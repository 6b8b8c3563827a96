"""The port's threefry (``core/prng.py``) and per-row sampler
(``kernels/sampling.py``) against ``jax.random`` and the JAX package's
``kernels/sampling.py``.

Bits, ``fold_in`` keys, uniforms and gumbels must equal jax's bit for bit
over several seeds and steps (jax's defaults: threefry2x32, partitionable,
gumbel mode "low"). ``sample_rows`` must pick the same tokens as the JAX
sampler on the same logits for greedy, temperature, top-k, top-p and
masked rows, and a row's token must not depend on the rows around it.
Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import sampling as jsampling
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.kernels import sampling as tsampling

torch.set_num_threads(1)
SEEDS = [0, 1, 7, 123456789, 2 ** 31 - 1, 2 ** 32 - 1]
STEPS = [0, 1, 5, 1000]


def _jkey(seed, step):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                              np.uint32(step))


def _tkey(seed, step):
    return prng.fold_in(prng.prng_key(torch.tensor([seed])),
                        torch.tensor([step]))


def _words(key):
    return [int(w[0]) for w in key]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_equal_jax(seed):
    assert _words(prng.prng_key(torch.tensor([seed]))) == [
        int(w) for w in np.asarray(jax.random.key_data(
            jax.random.PRNGKey(np.uint32(seed))))]
    for step in STEPS:
        want = [int(w) for w in np.asarray(jax.random.key_data(
            _jkey(seed, step)))]
        assert _words(_tkey(seed, step)) == want, (seed, step)


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_and_gumbel_equal_jax_bit_for_bit(seed):
    n = 1031  # odd, past one vector width
    for step in STEPS:
        jk, tk = _jkey(seed, step), _tkey(seed, step)
        bits = np.asarray(jax.random.bits(jk, (n,), jnp.uint32))
        np.testing.assert_array_equal(prng.random_bits(tk, n)[0].numpy(),
                                      bits.astype(np.int64))
        u = np.asarray(jax.random.uniform(jk, (n,), jnp.float32))
        assert np.array_equal(prng.uniform(tk, n)[0].numpy().view(np.int32),
                              u.view(np.int32))
        g = np.asarray(jax.random.gumbel(jk, (n,), jnp.float32))
        assert np.array_equal(prng.gumbel(tk, n)[0].numpy().view(np.int32),
                              g.view(np.int32)), (seed, step)


def test_keys_are_per_row():
    """One call over a batch of (seed, step) rows gives each row the key
    and bits it gets alone."""
    seeds = torch.tensor([3, 3, 9, 2 ** 31 - 1])
    steps = torch.tensor([0, 4, 4, 77])
    keys = prng.fold_in(prng.prng_key(seeds), steps)
    g = prng.gumbel(keys, 50)
    for r in range(4):
        alone = prng.gumbel(_tkey(int(seeds[r]), int(steps[r])), 50)[0]
        assert torch.equal(g[r], alone)


def _policy_rows(rows, vocab, rng):
    """A mixed batch: greedy, temperature, top-k, top-p, top-k + top-p,
    masked, in turn."""
    temp = np.zeros(rows, np.float32)
    topk = np.zeros(rows, np.int32)
    topp = np.ones(rows, np.float32)
    mask = np.ones((rows, vocab), np.float32)
    for r in range(rows):
        kind = r % 6
        if kind:
            temp[r] = rng.choice([0.5, 0.8, 1.0, 1.7])
        if kind in (2, 4):
            topk[r] = rng.randint(1, 20)
        if kind in (3, 4):
            topp[r] = rng.choice([0.5, 0.9, 0.95])
        if kind == 5:
            mask[r, rng.rand(vocab) < 0.6] = 0.0
            mask[r, rng.randint(vocab)] = 1.0
            if r % 12 == 5:
                temp[r] = 0.0  # a masked greedy row
    seed = rng.randint(0, 2 ** 31 - 1, rows).astype(np.int32)
    step = rng.randint(0, 200, rows).astype(np.int32)
    return temp, topk, topp, seed, step, mask


def _both(logits, temp, topk, topp, seed, step, mask):
    want = np.asarray(jsampling.sample_rows(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(topk),
        jnp.asarray(topp), jnp.asarray(seed), jnp.asarray(step),
        jnp.asarray(mask)))
    got = tsampling.sample_rows(*(torch.from_numpy(a) for a in (
        logits, temp, topk, topp, seed, step, mask)))
    return got.numpy(), want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_rows_picks_the_jax_samplers_tokens(seed):
    rng = np.random.RandomState(seed)
    rows, vocab = 48, 97
    logits = (rng.randn(rows, vocab) * 3).astype(np.float32)
    policy = _policy_rows(rows, vocab, rng)
    got, want = _both(logits, *policy)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    mask = policy[-1]
    assert all(mask[r, got[r]] > 0 for r in range(rows))


def test_sample_rows_is_batch_invariant():
    """A row's token depends on its own logits, policy, seed and step
    only: alone, in a batch, or moved to another row."""
    rng = np.random.RandomState(5)
    rows, vocab = 12, 64
    logits = (rng.randn(rows, vocab) * 2).astype(np.float32)
    policy = _policy_rows(rows, vocab, rng)
    batch = tsampling.sample_rows(*(torch.from_numpy(a) for a in (
        logits,) + policy))
    perm = rng.permutation(rows)
    shuffled = tsampling.sample_rows(*(torch.from_numpy(np.ascontiguousarray(
        a[perm])) for a in (logits,) + policy))
    assert torch.equal(shuffled, batch[perm])
    for r in range(rows):
        alone = tsampling.sample_rows(*(torch.from_numpy(a[r:r + 1]) for a in
                                        (logits,) + policy))
        assert int(alone[0]) == int(batch[r])


def test_top_logprobs_and_masked_logprobs_equal_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 40).astype(np.float32)
    logits[2, 5] = logits[2, 9]  # a tie: the lower id first
    mask = (rng.rand(6, 40) > 0.3).astype(np.float32)
    jv, ji = jsampling.top_logprobs(jnp.asarray(logits), 4,
                                    jnp.asarray(mask))
    tv, ti = tsampling.top_logprobs(torch.from_numpy(logits), 4,
                                    torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
