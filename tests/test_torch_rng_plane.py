"""The port's RNG plane against ``jax.random`` and the JAX executor.

``core/prng.py``'s split, uniform, bernoulli, normal and truncated_normal
are bit-exact with ``jax.random`` over several seeds and shapes, and its
f32 ``erf``, ``log1p`` and ``erf_inv`` equal XLA's CPU polynomials bit
for bit, the tail of ``erf_inv`` (|u| > 0.9966, where it takes a square
root) included: the largest gap these tests allow is ``NORMAL_MAX_ULP``,
0 ulp.

The startup programs of a narrow ResNet and of a small stacked LM, run by
both packages' ``Executor``s from the same ``random_seed`` and from
``FLAGS.seed``, give equal values: every uniform, truncated-normal and
constant init bit for bit, gaussian inits too (``NORMAL_MAX_ULP``).
Dropout masks in training equal JAX's bit for bit, ``is_test`` dropout
and ``scale`` too. The dense engine's sampled tokens (temperature 0.8,
top-k 50) equal JAX ``GenerationEngine(kv_cache="dense")``'s, and so do
``transformer_stack_generate``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core import program as tprog

torch.set_num_threads(1)
NORMAL_MAX_ULP = 0  # normal() draws equal jax.random's bit for bit
SEEDS = (0, 1, 7, 12345, 2**31 + 5)
SHAPES = ((7,), (3, 5), (64, 33))


def _ulps(a, b):
    """Elementwise distance in f32 units in the last place."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _key_np(key):
    return np.array([int(key[0]), int(key[1])], np.uint32)


# --- the primitives -------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_are_bit_exact(seed):
    jkey = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.split(jkey, 4))
    got = np.stack([_key_np(k) for k in prng.split(prng.prng_key(seed), 4)])
    np.testing.assert_array_equal(got, want)
    # split(key)[i] is fold_in(key, i) in the partitionable mode
    np.testing.assert_array_equal(
        _key_np(prng.fold_in(prng.prng_key(seed), 3)), want[3])
    # chained splits, the executor's per-op walk
    jk, tk = jkey, prng.prng_key(seed)
    for _ in range(5):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        np.testing.assert_array_equal(_key_np(tsub), np.asarray(jsub))
    np.testing.assert_array_equal(_key_np(tk), np.asarray(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bernoulli_truncated_normal_are_bit_exact(seed, shape):
    jkey, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for lo, hi in ((0.0, 1.0), (-0.3, 0.3), (-1.7, 2.9)):
        np.testing.assert_array_equal(
            prng.uniform(tkey, shape, lo, hi).numpy(),
            np.asarray(jax.random.uniform(jkey, shape, minval=lo,
                                          maxval=hi)))
    for p in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(
            prng.bernoulli(tkey, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jkey, p, shape)))
    np.testing.assert_array_equal(
        prng.truncated_normal(tkey, -2.0, 2.0, shape).numpy(),
        np.asarray(jax.random.truncated_normal(jkey, -2.0, 2.0, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_is_bit_exact_but_for_its_tail(seed):
    shape = (200_000,)
    got = prng.normal(prng.prng_key(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    gap = _ulps(got, want)
    assert gap.max() <= NORMAL_MAX_ULP
    np.testing.assert_array_equal(got, want)
    # the draws reach erf_inv's square-root branch (|x| > 2.9)
    assert (np.abs(want) > 2.9).sum() >= 50


def test_erf_and_log1p_equal_xla_and_erf_inv_is_within_one_ulp():
    rs = np.random.RandomState(0)
    bits = rs.randint(0, 2**32, size=300_000, dtype=np.uint64)
    f = ((bits.astype(np.uint32) >> 9) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1)
    u = np.maximum(np.float32(-0.99999994),
                   f * np.float32(2.0) + np.float32(-0.99999994))
    x = -(u * u)
    np.testing.assert_array_equal(prng._xla_log1p(torch.from_numpy(x)),
                                  np.asarray(jax.jit(jnp.log1p)(x)))
    xs = np.linspace(-6, 6, 100_001).astype(np.float32)
    np.testing.assert_array_equal(prng.erf(torch.from_numpy(xs)),
                                  np.asarray(jax.jit(lax.erf)(xs)))
    np.testing.assert_array_equal(prng.erf_inv(torch.from_numpy(u)),
                                  np.asarray(jax.jit(lax.erf_inv)(u)))
    # and densely over the square-root branch (w >= 5: |u| > 0.9966)
    tail = np.linspace(0.9966, 0.99999994, 200_001).astype(np.float32)
    tail = np.concatenate([tail, -tail])
    np.testing.assert_array_equal(prng.erf_inv(torch.from_numpy(tail)),
                                  np.asarray(jax.jit(lax.erf_inv)(tail)))


# --- the executor's scope key ---------------------------------------------------
def _resnet(pt):
    from test_torch_resnet import _narrow

    images = pt.layers.data("images", [32, 32, 3])
    return _narrow(pt, images)


def _lm(pt):
    ids = pt.layers.data("ids", shape=[16], dtype="int64")
    return pt.models.transformer_lm(ids, vocab_size=97, d_model=32,
                                    n_layers=2, num_heads=4, max_len=32,
                                    pipeline_stack=True)


def _init_mix(pt):
    """Every init op the RNG plane draws for, several of each."""
    x = pt.layers.data("x", [6])
    I = pt.initializer
    for init in (I.Uniform(-0.5, 0.5), I.Normal(0.1, 0.3),
                 I.TruncatedNormal(0.0, 0.2), I.Xavier(uniform=False),
                 I.MSRA(), I.TruncatedNormal(1.0, 2.0), I.Normal(0.0, 0.02),
                 I.MSRA(uniform=False), I.Uniform(0.0, 3.0)):
        x = pt.layers.fc(x, size=6, param_attr=pt.param_attr.ParamAttr(
            initializer=init))
    return x


def _startups(builder, seed):
    """Both packages' startup values by name, the programs built with
    the same names (the port's counter started where JAX's was)."""
    out = []
    start = jprog.Program._uid_counter
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = seed
        with pt.program_guard(main, startup):
            builder(pt)
        scope = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
        out.append((startup, {
            name: np.asarray(scope.get(name)) if pt is jpt
            else scope.get_numpy(name)
            for op in startup.global_block.ops
            for name in op.output_names()}))
    return out


@pytest.mark.parametrize("builder", [_resnet, _lm, _init_mix])
@pytest.mark.parametrize("seed", [5, None])
def test_startup_values_equal_jax(builder, seed):
    """``random_seed`` set, and unset (``FLAGS.seed`` = 3)."""
    old = jpt.flags.FLAGS.seed
    jpt.flags.FLAGS.seed = 3
    tpt.flags.FLAGS.seed = 3
    try:
        (jstart, jvals), (tstart, tvals) = _startups(builder, seed)
    finally:
        jpt.flags.FLAGS.seed = old
        tpt.flags.reset_flags()
    assert [op.type for op in tstart.global_block.ops] == \
        [op.type for op in jstart.global_block.ops]
    types = {n: op.type for op in tstart.global_block.ops
             for n in op.output_names()}
    assert sorted(tvals) == sorted(jvals)
    drawn = 0
    for name, want in jvals.items():
        got = tvals[name]
        assert got.shape == want.shape, name
        if types[name] == "gaussian_random":
            assert _ulps(got, want).max() <= NORMAL_MAX_ULP, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
        drawn += types[name] != "fill_constant"
    assert drawn >= 7


def test_runs_advance_the_scope_key_as_jax_does():
    main_j, start_j = jpt.Program(), jpt.Program()
    main_t, start_t = tpt.Program(), tpt.Program()
    for pt, main, start in ((jpt, main_j, start_j), (tpt, main_t, start_t)):
        start.random_seed = 11
        with pt.program_guard(main, start):
            _init_mix(pt)
    jscope, tscope = jpt.Scope(), tpt.Scope()
    for _ in range(2):  # the second run draws from the advanced key
        jpt.Executor(jpt.CPUPlace()).run(start_j, scope=jscope)
        tpt.Executor(tpt.CPUPlace()).run(start_t, scope=tscope)
        np.testing.assert_array_equal(
            _key_np(tscope.get(tprog.RNG_VAR)),
            np.asarray(jscope.get(jprog.RNG_VAR)))


# --- dropout --------------------------------------------------------------------
def _dropout_net(pt, is_test=False):
    x = pt.layers.data("x", [8, 16])
    h = pt.layers.dropout(x, dropout_prob=0.3, is_test=is_test)
    return pt.layers.dropout(pt.layers.relu(h), dropout_prob=0.6,
                             is_test=is_test)


@pytest.mark.parametrize("is_test", [False, True])
def test_dropout_masks_and_outputs_equal_jax(is_test):
    x = np.random.RandomState(1).randn(4, 8, 16).astype(np.float32)
    got = []
    start = jprog.Program._uid_counter
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main = pt.Program()
        main.random_seed = 9
        with pt.program_guard(main, pt.Program()):
            _dropout_net(pt, is_test)
        fetch = [n for op in main.global_block.ops
                 for n in op.output_names()]
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        got.append([exe.run(main, feed={"x": x}, fetch_list=fetch,
                            scope=scope) for _ in range(2)])
    for jrun, trun in zip(*got):
        for j, t in zip(jrun, trun):
            np.testing.assert_array_equal(t, np.asarray(j))
    if not is_test:  # the two runs drew different masks
        assert not np.array_equal(got[1][0][1], got[1][1][1])


def test_dropout_grad_and_scale_op_equal_jax():
    from paddle_tpu.core.registry import get_op as jax_op
    from paddle_tpu_torch.core.registry import get_op as torch_op

    x = np.random.RandomState(2).randn(5, 7).astype(np.float32)
    for attrs in ({"scale": 0.7}, {"scale": 1.5, "bias": 0.25},
                  {"scale": 2.0, "bias": -1.0, "bias_after_scale": False}):
        want = jax_op("scale").fn(attrs, {"X": [jnp.asarray(x)]})["Out"][0]
        got = torch_op("scale").fn(attrs, {"X": [torch.from_numpy(x)]})
        np.testing.assert_array_equal(got["Out"][0].numpy(),
                                      np.asarray(want))
    attrs = {"dropout_prob": 0.4}
    jout = jax_op("dropout").fn(attrs, {"X": [jnp.asarray(x)]},
                                rng=jax.random.PRNGKey(4))
    tout = torch_op("dropout").fn(attrs, {"X": [torch.from_numpy(x)]},
                                  rng=prng.prng_key(4))
    og = np.random.RandomState(3).randn(5, 7).astype(np.float32)
    jg = jax_op("dropout").grad_fn(attrs, {}, jout,
                                   {"Out": [jnp.asarray(og)]})["X"][0]
    tg = torch_op("dropout").grad_fn(attrs, {}, tout,
                                     {"Out": [torch.from_numpy(og)]})["X"][0]
    np.testing.assert_array_equal(tout["Mask"][0].numpy(),
                                  np.asarray(jout["Mask"][0]))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


# --- sampled decoding (the repaired fault) --------------------------------------
def test_dense_engine_sampled_tokens_equal_jax():
    from test_torch_serving import (BUCKETS, SLOTS, VOCAB, _drive,
                                    _jax_scope, _spec)

    from paddle_tpu.serving import GenerationEngine as JaxEngine
    from paddle_tpu.serving import LMSpec as JaxLMSpec
    from paddle_tpu.serving import Request as JaxRequest
    from paddle_tpu_torch.serving import GenerationEngine, Request

    scope = _jax_scope()
    params = {n: np.asarray(scope.get(n)) for n in scope.keys()
              if n != jprog.RNG_VAR}
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, VOCAB, (n,)).astype(np.int64)
               for n in (8, 5, 12, 3, 16)]
    horizons = (7, 3, 5, 6, 4)
    policy = dict(temperature=0.8, top_k=50)
    jscope = jpt.Scope()
    for n, v in params.items():
        jscope.set(n, jnp.asarray(v))
    s = _spec()
    jeng = JaxEngine(JaxLMSpec(vocab_size=s.vocab_size, d_model=s.d_model,
                               n_layers=s.n_layers, num_heads=s.num_heads,
                               max_len=s.max_len),
                     jscope, slots=SLOTS, prompt_buckets=BUCKETS,
                     kv_cache="dense", **policy)
    jeng.warmup()
    want = _drive(jeng, [JaxRequest({"prompt": p}, {"max_new_tokens": h},
                                    None)
                         for p, h in zip(prompts, horizons)])
    teng = GenerationEngine(s, params, slots=SLOTS, prompt_buckets=BUCKETS,
                            kv_cache="dense", device="cpu", **policy)
    teng.warmup()
    got = _drive(teng, [Request({"prompt": p}, {"max_new_tokens": h}, None)
                        for p, h in zip(prompts, horizons)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # sampling drew: the tokens differ from the greedy engine's
    greedy = _drive(GenerationEngine(s, params, slots=SLOTS,
                                     prompt_buckets=BUCKETS,
                                     kv_cache="dense", device="cpu"),
                    [Request({"prompt": p}, {"max_new_tokens": h}, None)
                     for p, h in zip(prompts, horizons)])
    assert any(not np.array_equal(g, w) for g, w in zip(greedy, got))


@pytest.mark.parametrize("variant,seed", [("mha_pos_emb", 0),
                                          ("gqa_rope", 3)])
def test_one_shot_generate_samples_as_jax(variant, seed):
    from test_torch_pipeline_ops import V, _both, _np, _weights

    from paddle_tpu.ops import pipeline_ops as jops
    from paddle_tpu_torch.ops import pipeline_ops as tops

    _, attrs, weights = _weights(variant, seed=4)
    attrs = dict(attrs, max_new_tokens=6, temperature=0.8, top_k=20)
    prompt = np.random.RandomState(6).randint(0, V, (3, 9)).astype(np.int64)
    jins, tins = _both(dict(weights, Prompt=prompt))
    want = _np(jops.transformer_stack_generate(
        attrs, jins, jax.random.PRNGKey(seed))["Out"][0])
    got = tops.transformer_stack_generate(attrs, tins,
                                          prng.prng_key(seed))["Out"][0]
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = tops.transformer_stack_generate(
        dict(attrs, temperature=0.0), tins)["Out"][0]
    assert not torch.equal(greedy, got)
