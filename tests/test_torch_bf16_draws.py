"""bf16 random draws against ``jax.random`` and the JAX executor's startup.

Under AMP a parameter fed by a bf16 activation is declared bf16 (the
per-layer transformer's attention out-projection, both FFN biases and
the second FFN weight), and its startup op draws in bf16. ``jax.random``
draws bf16 its own way: ``uniform`` takes 8-bit words (the low byte of
each threefry word: bf16 has 7 mantissa bits, fewer than 8) and keeps
their top 7 bits as the mantissa, and every step after (the scale and
shift, ``erf_inv``, the sqrt(2) factor, the op's ``mean + std * x``) is a
bf16 op rounded to bf16. Drawing in f32 and casting gives other values
for every draw. ``core/prng.py``'s ``uniform``, ``normal`` and
``truncated_normal`` and the four init ops in bf16 are held bit for bit
to ``jax.random`` and the JAX ops here, over several seeds, shapes and
ranges (the f32 ``erf_inv`` tail gap of ``test_torch_rng_plane.py`` is
below bf16's precision: no draw differs). Then the per-layer LM built
under AMP (L2, 25 parameters) is initialised by each package's own
startup program and executor from the same seed: every parameter equal
in value and dtype, no value carried across.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.ops.common as jax_common
import paddle_tpu_torch as tpt
import paddle_tpu_torch.ops.common as torch_common
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op as torch_op

torch.set_num_threads(1)
SEEDS = (0, 3, 7, 12345, 2**31 + 5)
SHAPES = ((6,), (64, 33), (4097,))
RANGES = ((-0.1, 0.1), (0.0, 1.0), (-1.7, 2.9), (-0.0510310363, 0.0510310363))


def _f32(a):
    """A bf16 jax array or tensor as f32 numpy (exact)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_bf16_uniform_differs_from_an_f32_draw_cast():
    """The draw the port made before: every value of the first six moves."""
    key = prng.prng_key(3)
    want = _f32(jax.random.uniform(jax.random.PRNGKey(3), (6,),
                                   dtype=jnp.bfloat16, minval=-0.1,
                                   maxval=0.1))
    cast = prng.uniform(key, (6,), -0.1, 0.1).bfloat16()
    assert (cast.float().numpy() != want).all()
    np.testing.assert_array_equal(
        _f32(prng.uniform(key, (6,), -0.1, 0.1, dtype=torch.bfloat16)), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_uniform_normal_truncated_normal_are_bit_exact(seed, shape):
    jkey, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    bf = torch.bfloat16
    for lo, hi in RANGES:
        got = prng.uniform(tkey, shape, lo, hi, dtype=bf)
        assert got.dtype == bf
        np.testing.assert_array_equal(_f32(got), _f32(jax.random.uniform(
            jkey, shape, dtype=jnp.bfloat16, minval=lo, maxval=hi)))
    np.testing.assert_array_equal(
        _f32(prng.normal(tkey, shape, dtype=bf)),
        _f32(jax.random.normal(jkey, shape, dtype=jnp.bfloat16)))
    np.testing.assert_array_equal(
        _f32(prng.truncated_normal(tkey, -2.0, 2.0, shape, dtype=bf)),
        _f32(jax.random.truncated_normal(jkey, -2.0, 2.0, shape,
                                         dtype=jnp.bfloat16)))


# (op type, attrs, inputs) of the four init ops, drawn in bf16
OPS = [
    ("uniform_random", {"shape": [33, 17], "min": -0.08, "max": 0.08}, {}),
    ("gaussian_random", {"shape": [33, 17], "mean": 0.0, "std": 0.02}, {}),
    ("gaussian_random", {"shape": [500], "mean": 0.5, "std": 1.3}, {}),
    ("truncated_gaussian_random", {"shape": [64, 9], "mean": 0.1,
                                   "std": 0.2}, {}),
    ("gaussian_random_batch_size_like", {"shape": [-1, 12], "mean": -1.0,
                                         "std": 0.7},
     {"Input": np.zeros((9, 4), np.float32)}),
]


@pytest.mark.parametrize("case", range(len(OPS)))
@pytest.mark.parametrize("seed", (1, 99))
def test_bf16_init_ops_equal_the_jax_ops(case, seed):
    op_type, attrs, ins = OPS[case]
    attrs = dict(attrs, dtype="bfloat16")
    want = jax_op(op_type).fn(
        attrs, {s: [jnp.asarray(a)] for s, a in ins.items()},
        rng=jax.random.PRNGKey(seed))["Out"][0]
    got = torch_op(op_type).fn(
        attrs, {s: [torch.from_numpy(a)] for s, a in ins.items()},
        rng=prng.prng_key(seed))["Out"][0]
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


def _lm(pt):
    ids = pt.layers.data("ids", shape=[16], dtype="int64")
    return pt.models.transformer_lm(ids, vocab_size=61, d_model=32,
                                    n_layers=2, num_heads=4, max_len=32)


@pytest.mark.parametrize("amp", [True, False], ids=["amp", "f32"])
def test_per_layer_lm_startup_equals_the_jax_executors(amp, monkeypatch):
    """Each package runs its own startup program: values and dtypes equal
    for every parameter, the bf16-declared ones included under AMP."""
    monkeypatch.setattr(jax_common, "_AMP", amp)
    monkeypatch.setattr(torch_common, "_AMP", amp)
    start = jprog.Program._uid_counter
    values = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 11
        with pt.program_guard(main, startup):
            _lm(pt)
        scope = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
        values.append({p.name: scope.get(p.name)
                       for p in main.global_block.all_parameters()})
    jvals, tvals = values
    assert sorted(tvals) == sorted(jvals) and len(tvals) == 25
    bf16, drawn = [], []
    for name, want in jvals.items():
        got = tvals[name]
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
        np.testing.assert_array_equal(_f32(got), _f32(want), err_msg=name)
        if got.dtype == torch.bfloat16:
            bf16.append(name)
            if (_f32(got) != 0).any():
                drawn.append(name)
    # four a layer: the out-projection, both FFN biases (zeros) and the
    # second FFN weight; the two weights are uniform draws in bf16
    assert (len(bf16), len(drawn)) == ((8, 4) if amp else (0, 0)), bf16
