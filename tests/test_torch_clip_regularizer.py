"""Gradient clipping (``clip``), weight decay (``regularizer``) and their
ops in the port, against the JAX package.

The ops on numpy inputs from a seed: ``clip_by_norm`` and
``clip_by_global_norm`` with the limit above and below the norm, f32 and
bf16 gradients, and ``l1_decay_sign``. Tolerance: the rescaled
gradients within 2 f32 ulps of JAX's relative (the squared norm is
summed in another order and the root is torch's; bf16: equal, the
factor's last bits vanish in the cast), ``l1_decay_sign`` bit for bit.

One training step (SGD, then Momentum for the state) of a 2-layer MLP
under each clip attr (by value, by norm, by global norm over a group of
parameters, none) and each regularizer (L1, L2; global, per parameter,
and the parameter's own winning over the global one): both packages
build the same program (``trained_dict``), and every parameter after
the step equals JAX's within rtol 1e-5 / atol 1e-6 (f32 rounding through
one backward and update).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op as torch_op
from test_torch_book import scopes
from test_torch_fused_head import trained_dict

torch.set_num_threads(1)
RTOL_OP = 2.4e-7  # 2 f32 ulps relative
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _run_op(op, attrs, xs, dtype):
    """The op's Out list in both packages, as f32 numpy."""
    jx = [jnp.asarray(x).astype(dtype) for x in xs]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    want = jax_op(op).fn(attrs, {"X": jx})["Out"]
    got = torch_op(op).fn(attrs, {"X": tx})["Out"]
    assert [str(g.dtype) for g in got] == [f"torch.{dtype}"] * len(xs)
    return ([g.float().numpy() for g in got],
            [np.asarray(w, np.float32) for w in want])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_norm_matches_jax(dtype, max_norm):
    got, want = _run_op("clip_by_norm", {"max_norm": max_norm},
                        [_rand(5, 7, scale=2.0)], dtype)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL_OP)
    if max_norm > 1e2:  # under the limit: unchanged
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(dtype, max_norm):
    xs = [_rand(5, 7, seed=1), _rand(3, seed=2, scale=4.0),
          _rand(2, 2, 3, seed=3)]
    got, want = _run_op("clip_by_global_norm", {"max_norm": max_norm},
                        xs, dtype)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL_OP)
    total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                        for g in got))
    if dtype == "float32" and max_norm < 1:
        assert abs(total - max_norm) <= 1e-6 * max_norm


def test_clip_by_norm_floor_on_a_zero_gradient():
    got, want = _run_op("clip_by_norm", {"max_norm": 1.0},
                        [np.zeros((4,), np.float32)], "float32")
    np.testing.assert_array_equal(got[0], want[0])
    assert np.all(got[0] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l1_decay_sign_matches_jax(dtype):
    x = _rand(6, 4, seed=4)
    x[0, :2] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    want = jax_op("l1_decay_sign").fn({"coeff": 0.013}, {"X": [jx]})
    got = torch_op("l1_decay_sign").fn(
        {"coeff": 0.013}, {"X": [torch.from_numpy(x).to(
            getattr(torch, dtype))]})
    np.testing.assert_array_equal(got["Out"][0].float().numpy(),
                                  np.asarray(want["Out"][0], np.float32))


def _mlp(pt, clip=None, reg=None, own_reg=None, optimizer="sgd"):
    """x -> fc 8 (relu) -> fc 4, softmax CE; ``clip`` a function of the
    package giving its attr (set on both weights, or a list for a
    group), ``reg`` the global regularizer, ``own_reg`` fc1's own."""
    L = pt.layers
    x = L.data("x", shape=[6])
    y = L.data("y", shape=[1], dtype="int64")
    own = pt.ParamAttr(name="fc1.w",
                       regularizer=own_reg(pt) if own_reg else None)
    h = L.fc(x, size=8, act="relu", param_attr=own)
    logits = L.fc(h, size=4, param_attr=pt.ParamAttr(name="fc2.w"))
    loss = L.mean(L.softmax_with_cross_entropy(logits, y))
    if clip is not None:
        pt.clip.set_gradient_clip(clip(pt), param_list=["fc1.w", "fc2.w"])
    opt = (pt.optimizer.SGDOptimizer(0.5, regularization=reg(pt) if reg
                                     else None)
           if optimizer == "sgd" else
           pt.optimizer.MomentumOptimizer(0.3, 0.9, regularization=(
               reg(pt) if reg else None)))
    opt.minimize(loss)
    return loss


CLIPS = {
    "none": None,
    "value": lambda pt: pt.clip.GradientClipByValue(0.02),
    "value_min": lambda pt: pt.clip.GradientClipByValue(0.03, min=-0.01),
    "norm": lambda pt: pt.clip.GradientClipByNorm(0.05),
    "global_norm": lambda pt: pt.clip.GradientClipByGlobalNorm(0.05),
}
REGS = {
    "l2": (lambda pt: pt.regularizer.L2Decay(0.1), None),
    "l1": (lambda pt: pt.regularizer.L1DecayRegularizer(0.05), None),
    "own_l1": (None, lambda pt: pt.regularizer.L1Decay(0.05)),
    "own_wins": (lambda pt: pt.regularizer.L2DecayRegularizer(0.1),
                 lambda pt: pt.regularizer.L1Decay(0.05)),
}


def _step_both(build, steps=2):
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 11
        with pt.program_guard(main, startup):
            loss = build(pt)
        built.append((main, startup, loss))
    (jm, js, jl), (tm, ts, tl) = built
    assert trained_dict(tpt, tm) == trained_dict(jpt, jm)
    jscope, tscope = scopes(js, ts)
    rng = np.random.RandomState(5)
    for _ in range(steps):
        feed = {"x": rng.randn(16, 6).astype(np.float32),
                "y": rng.randint(0, 4, (16, 1)).astype(np.int64)}
        lj, = jpt.Executor(jpt.CPUPlace()).run(jm, feed=feed,
                                               fetch_list=[jl], scope=jscope)
        lt, = tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed,
                                               fetch_list=[tl], scope=tscope)
        np.testing.assert_allclose(np.asarray(lt), np.asarray(lj), rtol=1e-6)
    for name in [n for n in tscope.keys() if n.startswith("fc")]:
        np.testing.assert_allclose(tscope.get_numpy(name),
                                   np.asarray(jscope.get(name)),
                                   err_msg=name, **STEP_TOL)
    return tm


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_clip_attr_trains_as_jax(clip, optimizer):
    tm = _step_both(lambda pt: _mlp(pt, clip=CLIPS[clip],
                                    optimizer=optimizer))
    types = [op.type for op in tm.global_block.ops]
    want = {"none": None, "value": "clip", "value_min": "clip",
            "norm": "clip_by_norm", "global_norm": "clip_by_global_norm"}
    if want[clip]:
        # one op a gradient, or one op for the group
        assert types.count(want[clip]) == (1 if clip == "global_norm"
                                           else 2)


@pytest.mark.parametrize("reg", sorted(REGS))
def test_regularizer_trains_as_jax(reg):
    glob, own = REGS[reg]
    tm = _step_both(lambda pt: _mlp(pt, reg=glob, own_reg=own))
    types = [op.type for op in tm.global_block.ops]
    decays = types.count("scale") + types.count("l1_decay_sign")
    assert decays >= (1 if reg == "own_l1" else 2)
    if reg == "own_wins":
        assert types.count("l1_decay_sign") == 1


def test_clip_comes_before_regularization():
    tm = _step_both(lambda pt: _mlp(pt, clip=CLIPS["global_norm"],
                                    reg=REGS["l2"][0]))
    types = [op.type for op in tm.global_block.ops]
    assert types.index("clip_by_global_norm") < types.index("sum")


def test_set_gradient_clip_checks_its_argument():
    with tpt.program_guard(tpt.Program(), tpt.Program()):
        with pytest.raises(TypeError, match="BaseGradientClipAttr"):
            tpt.clip.set_gradient_clip(0.5)
    assert tpt.clip.ClipByValue is tpt.clip.GradientClipByValue
    assert tpt.clip.__all__ == jpt.clip.__all__
