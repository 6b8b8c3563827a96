"""The port's conv-epilogue kernels and fused op against the JAX package.

The plain versions of the three CUDA kernels (``conv1x1_stats``,
``conv1x1_epilogue``, ``scale_shift_act``) are held against the Pallas
kernels run in interpret mode on the CPU, at a shape that tiles (R, I, O
= 512, 128, 128) and one that takes the JAX wrappers' XLA fallback (100,
32, 16), with and without a residual, act None and relu, at rtol 1e-5 /
atol 1e-4. The fused ``conv1x1_bn_act`` op and its grad_fn are held
against the JAX op's (which runs those Pallas kernels in interpret mode
on the CPU) in training and test form, with and without a residual and
with running-stat cotangents, at rtol 1e-4 / atol 1e-6. The CUDA launch paths refuse what the
kernels do not take before anything is built. Inputs come from a numpy
seed; f32 throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX ops)
import paddle_tpu_torch  # noqa: F401  (registers the port's ops)
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu.kernels import conv_epilogue as jke
from paddle_tpu_torch.core.registry import get_op as torch_op
from paddle_tpu_torch.kernels import conv_epilogue as tke

torch.set_num_threads(1)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
OP_TOL = dict(rtol=1e-4, atol=1e-6)
SHAPES = {"tiles": (512, 128, 128), "fallback": (100, 32, 16)}


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _kernel_inputs(R, I, O, residual):
    x = _rand(R, I, seed=1)
    w = _rand(I, O, seed=2, scale=I ** -0.5)
    scale = 1.0 + 0.2 * _rand(O, seed=3)
    shift = 0.3 * _rand(O, seed=4)
    res = _rand(R, O, seed=5) if residual else None
    return x, w, scale, shift, res


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


# --- the kernels' plain versions against the Pallas kernels -----------------
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_conv1x1_stats_plain_matches_pallas(shape):
    R, I, O = SHAPES[shape]
    x, w, *_ = _kernel_inputs(R, I, O, False)
    jy, jstats = jke.conv1x1_stats(_j(x), _j(w), interpret=True)
    ty, tstats = tke.conv1x1_stats(_t(x), _t(w))
    _close(ty, jy, KERNEL_TOL, "y")
    _close(tstats, jstats, KERNEL_TOL, "stats")
    assert tstats.dtype == torch.float32


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "relu"])
def test_conv1x1_epilogue_plain_matches_pallas(shape, residual, act):
    R, I, O = SHAPES[shape]
    x, w, scale, shift, res = _kernel_inputs(R, I, O, residual)
    want = jke.conv1x1_epilogue(_j(x), _j(w), _j(scale), _j(shift),
                                residual=_j(res), act=act, interpret=True)
    got = tke.conv1x1_epilogue(_t(x), _t(w), _t(scale), _t(shift),
                               residual=_t(res), act=act)
    _close(got, want, KERNEL_TOL)
    if act == "relu":
        assert (got >= 0).all() and (got == 0).any()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [None, "relu"])
def test_scale_shift_act_plain_matches_pallas(shape, residual, act):
    R, _, O = SHAPES[shape]
    y = _rand(R, O, seed=6)
    _, _, scale, shift, res = _kernel_inputs(R, 1, O, residual)
    want = jke.scale_shift_act(_j(y), _j(scale), _j(shift),
                               residual=_j(res), act=act, interpret=True)
    got = tke.scale_shift_act(_t(y), _t(scale), _t(shift),
                              residual=_t(res), act=act)
    _close(got, want, KERNEL_TOL)


def test_wrappers_on_the_cpu_run_the_plain_versions_and_launch_nothing():
    x, w, scale, shift, res = (_t(a) for a in _kernel_inputs(64, 8, 12,
                                                              True))
    y, stats = tke.conv1x1_stats(x, w)
    torch.testing.assert_close(y, x @ w)
    torch.testing.assert_close(stats, torch.stack([y.sum(0),
                                                   (y * y).sum(0)]))
    out = tke.scale_shift_act(y, scale, shift, res, "relu")
    torch.testing.assert_close(out, torch.relu(y * scale + shift + res))
    torch.testing.assert_close(
        tke.conv1x1_epilogue(x, w, scale, shift, res, "relu"), out)
    assert (tke.conv1x1_stats.launches, tke.conv1x1_epilogue.launches,
            tke.scale_shift_act.launches) == (0, 0, 0)
    meta = tke.conv1x1_stats(x.to("meta"), w.to("meta"))
    assert [tuple(t.shape) for t in meta] == [(64, 12), (2, 12)]


def _bad_launch(case):
    """(launcher, args, exception) the CUDA launch paths must refuse."""
    x, w, scale, shift, res = (_t(a) for a in _kernel_inputs(16, 8, 4, True))
    if case == "stats_dtype":
        return tke._launch_stats, (x.double(), w.double()), TypeError
    if case == "stats_chain":
        return tke._launch_stats, (x, w[:5]), ValueError
    if case == "stats_rank":
        return tke._launch_stats, (x[None], w), ValueError
    if case == "epilogue_scale_shape":
        return (tke._launch_epilogue, (x, w, scale[:3], shift, None, "relu"),
                ValueError)
    if case == "epilogue_residual_shape":
        return (tke._launch_epilogue, (x, w, scale, shift, res[:8], None),
                ValueError)
    if case == "apply_dtype":
        return (tke._launch_apply, (res.half(), scale, shift, None, None),
                TypeError)
    return (tke._launch_apply, (res, scale, shift, res.t(), "relu"),
            ValueError)  # "apply_residual_shape"


@pytest.mark.parametrize("case", [
    "stats_dtype", "stats_chain", "stats_rank", "epilogue_scale_shape",
    "epilogue_residual_shape", "apply_dtype", "apply_residual_shape"])
def test_launch_refuses_what_the_kernels_do_not_take(case):
    """The CUDA launch paths validate before they build or bind anything
    (a build here would raise KernelBuildError: no nvcc), so these checks
    run on the CPU too."""
    launcher, args, exc = _bad_launch(case)
    with pytest.raises(exc):
        launcher(*args)
    assert (tke.conv1x1_stats.launches, tke.conv1x1_epilogue.launches,
            tke.scale_shift_act.launches) == (0, 0, 0)


def test_wrappers_refuse_other_devices():
    class FakeDevice:
        type = "xpu"

    class FakeTensor:
        device = FakeDevice()

    t = FakeTensor()
    for call in (lambda: tke.conv1x1_stats(t, t),
                 lambda: tke.conv1x1_epilogue(t, t, t, t),
                 lambda: tke.scale_shift_act(t, t, t)):
        with pytest.raises(ValueError, match="cuda, cpu or meta"):
            call()


# --- the fused op and its grad_fn against the JAX op ------------------------
def _fused_ins(B, H, W, I, O, residual, seed=0):
    rng = np.random.RandomState(seed)
    ins = {"X": [rng.randn(B, H, W, I).astype(np.float32)],
           "Filter": [(rng.randn(1, 1, I, O) * I ** -0.5).astype(np.float32)],
           "Scale": [(1.0 + 0.2 * rng.randn(O)).astype(np.float32)],
           "Bias": [(0.1 * rng.randn(O)).astype(np.float32)],
           "Mean": [(0.1 * rng.randn(O)).astype(np.float32)],
           "Variance": [(1.0 + 0.1 * rng.rand(O)).astype(np.float32)]}
    if residual:
        ins["Residual"] = [rng.randn(B, H, W, O).astype(np.float32)]
    return ins


def _both(ins):
    return ({s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
            {s: [torch.from_numpy(a.copy()) for a in v]
             for s, v in ins.items()})


# B, H, W, I, O: R = 128 tiles in the JAX kernels, R = 50 takes the XLA
# fallback
FUSED = {"tiles": (2, 8, 8, 32, 16), "fallback": (2, 5, 5, 8, 24)}


@pytest.mark.parametrize("shape", sorted(FUSED))
@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_conv1x1_bn_act_forward_and_grad_match_jax(shape, is_test, residual):
    B, H, W, I, O = FUSED[shape]
    ins = _fused_ins(B, H, W, I, O, residual)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "act": "relu"}
    jins, tins = _both(ins)
    want = jax_op("conv1x1_bn_act").fn(attrs, jins)
    got = torch_op("conv1x1_bn_act").fn(attrs, tins)
    assert sorted(got) == sorted(want)
    for slot in want:
        _close(got[slot][0], want[slot][0], OP_TOL, slot)
    # cotangents for Y and, in training, the running-stat outputs
    og = {"Y": _rand(B, H, W, O, seed=7)}
    if not is_test:
        og["MeanOut"] = _rand(O, seed=8)
        og["VarianceOut"] = _rand(O, seed=9)
    jg = jax_op("conv1x1_bn_act").grad_fn(
        attrs, jins, want, {s: [jnp.asarray(a)] for s, a in og.items()})
    tg = torch_op("conv1x1_bn_act").grad_fn(
        attrs, tins, got, {s: [torch.from_numpy(a)] for s, a in og.items()})
    assert sorted(tg) == sorted(jg)
    for slot in jg:
        _close(tg[slot][0], jg[slot][0], OP_TOL, f"d{slot}")


def test_conv1x1_bn_act_runs_the_kernels_once_each(monkeypatch):
    """Training runs conv1x1_stats then scale_shift_act; test mode runs
    conv1x1_epilogue alone."""
    calls = []
    for name in ("conv1x1_stats", "conv1x1_epilogue", "scale_shift_act"):
        fn = getattr(tke, name)
        monkeypatch.setattr(tke, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    _, tins = _both(_fused_ins(1, 4, 4, 8, 8, True))
    for is_test in (False, True):
        torch_op("conv1x1_bn_act").fn({"is_test": is_test, "act": "relu"},
                                      tins)
    assert calls == ["conv1x1_stats", "scale_shift_act", "conv1x1_epilogue"]
