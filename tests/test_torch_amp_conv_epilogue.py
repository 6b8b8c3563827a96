"""The conv-epilogue kernels' plain versions and the fused op under AMP
against the JAX package.

Under AMP (bf16 products on f32 master weights) the fused
``conv1x1_bn_act`` op hands the kernels bf16 x and W. The Pallas kernels
accumulate those products in f32 (``preferred_element_type``) and round
only the output; the port's plain versions used to take the product in
the operands' dtype, which erred by 5.9e-4 of the largest statistic and
moved 14% of the epilogue's outputs at R512 I256 O128 (relu, seed 0).
Since the product is taken of the f32-upcast operands, the plain versions
are held here against the Pallas kernels (interpret mode, bf16 inputs)
at:

- statistics: each channel's error within 1e-5 of its summed magnitude
  (sum |y|, sum y^2; measured 1.9e-7 of the largest statistic);
- bf16 outputs: within one bf16 ulp (two f32 sums in another order round
  apart at a tie), on at most 1e-3 of the values (measured 9e-5); the ulp
  is taken at no less than 1/256 of the largest |value|, since f32 sums
  in another order differ by ~1e-7 of the summed terms, more than a bf16
  ulp of a value that cancels to near zero.

The fused op and its grad_fn under AMP are held against the JAX op under
AMP, with every output's dtype, at rtol 2e-2 / atol 2e-3 (the JAX
package's own AMP tolerance, tests/test_norm_grads.py). The CUDA launch
paths take the dtype mixes the Pallas kernels take under AMP and refuse
any other, naming the dtypes. AMP is set in both packages with
``monkeypatch`` (no ``set_amp`` call pins the JAX package's state).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX ops)
import paddle_tpu.ops.common as jax_common
import paddle_tpu_torch  # noqa: F401  (registers the port's ops)
import paddle_tpu_torch.ops.common as torch_common
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu.kernels import conv_epilogue as jke
from paddle_tpu_torch.core.registry import get_op as torch_op
from paddle_tpu_torch.kernels import conv_epilogue as tke

torch.set_num_threads(1)
STATS_TOL = 1e-5           # of each channel's summed magnitude
DIFFER_FRACTION = 1e-3     # bf16 outputs one ulp apart
OP_TOL = dict(rtol=2e-2, atol=2e-3)
# R512 tiles in the Pallas kernels; R100 takes the JAX wrappers' fallback
SHAPES = {"repair": (512, 256, 128), "fallback": (100, 32, 16)}


@pytest.fixture
def amp(monkeypatch):
    monkeypatch.setattr(jax_common, "_AMP", True)
    monkeypatch.setattr(torch_common, "_AMP", True)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _bf16_pair(a):
    """The same bf16 values for both packages."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulp(a, floor):
    """One bf16 ulp (8 significant bits) at max(|a|, floor)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), floor)))
    return 2.0 ** (e - 7)


def _assert_bf16_close(got, want, what):
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, what
    g, w = _f32(got), _f32(want)
    diff = np.abs(g - w)
    floor = max(np.abs(w).max() / 256, 2.0 ** -126)
    assert (diff <= np.maximum(_ulp(g, floor), _ulp(w, floor))).all(), (
        what, diff.max())
    assert (diff > 0).mean() <= DIFFER_FRACTION, (what, (diff > 0).mean())


def _kernel_inputs(R, I, O, residual, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(R, I).astype(np.float32)
    w = (rng.randn(I, O) * I ** -0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.randn(O)).astype(np.float32)
    shift = (0.3 * rng.randn(O)).astype(np.float32)
    res = None if residual is None else rng.randn(R, O).astype(np.float32)
    return x, w, scale, shift, res


def _residual_pair(res, dtype):
    """(jax, torch) residual in ``dtype`` ("bfloat16" or "float32")."""
    if res is None:
        return None, None
    if dtype == "bfloat16":
        return _bf16_pair(res)
    return jnp.asarray(res), torch.from_numpy(res)


# --- the plain versions against the Pallas kernels, bf16 inputs -------------
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_conv1x1_stats_plain_matches_pallas_in_bf16(shape):
    """The statistics come from the f32 product, not from the rounded y:
    the repair, checked at the shape it was found at."""
    R, I, O = SHAPES[shape]
    x, w, *_ = _kernel_inputs(R, I, O, None)
    (jx, tx), (jw, tw) = _bf16_pair(x), _bf16_pair(w)
    jy, jstats = jke.conv1x1_stats(jx, jw, interpret=True)
    ty, tstats = tke.conv1x1_stats(tx, tw)
    _assert_bf16_close(ty, jy, "y")
    assert tstats.dtype == torch.float32
    y = _f32(jy)
    mass = np.stack([np.abs(y).sum(0), (y * y).sum(0)])
    err = np.abs(tstats.numpy() - np.asarray(jstats)) / mass
    assert err.max() <= STATS_TOL, err.max()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("residual", [None, "bfloat16", "float32"])
@pytest.mark.parametrize("act", [None, "relu"])
def test_conv1x1_epilogue_plain_matches_pallas_in_bf16(shape, residual, act):
    R, I, O = SHAPES[shape]
    x, w, scale, shift, res = _kernel_inputs(R, I, O, residual)
    (jx, tx), (jw, tw) = _bf16_pair(x), _bf16_pair(w)
    jr, tr = _residual_pair(res, residual)
    want = jke.conv1x1_epilogue(jx, jw, jnp.asarray(scale),
                                jnp.asarray(shift), residual=jr, act=act,
                                interpret=True)
    got = tke.conv1x1_epilogue(tx, tw, torch.from_numpy(scale),
                               torch.from_numpy(shift), residual=tr, act=act)
    _assert_bf16_close(got, want, "out")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("residual", [None, "bfloat16", "float32"])
@pytest.mark.parametrize("act", [None, "relu"])
def test_scale_shift_act_plain_matches_pallas_in_bf16(shape, residual, act):
    R, _, O = SHAPES[shape]
    _, _, scale, shift, res = _kernel_inputs(R, 1, O, residual)
    jy, ty = _bf16_pair(_rand(R, O, seed=6))
    jr, tr = _residual_pair(res, residual)
    want = jke.scale_shift_act(jy, jnp.asarray(scale), jnp.asarray(shift),
                               residual=jr, act=act, interpret=True)
    got = tke.scale_shift_act(ty, torch.from_numpy(scale),
                              torch.from_numpy(shift), residual=tr, act=act)
    _assert_bf16_close(got, want, "out")


def test_bf16_tile_plan_covers_k_in_64_deep_stages():
    """The bf16 instances run 64-deep K stages; a split-K slice stays at
    least 128 deep, as the f32 instance's."""
    for R, I, O in ((784, 1024, 256), (3136, 64, 256), (100, 30, 9)):
        plan = tke.tile_plan(R, I, O, split_k=True, k_tile=tke.K_TILE_BF16)
        k_steps = -(-I // tke.K_TILE_BF16)
        assert plan.i_pad == k_steps * tke.K_TILE_BF16
        assert plan.slices * plan.slice_steps >= k_steps
        assert (plan.slices - 1) * plan.slice_steps < max(k_steps, 1)
        if plan.slices > 1:
            assert plan.slice_steps * tke.K_TILE_BF16 >= 128


# --- what the CUDA launch paths take ----------------------------------------
def _mats(R=16, I=8, O=4):
    x, w, scale, shift, res = (torch.from_numpy(a) for a in
                               _kernel_inputs(R, I, O, "float32"))
    return x, w, scale, shift, res


@pytest.mark.parametrize("residual", [None, torch.bfloat16, torch.float32])
def test_check_takes_the_amp_dtype_mix(residual):
    """bf16 x and W, f32 scale/shift, a bf16 or f32 residual: the mixes
    the Pallas kernels take under AMP (the transpiled serving program's
    BN-folded shortcuts hand the epilogue an f32 residual)."""
    x, w, scale, shift, res = _mats()
    r = None if residual is None else res.to(residual)
    tke._check("conv1x1_epilogue", x.bfloat16(), w.bfloat16(),
               (scale, shift), r)
    tke._check("conv1x1_stats", x.bfloat16(), w.bfloat16())
    tke._check("scale_shift_act", res.bfloat16(), None, (scale, shift), r)


@pytest.mark.parametrize("case", ["x_bf16_w_f32", "x_f32_w_bf16",
                                  "scale_bf16", "residual_f16",
                                  "apply_residual_f64", "f16"])
def test_launch_refuses_other_dtype_mixes_and_names_them(case):
    """Refused before anything is built or bound (no nvcc here), so the
    checks run on the CPU."""
    x, w, scale, shift, res = _mats()
    xb, wb = x.bfloat16(), w.bfloat16()
    calls = {
        "x_bf16_w_f32": lambda: tke._launch_stats(xb, w),
        "x_f32_w_bf16": lambda: tke._launch_stats(x, wb),
        "scale_bf16": lambda: tke._check("conv1x1_epilogue", xb, wb,
                                         (scale.bfloat16(), shift), None),
        "residual_f16": lambda: tke._launch_epilogue(
            xb, wb, scale, shift, res.half(), "relu"),
        "apply_residual_f64": lambda: tke._launch_apply(
            res.bfloat16(), scale, shift, res.double(), None),
        "f16": lambda: tke._launch_stats(x.half(), w.half()),
    }
    with pytest.raises(TypeError, match="got .*(bfloat16|float16|float64)"):
        calls[case]()
    assert (tke.conv1x1_stats.launches, tke.conv1x1_epilogue.launches,
            tke.scale_shift_act.launches) == (0, 0, 0)


# --- the fused op and its grad_fn under AMP against the JAX op --------------
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


def _both(ins, x_dtype):
    """(jax ins, torch ins); X (and the residual) in ``x_dtype``."""
    j = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    t = {s: [torch.from_numpy(a.copy()) for a in v] for s, v in ins.items()}
    if x_dtype == "bfloat16":
        for slot in ("X", "Residual"):
            if slot in ins:
                j[slot][0], t[slot][0] = _bf16_pair(ins[slot][0])
    return j, t


def _assert_same(got, want, what):
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (
        what, got.dtype, want.dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), err_msg=what, **OP_TOL)


# B, H, W, I, O: R = 128 tiles in the JAX kernels, R = 50 their fallback
FUSED = {"tiles": (2, 8, 8, 32, 16), "fallback": (2, 5, 5, 8, 24)}


@pytest.mark.parametrize("shape", sorted(FUSED))
@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_conv1x1_bn_act_under_amp_matches_jax(amp, shape, is_test, residual,
                                              x_dtype):
    """X in f32 (cast on entry, Y back in f32) or in bf16 (an AMP
    network's activations): forward, grads and every output's dtype."""
    B, H, W, I, O = FUSED[shape]
    ins = _fused_ins(B, H, W, I, O, residual)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "act": "relu"}
    jins, tins = _both(ins, x_dtype)
    want = jax_op("conv1x1_bn_act").fn(attrs, jins)
    got = torch_op("conv1x1_bn_act").fn(attrs, tins)
    assert sorted(got) == sorted(want)
    for slot in want:
        if slot == "ConvOut" and is_test:
            continue  # a placeholder
        _assert_same(got[slot][0], want[slot][0], slot)
    og = {"Y": _rand(B, H, W, O, seed=7)}
    if not is_test:
        og["MeanOut"] = _rand(O, seed=8)
        og["VarianceOut"] = _rand(O, seed=9)
    jog = {s: [jnp.asarray(a).astype(want[s][0].dtype)]
           for s, a in og.items()}
    tog = {s: [torch.from_numpy(a).to(got[s][0].dtype)]
           for s, a in og.items()}
    jg = jax_op("conv1x1_bn_act").grad_fn(attrs, jins, want, jog)
    tg = torch_op("conv1x1_bn_act").grad_fn(attrs, tins, got, tog)
    assert sorted(tg) == sorted(jg)
    for slot in jg:
        _assert_same(tg[slot][0], jg[slot][0], f"d{slot}")
