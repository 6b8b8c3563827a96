"""The port's ops under mixed precision (AMP) against the JAX package's.

AMP is the JAX package's bf16-compute / f32-master-weight policy
(``paddle_tpu/ops/common.py``): each product casts its f32 operands to
bf16 and returns bf16 (accumulating in f32), the norms and the loss
reduce in f32, and elementwise ops promote as jnp does. Each op on the
port's training, ResNet and serving paths is run under AMP in both
packages on the same numpy inputs (bf16 inputs are the same bf16 values
on both sides), forward and gradient (``grad_fn`` where the op has one,
else ``jax.vjp`` against ``torch.autograd.grad``), and every output's
and gradient's dtype must be JAX's. Tolerance: rtol 2e-2 / atol 2e-3, the
JAX package's own AMP tolerance (tests/test_norm_grads.py): bf16 rounds
a product's result at 2^-9 of its size, and two f32 sums in another
order round apart at a tie. AMP is set in both packages with
``monkeypatch`` (no ``set_amp`` call pins the JAX package's state).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX ops)
import paddle_tpu.ops.common as jax_common
import paddle_tpu_torch as pt
import paddle_tpu_torch.ops.common as torch_common
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch import flags
from paddle_tpu_torch.core.registry import get_op as torch_op
from paddle_tpu_torch.core.types import to_numpy

torch.set_num_threads(1)
TOL = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture
def amp(monkeypatch):
    monkeypatch.setattr(jax_common, "_AMP", True)
    monkeypatch.setattr(torch_common, "_AMP", True)


# --- the policy -------------------------------------------------------------
def test_amp_policy_defers_to_the_flag_until_set(monkeypatch):
    """As in the JAX package: unset follows --use_amp, set_amp wins."""
    monkeypatch.setattr(torch_common, "_AMP", torch_common._UNSET)
    monkeypatch.setitem(flags._values, "use_amp", False)
    assert not pt.amp_enabled() and not flags.FLAGS.use_amp
    flags.FLAGS.use_amp = "on"
    assert pt.amp_enabled()
    pt.set_amp(False)
    assert not pt.amp_enabled() and flags.FLAGS.use_amp
    pt.set_amp(True)
    flags.FLAGS.use_amp = False
    assert pt.amp_enabled()
    assert flags._DEFAULTS["use_amp"] is False


def test_amp_cast_casts_f32_only(amp):
    f, d, i = (torch.ones(2, dtype=t) for t in (torch.float32,
                                                torch.float64, torch.int64))
    cf, cd, ci = torch_common.amp_cast(f, d, i)
    assert (cf.dtype, cd.dtype, ci.dtype) == (torch.bfloat16, torch.float64,
                                              torch.int64)
    assert torch_common.amp_cast(f).dtype == torch.bfloat16


def test_bf16_products_keep_the_callers_reduction_setting():
    """cuBLAS's bf16 reduced-precision reductions are off inside an AMP
    product and back to the caller's setting after it."""
    flags_ = torch.backends.cuda.matmul
    prev = flags_.allow_bf16_reduced_precision_reduction
    x = torch.ones(4, 3, dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones(3, 2, dtype=torch.bfloat16, requires_grad=True)
    seen = []
    orig = torch.matmul

    def spy(a, b):
        seen.append(flags_.allow_bf16_reduced_precision_reduction)
        return orig(a, b)

    try:
        flags_.allow_bf16_reduced_precision_reduction = True
        torch.matmul = spy
        y = torch_common.matmul(x, w)
        y.sum().backward()
    finally:
        torch.matmul = orig
    assert flags_.allow_bf16_reduced_precision_reduction
    flags_.allow_bf16_reduced_precision_reduction = prev
    assert seen and not any(seen)
    assert y.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16


def test_bf16_fetches_come_back_as_f32_numpy():
    """numpy has no bf16: a fetch widens it, which is exact."""
    t = torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16)
    a = to_numpy(t)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, t.float().numpy())


# --- ops, forward and gradient ---------------------------------------------
def _pair(a, dtype):
    """The same values as a jax array and a torch tensor in ``dtype``
    ("float32", "bfloat16" or an integer numpy dtype)."""
    if dtype == "bfloat16":
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _close(got, want, what):
    assert _name(got.dtype) == _name(want.dtype), (what, got.dtype,
                                                    want.dtype)
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape)
    np.testing.assert_allclose(
        to_numpy(got), np.asarray(jnp.asarray(want).astype(jnp.float32)),
        err_msg=what, **TOL)


def _check_op(op_type, attrs, ins, diff, outs, seed=0):
    """Run ``op_type`` in both packages on ``ins`` ({slot: [(array,
    dtype)]}), compare the ``outs`` slots, then the gradients of those
    outputs under one random cotangent (in each output's dtype) with
    respect to the first input of each ``diff`` slot."""
    j = {s: [_pair(a, d)[0] for a, d in v] for s, v in ins.items()}
    t = {s: [_pair(a, d)[1] for a, d in v] for s, v in ins.items()}
    jdef, tdef = jax_op(op_type), torch_op(op_type)
    want = jdef.fn(attrs, j)
    rng = np.random.RandomState(seed + 1)
    if tdef.grad_fn is not None:
        got = tdef.fn(attrs, t)
        cts = {s: np.asarray(rng.randn(*want[s][0].shape), np.float32)
               for s in outs}
        jg = jdef.grad_fn(attrs, j, want, {
            s: [jnp.asarray(c).astype(want[s][0].dtype)]
            for s, c in cts.items()})
        tg = tdef.grad_fn(attrs, t, got, {
            s: [torch.from_numpy(c).to(got[s][0].dtype)]
            for s, c in cts.items()})
        grads = [(tg[s][0], jg[s][0], s) for s in diff]
    else:
        def jf(*xs):
            full = dict(j)
            for s, x in zip(diff, xs):
                full[s] = [x] + list(j[s][1:])
            o = jdef.fn(attrs, full)
            return [o[s][0] for s in outs]

        ys, vjp = jax.vjp(jf, *(j[s][0] for s in diff))
        cts = [np.asarray(rng.randn(*y.shape), np.float32) for y in ys]
        jgs = vjp([jnp.asarray(c).astype(y.dtype) for c, y in zip(cts, ys)])
        leaves = [t[s][0].requires_grad_() for s in diff]
        got = tdef.fn(attrs, t)
        tys = [got[s][0] for s in outs]
        tgs = torch.autograd.grad(
            tys, leaves, [torch.from_numpy(c).to(y.dtype)
                          for c, y in zip(cts, tys)])
        grads = list(zip(tgs, jgs, diff))
    for s in outs:
        _close(got[s][0], want[s][0], f"{op_type}.{s}")
    for g, w, s in grads:
        _close(g, w, f"d{op_type}/d{s}")
    return got


def _r(*shape, seed=0, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


CONV_CASES = {
    # (data_format, x shape, filter shape, strides, paddings, x dtype)
    "nhwc_3x3_f32_input": ("NHWC", (2, 6, 6, 4), (3, 3, 4, 8), 1, 1,
                           "float32"),
    "nhwc_3x3_s2_bf16_input": ("NHWC", (2, 7, 7, 4), (3, 3, 4, 8), 2, 1,
                               "bfloat16"),
    "nhwc_1x1": ("NHWC", (2, 5, 5, 8), (1, 1, 8, 6), 1, 0, "float32"),
    "nchw_3x3": ("NCHW", (2, 4, 6, 6), (8, 4, 3, 3), 1, 1, "float32"),
    "nchw_1x1_bf16_input": ("NCHW", (2, 8, 5, 5), (6, 8, 1, 1), 1, 0,
                            "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_casts_and_returns_bf16(amp, case):
    fmt, xs, ws, stride, pad, xdt = CONV_CASES[case]
    got = _check_op("conv2d", {"data_format": fmt, "strides": stride,
                               "paddings": pad, "dilations": 1, "groups": 1},
                    {"Input": [(_r(*xs), xdt)],
                     "Filter": [(_r(*ws, seed=1, scale=0.3), "float32")]},
                    ["Input", "Filter"], ["Output"])
    assert got["Output"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("ptype,ksize,stride,pad,glob", [
    ("max", 3, 2, 1, False), ("avg", 2, 2, 0, False), ("avg", 1, 1, 0,
                                                       True)])
def test_pool2d_keeps_the_dtype(amp, ptype, ksize, stride, pad, glob):
    _check_op("pool2d", {"data_format": "NHWC", "pooling_type": ptype,
                         "ksize": ksize, "strides": stride, "paddings": pad,
                         "global_pooling": glob},
              {"X": [(_r(2, 6, 6, 4), "bfloat16")]}, ["X"], ["Out"])


def _bn_ins(x_dtype):
    C = 4
    return {"X": [(_r(4, 3, 3, C), x_dtype)],
            "Scale": [(1.0 + 0.2 * _r(C, seed=1), "float32")],
            "Bias": [(0.1 * _r(C, seed=2), "float32")],
            "Mean": [(0.1 * _r(C, seed=3), "float32")],
            "Variance": [(1.0 + 0.1 * np.abs(_r(C, seed=4)), "float32")]}


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_batch_norm_reduces_in_f32_and_keeps_x_dtype(amp, is_test, x_dtype):
    got = _check_op("batch_norm", {"data_layout": "NHWC", "momentum": 0.9,
                                   "epsilon": 1e-5, "is_test": is_test},
                    _bn_ins(x_dtype), ["X", "Scale", "Bias"],
                    ["Y", "MeanOut", "VarianceOut"])
    assert _name(got["Y"][0].dtype) == x_dtype
    assert got["MeanOut"][0].dtype == torch.float32


def test_layer_norm_reduces_in_f32_and_keeps_x_dtype(amp):
    got = _check_op("layer_norm", {"begin_norm_axis": 2, "epsilon": 1e-5},
                    {"X": [(_r(2, 3, 8), "bfloat16")],
                     "Scale": [(1.0 + 0.1 * _r(8, seed=1), "float32")],
                     "Bias": [(0.1 * _r(8, seed=2), "float32")]},
                    ["X", "Scale", "Bias"], ["Y"])
    assert got["Y"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("xshape,yshape,xd", [((6, 4), (4, 5), 1),
                                              ((2, 3, 4), (4, 5), 2)])
def test_mul_is_a_bf16_product(amp, xshape, yshape, xd):
    got = _check_op("mul", {"x_num_col_dims": xd, "y_num_col_dims": 1},
                    {"X": [(_r(*xshape), "float32")],
                     "Y": [(_r(*yshape, seed=1), "float32")]},
                    ["X", "Y"], ["Out"])
    assert got["Out"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("ty,alpha", [(False, 1.0), (True, 0.125)])
def test_matmul_is_a_bf16_product(amp, ty, alpha):
    ys = (2, 3, 5, 4) if ty else (2, 3, 4, 5)
    _check_op("matmul", {"transpose_X": False, "transpose_Y": ty,
                         "alpha": alpha},
              {"X": [(_r(2, 3, 6, 4), "float32")],
               "Y": [(_r(*ys, seed=1), "float32")]}, ["X", "Y"], ["Out"])


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy_from_bf16_logits(amp, soft):
    """The loss in f32 from bf16 logits; its gradient in the logits'
    dtype."""
    label = (np.abs(_r(6, 10, seed=1)) if soft else
             np.random.RandomState(1).randint(0, 10, (6, 1)))
    got = _check_op("softmax_with_cross_entropy", {"soft_label": soft},
                    {"Logits": [(_r(6, 10), "bfloat16")],
                     "Label": [(label, "float32" if soft else np.int64)]},
                    ["Logits"], ["Loss"])
    assert got["Loss"][0].dtype == torch.float32


@pytest.mark.parametrize("yshape,ydtype", [((4,), "float32"),
                                           ((), "float32"),
                                           ((3, 4), "bfloat16")])
def test_elementwise_add_promotes_as_jnp(amp, yshape, ydtype):
    """bf16 activations meet f32 biases: jnp widens to f32, also against
    a 0-dim f32 operand, where torch alone would keep bf16."""
    got = _check_op("elementwise_add", {"axis": -1},
                    {"X": [(_r(3, 4), "bfloat16")],
                     "Y": [(_r(*yshape, seed=1), ydtype)]}, ["X", "Y"],
                    ["Out"])
    assert got["Out"][0].dtype == (torch.bfloat16 if ydtype == "bfloat16"
                                   else torch.float32)


@pytest.mark.parametrize("op_type,attrs", [
    ("mean", {}), ("relu", {}), ("softmax", {"axis": -1}),
    ("scale", {"scale": 0.5, "bias": 0.25})])
def test_unary_ops_keep_bf16(amp, op_type, attrs):
    got = _check_op(op_type, attrs, {"X": [(_r(3, 5), "bfloat16")]}, ["X"],
                    ["Out"])
    assert got["Out"][0].dtype == torch.bfloat16


def test_sum_of_bf16_and_f32_grads_is_f32(amp):
    _check_op("sum", {}, {"X": [(_r(3, 4), "bfloat16"),
                                (_r(3, 4, seed=1), "float32")]}, ["X"],
              ["Out"])


def _opt_ins(p_dtype, **extra):
    ins = {"Param": [(_r(4, 3), p_dtype)], "Grad": [(_r(4, 3, seed=1),
                                                     "float32")],
           "LearningRate": [(np.array([0.1], np.float32), "float32")]}
    ins.update({k: [(v, "float32")] for k, v in extra.items()})
    return ins


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op_type", ["sgd", "momentum", "adam"])
def test_optimizer_updates_take_the_jax_dtypes(amp, op_type, p_dtype):
    """A parameter an AMP program declared bf16 (fed by a bf16
    activation) is updated as JAX updates it: momentum's f32 velocity
    widens it to f32, sgd and adam keep its dtype; moments stay f32."""
    extra = {}
    if op_type == "momentum":
        extra = {"Velocity": _r(4, 3, seed=2)}
    if op_type == "adam":
        extra = {"Moment1": 0.1 * _r(4, 3, seed=2),
                 "Moment2": np.abs(_r(4, 3, seed=3)),
                 "Beta1Pow": np.array([0.9], np.float32),
                 "Beta2Pow": np.array([0.999], np.float32)}
    j = {s: [_pair(a, d)[0] for a, d in v]
         for s, v in _opt_ins(p_dtype, **extra).items()}
    t = {s: [_pair(a, d)[1] for a, d in v]
         for s, v in _opt_ins(p_dtype, **extra).items()}
    attrs = {"mu": 0.9}
    want = jax_op(op_type).fn(attrs, j)
    got = torch_op(op_type).fn(attrs, t)
    assert sorted(got) == sorted(want)
    for s in want:
        _close(got[s][0], want[s][0], f"{op_type}.{s}")


def _stack_ins(L=2, b=2, T=16, d=32, d_ff=64, seed=0):
    from paddle_tpu_torch.ops.pipeline_ops import _STACK_SLOTS

    rng = np.random.RandomState(seed)
    shapes = {"ln1_s": (L, d), "ln1_b": (L, d), "qkv_w": (L, d, 3 * d),
              "out_w": (L, d, d), "ln2_s": (L, d), "ln2_b": (L, d),
              "ff_w1": (L, d, d_ff), "ff_b1": (L, d_ff),
              "ff_w2": (L, d_ff, d), "ff_b2": (L, d)}
    ins = {"X": [(rng.randn(b, T, d).astype(np.float32), "float32")]}
    for slot, key in _STACK_SLOTS.items():
        w = rng.randn(*shapes[key]).astype(np.float32) * 0.2
        if key.endswith("_s"):
            w = 1.0 + 0.1 * w
        ins[slot] = [(w, "float32")]
    return ins


def test_pipelined_transformer_stack_under_amp(amp):
    """bf16 projections (q/k/v cast back to f32, so attention stays f32);
    activations and gradients of the f32 weights stay f32."""
    got = _check_op("pipelined_transformer_stack",
                    {"num_heads": 4, "num_kv_heads": None, "use_rope": False,
                     "causal": True, "n_microbatches": None, "remat": False},
                    _stack_ins(), ["X", "QkvW", "OutW", "FfW1", "FfW2",
                                   "Ln1S", "FfB2"], ["Out"])
    assert got["Out"][0].dtype == torch.float32


def test_stack_under_amp_differs_from_f32(monkeypatch):
    """The casts are taken: under AMP the stack's output moves off the f32
    one by more than f32 rounding."""
    ins = {s: [_pair(a, d)[1] for a, d in v] for s, v in _stack_ins().items()}
    attrs = {"num_heads": 4, "causal": True}
    fn = torch_op("pipelined_transformer_stack").fn
    monkeypatch.setattr(torch_common, "_AMP", False)
    f32 = fn(attrs, ins)["Out"][0]
    monkeypatch.setattr(torch_common, "_AMP", True)
    bf16 = fn(attrs, ins)["Out"][0]
    rel = float((bf16 - f32).abs().max() / f32.abs().max())
    assert 1e-4 < rel < 2e-2, rel


def test_flash_wrappers_refuse_bf16_naming_the_roadmap():
    """No fallback: since the flash kernels' bf16 instances landed, an
    all-bf16 q/k/v passes the launch path's check, and a bf16 q beside
    f32 k/v (a mix no kernel takes) is refused before anything is built,
    naming the dtypes."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16)
    fa._check_kernel_inputs(q, q, q)
    with pytest.raises(TypeError, match="torch.bfloat16, torch.float32"):
        fa._check_kernel_inputs(q, q.float(), q.float())
