"""The training slice's op kernels against the JAX package's.

Each op the port registers is run in both packages on the same numpy
inputs through the registries (``get_op(type).fn``), and so is each
custom gradient (``grad_fn``). Ops whose gradient is the generic vjp are
differentiated in both (``torch.autograd.grad`` against ``jax.vjp``),
as the generic ``grad`` op does. ``adam`` runs 3 updates, each feeding
its outputs back in. f32 throughout; atol = rtol = 1e-5 unless a case
states otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX ops)
import paddle_tpu_torch  # noqa: F401  (registers the port's ops)
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core.registry import get_op as torch_op

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _jax_ins(ins):
    return {slot: [jnp.asarray(a) for a in arrs] for slot, arrs in ins.items()}


def _torch_ins(ins):
    return {slot: [torch.from_numpy(np.array(a)) for a in arrs]
            for slot, arrs in ins.items()}


def _jax_dtype(dtype):
    """The dtype JAX gives for ``dtype``: int64 is int32 unless x64 is
    enabled."""
    x64 = jax.config.read("jax_enable_x64")
    return np.dtype(np.int32) if dtype == np.int64 and not x64 else dtype


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert _jax_dtype(got.dtype) == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _run_both(op_type, attrs, ins, tol=TOL):
    want = jax_op(op_type).fn(attrs, _jax_ins(ins))
    got = torch_op(op_type).fn(attrs, _torch_ins(ins))
    assert sorted(got) == sorted(want), (op_type, sorted(got), sorted(want))
    for slot in want:
        assert len(got[slot]) == len(want[slot])
        for g, w in zip(got[slot], want[slot]):
            _close(g, w, tol, f"{op_type}.{slot}")
    return got, want


def _vjp_both(op_type, attrs, ins, diff_slots, out_slot="Out", tol=TOL,
              seed=0):
    """Gradients of ``out_slot`` w.r.t. the first input of each of
    ``diff_slots`` under one random cotangent: jax.vjp of the JAX op
    against torch.autograd.grad of the port's."""
    jfn = jax_op(op_type).fn
    tfn = torch_op(op_type).fn
    jins = _jax_ins(ins)

    def jf(*xs):
        full = dict(jins)
        for slot, x in zip(diff_slots, xs):
            full[slot] = [x] + list(jins[slot][1:])
        return jfn(attrs, full)[out_slot][0]

    y, vjp = jax.vjp(jf, *(jins[s][0] for s in diff_slots))
    ct = np.asarray(np.random.RandomState(seed).randn(*y.shape), np.float32)
    want = vjp(jnp.asarray(ct))
    tins = _torch_ins(ins)
    leaves = [tins[s][0].requires_grad_() for s in diff_slots]
    out = tfn(attrs, tins)[out_slot][0]
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for slot, g, w in zip(diff_slots, got, want):
        _close(g, w, tol, f"d{op_type}/d{slot}")


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --- creation and plain tensor ops ------------------------------------------
@pytest.mark.parametrize("attrs", [
    {"shape": [2, 3], "value": 1.5, "dtype": "float32"},
    {"shape": [4], "value": 7, "dtype": "int64"},
    {"shape": [1], "value": 0.9, "dtype": "float32"},
])
@pytest.mark.filterwarnings("ignore:Explicitly requested dtype")
def test_fill_constant(attrs):
    _run_both("fill_constant", attrs, {})


def test_uniform_random_draws_in_range_from_the_generator():
    """The bits differ from JAX's threefry (the RNG slice); shape, dtype,
    range and determinism per seed are the contract."""
    fn = torch_op("uniform_random").fn
    attrs = {"shape": [64, 32], "dtype": "float32", "min": -0.3, "max": 0.3}
    a = fn(attrs, {}, rng=torch.Generator().manual_seed(3))["Out"][0]
    b = fn(attrs, {}, rng=torch.Generator().manual_seed(3))["Out"][0]
    c = fn(attrs, {}, rng=torch.Generator().manual_seed(4))["Out"][0]
    want = jax_op("uniform_random").fn(attrs, {},
                                       rng=jax.random.PRNGKey(0))["Out"][0]
    assert a.shape == tuple(want.shape) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= -0.3 and float(a.max()) < 0.3
    assert abs(float(a.mean())) < 0.03 and float(a.std()) > 0.15


def test_assign():
    _run_both("assign", {}, {"X": [_rand(3, 4)]})


@pytest.mark.parametrize("shape", [[0, -1], [-1, 4], [6, 4]])
def test_reshape(shape):
    _run_both("reshape", {"shape": shape}, {"X": [_rand(2, 3, 4)]})
    _vjp_both("reshape", {"shape": shape}, {"X": [_rand(2, 3, 4)]}, ["X"])


@pytest.mark.parametrize("axes,starts,ends", [([0], [0], [5]),
                                              ([1, 2], [1, 0], [3, 2])])
def test_slice(axes, starts, ends):
    attrs = {"axes": axes, "starts": starts, "ends": ends}
    ins = {"X": [_rand(8, 4, 3)]}
    _run_both("slice", attrs, ins)
    _vjp_both("slice", attrs, ins, ["X"])


@pytest.mark.parametrize("yshape,axis", [((2, 3, 4), -1), ((4,), -1),
                                         ((3,), 1), ((3, 4), 1)])
def test_elementwise_add(yshape, axis):
    ins = {"X": [_rand(2, 3, 4)], "Y": [_rand(*yshape, seed=1)]}
    _run_both("elementwise_add", {"axis": axis}, ins)
    _vjp_both("elementwise_add", {"axis": axis}, ins, ["X", "Y"])


def test_sum():
    _run_both("sum", {}, {"X": [_rand(3, 4, seed=i) for i in range(3)]})


def test_mean():
    ins = {"X": [_rand(5, 7)]}
    _run_both("mean", {}, ins)
    _vjp_both("mean", {}, ins, ["X"])


@pytest.mark.parametrize("xshape,yshape,xd", [((6, 4), (4, 5), 1),
                                              ((2, 3, 4), (4, 5), 2)])
def test_mul(xshape, yshape, xd):
    attrs = {"x_num_col_dims": xd, "y_num_col_dims": 1}
    ins = {"X": [_rand(*xshape)], "Y": [_rand(*yshape, seed=1)]}
    _run_both("mul", attrs, ins)
    _vjp_both("mul", attrs, ins, ["X", "Y"])


# --- lookup_table and its dense gradient ------------------------------------
# in-range ids, the padding id, and ids that are negative or past the
# table (XLA gather semantics: negative ids wrap once, others clamp in the
# forward; the gradient drops what lies outside the table)
IDS = np.array([[0, 3, 9], [3, 2, 2], [-1, 5, 11]], np.int64)


@pytest.mark.parametrize("padding_idx", [None, 2])
@pytest.mark.parametrize("ids_shape", ["2d", "trailing_1"])
def test_lookup_table_and_grad(padding_idx, ids_shape):
    w = _rand(10, 4)
    ids = IDS if ids_shape == "2d" else IDS.reshape(9, 1)
    attrs = {"padding_idx": padding_idx, "is_sparse": False}
    ins = {"W": [w], "Ids": [ids]}
    got, want = _run_both("lookup_table", attrs, ins)
    og = _rand(*want["Out"][0].shape, seed=2)
    jg = jax_op("lookup_table").grad_fn(attrs, _jax_ins(ins), want,
                                        {"Out": [jnp.asarray(og)]})
    tg = torch_op("lookup_table").grad_fn(attrs, _torch_ins(ins), got,
                                          {"Out": [torch.from_numpy(og)]})
    assert tg["Ids"] == [None] and jg["Ids"] == [None]
    _close(tg["W"][0], jg["W"][0], what="dW")


def test_lookup_table_sparse_is_a_later_slice():
    ins = _torch_ins({"W": [_rand(10, 4)], "Ids": [IDS]})
    with pytest.raises(NotImplementedError, match="sparse"):
        torch_op("lookup_table").fn({"is_sparse": True}, ins)


# --- layer_norm and its hand-written gradient -------------------------------
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("ogs", [("Y",), ("Y", "Mean", "Variance"),
                                 ("Variance",)])
def test_layer_norm_and_grad(affine, ogs):
    x = _rand(2, 3, 8) * 3 + 1
    ins = {"X": [x]}
    if affine:
        ins["Scale"] = [_rand(8, seed=1)]
        ins["Bias"] = [_rand(8, seed=2)]
    attrs = {"epsilon": 1e-5, "begin_norm_axis": 2}
    got, want = _run_both("layer_norm", attrs, ins)
    og = {slot: _rand(*want[slot][0].shape, seed=5 + i)
          for i, slot in enumerate(ogs)}
    jg = jax_op("layer_norm").grad_fn(
        attrs, _jax_ins(ins), want,
        {s: [jnp.asarray(a)] for s, a in og.items()})
    tg = torch_op("layer_norm").grad_fn(
        attrs, _torch_ins(ins), got,
        {s: [torch.from_numpy(a)] for s, a in og.items()})
    assert sorted(tg) == sorted(jg)
    for slot in jg:
        _close(tg[slot][0], jg[slot][0], dict(atol=2e-5, rtol=1e-5),
               f"d{slot}")


# --- softmax_with_cross_entropy and its fused gradient ----------------------
@pytest.mark.parametrize("kind", ["hard", "smoothed", "soft"])
def test_softmax_with_cross_entropy_and_grad(kind):
    logits = _rand(6, 11) * 2
    rng = np.random.RandomState(1)
    if kind == "soft":
        label = rng.rand(6, 11).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = rng.randint(0, 11, (6, 1)).astype(np.int64)
    attrs = {"soft_label": kind == "soft",
             "label_smoothing": 0.1 if kind == "smoothed" else 0.0}
    ins = {"Logits": [logits], "Label": [label]}
    got, want = _run_both("softmax_with_cross_entropy", attrs, ins)
    og = _rand(6, 1, seed=3)
    jg = jax_op("softmax_with_cross_entropy").grad_fn(
        attrs, _jax_ins(ins), want, {"Loss": [jnp.asarray(og)]})
    tg = torch_op("softmax_with_cross_entropy").grad_fn(
        attrs, _torch_ins(ins), got, {"Loss": [torch.from_numpy(og)]})
    _close(tg["Logits"][0], jg["Logits"][0], what="dLogits")
    assert tg["Label"] == [None]


# --- optimizers ---------------------------------------------------------------
def test_sgd():
    _run_both("sgd", {}, {"Param": [_rand(4, 3)], "Grad": [_rand(4, 3, seed=1)],
                          "LearningRate": [np.array([0.1], np.float32)]})


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_three_updates(weight_decay):
    """Each update feeds its outputs back in, with a new gradient."""
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "weight_decay": weight_decay}
    state = {"Param": _rand(5, 4), "Moment1": np.zeros((5, 4), np.float32),
             "Moment2": np.zeros((5, 4), np.float32),
             "Beta1Pow": np.array([0.9], np.float32),
             "Beta2Pow": np.array([0.999], np.float32)}
    lr = np.array([1e-2], np.float32)
    for step in range(3):
        ins = {k: [v] for k, v in state.items()}
        ins["Grad"] = [_rand(5, 4, seed=10 + step)]
        ins["LearningRate"] = [lr]
        got, _ = _run_both("adam", attrs, ins, dict(atol=1e-6, rtol=1e-5))
        state = {k: got[k + "Out"][0].numpy()
                 for k in ("Param", "Moment1", "Moment2", "Beta1Pow",
                           "Beta2Pow")}


# --- the transformer stack: forward and its vjp ------------------------------
def _stack_ins(L=2, b=2, T=16, d=32, d_ff=64, seed=0):
    from paddle_tpu_torch.ops.pipeline_ops import _STACK_SLOTS

    rng = np.random.RandomState(seed)
    shapes = {"ln1_s": (L, d), "ln1_b": (L, d), "qkv_w": (L, d, 3 * d),
              "out_w": (L, d, d), "ln2_s": (L, d), "ln2_b": (L, d),
              "ff_w1": (L, d, d_ff), "ff_b1": (L, d_ff),
              "ff_w2": (L, d_ff, d), "ff_b2": (L, d)}
    ins = {"X": [rng.randn(b, T, d).astype(np.float32)]}
    for slot, key in _STACK_SLOTS.items():
        scale = 1.0 if key.startswith("ln") and key.endswith("_s") else 0.2
        w = rng.randn(*shapes[key]).astype(np.float32) * scale
        if key.endswith("_s"):
            w = 1.0 + 0.1 * w
        ins[slot] = [w]
    return ins


STACK_ATTRS = {"num_heads": 4, "num_kv_heads": None, "use_rope": False,
               "causal": True, "n_microbatches": None, "remat": False}


def test_pipelined_transformer_stack_forward_and_vjp():
    ins = _stack_ins()
    _run_both("pipelined_transformer_stack", STACK_ATTRS, ins,
              dict(atol=2e-5, rtol=1e-5))
    _vjp_both("pipelined_transformer_stack", STACK_ATTRS, ins,
              ["X", "QkvW", "OutW", "Ln1S", "FfW1", "FfB2"],
              tol=dict(atol=5e-5, rtol=1e-4))


def test_pipelined_transformer_stack_remat_is_a_later_slice():
    with pytest.raises(NotImplementedError, match="recompute"):
        torch_op("pipelined_transformer_stack").fn(
            dict(STACK_ATTRS, remat=True), _torch_ins(_stack_ins()))


def test_generic_grad_op_recomputes_the_forward_vjp():
    """The ``grad`` op run on its own (no recorded forward) recomputes
    the forward and gives its vjp, as the JAX ``grad`` kernel does."""
    x, y = _rand(6, 4), _rand(4, 5, seed=1)
    og = _rand(6, 5, seed=2)
    attrs = {"fwd_type": "mul", "fwd_attrs": {"x_num_col_dims": 1,
                                              "y_num_col_dims": 1},
             "in_slots": {"X": 1, "Y": 1}, "out_slots": ["Out"],
             "og": {"Out": [True]}, "diff": {"X": [True], "Y": [True]}}
    ins = {"I:X": [x], "I:Y": [y], "OG:Out": [og]}
    got = torch_op("grad").fn(attrs, _torch_ins(ins))
    want = jax_op("grad").fn(attrs, _jax_ins(ins))
    for slot in ("IG:X", "IG:Y"):
        _close(got[slot][0], want[slot][0], what=slot)
