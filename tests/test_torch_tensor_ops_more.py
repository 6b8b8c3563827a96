"""The port's 30 further tensor ops against the JAX package's, forward
and gradient, in f32 and bf16, and the registry's count.

Each case runs the reference's registered ``fn`` jitted under
``jax.vjp`` and the port's ``fn`` under ``torch.autograd`` on the same
seeded numpy inputs (float inputs cast to the case's dtype, integer ones
kept), with ties and bounds mixed in: equal elements of X and Y for the
comparisons and ``elementwise_max``/``min``, repeated maxima for
``reduce_max``/``min`` and ``argmax``, values at ``clip``'s bounds,
negative and out-of-range ids for ``gather`` and ``one_hot``. The
gradient is taken for every float input of an op with a float output
(comparisons, logic, ``argmax`` and ``one_hot`` give bool, int64 and a
constant and pass none, ``core/backward.py``'s ``NON_DIFFERENTIABLE``).
Without x64 JAX carries int64 as int32, so integer outputs are compared
by value.

Tolerance, with ``_ulps`` of ``test_torch_activation_ops.py``:
- exact, forward and gradient, for the shape ops (but ``expand``'s
  gradient, a sum over the copies), ``clip``,
  ``elementwise_max``/``min`` (a tie splits its gradient evenly in both
  packages), ``reduce_max``/``min`` (the same), the comparisons, the
  logic, ``argmax``, ``gather``, ``one_hot``, ``assign_value`` and
  ``fill_constant_batch_size_like``;
- the arithmetic (``elementwise_div``/``pow``, ``reduce_sum``/``mean``/
  ``prod``) and ``expand``'s gradient: at most ``F32_ULPS`` f32 or
  ``BF16_ULPS`` bf16 ulps. XLA and torch add a sum's terms in other
  orders and XLA fuses f32 products into multiply-adds; ``pow`` is XLA's
  polynomial against torch's. One exception: the transpose of ``jnp.tile``
  sums a bf16 gradient's copies in bf16, rounding at every add, where
  torch sums them in f32 and rounds once, so ``expand``'s bf16 gradient
  over 6 copies is held at ``BF16_SUM_ULPS`` (measured 6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX ops)
import paddle_tpu.ops  # noqa: F401
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core.registry import _REGISTRY
from paddle_tpu_torch.core.registry import get_op as torch_op
from test_torch_activation_ops import BF16_ULPS, F32_ULPS, _ulps

torch.set_num_threads(1)
BF16_SUM_ULPS = 8


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _ties(x, y):
    """y equal to x at every fifth element."""
    y = y.copy()
    flat_x, flat_y = x.reshape(-1), y.reshape(-1)
    n = min(flat_x.size, flat_y.size)
    flat_y[:n:5] = flat_x[:n:5]
    return y


def _cast(a, dtype, lib):
    if a.dtype != np.float32:
        return jnp.asarray(a) if lib == "jax" else torch.tensor(a)
    if lib == "jax":
        return jnp.asarray(a).astype(getattr(jnp, dtype))
    return torch.tensor(a).to(getattr(torch, dtype))


def run_both(op, attrs, ins, slot, dtype, seed=99):
    """Out ``slot`` of both packages and the gradients of each float
    input, as numpy (f32 for floats): (jax_out, jax_grads, port_out,
    port_grads); grads are [] when the output is not a float."""
    names = [(s, i) for s in sorted(ins) for i in range(len(ins[s]))]

    def pack(arrays):
        d = {}
        for (s, _), a in zip(names, arrays):
            d.setdefault(s, []).append(a)
        return d

    jarrs = [_cast(ins[s][i], dtype, "jax") for s, i in names]
    float_idx = [k for k, (s, i) in enumerate(names)
                 if ins[s][i].dtype == np.float32]

    def fwd(*floats):
        arrs = list(jarrs)
        for k, a in zip(float_idx, floats):
            arrs[k] = a
        return jax_op(op).fn(attrs, pack(arrs))[slot][0]

    jout = jax.jit(fwd)(*[jarrs[k] for k in float_idx])
    floating = jnp.issubdtype(jout.dtype, jnp.floating)
    tarrs = [_cast(ins[s][i], dtype, "torch") for s, i in names]
    for k in float_idx:
        tarrs[k].requires_grad_(floating)
    tout = torch_op(op).fn(attrs, pack(tarrs))[slot][0]
    assert tuple(tout.shape) == tuple(jout.shape), (tout.shape, jout.shape)
    jgrads, tgrads = [], []
    if floating and float_idx:
        assert str(tout.dtype).replace("torch.", "") == str(jout.dtype)
        g = np.asarray(np.random.RandomState(seed).randn(*jout.shape),
                       np.float32)
        _, vjp = jax.vjp(jax.jit(fwd), *[jarrs[k] for k in float_idx])
        jgrads = [np.asarray(a.astype(jnp.float32))
                  for a in vjp(jnp.asarray(g).astype(jout.dtype))]
        if tout.requires_grad:
            tout.backward(torch.tensor(g).to(tout.dtype))
        # an input the output does not depend on gets no gradient (zero)
        tgrads = [np.zeros(tarrs[k].shape, np.float32) if tarrs[k].grad is
                  None else tarrs[k].grad.float().numpy() for k in float_idx]
    if floating:
        return (np.asarray(jout.astype(jnp.float32)), jgrads,
                tout.detach().float().numpy(), tgrads)
    return np.asarray(jout), [], tout.numpy(), []


def _x(seed=0):
    return _rand(6, 8, seed=seed, scale=2.0)


def _cmp(op):
    x = _x()
    return (op, {}, {"X": [x], "Y": [_ties(x, _rand(6, 8, seed=1))]},
            "Out", True)


def _logic(op):
    x = (_rand(6, 8) > 0).astype(np.bool_)
    return (op, {}, {"X": [x], "Y": [(_rand(6, 8, seed=1) > 0)]}, "Out",
            True)


def _reduce_x(tied):
    x = _rand(3, 4, 5, seed=3, scale=1.5)
    if tied:
        x[:, 1] = x[:, 0]  # a maximum and a minimum held twice
    return x


# name -> (op, attrs, ins, out slot, exact)
CASES = {
    "elementwise_div": ("elementwise_div", {"axis": 1},
                        {"X": [_x()], "Y": [np.abs(_rand(8, seed=2)) + 0.5]},
                        "Out", False),
    "elementwise_max": ("elementwise_max", {},
                        {"X": [_x()], "Y": [_ties(_x(), _rand(6, 8, seed=2))]},
                        "Out", True),
    "elementwise_min": ("elementwise_min", {},
                        {"X": [_x()], "Y": [_ties(_x(), _rand(6, 8, seed=2))]},
                        "Out", True),
    "elementwise_pow": ("elementwise_pow", {},
                        {"X": [np.abs(_x()) + 0.1],
                         "Y": [_rand(6, 8, seed=2)]}, "Out", False),
    "reduce_sum": ("reduce_sum", {"dim": [1, 2]}, {"X": [_reduce_x(False)]},
                   "Out", False),
    "reduce_mean": ("reduce_mean", {"dim": 1, "keep_dim": True},
                    {"X": [_reduce_x(False)]}, "Out", False),
    "reduce_max": ("reduce_max", {"dim": [1], "keep_dim": False},
                   {"X": [_reduce_x(True)]}, "Out", True),
    "reduce_min": ("reduce_min", {"dim": -2}, {"X": [_reduce_x(True)]},
                   "Out", True),
    "reduce_prod": ("reduce_prod", {"dim": [2]},
                    {"X": [_reduce_x(False) * 0.5 + 1.0]}, "Out", False),
    "argmax": ("argmax", {"axis": 1}, {"X": [_reduce_x(True)]}, "Out", True),
    "not_equal": _cmp("not_equal"),
    "less_than": _cmp("less_than"),
    "less_equal": _cmp("less_equal"),
    "greater_than": _cmp("greater_than"),
    "greater_equal": _cmp("greater_equal"),
    "logical_and": _logic("logical_and"),
    "logical_or": _logic("logical_or"),
    "logical_xor": _logic("logical_xor"),
    "logical_not": ("logical_not", {}, {"X": [_rand(6, 8) > 0]}, "Out",
                    True),
    "squeeze": ("squeeze", {"axes": []}, {"X": [_rand(3, 1, 4, 1)]}, "Out",
                True),
    "unsqueeze": ("unsqueeze", {"axes": [0, -1]}, {"X": [_rand(3, 4)]},
                  "Out", True),
    "expand": ("expand", {"expand_times": [2, 1, 3]}, {"X": [_rand(3, 4)]},
               "Out", False),
    "stack": ("stack", {"axis": 1},
              {"X": [_rand(3, 4), _rand(3, 4, seed=1), _rand(3, 4, seed=2)]},
              "Y", True),
    "pad": ("pad", {"paddings": [1, 0, 2, 3], "pad_value": 0.5},
            {"X": [_rand(3, 4)]}, "Out", True),
    "crop": ("crop", {"offsets": [0, 1, 2], "shape": [-1, 2, 3]},
             {"X": [_rand(4, 5, 6)]}, "Out", True),
    "clip": ("clip", {"min": -0.5, "max": 1.0},
             {"X": [np.concatenate([_x().reshape(-1), [-0.5, 1.0, -0.5, 1.0]])
                    .astype(np.float32).reshape(4, 13)]}, "Out", True),
    "assign_value": ("assign_value", {"shape": [2, 3], "dtype": "float32",
                                      "values": [0.1, -2.5, 3.0, 1e-3, 7.25,
                                                 -0.3]}, {}, "Out", True),
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like",
        {"shape": [2, 3, -1], "value": 0.7, "dtype": "float32",
         "input_dim_idx": 1, "output_dim_idx": 2},
        {"Input": [_rand(2, 5)]}, "Out", True),
    "gather": ("gather", {},
               {"X": [_rand(10, 4)],
                "Index": [np.array([[3], [0], [-1], [9], [3], [-10]],
                                   np.int64)]}, "Out", True),
    "one_hot": ("one_hot", {"depth": 6},
                {"X": [np.array([[0], [5], [2], [-1], [6], [2]], np.int64)]},
                "Out", True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_op_matches_jax(name, dtype):
    op, attrs, ins, slot, exact = CASES[name]
    jout, jgrads, tout, tgrads = run_both(op, attrs, ins, slot, dtype)
    if jout.dtype.kind in "iub":
        assert tout.dtype.kind == jout.dtype.kind or (
            tout.dtype.kind in "iu" and jout.dtype.kind in "iu")
        np.testing.assert_array_equal(tout.astype(np.int64) if
                                      tout.dtype.kind != "b" else tout,
                                      jout.astype(np.int64) if
                                      jout.dtype.kind != "b" else jout)
        return
    if exact:
        np.testing.assert_array_equal(tout, jout)
        assert len(tgrads) == len(jgrads)
        for t, j in zip(tgrads, jgrads):
            np.testing.assert_array_equal(t, j)
        return
    limit = F32_ULPS if dtype == "float32" else BF16_ULPS
    if name == "expand" and dtype == "bfloat16":
        limit = BF16_SUM_ULPS
    gaps = [_ulps(tout, jout, dtype)] + [
        _ulps(t, j, dtype) for t, j in zip(tgrads, jgrads)]
    assert max(gaps) <= limit, gaps


@pytest.mark.parametrize("case", [
    ({"dim": None}, (3, 4, 5)), ({"dim": [0, 2], "keep_dim": True},
                                 (3, 4, 5)),
    ({"dim": 1, "reduce_all": True}, (3, 4, 5))])
def test_reduce_dims_and_shape_inference(case):
    """``dim`` as None, a list or an int, ``keep_dim`` and ``reduce_all``
    give JAX's shapes, and the port infers them on meta tensors."""
    from paddle_tpu_torch.core.registry import infer_outputs

    attrs, shape = case
    x = _rand(*shape)
    for op in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
               "reduce_prod"):
        jout, _, tout, _ = run_both(op, attrs, {"X": [x]}, "Out", "float32")
        assert tout.shape == jout.shape
        meta = infer_outputs(op, attrs, {"X": [torch.empty(shape)]})
        assert tuple(meta["Out"][0].shape) == jout.shape


def test_shape_ops_infer_on_meta_tensors():
    """``one_hot`` with its depth, ``crop`` with a -1 extent, ``squeeze``
    with empty axes and ``gather`` infer their shapes without values."""
    from paddle_tpu_torch.core.registry import infer_outputs

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    assert infer_outputs("one_hot", {"depth": 7}, {
        "X": [meta((5, 1), torch.int64)]})["Out"][0].shape == (5, 7)
    assert infer_outputs("crop", {"offsets": [0, 1], "shape": [-1, 2]}, {
        "X": [meta((9, 4))]})["Out"][0].shape == (9, 2)
    assert infer_outputs("squeeze", {"axes": []}, {
        "X": [meta((2, 1, 3, 1))]})["Out"][0].shape == (2, 3)
    assert infer_outputs("gather", {}, {
        "X": [meta((9, 4))], "Index": [meta((5, 1), torch.int64)]}
    )["Out"][0].shape == (5, 4)
    assert infer_outputs("fill_constant_batch_size_like", {
        "shape": [-1, 1], "value": 0.0, "dtype": "float32"}, {
        "Input": [meta((6, 3))]})["Out"][0].shape == (6, 1)
    assert infer_outputs("argmax", {"axis": -1}, {
        "X": [meta((4, 3))]})["Out"][0].dtype == torch.int64
    assert infer_outputs("less_than", {}, {
        "X": [meta((4, 3))], "Y": [meta((4, 3))]})["Out"][0].dtype \
        == torch.bool


# the 76 ops this slice ports (activation, tensor, loss and math ops)
SLICE_OPS = {
    "activation": [
        "sigmoid", "logsigmoid", "tanh", "exp", "log", "sqrt", "rsqrt",
        "abs", "ceil", "floor", "round", "reciprocal", "square", "softplus",
        "softsign", "sin", "cos", "tanh_shrink", "softshrink", "hard_shrink",
        "brelu", "relu6", "leaky_relu", "elu", "pow", "stanh",
        "hard_sigmoid", "thresholded_relu", "swish", "log_softmax",
        "maxout", "prelu"],
    "tensor": sorted(CASES),
    "loss": [
        "cross_entropy", "sigmoid_cross_entropy_with_logits", "bce_loss",
        "square_error_cost", "squared_l2_distance", "squared_l2_norm",
        "hinge_loss", "huber_loss", "log_loss", "rank_loss",
        "margin_rank_loss", "smooth_l1_loss"],
    "math": ["dot", "cos_sim"],
}


def test_registry_holds_the_slice_ops():
    """All 76 names are registered, and every op the port registers is
    one of the reference's (172 of its 256: this slice's 142, the book
    plane's six, the optimizer plane's eight, the decode plane's six and
    the sparse plane's ten)."""
    from paddle_tpu.core.registry import _REGISTRY as JAX_REGISTRY

    names = [n for ops in SLICE_OPS.values() for n in ops]
    assert [len(v) for v in SLICE_OPS.values()] == [32, 30, 12, 2]
    assert len(set(names)) == 76
    assert not set(names) - set(_REGISTRY)
    assert not set(_REGISTRY) - set(JAX_REGISTRY)
    assert len(_REGISTRY) == 172 and len(JAX_REGISTRY) == 256


def test_comparisons_pass_no_gradient_through_a_program():
    """A program whose loss reads ``less_than`` and ``argmax`` only
    through a cast builds no gradient op for them."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data("x", shape=[4])
        h = layers.fc(x, size=4)
        mask = layers.cast(layers.less_than(h, x), "float32")
        loss = layers.mean(layers.elementwise_mul(h, mask))
        pt.optimizer.SGDOptimizer(0.1).minimize(loss)
    grads = [op.attrs.get("fwd_type") for op in main.global_block.ops
             if op.type == "grad"]
    assert "less_than" not in grads and "elementwise_mul" in grads
