"""The slice's layer functions, Variable arithmetic and ``nets.glu``
build the JAX package's programs.

Each layer is called by one builder with ``pt`` set to each package in
turn and the name counters synced, and the two programs (main, startup
and the ``for_test`` clone) must be equal as ``program_to_dict`` writes
them (``test_torch_transpiler.program_dict``): the same op types, attrs,
variable names, dtypes and inferred shapes. Each layer also has the
reference's signature and defaults. ``+ - * /`` on Variables build one
``scale`` op for a scalar operand and ``elementwise_*`` for a Variable,
and leave comparison and hashing Python's. ``nets.glu`` builds the same
program and, run from each package's own startup (the RNG plane draws
the same weights), the same forward and weight gradient: the gate's
sigmoid and the product agree with JAX's within 8 f32 ulps of each
tensor's largest |value| (``test_torch_activation_ops.py``).
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from test_torch_activation_ops import F32_ULPS, _ulps
from test_torch_transpiler import program_dict

torch.set_num_threads(1)

ATTR_KWARGS = {
    "softshrink": {"lambda": 0.3}, "hard_shrink": {"threshold": 0.4},
    "brelu": {"t_min": 1.0, "t_max": 5.0}, "relu6": {"threshold": 5.0},
    "leaky_relu": {"alpha": 0.2}, "elu": {"alpha": 0.7},
    "pow": {"factor": 3.0}, "stanh": {"scale_a": 0.5, "scale_b": 2.0},
    "hard_sigmoid": {"slope": 0.3, "offset": 0.4},
    "thresholded_relu": {"threshold": 0.9}, "swish": {"beta": 2.0},
}


def _unary(name):
    def build(pt):
        x = pt.layers.data("x", shape=[6])
        kw = dict(ATTR_KWARGS.get(name, {}))
        kw["not_an_attr"] = 1  # filtered out by the layers with attrs
        if name not in ATTR_KWARGS:
            kw = {}
        getattr(pt.layers, name)(x, **kw)
    return build


def _binary(name):
    def build(pt):
        x = pt.layers.data("x", shape=[4, 6])
        y = pt.layers.data("y", shape=[6], append_batch_size=False)
        getattr(pt.layers, name)(x, y)
        getattr(pt.layers, name)(x, x, axis=0)
    return build


def _t(fn):
    """A builder from ``fn(pt, layers, x)`` with x a [-1, 6] data var."""
    def build(pt):
        fn(pt, pt.layers, pt.layers.data("x", shape=[6]))
    return build


BUILDERS = {
    "fill_constant_batch_size_like": _t(
        lambda pt, L, x: L.fill_constant_batch_size_like(
            x, shape=[-1, 3], dtype="float32", value=0.9)),
    "fill_constant_batch_size_like_dims": _t(
        lambda pt, L, x: L.fill_constant_batch_size_like(
            x, shape=[2, -1], dtype="int64", value=3, input_dim_idx=0,
            output_dim_idx=1)),
    "gaussian_random_batch_size_like": _t(
        lambda pt, L, x: L.gaussian_random_batch_size_like(
            x, shape=[-1, 16], mean=0.5, std=2.0)),
    "one_hot": lambda pt: pt.layers.one_hot(
        pt.layers.data("ids", shape=[1], dtype="int64"), depth=10),
    "argmax": _t(lambda pt, L, x: L.argmax(x, axis=1)),
    "reduce_sum": _t(lambda pt, L, x: L.reduce_sum(x, dim=[1])),
    "reduce_mean": _t(lambda pt, L, x: L.reduce_mean(x, dim=1,
                                                     keep_dim=True)),
    "reduce_max": _t(lambda pt, L, x: L.reduce_max(x)),
    "reduce_min": _t(lambda pt, L, x: L.reduce_min(x, dim=[0, 1])),
    "sums": _t(lambda pt, L, x: L.sums([x, L.scale(x, 2.0), x])),
    "create_tensor": _t(lambda pt, L, x: L.assign(
        x, output=L.create_tensor(dtype="float32", name="t"))),
    "ones": lambda pt: pt.layers.ones([3, 2], dtype="float32"),
    "zeros": lambda pt: pt.layers.zeros([4], dtype="int64"),
    "sigmoid_cross_entropy_with_logits": _t(
        lambda pt, L, x: L.sigmoid_cross_entropy_with_logits(
            x, L.data("z", shape=[6]))),
    "cross_entropy": _t(lambda pt, L, x: L.cross_entropy(
        L.softmax(x), L.data("label", shape=[1], dtype="int64"))),
    "cross_entropy_soft": _t(lambda pt, L, x: L.cross_entropy(
        L.softmax(x), L.data("p", shape=[6]), soft_label=True)),
    "square_error_cost": _t(lambda pt, L, x: L.square_error_cost(
        x, L.data("y", shape=[6]))),
    "cos_sim": _t(lambda pt, L, x: L.cos_sim(x, L.data("y", shape=[6]))),
    "mul": _t(lambda pt, L, x: L.mul(
        x, L.data("w", shape=[6, 3], append_batch_size=False))),
    "clip": _t(lambda pt, L, x: L.clip(x, -1, 2.5)),
}
for _name in (tpt.layers.ops._UNARY + list(tpt.layers.ops._UNARY_ATTRS)):
    BUILDERS[_name] = _unary(_name)
for _name in tpt.layers.ops._BINARY:
    BUILDERS[_name] = _binary(_name)


def program_dicts(builder):
    """The builder's (main, startup, test clone) dicts in both packages,
    built with the same name counters."""
    start = jprog.Program._uid_counter
    dicts = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            builder(pt)
        dicts.append([program_dict(pt, p) for p in
                      (main, startup, main.clone(for_test=True))])
    return dicts


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_layer_builds_the_jax_program(name):
    jd, td = program_dicts(BUILDERS[name])
    assert td == jd
    assert td[0]["blocks"][0]["ops"], name


LAYERS = sorted(
    tpt.layers.ops.__all__
    + ["fill_constant_batch_size_like", "gaussian_random_batch_size_like",
       "one_hot", "argmax", "reduce_sum", "reduce_mean", "reduce_max",
       "reduce_min", "sums", "create_tensor", "ones", "zeros",
       "sigmoid_cross_entropy_with_logits", "cross_entropy",
       "square_error_cost", "cos_sim", "mul", "clip"])


def test_layer_lists_and_signatures_equal_the_reference():
    """The generated lists are the reference's, every layer of the
    slice is exported under its name with the reference's signature and
    defaults, and every name the port exports exists in the reference."""
    from paddle_tpu.layers import ops as jops

    tops = tpt.layers.ops
    assert tops._UNARY == jops._UNARY
    assert tops._UNARY_ATTRS == jops._UNARY_ATTRS
    assert tops._BINARY == jops._BINARY
    for name in LAYERS:
        assert name in tpt.layers.__all__, name
        want = inspect.signature(getattr(jpt.layers, name))
        assert inspect.signature(getattr(tpt.layers, name)) == want, name
    assert not (set(tpt.layers.__all__) - set(jpt.layers.__all__)
                - {"make_stack_params"})


ARITH = {
    "add_scalar": lambda x, y: x + 2.5,
    "radd_scalar": lambda x, y: 1 + x,
    "sub_scalar": lambda x, y: x - 0.75,
    "rsub_scalar": lambda x, y: 3 - x,
    "mul_scalar": lambda x, y: x * 0.5,
    "rmul_scalar": lambda x, y: 4 * x,
    "div_scalar": lambda x, y: x / 8,
    "rdiv_scalar": lambda x, y: 2.0 / x,
    "neg": lambda x, y: -x,
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "mul": lambda x, y: x * y,
    "div": lambda x, y: x / y,
    "chain": lambda x, y: (x - y) * (x - y) / 2 + 1,
}


@pytest.mark.parametrize("name", sorted(ARITH))
def test_variable_arithmetic_builds_the_jax_program(name):
    def build(pt):
        x = pt.layers.data("x", shape=[5])
        y = pt.layers.data("y", shape=[5])
        ARITH[name](x, y)

    jd, td = program_dicts(build)
    assert td == jd
    types = [op["type"] for op in td[0]["blocks"][0]["ops"]]
    if name.endswith("_scalar") or name == "neg":
        assert types[-1] == "scale"
    if name in ("add", "sub", "mul", "div"):
        assert types == ["elementwise_" + name]


def test_variables_stay_hashable_and_compare_as_python():
    with tpt.program_guard(tpt.Program(), tpt.Program()):
        x = tpt.layers.data("x", shape=[3])
        y = tpt.layers.data("y", shape=[3])
        n_ops = len(x.block.ops)
        table = {x: 1, y: 2}
        assert table[x] == 1 and table[y] == 2
        assert (x == x) is True and (x == y) is False
        assert len(x.block.ops) == n_ops


def _glu_program(pt, seed):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = seed
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[6])
        h = pt.layers.fc(x, size=8)
        out = pt.nets.glu(h, dim=-1)
        loss = pt.layers.mean(out)
        forward = main.clone()
        pgs = pt.optimizer.SGDOptimizer(0.0).minimize(loss)
    return main, forward, startup, out, [g for _, g in pgs]


def test_glu_builds_and_computes_as_jax():
    start = jprog.Program._uid_counter
    feed = {"x": np.random.RandomState(3).randn(5, 6).astype(np.float32)}
    results = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, forward, startup, out, grads = _glu_program(pt, seed=13)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        got = exe.run(main, feed=feed, fetch_list=[out] + grads, scope=scope)
        # the backward's names differ (the learning-rate var's follows
        # each backward's count of names), so the forward is compared
        results.append(([program_dict(pt, forward)],
                        [np.asarray(v, np.float32) for v in got]))
    (jd, jvals), (td, tvals) = results
    assert td == jd
    assert [op["type"] for op in td[0]["blocks"][0]["ops"]][2:5] == [
        "split", "sigmoid", "elementwise_mul"]
    assert tvals[0].shape == (5, 4)
    for t, j in zip(tvals, jvals):
        assert _ulps(t, j, "float32", at_max=True) <= F32_ULPS
