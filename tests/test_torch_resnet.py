"""The ResNet slice of the port against the JAX package.

Ops: ``conv2d`` (NHWC at 1x1 s1, 1x1 s2, 3x3 s2 p1, 7x7 s2 p3; NCHW at
3x3 s1 p1 and 1x1 s1), ``pool2d`` (max 3/2/1 with tied maxima, global
average, exclusive average and ceil mode), ``batch_norm`` in training
and test form through its grad_fn, ``relu`` and ``momentum`` are run in
both packages on the same numpy inputs, forward and gradients, at rtol
1e-4 / atol 1e-6.

The slice: a narrow net built in both packages through ``models.resnet``'s
own builders with ``--fused_conv_epilogue`` on (a 16-channel stem, a
bottleneck with the fused projection, an identity bottleneck, a strided
bottleneck, global pooling and fc(10), on 32x32 images at batch 2, so
stage 1 has R = 128 and JAX takes its interpret-mode Pallas kernels). Each
package runs its own startup; the port's values equal the JAX startup's
bit for bit, paired op by op. Step one's loss and every gradient, the BN running
stats after it, the losses of 3 Momentum steps and the
``clone(for_test=True)`` logits after them match at rtol 1e-4 / atol
1e-6. ``resnet_imagenet(depth=50)`` is built in both packages, and the
port's own startup trains it one step on the CPU.
"""
import contextlib
import re

import jax
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
from paddle_tpu_torch.core.types import dtype_name, to_dtype
from paddle_tpu_torch.kernels import conv_epilogue as tke

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-6)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _public(attrs):
    """attrs without the ``_``-prefixed metadata keys (call sites)."""
    return {k: v for k, v in attrs.items() if not k.startswith("_")}


def _ins(ins):
    return ({s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
            {s: [torch.from_numpy(np.array(a)) for a in v]
             for s, v in ins.items()})


def _fwd_vjp_both(op_type, attrs, ins, diff_slots, out_slot, seed=0):
    """Forward outputs, then gradients of ``out_slot`` w.r.t. the first
    input of each of ``diff_slots`` under one random cotangent: jax.vjp of
    the JAX op against torch.autograd.grad of the port's, as the generic
    grad op computes them."""
    jins, tins = _ins(ins)

    def jf(*xs):
        full = dict(jins)
        for slot, x in zip(diff_slots, xs):
            full[slot] = [x]
        return jax_op(op_type).fn(attrs, full)[out_slot][0]

    y, vjp = jax.vjp(jf, *(jins[s][0] for s in diff_slots))
    leaves = [tins[s][0].requires_grad_() for s in diff_slots]
    got = torch_op(op_type).fn(attrs, tins)[out_slot][0]
    _close(got, y, what=f"{op_type}.{out_slot}")
    ct = _rand(*y.shape, seed=seed + 99)
    want = vjp(jnp.asarray(ct))
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(ct))
    for slot, g, w in zip(diff_slots, grads, want):
        _close(g, w, what=f"d{op_type}/d{slot}")
    return got


# --- ops ----------------------------------------------------------------------
CONVS = {  # name: (data_format, x shape, filter shape, strides, paddings)
    "nhwc_1x1_s1": ("NHWC", (2, 6, 6, 8), (1, 1, 8, 12), 1, 0),
    "nhwc_1x1_s2": ("NHWC", (2, 7, 7, 8), (1, 1, 8, 12), 2, 0),
    "nhwc_3x3_s2_p1": ("NHWC", (2, 9, 9, 8), (3, 3, 8, 12), 2, 1),
    "nhwc_7x7_s2_p3": ("NHWC", (2, 16, 16, 3), (7, 7, 3, 8), 2, 3),
    "nchw_3x3_s1_p1": ("NCHW", (2, 8, 7, 7), (12, 8, 3, 3), 1, 1),
    "nchw_1x1_s1": ("NCHW", (2, 8, 5, 5), (12, 8, 1, 1), 1, 0),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv2d_forward_and_vjp(case):
    fmt, xs, ws, stride, pad = CONVS[case]
    attrs = {"strides": stride, "paddings": pad, "dilations": 1,
             "groups": 1, "data_format": fmt}
    ins = {"Input": [_rand(*xs, seed=1)],
           "Filter": [_rand(*ws, seed=2, scale=0.3)]}
    _fwd_vjp_both("conv2d", attrs, ins, ["Input", "Filter"], "Output")


def _tied(shape, seed):
    """relu of small integers: windows of zeros and tied maxima."""
    return np.maximum(np.random.RandomState(seed).randint(-3, 3, shape),
                      0).astype(np.float32)


POOLS = {  # name: (attrs, x)
    "max_3_2_1_ties": ({"pooling_type": "max", "ksize": 3, "strides": 2,
                        "paddings": 1}, _tied((2, 9, 9, 4), 3)),
    "global_avg": ({"pooling_type": "avg", "global_pooling": True},
                   _rand(2, 5, 5, 6, seed=4)),
    "avg_exclusive_3_2_1": ({"pooling_type": "avg", "ksize": 3, "strides": 2,
                             "paddings": 1}, _rand(2, 8, 8, 3, seed=5)),
    "max_ceil_2_2": ({"pooling_type": "max", "ksize": 2, "strides": 2,
                      "ceil_mode": True}, _rand(2, 7, 7, 3, seed=6)),
    # padding wider than half the window: padded explicitly
    "max_3_2_pad2_ceil": ({"pooling_type": "max", "ksize": 3, "strides": 2,
                           "paddings": 2, "ceil_mode": True},
                          _rand(2, 8, 8, 3, seed=7)),
    "avg_exclusive_3_2_pad2": ({"pooling_type": "avg", "ksize": 3,
                                "strides": 2, "paddings": 2},
                               _rand(2, 7, 7, 3, seed=8)),
    "avg_inclusive_3_2_pad2_ceil": ({"pooling_type": "avg", "ksize": 3,
                                     "strides": 2, "paddings": 2,
                                     "exclusive": False, "ceil_mode": True},
                                    _rand(2, 8, 8, 3, seed=9)),
    "avg_inclusive_3_2_1": ({"pooling_type": "avg", "ksize": 3, "strides": 2,
                             "paddings": 1, "exclusive": False},
                            _rand(2, 8, 8, 3, seed=10)),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_pool2d_forward_and_vjp(case):
    attrs, x = POOLS[case]
    attrs = dict(attrs, data_format="NHWC")
    if case.endswith("ties"):  # the case has all-zero windows and ties
        assert (x == 0).mean() > 0.4
    _fwd_vjp_both("pool2d", attrs, {"X": [x]}, ["X"], "Out")


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("ogs", [("Y",), ("Y", "MeanOut", "VarianceOut"),
                                 ("Y", "SavedMean", "SavedVariance")])
def test_batch_norm_and_grad(is_test, layout, ogs):
    C = 6
    x = _rand(2, 5, 5, C, seed=1) * 2 + 0.5
    if layout == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    ins = {"X": [x], "Scale": [1.0 + _rand(C, seed=2, scale=0.2)],
           "Bias": [_rand(C, seed=3, scale=0.1)],
           "Mean": [_rand(C, seed=4, scale=0.1)],
           "Variance": [1.0 + np.abs(_rand(C, seed=5, scale=0.2))]}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": layout}
    jins, tins = _ins(ins)
    want = jax_op("batch_norm").fn(attrs, jins)
    got = torch_op("batch_norm").fn(attrs, tins)
    assert sorted(got) == sorted(want)
    for slot in want:
        _close(got[slot][0], want[slot][0], what=slot)
    og = {s: _rand(*np.shape(want[s][0]), seed=10 + i)
          for i, s in enumerate(ogs)}
    jg = jax_op("batch_norm").grad_fn(
        attrs, jins, want, {s: [jnp.asarray(a)] for s, a in og.items()})
    tg = torch_op("batch_norm").grad_fn(
        attrs, tins, got, {s: [torch.from_numpy(a)] for s, a in og.items()})
    assert sorted(tg) == sorted(jg)
    for slot in jg:
        _close(tg[slot][0], jg[slot][0], what=f"d{slot}")


def test_relu_forward_and_vjp():
    x = _rand(3, 7, seed=1)
    x[0, :3] = 0.0  # the gradient at 0 is 0 in both
    _fwd_vjp_both("relu", {}, {"X": [x]}, ["X"], "Out")


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_three_updates(nesterov):
    """Each update feeds ParamOut and VelocityOut back in, with a new
    gradient."""
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    p, v = _rand(5, 4, seed=1), np.zeros((5, 4), np.float32)
    for step in range(3):
        ins = {"Param": [p], "Grad": [_rand(5, 4, seed=10 + step)],
               "Velocity": [v], "LearningRate": [np.array([0.1], np.float32)]}
        jins, tins = _ins(ins)
        want = jax_op("momentum").fn(attrs, jins)
        got = torch_op("momentum").fn(attrs, tins)
        for slot in ("ParamOut", "VelocityOut"):
            _close(got[slot][0], want[slot][0], what=slot)
        p, v = got["ParamOut"][0].numpy(), got["VelocityOut"][0].numpy()


def test_gaussian_random_draws_the_asked_moments():
    """The op draws from a threefry key: bit-exact with the JAX op as the
    JAX executor runs it (jitted), with the asked moments, and
    deterministic per key."""
    from paddle_tpu_torch.core import prng

    fn = torch_op("gaussian_random").fn
    attrs = {"shape": [256, 64], "dtype": "float32", "mean": 0.5, "std": 2.0}
    a = fn(attrs, {}, rng=prng.prng_key(3))["Out"][0]
    b = fn(attrs, {}, rng=prng.prng_key(3))["Out"][0]
    want = jax.jit(lambda k: jax_op("gaussian_random").fn(
        attrs, {}, rng=k)["Out"][0])(jax.random.PRNGKey(3))
    assert a.shape == tuple(want.shape) and a.dtype == torch.float32
    assert np.array_equal(a.numpy(), np.asarray(want))
    assert torch.equal(a, b)
    assert abs(float(a.mean()) - 0.5) < 0.05
    assert abs(float(a.std()) - 2.0) < 0.05


@pytest.mark.parametrize("kind", ["normal", "xavier_normal"])
def test_normal_initializers_emit_the_jax_startup_op(kind):
    def make(pt):
        init = (pt.initializer.NormalInitializer(0.5, 0.02, seed=3)
                if kind == "normal"
                else pt.initializer.XavierInitializer(uniform=False))
        startup = pt.Program()
        var = startup.global_block.create_var(name="w", shape=[6, 4],
                                              dtype="float32",
                                              persistable=True)
        init(var, startup.global_block)
        op, = startup.global_block.ops
        return op.type, op.attrs

    (jtype, jattrs), (ttype, tattrs) = make(jpt), make(tpt)
    assert ttype == jtype == "gaussian_random"
    assert _public(tattrs) == _public(jattrs)


def test_conv2d_turns_tf32_off_in_its_forward_and_backward(monkeypatch):
    """cuDNN runs f32 convolutions in TF32 by default; the op turns that
    off around its forward and, when the generic grad op differentiates
    it later, around its backward, and gives the caller's setting back."""
    from paddle_tpu_torch.ops import common, nn_ops

    seen = []

    @contextlib.contextmanager
    def recording():
        with common.full_f32_convolutions():
            seen.append(torch.backends.cudnn.allow_tf32)
            yield

    monkeypatch.setattr(nn_ops, "full_f32_convolutions", recording)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = torch.from_numpy(_rand(1, 5, 5, 2)).requires_grad_()
        w = torch.from_numpy(_rand(3, 3, 2, 4)).requires_grad_()
        y = torch_op("conv2d").fn(
            {"strides": 1, "paddings": 1, "data_format": "NHWC"},
            {"Input": [x], "Filter": [w]})["Output"][0]
        assert seen == [False] and torch.backends.cudnn.allow_tf32
        y.sum().backward()
        assert seen == [False, False] and torch.backends.cudnn.allow_tf32
        assert x.grad is not None and w.grad is not None
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# --- the slice ----------------------------------------------------------------
STEM, BATCH, SIZE, CLASSES, LR = 16, 2, 32, 10, 0.05


def _narrow(pt, images, is_test=False):
    """The narrow net through the package's own ResNet builders."""
    R = pt.models.resnet
    x = R._conv_bn(images, STEM, 7, stride=2, padding=3, data_format="NHWC",
                   is_test=is_test)
    x = pt.layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                         data_format="NHWC")
    x = R._bottleneck(x, 8, 1, "NHWC", is_test)   # fused projection
    x = R._bottleneck(x, 8, 1, "NHWC", is_test)   # identity shortcut
    x = R._bottleneck(x, 16, 2, "NHWC", is_test)  # strided projection
    x = pt.layers.pool2d(x, pool_type="avg", global_pooling=True,
                         data_format="NHWC")
    return pt.layers.fc(x, size=CLASSES)


def _build(pt, net, size, fused, optimizer=True):
    """(main, startup, test_prog, loss, logits, params) of ``net`` with
    Momentum, the for_test clone taken before minimize."""
    pt.flags.FLAGS.fused_conv_epilogue = fused
    try:
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 5
        with pt.program_guard(main, startup):
            images = pt.layers.data("images", [size, size, 3])
            label = pt.layers.data("label", [1], "int64")
            logits = net(pt, images)
            test_prog = main.clone(for_test=True)
            loss = pt.layers.mean(
                pt.layers.softmax_with_cross_entropy(logits, label))
            params = []
            if optimizer:
                params = [p.name for p, _ in pt.optimizer.MomentumOptimizer(
                    learning_rate=LR, momentum=0.9).minimize(loss)]
    finally:
        pt.flags.reset_flags()
    return main, startup, test_prog, loss, logits, params


def _build_both(net, size, fused, optimizer=True):
    """The same program in both packages, with the port's name counter
    started where the JAX package's was, so every name agrees."""
    start = jprog.Program._uid_counter
    jbuilt = _build(jpt, net, size, fused, optimizer)
    tprog.Program._uid_counter = start
    tbuilt = _build(tpt, net, size, fused, optimizer)
    return jbuilt, tbuilt


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"images": rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
             "label": rng.randint(0, CLASSES, (BATCH, 1)).astype(np.int64)}
            for _ in range(n)]


class _Run:
    """Both packages train the narrow net from their own startups (the
    port's draws the JAX startup's values, checked bit for bit):
    step one's loss and gradients, the BN running stats after it, two
    more steps' losses, and the for_test logits after them. Counts the
    port's kernel-wrapper calls per program run."""

    def __init__(self, monkeypatch):
        (jmain, jstart, jtest, jloss, jlogits, self.params), \
            (tmain, tstart, ttest, tloss, tlogits, tparams) = _build_both(
                _narrow, SIZE, fused=True)
        assert tparams == self.params
        self.fused_ops = sum(op.type == "conv1x1_bn_act"
                             for op in tmain.global_block.ops)
        self.calls = {"conv1x1_stats": 0, "scale_shift_act": 0,
                      "conv1x1_epilogue": 0}
        for name in self.calls:
            fn = getattr(tke, name)

            def counted(*a, _f=fn, _n=name, **k):
                self.calls[_n] += 1
                return _f(*a, **k)

            monkeypatch.setattr(tke, name, counted)
        jscope, jexe = jpt.Scope(), jpt.Executor(jpt.CPUPlace())
        jexe.run(jstart, scope=jscope)
        tscope, texe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
        texe.run(tstart, scope=tscope)
        # the port's own startup draws the JAX startup's values, bit for bit
        values = {}
        for jop, top in zip(jstart.global_block.ops, tstart.global_block.ops):
            for jn, tn in zip(jop.output_names(), top.output_names()):
                values[tn] = np.asarray(jscope.get(jn))
                np.testing.assert_array_equal(tscope.get_numpy(tn),
                                              values[tn], err_msg=tn)
        self.state_names = sorted(values)
        self.stats_names = sorted(n for n in values
                                  if n.endswith((".mean", ".var")))
        feeds = _feeds(3, seed=1)
        grads = [f"{p}@GRAD" for p in self.params]
        fetch = [jloss.name] + grads
        self.j1 = jexe.run(jmain, feed=feeds[0], fetch_list=fetch,
                           scope=jscope)
        self.t1 = texe.run(tmain, feed=feeds[0], fetch_list=fetch,
                           scope=tscope)
        self.step_calls = dict(self.calls)
        self.jstats = [np.asarray(jscope.get(n)) for n in self.stats_names]
        self.tstats = [tscope.get_numpy(n) for n in self.stats_names]
        self.jlosses, self.tlosses = [float(self.j1[0])], [float(self.t1[0])]
        for feed in feeds[1:]:
            self.jlosses.append(float(jexe.run(
                jmain, feed=feed, fetch_list=[jloss], scope=jscope)[0]))
            self.tlosses.append(float(texe.run(
                tmain, feed=feed, fetch_list=[tloss], scope=tscope)[0]))
        images = {"images": _feeds(1, seed=2)[0]["images"]}
        before = dict(self.calls)
        self.jlogits = jexe.run(jtest, feed=images, fetch_list=[jlogits],
                                scope=jscope)[0]
        self.tlogits = texe.run(ttest, feed=images, fetch_list=[tlogits],
                                scope=tscope)[0]
        self.test_calls = {k: self.calls[k] - before[k] for k in before}


@pytest.fixture(scope="module")
def run():
    mp = pytest.MonkeyPatch()
    try:
        yield _Run(mp)
    finally:
        mp.undo()


def test_narrow_net_builds_seven_fused_ops_and_every_state(run):
    assert run.fused_ops == 7
    # 12 filters (7 fused, 5 conv2d) + 12 BN scale/bias pairs + fc w, b;
    # 12 pairs of running stats
    assert len(run.params) == 38 and len(run.stats_names) == 24
    assert run.step_calls == {"conv1x1_stats": 7, "scale_shift_act": 7,
                              "conv1x1_epilogue": 0}
    assert run.test_calls == {"conv1x1_stats": 0, "scale_shift_act": 0,
                              "conv1x1_epilogue": 7}


def test_step_one_loss_and_every_gradient_match_jax(run):
    names = ["loss"] + [f"{p}@GRAD" for p in run.params]
    for name, j, t in zip(names, run.j1, run.t1):
        _close(t, np.asarray(j), what=name)


def test_running_stats_after_a_step_match_jax(run):
    for name, j, t in zip(run.stats_names, run.jstats, run.tstats):
        _close(t, j, what=name)
    assert any(not np.allclose(t, 0) for t in run.tstats[::2])


def test_three_momentum_steps_lose_the_same(run):
    np.testing.assert_allclose(run.tlosses, run.jlosses, rtol=1e-4)
    assert all(np.isfinite(run.tlosses))


def test_for_test_clone_logits_match_jax(run):
    assert run.tlogits.shape == (BATCH, CLASSES)
    _close(run.tlogits, run.jlogits, what="logits")


@pytest.mark.parametrize("fused", [True, False])
def test_resnet50_builds_the_same_program_in_both_packages(fused):
    def net(pt, images):
        return pt.models.resnet_imagenet(images, num_classes=1000, depth=50)

    (jmain, jstart, jtest, *_), (tmain, tstart, ttest, *_) = _build_both(
        net, 224, fused)
    jops, tops = jmain.global_block.ops, tmain.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]

    def names(slots):
        # names made during and after the backward (x@PRE_7, x@GRAD@R_9,
        # learning_rate_11) carry counter values that each package's
        # append_backward advances its own way
        return {slot: [re.sub(r"(@[A-Z]+|learning_rate)_\d+", r"\1", n)
                       for n in ns] for slot, ns in slots.items()}

    for t, j in zip(tops, jops):
        assert names(t.inputs) == names(j.inputs), t.type
        assert names(t.outputs) == names(j.outputs), t.type
        if t.type in ("grad", "grad_custom"):
            assert t.attrs["fwd_type"] == j.attrs["fwd_type"]
    assert [op.attrs.get("is_test") for op in ttest.global_block.ops] == \
        [op.attrs.get("is_test") for op in jtest.global_block.ops]

    def params(prog):
        return sorted((p.name, tuple(p.shape)) for p in prog.all_parameters())

    assert params(tmain) == params(jmain)
    # the startups initialise the same names with the same ops and attrs
    for t, j in zip(tstart.global_block.ops, jstart.global_block.ops):
        assert (t.type, names(t.outputs)) == (j.type, names(j.outputs))
        tattrs, jattrs = _public(t.attrs), _public(j.attrs)
        assert to_dtype(tattrs.pop("dtype")) == to_dtype(jattrs.pop("dtype"))
        assert tattrs == jattrs, t.type
    assert len(tstart.global_block.ops) == len(jstart.global_block.ops)
    fused_ops = sum(op.type == "conv1x1_bn_act" for op in tops)
    assert fused_ops == (33 if fused else 0)
    # build-time shapes of every forward output, batch dim included
    for t, j in zip(ttest.global_block.ops, jtest.global_block.ops):
        for slot, names in j.outputs.items():
            for n in names:
                tv, jv = ttest.global_block.var(n), jtest.global_block.var(n)
                if jv.shape is not None:
                    assert tv.shape == tuple(jv.shape), (t.type, slot)
                    assert dtype_name(tv.dtype) == np.dtype(jv.dtype).name


def test_port_startup_trains_resnet50_one_step_on_the_cpu():
    def net(pt, images):
        return pt.models.resnet_imagenet(images, num_classes=1000, depth=50)

    main, startup, _, loss, _, params = _build(tpt, net, SIZE, fused=True)
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    before = scope.get_numpy(params[0])
    feed = _feeds(1)[0]
    feed["label"] = feed["label"] * 97  # classes up to 1000
    lo, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(lo) and lo > 0
    assert not np.array_equal(scope.get_numpy(params[0]), before)


def test_recompute_is_a_later_slice():
    """Recompute segments are ported: ``recompute=True`` tags each of
    ResNet-50's 16 bottlenecks as one segment."""
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        images = tpt.layers.data("images", [32, 32, 3])
        tpt.models.resnet_imagenet(images, depth=50, recompute=True)
    segs = {op.attrs.get("__recompute_seg__")
            for op in main.global_block.ops}
    assert len(segs - {None}) == 16
