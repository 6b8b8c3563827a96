"""The reference benchmark's AlexNet training row, built by the same code
in both packages.

``bench.py``'s ``bench_image_model`` program (images NHWC, the model,
``softmax_with_cross_entropy`` mean loss, ``MomentumOptimizer(0.01,
0.9)``) at batch 2, 10 classes and 96x96 inputs, the feed from
``RandomState(0)``. The program is built by one function with ``pt`` set
to each package in turn, with the name counters synced:

- every variable's dtype equals JAX's, in f32 and under AMP;
- each package's own startup draws the same values bit for bit (the RNG
  plane), and the dropout masks of step 1 are equal;
- step 1's loss and every parameter gradient match JAX's. In f32: the
  loss at rtol 1e-5 and each gradient at rtol 1e-5 with an atol of 1e-6
  of its largest |value|. Under AMP: the loss at rtol 2e-3 (the AMP LM
  test's), and the rule below.

The AMP rule. XLA's CPU and torch's CPU sum a bf16 product's f32 terms in
another order, so about 1 in 10^4 of a conv's bf16 outputs rounds one ulp
apart, and that carries into the layers above: every ReLU input (the
pre-activation) is held within ``AMP_FWD_ULPS`` bf16 ulps of its
tensor's largest |value| (measured at most 2: VGG-16; GoogLeNet's are
equal bit for bit). Where a pre-activation that close to zero lands on
the other side of it in one package, that ReLU passes the gradient in one
package and not in the other. Each such flip must be a near-tie (both
values within ``AMP_TIE_ULPS`` ulps of the tensor's largest |value| from
zero; measured 0.22 AlexNet, 0.77 VGG-16) and flips at most 1 in 1000 of
the pre-activations (measured 8 of 193,280 AlexNet, 64 of 569,344
VGG-16). Without a flip each gradient lies within ``AMP_ULPS`` bf16 ulps
of its largest |value| of JAX's (GoogLeNet: at most 9); after one, at
batch 2 a flipped unit moves a whole row of the backward signal, and each
gradient is held within ``AMP_FLIP_GAP`` of its norm (measured at most
0.065 AlexNet, 0.137 VGG-16).

ReLU zeros make tied max-pool windows. XLA's ``select_and_scatter`` and
torch's ``max_pool2d`` backward both send a tied window's gradient to its
first maximum: ``test_tied_pool_windows_route_alike`` builds such windows
and holds the gradients equal bit for bit, and the f32 step-1 check holds
with every tie the model's ReLUs make.

The helpers here are shared with the GoogLeNet and VGG files.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.ops.common as jax_common
import paddle_tpu_torch as tpt
import paddle_tpu_torch.ops.common as torch_common
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.types import to_numpy

torch.set_num_threads(1)
BATCH, CLASSES = 2, 10
F32_RTOL, F32_ATOL = 1e-5, 1e-6
AMP_LOSS_RTOL = 2e-3
AMP_FWD_ULPS, AMP_TIE_ULPS, AMP_FLIPS = 4, 2, 1e-3
AMP_ULPS, AMP_FLIP_GAP = 16, 0.2


def build_bench_image_model(pt, model, hw):
    """bench.py's bench_image_model program with ``pt`` the package and
    ``model(pt, images)`` the model: (main, startup, loss, params_grads)."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 5
    with pt.program_guard(main, startup):
        images = layers.data("images", shape=[hw, hw, 3])
        label = layers.data("label", shape=[1], dtype="int64")
        logits = model(pt, images)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        params_grads = pt.optimizer.MomentumOptimizer(
            learning_rate=0.01, momentum=0.9).minimize(
                loss, startup_program=startup)
    return main, startup, loss, params_grads


def bench_feed(hw):
    rng = np.random.RandomState(0)
    return {"images": rng.rand(BATCH, hw, hw, 3).astype("float32"),
            "label": rng.randint(0, CLASSES, size=(BATCH, 1)).astype(
                "int64")}


def _norm(name):
    """A name without the counters each package's backward advances its
    own way (x@GRAD@R_9, learning_rate_11)."""
    return re.sub(r"(@[A-Z]+|learning_rate)_\d+", r"\1", name)


def var_dtypes(program):
    """(name, dtype) of every variable; int64 reads as int32, as the JAX
    package carries it without x64."""
    return sorted((_norm(n), str(v.dtype).replace("torch.", "")
                   .replace("int64", "int32"))
                  for n, v in program.global_block.vars.items())


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulp_of_max(want):
    """One bf16 ulp at want's largest |value|."""
    return 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)


def bf16_ulps(got, want):
    """The largest |got - want| in bf16 ulps of want's largest |value|."""
    return float(np.abs(got - want).max()) / _ulp_of_max(want)


@pytest.fixture(params=["f32", "amp"])
def amp(request, monkeypatch):
    on = request.param == "amp"
    monkeypatch.setattr(jax_common, "_AMP", on)
    monkeypatch.setattr(torch_common, "_AMP", on)
    return on


class ZooPair:
    """One bench_image_model program in both packages, each from its own
    startup. The startup values are compared as soon as they are drawn
    (``startup_mismatches``), before any step moves them."""

    def __init__(self, model, hw):
        start = jprog.Program._uid_counter
        self.j = build_bench_image_model(jpt, model, hw)
        tprog.Program._uid_counter = start
        self.t = build_bench_image_model(tpt, model, hw)
        self.feed = bench_feed(hw)
        self.jscope, self.tscope = jpt.Scope(), tpt.Scope()
        self.jexe = jpt.Executor(jpt.CPUPlace())
        self.texe = tpt.Executor(tpt.CPUPlace())
        self.jexe.run(self.j[1], scope=self.jscope)
        self.texe.run(self.t[1], scope=self.tscope)
        self.params = [p.name for p, _ in self.j[3]]
        self.startup_mismatches = []
        for name in self.params:
            jv, tv = self.jscope.get(name), self.tscope.get(name)
            if (str(tv.dtype).replace("torch.", "") != str(jv.dtype)
                    or not np.array_equal(to_numpy(tv), f32(jv))):
                self.startup_mismatches.append(name)

    def step(self, extra=()):
        names = [self.j[2].name] + [g.name for _, g in self.j[3]]
        names += list(extra)
        jout = self.jexe.run(self.j[0], feed=self.feed, fetch_list=names,
                             scope=self.jscope, return_numpy=False)
        tout = self.texe.run(self.t[0], feed=self.feed, fetch_list=names,
                             scope=self.tscope, return_numpy=False)
        return names, jout, tout


def check_dtypes_and_startup(pair):
    assert var_dtypes(pair.t[0]) == var_dtypes(pair.j[0])
    assert var_dtypes(pair.t[1]) == var_dtypes(pair.j[1])
    assert pair.params == [p.name for p, _ in pair.t[3]]
    assert pair.params and not pair.startup_mismatches, \
        pair.startup_mismatches


def _relu_flips(pre_names, jpre, tpre):
    """The AMP rule's forward half over the ReLU inputs; returns the
    number of flips."""
    flips = total = 0
    for name, j, t in zip(pre_names, jpre, tpre):
        w, g = f32(j), to_numpy(t)
        assert bf16_ulps(g, w) <= AMP_FWD_ULPS, (name, bf16_ulps(g, w))
        flipped = (w > 0) != (g > 0)
        if flipped.any():
            tie = np.maximum(np.abs(w), np.abs(g))[flipped].max()
            assert tie <= AMP_TIE_ULPS * _ulp_of_max(w), (name, tie)
        flips += int(flipped.sum())
        total += flipped.size
    assert flips <= AMP_FLIPS * total, (flips, total)
    return flips


def check_step_one(pair, amp):
    """Step 1's loss and every gradient against JAX's (and the dropout
    masks, bit for bit); under AMP the rule of the module docstring."""
    blk = pair.j[0].global_block
    masks = [op.outputs["Mask"][0] for op in blk.ops if op.type == "dropout"]
    pre = [op.inputs["X"][0] for op in blk.ops if op.type == "relu"]
    names, jout, tout = pair.step(masks + pre)
    n = len(names) - len(masks) - len(pre)
    for name, j, t in zip(masks, jout[n:], tout[n:]):
        np.testing.assert_array_equal(to_numpy(t), f32(j), err_msg=name)
    jl, tl = f32(jout[0]), to_numpy(tout[0])
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=AMP_LOSS_RTOL if amp
                               else F32_RTOL, atol=0)
    flips = (_relu_flips(pre, jout[n + len(masks):], tout[n + len(masks):])
             if amp else 0)
    for name, j, t in zip(names[1:n], jout[1:n], tout[1:n]):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), name
        w, g = f32(j), to_numpy(t)
        assert np.isfinite(g).all() and np.abs(w).max() > 0, name
        if flips:
            gap = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert gap <= AMP_FLIP_GAP, (name, gap, flips)
        elif amp:
            assert bf16_ulps(g, w) <= AMP_ULPS, (name, bf16_ulps(g, w))
        else:
            np.testing.assert_allclose(
                g, w, rtol=F32_RTOL,
                atol=F32_ATOL * max(1.0, float(np.abs(w).max())),
                err_msg=name)
    return flips


# --- AlexNet ------------------------------------------------------------------
HW = 96


def alexnet(pt, images):
    return pt.models.alexnet(images, num_classes=CLASSES)


@pytest.fixture(scope="module")
def pairs():
    """One pair a precision, built on first use (the startups draw ~21 M
    values)."""
    return {}


def _pair(pairs, amp):
    if amp not in pairs:
        pairs[amp] = ZooPair(alexnet, HW)
    return pairs[amp]


def test_dtypes_and_startup_values_equal_jax(pairs, amp):
    check_dtypes_and_startup(_pair(pairs, amp))


def test_step_one_matches_jax(pairs, amp):
    check_step_one(_pair(pairs, amp), amp)


def test_forward_ops_and_attrs_equal_jax():
    """The conv, lrn and pool ops in order, with their attrs."""
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main = build_bench_image_model(pt, alexnet, HW)[0]
        built.append([(op.type, {k: v for k, v in op.attrs.items()
                                 if not k.startswith("_")})
                      for op in main.global_block.ops
                      if op.type in ("conv2d", "lrn", "pool2d")])
    assert built[1] == built[0]
    assert [t for t, _ in built[1]].count("lrn") == 2


def test_tied_pool_windows_route_alike():
    """A 3/2 max pool over ReLU outputs with windows of zeros and of equal
    positives: the gradients equal JAX's bit for bit."""
    import jax

    from paddle_tpu.core.registry import get_op as jax_op
    from paddle_tpu_torch.core.registry import get_op as torch_op

    x = np.maximum(np.random.RandomState(1).randn(2, 9, 9, 4), 0)
    x[:, 2:5, 2:5, :] = 0.5  # a window of tied positives
    x[:, 6:9, 0:3, :] = 0.0  # a window of ReLU zeros
    x = x.astype(np.float32)
    g = np.random.RandomState(2).randn(2, 4, 4, 4).astype(np.float32)
    attrs = {"pooling_type": "max", "ksize": 3, "strides": 2,
             "paddings": 0, "data_format": "NHWC"}
    _, vjp = jax.vjp(
        lambda a: jax_op("pool2d").fn(attrs, {"X": [a]})["Out"][0],
        jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    torch_op("pool2d").fn(attrs, {"X": [xt]})["Out"][0].backward(
        torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_timed_steps_stay_finite_and_move_every_parameter():
    """The port's own startup, then three Momentum steps on one batch
    (f32, dropout drawing anew each step), as bench.py times them: every
    loss finite, every parameter moved."""
    main, startup, loss, params_grads = build_bench_image_model(
        tpt, alexnet, HW)
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    before = {p.name: scope.get(p.name).clone() for p, _ in params_grads}
    feed = bench_feed(HW)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(3)]
    assert np.isfinite(losses).all(), losses
    for name, value in before.items():
        assert not torch.equal(scope.get(name), value), name
