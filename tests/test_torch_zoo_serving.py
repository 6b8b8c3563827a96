"""The reference benchmark's image-serving rows and the small image
models, in both packages.

- ``bench.py``'s ``bench_inference`` path for GoogLeNet (64x64) and
  VGG-19 (32x32), 10 classes: the model built with ``is_test=False`` (as
  the bench builds it), the port's startup values carried into a JAX
  scope (the training files hold the two startups' draws equal), then in
  each package ``io.save_inference_model`` through the inference
  transpiler, ``load_inference_model`` and ``Executor.run`` at batch 2.
  Both packages save the same program (``program_to_dict``, dropout
  rewritten to ``scale`` by ``DropoutToScale``) and the same parameters
  bit for bit; the port's logits equal JAX's at rtol 1e-4 / atol 1e-5 of
  the largest |logit| (the transpiled tolerance of
  ``tests/test_torch_io.py``) and equal the port's own untranspiled
  ``for_test`` clone at the same tolerance. ``InferenceEngine`` serves the
  saved GoogLeNet with its graph capture rehearsed on the CPU
  (``tests/test_torch_inference_engine.py``'s fake capture): replayed
  logits equal the eager run bit for bit.
- MobileNet v1 at scale 0.25 and 64x64 under ``--fused_conv_epilogue``:
  the transpiled program's op types equal JAX's, 13 ``conv1x1_bn_act``
  ops among them (BN folded into the 14 plain and grouped convs,
  ``FoldBatchNorm``), the folded weights bit for bit, and the logits
  equal JAX's (its Pallas kernels in interpret mode, the port's plain
  versions) at the same tolerance. A ``depthwise_conv2d`` op followed by
  batch_norm folds in both packages alike.
- LeNet-5 (28x28x1) and SmallNet (32x32x3): the forward and one Momentum
  step from each package's own startup, the startup draws bit for bit,
  the logits, loss and every gradient at rtol 1e-5 with an atol of 1e-6
  of each tensor's largest |value|.
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.types import to_numpy
from paddle_tpu_torch.serving import engine as engine_mod
from test_torch_inference_engine import _fake_graph_capture
from test_torch_transpiler import program_dict
from test_torch_zoo_alexnet import f32

torch.set_num_threads(1)
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
F32_RTOL, F32_ATOL = 1e-5, 1e-6
CLASSES, BATCH = 10, 2


def _build(pt, model, hw, channels=3, fused=False):
    """(main, startup, logits) of ``model(pt, images)``."""
    old = pt.flags.FLAGS.fused_conv_epilogue
    pt.flags.FLAGS.fused_conv_epilogue = fused
    try:
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 7
        with pt.program_guard(main, startup):
            images = pt.layers.data("images", shape=[hw, hw, channels])
            logits = model(pt, images)
    finally:
        pt.flags.FLAGS.fused_conv_epilogue = old
    return main, startup, logits


class Served:
    """One model saved, loaded and served by both packages from the port's
    startup values."""

    def __init__(self, model, hw, tmp, fused=False):
        start = jprog.Program._uid_counter
        self.j = _build(jpt, model, hw, fused=fused)
        tprog.Program._uid_counter = start
        self.t = _build(tpt, model, hw, fused=fused)
        self.tscope = tpt.Scope()
        self.texe = tpt.Executor(tpt.CPUPlace())
        self.texe.run(self.t[1], scope=self.tscope)
        self.jscope = jpt.Scope()
        for name in self.tscope.keys():
            if name != tprog.RNG_VAR:
                self.jscope.set(name, to_numpy(self.tscope.get(name)))
        self.jexe = jpt.Executor(jpt.CPUPlace())
        self.images = np.random.RandomState(0).rand(
            BATCH, hw, hw, 3).astype("float32")
        self.dirs, self.logits, self.loaded = {}, {}, {}
        for pt, (main, _, logits), exe, scope in (
                (jpt, self.j, self.jexe, self.jscope),
                (tpt, self.t, self.texe, self.tscope)):
            d = str(tmp / pt.__name__)
            old = pt.flags.FLAGS.fused_conv_epilogue
            pt.flags.FLAGS.fused_conv_epilogue = fused
            try:
                pt.io.save_inference_model(d, ["images"], [logits], exe,
                                           main_program=main, scope=scope)
            finally:
                pt.flags.FLAGS.fused_conv_epilogue = old
            load_scope = pt.Scope()
            prog, feeds, fetches = pt.io.load_inference_model(
                d, exe, scope=load_scope)
            out, = exe.run(prog, feed={feeds[0]: self.images},
                           fetch_list=fetches, scope=load_scope)
            self.dirs[pt.__name__] = d
            self.logits[pt.__name__] = f32(out)
            self.loaded[pt.__name__] = (prog, load_scope)

    def check_logits(self):
        want = self.logits["paddle_tpu"]
        got = self.logits["paddle_tpu_torch"]
        assert got.shape == (BATCH, CLASSES) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL * np.abs(want).max())

    def saved_programs(self):
        return [program_dict(pt, self.loaded[pt.__name__][0])
                for pt in (jpt, tpt)]


def _googlenet(pt, images):
    return pt.models.googlenet(images, num_classes=CLASSES)


def _vgg19(pt, images):
    return pt.models.vgg(images, num_classes=CLASSES, depth=19)


def _mobilenet(pt, images):
    return pt.models.mobilenet(images, num_classes=CLASSES, scale=0.25)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            model, hw, fused = {"googlenet": (_googlenet, 64, False),
                                "vgg19": (_vgg19, 32, False),
                                "mobilenet": (_mobilenet, 64, True)}[name]
            cache[name] = Served(model, hw, tmp_path_factory.mktemp(name),
                                 fused=fused)
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["googlenet", "vgg19"])
def test_bench_inference_logits_equal_jax(served, name):
    served(name).check_logits()


@pytest.mark.parametrize("name", ["googlenet", "vgg19"])
def test_both_packages_save_the_same_model(served, name):
    s = served(name)
    jd, td = s.saved_programs()
    assert td == jd
    types = collections.Counter(op["type"] for op in td["blocks"][0]["ops"])
    assert not types["dropout"] and types["scale"] >= 1, types
    jscope, tscope = s.loaded["paddle_tpu"][1], s.loaded["paddle_tpu_torch"][1]
    names = [v["name"] for v in td["blocks"][0]["vars"] if v["persistable"]]
    assert names
    for name_ in names:
        np.testing.assert_array_equal(to_numpy(tscope.get(name_)),
                                      f32(jscope.get(name_)), err_msg=name_)


@pytest.mark.parametrize("name", ["googlenet", "vgg19"])
def test_transpiled_logits_equal_the_for_test_clone(served, name):
    s = served(name)
    test_prog = s.t[0].clone(for_test=True)
    want, = s.texe.run(test_prog, feed={"images": s.images},
                       fetch_list=[s.t[2]], scope=s.tscope)
    got = s.logits["paddle_tpu_torch"]
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * np.abs(want).max())


def test_inference_engine_replay_equals_the_eager_run(served, monkeypatch):
    s = served("googlenet")
    d = s.dirs["paddle_tpu_torch"]
    eager = tpt.InferenceEngine(d, place=tpt.CPUPlace(), batch_buckets=(2,))
    monkeypatch.setattr(engine_mod, "_graph_capture", _fake_graph_capture)
    eng = tpt.InferenceEngine(d, place=tpt.CPUPlace(), batch_buckets=(2,))
    eng._use_graphs = True
    assert eng.warmup() == 1 and eng.cache_stats() == {"graphs": 1}
    got = eng.run({"images": s.images})[0]
    np.testing.assert_array_equal(got, eager.run({"images": s.images})[0])
    np.testing.assert_allclose(got, s.logits["paddle_tpu_torch"],
                               rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * np.abs(got).max())
    eng.close()
    eager.close()


# --- MobileNet under --fused_conv_epilogue ------------------------------------
def test_mobilenet_fused_program_equals_jax(served):
    s = served("mobilenet")
    jd, td = s.saved_programs()
    assert td == jd
    types = collections.Counter(op["type"] for op in td["blocks"][0]["ops"])
    assert types["conv1x1_bn_act"] == 13, types
    assert types["conv2d"] == 14 and not types["batch_norm"], types
    jscope, tscope = s.loaded["paddle_tpu"][1], s.loaded["paddle_tpu_torch"][1]
    for v in td["blocks"][0]["vars"]:
        if v["persistable"]:
            np.testing.assert_array_equal(to_numpy(tscope.get(v["name"])),
                                          f32(jscope.get(v["name"])),
                                          err_msg=v["name"])


def test_mobilenet_fused_logits_equal_jax(served):
    s = served("mobilenet")
    s.check_logits()
    test_prog = s.t[0].clone(for_test=True)
    want, = s.texe.run(test_prog, feed={"images": s.images},
                       fetch_list=[s.t[2]], scope=s.tscope)
    np.testing.assert_allclose(s.logits["paddle_tpu_torch"], want,
                               rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * np.abs(want).max())


def _depthwise_bn(pt, images):
    """A depthwise_conv2d op (the JAX package's op, which no layer emits)
    over NHWC ``images`` of 3 channels, then batch_norm in test mode."""
    from importlib import import_module

    helper_mod = import_module(pt.__name__ + ".layers.layer_helper")
    helper = helper_mod.LayerHelper("depthwise_conv2d")
    w = helper.create_parameter(None, shape=[3, 3, 1, 3], dtype="float32")
    y = helper.simple_op("depthwise_conv2d",
                         {"Input": [images], "Filter": [w]},
                         {"strides": 1, "paddings": 1, "dilations": 1,
                          "data_format": "NHWC"}, out_slot="Output")
    return pt.layers.batch_norm(y, is_test=True, data_layout="NHWC",
                                act="relu")


def test_fold_batch_norm_over_depthwise_conv2d_equals_jax(tmp_path):
    s = Served(lambda pt, images: pt.layers.fc(_depthwise_bn(pt, images),
                                               size=CLASSES), 6, tmp_path)
    jd, td = s.saved_programs()
    assert td == jd
    types = [op["type"] for op in td["blocks"][0]["ops"]]
    assert "depthwise_conv2d" in types and "batch_norm" not in types
    s.check_logits()


# --- LeNet-5 and SmallNet -----------------------------------------------------
def _train_program(pt, model, hw, channels):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 3
    with pt.program_guard(main, startup):
        images = pt.layers.data("images", shape=[hw, hw, channels])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        logits = model(pt, images)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits,
                                                                   label))
        params_grads = pt.optimizer.MomentumOptimizer(
            learning_rate=0.01, momentum=0.9).minimize(
                loss, startup_program=startup)
    return main, startup, logits, loss, params_grads


@pytest.mark.parametrize("name", ["lenet5", "smallnet"])
def test_small_model_forward_and_step_equal_jax(name):
    model, hw, channels = {
        "lenet5": (lambda pt, im: pt.models.lenet5(im), 28, 1),
        "smallnet": (lambda pt, im: pt.models.smallnet_mnist_cifar(im),
                     32, 3)}[name]
    start = jprog.Program._uid_counter
    j = _train_program(jpt, model, hw, channels)
    tprog.Program._uid_counter = start
    t = _train_program(tpt, model, hw, channels)
    rng = np.random.RandomState(1)
    feed = {"images": rng.rand(4, hw, hw, channels).astype("float32"),
            "label": rng.randint(0, CLASSES, (4, 1)).astype("int64")}
    jscope, tscope = jpt.Scope(), tpt.Scope()
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    jexe.run(j[1], scope=jscope)
    texe.run(t[1], scope=tscope)
    params = [p.name for p, _ in j[4]]
    assert params == [p.name for p, _ in t[4]]
    for p in params:
        np.testing.assert_array_equal(to_numpy(tscope.get(p)),
                                      f32(jscope.get(p)), err_msg=p)
    names = [j[2].name, j[3].name] + [g.name for _, g in j[4]]
    jout = jexe.run(j[0], feed=feed, fetch_list=names, scope=jscope)
    tout = texe.run(t[0], feed=feed, fetch_list=names, scope=tscope)
    for n, want, got in zip(names, jout, tout):
        want = f32(want)
        np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                                   atol=F32_ATOL * max(1.0, float(
                                       np.abs(want).max())), err_msg=n)
    # the updated parameters after the step, too
    for p in params:
        want = f32(jscope.get(p))
        np.testing.assert_allclose(to_numpy(tscope.get(p)), want,
                                   rtol=F32_RTOL, atol=F32_ATOL, err_msg=p)
