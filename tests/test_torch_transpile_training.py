"""``trainer.SGD(transpile=True)`` in the port against the JAX package.

The narrow ResNet of ``tests/test_torch_resnet.py`` (a 16-channel stem
and three bottlenecks, NHWC 32x32 images, 10 classes), built plain with
``--fused_conv_epilogue`` off, then handed to ``SGD(transpile=True)``
with the flag on, in both packages from the same name counter and
startup seed: ``transpiler.training_pipeline`` (literal constant folding,
then the fused-kernel rewrites) runs on the program before ``minimize``
and ``prune_pipeline`` on its test clone. Both packages rewrite the same
seven 1x1 conv + BN (+ residual) (+ relu) chains of the training program
into ``conv1x1_bn_act`` and end with the same op types there (backward
and Momentum updates included) and in the test clone, which the prune
pipeline only slices. Two training steps at
batch 8 (batch norm over 8 images keeps the second step well
conditioned) lose the same as JAX's at rtol 1e-5, the first equal to the
untranspiled program's first loss at rtol 1e-6 (one forward, the fused
kernels' plain versions against conv2d + batch_norm).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import reader as jreader
from paddle_tpu.core import program as jprog
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.trainer import SGD as TSGD

torch.set_num_threads(1)
STEM, BATCH, SIZE, CLASSES, LR, STEPS = 16, 8, 32, 10, 0.05, 2
PKG = {"jax": (jpt, jprog, JSGD, jreader), "torch": (tpt, tprog, TSGD,
                                                     treader)}


def _narrow(pt, images):
    R = pt.models.resnet
    x = R._conv_bn(images, STEM, 7, stride=2, padding=3, data_format="NHWC")
    x = pt.layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                         data_format="NHWC")
    for ch_mid, stride in ((8, 1), (8, 1), (16, 2)):
        x = R._bottleneck(x, ch_mid, stride, "NHWC", False)
    x = pt.layers.pool2d(x, pool_type="avg", global_pooling=True,
                         data_format="NHWC")
    return pt.layers.fc(x, size=CLASSES)


def _rows():
    rng = np.random.RandomState(4)
    xs = rng.randn(STEPS * BATCH, SIZE, SIZE, 3).astype(np.float32)
    ys = rng.randint(0, CLASSES, (STEPS * BATCH, 1)).astype(np.int64)

    def reader():
        for x, y in zip(xs, ys):
            yield x, y
    return reader


def _train(which, start, transpile):
    """(costs, training op types, test op types) of STEPS steps."""
    pt, counter, SGD, reader_mod = PKG[which]
    counter.Program._uid_counter = start
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 5
    with pt.program_guard(main, startup):
        images = pt.layers.data("images", [SIZE, SIZE, 3])
        label = pt.layers.data("label", [1], "int64")
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            _narrow(pt, images), label))
        pt.flags.FLAGS.fused_conv_epilogue = transpile
        try:
            trainer = SGD(cost=loss,
                          optimizer=pt.optimizer.MomentumOptimizer(LR, 0.9),
                          feed_list=[images, label], place=pt.CPUPlace(),
                          scope=pt.Scope(), transpile=transpile)
        finally:
            pt.flags.reset_flags()
    costs = []

    def handler(e):
        if type(e).__name__ == "EndIteration":
            costs.append(float(e.cost))

    trainer.train(reader_mod.batch(_rows(), BATCH), event_handler=handler)
    return (costs, [op.type for op in main.global_block.ops],
            [op.type for op in trainer.test_program.global_block.ops])


@pytest.fixture(scope="module")
def runs():
    start = jprog.Program._uid_counter
    return {(which, t): _train(which, start, t)
            for which in ("jax", "torch") for t in (True, False)}


def test_training_pipeline_rewrites_the_same_ops_as_jax(runs):
    jcosts, jtypes, jtest = runs["jax", True]
    tcosts, ttypes, ttest = runs["torch", True]
    assert ttypes == jtypes and ttest == jtest
    assert ttypes.count("conv1x1_bn_act") == 7
    assert "conv1x1_bn_act" not in ttest and "conv2d" in ttest
    plain = runs["torch", False][1]
    assert plain.count("conv1x1_bn_act") == 0
    assert len(ttypes) < len(plain)


def test_transpiled_training_loses_as_jax_and_as_the_plain_program(runs):
    jcosts = runs["jax", True][0]
    tcosts = runs["torch", True][0]
    assert len(tcosts) == STEPS and all(np.isfinite(tcosts))
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-5)
    plain = runs["torch", False][0]
    np.testing.assert_allclose(tcosts[0], plain[0], rtol=1e-6)
