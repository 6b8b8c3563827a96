"""``models.resnet`` with ``recompute=True`` in the port, against the JAX
package.

The narrow net of ``tests/test_torch_resnet.py`` (a 16-channel stem and
three bottlenecks, 32x32 images at batch 2, 10 classes, Momentum) built
through the package's own ResNet builders with ``recompute=True``, with
``--fused_conv_epilogue`` off and on, in both packages from the same
name counter. Each bottleneck is one recompute guard: without the flag
each is one segment (3 ``seg_fwd``); with it the fused
``conv1x1_bn_act`` ops, whose ``grad_fn`` is not an optimization, split
the guards, and what lies between them forms the segments (4).

Batch norm over two images conditions the gradients badly: a change in
the last bit of a BN statistic moves them by far more than one rounding.
So the port's step-one gradients are held to the move of JAX's own
gradients under a nudge: the JAX program run again on images scaled by
(1 + 1e-6). Each port gradient must lie within ``NUDGE_MULT`` times that
move (in norm) of JAX's, both for the recompute build and for the
port's plain build against its recompute build (measured: at most 1.11
and 0.64 times the move); the loss at rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog

torch.set_num_threads(1)
STEM, BATCH, SIZE, CLASSES, LR = 16, 2, 32, 10, 0.05
NUDGE = 1e-6
NUDGE_MULT = 4.0


def _narrow(pt, images, recompute):
    R = pt.models.resnet
    x = R._conv_bn(images, STEM, 7, stride=2, padding=3, data_format="NHWC")
    x = pt.layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                         data_format="NHWC")
    for ch_mid, stride in ((8, 1), (8, 1), (16, 2)):
        x = R._bottleneck(x, ch_mid, stride, "NHWC", False, recompute)
    x = pt.layers.pool2d(x, pool_type="avg", global_pooling=True,
                         data_format="NHWC")
    return pt.layers.fc(x, size=CLASSES)


def _step_one(pt, counter, start, fused, recompute, feeds):
    """Step one's loss and every gradient, one list per feed, and the
    number of segment ops."""
    counter.Program._uid_counter = start
    pt.flags.FLAGS.fused_conv_epilogue = fused
    try:
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 5
        with pt.program_guard(main, startup):
            images = pt.layers.data("images", [SIZE, SIZE, 3])
            label = pt.layers.data("label", [1], "int64")
            loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
                _narrow(pt, images, recompute), label))
            pgs = pt.optimizer.MomentumOptimizer(LR, 0.9).minimize(loss)
    finally:
        pt.flags.reset_flags()
    names = [loss.name] + [f"{p.name}@GRAD" for p, _ in pgs]
    out = []
    for feed in feeds:
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        out.append([np.asarray(a) for a in exe.run(
            main, feed=feed, fetch_list=names, scope=scope)])
    types = [op.type for op in main.global_block.ops]
    return out, names, types.count("seg_fwd"), types.count("grad_seg")


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_narrow_resnet_recompute_step_one_matches_jax(fused):
    rng = np.random.RandomState(1)
    feed = {"images": rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
            "label": rng.randint(0, CLASSES, (BATCH, 1)).astype(np.int64)}
    nudged = dict(feed, images=(feed["images"] * np.float32(1 + NUDGE)))
    start = jprog.Program._uid_counter
    (jout, jnudged), names, jsegs, _ = _step_one(jpt, jprog, start, fused,
                                                 True, [feed, nudged])
    (tout,), tnames, tsegs, tgrads = _step_one(tpt, tprog, start, fused,
                                               True, [feed])
    (plain,), _, none, _ = _step_one(tpt, tprog, start, fused, False,
                                     [feed])
    assert tnames == names and len(names) == 39
    assert tsegs == tgrads == jsegs == (4 if fused else 3) and none == 0
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-6)
    for name, j, jn, t, p in zip(names[1:], jout[1:], jnudged[1:],
                                 tout[1:], plain[1:]):
        move = np.linalg.norm(jn - j)
        assert move > 0, name
        assert np.linalg.norm(t - j) <= NUDGE_MULT * move, (
            name, np.linalg.norm(t - j) / move)
        assert np.linalg.norm(p - t) <= NUDGE_MULT * move, (
            name, np.linalg.norm(p - t) / move)
