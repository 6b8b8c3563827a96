"""The reference benchmark's GoogLeNet training row, built by the same
code in both packages, in f32 (its AMP half is
``tests/test_torch_zoo_googlenet_amp.py``: the JAX package compiles each
precision's startup and step for ~20 s on the CPU).

``bench.py``'s ``bench_image_model`` program around
``models.googlenet`` at batch 2, 10 classes and 64x64 inputs, with the
checks and tolerances of ``tests/test_torch_zoo_alexnet.py``: dtypes,
startup draws and step-1 dropout masks equal, step 1's loss and
gradients at rtol 1e-5.
"""
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from test_torch_zoo_alexnet import (CLASSES, ZooPair,
                                    build_bench_image_model,
                                    check_dtypes_and_startup, check_step_one)

torch.set_num_threads(1)
HW = 64


def googlenet(pt, images):
    return pt.models.googlenet(images, num_classes=CLASSES)


@pytest.fixture(scope="module")
def pair():
    return ZooPair(googlenet, HW)


def test_dtypes_and_startup_values_equal_jax(pair):
    check_dtypes_and_startup(pair)


def test_step_one_matches_jax(pair):
    check_step_one(pair, amp=False)


def test_inception_blocks_concat_on_the_channel_axis():
    """Nine inception blocks, each one concat of its four branches on
    axis 3 (NHWC), with the shapes JAX infers."""
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main = build_bench_image_model(pt, googlenet, HW)[0]
        blk = main.global_block
        built.append([(op.attrs["axis"], len(op.inputs["X"]),
                       list(blk.var(op.outputs["Out"][0]).shape))
                      for op in blk.ops if op.type == "concat"])
    assert built[1] == built[0]
    assert len(built[1]) == 9
    assert {(a, n) for a, n, _ in built[1]} == {(3, 4)}
    assert built[1][-1][2] == [-1, 1, 1, 1024]
