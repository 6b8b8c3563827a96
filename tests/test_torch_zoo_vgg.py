"""The reference benchmark's VGG-16 training row, built by the same code
in both packages, and VGG-19's program.

``bench.py``'s ``bench_image_model`` program around ``models.vgg(depth=
16)`` at batch 2, 10 classes and 32x32 inputs, with the checks and
tolerances of ``tests/test_torch_zoo_alexnet.py`` (dtypes, startup draws
and step-1 dropout masks equal; step 1's loss and gradients in f32 at
rtol 1e-5 and under AMP by its rule: measured 64 ReLU flips of 569,344
pre-activations, each within 0.77 bf16 ulps of its tensor's largest
|value| from zero, and gradients at most 0.137 of their norm from JAX's).
VGG-19 (``bench_inference``'s model) and ``nets.img_conv_group`` build
the same programs as in JAX.
"""
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from test_torch_transpiler import program_dict
from test_torch_zoo_alexnet import (CLASSES, ZooPair, amp,  # noqa: F401
                                    check_dtypes_and_startup, check_step_one)

torch.set_num_threads(1)
HW = 32


def vgg16(pt, images):
    return pt.models.vgg(images, num_classes=CLASSES, depth=16)


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, amp):
    if amp not in pairs:
        pairs[amp] = ZooPair(vgg16, HW)
    return pairs[amp]


def test_dtypes_and_startup_values_equal_jax(pairs, amp):
    check_dtypes_and_startup(_pair(pairs, amp))


def test_step_one_matches_jax(pairs, amp):
    check_step_one(_pair(pairs, amp), amp)


def _program_dicts(builder):
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


@pytest.mark.parametrize("depth,convs", [(16, 13), (19, 16)])
def test_vgg_program_dict_equals_jax(depth, convs):
    def builder(pt):
        images = pt.layers.data("images", shape=[32, 32, 3])
        pt.models.vgg(images, num_classes=CLASSES, depth=depth,
                      is_test=True)

    jd, td = _program_dicts(builder)
    assert td == jd
    ops = [op["type"] for op in td[0]["blocks"][0]["ops"]]
    assert ops.count("conv2d") == convs and ops.count("pool2d") == 5


@pytest.mark.parametrize("options", [
    dict(conv_with_batchnorm=True, conv_batchnorm_drop_rate=0.3),
    dict(conv_filter_size=[3, 1], conv_with_batchnorm=[False, True],
         conv_batchnorm_drop_rate=[0.0, 0.5], pool_type="avg"),
], ids=["bn_dropout", "per_conv"])
def test_img_conv_group_options_equal_jax(options):
    """img_conv_group's batch-norm, dropout and per-conv options build
    JAX's program."""
    def builder(pt):
        images = pt.layers.data("images", shape=[8, 8, 4])
        pt.nets.img_conv_group(images, [6, 5], conv_act="relu",
                               data_format="NHWC", **options)

    jd, td = _program_dicts(builder)
    assert td == jd


def test_simple_img_conv_pool_and_glu():
    def builder(pt):
        images = pt.layers.data("images", shape=[12, 12, 3])
        pt.nets.simple_img_conv_pool(images, 4, 3, 2, 2, "relu",
                                     data_format="NHWC")

    jd, td = _program_dicts(builder)
    assert td == jd

    def glu_builder(pt):
        x = pt.layers.data("x", shape=[6, 8])
        pt.nets.glu(x, dim=-1)

    jd, td = _program_dicts(glu_builder)
    assert td == jd


def test_vgg_depth_is_16_or_19():
    with pytest.raises(ValueError, match="16 or 19"):
        with tpt.program_guard(tpt.Program(), tpt.Program()):
            tpt.models.vgg(tpt.layers.data("images", [32, 32, 3]), depth=17)
