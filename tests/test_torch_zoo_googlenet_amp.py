"""The reference benchmark's GoogLeNet training row under AMP, built by
the same code in both packages (the f32 half is
``tests/test_torch_zoo_googlenet.py``).

``bench.py``'s ``bench_image_model`` program around
``models.googlenet`` at batch 2, 10 classes and 64x64 inputs, built with
AMP on in both packages, with the checks of
``tests/test_torch_zoo_alexnet.py``: every variable's dtype (the
parameters behind a bf16 activation declared bf16), the startup draws
(bf16 ones among them) and the step-1 dropout masks equal JAX's; step
1's loss at rtol 2e-3 and the AMP rule. Here every pre-activation equals
JAX's bit for bit, so no ReLU flips, and every gradient lies within
``AMP_ULPS`` bf16 ulps of its largest |value| of JAX's (measured at most
9).
"""
import pytest
import torch

import paddle_tpu.ops.common as jax_common
import paddle_tpu_torch.ops.common as torch_common
from test_torch_zoo_alexnet import (ZooPair, check_dtypes_and_startup,
                                    check_step_one)
from test_torch_zoo_googlenet import HW, googlenet

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_common, "_AMP", True)
    mp.setattr(torch_common, "_AMP", True)
    try:
        yield ZooPair(googlenet, HW)
    finally:
        mp.undo()


@pytest.fixture
def amp_on(monkeypatch):
    monkeypatch.setattr(jax_common, "_AMP", True)
    monkeypatch.setattr(torch_common, "_AMP", True)


def test_dtypes_and_startup_values_equal_jax(pair, amp_on):
    check_dtypes_and_startup(pair)
    declared = {str(v.dtype) for n, v in pair.j[0].global_block.vars.items()
                if v.persistable and n.startswith("conv2d.w")}
    assert declared == {"bfloat16", "float32"}, declared


def test_step_one_matches_jax(pair, amp_on):
    assert check_step_one(pair, amp=True) == 0  # no ReLU flips
