"""MNIST, synthetic (counterpart of ``paddle_tpu/dataset/mnist.py``'s
synthetic readers). Samples are ``(image, label)``: a flat float32[784]
in [-1, 1] and an int in [0, 10). Each digit is a fixed prototype of
three gaussian blobs, and each sample its digit's prototype plus
gaussian noise, clipped: separable enough that LeNet converges. The
readers never read files.
"""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ["train", "test"]

TRAIN_SIZE = 8192
TEST_SIZE = 1024


def _prototypes():
    rng = common.synthetic_rng("mnist-protos")
    protos = []
    for _ in range(10):
        img = np.zeros((28, 28), np.float32)
        # each digit: 3 gaussian blobs at digit-specific locations
        for _ in range(3):
            cy, cx = rng.randint(4, 24, size=2)
            yy, xx = np.mgrid[0:28, 0:28]
            img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
        protos.append(np.clip(img, 0, 1))
    return protos


def _synthetic_reader(n: int, seed_name: str):
    protos = _prototypes()

    def reader():
        rng = common.synthetic_rng(seed_name)
        for _ in range(n):
            label = int(rng.randint(0, 10))
            img = protos[label] + rng.normal(0, 0.15, (28, 28)).astype(
                np.float32)
            img = np.clip(img, 0, 1) * 2.0 - 1.0  # [-1, 1]
            yield img.reshape(784).astype(np.float32), label

    return reader


def train():
    return _synthetic_reader(TRAIN_SIZE, "mnist-train")


def test():
    return _synthetic_reader(TEST_SIZE, "mnist-t10k")
