"""UCI housing regression dataset (reference v2/dataset/uci_housing.py API).

Samples: (features float32[13], price float32[1]). When the real
``housing.data`` is present in the cache dir it is parsed with the
reference's rules (whitespace floats, 14 cols, per-feature
(x-avg)/(max-min) normalization, 80/20 split — uci_housing.py:60
load_data); otherwise a synthetic fallback draws features then prices
from a fixed linear model + noise, so fit_a_line-style book tests
converge deterministically.

Counterpart of ``paddle_tpu/dataset/uci_housing.py``, ported whole: the synthetic
readers yield the same samples bit for bit (``common.synthetic_rng``),
and the real-corpus branches read the same files under ``common.DATA_HOME``.
"""
from __future__ import annotations

import os

import numpy as np

from . import common

__all__ = ["train", "test", "feature_names"]

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS", "RAD", "TAX",
    "PTRATIO", "B", "LSTAT",
]

TRAIN_SIZE = 404
TEST_SIZE = 102


def _synthetic(n, seed_name):
    w_rng = common.synthetic_rng("uci-weights")
    true_w = w_rng.randn(13, 1).astype(np.float32)

    def reader():
        rng = common.synthetic_rng(seed_name)
        for _ in range(n):
            x = rng.rand(13).astype(np.float32)
            y = (x @ true_w).astype(np.float32) + rng.normal(0, 0.05, 1).astype(np.float32)
            yield x, y

    return reader


def _real_path():
    p = os.path.join(common.DATA_HOME, "uci_housing", "housing.data")
    return p if os.path.exists(p) else None


def _load_real(ratio=0.8):
    data = np.fromfile(_real_path(), sep=" ").astype(np.float64)
    data = data.reshape(data.shape[0] // 14, 14)
    maxs, mins = data.max(axis=0), data.min(axis=0)
    avgs = data.mean(axis=0)
    for i in range(13):
        data[:, i] = (data[:, i] - avgs[i]) / (maxs[i] - mins[i])
    offset = int(data.shape[0] * ratio)
    return data[:offset], data[offset:]


def _real_reader(is_test):
    def reader():
        train_rows, test_rows = _load_real()
        for row in (test_rows if is_test else train_rows):
            yield (row[:13].astype(np.float32),
                   row[13:].astype(np.float32))

    return reader


def train():
    if _real_path():
        return _real_reader(is_test=False)
    return _synthetic(TRAIN_SIZE, "uci-train")


def test():
    if _real_path():
        return _real_reader(is_test=True)
    return _synthetic(TEST_SIZE, "uci-test")
