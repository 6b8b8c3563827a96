"""Dataset infrastructure, cut to the synthetic data's seed and the
cache directory. Counterpart of ``paddle_tpu/dataset/common.py``: a
dataset module draws its synthetic samples from ``synthetic_rng(name)``,
a numpy RandomState seeded from the md5 of the name, so both packages
draw the same samples; a real corpus is read only where its files
already lie under ``DATA_HOME`` (the same ``PADDLE_TPU_DATA_HOME``
directory as the JAX package's)."""
from __future__ import annotations

import hashlib
import os

import numpy as np

DATA_HOME = os.path.expanduser(os.environ.get("PADDLE_TPU_DATA_HOME",
                                              "~/.cache/paddle_tpu/dataset"))


def synthetic_rng(name: str) -> np.random.RandomState:
    """Deterministic per-dataset RNG so synthetic data is reproducible."""
    seed = int(hashlib.md5(name.encode()).hexdigest()[:8], 16) % (2**31)
    return np.random.RandomState(seed)


def download(url: str, module_name: str, md5sum: str = None) -> str:
    """Downloads are disabled: every dataset module serves its synthetic
    reader."""
    raise FileNotFoundError(
        f"{module_name}: downloads are disabled ({url}); the dataset's "
        f"readers serve synthetic samples")
