"""Dtype and variable-type vocabulary for the program IR.

Counterpart of ``paddle_tpu/core/types.py``: the same dtype names, mapped
onto torch dtypes instead of JAX/numpy ones. Op attrs keep the names
(``"float32"``), so a program's attrs read the same in both packages.
"""
from __future__ import annotations

import enum

import torch


class VarType(enum.Enum):
    """Variable kinds, analogous to VarDesc.VarType in the reference."""

    DENSE_TENSOR = "dense_tensor"
    SELECTED_ROWS = "selected_rows"
    TENSOR_ARRAY = "tensor_array"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"


_DTYPE_ALIASES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "float64": torch.float64,
    "fp64": torch.float64,
    "float16": torch.float16,
    "fp16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def to_dtype(dtype) -> torch.dtype:
    """Normalise a dtype spec (a name, a torch dtype, or anything numpy
    reads as a dtype) to a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else None
    if name is None:
        import numpy as np

        name = np.dtype(dtype).name
    if name not in _DTYPE_ALIASES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _DTYPE_ALIASES[name]


def dtype_name(dtype) -> str:
    """The canonical name of a dtype (``torch.float32`` -> ``"float32"``),
    as the JAX package writes it into op attrs."""
    return str(to_dtype(dtype)).replace("torch.", "")


def is_floating(dtype) -> bool:
    return to_dtype(dtype).is_floating_point


def to_numpy(t):
    """A tensor's value as a numpy array on the host. numpy has no
    bfloat16 (JAX fetches one as ``ml_dtypes.bfloat16``, a package the
    port does not take on), so a bf16 value comes back widened to
    float32, which is exact."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
