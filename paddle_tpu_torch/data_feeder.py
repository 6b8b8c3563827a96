"""DataFeeder: reader minibatches -> executor feed dicts.

Counterpart of ``paddle_tpu/data_feeder.py``: a reader yields rows
(tuples ordered like ``feed_list``); the feeder stacks each column into a
dense numpy array of the variable's dtype and shape. int64 columns stay
int64 (the JAX package carries them as int32 without x64).

Variable-length (LoD) columns, whose entries are sequences of differing
length, are padded to the batch max and returned together with a
``<name>@len`` int32 length vector. A ``sparse_float_vector`` column (v2's
``data_type``), rows of (index, value) pairs, becomes the padded id feed
with its lengths and the padded value feed of its companion variable.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .core.program import Variable
from .core.types import dtype_name


def _is_ragged(col) -> bool:
    try:
        first = np.asarray(col[0])
    except Exception:
        return True
    if first.ndim == 0:
        return False
    lengths = set()
    for item in col:
        arr = np.asarray(item)
        lengths.add(arr.shape[0] if arr.ndim else 0)
        if len(lengths) > 1:
            return True
    return False


class DataFeeder:
    """``pad_to_multiple`` rounds every ragged column's padded length up
    to the next multiple (bucket padding), so varlen batches come in a
    bounded set of shapes. Pair it with ``reader.bucket_by_length(...,
    pad_to_multiple=m)`` so batches also group by the same buckets."""

    def __init__(self, feed_list: Sequence[Variable], place=None,
                 pad_to_multiple: int = None):
        self.feed_vars = list(feed_list)
        self.place = place
        self.pad_to_multiple = (int(pad_to_multiple)
                                if pad_to_multiple else None)

    def feed(self, data: Sequence[Sequence]) -> Dict[str, np.ndarray]:
        """Convert a minibatch (list of rows) into {name: array} feeds."""
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_vars):
            col = [row[i] for row in data]
            sval = getattr(var, "sparse_values", None)
            if sval is not None:
                # sparse_float_vector rows, [(index, value), ...]: the
                # padded id feed and its companion value feed
                out.update(self._pad_sequences(
                    var, [[p[0] for p in item] for item in col]))
                out[sval.name] = self._pad_sequences(
                    sval, [[p[1] for p in item] for item in col])[sval.name]
                continue
            if var.lod_level > 0 or _is_ragged(col):
                out.update(self._pad_sequences(var, col))
            else:
                arr = np.asarray(col, dtype=_np_dtype(var))
                shape = tuple(d for d in (var.shape or ()) if d != -1)
                if shape and arr.shape[1:] != shape \
                        and arr.size == len(col) * int(np.prod(shape)):
                    arr = arr.reshape((len(col),) + shape)
                out[var.name] = arr
        return out

    def _pad_sequences(self, var, col) -> Dict[str, np.ndarray]:
        dtype = _np_dtype(var)
        seqs = [np.asarray(item, dtype=dtype) for item in col]
        lengths = np.asarray([s.shape[0] for s in seqs], dtype=np.int32)
        max_len = int(lengths.max()) if len(lengths) else 0
        m = self.pad_to_multiple
        if m and m > 1:
            max_len = -(-max_len // m) * m
        tail = seqs[0].shape[1:] if seqs and seqs[0].ndim > 1 else ()
        padded = np.zeros((len(seqs), max_len) + tail, dtype=dtype)
        for i, s in enumerate(seqs):
            padded[i, : s.shape[0]] = s
        return {var.name: padded, f"{var.name}@len": lengths}


def _np_dtype(var):
    """The numpy dtype of ``var``'s torch dtype (bf16 columns stack as
    f32; the executor casts them on the device)."""
    name = dtype_name(var.dtype)
    return np.float32 if name == "bfloat16" else np.dtype(name)
