"""Data-entry layer (fluid layers.data parity). Counterpart of
``paddle_tpu/layers/io.py``."""
from __future__ import annotations

import numpy as np

from .layer_helper import LayerHelper


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         main_program=None, stop_gradient=True):
    """Declare a feed variable; by default a -1 batch dimension is
    prepended, and the executor takes the batch from the actual feed.

    ``lod_level`` > 0 declares a padded sequence feed: the tensor is
    [batch, T, *shape] (ids declared ``shape=[1]`` stay [batch, T]), and
    an int32 companion ``<name>@len`` ([batch]) carries each row's true
    length, fed beside it and threaded to the sequence layers through
    ``var.seq_len``."""
    helper = LayerHelper("data", main_program=main_program)
    shape = list(shape)
    if lod_level > 0:
        is_ids = (len(shape) == 1 and shape[0] == 1
                  and np.issubdtype(np.dtype(dtype), np.integer))
        shape = [-1, -1] + ([] if is_ids else shape)
        var = helper.block.create_var(
            name=name, shape=shape, dtype=dtype, lod_level=lod_level,
            stop_gradient=stop_gradient, is_data=True)
        len_var = helper.block.create_var(
            name=f"{name}@len", shape=[-1], dtype="int32",
            stop_gradient=True, is_data=True)
        # fed beside its owner column, not a reader column of its own
        len_var.is_companion = True
        var.seq_len = len_var
        return var
    if append_batch_size:
        shape = [-1] + shape
    return helper.block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
