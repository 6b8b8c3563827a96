"""Data-entry layer (fluid layers.data parity). Counterpart of
``paddle_tpu/layers/io.py``; padded sequence feeds (``lod_level`` > 0)
are a later slice of the port."""
from __future__ import annotations

from .layer_helper import LayerHelper


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         main_program=None, stop_gradient=True):
    """Declare a feed variable; by default a -1 batch dimension is
    prepended, and the executor takes the batch from the actual feed."""
    if lod_level > 0:
        raise NotImplementedError(
            "layers.data(lod_level > 0) (padded sequence feeds with a "
            "length companion) is not ported to paddle_tpu_torch yet: it "
            "lands with the sequence-model slice")
    helper = LayerHelper("data", main_program=main_program)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
