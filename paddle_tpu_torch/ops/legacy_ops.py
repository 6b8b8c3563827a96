"""Ops of the legacy gserver layer-type tail. Counterpart of
``paddle_tpu/ops/legacy_ops.py``, cut to ``addto``, which v2's ``fc``
over a sparse input and its ``addto_layer`` append; the rest of the
tail is ROADMAP.md Queue 1 item 8."""
from __future__ import annotations

from ..core.registry import register_op
from .common import maybe, out


@register_op("addto", optional_inputs=("Bias",))
def addto(attrs, ins):
    """The elementwise sum of N same-shaped inputs, in order, then the
    optional Bias (AddtoLayer.cpp)."""
    xs = ins["X"]
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    b = maybe(ins, "Bias")
    if b is not None:
        acc = acc + b
    return out(Out=acc)
