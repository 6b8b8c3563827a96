"""Layer builders of the legacy gserver layer-type tail
(``ops/legacy_ops.py``). Counterpart of ``paddle_tpu/layers/legacy.py``,
cut to ``addto``."""
from __future__ import annotations

from .layer_helper import LayerHelper


def addto(inputs, bias=None, act=None, **kw):
    """Elementwise sum of same-shaped layers (addto_layer)."""
    h = LayerHelper("addto", main_program=kw.get("main_program"),
                    startup_program=kw.get("startup_program"))
    ins = {"X": list(inputs)}
    if bias is not None:
        ins["Bias"] = [bias]
    y = h.simple_op("addto", ins, {})
    return h.append_activation(y, act) if act else y
