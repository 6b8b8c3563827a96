"""Control-flow layers. Counterpart of ``paddle_tpu/layers/control_flow.py``,
cut to ``increment`` (gradient accumulation's step counter)."""
from __future__ import annotations

from .layer_helper import LayerHelper


def increment(x, value=1.0, main_program=None, startup_program=None):
    """x + value, as a new variable."""
    helper = LayerHelper("increment", main_program=main_program,
                         startup_program=startup_program)
    return helper.simple_op("increment", {"X": [x]}, {"step": value})
