"""Runtime flags. Counterpart of ``paddle_tpu/flags.py``, cut to the
flags the port reads, behind the same ``FLAGS`` namespace
(``flags.FLAGS.fused_conv_epilogue``). Components read FLAGS when they
build, so a flip affects what is built afterwards; ``reset_flags``
restores every default.
"""
from __future__ import annotations

from typing import Any, Dict

_DEFAULTS: Dict[str, bool] = {
    # lower NHWC 1x1/stride-1 conv+BN(+relu)(+residual) chains in models
    # as the fused conv1x1_bn_act op (ops/fusion_ops.py)
    "fused_conv_epilogue": False,
}
_values: Dict[str, bool] = dict(_DEFAULTS)


class FlagError(ValueError):
    pass


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise FlagError(f"not a boolean: {v!r}")


class _Namespace:
    """Attribute view over the flags (gflags' FLAGS object)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return _values[name]
        except KeyError:
            raise AttributeError(f"unknown flag {name!r}; defined flags: "
                                 f"{sorted(_values)}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        if name not in _values:
            raise FlagError(f"unknown flag {name!r}")
        _values[name] = _parse_bool(value)


FLAGS = _Namespace()


def reset_flags() -> None:
    """Restore every flag to its default (tests)."""
    _values.update(_DEFAULTS)
