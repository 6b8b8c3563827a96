"""Runtime flags. Counterpart of ``paddle_tpu/flags.py``, cut to the
flags the port reads (booleans, ints and strings), behind the same ``FLAGS`` namespace
(``flags.FLAGS.fused_conv_epilogue``). Components read FLAGS when they
build, so a flip affects what is built afterwards; ``reset_flags``
restores every default.
"""
from __future__ import annotations

from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    # lower NHWC 1x1/stride-1 conv+BN(+relu)(+residual) chains in models
    # as the fused conv1x1_bn_act op (ops/fusion_ops.py)
    "fused_conv_epilogue": False,
    # bf16 products on f32 master weights (mixed precision) for ops that
    # run while ops.common.set_amp has not been called
    "use_amp": False,
    # global graph RNG seed used when a program sets no random_seed of
    # its own; runs are deterministic for a fixed seed
    "seed": 0,
    # verify programs before compiling them (the JAX package's analysis
    # plane; not ported: setting it makes the engines raise)
    "verify_program": False,
    # scan fetched outputs and updated state for NaN/Inf each run
    # (executor.cc:25 --check_nan_inf)
    "check_nan_inf": False,
    # default trainer log cadence in batches (Flags.h --log_period)
    "log_period": 100,
    # deterministic chaos plan for manual resilience drills, e.g.
    # 'preempt@5,torn_checkpoint@3': kind@step entries
    # (resilience/faults.py FAULT_KINDS) injected once each into the next
    # SGD.train run; empty = no injection
    "fault_plan": "",
}
_values: Dict[str, Any] = dict(_DEFAULTS)


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
        if isinstance(_DEFAULTS[name], bool):
            _values[name] = _parse_bool(value)
        elif isinstance(_DEFAULTS[name], str):
            _values[name] = str(value)
        else:
            _values[name] = int(value)


FLAGS = _Namespace()


def reset_flags() -> None:
    """Restore every flag to its default (tests)."""
    _values.update(_DEFAULTS)
