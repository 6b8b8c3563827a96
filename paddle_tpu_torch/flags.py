"""Runtime flag registry: the gflags plane. Counterpart of
``paddle_tpu/flags.py``, with all of its flags, types and entry points:

- ``define_*`` at module scope registers a typed flag with a default;
- environment overrides: ``PADDLE_TPU_<NAME>`` is read at definition
  time (the cluster-launcher path, gflags' FLAGS_* env);
- ``parse_flags(argv)`` consumes ``--name=value`` / ``--name value`` /
  ``--noname`` tokens, returning the tokens it does not know;
- ``set_flags({...})``, ``get_flag(name)``, ``flags_registered()``,
  ``print_flags()`` and ``reset_flags()``.

Access is via the ``FLAGS`` namespace: ``flags.FLAGS.check_nan_inf``.
Components read FLAGS when they build or run, so a flip affects what
comes after it (constructor arguments still win).

Flags whose plane is not ported parse and are stored, and do nothing
(their help says so): ``compilation_cache_dir``,
``verify_restored_donation`` and ``warmup_concurrency`` are XLA's
compilation cache and AOT warm-up, which have no counterpart on the
card; ``op_callsite``, ``trace_level``, ``trace_sample_rate``,
``trace_buffer`` and ``reduce_peak_memory`` wait for the tracing,
call-site and analysis planes (ROADMAP item 9). ``verify_program`` makes
the engines and the trainer raise, naming item 9.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List

_ENV_PREFIX = "PADDLE_TPU_"


class FlagError(ValueError):
    pass


class _Flag:
    __slots__ = ("name", "help", "parser", "type_name")

    def __init__(self, name, help_str, parser, type_name):
        self.name = name
        self.help = help_str
        self.parser = parser
        self.type_name = type_name


# the registry, each flag's default, and its value now
_registry: Dict[str, _Flag] = {}
_DEFAULTS: Dict[str, Any] = {}
_values: Dict[str, Any] = {}


class _Namespace:
    """Attribute view over the registry (gflags' FLAGS object)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return _values[name]
        except KeyError:
            raise AttributeError(f"unknown flag {name!r}; defined flags: "
                                 f"{sorted(_registry)}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        flag = _registry.get(name)
        if flag is None:
            raise FlagError(f"unknown flag {name!r}")
        _values[name] = flag.parser(value)


FLAGS = _Namespace()


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise FlagError(f"not a boolean: {v!r}")


def _parse_float(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        raise FlagError(f"not a float: {v!r}") from None


def _parse_int(v: Any) -> int:
    try:
        return int(str(v), 0)
    except ValueError:
        raise FlagError(f"not an integer: {v!r}") from None


def _define(name: str, default: Any, help_str: str,
            parser: Callable[[Any], Any], type_name: str) -> None:
    if name in _registry:
        raise FlagError(f"flag {name!r} already defined")
    _registry[name] = _Flag(name, help_str, parser, type_name)
    _DEFAULTS[name] = default
    env = os.environ.get(_ENV_PREFIX + name.upper())
    _values[name] = default if env is None else parser(env)


def define_bool(name, default, help_str=""):
    _define(name, default, help_str, _parse_bool, "bool")


def define_int32(name, default, help_str=""):
    _define(name, default, help_str, _parse_int, "int32")


def define_float(name, default, help_str=""):
    _define(name, default, help_str, _parse_float, "float")


def define_string(name, default, help_str=""):
    _define(name, default, help_str, str, "string")


def get_flag(name: str) -> Any:
    return getattr(FLAGS, name)


def set_flags(values: Dict[str, Any]) -> None:
    """Bulk set, fluid's paddle.set_flags analogue."""
    for k, v in values.items():
        setattr(FLAGS, k, v)


def flags_registered() -> List[str]:
    return sorted(_registry)


def reset_flags() -> None:
    """Restore every flag to its registered default (tests)."""
    _values.update(_DEFAULTS)


def parse_flags(argv: List[str]) -> List[str]:
    """Consume --name=value / --name value / --noname tokens from argv;
    returns the tokens that are not recognized flags (positional args and
    foreign options), as gflags' remove_flags does."""
    rest: List[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            rest.append(tok)
            i += 1
            continue
        name, eq, val = tok[2:].partition("=")
        flag = _registry.get(name)
        if flag is not None:
            if eq:
                _values[name] = flag.parser(val)
            elif flag.type_name == "bool":
                _values[name] = True
            elif i + 1 < len(argv):
                _values[name] = flag.parser(argv[i + 1])
                i += 1
            else:
                raise FlagError(f"flag --{name} expects a value")
        elif name.startswith("no") and not eq and \
                getattr(_registry.get(name[2:]), "type_name", "") == "bool":
            _values[name[2:]] = False
        else:
            rest.append(tok)
        i += 1
    return rest


def print_flags() -> str:
    lines = []
    for name in sorted(_registry):
        f, v = _registry[name], _values[name]
        mark = "" if v == _DEFAULTS[name] else "  (set)"
        lines.append(f"--{name}={v!r}  [{f.type_name}] {f.help}{mark}")
    return "\n".join(lines)


_XLA_ONLY = " (XLA-only: parsed and stored, nothing on the card reads it)"
_ITEM_9 = " (not ported: parsed and stored, nothing reads it; ROADMAP item 9)"

define_bool("check_nan_inf", False,
            "scan fetched outputs and updated state for NaN/Inf each run "
            "(executor.cc:25 --check_nan_inf)")
define_bool("use_amp", False,
            "bf16 products on f32 master weights (mixed precision) for "
            "ops that run while ops.common.set_amp has not been called")
define_string("mxu_precision", "default",
              "contraction precision while ops.common.set_mxu_precision "
              "has not been called: default (TF32 on the card: cuBLAS, "
              "cuDNN and the 1xTF32 conv GEMM kernels) | high | highest "
              "(f32-accurate: full f32 library products, the 3xTF32 "
              "kernels); every policy is full f32 on the CPU")
define_bool("fused_conv_epilogue", False,
            "lower NHWC 1x1/stride-1 conv+BN(+relu)(+residual) chains in "
            "models as the fused conv1x1_bn_act op (ops/fusion_ops.py)")
define_string("compilation_cache_dir", "",
              "persist XLA compilations here" + _XLA_ONLY)
define_bool("verify_restored_donation", True,
            "verify donated-state write-back of executables restored "
            "from --compilation_cache_dir" + _XLA_ONLY)
define_int32("warmup_concurrency", 4,
             "thread-pool width for AOT manifest replay" + _XLA_ONLY)
define_int32("seed", 0,
             "global graph RNG seed used when a program sets no "
             "random_seed of its own; runs are deterministic for a fixed "
             "seed")
define_int32("log_period", 100,
             "default trainer log cadence in batches (Flags.h --log_period)")
define_bool("op_callsite", True,
            "record user file:line on every appended op for error "
            "reports" + _ITEM_9)
define_int32("trace_level", 0,
             "span-tracing level: 0 off, 1 executor/serving/trainer "
             "spans, 2 per-op debug runs" + _ITEM_9)
define_bool("verify_program", False,
            "run the program verifier around every transpiler pass and "
            "on the programs the engines compile (not ported: setting it "
            "makes the engines and the trainer raise, naming ROADMAP "
            "item 9)")
define_bool("reduce_peak_memory", False,
            "append the memory-aware op-scheduling pass to the inference "
            "pipelines" + _ITEM_9)
define_string("fault_plan", "",
              "deterministic chaos plan for manual resilience drills, "
              "e.g. 'preempt@5,torn_checkpoint@3': kind@step entries "
              "(resilience/faults.py FAULT_KINDS) injected once each "
              "into the next SGD.train run; empty = no injection")
define_float("trace_sample_rate", 1.0,
             "fraction of trace roots kept by the span tracer" + _ITEM_9)
define_int32("trace_buffer", 16384,
             "span ring-buffer capacity" + _ITEM_9)
