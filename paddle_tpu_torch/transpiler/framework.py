"""Pass framework: Pass base class, registry, PassManager.

Counterpart of ``paddle_tpu/transpiler/framework.py``: a fixed, named
ordering of small program rewrites, each timed (wall time and op-count
delta per pass, ``stats()``/``metrics_dict()``) and dumpable (op listings
before and after, ``ir_dump_hook``), so a bad rewrite bisects to one pass.

Passes mutate the given Program in place under a ``PassContext`` that
carries the feed/fetch contract and, optionally, a Scope: passes that
rewrite weights (BN folding, constant folding) write new names into that
scope and never overwrite existing entries, so callers hand a child scope
(``Scope(parent=user_scope)``) and keep their own state unchanged.

The JAX package's pass sandwich (``verify_each``: the analysis plane's
verifier re-run after every pass) and its profiler ``StatSet`` are not
ported; ``verify_each=True`` raises, naming ``ROADMAP.md``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..core.program import Program
from ..core.scope import Scope


class PassContext:
    """What a pass may consult: the feed/fetch contract, the scope
    holding parameter values, and policy knobs.

    ``preserve_state_writes``: dead-op elimination also keeps ops that
    write a name resident in ``scope`` (state nobody fetches)."""

    def __init__(self, feed_names: Sequence[str],
                 fetch_names: Sequence[str],
                 scope: Optional[Scope] = None,
                 preserve_state_writes: bool = False):
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.scope = scope
        self.preserve_state_writes = preserve_state_writes
        self.notes: List[str] = []

    def note(self, msg: str) -> None:
        self.notes.append(msg)


@dataclasses.dataclass
class PassResult:
    """One pass application: wall time and op-count delta."""

    name: str
    seconds: float
    ops_before: int
    ops_after: int

    @property
    def op_delta(self) -> int:
        return self.ops_after - self.ops_before

    @property
    def changed(self) -> bool:
        return self.ops_after != self.ops_before


class Pass:
    """Base class: subclass, set ``name``, implement ``apply``, which
    mutates ``program`` in place. Running a pass twice must change
    nothing the second time (pipelines re-run on transpiled models)."""

    name: str = ""

    def apply(self, program: Program, ctx: PassContext) -> None:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


_PASS_REGISTRY: Dict[str, Callable[[], Pass]] = {}


def register_pass(factory: Callable[[], Pass] = None, *,
                  name: Optional[str] = None):
    """Register a Pass class (or zero-arg factory) under its ``name``.
    Usable as a decorator on Pass subclasses."""

    def _do(f):
        key = name or getattr(f, "name", "") or getattr(f, "__name__", "")
        if not key:
            raise ValueError("pass factory needs a name")
        if key in _PASS_REGISTRY:
            raise ValueError(f"pass {key!r} already registered")
        _PASS_REGISTRY[key] = f
        return f

    if factory is None:
        return _do
    return _do(factory)


def get_pass(name: str) -> Pass:
    if name not in _PASS_REGISTRY:
        raise KeyError(f"pass {name!r} is not registered "
                       f"(known: {sorted(_PASS_REGISTRY)})")
    return _PASS_REGISTRY[name]()


def registered_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


def _op_count(program: Program) -> int:
    return sum(len(b.ops) for b in program.blocks)


def ir_dump_hook(dirname: str) -> Callable[[str, str, str], None]:
    """A dump hook writing ``NN_<pass>.{before,after}.txt`` op listings
    into ``dirname``: plug into ``PassManager(dump_hook=...)``."""
    seq = {"n": 0}

    def hook(pass_name: str, before: str, after: str) -> None:
        os.makedirs(dirname, exist_ok=True)
        stem = os.path.join(dirname, f"{seq['n']:02d}_{pass_name}")
        with open(stem + ".before.txt", "w") as f:
            f.write(before)
        with open(stem + ".after.txt", "w") as f:
            f.write(after)
        seq["n"] += 1

    return hook


class PassManager:
    """Runs an ordered pass list over a program, timing each pass.

    ``dump_hook(pass_name, before, after)`` receives the program's
    listing around every pass that changed it (every pass with
    ``dump_all``)."""

    def __init__(self, passes: Sequence,
                 dump_hook: Optional[Callable[[str, str, str], None]] = None,
                 dump_all: bool = False,
                 verify_each: Optional[bool] = None):
        if verify_each:
            raise NotImplementedError(
                "the pass sandwich (verify_each) needs the analysis plane, "
                "which is not ported to paddle_tpu_torch; see ROADMAP.md "
                "Queue 1 item 9")
        self.passes: List[Pass] = [
            get_pass(p) if isinstance(p, str) else p for p in passes]
        self.dump_hook = dump_hook
        self.dump_all = dump_all
        self.results: List[PassResult] = []
        self.last_notes: List[str] = []

    def run(self, program: Program, feed_names: Sequence[str],
            fetch_names: Sequence[str], scope: Optional[Scope] = None,
            **ctx_kw) -> Program:
        """Apply every pass in order (in place) and return the program."""
        from ..flags import FLAGS

        if FLAGS.verify_program:
            raise NotImplementedError(
                "--verify_program needs the analysis plane, which is not "
                "ported to paddle_tpu_torch; see ROADMAP.md Queue 1 item 9")
        ctx = PassContext(feed_names, fetch_names, scope=scope, **ctx_kw)
        self.results = []
        for p in self.passes:
            before = str(program) if self.dump_hook else ""
            n0 = _op_count(program)
            t0 = time.perf_counter()
            p.apply(program, ctx)
            dt = time.perf_counter() - t0
            n1 = _op_count(program)
            self.results.append(PassResult(p.name, dt, n0, n1))
            if self.dump_hook and (self.dump_all or n1 != n0):
                self.dump_hook(p.name, before, str(program))
        self.last_notes = list(ctx.notes)
        return program

    def stats(self) -> List[dict]:
        """JSON-safe per-pass rows from the last ``run``."""
        return [{"pass": r.name, "ms": round(r.seconds * 1e3, 3),
                 "ops_before": r.ops_before, "ops_after": r.ops_after,
                 "op_delta": r.op_delta}
                for r in self.results]

    def metrics_dict(self, prefix: str = "transpile/") -> Dict[str, float]:
        """Flat gauge dict for a serving ``MetricsRegistry``."""
        out: Dict[str, float] = {}
        for r in self.results:
            out[f"{prefix}{r.name}_ms"] = round(r.seconds * 1e3, 3)
            out[f"{prefix}{r.name}_op_delta"] = r.op_delta
        if self.results:
            out[prefix + "total_ms"] = round(
                sum(r.seconds for r in self.results) * 1e3, 3)
            out[prefix + "ops_removed"] = (self.results[0].ops_before
                                           - self.results[-1].ops_after)
        return out

    def format_stats(self) -> str:
        """Human table of the last run."""
        if not self.results:
            return "(no passes run)"
        head = (f"{'pass':<28}{'ms':>10}{'ops before':>12}"
                f"{'ops after':>11}{'delta':>8}")
        lines = [head, "-" * len(head)]
        for r in self.results:
            lines.append(f"{r.name:<28}{r.seconds * 1e3:>10.3f}"
                         f"{r.ops_before:>12}{r.ops_after:>11}"
                         f"{r.op_delta:>+8}")
        return "\n".join(lines)
