"""Deterministic fault injection: the chaos plane of the resilience stack.

Counterpart of ``paddle_tpu/resilience/faults.py``. A :class:`FaultPlan`
is an explicit schedule of faults, each entry firing exactly once at an
exact step, so a crash-recovery parity test can assert bitwise equality.
The port's trainer consumes these kinds:

- ``crash``           trainer, before step k: raises :class:`SimulatedCrash`
                      (hard kill: no final checkpoint).
- ``preempt``         trainer, after step k: sets the graceful-shutdown
                      flag, as if SIGTERM had arrived (drain + final
                      checkpoint + ``EndPass(interrupted=True)``).
- ``executor_error``  trainer, before step k: raises a retryable
                      :class:`TransientFault` (consumed by the step retry
                      policy: the step still runs exactly once).
- ``torn_checkpoint`` CheckpointManager, at the save of step k: the
                      written payload is truncated after the fact, so the
                      md5 no longer matches (a torn write).

The other kinds of ``FAULT_KINDS`` belong to planes the port does not
have yet (the master client, the serving fleet, the elastic trainer);
plans naming them parse, and nothing fires them.

Manual chaos runs go through ``--fault_plan`` (flags.py), e.g.
``FLAGS.fault_plan = "preempt@5,torn_checkpoint@3"``: the trainer parses
it when no plan is installed programmatically.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Tuple

FAULT_KINDS = ("crash", "preempt", "executor_error", "torn_checkpoint",
               "master_drop", "replica_crash", "slow_replica",
               "trainer_crash", "trainer_preempt_rejoin", "zombie_ack",
               "master_partition", "replica_kill", "decode_leg_crash")


class SimulatedCrash(RuntimeError):
    """Fault-plan hard kill: the process dies with no graceful shutdown."""


class TransientFault(RuntimeError):
    """Fault-plan transient error: retry policies treat it as retryable."""


class _Entry:
    __slots__ = ("kind", "step", "params", "fired")

    def __init__(self, kind: str, step: Optional[int], params: dict):
        self.kind = kind
        self.step = step
        self.params = params
        self.fired = False


class FaultPlan:
    """An ordered, one-shot schedule of injected faults.

    ``plan.at(step=5, kind="preempt")`` arms a fault; injection points
    call ``plan.fire(kind, step)`` which consumes (and reports) the first
    matching unfired entry. ``step=None`` entries match the first
    opportunity of their kind. Thread-safe: the master client fires from
    reader threads.
    """

    def __init__(self):
        self._entries: List[_Entry] = []
        self._lock = threading.Lock()
        self.fired_log: List[Tuple[str, Optional[int]]] = []

    def at(self, step: Optional[int] = None, kind: str = "crash",
           **params) -> "FaultPlan":
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of "
                             f"{FAULT_KINDS}")
        self._entries.append(_Entry(kind, None if step is None else int(step),
                                    params))
        return self

    def fire(self, kind: str, step: Optional[int] = None) -> Optional[dict]:
        """Consume the first unfired entry matching (kind, step); returns
        its params dict (possibly empty) or None when nothing matches."""
        with self._lock:
            for e in self._entries:
                if e.fired or e.kind != kind:
                    continue
                if e.step is not None and step is not None \
                        and e.step != step:
                    continue
                e.fired = True
                self.fired_log.append((kind, step))
                from .. import profiler

                profiler.global_stat.add_count(f"fault/{kind}", 1)
                return dict(e.params)
        return None

    def peek(self, kind: str,
             step: Optional[int] = None) -> Optional[dict]:
        """Params of the first unfired entry matching (kind, step)
        WITHOUT consuming it — for injection points that must check a
        threshold carried in the params (e.g. ``replica_kill``'s
        ``after_tokens``) before committing to fire."""
        with self._lock:
            for e in self._entries:
                if e.fired or e.kind != kind:
                    continue
                if e.step is not None and step is not None \
                        and e.step != step:
                    continue
                return dict(e.params)
        return None

    def pending(self) -> List[Tuple[str, Optional[int]]]:
        with self._lock:
            return [(e.kind, e.step) for e in self._entries if not e.fired]

    @contextlib.contextmanager
    def active(self):
        """Install this plan as the process-global active plan."""
        install_plan(self)
        try:
            yield self
        finally:
            clear_plan()

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        """``"kind@step,kind@step,kind"`` -> plan (the --fault_plan
        syntax). A bare ``kind`` fires at the first opportunity."""
        plan = FaultPlan()
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            kind, _, step = tok.partition("@")
            plan.at(step=int(step) if step else None, kind=kind.strip())
        return plan

    def __repr__(self):
        return (f"FaultPlan(pending={self.pending()}, "
                f"fired={self.fired_log})")


_active_plan: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _active_plan


def install_plan(plan: Optional[FaultPlan]) -> None:
    global _active_plan
    _active_plan = plan


def clear_plan() -> None:
    install_plan(None)
