"""Checkpoint manager and per-run trainer resilience state.

Counterpart of ``paddle_tpu/resilience/manager.py``:

- :class:`CheckpointConfig`: the policy handed to
  ``SGD.train(checkpoint=...)``: where, how often, how many to keep,
  whether saves run in the background, resume semantics.
- :class:`CheckpointManager`: executes the policy. A save has two
  phases. The *snapshot* (a device-to-host copy of every scope value,
  complete before the snapshot counts as taken) runs on the trainer
  thread at a drained safe point. The *write* (npz + md5 + atomic rename
  + retention, ``paddle_tpu_torch.checkpoint``) runs on a background
  thread when ``background=True``. The ``ckpt/stall`` timer in the
  profiler's ``global_stat`` covers the part that stalls the loop;
  ``ckpt/*`` counters count saves and restores.
- :class:`TrainResilience`: one ``SGD.train()`` call's run state:
  resume position (pass/iteration/samples), checkpoint cadence, the
  graceful-shutdown flag and fault-plan stepping.

The JAX package's ``ckpt/save``, ``ckpt/write`` and ``ckpt/restore``
trace spans land with the port's trace plane (ROADMAP.md Queue 1 item
9); restoring through a sharding plan with item 10.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..profiler import _tensors
from .faults import FaultPlan, SimulatedCrash, TransientFault, active_plan
from .retry import Retry
from .signals import ShutdownFlag, graceful_shutdown


class CheckpointConfig:
    """Checkpoint policy for ``SGD.train(checkpoint=...)``.

    dirname:            checkpoint directory (created on first save).
    every_n_steps:      periodic cadence in completed steps; 0 disables
                        periodic saves (final/interrupt saves still run).
    keep:               retention — newest ``keep`` checkpoints survive.
    background:         serialize + write on a background thread; only
                        the host snapshot stalls the step loop.
    resume:             auto-restore the latest intact checkpoint (and
                        training position) at ``train()`` start.
    strict:             propagate a corrupt-latest error instead of
                        walking back to an older intact checkpoint.
    save_on_interrupt:  write a final checkpoint on SIGTERM/SIGINT (or a
                        fault-plan preemption) before exiting the loop.
    save_final:         write a checkpoint when training completes.
    install_signal_handlers: wrap the training loop in
                        :func:`graceful_shutdown`.

    On resume the interrupted pass skips the batches it had already
    consumed. The JAX package's hooks for its elastic StreamingTrainer
    (``extra_fn``, ``pre_save_fn``, ``on_saved``, ``accept_fn``,
    ``keep_last_n``, ``skip_batches_on_resume``) land with that trainer,
    which waits for the ``master`` module (ROADMAP.md Queue 1 item 9).
    """

    def __init__(self, dirname: str, every_n_steps: int = 100,
                 keep: int = 3, background: bool = True,
                 resume: bool = True, strict: bool = False,
                 save_on_interrupt: bool = True, save_final: bool = True,
                 install_signal_handlers: bool = True):
        if every_n_steps < 0:
            raise ValueError("every_n_steps must be >= 0")
        self.dirname = dirname
        self.every_n_steps = int(every_n_steps)
        self.keep = int(keep)
        self.background = bool(background)
        self.resume = bool(resume)
        self.strict = bool(strict)
        self.save_on_interrupt = bool(save_on_interrupt)
        self.save_final = bool(save_final)
        self.install_signal_handlers = bool(install_signal_handlers)

    def __repr__(self):
        return (f"CheckpointConfig({self.dirname!r}, "
                f"every_n_steps={self.every_n_steps}, keep={self.keep}, "
                f"background={self.background}, resume={self.resume})")


def _host_copy(value):
    """A host copy of one scope value, which no later step can change.
    A CUDA tensor is copied into pinned memory asynchronously; the
    snapshot waits for all its copies at once (``_HostSnapshot``). The
    port's ops never write into their inputs (``core/executor.py``), so
    the scope's tensors themselves are already immutable: the copy is
    for the background writer, which must not hold device memory that a
    later step might want."""
    if isinstance(value, (tuple, list)):  # the RNG key
        return type(value)(_host_copy(v) for v in value)
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t, non_blocking=True)
        return t.clone()
    return np.array(value, copy=True)


class _HostSnapshot:
    """Scope-shaped view over host copies: what the background writer
    serializes (checkpoint.save_checkpoint only needs keys()/get()). It
    counts as taken when every copy has landed: the constructor waits
    for the devices the scope's tensors live on."""

    def __init__(self, scope):
        names = list(scope.keys())
        values = [scope.get(n) for n in names]
        self._vars = {n: _host_copy(v) for n, v in zip(names, values)}
        for dev in {t.device for v in values for t in _tensors(v)
                    if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def keys(self):
        return iter(self._vars.keys())

    def get(self, name):
        return self._vars[name]

    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for v in self._vars.values() for t in _tensors(v))
                   + sum(v.nbytes for v in self._vars.values()
                         if isinstance(v, np.ndarray)))


class CheckpointManager:
    """Drives periodic / on-signal checkpointing for one scope.

    Not thread-safe by itself: ``save``/``wait``/``close`` are called
    from the training thread at drained safe points; only the npz write
    runs elsewhere. A background write error is re-raised on the next
    ``save``/``wait`` — a checkpoint that silently fails to persist is a
    resume-time data loss.
    """

    def __init__(self, config: CheckpointConfig, scope=None, device=None):
        from ..core.scope import global_scope

        self.config = config
        self.scope = scope if scope is not None else global_scope()
        self.device = device  # where resume() restores (cuda by default)
        self.last_saved_step: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_bytes: Optional[int] = None  # the last payload's size

    # -- cadence -----------------------------------------------------------
    def due(self, step: int) -> bool:
        n = self.config.every_n_steps
        return (n > 0 and step > 0 and step % n == 0
                and step != self.last_saved_step)

    # -- restore -----------------------------------------------------------
    def resume(self) -> Optional[dict]:
        """Restore the latest intact checkpoint into the scope; returns
        its meta (with ``extra`` position) or None when the directory has
        no checkpoint yet. Corruption of the latest walks back to an
        older intact one unless ``strict``."""
        from .. import checkpoint as ckpt_mod
        from .. import profiler

        meta_path = os.path.join(self.config.dirname, ckpt_mod.META_NAME)
        if not os.path.exists(meta_path):
            return None
        meta = ckpt_mod.load_checkpoint(self.config.dirname,
                                        scope=self.scope,
                                        strict=self.config.strict,
                                        device=self.device)
        profiler.global_stat.add_count("ckpt/restores", 1)
        if meta.get("fallback"):
            profiler.global_stat.add_count("ckpt/restore_fallbacks", 1)
        self.last_saved_step = int(meta.get("step", 0))
        return meta

    # -- save --------------------------------------------------------------
    def save(self, step: int, pass_id: int = 0, iteration: int = -1,
             samples_seen: int = 0, reason: str = "periodic",
             wait: bool = False) -> None:
        """Checkpoint the scope as of ``step`` completed steps. MUST be
        called at a drained safe point (no in-flight async handles): the
        snapshot reads every scope value. With ``background`` the write
        happens off-thread; ``wait=True`` forces a synchronous save
        (interrupt/final checkpoints must hit disk before exit)."""
        from .. import profiler

        extra = {"pass_id": int(pass_id), "iteration": int(iteration),
                 "samples_seen": int(samples_seen), "reason": reason}
        background = self.config.background and not wait
        with profiler.timer("ckpt/stall"):
            # joining a still-running previous write IS step-loop stall
            self.wait()  # also surfaces background errors
            # the scope's tensors are the state as of ``step``: the port's
            # ops never write into their inputs, so no later step can
            # change them; the snapshot copies them to the host and is
            # complete when it returns
            snap = _HostSnapshot(self.scope)
            if background:
                self._thread = threading.Thread(
                    target=self._write_guarded, args=(snap, step, extra),
                    name="paddle-tpu-torch-ckpt", daemon=True)
                self._thread.start()
            else:
                self._write(snap, step, extra)
        profiler.global_stat.add_count("ckpt/saves", 1)
        self.last_saved_step = int(step)

    def _write(self, snap: _HostSnapshot, step: int, extra: dict) -> None:
        from .. import checkpoint as ckpt_mod

        payload = ckpt_mod.save_checkpoint(
            self.config.dirname, scope=snap, step=step,
            max_keep=self.config.keep, extra=extra)
        plan = active_plan()
        if plan is not None \
                and plan.fire("torn_checkpoint", step) is not None:
            _tear(payload)
        self.last_bytes = os.path.getsize(payload)

    def _write_guarded(self, snap, step, extra) -> None:
        try:
            self._write(snap, step, extra)
        except BaseException as exc:  # noqa: BLE001 - re-raised on wait()
            self._error = exc

    def wait(self) -> None:
        """Join an in-flight background write; re-raises its error."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def join_quietly(self) -> None:
        """Join without raising — the exception-path cleanup, where a
        background-write failure must not mask the original error."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None

    def close(self) -> None:
        self.wait()


def _tear(payload: str) -> None:
    """Truncate a just-written checkpoint payload (torn-write fault)."""
    size = os.path.getsize(payload)
    with open(payload, "r+b") as f:
        f.truncate(max(size // 2, 1))


# ---------------------------------------------------------------------------
# Trainer run state
# ---------------------------------------------------------------------------
class TrainResilience:
    """One ``SGD.train()`` call's resilience state machine.

    The trainer calls, in order:

    - ``resume()`` once after param init (restores scope + position);
    - ``before_step()`` as each step enters the loop (fires ``crash`` /
      ``executor_error`` faults; the latter through the step retry);
    - ``after_step(...)`` as each step's results RESOLVE. In the sync
      loop it checkpoints inline and returns True on graceful interrupt;
      the async loop passes ``defer=True`` and, when ``pause_requested``,
      drains its window then calls ``commit()``: the scope already holds
      the state of every dispatched step, so the snapshot waits until
      every dispatched step has resolved;
    - ``finalize()`` after the pass loop (final checkpoint + join).
    """

    def __init__(self, config: Optional[CheckpointConfig], scope=None,
                 device=None):
        from ..flags import FLAGS

        self.config = config
        self.manager = (CheckpointManager(config, scope=scope, device=device)
                        if config is not None else None)
        plan = active_plan()
        if plan is None and FLAGS.fault_plan:
            plan = FaultPlan.parse(FLAGS.fault_plan)
        self.plan = plan
        self.flag = ShutdownFlag()
        self.step_retry = Retry(max_attempts=3, backoff=0.01,
                                name="trainer/step")
        self.dispatched = 0      # steps entered (dispatch order)
        self.completed = 0       # steps whose results resolved
        self.samples_seen = 0
        self.start_pass = 0
        self.skip_iterations = 0
        self.pause_requested = False
        self.interrupted = False
        self.resumed_meta: Optional[dict] = None
        self._last_pos = (0, -1)  # (pass_id, batch_id) last completed
        self._due_save = False    # latched: cadence hit, save not yet done

    # -- resume ------------------------------------------------------------
    def resume(self) -> Optional[dict]:
        if self.manager is None or not self.config.resume:
            return None
        meta = self.manager.resume()
        if meta is None:
            return None
        extra = meta.get("extra") or {}
        self.dispatched = self.completed = int(meta.get("step", 0))
        self.samples_seen = int(extra.get("samples_seen", 0))
        self.start_pass = int(extra.get("pass_id", 0))
        self.skip_iterations = int(extra.get("iteration", -1)) + 1
        self._last_pos = (self.start_pass, self.skip_iterations - 1)
        self.resumed_meta = meta
        return meta

    def skip_for_pass(self, pass_id: int) -> int:
        """Batches of ``pass_id`` already consumed before the
        interrupt."""
        if pass_id != self.start_pass or self.skip_iterations <= 0:
            return 0
        return self.skip_iterations

    def signal_context(self) -> Iterator[ShutdownFlag]:
        if self.config is not None and self.config.install_signal_handlers:
            return graceful_shutdown(flag=self.flag)
        return contextlib.nullcontext(self.flag)

    # -- step hooks --------------------------------------------------------
    def before_step(self) -> None:
        step = self.dispatched + 1
        if self.plan is not None:
            if self.plan.fire("crash", step) is not None:
                raise SimulatedCrash(
                    f"fault plan: hard crash before step {step}")

            def _maybe_transient():
                if self.plan.fire("executor_error", step) is not None:
                    raise TransientFault(
                        f"fault plan: transient executor error at step "
                        f"{step}")

            self.step_retry.call(_maybe_transient)
        self.dispatched += 1

    def after_step(self, pass_id: int, batch_id: int,
                   batch_size: Optional[int], defer: bool = False) -> bool:
        self.completed += 1
        if batch_size:
            self.samples_seen += int(batch_size)
        self._last_pos = (pass_id, batch_id)
        if self.plan is not None \
                and self.plan.fire("preempt", self.completed) is not None:
            self.flag.set(reason="fault-plan preemption")
        if self.manager is not None and self.manager.due(self.completed):
            # latched: the async loop drains PAST the cadence boundary
            # before it can save, so the due-ness must survive the drain
            self._due_save = True
        stop = self.flag.is_set()
        if not (self._due_save or stop):
            return False
        if defer:
            self.pause_requested = True
            return stop
        return self.commit(pass_id)

    def commit(self, pass_id: int) -> bool:  # noqa: ARG002 - symmetry
        """At a drained safe point: checkpoint if due / on interrupt;
        returns True when the loop must stop."""
        self.pause_requested = False
        stop = self.flag.is_set()
        if self.manager is not None:
            if stop and self.config.save_on_interrupt:
                self._save(reason="interrupt", wait=True)
                self._due_save = False
            elif self._due_save:
                self._save(reason="periodic")
                self._due_save = False
        if stop:
            self.interrupted = True
        return stop

    def _save(self, reason: str, wait: bool = False) -> None:
        p, b = self._last_pos
        self.manager.save(self.completed, pass_id=p, iteration=b,
                          samples_seen=self.samples_seen, reason=reason,
                          wait=wait)

    def finalize(self) -> None:
        if self.manager is None:
            return
        if (self.config.save_final and not self.interrupted
                and self.completed > 0
                and self.completed != self.manager.last_saved_step):
            self._save(reason="final", wait=True)
        self.manager.close()

    def abort(self) -> None:
        """Exception-path cleanup: join (never start) writes so no
        background thread keeps mutating the checkpoint dir after the
        crash propagates."""
        if self.manager is not None:
            self.manager.join_quietly()
