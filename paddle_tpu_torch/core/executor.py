"""Executor: runs a program block op by op, eagerly, on one device.

Counterpart of ``paddle_tpu/core/executor.py``. The JAX package traces a
whole block into one jitted XLA computation; the port interprets it, the
counterpart of the reference's per-op interpreter ``_run_interpreted``:
feeds, then scope reads, then ops, then the write-back of persistable
state, then fetches. There is no jit, mesh, buffer donation or compile
cache. Kernels queue on the device's stream as the interpreter reaches
them, so ``run_async`` is ``run`` without the host sync: it returns a
``RunHandle`` of device tensors, and nothing reads them on the host
until ``result()``.

``check_nan_inf`` (``FLAGS.check_nan_inf`` by default; the reference's
executor.cc:25) scans the written-back state, in the order the block
first writes it, and then the fetches for NaN/Inf, and raises
``FloatingPointError`` naming the first bad variable, as the JAX
executor does: ``run`` before that variable goes back to the scope;
``run_async`` counts the non-finite values on the device at dispatch and
raises at ``result()``.

What the interpreter does in place of XLA's whole-program view:

- **One forward per step.** A forward op whose generic ``grad`` op comes
  later in the block (``backward.VJP_KEY``) runs once under autograd;
  its vjp closure waits for the grad op, which consumes it. The JAX
  package recomputes the forward inside ``jax.vjp`` and lets XLA merge
  the two; eagerly that would run every such op twice.
- **Recompute segments.** A ``seg_fwd`` op whose ``grad_seg`` comes
  later keeps its residuals in a ``SegmentStash`` that lives in the run
  alone; the ``grad_seg`` op consumes and frees it. So neither ``run``
  nor ``run_async`` keeps a segment's residuals past the step.
- **Liveness.** An intermediate is dropped after its last reader, or as
  soon as it is written where nothing reads it, as XLA frees a buffer,
  unless it is fetched or persistable.
- **Row-sparse gradients.** A sparse embedding's gradient is a
  ``SelectedRows`` value in the run's environment, passed on to the
  ``sum``, clip and optimizer ops that keep it sparse; it is fetched
  dense, and ``check_nan_inf`` scans its values.
- **No aliasing.** Op functions return new tensors and never write into
  their inputs, so ``assign`` may hand on the same tensor and a ``@PRE``
  snapshot can never see a later write. The one exception is the update
  ops' row rule for a ``SelectedRows`` gradient, which writes the
  touched rows into the parameter and its moments in place (the JAX
  executor donates them) and runs after every reader of their old
  values.

Randomness is the JAX package's scope key: the first run that draws
seeds ``prng_key(program.random_seed)`` (``FLAGS.seed`` when the program
sets none) under ``RNG_VAR`` in the scope, and every op that draws splits
it in program order, ``rng, sub = split(rng)``, and draws from ``sub``
(``core/prng.py``, bit-exact with ``jax.random``); the advanced key goes
back to the scope after the run. So startup values and dropout masks
equal the JAX executor's for the same seed.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import prng
from . import program as prog_mod
from .backward import (VJP_KEY, SegmentStash, apply_vjp, forward_with_vjp,
                       segment_forward, segment_grad)
from .enforce import EnforceError, op_error
from .program import RNG_VAR, Program
from .registry import get_op, op_uses_rng
from .scope import Scope, global_scope
from .selected_rows import SelectedRows, densify
from .types import to_numpy


class CUDAPlace:
    """The CUDA device ``device_id``: the port's default place."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass CPUPlace() to run the plain versions of "
                "the kernels")
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


class CPUPlace:
    """The host CPU, where every kernel runs its plain version."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace()"


def _is_float(value) -> bool:
    if isinstance(value, SelectedRows):
        value = value.values
    return isinstance(value, torch.Tensor) and value.is_floating_point()


def _raise_nonfinite(name: str, n_nan: int, n_inf: int) -> None:
    raise FloatingPointError(
        f"variable {name!r} contains NaN/Inf "
        f"({n_nan} NaN, {n_inf} Inf)")


def _device_counts(value) -> torch.Tensor:
    """[n_nan, n_inf] of a float tensor (a SelectedRows' values), on its
    device (no host sync)."""
    if isinstance(value, SelectedRows):
        value = value.values
    return torch.stack([value.isnan().sum(), value.isinf().sum()])


def _check_nan_inf(name: str, value) -> None:
    if _is_float(value):
        n_nan, n_inf = _device_counts(value).tolist()
        if n_nan or n_inf:
            _raise_nonfinite(name, n_nan, n_inf)


class RunHandle:
    """Deferred result of :meth:`Executor.run_async`.

    Holds the fetches as device tensors (their kernels may still be
    queued) and, for a deferred ``check_nan_inf``, one [n_nan, n_inf]
    count tensor per written-back float state, computed on the device at
    dispatch. The scope write-back happened at dispatch, so consecutive
    dispatches chain on the device. Nothing touches the host until
    :meth:`result` / :meth:`numpy`.
    """

    __slots__ = ("fetch_names", "_fetches", "_state_checks", "_check",
                 "_start", "_done", "_checked")

    def __init__(self, fetches, fetch_names, state_checks=(),
                 check_nan_inf=False, start=None):
        self._fetches = list(fetches)
        self.fetch_names = list(fetch_names)
        self._state_checks = list(state_checks)
        self._check = check_nan_inf
        self._checked = False
        self._start = start
        self._done = None
        devices = {v.device for v in self._fetches
                   if isinstance(v, torch.Tensor)}
        cuda = [d for d in devices if d.type == "cuda"]
        if cuda:  # marks the end of everything queued so far
            self._done = torch.cuda.Event(enable_timing=start is not None)
            self._done.record(torch.cuda.current_stream(cuda[0]))

    def done(self) -> bool:
        """Non-blocking readiness poll (True for host-resident values)."""
        return self._done is None or self._done.query()

    def block(self) -> "RunHandle":
        """Wait for the device to finish the run, without copying."""
        if self._done is not None:
            self._done.synchronize()
        return self

    def device_seconds(self) -> Optional[float]:
        """The run's span on its CUDA stream, in seconds: from an event
        recorded at dispatch, which the stream reaches once the work
        queued before the run is done, to the event after the run's last
        kernel. Where the host launched the run's kernels slower than the
        device ran them, the span holds those gaps too. Waits for the
        run; None for a run on the host."""
        if self._start is None or self._done is None:
            return None
        self._done.synchronize()
        return self._start.elapsed_time(self._done) / 1e3

    def result(self, return_numpy: bool = True):
        """Resolve the run: applies the deferred ``check_nan_inf`` scan
        (written-back state first, then the fetches) and returns the
        fetch list, numpy by default (bf16 as f32, ``types.to_numpy``),
        device tensors with ``return_numpy=False``."""
        if self._check and not self._checked:
            for name, counts in self._state_checks:
                n_nan, n_inf = counts.tolist()
                if n_nan or n_inf:
                    _raise_nonfinite(name, n_nan, n_inf)
            for name, val in zip(self.fetch_names, self._fetches):
                _check_nan_inf(name, val)
            self._checked = True
            self._state_checks = []
        if return_numpy:
            return [to_numpy(v) for v in self._fetches]
        return list(self._fetches)

    def numpy(self):
        return self.result(return_numpy=True)

    def __repr__(self):
        state = "done" if self.done() else "in-flight"
        return f"RunHandle({self.fetch_names}, {state})"


class _Plan:
    """What a run of one program version needs to know about its block:
    the generic grad op of each ``_vjp_key``, the recompute segments
    whose ``grad_seg`` follows, and each name's last reader."""

    def __init__(self, block):
        self.grad_of: Dict[str, Any] = {}
        self.seg_grads: set = set()
        self.last_read: Dict[str, int] = {}
        for i, op in enumerate(block.ops):
            key = op.attrs.get(VJP_KEY)
            if op.type == "grad" and key is not None:
                self.grad_of[key] = op
            if op.type == "grad_seg":
                self.seg_grads.add(op.attrs["vjp_key"])
            for name in op.input_names():
                self.last_read[name] = i


class Executor:
    """Runs programs on ``place`` (``CUDAPlace(0)`` by default; without
    CUDA that raises). ``check_nan_inf`` defaults to
    ``FLAGS.check_nan_inf``."""

    def __init__(self, place=None, check_nan_inf: Optional[bool] = None):
        from ..flags import FLAGS

        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self.check_nan_inf = (FLAGS.check_nan_inf if check_nan_inf is None
                              else bool(check_nan_inf))
        self._plans: Dict[int, tuple] = {}

    def _plan(self, program: Program) -> _Plan:
        cached = self._plans.get(id(program))
        if cached is not None and cached[0] is program \
                and cached[1] == program.version:
            return cached[2]
        plan = _Plan(program.global_block)
        self._plans[id(program)] = (program, program.version, plan)
        return plan

    def _rng_state(self, program: Program, scope: Scope):
        """The scope key, seeded on first use from the program's
        ``random_seed`` or else ``FLAGS.seed``."""
        if not scope.has(RNG_VAR):
            from ..flags import FLAGS

            seed = (program.random_seed if program.random_seed is not None
                    else FLAGS.seed)
            scope.set(RNG_VAR, prng.prng_key(int(seed), device=self.device))
        return scope.get(RNG_VAR)

    def _normalize_feeds(self, block, feed: Dict[str, Any]):
        """Feeds as tensors on the run's device, in their variable's
        dtype."""
        vals = {}
        for name, value in feed.items():
            dtype = block.var(name).dtype if block.has_var(name) else None
            if isinstance(value, torch.Tensor):
                vals[name] = value.to(device=self.device, dtype=dtype)
            else:
                arr = np.asarray(value)
                t = torch.from_numpy(np.ascontiguousarray(arr))
                vals[name] = t.to(device=self.device, dtype=dtype)
        return vals

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True):
        """Run ``program``'s global block: ``feed`` maps data variable
        names to arrays or tensors; returns the ``fetch_list`` values
        (numpy arrays unless ``return_numpy`` is False; a bfloat16 value
        comes back as float32, ``types.to_numpy``). Persistable
        state comes from and goes back to ``scope``."""
        fetch_names = _fetch_names(fetch_list)
        fetches, _ = self._execute(program, feed, fetch_names, scope,
                                   check="sync" if self.check_nan_inf
                                   else None)
        if self.check_nan_inf:
            for name, val in zip(fetch_names, fetches):
                _check_nan_inf(name, val)
        if return_numpy:
            return [to_numpy(v) for v in fetches]
        return fetches

    def run_async(self, program: Optional[Program] = None,
                  feed: Optional[Dict[str, Any]] = None,
                  fetch_list: Optional[Sequence] = None,
                  scope: Optional[Scope] = None) -> RunHandle:
        """Dispatch a run without any host synchronisation and return a
        :class:`RunHandle` of device tensors. The interpreter is
        ``run``'s: its kernels are queued on the device's stream, the
        updated state goes back to the scope as device tensors (so the
        next dispatch chains on the device), and ``check_nan_inf``
        counts non-finite values on the device, raising at
        ``handle.result()``."""
        fetch_names = _fetch_names(fetch_list)
        start = None
        if self.device.type == "cuda":  # the start of the run's span
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
        fetches, checks = self._execute(
            program, feed, fetch_names, scope,
            check="deferred" if self.check_nan_inf else None)
        return RunHandle(fetches, fetch_names, state_checks=checks,
                         check_nan_inf=self.check_nan_inf, start=start)

    def _execute(self, program, feed, fetch_names, scope, check=None
                 ) -> Tuple[List[Any], List[tuple]]:
        """The interpreter: returns (fetches as tensors, [(state name,
        [n_nan, n_inf] on the device)] with ``check="deferred"``). With
        ``check="sync"`` a non-finite written-back state raises before it
        goes back to the scope (the JAX executor's order)."""
        program = program or prog_mod.default_main_program()
        scope = scope or global_scope()
        block = program.global_block
        plan = self._plan(program)
        env: Dict[str, Any] = self._normalize_feeds(block, feed or {})
        keep = set(fetch_names)
        keep.update(n for n, v in block.vars.items() if v.persistable)
        state_read: set = set()
        vjps: Dict[str, tuple] = {}
        rng = None
        uses_rng = any(op_uses_rng(get_op(op.type), op.attrs)
                       for op in block.ops)
        if uses_rng:
            rng = self._rng_state(program, scope)
        checks: List[tuple] = []
        with torch.no_grad():
            for index, op in enumerate(block.ops):
                opdef = get_op(op.type)
                ins = {}
                for slot, names in op.inputs.items():
                    if not names:
                        continue
                    vals = []
                    for name in names:
                        if name not in env:
                            if not scope.has(name):
                                raise RuntimeError(
                                    f"op {op.type!r} input {slot}={name!r} "
                                    "is neither a feed, produced by a prior "
                                    "op, nor present in the scope. Did you "
                                    "forget to run the startup program?")
                            state_read.add(name)
                            env[name] = scope.get(name)
                        vals.append(env[name])
                    ins[slot] = vals
                sub = None
                if op_uses_rng(opdef, op.attrs):
                    rng, sub = prng.split(rng)
                try:
                    outs = self._run_op(op, opdef, ins, plan, vjps, sub)
                except EnforceError:
                    raise
                except Exception as exc:
                    raise op_error(op, index, ins, exc) from exc
                for slot, names in op.outputs.items():
                    for name, val in zip(names, (outs or {}).get(slot, [])):
                        if plan.last_read.get(name, -1) > index \
                                or name in keep or name in state_read:
                            env[name] = val
                        else:  # nothing reads this value
                            env.pop(name, None)
                for name in op.input_names():
                    if plan.last_read.get(name) == index and name not in keep \
                            and name not in state_read:
                        env.pop(name, None)
            if uses_rng:
                scope.set(RNG_VAR, rng)
            # write-back: persistable outputs and state read from the
            # scope, in the order the block first writes them
            written = dict.fromkeys(
                name for op in block.ops for name in op.output_names()
                if name in env and (name in state_read or (
                    block.has_var(name) and block.var(name).persistable)))
            for name in written:
                val = env[name]
                if check == "sync":
                    _check_nan_inf(name, val)
                scope.set(name, val)
                if check == "deferred" and _is_float(val):
                    checks.append((name, _device_counts(val)))
            fetches = []
            for name in fetch_names:
                if name in env:  # a SelectedRows is fetched dense
                    fetches.append(densify(env[name]))
                elif scope.has(name):
                    fetches.append(scope.get(name))
                else:
                    raise RuntimeError(
                        f"fetch variable {name!r} is never produced")
        return fetches, checks

    def _run_op(self, op, opdef, ins, plan: _Plan, vjps, rng):
        if op.type == "seg_fwd":
            key = op.attrs["vjp_key"]
            if key not in plan.seg_grads:
                return segment_forward(op.attrs, ins)
            vjps[key] = SegmentStash()
            return segment_forward(op.attrs, ins, vjps[key])
        if op.type == "grad_seg":
            return segment_grad(vjps.pop(op.attrs["vjp_key"]), op.attrs, ins)
        key = op.attrs.get(VJP_KEY)
        if op.type == "grad" and key in vjps:
            return apply_vjp(vjps.pop(key), op.attrs, ins)
        grad_op = plan.grad_of.get(key) if op.type != "grad" else None
        if grad_op is not None:
            outs, vjps[key] = forward_with_vjp(opdef, op.attrs, ins,
                                               grad_op.attrs["diff"])
            return outs
        if op_uses_rng(opdef, op.attrs):
            with torch.device(self.device):
                return opdef.fn(op.attrs, ins, rng=rng)
        if callable(opdef.needs_rng):
            return opdef.fn(op.attrs, ins, rng=None)
        if not ins:  # creation ops make their outputs on the run's device
            with torch.device(self.device):
                return opdef.fn(op.attrs, ins)
        return opdef.fn(op.attrs, ins)


def _fetch_names(fetch_list) -> List[str]:
    return [f.name if hasattr(f, "name") else str(f)
            for f in (fetch_list or [])]
