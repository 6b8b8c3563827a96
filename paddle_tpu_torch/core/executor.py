"""Executor: runs a program block op by op, eagerly, on one device.

Counterpart of ``paddle_tpu/core/executor.py``. The JAX package traces a
whole block into one jitted XLA computation; the port interprets it, the
counterpart of the reference's per-op interpreter ``_run_interpreted``:
feeds, then scope reads, then ops, then the write-back of persistable
state, then fetches. There is no jit, mesh, async dispatch, buffer
donation or compile cache.

What the interpreter does in place of XLA's whole-program view:

- **One forward per step.** A forward op whose generic ``grad`` op comes
  later in the block (``backward.VJP_KEY``) runs once under autograd;
  its vjp closure waits for the grad op, which consumes it. The JAX
  package recomputes the forward inside ``jax.vjp`` and lets XLA merge
  the two; eagerly that would run every such op twice.
- **Liveness.** An intermediate is dropped after its last reader, as XLA
  frees a buffer, unless it is fetched or persistable.
- **No aliasing.** Op functions return new tensors and never write into
  their inputs, so ``assign`` may hand on the same tensor and a ``@PRE``
  snapshot can never see a later write.

Randomness: ops that draw (startup's ``uniform_random``) draw in program
order from one ``torch.Generator`` on the run's device, seeded from
``program.random_seed`` (0 when unset) and kept in the scope. Its bits
differ from JAX's threefry: the RNG plane is a later slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from . import program as prog_mod
from .backward import VJP_KEY, apply_vjp, forward_with_vjp
from .enforce import EnforceError, op_error
from .program import RNG_VAR, Program
from .registry import get_op, op_uses_rng
from .scope import Scope, global_scope


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


class _Plan:
    """What a run of one program version needs to know about its block:
    the generic grad op of each ``_vjp_key`` and each name's last
    reader."""

    def __init__(self, block):
        self.grad_of: Dict[str, Any] = {}
        self.last_read: Dict[str, int] = {}
        for i, op in enumerate(block.ops):
            key = op.attrs.get(VJP_KEY)
            if op.type == "grad" and key is not None:
                self.grad_of[key] = op
            for name in op.input_names():
                self.last_read[name] = i


class Executor:
    """Runs programs on ``place`` (``CUDAPlace(0)`` by default; without
    CUDA that raises)."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self._plans: Dict[int, tuple] = {}

    def _plan(self, program: Program) -> _Plan:
        cached = self._plans.get(id(program))
        if cached is not None and cached[0] is program \
                and cached[1] == program.version:
            return cached[2]
        plan = _Plan(program.global_block)
        self._plans[id(program)] = (program, program.version, plan)
        return plan

    def _rng(self, program: Program, scope: Scope) -> torch.Generator:
        if not scope.has(RNG_VAR):
            seed = program.random_seed if program.random_seed is not None else 0
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            scope.set(RNG_VAR, gen)
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
        (numpy arrays unless ``return_numpy`` is False). Persistable
        state comes from and goes back to ``scope``."""
        program = program or prog_mod.default_main_program()
        scope = scope or global_scope()
        fetch_names = [f.name if hasattr(f, "name") else str(f)
                       for f in (fetch_list or [])]
        block = program.global_block
        plan = self._plan(program)
        env: Dict[str, Any] = self._normalize_feeds(block, feed or {})
        keep = set(fetch_names)
        keep.update(n for n, v in block.vars.items() if v.persistable)
        state_read: set = set()
        vjps: Dict[str, tuple] = {}
        rng = None
        if any(op_uses_rng(get_op(op.type), op.attrs) for op in block.ops):
            rng = self._rng(program, scope)
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
                try:
                    outs = self._run_op(op, opdef, ins, plan, vjps, rng)
                except EnforceError:
                    raise
                except Exception as exc:
                    raise op_error(op, index, ins, exc) from exc
                for slot, names in op.outputs.items():
                    for name, val in zip(names, (outs or {}).get(slot, [])):
                        env[name] = val
                for name in op.input_names():
                    if plan.last_read.get(name) == index and name not in keep \
                            and name not in state_read:
                        env.pop(name, None)
            # write-back: persistable outputs and state read from the scope
            for op in block.ops:
                for name in op.output_names():
                    if name not in env:
                        continue
                    persist = block.has_var(name) and block.var(name).persistable
                    if persist or name in state_read:
                        scope.set(name, env[name])
            fetches = []
            for name in fetch_names:
                if name in env:
                    fetches.append(env[name])
                elif scope.has(name):
                    fetches.append(scope.get(name))
                else:
                    raise RuntimeError(
                        f"fetch variable {name!r} is never produced")
        if return_numpy:
            return [v.detach().cpu().numpy() for v in fetches]
        return fetches

    def _run_op(self, op, opdef, ins, plan: _Plan, vjps, rng):
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
