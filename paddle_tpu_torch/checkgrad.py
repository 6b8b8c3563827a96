"""Gradient checking as a job of its own.

Counterpart of ``paddle_tpu/checkgrad.py``: the reference's
``--job=checkgrad`` trainer mode (TrainerMain.cpp:54, Trainer.cpp
checkGradient) and the OpTest numeric-gradient harness (op_test.py
get_numeric_gradient): the program's backward pass against central
finite differences, for every trainable parameter.

The check runs f32 products at full precision (``set_mxu_precision(
"highest")``) for its duration: the card's TF32 default carries ~1e-3
relative noise, which would swamp a 1e-4 finite-difference comparison.

Two things set what a probe can resolve. Rounding: a loss that is a
mean (the usual cost) is probed as the float64 mean of the tensor under
it, which drops the reductions' f32 roundings, so the probed loss moves
about a third of an f32 spacing from rounding instead of one or two.
Kinks: a probe whose +-delta reaches across a point where the loss is
not differentiable (a max pool or a ReLU changing its choice) measures
the mean of two slopes, not the derivative. Where the central difference
disagrees, the check also takes the loss at the unperturbed point; if
the two one-sided differences differ by more than the tolerance and by
more than ``_KINK_ULPS`` spacings of the loss over delta (a kink within
delta, not rounding), and the analytic gradient agrees with one of them
(the slope of the side that holds no kink), the element passes and is
listed in ``kinks``. A wrong gradient still fails: at a smooth point the
one-sided differences agree, and across a kink it must still match one
side's slope.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.backward import append_backward
from .core.program import GRAD_SUFFIX
from .ops import common as ops_common

# a kink must bend the loss by more than this many of its f32 spacings
# over one delta: rounding moves the probed loss by about a third of one
_KINK_ULPS = 2


def _ulp(x: float) -> float:
    return float(np.spacing(np.float32(abs(x))))


def check_gradients(program, feed: Dict[str, np.ndarray], loss,
                    scope=None, params: Optional[List[str]] = None,
                    delta: float = 1e-3, rtol: float = 1e-2,
                    atol: float = 1e-4, max_elements: int = 64,
                    startup_program=None,
                    executor=None, kinks: Optional[list] = None
                    ) -> List[Tuple[str, float]]:
    """Run the checkgrad job. Returns [(param_name, max_rel_error)] and
    raises AssertionError on the first parameter past the tolerance.
    A list passed as ``kinks`` receives the (param_name, index) of each
    probe that reached across a kink (module docstring).

    ``program`` must already hold the loss; the backward ops go into a
    clone, so the caller's program is untouched. At most
    ``max_elements`` randomly chosen elements per parameter are
    perturbed (the reference sweeps all). ``executor`` defaults to one
    on ``CUDAPlace(0)``."""
    import paddle_tpu_torch as pt

    scope = scope if scope is not None else pt.global_scope()
    exe = executor or pt.Executor()

    prog = program.clone()
    block = prog.global_block
    # drop everything after the op producing the loss: a program built by
    # Optimizer.minimize carries backward and update ops, and running
    # those during a probe would move the very weights being measured
    loss_idx = max(i for i, op in enumerate(block.ops)
                   if loss.name in op.output_names())
    del block.ops[loss_idx + 1:]
    # a mean loss (a mean of a mean ...) is probed as the float64 mean of
    # the tensor under it (module docstring)
    producer = {n: op for op in block.ops for n in op.output_names()}
    probed = loss.name
    while probed in producer and producer[probed].type == "mean":
        probed = producer[probed].input("X")
    # the stale @GRAD vars of that minimize() backward would make
    # append_backward rename its fresh gradients around them
    for name in [n for n in block.vars if GRAD_SUFFIX in n]:
        del block.vars[name]
    with pt.program_guard(prog, startup_program or pt.Program()):
        param_grads = append_backward(block.var(loss.name))
    if params is None:
        params = [p.name for p, _ in param_grads]
    grad_names = {p.name: g.name for p, g in param_grads}

    old_precision = ops_common._MXU_PRECISION
    ops_common.set_mxu_precision("highest")
    try:
        fetch = [loss.name] + [grad_names[p] for p in params]
        outs = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        analytic = dict(zip(params, outs[1:]))

        def loss_at() -> float:
            (lo,) = exe.run(prog, feed=feed, fetch_list=[probed],
                            scope=scope)
            lo = np.asarray(lo, np.float64)
            return float(lo.mean() if probed != loss.name else lo.sum())

        def scale(x: float, y: float) -> float:
            return max(abs(x), abs(y), atol / rtol)

        def rel_err(x: float, y: float) -> float:
            return abs(x - y) / scale(x, y)

        results = []
        kinks = kinks if kinks is not None else []
        base_loss = None  # the loss at the unperturbed point, on demand
        rng = np.random.RandomState(0)
        for pname in params:
            base_t = scope.get(pname)
            base = scope.get_numpy(pname).copy()
            flat = base.reshape(-1)
            n = flat.size
            idxs = (np.arange(n) if n <= max_elements
                    else rng.choice(n, size=max_elements, replace=False))
            worst = 0.0
            a = np.asarray(analytic[pname]).reshape(-1)
            for i in idxs:
                probes = []
                for sign in (+1, -1):
                    pert = flat.copy()
                    pert[i] += sign * delta
                    scope.set(pname, torch.from_numpy(
                        pert.reshape(base.shape)).to(base_t.device))
                    probes.append(loss_at())
                hi, lo = probes
                numeric = (hi - lo) / (2 * delta)
                err = rel_err(numeric, a[i])
                if err > rtol:
                    if base_loss is None:
                        scope.set(pname, base_t)
                        base_loss = loss_at()
                    ahead = (hi - base_loss) / delta
                    behind = (base_loss - lo) / delta
                    side = min(rel_err(ahead, a[i]), rel_err(behind, a[i]))
                    apart = abs(ahead - behind)
                    if (apart > rtol * scale(ahead, behind)
                            and apart * delta > _KINK_ULPS * _ulp(base_loss)
                            and side <= rtol):
                        kinks.append((pname, int(i)))
                        err = side
                worst = max(worst, err)
                if err > rtol:
                    scope.set(pname, base_t)
                    raise AssertionError(
                        f"gradient check FAILED for {pname}[{i}]: "
                        f"numeric={numeric:.6g} analytic={a[i]:.6g} "
                        f"rel_err={err:.3g} > {rtol}")
            scope.set(pname, base_t)
            results.append((pname, worst))
        return results
    finally:
        ops_common._MXU_PRECISION = old_precision
