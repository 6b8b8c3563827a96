"""paddle_tpu_torch.transpiler: program-to-program rewriting passes.

Counterpart of ``paddle_tpu/transpiler``: a ``Pass`` base class, a
registry, a ``PassManager`` with per-pass wall time and op-count deltas
and IR dump hooks, and the pass library the inference pipeline runs::

    from paddle_tpu_torch import transpiler

    pm = transpiler.inference_pipeline()
    program = pm.run(program, feed_names, fetch_names, scope=scope)
    print(pm.format_stats())

``io.save_inference_model`` runs the inference pipeline by default, and
``serving.InferenceEngine`` re-runs it on load (a no-op on a transpiled
model); ``trainer.SGD(transpile=True)`` runs the training pipeline on
its program before ``minimize``. The memory-aware scheduling pass
(``reduce_peak``), the sharding pass and the deployment pipeline are
later pieces of the port: they raise, naming ``ROADMAP.md``.
"""
from __future__ import annotations

from typing import Optional

from .framework import (Pass, PassContext, PassManager, PassResult,
                        get_pass, ir_dump_hook, register_pass,
                        registered_passes)
from .passes import (CanonicalizeIsTest, ConstantFolding,
                     DeadOpElimination, DropoutToScale,
                     ExpandRecomputeSegments, FoldBatchNorm, FusePatterns)

__all__ = [
    "Pass", "PassContext", "PassManager", "PassResult", "register_pass",
    "get_pass", "registered_passes", "ir_dump_hook",
    "ExpandRecomputeSegments", "CanonicalizeIsTest", "DropoutToScale",
    "DeadOpElimination", "ConstantFolding", "FoldBatchNorm",
    "FusePatterns", "inference_pipeline", "prune_pipeline",
    "training_pipeline", "shard_program",
]


def _refuse_reduce_peak(reduce_peak):
    """``reduce_peak=None`` follows ``--reduce_peak_memory``, which the
    port does not define (off); asking for the pass raises."""
    if reduce_peak:
        raise NotImplementedError(
            "the memory-aware scheduling pass (reduce_peak / schedule.py) "
            "is not ported to paddle_tpu_torch; see ROADMAP.md Queue 1 "
            "item 9")


def prune_pipeline(for_test: bool = True, **pm_kw) -> PassManager:
    """The slice pipeline behind ``io.prune_program``: flatten recompute
    segments, (optionally) canonicalize ``is_test``, then dead-op
    elimination down to the fetch targets."""
    passes = [ExpandRecomputeSegments()]
    if for_test:
        passes.append(CanonicalizeIsTest())
    passes.append(DeadOpElimination())
    return PassManager(passes, **pm_kw)


def inference_pipeline(*, constant_fold: bool = True,
                       fold_batch_norm: bool = True,
                       fuse: bool = True,
                       epilogue: Optional[bool] = None,
                       reduce_peak: Optional[bool] = None,
                       **pm_kw) -> PassManager:
    """The deploy-time pipeline (``save_inference_model``'s default):
    flatten → is_test → DCE → dropout→scale → constant-fold → fused-kernel
    rewrites → BN folding → cleanup DCE. Fusion runs before BN folding,
    so under ``--fused_conv_epilogue`` (or ``epilogue=True``) 1x1 NHWC
    conv→BN chains become ``conv1x1_bn_act`` and folding takes only what
    fusion cannot (3x3 convs, fc+BN). Folding writes new names into the
    given scope: hand a child scope to keep the caller's unchanged."""
    _refuse_reduce_peak(reduce_peak)
    # DCE runs before the dropout rewrite: in a training program the
    # backward's grad ops read dropout's Mask, which is dead only once
    # the training slice is gone
    passes = [ExpandRecomputeSegments(), CanonicalizeIsTest(),
              DeadOpElimination(), DropoutToScale()]
    if constant_fold:
        passes.append(ConstantFolding())
    if fuse:
        passes.append(FusePatterns(epilogue=epilogue))
    if fold_batch_norm:
        passes.append(FoldBatchNorm())
    passes.append(DeadOpElimination())
    return PassManager(passes, **pm_kw)


def training_pipeline(*, epilogue: Optional[bool] = None,
                      **pm_kw) -> PassManager:
    """The build-time pipeline for training programs, run before
    ``append_backward``/``minimize`` (grad ops name the op list they were
    derived from; the fused replacements carry their own grad_fns):
    literal constant folding (parameters stay live: they change every
    step), then the fused-kernel pattern rewrites."""
    return PassManager([ConstantFolding(fold_params=False),
                        FusePatterns(epilogue=epilogue)], **pm_kw)


def shard_program(*args, **kwargs):
    """Not ported: the sharding plane comes with ``parallel``."""
    raise NotImplementedError(
        "shard_program (the one sharding plane) is not ported to "
        "paddle_tpu_torch; see ROADMAP.md Queue 1 item 10")
