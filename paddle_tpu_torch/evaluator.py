"""Evaluators: metric accumulation across batches, built into the program.

Counterpart of ``paddle_tpu/evaluator.py``, cut to ``Evaluator``,
``Accuracy``, ``ChunkEvaluator`` and the CTR and ranking evaluators
``PrecisionRecall``, ``Auc``, ``RankAuc`` and ``Pnpair``. A metric's
state is a set of persistable variables (int32 counts, or f32 sums for
``RankAuc`` and ``Pnpair``), zeroed by the startup program; the update
ops appended to the main program add each batch's counts into them,
and the executor writes them back to the scope after every run, on the
run's device, as it does the optimizer's state. ``eval(exe, scope)``
reads them to the host and combines them; ``reset(exe, scope)`` zeroes
them on the device where they live.

The counts are int32, as the JAX package declares them: a count that
comes out of an op as int64 (the port keeps the reference's int64 where
JAX without x64 narrows it) is cast to the state's dtype before it is
added, so the state keeps its dtype across runs.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import dtype_name, to_dtype
from .initializer import ConstantInitializer
from .layers.layer_helper import LayerHelper

__all__ = ["Evaluator", "Accuracy", "ChunkEvaluator", "PrecisionRecall",
           "Auc", "RankAuc", "Pnpair"]


class Evaluator:
    """Base: manages the state variables (created in both programs) and
    ``reset``/``eval``, as fluid's evaluator.Evaluator does."""

    def __init__(self, name, main_program=None, startup_program=None):
        self.helper = LayerHelper(name, main_program=main_program,
                                  startup_program=startup_program)
        self.states = []

    def _create_state(self, suffix, shape, dtype="int32"):
        main = self.helper.main_program
        name = main.unique_name(f"{self.helper.layer_type}.{suffix}")
        v = main.global_block.create_var(
            name=name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True)
        sb = self.helper.startup_program.global_block
        sv = sb.create_var(name=name, shape=shape, dtype=dtype,
                           persistable=True)
        ConstantInitializer(0)(sv, sb)
        self.states.append(v)
        return v

    def reset(self, executor, scope=None):
        """Zero every state: on the device of the value the scope holds,
        else on the executor's."""
        from .core.scope import global_scope

        scope = scope or global_scope()
        for v in self.states:
            device = (scope.get(v.name).device if scope.has(v.name)
                      else executor.device)
            shape = tuple(d for d in v.shape if d != -1)
            scope.set(v.name, torch.zeros(shape, dtype=to_dtype(v.dtype),
                                          device=device))

    def eval(self, executor, scope=None):
        raise NotImplementedError

    def _fetch_states(self, scope):
        from .core.scope import global_scope

        scope = scope or global_scope()
        return [scope.get_numpy(v.name) for v in self.states]

    def _accumulate(self, state_var, increment):
        """state += increment, written back to the same scope name."""
        if increment.dtype != state_var.dtype:
            increment = self.helper.simple_op(
                "cast", {"X": [increment]},
                {"dtype": dtype_name(state_var.dtype)})
        self.helper.append_op(
            "elementwise_add", {"X": [state_var], "Y": [increment]},
            {"Out": [state_var]}, {})


class Accuracy(Evaluator):
    """Streaming top-k accuracy (fluid evaluator.Accuracy; legacy
    classification_error_evaluator)."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy_eval", **kwargs)
        self.total = self._create_state("total", [], "int32")
        self.correct = self._create_state("correct", [], "int32")
        from . import layers

        main = self.helper.main_program
        startup = self.helper.startup_program
        topk_out, topk_idx = layers.topk(input, k=k, main_program=main,
                                         startup_program=startup)
        outs, _ = self.helper.append_op(
            "accuracy",
            {"Out": [topk_out], "Indices": [topk_idx], "Label": [label]},
            ["Accuracy", "Correct", "Total"])
        self.batch_acc = outs["Accuracy"][0]
        corr = self.helper.simple_op(
            "cast", {"X": [outs["Correct"][0]]}, {"dtype": "int32"})
        tot = self.helper.simple_op(
            "cast", {"X": [outs["Total"][0]]}, {"dtype": "int32"})
        self._accumulate(self.correct, corr)
        self._accumulate(self.total, tot)

    def eval(self, executor, scope=None):
        total, correct = self._fetch_states(scope)
        return float(correct) / max(float(total), 1.0)


class ChunkEvaluator(Evaluator):
    """Streaming chunk F1 (fluid ChunkEvaluator / legacy chunk
    evaluator). eval() returns (precision, recall, f1)."""

    def __init__(self, input, label, chunk_scheme="IOB", num_chunk_types=1,
                 **kwargs):
        super().__init__("chunk_eval_streaming", **kwargs)
        self.n_infer = self._create_state("num_infer", [1], "int32")
        self.n_label = self._create_state("num_label", [1], "int32")
        self.n_correct = self._create_state("num_correct", [1], "int32")
        from . import layers

        main = self.helper.main_program
        startup = self.helper.startup_program
        _, _, _, ni, nl, nc = layers.chunk_eval(
            input, label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types, main_program=main,
            startup_program=startup)
        self._accumulate(self.n_infer, ni)
        self._accumulate(self.n_label, nl)
        self._accumulate(self.n_correct, nc)

    def eval(self, executor, scope=None):
        ni, nl, nc = self._fetch_states(scope)
        ni, nl, nc = float(ni[0]), float(nl[0]), float(nc[0])
        precision = nc / ni if ni else 0.0
        recall = nc / nl if nl else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return precision, recall, f1


class PrecisionRecall(Evaluator):
    """Multi-class streaming precision/recall/F1 from confusion counts
    (legacy precision_recall_evaluator). eval() returns the macro
    (precision, recall, f1)."""

    def __init__(self, input, label, num_classes, **kwargs):
        super().__init__("precision_recall", **kwargs)
        self.num_classes = num_classes
        self.tp = self._create_state("tp", [num_classes], "int32")
        self.fp = self._create_state("fp", [num_classes], "int32")
        self.fn = self._create_state("fn", [num_classes], "int32")
        outs, _ = self.helper.append_op(
            "confusion_counts", {"Pred": [input], "Label": [label]},
            ["TP", "FP", "FN"], {"num_classes": num_classes})
        self._accumulate(self.tp, outs["TP"][0])
        self._accumulate(self.fp, outs["FP"][0])
        self._accumulate(self.fn, outs["FN"][0])

    def eval(self, executor, scope=None):
        tp, fp, fn = [a.astype(np.float64) for a in
                      self._fetch_states(scope)]
        p = tp / np.maximum(tp + fp, 1)
        r = tp / np.maximum(tp + fn, 1)
        f1 = 2 * p * r / np.maximum(p + r, 1e-10)
        return float(p.mean()), float(r.mean()), float(f1.mean())


class Auc(Evaluator):
    """Streaming AUC from score histograms (legacy AucEvaluator): the
    positive-class scores in ``num_thresholds`` buckets; eval()
    integrates the ROC curve by the trapezoid rule."""

    def __init__(self, input, label, num_thresholds=200, **kwargs):
        super().__init__("auc", **kwargs)
        self.num_thresholds = num_thresholds
        self.pos = self._create_state("pos_hist", [num_thresholds], "int32")
        self.neg = self._create_state("neg_hist", [num_thresholds], "int32")
        outs, _ = self.helper.append_op(
            "auc_histogram", {"Score": [input], "Label": [label]},
            ["Pos", "Neg"], {"num_thresholds": num_thresholds})
        self._accumulate(self.pos, outs["Pos"][0])
        self._accumulate(self.neg, outs["Neg"][0])

    def eval(self, executor, scope=None):
        pos, neg = (a.astype(np.float64) for a in self._fetch_states(scope))
        # cumulated from the highest threshold down: the ROC curve
        tp = np.cumsum(pos[::-1])
        fp = np.cumsum(neg[::-1])
        if tp[-1] == 0 or fp[-1] == 0:
            return 0.5
        tpr = np.concatenate([[0.0], tp / tp[-1]])
        fpr = np.concatenate([[0.0], fp / fp[-1]])
        # np.trapezoid(tpr, fpr), written out (older numpy lacks the name)
        return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


class RankAuc(Evaluator):
    """Streaming per-query ranking AUC (legacy rankauc evaluator) over
    dense padded [b, L] query rows of ``score``/``click``/``pv`` with an
    optional ``length`` [b]. eval() returns the mean per-query AUC."""

    def __init__(self, score, click, pv=None, length=None, **kwargs):
        super().__init__("rank_auc_eval", **kwargs)
        self.auc_sum = self._create_state("auc_sum", [], "float32")
        self.queries = self._create_state("queries", [], "float32")
        ins = {"Score": [score], "Click": [click]}
        if pv is not None:
            ins["Pv"] = [pv]
        if length is not None:
            ins["Length"] = [length]
        outs, _ = self.helper.append_op(
            "rank_auc", ins, ["AucSum", "QueryCount"], {})
        self._accumulate(self.auc_sum, outs["AucSum"][0])
        self._accumulate(self.queries, outs["QueryCount"][0])

    def eval(self, executor, scope=None):
        s, n = self._fetch_states(scope)
        return float(s) / max(float(n), 1.0)


class Pnpair(Evaluator):
    """Streaming positive/negative pair counts for ranking (legacy pnpair
    evaluator). eval() returns pos / neg; ``counts()`` gives (pos, neg,
    special)."""

    def __init__(self, score, label, weight=None, length=None, **kwargs):
        super().__init__("pnpair_eval", **kwargs)
        self.pos = self._create_state("pos", [], "float32")
        self.neg = self._create_state("neg", [], "float32")
        self.spe = self._create_state("spe", [], "float32")
        ins = {"Score": [score], "Label": [label]}
        if weight is not None:
            ins["Weight"] = [weight]
        if length is not None:
            ins["Length"] = [length]
        outs, _ = self.helper.append_op(
            "pnpair_counts", ins, ["Pos", "Neg", "Spe"], {})
        self._accumulate(self.pos, outs["Pos"][0])
        self._accumulate(self.neg, outs["Neg"][0])
        self._accumulate(self.spe, outs["Spe"][0])

    def counts(self, scope=None):
        p, n, s = self._fetch_states(scope)
        return float(p), float(n), float(s)

    def eval(self, executor, scope=None):
        p, n, _ = self._fetch_states(scope)
        return float(p) / max(float(n), 1e-10)
