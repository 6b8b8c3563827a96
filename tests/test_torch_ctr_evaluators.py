"""The CTR and ranking metric ops and evaluators of the port against the
JAX package's, on the same numpy inputs from a seed.

- ``confusion_counts``, ``auc_histogram`` and ``positive_negative_pair``
  are counts and equal JAX's exactly (dtype too); ``precision_recall``'s
  per-class ratios are bit for bit; its macro means, ``rank_auc``,
  ``pnpair_counts`` and ``auc`` sum f32 terms in another order and hold
  at OP_RTOL.
- ``PrecisionRecall``, ``Auc``, ``RankAuc`` and ``Pnpair`` built into
  programs of both packages, run over the same batches: their states
  equal JAX's (the counts exactly, the f32 sums at OP_RTOL), ``eval``
  agrees, ``reset`` zeroes them, and the classes' signatures are JAX's.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op as torch_op

torch.set_num_threads(1)
OP_RTOL = 2e-6
COUNTS = ("confusion_counts", "auc_histogram", "positive_negative_pair")


def _inputs(op, seed):
    rng = np.random.RandomState(seed)
    b, L = 6, 9
    if op in ("confusion_counts", "precision_recall"):
        n = 5
        pred = {0: rng.rand(40, n).astype(np.float32),
                1: rng.randint(0, n, (40, 1)).astype(np.int64),
                2: rng.rand(40, 1).astype(np.float32)}[seed % 3]
        label = rng.randint(0, n if seed % 3 != 2 else 2, (40, 1))
        label[0] = n + 1  # a label out of range counts nowhere
        return {"num_classes": n}, {"Pred": pred,
                                    "Label": label.astype(np.int64)}
    if op in ("auc_histogram", "auc"):
        score = rng.rand(64, 2 if seed % 2 else 1).astype(np.float32)
        score[0, -1] = 1.0  # the top bucket's edge
        label = (rng.rand(64, 1) < 0.4).astype(np.float32)
        slot = "Score" if op == "auc_histogram" else "Out"
        return {"num_thresholds": 50}, {slot: score, "Label": label}
    if op in ("rank_auc", "pnpair_counts"):
        # scores on a coarse grid, so ties occur
        score = (rng.randint(0, 6, (b, L)) / 5.0).astype(np.float32)
        ins = {"Score": score, "Length": rng.randint(2, L + 1, b).astype(
            np.int64)}
        if op == "rank_auc":
            pv = rng.randint(1, 4, (b, L)).astype(np.float32)
            ins["Click"] = np.minimum(rng.randint(0, 3, (b, L)),
                                      pv).astype(np.float32)
            ins["Pv"] = pv
        else:
            ins["Label"] = rng.randint(0, 3, (b, L)).astype(np.float32)
            ins["Weight"] = rng.rand(b, L).astype(np.float32)
        return {}, ins
    score = (rng.randint(0, 5, 30) / 4.0).astype(np.float32)
    return {}, {"Score": score,
                "Label": rng.randint(0, 3, 30).astype(np.float32),
                "QueryID": rng.randint(0, 4, 30).astype(np.int64)}


OPS = ("confusion_counts", "auc_histogram", "rank_auc", "pnpair_counts",
       "precision_recall", "auc", "positive_negative_pair")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", OPS)
def test_metric_op_matches_jax(op, seed):
    attrs, ins = _inputs(op, seed)
    want = jax_op(op).fn(attrs, {k: [jnp.asarray(v)] for k, v in ins.items()})
    got = torch_op(op).fn(attrs, {k: [torch.from_numpy(v)]
                                  for k, v in ins.items()})
    assert sorted(got) == sorted(want)
    for slot in want:
        w, g = np.asarray(want[slot][0]), got[slot][0].numpy()
        assert g.shape == w.shape, slot
        assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)
        if op in COUNTS or slot in ("ClassPrecision", "ClassRecall"):
            np.testing.assert_array_equal(g, w, err_msg=slot)
        else:
            np.testing.assert_allclose(g, w, rtol=OP_RTOL, atol=1e-7,
                                       err_msg=slot)


def _eval_program(pt):
    """The four evaluators over one batch of CTR-like scores, labels and
    [b, L] query rows."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        prob = pt.layers.data("prob", shape=[1])
        label = pt.layers.data("label", shape=[1])
        cls = pt.layers.data("cls", shape=[4])
        cls_label = pt.layers.data("cls_label", shape=[1], dtype="int64")
        qscore = pt.layers.data("qscore", shape=[7])
        qclick = pt.layers.data("qclick", shape=[7])
        qlen = pt.layers.data("qlen", shape=[], dtype="int64")
        kw = dict(main_program=main, startup_program=startup)
        evs = [pt.evaluator.Auc(prob, label, num_thresholds=64, **kw),
               pt.evaluator.PrecisionRecall(cls, cls_label, 4, **kw),
               pt.evaluator.RankAuc(qscore, qclick, length=qlen, **kw),
               pt.evaluator.Pnpair(qscore, qclick, length=qlen, **kw)]
    return main, startup, evs


def _feed(rng):
    b = 32
    return {"prob": rng.rand(b, 1).astype(np.float32),
            "label": (rng.rand(b, 1) < 0.3).astype(np.float32),
            "cls": rng.rand(b, 4).astype(np.float32),
            "cls_label": rng.randint(0, 4, (b, 1)).astype(np.int64),
            "qscore": (rng.randint(0, 8, (b, 7)) / 7.0).astype(np.float32),
            "qclick": rng.randint(0, 2, (b, 7)).astype(np.float32),
            "qlen": rng.randint(1, 8, b).astype(np.int64)}


def test_evaluators_match_jax():
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        built.append(_eval_program(pt))
    (jm, js, jevs), (tm, ts, tevs) = built
    assert [op.type for op in tm.global_block.ops] == [
        op.type for op in jm.global_block.ops]
    jscope, tscope = jpt.Scope(), tpt.Scope()
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    rng = np.random.RandomState(0)
    for _ in range(3):
        feed = _feed(rng)
        jexe.run(jm, feed=feed, scope=jscope)
        texe.run(tm, feed=feed, scope=tscope)
    for jev, tev in zip(jevs, tevs):
        for jv, tv in zip(jev.states, tev.states):
            got, want = tscope.get_numpy(tv.name), np.asarray(
                jscope.get(jv.name))
            assert tv.name == jv.name and got.dtype == want.dtype
            if got.dtype == np.int32:
                np.testing.assert_array_equal(got, want, err_msg=tv.name)
            else:
                np.testing.assert_allclose(got, want, rtol=OP_RTOL,
                                           err_msg=tv.name)
        np.testing.assert_allclose(tev.eval(texe, tscope),
                                   jev.eval(jexe, jscope), rtol=OP_RTOL)
    assert 0.0 < tevs[0].eval(texe, tscope) < 1.0
    np.testing.assert_allclose(tevs[3].counts(tscope),
                               jevs[3].counts(jscope), rtol=OP_RTOL)
    for ev in tevs:
        ev.reset(texe, tscope)
        assert all(not tscope.get_numpy(v.name).any() for v in ev.states)
    assert tevs[0].eval(texe, tscope) == 0.5  # no positives or negatives


@pytest.mark.parametrize("cls", ["PrecisionRecall", "Auc", "RankAuc",
                                 "Pnpair"])
def test_evaluator_signatures(cls):
    for method in ("__init__", "reset", "eval"):
        want = inspect.signature(getattr(getattr(jpt.evaluator, cls),
                                         method))
        got = inspect.signature(getattr(getattr(tpt.evaluator, cls), method))
        assert got == want, (cls, method)
