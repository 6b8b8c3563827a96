"""The port's streaming evaluators against the JAX package's.

``Accuracy`` (top-1 and top-2) and ``ChunkEvaluator`` (IOB, 4 chunk
types and O, as conll05 tags) are built by each package into its own
program; three batches of the same numpy inputs run through both
executors, and after every batch the state counts equal JAX's exactly
and stay int32 (the port's ``chunk_eval`` counts are int64, cast before
they are added) and ``eval`` returns the same numbers (floats from the
same integer counts: equal). ``reset`` zeroes the states in both, on
the scope's device, and a fourth batch then counts alone.
"""
import numpy as np
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt

torch.set_num_threads(1)


def _accuracy_program(pt, k):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        scores = pt.layers.data("scores", shape=[6])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        ev = pt.evaluator.Accuracy(scores, label, k=k)
    return main, startup, ev


def _chunk_program(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        pred = pt.layers.data("pred", shape=[1], dtype="int64", lod_level=1)
        lab = pt.layers.data("lab", shape=[1], dtype="int64", lod_level=1)
        ev = pt.evaluator.ChunkEvaluator(pred, lab, num_chunk_types=4)
    return main, startup, ev


def _run_both(build, feeds):
    """Per batch, for JAX then the port: (the state values, eval)."""
    out, runs = [], []
    for pt, place in ((jpt, jpt.TPUPlace()), (tpt, tpt.CPUPlace())):
        main, startup, ev = build(pt)
        scope = pt.Scope()
        exe = pt.Executor(place)
        exe.run(startup, scope=scope)
        ev.reset(exe, scope)
        runs.append((main, ev, scope, exe))
    for i, feed in enumerate(feeds):
        row = []
        for main, ev, scope, exe in runs:
            if i == len(feeds) - 1:  # the last batch counts alone
                ev.reset(exe, scope)
            exe.run(main, feed=feed, fetch_list=[], scope=scope)
            row.append(([np.asarray(scope.get(v.name)) for v in ev.states],
                        ev.eval(exe, scope)))
        out.append(row)
    port_scope = runs[1][2]
    for v in runs[1][1].states:
        value = port_scope.get(v.name)
        assert value.dtype == torch.int32 and value.device.type == "cpu"
    return out


def _check(rows):
    for (jstates, jval), (tstates, tval) in rows:
        for j, t in zip(jstates, tstates):
            assert t.dtype == np.int32
            np.testing.assert_array_equal(t, j)
        assert tval == jval


def test_accuracy_streams_and_resets():
    rng = np.random.RandomState(0)
    feeds = [{"scores": rng.randn(8, 6).astype(np.float32),
              "label": rng.randint(0, 6, size=(8, 1)).astype(np.int64)}
             for _ in range(4)]
    for k in (1, 2):
        rows = _run_both(lambda pt: _accuracy_program(pt, k), feeds)
        _check(rows)
        want = np.mean([(np.argsort(-f["scores"], 1, kind="stable")[:, :k]
                         == f["label"]).any(1).mean() for f in feeds[:3]])
        np.testing.assert_allclose(rows[2][1][1], want, rtol=1e-12)
        assert rows[3][1][0][0] == 8  # the total after the reset


def test_chunk_evaluator_streams_and_resets():
    rng = np.random.RandomState(1)
    feeds = []
    for _ in range(4):
        lab = rng.randint(0, 9, size=(6, 10, 1)).astype(np.int64)
        pred = np.where(rng.rand(6, 10, 1) < 0.3,
                        rng.randint(0, 9, size=(6, 10, 1)), lab)
        lens = rng.randint(1, 11, size=6).astype(np.int32)
        feeds.append({"pred": pred.astype(np.int64), "pred@len": lens,
                      "lab": lab, "lab@len": lens})
    rows = _run_both(_chunk_program, feeds)
    _check(rows)
    p, r, f1 = rows[2][1][1]
    assert 0 < p <= 1 and 0 < r <= 1 and 0 < f1 <= 1
    ni, nl, nc = (int(s[0]) for s in rows[3][1][0])
    assert nc <= min(ni, nl) and nl > 0
