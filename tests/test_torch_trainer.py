"""``SGD.train`` in the port against the JAX package's.

Two models, each built in both packages from the same startup seed (the
port's own startup draws the JAX startup's values, ``core/prng.py``) and
trained over the same batched reader through ``DataFeeder``:

- the MLP of ``tests/test_trainer.py`` (fc, softmax cross-entropy, an
  ``accuracy`` metric), SGD, 4 passes with a test reader: the same event
  sequence, every step's cost and metric, every pass summary and test
  result, and the final parameters, f32 at rtol 1e-5;
- a 2-layer per-layer transformer LM (V 97, T 16, d 32, 2 heads of 16,
  d_ff 64), SGD 0.5, one pass of 4 batches: every step's cost and the
  final parameters at rtol 1e-5 (atol 1e-7 for weights whose update is
  zero up to rounding).

Then the trainer's own contracts: the test program is cloned before
``minimize`` and leaves the parameters alone; ``save_params`` /
``load_params`` round-trip; the default log handler follows
``FLAGS.log_period``; what the port does not carry raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import event as jevent
from paddle_tpu import reader as jreader
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.trainer import SGD as TSGD

torch.set_num_threads(1)
RTOL = 1e-5
PKG = {"jax": (jpt, JSGD, jreader, jevent), "torch": (tpt, TSGD, treader,
                                                      tevent)}


def _toy_reader(n=64, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n, 8).astype("float32")
    w = rng.rand(8, 3)
    ys = np.argmax(xs @ w, axis=1).astype("int64")

    def r():
        for i in range(n):
            yield xs[i], ys[i:i + 1]
    return r


def _mlp(which, lr=0.5):
    pt, SGD, _, _ = PKG[which]
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[8])
        y = pt.layers.data("y", shape=[1], dtype="int64")
        logits = pt.layers.fc(x, size=3)
        cost = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits, y))
        acc = pt.layers.accuracy(logits, y)
        trainer = SGD(cost=cost,
                      optimizer=pt.optimizer.SGDOptimizer(learning_rate=lr),
                      feed_list=[x, y], place=pt.CPUPlace(),
                      scope=pt.Scope(), metrics={"acc": acc})
    return trainer, main


def _params(trainer, main):
    return [np.asarray(trainer.scope.get(p.name), dtype=np.float32)
            for p in main.all_parameters()]


def _events(events):
    """(kind, pass, batch, cost, metrics) of every event."""
    return [(type(e).__name__, getattr(e, "pass_id", None),
             getattr(e, "batch_id", None), getattr(e, "cost", None),
             getattr(e, "metrics", None)) for e in events]


def _assert_events_close(got, want):
    assert [g[:3] for g in got] == [w[:3] for w in want]
    for g, w in zip(got, want):
        if w[3] is not None:
            np.testing.assert_allclose(g[3], w[3], rtol=RTOL, err_msg=g[:3])
        if w[4] is not None:
            assert sorted(g[4]) == sorted(w[4])
            for k in w[4]:
                np.testing.assert_allclose(g[4][k], w[4][k], rtol=RTOL,
                                           err_msg=(g[:3], k))


def test_mlp_train_matches_jax_events_metrics_and_params():
    out = {}
    for which in ("jax", "torch"):
        trainer, main = _mlp(which)
        reader_mod = PKG[which][2]
        events = []
        trainer.train(reader_mod.batch(_toy_reader(), batch_size=16),
                      num_passes=4, event_handler=events.append,
                      test_reader=reader_mod.batch(_toy_reader(seed=1), 16))
        out[which] = (_events(events), _params(trainer, main))
    ev_j, p_j = out["jax"]
    ev_t, p_t = out["torch"]
    kinds = [e[0] for e in ev_t]
    assert kinds.count("EndIteration") == 16 and kinds.count("EndPass") == 4
    assert kinds.count("TestResult") == 4
    _assert_events_close(ev_t, ev_j)
    assert len(p_t) == len(p_j) == 2
    for t, j in zip(p_t, p_j):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-7)
    ends = [e for e in ev_t if e[0] == "EndPass"]
    assert ends[-1][4]["cost"] < ends[0][4]["cost"]


V, T, D, H, BATCH = 97, 16, 32, 2, 4


def _lm_rows(n_batches=4, seed=0):
    """Rows (ids[T], tgt[T]) of the learnable language t+1 = 3t + noise."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n_batches * BATCH):
        x = np.zeros(T + 1, np.int64)
        x[0] = rng.randint(0, V)
        for t in range(T):
            x[t + 1] = (3 * x[t] + rng.randint(0, 2)) % V
        rows.append((x[:-1], x[1:]))
    return rows


def _lm(which):
    pt, SGD, _, _ = PKG[which]
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 11
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[T], dtype="int64")
        tgt = pt.layers.data("tgt", shape=[T], dtype="int64")
        logits = pt.models.transformer_lm(
            ids, vocab_size=V, d_model=D, n_layers=2, num_heads=H, d_ff=64,
            max_len=T, pipeline_stack=False)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.reshape(logits, shape=[-1, V]),
            pt.layers.reshape(tgt, shape=[-1, 1])))
        trainer = SGD(cost=loss,
                      optimizer=pt.optimizer.SGDOptimizer(learning_rate=0.5),
                      feed_list=[ids, tgt], place=pt.CPUPlace(),
                      scope=pt.Scope())
    return trainer, main


def test_two_layer_lm_train_matches_jax_costs_and_params():
    rows = _lm_rows()
    out = {}
    for which in ("jax", "torch"):
        trainer, main = _lm(which)
        reader_mod = PKG[which][2]
        costs = []
        trainer.train(reader_mod.batch(lambda: iter(rows), BATCH),
                      event_handler=lambda e: costs.append(e.cost)
                      if type(e).__name__ == "EndIteration" else None)
        out[which] = (costs, _params(trainer, main))
    (c_j, p_j), (c_t, p_t) = out["jax"], out["torch"]
    assert len(c_t) == 4 and c_t[-1] < c_t[0]
    np.testing.assert_allclose(c_t, c_j, rtol=RTOL)
    assert len(p_t) == len(p_j) > 10
    for i, (t, j) in enumerate(zip(p_t, p_j)):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-7, err_msg=i)


def test_test_program_is_isolated_from_the_optimizer():
    """test() runs the clone taken before minimize: no optimizer op, and
    the parameters do not move; its result equals JAX's."""
    results = {}
    for which in ("jax", "torch"):
        trainer, main = _mlp(which)
        trainer._init_params()
        types = [op.type for op in trainer.test_program.global_block.ops]
        assert "sgd" not in types and not any("grad" in t for t in types)
        before = _params(trainer, main)
        results[which] = trainer.test(
            PKG[which][2].batch(_toy_reader(), 16))
        for b, a in zip(before, _params(trainer, main)):
            np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(results["torch"].cost, results["jax"].cost,
                               rtol=RTOL)
    assert results["torch"].metrics == pytest.approx(results["jax"].metrics,
                                                     rel=RTOL)


def test_save_params_load_params_round_trip(tmp_path):
    trainer, main = _mlp("torch")
    trainer.train(treader.batch(_toy_reader(), 16), num_passes=1,
                  event_handler=lambda e: None)
    trained = _params(trainer, main)
    trainer.save_params(str(tmp_path))
    for p in main.all_parameters():
        trainer.scope.set(p.name, torch.zeros_like(trainer.scope.get(p.name)))
    trainer.load_params(str(tmp_path))
    for t, got in zip(trained, _params(trainer, main)):
        np.testing.assert_array_equal(t, got)


def test_default_log_handler_follows_log_period(capsys):
    tpt.flags.FLAGS.log_period = 2
    try:
        trainer, _ = _mlp("torch")
        trainer.train(treader.batch(_toy_reader(), 16), num_passes=1)
    finally:
        tpt.flags.reset_flags()
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" cost")[0] for ln in lines[:2]] == [
        "pass 0 batch 0", "pass 0 batch 2"]
    assert lines[-1].startswith("pass 0 done: acc=") and "cost=" in lines[-1]


def test_events_carry_goodput_walls():
    trainer, _ = _mlp("torch")
    events = []
    trainer.train(treader.batch(_toy_reader(), 16), event_handler=events.append)
    ends = [e for e in events if isinstance(e, tevent.EndIteration)]
    assert all(e.batch_size == 16 and e.device_wall_s > 0
               and e.host_wall_s >= 0 and e.mfu is None for e in ends)
    snap = trainer.goodput.snapshot()
    assert snap["steps"] == 4 and snap["buckets"]["device_compute"] > 0
    assert snap["buckets"]["fresh_compile"] == 0.0 and snap["mfu"] is None
    # goodput=False: the bare loop, no meter
    trainer.train(treader.batch(_toy_reader(), 16), event_handler=events.append,
                  goodput=False)
    assert trainer.goodput is None


def test_default_place_is_cuda_and_what_is_not_ported_raises():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", shape=[8])
        y = tpt.layers.data("y", shape=[1], dtype="int64")
        cost = tpt.layers.mean(tpt.layers.softmax_with_cross_entropy(
            tpt.layers.fc(x, size=3), y))

        def sgd(**kw):
            return TSGD(cost=cost,
                        optimizer=tpt.optimizer.SGDOptimizer(0.1),
                        feed_list=[x, y], scope=tpt.Scope(), **kw)

        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                sgd()
        # the training pipeline is ported now (item 4's later part)
        assert sgd(transpile=True, place=tpt.CPUPlace()).test_program
        with pytest.raises(NotImplementedError, match="item 10"):
            sgd(mesh=object())
        trainer = sgd(place=tpt.CPUPlace())
    reader = treader.batch(_toy_reader(), 16)
    for kw, item in ((dict(run_log=print), 9), (dict(mem_budget=1e9), 9),
                     (dict(plan=object()), 10)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            trainer.train(reader, **kw)
