"""The overlapped training pipeline and the deferred NaN check, in the port.

``SGD.train(async_depth=3)`` must equal ``async_depth=1`` bit for bit
(costs, metrics, pass summaries, parameters; dropout's RNG included) and
deliver its events in the JAX package's order (``tests/
test_async_training.py:75,96``). An exception drains the pending
handles. ``check_nan_inf`` raises ``FloatingPointError`` at the same
step, naming the same variable, as the JAX package's does, in the
synchronous and the pipelined loop; ``run_async`` defers the scan to
``result()``. Both packages build with their name counters at 0, so
variable names agree.
"""
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import reader as jreader
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.serving import MetricsRegistry
from paddle_tpu_torch.trace import GoodputMeter
from paddle_tpu_torch.trainer import SGD as TSGD

torch.set_num_threads(1)
PKG = {"jax": (jpt, JSGD, jreader), "torch": (tpt, TSGD, treader)}


def _rows(n=48, seed=0, nan_batch=None, batch=8):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n, 8).astype("float32")
    ys = rng.randint(0, 3, size=(n, 1)).astype("int64")
    if nan_batch is not None:
        xs[nan_batch * batch:(nan_batch + 1) * batch] = np.nan

    def r():
        for i in range(n):
            yield xs[i], ys[i:i + 1]
    return r


def _trainer(which, dropout=True, check_nan_inf=None):
    """fc -> relu -> dropout -> fc with an accuracy metric, names from 0."""
    pt, SGD, _ = PKG[which]
    pt.Program._uid_counter = 0
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[8])
        y = pt.layers.data("y", shape=[1], dtype="int64")
        h = pt.layers.fc(x, size=16, act="relu")
        if dropout:
            h = pt.layers.dropout(h, dropout_prob=0.3)
        logits = pt.layers.fc(h, size=3)
        cost = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits, y))
        acc = pt.layers.accuracy(logits, y)
        trainer = SGD(cost=cost,
                      optimizer=pt.optimizer.SGDOptimizer(learning_rate=0.5),
                      feed_list=[x, y], place=pt.CPUPlace(),
                      scope=pt.Scope(), metrics={"acc": acc},
                      check_nan_inf=check_nan_inf)
    return trainer, main


def _train(which, depth, passes=2, **kw):
    trainer, main = _trainer(which, **kw)
    events = []
    trainer.train(PKG[which][2].batch(_rows(), 8), num_passes=passes,
                  event_handler=events.append, async_depth=depth)
    params = [np.asarray(trainer.scope.get(p.name)).copy()
              for p in main.all_parameters()]
    return events, params


def _kinds(events):
    return [(type(e).__name__, getattr(e, "pass_id", None),
             getattr(e, "batch_id", None)) for e in events]


def test_async_depth3_equals_sync_bit_for_bit():
    ev_s, p_s = _train("torch", 1)
    ev_a, p_a = _train("torch", 3)
    assert len(p_s) == len(p_a) == 4
    for a, b in zip(p_s, p_a):
        np.testing.assert_array_equal(a, b)

    def iters(evs):
        return [(e.pass_id, e.batch_id, e.cost, e.metrics)
                for e in evs if isinstance(e, tevent.EndIteration)]

    assert iters(ev_s) == iters(ev_a) and len(iters(ev_s)) == 12
    assert ([e.metrics for e in ev_s if isinstance(e, tevent.EndPass)]
            == [e.metrics for e in ev_a if isinstance(e, tevent.EndPass)])


@pytest.mark.parametrize("depth", [1, 3])
def test_event_order_matches_jax(depth):
    ev_j, p_j = _train("jax", depth)
    ev_t, p_t = _train("torch", depth)
    assert _kinds(ev_t) == _kinds(ev_j)
    # the pipelined order: BeginIteration k+1 precedes EndIteration k, and
    # every EndIteration of a pass precedes its EndPass
    if depth > 1:
        kinds = _kinds(ev_t)
        assert kinds.index(("BeginIteration", 0, 1)) \
            < kinds.index(("EndIteration", 0, 0))
    for t, j in zip(p_t, p_j):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_exception_drains_pending_handles(which):
    """A handler raising mid-pass delivers the EndIteration of every
    dispatched step before the exception propagates."""
    trainer, _ = _trainer(which)
    events = []

    class Boom(RuntimeError):
        pass

    def handler(e):
        events.append(e)
        if type(e).__name__ == "EndIteration" and e.batch_id == 0:
            raise Boom("handler failure")

    with pytest.raises(Boom):
        trainer.train(PKG[which][2].batch(_rows(), 8), event_handler=handler,
                      async_depth=3)
    ends = [e.batch_id for e in events if type(e).__name__ == "EndIteration"]
    begins = [e.batch_id for e in events
              if type(e).__name__ == "BeginIteration"]
    assert ends == begins == [0, 1, 2]


def _nan_failure(which, depth):
    """(batch ids that ended, the variable named) of a run whose third
    batch is NaN, under check_nan_inf."""
    trainer, _ = _trainer(which, dropout=False, check_nan_inf=True)
    ended = []
    with pytest.raises(FloatingPointError) as info:
        trainer.train(PKG[which][2].batch(_rows(nan_batch=2), 8),
                      event_handler=lambda e: ended.append(e.batch_id)
                      if type(e).__name__ == "EndIteration" else None,
                      async_depth=depth)
    name = re.search(r"variable '([^']+)'", str(info.value)).group(1)
    return ended, name


@pytest.mark.parametrize("depth", [1, 3])
def test_check_nan_inf_raises_at_the_step_and_variable_jax_names(depth):
    ended_j, name_j = _nan_failure("jax", depth)
    ended_t, name_t = _nan_failure("torch", depth)
    assert ended_t == ended_j == [0, 1]
    assert name_t == name_j


def _mlp_program(pt):
    x = pt.layers.data("x", shape=[4])
    y = pt.layers.data("y", shape=[1], dtype="int64")
    clean = pt.layers.data("clean", shape=[4])
    cost = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
        pt.layers.fc(x, size=3), y))
    finite = pt.layers.mean(clean)
    pt.optimizer.SGDOptimizer(learning_rate=0.5).minimize(cost)
    return cost, finite


def test_run_async_matches_run_and_chains_on_the_device():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        cost, _ = _mlp_program(tpt)
    exe = tpt.Executor(tpt.CPUPlace())
    scope_a, scope_b = tpt.Scope(), tpt.Scope()
    exe.run(startup, scope=scope_a)
    exe.run(startup, scope=scope_b)
    feed = {"x": np.random.RandomState(0).rand(4, 4).astype("float32"),
            "y": np.zeros((4, 1), "int64"), "clean": np.ones((4, 4), "f4")}
    sync = [exe.run(main, feed=feed, fetch_list=[cost], scope=scope_a)[0]
            for _ in range(2)]
    h1 = exe.run_async(main, feed=feed, fetch_list=[cost], scope=scope_b)
    pname = main.all_parameters()[0].name
    assert isinstance(scope_b.get(pname), torch.Tensor)
    h2 = exe.run_async(main, feed=feed, fetch_list=[cost], scope=scope_b)
    assert h1.fetch_names == [cost.name]
    assert h2.block().done() and "done" in repr(h2)
    got = [h1.result()[0], h2.numpy()[0]]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(sync))
    assert got[1] < got[0]  # the second step trained on the first's update
    assert isinstance(h2.result(return_numpy=False)[0], torch.Tensor)
    np.testing.assert_array_equal(scope_a.get_numpy(pname),
                                  scope_b.get_numpy(pname))


def test_run_async_defers_the_nan_check_to_result():
    """NaN feeds poison the update (state) while the fetch stays finite:
    dispatch does not raise, and the late result() names the state."""
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        _, finite = _mlp_program(tpt)
    exe = tpt.Executor(tpt.CPUPlace(), check_nan_inf=True)
    scope = tpt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.full((4, 4), np.nan, "float32"),
            "y": np.zeros((4, 1), "int64"), "clean": np.ones((4, 4), "f4")}
    h1 = exe.run_async(main, feed=feed, fetch_list=[finite], scope=scope)
    h2 = exe.run_async(main, feed=feed, fetch_list=[finite], scope=scope)
    with pytest.raises(FloatingPointError, match="NaN"):
        h1.result()
    with pytest.raises(FloatingPointError):
        exe.run(main, feed=feed, fetch_list=[finite], scope=scope)
    del h2
    # FLAGS.check_nan_inf is the default
    tpt.flags.FLAGS.check_nan_inf = True
    try:
        assert tpt.Executor(tpt.CPUPlace()).check_nan_inf
    finally:
        tpt.flags.reset_flags()
    assert not tpt.Executor(tpt.CPUPlace()).check_nan_inf


def test_train_async_with_check_nan_inf_on_finite_data():
    trainer, _ = _trainer("torch", dropout=False, check_nan_inf=True)
    events = []
    trainer.train(treader.batch(_rows(), 8), event_handler=events.append,
                  async_depth=3)
    ends = [e for e in events if isinstance(e, tevent.EndIteration)]
    assert len(ends) == 6 and all(np.isfinite(e.cost) for e in ends)


def test_goodput_meter_accounts_the_async_loop_and_publishes():
    trainer, _ = _trainer("torch")
    meter = GoodputMeter()
    events = []
    trainer.train(treader.batch(_rows(), 8), event_handler=events.append,
                  async_depth=3, goodput=meter)
    assert trainer.goodput is meter
    snap = meter.snapshot()
    b = snap["buckets"]
    assert b["device_compute"] > 0 and b["host_dispatch"] > 0
    assert b["fresh_compile"] == 0.0 and snap["mfu"] is None
    # one device wall a step: on a host device, the dispatch that ran it
    assert snap["steps"] == 6
    ends = [e for e in events if isinstance(e, tevent.EndIteration)]
    assert [e.device_wall_s == e.host_wall_s > 0 for e in ends] == [True] * 6
    assert meter.bucket_seconds("device_compute") == pytest.approx(
        sum(e.device_wall_s for e in ends))
    assert abs(sum(b.values()) - snap["total_s"]) < 1e-5
    reg = MetricsRegistry()
    meter.publish(reg, trainer="t0")
    out = reg.snapshot()
    assert set(out["labeled"]["goodput_seconds_total"]) == {
        f'{{bucket="{k}",trainer="t0"}}' for k in b}
    assert 0 < out["gauges"]["goodput_fraction"] <= 1
    assert out["counters"]["goodput_total_ms_total"] >= \
        out["counters"].get("goodput_good_ms_total", 0)
    assert "mfu" not in out["gauges"]
    # the trainer mirrored the buckets into the global StatSet at pass end
    assert "goodput/device_compute" in tpt.profiler.global_stat.as_dict(
        prefix="goodput/")
    fresh, stats = GoodputMeter(), tpt.profiler.StatSet()
    with fresh.measure("data_wait"):
        pass
    fresh.account("device_compute", 0.5)
    fresh.publish_stats(stats)
    fresh.publish_stats(stats)  # only the un-mirrored delta goes in
    d = stats.as_dict(prefix="goodput/")
    assert d["goodput/device_compute"]["calls"] == 1
    assert d["goodput/device_compute"]["total_ms"] == pytest.approx(500.0)
    # MFU, given a program's FLOPs and a peak by the caller
    priced = GoodputMeter(peak_flops=1e12)
    priced.set_program_flops(1e9)
    assert priced.note_step(1e-3) == pytest.approx(1.0)
