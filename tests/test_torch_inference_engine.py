"""The port's InferenceEngine against the JAX package's, on the CPU.

A narrow ResNet (``test_torch_resnet``'s net, ``--fused_conv_epilogue``)
is saved by the JAX package (``save_inference_model``, transpiled), and
both engines load the same directory with batch buckets (1, 2, 4). Their
fetches agree at rtol 1e-4 / atol 1e-5 for batches that pad (3 → 4) and
chunk past the largest bucket (7 → 4 + 3, 9 → 4 + 4 + 1); ``warmup()``
counts the buckets; ``Server`` serves per-row feed dicts of two image
sizes grouped by shape; ``close(drain)`` ends admissions with
``EngineClosedError``. The card's path (one CUDA graph per bucket,
captured at warmup and replayed by ``run``) runs here through a stand-in
for the capture whose replay re-runs the captured function into the same
static outputs: it must give the eager run's fetches bitwise, copy each
replay's outputs out before the next, and refuse a shape it holds no
graph for.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.serving import InferenceEngine as JaxInferenceEngine
from paddle_tpu_torch.serving import engine as engine_mod
from test_torch_transpiler import Pair, resnet_net

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
BUCKETS = (1, 2, 4)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    pair = Pair(resnet_net, fused=True, test_clone=True)
    d = str(tmp_path_factory.mktemp("jax_saved"))
    old = jpt.flags.FLAGS.fused_conv_epilogue
    jpt.flags.FLAGS.fused_conv_epilogue = True
    try:
        jpt.io.save_inference_model(d, ["images"], [pair.fetch],
                                    jpt.Executor(jpt.CPUPlace()),
                                    main_program=pair.jmain,
                                    scope=pair.jscope)
    finally:
        jpt.flags.FLAGS.fused_conv_epilogue = old
    jeng = JaxInferenceEngine(d, batch_buckets=BUCKETS)
    return d, jeng


def _engine(d, **kw):
    return tpt.InferenceEngine(d, place=tpt.CPUPlace(),
                               batch_buckets=BUCKETS, **kw)


def _images(n, size=32, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def test_runs_pad_and_chunk_as_jax_does(model):
    d, jeng = model
    eng = _engine(d)
    assert eng.warmup() == len(BUCKETS) == jeng.warmup()
    # the load-time pipeline is a no-op on a transpiled artefact
    gauges = eng.metrics.snapshot()["gauges"]
    assert gauges["transpile/ops_removed"] == 0
    before = eng.metrics.counter("batches_executed")
    for n in (1, 3, 4, 7, 9):
        x = _images(n, seed=n)
        (got,) = eng.run({"images": x})
        (want,) = jeng.run({"images": x})
        assert got.shape == (n, 10)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        # padding rows never leak into the real rows
        np.testing.assert_allclose(
            got[-1:], eng.run({"images": x[-1:]})[0], rtol=0, atol=1e-6)
    # 1 + 1 + 1 + 2 + 3 padded runs, and one single-row run after each
    assert eng.metrics.counter("batches_executed") - before == 8 + 5


def test_padding_repeats_the_last_row(model):
    eng = _engine(model[0])
    x = _images(3)
    fed, bucket = eng._pad_feed({"images": x}, 3)
    assert bucket == 4
    np.testing.assert_array_equal(fed["images"][:3], x)
    np.testing.assert_array_equal(fed["images"][3], x[2])
    assert eng.bucket_for(1) == 1 and eng.bucket_for(9) == 4
    with pytest.raises(tpt.BadRequestError):
        eng.run({"wrong": x})
    with pytest.raises(tpt.BadRequestError):
        eng.run({"images": x[:0]})


def test_server_serves_rows_grouped_by_shape(model):
    d, jeng = model
    eng = _engine(d)
    eng.warmup()
    srv = tpt.Server(eng, max_wait_ms=20).start()
    try:
        rows = ([_images(1, 32, seed=i)[0] for i in range(6)]
                + [_images(1, 16, seed=10 + i)[0] for i in range(5)])
        futs = [srv.submit({"images": r}) for r in rows]
        got = [f.result(timeout=60) for f in futs]
    finally:
        srv.stop()
    for r, g in zip(rows, got):
        (want,) = jeng.run({"images": r[None]})
        np.testing.assert_allclose(g[0], np.asarray(want)[0], **TOL)
    snap = eng.metrics.snapshot()
    assert snap["counters"]["completed"] == len(rows)
    assert snap["counters"]["batches"] >= 2  # the two shapes never mix


def test_close_drains_and_refuses(model):
    eng = _engine(model[0])
    assert eng.state == "ready"
    eng.run({"images": _images(2)})
    eng.close(drain=True)
    assert eng.state == "closed"
    with pytest.raises(tpt.EngineClosedError):
        eng.run({"images": _images(1)})
    with pytest.raises(tpt.EngineClosedError):
        eng.run_async({"images": _images(1)})
    with pytest.raises(tpt.EngineClosedError):
        eng.serve_step(tpt.DynamicBatcher(buckets=BUCKETS))
    eng.close()  # idempotent


def _fake_graph_capture(fn, device):
    """The capture on the CPU: the static outputs of one call, and a
    replay that re-runs ``fn`` and writes into them, as a CUDA graph
    writes its captured outputs."""
    outs = fn()
    calls = {"replays": 0}

    def replay():
        for o, new in zip(outs, fn()):
            o.copy_(new)
        calls["replays"] += 1

    graph = type("Graph", (), {"replay": staticmethod(replay),
                               "calls": calls})()
    return graph, outs


def test_replayed_buckets_equal_the_eager_run(model, monkeypatch):
    d, _ = model
    eager = _engine(d)
    monkeypatch.setattr(engine_mod, "_graph_capture", _fake_graph_capture)
    eng = _engine(d)
    eng._use_graphs = True
    with pytest.raises(RuntimeError, match="warmup"):
        eng.run({"images": _images(1)})  # no graph: no eager fallback
    assert eng.warmup() == len(BUCKETS)
    assert eng.cache_stats() == {"graphs": len(BUCKETS)}
    x, y = _images(3, seed=1), _images(3, seed=2)
    first = eng.run_async({"images": x})
    second = eng.run({"images": y})  # replays the same bucket again
    np.testing.assert_array_equal(first.result()[0],
                                  eager.run({"images": x})[0])
    np.testing.assert_array_equal(second[0], eager.run({"images": y})[0])
    np.testing.assert_array_equal(eng.run({"images": _images(9)})[0],
                                  eager.run({"images": _images(9)})[0])
    replays = sum(g.calls["replays"] for g, _, _ in eng._graphs.values())
    assert replays == 2 + 3
    with pytest.raises(RuntimeError, match="no CUDA graph"):
        eng.run({"images": _images(2, size=16)})
    eng.close()
    assert eng.cache_stats() == {"graphs": 0}


def test_no_fallback_and_later_pieces_raise(model):
    d, _ = model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpt.InferenceEngine(d)
    for kw in (dict(mesh=object()), dict(mem_budget=1e9)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _engine(d, **kw)
    eng = _engine(d)
    for call in (eng.warm_start, eng.warm_from_manifest, eng.save_manifest,
                 lambda: eng.swap_params({})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    tpt.flags.FLAGS.verify_program = True
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _engine(d)
    finally:
        tpt.flags.reset_flags()
