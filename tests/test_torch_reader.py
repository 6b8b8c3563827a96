"""Reader decorators, ``DataFeeder`` and the profiler's timers, in the port
against the JAX package.

Every decorator gives the JAX package's samples and batches on the same
inputs (shuffles under the same ``random`` seed); ``DataFeeder`` gives
its arrays (int64 columns stay int64 in the port; JAX carries them as
int32 without x64, so values are compared); abandoning a staged reader
early leaves no fill thread (``tests/test_async_training.py:354-406``);
``device_prefetch`` yields tensors on the device it was given.
"""
import gc
import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import reader as jreader
from paddle_tpu.data_feeder import DataFeeder as JFeeder
from paddle_tpu_torch import profiler
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.data_feeder import DataFeeder as TFeeder
from paddle_tpu_torch.reader import decorator

torch.set_num_threads(1)


def _samples(n=23):
    return lambda: iter([(i, [i] * (i % 5 + 1)) for i in range(n)])


def _same(make):
    """make(reader_module) gives a reader; both packages' samples."""
    random.seed(5)
    j = list(make(jreader)())
    random.seed(5)
    t = list(make(treader)())
    return j, t


@pytest.mark.parametrize("name,make", [
    ("batch", lambda r: r.batch(_samples(), 4)),
    ("batch_drop_last", lambda r: r.batch(_samples(), 4, drop_last=True)),
    ("shuffle", lambda r: r.shuffle(_samples(), buf_size=7)),
    ("chain", lambda r: r.chain(_samples(3), _samples(5))),
    ("compose", lambda r: r.compose(_samples(4), _samples(4))),
    ("map_readers", lambda r: r.map_readers(lambda a, b: a[0] + b[0],
                                            _samples(6), _samples(6))),
    ("firstn", lambda r: r.firstn(_samples(), 5)),
    ("cache", lambda r: r.cache(_samples(6))),
    ("buffered", lambda r: r.buffered(_samples(), 3)),
    ("xmap_ordered", lambda r: r.xmap_readers(lambda s: s[0] * 2, _samples(),
                                              process_num=3, buffer_size=4,
                                              order=True)),
    ("bucket_by_length", lambda r: r.bucket_by_length(
        _samples(), batch_size=4, key=lambda s: len(s[1]), buf_size=8,
        seed=3, pad_to_multiple=2)),
])
def test_decorators_give_jax_samples(name, make):
    j, t = _same(make)
    assert t == j and len(t) > 0, name


def test_cache_replays_and_compose_checks_alignment():
    cached = treader.cache(_samples(4))
    assert list(cached()) == list(cached()) == list(_samples(4)())
    with pytest.raises(decorator.ComposeNotAligned):
        list(treader.compose(_samples(3), _samples(4))())


def test_pipe_reader_streams_lines():
    j = list(jreader.PipeReader("printf a\\nbb\\nc").get_line())
    t = list(treader.PipeReader("printf a\\nbb\\nc").get_line())
    assert t == j == ["a", "bb", "c"]


def _wait_threads_back_to(before, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        extra = [t for t in threading.enumerate()
                 if t not in before and t.is_alive()]
        if not extra:
            return []
        time.sleep(0.02)
    return extra


def test_buffered_early_break_leaves_no_fill_thread():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = set(threading.enumerate())
    it = decorator.buffered(endless, size=2)()
    assert next(it) == 0
    it.close()
    assert _wait_threads_back_to(before) == []


def test_device_prefetch_lands_tensors_and_an_early_break_leaves_no_thread():
    def feeds():
        i = 0
        while True:
            yield {"x": np.full((2, 2), i, dtype="float32"),
                   "y": np.arange(2, dtype="int64") + i}
            i += 1

    before = set(threading.enumerate())

    def consume():
        for i, feed in enumerate(decorator.device_prefetch(
                feeds, depth=2, device="cpu")()):
            assert isinstance(feed["x"], torch.Tensor)
            assert feed["x"].device.type == "cpu"
            assert feed["y"].dtype == torch.int64
            assert float(feed["x"][0, 0]) == i
            if i == 1:
                break

    consume()
    gc.collect()
    assert _wait_threads_back_to(before) == []
    if not torch.cuda.is_available():  # the default device is cuda
        with pytest.raises(RuntimeError, match="CUDA"):
            decorator.device_prefetch(feeds)


def test_background_stage_close_is_bounded_and_errors_propagate():
    release = threading.Event()

    def stuck():
        yield 0
        release.wait()
        yield 1

    it = decorator.background_stage(stuck, depth=2)()
    assert next(it) == 0
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 2.0
    release.set()

    def bad():
        yield 1
        raise RuntimeError("source exploded")

    it = decorator.background_stage(bad, depth=2)()
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="source exploded"):
        next(it)


def _feeders(pad_to_multiple=None):
    out = {}
    for name, pt, Feeder in (("jax", jpt, JFeeder), ("torch", tpt, TFeeder)):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            img = pt.layers.data("img", shape=[2, 3])
            label = pt.layers.data("label", shape=[1], dtype="int64")
            words = pt.layers.data("words", shape=[1], dtype="int64",
                                   lod_level=1)
        out[name] = Feeder([img, label, words],
                           pad_to_multiple=pad_to_multiple)
    return out


@pytest.mark.parametrize("pad", [None, 3])
def test_data_feeder_gives_jax_arrays(pad):
    rng = np.random.RandomState(0)
    rows = [(rng.rand(6).astype("float32"), [int(i)],
             list(range(i % 3 + 1, 2 * (i % 3) + 3)))
            for i in range(5)]
    feeds = {k: f.feed(rows) for k, f in _feeders(pad).items()}
    j, t = feeds["jax"], feeds["torch"]
    assert sorted(t) == sorted(j) == ["img", "label", "words", "words@len"]
    assert t["img"].shape == (5, 2, 3) and t["img"].dtype == np.float32
    assert t["label"].dtype == np.int64 and t["words"].dtype == np.int64
    for k in t:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t["words"].shape[1] == (6 if pad else 4)
    assert t["words@len"].dtype == np.int32


def test_stage_to_device_copies_a_feed_with_a_ragged_column():
    """On the CPU ``_stage_to_device`` copies without a stream or event,
    and ``_landed`` hands the feed on unchanged."""
    f = _feeders()["torch"]
    rows = [(np.ones(6, "float32"), [1], [1, 2, 3]), (np.zeros(6, "float32"),
                                                    [0], [4])]
    feed = f.feed(rows)
    staged, done = decorator._stage_to_device(feed, "cpu")
    assert done is None
    for k, v in decorator._landed(staged, done).items():
        np.testing.assert_array_equal(v.numpy(), feed[k])


def test_stat_set_timers_and_record_event(capsys):
    s = profiler.StatSet()
    with profiler.timer("step", stat_set=s):
        pass
    with profiler.timer("step", stat_set=s, block_on=lambda: [torch.ones(2)]):
        pass
    s.add_count("ops", 7)
    d = s.as_dict()
    assert d["step"]["calls"] == 2 and d["step"]["kind"] == "time"
    assert d["ops"]["total_ms"] == 7 and d["ops"]["kind"] == "count"
    assert s.kind_of("ops") == "count" and s.kind_of("nope") is None
    assert "step" in s.format() and s.table()[0][1] >= 1
    with profiler.profiler() as p:
        with profiler.record_event("inner"):
            pass
    assert p.stats.as_dict()["inner"]["calls"] == 1
    assert "inner" in capsys.readouterr().out
    with profiler.record_event("outside"):  # no profiler: a no-op
        pass
    with pytest.raises(NotImplementedError, match="item 9"):
        with profiler.profiler(state="GPU"):
            pass
    with pytest.raises(NotImplementedError, match="item 9"):
        with profiler.xprof_trace("/nonexistent"):
            pass
    with pytest.raises(NotImplementedError, match="item 9"):
        profiler.framework_op_stats("/nonexistent")


def test_trainer_flags_have_the_jax_defaults():
    from paddle_tpu.flags import FLAGS as JF

    F = tpt.flags.FLAGS
    for name in ("check_nan_inf", "log_period", "fault_plan"):
        assert getattr(F, name) == getattr(JF, name), name
    F.fault_plan = "crash@3"
    F.log_period = "7"
    F.check_nan_inf = "on"
    try:
        assert (F.fault_plan, F.log_period, F.check_nan_inf) == (
            "crash@3", 7, True)
    finally:
        tpt.flags.reset_flags()
    assert F.fault_plan == ""
