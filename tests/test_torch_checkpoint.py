"""Checkpoints and resilience in the port, and checkpoints across packages.

The file format is the JAX package's (``paddle_tpu/checkpoint.py``): a
checkpoint written by either package loads in the other, the RNG key
included (uint32 [2] in the file; a pair of int64 tensors in the port),
and training goes on to the other package's losses (rtol 1e-5, the two
packages' f32 rounding). Within the port, resume is exact: a crash
through a ``FaultPlan``, a preemption, a SIGTERM and a torn checkpoint
each resume to the bit-identical end state of an uninterrupted run
(modelled on ``tests/test_resilience.py:96-245``). The model has a
dropout layer, so the RNG key is part of every claim.
"""
import os
import signal
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu_torch import checkpoint as tckpt
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch.core.program import RNG_VAR
from paddle_tpu_torch.resilience import (CheckpointConfig, FaultPlan, Retry,
                                         ShutdownFlag, SimulatedCrash,
                                         TransientFault, graceful_shutdown)
from paddle_tpu_torch.trainer import SGD as TSGD

torch.set_num_threads(1)
N_BATCHES = 8
_rng = np.random.RandomState(0)
BATCHES = [[(_rng.rand(6).astype("float32"),
             _rng.randint(0, 3, size=(1,)).astype("int64"))
            for _ in range(8)] for _ in range(N_BATCHES)]


def _reader(lo=0, hi=N_BATCHES):
    return lambda: iter(BATCHES[lo:hi])


def _build(pt=tpt, SGD=TSGD):
    """The same program from scratch with names from 0, as a restarted
    process rebuilds it."""
    pt.Program._uid_counter = 0
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[6])
        y = pt.layers.data("y", shape=[1], dtype="int64")
        h = pt.layers.fc(x, size=12, act="relu")
        h = pt.layers.dropout(h, dropout_prob=0.3)
        logits = pt.layers.fc(h, size=3)
        cost = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits, y))
        return SGD(cost=cost,
                   optimizer=pt.optimizer.AdamOptimizer(learning_rate=0.01),
                   feed_list=[x, y], place=pt.CPUPlace(), scope=pt.Scope())


def _quiet(e):
    pass


def _costs(trainer, reader):
    out = []
    trainer.train(reader, event_handler=lambda e: out.append(e.cost)
                  if type(e).__name__ == "EndIteration" else None)
    return out


def _state(trainer):
    """Every scope value as numpy (the RNG key as its uint32 pair)."""
    out = {}
    for k in trainer.scope.keys():
        v = trainer.scope.get(k)
        if k == RNG_VAR and isinstance(v, tuple):
            v = np.asarray([int(t) for t in v], np.uint32)
        out[k] = np.asarray(v).copy()
    return out


def _assert_bitwise_equal(ref, got):
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


@pytest.fixture(scope="module")
def uninterrupted_state():
    t = _build()
    t.train(_reader(), event_handler=_quiet)
    return _state(t)


def test_jax_checkpoint_loads_in_the_port_and_trains_on_to_jax_losses(
        tmp_path):
    d = str(tmp_path / "ck")
    jt = _build(jpt, JSGD)
    _costs(jt, _reader(0, 3))
    jckpt.save_checkpoint(d, scope=jt.scope, step=3)
    tt = _build()
    tt._init_params()
    meta = tckpt.load_checkpoint(d, scope=tt.scope, device="cpu")
    assert meta["step"] == 3
    key = tt.scope.get(RNG_VAR)
    assert isinstance(key, tuple) and all(k.dtype == torch.int64 for k in key)
    jstate = {k: np.asarray(jt.scope.get(k)) for k in jt.scope.keys()}
    tstate = _state(tt)
    for k, v in jstate.items():
        np.testing.assert_array_equal(tstate[k], v, err_msg=k)
    np.testing.assert_allclose(_costs(tt, _reader(3, 6)),
                               _costs(jt, _reader(3, 6)), rtol=1e-5)


def test_port_checkpoint_loads_in_jax_and_trains_on_to_port_losses(tmp_path):
    d = str(tmp_path / "ck")
    tt = _build()
    _costs(tt, _reader(0, 3))
    tckpt.save_checkpoint(d, scope=tt.scope, step=3, extra={"iteration": 2})
    jt = _build(jpt, JSGD)
    jt._init_params()
    meta = jckpt.load_checkpoint(d, scope=jt.scope)
    assert meta["step"] == 3 and meta["extra"] == {"iteration": 2}
    jkey = np.asarray(jt.scope.get(RNG_VAR))
    assert jkey.dtype == np.uint32 and jkey.shape == (2,)
    for k, v in _state(tt).items():
        np.testing.assert_array_equal(
            np.asarray(jt.scope.get(k)).astype(v.dtype), v, err_msg=k)
    np.testing.assert_allclose(_costs(jt, _reader(3, 6)),
                               _costs(tt, _reader(3, 6)), rtol=1e-5)


def test_bf16_values_round_trip_through_both_packages(tmp_path):
    import ml_dtypes

    d = str(tmp_path / "ck")
    bits = np.random.RandomState(1).randint(0, 1 << 16, 12).astype(np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80  # no NaN/Inf patterns
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    s = tpt.Scope()
    s.set("w", t.reshape(3, 4))
    s.set("n", torch.arange(3, dtype=torch.int64))
    tckpt.save_checkpoint(d, scope=s, step=1)
    js = jpt.Scope()
    jckpt.load_checkpoint(d, scope=js)
    jw = np.asarray(js.get("w"))
    assert jw.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(jw.view(np.uint16).reshape(-1), bits)
    jckpt.save_checkpoint(d, scope=js, step=2)
    back = tpt.Scope()
    tckpt.load_checkpoint(d, scope=back, device="cpu")
    assert back.get("w").dtype == torch.bfloat16
    assert torch.equal(back.get("w").view(torch.int16),
                       t.reshape(3, 4).view(torch.int16))
    assert back.get("n").tolist() == [0, 1, 2]


def test_corrupt_latest_falls_back_and_warns(tmp_path):
    d = str(tmp_path / "ck")
    s = tpt.Scope()
    s.set("w", torch.arange(4, dtype=torch.float32))
    tckpt.save_checkpoint(d, scope=s, step=2,
                          extra={"pass_id": 0, "iteration": 1})
    s.set("w", torch.arange(4, dtype=torch.float32) + 100)
    payload = tckpt.save_checkpoint(d, scope=s, step=4,
                                    extra={"pass_id": 0, "iteration": 3})
    with open(payload, "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff")
    s2 = tpt.Scope()
    with pytest.warns(RuntimeWarning, match="fell back"):
        meta = tckpt.load_checkpoint(d, scope=s2, device="cpu")
    assert meta["step"] == 2 and meta["fallback"]
    assert meta["fallback_from"] == "ckpt-4.npz"
    assert meta["extra"]["iteration"] == 1
    assert s2.get("w").tolist() == [0, 1, 2, 3]
    assert tckpt.latest_step(d) == 2 and tckpt.latest_step(d, verify=False) == 4
    with pytest.raises(ValueError, match="md5 mismatch"):
        tckpt.load_checkpoint(d, scope=tpt.Scope(), strict=True, device="cpu")
    # the JAX package walks back the same way over the port's files
    with pytest.warns(RuntimeWarning, match="fell back"):
        assert jckpt.load_checkpoint(d, scope=jpt.Scope())["step"] == 2
    # and with no intact checkpoint left, the latest's error is raised
    with open(os.path.join(d, "ckpt-2.npz"), "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff")
    with pytest.raises(ValueError, match="md5 mismatch"):
        tckpt.load_checkpoint(d, scope=tpt.Scope(), device="cpu")
    assert tckpt.latest_step(d) is None


def test_retention_keeps_the_newest_and_the_pinned(tmp_path):
    d = str(tmp_path / "ck")
    s = tpt.Scope()
    s.set("w", torch.zeros(2))
    tckpt.save_checkpoint(d, scope=s, step=1, max_keep=2)
    tckpt.pin_generation(d, 1)
    for step in (2, 3, 4):
        tckpt.save_checkpoint(d, scope=s, step=step, max_keep=2)
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
        "ckpt-1.npz", "ckpt-3.npz", "ckpt-4.npz"]
    assert tckpt.pinned_step(d) == 1
    assert tckpt.generation_info(d, 4)["step"] == 4
    assert tckpt.generation_info(d, 2) is None
    tckpt.pin_generation(d, None)
    assert tckpt.pinned_step(d) is None
    with pytest.raises(NotImplementedError, match="item 10"):
        tckpt.load_checkpoint(d, scope=s, plan=object(), device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path / "none"), device="cpu")


@pytest.mark.parametrize("depth", [1, 3], ids=["sync", "async_depth3"])
def test_crash_resume_bitwise(tmp_path, uninterrupted_state, depth):
    d = str(tmp_path / "ck")
    t1 = _build()
    cfg = CheckpointConfig(d, every_n_steps=3, background=True,
                           install_signal_handlers=False)
    with FaultPlan().at(step=6, kind="crash").active():
        with pytest.raises(SimulatedCrash):
            t1.train(_reader(), event_handler=_quiet, async_depth=depth,
                     checkpoint=cfg)
    # the periodic save at step 3 lands once the step resolves: at once in
    # the sync loop, after the pipelined loop drains its window (step 5)
    saved = tckpt.latest_step(d)
    assert saved == (3 if depth == 1 else 5)
    t2 = _build()
    events = []
    t2.train(_reader(), event_handler=events.append, async_depth=depth,
             checkpoint=CheckpointConfig(d, every_n_steps=3,
                                         install_signal_handlers=False))
    _assert_bitwise_equal(uninterrupted_state, _state(t2))
    iters = [e.batch_id for e in events
             if isinstance(e, tevent.EndIteration)]
    assert iters == list(range(saved, N_BATCHES))  # only the tail replayed


def test_preempt_graceful_then_resume(tmp_path, uninterrupted_state):
    d = str(tmp_path / "ck")
    t1 = _build()
    events = []
    with FaultPlan().at(step=5, kind="preempt").active():
        t1.train(_reader(), event_handler=events.append,
                 checkpoint=CheckpointConfig(d, every_n_steps=100,
                                             install_signal_handlers=False))
    ends = [e for e in events if isinstance(e, tevent.EndPass)]
    assert len(ends) == 1 and ends[0].interrupted
    assert len([e for e in events if isinstance(e, tevent.EndIteration)]) == 5
    meta = tckpt.load_checkpoint(d, scope=tpt.Scope(), device="cpu")
    assert meta["step"] == 5 and meta["extra"]["reason"] == "interrupt"
    assert meta["extra"]["samples_seen"] == 5 * 8
    t2 = _build()
    t2.train(_reader(), event_handler=_quiet,
             checkpoint=CheckpointConfig(d, every_n_steps=100,
                                         install_signal_handlers=False))
    _assert_bitwise_equal(uninterrupted_state, _state(t2))


def test_sigterm_stops_gracefully(tmp_path):
    d = str(tmp_path / "ck")
    events = []

    def handler(e):
        events.append(e)
        if isinstance(e, tevent.EndIteration) and e.batch_id == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    _build().train(_reader(), event_handler=handler,
                   checkpoint=CheckpointConfig(d, every_n_steps=100))
    assert signal.getsignal(signal.SIGTERM) is before
    ends = [e for e in events if isinstance(e, tevent.EndPass)]
    assert len(ends) == 1 and ends[0].interrupted
    assert tckpt.load_checkpoint(d, scope=tpt.Scope(),
                                 device="cpu")["step"] == 3


def test_torn_write_then_fallback_resume(tmp_path, uninterrupted_state):
    d = str(tmp_path / "ck")
    plan = (FaultPlan().at(step=6, kind="torn_checkpoint")
            .at(step=7, kind="crash"))
    with plan.active():
        with pytest.raises(SimulatedCrash):
            _build().train(_reader(), event_handler=_quiet,
                           checkpoint=CheckpointConfig(
                               d, every_n_steps=3,
                               install_signal_handlers=False))
    assert plan.pending() == [] and tckpt.latest_step(d) == 3
    t2 = _build()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        t2.train(_reader(), event_handler=_quiet,
                 checkpoint=CheckpointConfig(d, every_n_steps=3,
                                             install_signal_handlers=False))
    _assert_bitwise_equal(uninterrupted_state, _state(t2))


def test_resume_of_a_finished_run_trains_nothing(tmp_path):
    d = str(tmp_path / "ck")
    cfg = CheckpointConfig(d, every_n_steps=0, install_signal_handlers=False)
    t1 = _build()
    t1.train(_reader(), event_handler=_quiet, checkpoint=cfg)
    t2 = _build()
    events = []
    t2.train(_reader(), event_handler=events.append, checkpoint=cfg)
    assert not [e for e in events if isinstance(e, tevent.EndIteration)]
    _assert_bitwise_equal(_state(t1), _state(t2))


def test_fault_plan_flag_and_transient_step_retry(uninterrupted_state):
    assert FaultPlan.parse("preempt@5, crash").pending() == [
        ("preempt", 5), ("crash", None)]
    tpt.flags.FLAGS.fault_plan = "executor_error@2"
    try:
        t = _build()
        t.train(_reader(), event_handler=_quiet)
    finally:
        tpt.flags.reset_flags()
    _assert_bitwise_equal(uninterrupted_state, _state(t))
    stats = tpt.profiler.global_stat.as_dict(prefix="retry/")
    assert stats["retry/recovered"]["calls"] >= 1


def test_retry_policy_and_shutdown_flag():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientFault("blip")
        return "ok"

    assert Retry(max_attempts=5, backoff=0.0).call(flaky) == "ok"
    with pytest.raises(ConnectionError):
        Retry(max_attempts=2, backoff=0.0).call(
            lambda: (_ for _ in ()).throw(ConnectionError("down")))
    with pytest.raises(KeyError):  # not retryable: escapes at once
        Retry(max_attempts=5, backoff=0.0).call(
            lambda: (_ for _ in ()).throw(KeyError("x")))
    flag = ShutdownFlag()
    flag.set("first")
    flag.set("second")
    assert flag.is_set() and flag.reason == "first"
    before = signal.getsignal(signal.SIGINT)
    with graceful_shutdown() as f:
        os.kill(os.getpid(), signal.SIGINT)
        assert f.is_set() and f.reason == "SIGINT"
    assert signal.getsignal(signal.SIGINT) is before
