"""Event-driven training loop. Counterpart of ``paddle_tpu/trainer.py``
(the v2 SGD trainer) on top of the port's eager executor.

The optimizer appends its update ops into the program, so a step
(forward, backward, update) is one ``Executor`` run. ``train`` drives
the same events in the same order as the JAX package's loop, with the
same ``async_depth`` pipeline, checkpoints, fault plans and goodput
buckets, and ``transpile=True`` runs ``transpiler.training_pipeline``
on the program before ``minimize`` and ``prune_pipeline`` on its test
clone. What the port leaves out raises, naming its ROADMAP.md Queue 1
item: ``mesh``/``plan`` (item 10), ``run_log`` and ``mem_budget`` (item 9), and
``FLAGS.verify_program`` (item 9's analysis plane). The JAX package's
trace spans, flight recorder and compile-signature manifests are item
9's too; the port compiles nothing, so its trainer accounts nothing to
the ``fresh_compile`` bucket.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from . import event as evt
from . import io as io_mod
from . import profiler
from .core.executor import CUDAPlace, Executor
from .core.program import Program, Variable, default_startup_program
from .core.scope import Scope, global_scope
from .data_feeder import DataFeeder


def _not_ported(what: str, item: int, why: str):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet: {why} "
        f"(ROADMAP.md Queue 1 item {item})")


class SGD:
    """``SGD(cost, optimizer, feed_list).train(reader, ...)``.

    ``metrics`` maps display names to program variables (e.g. the output
    of ``layers.accuracy``) fetched and averaged alongside the cost.
    ``place`` defaults to ``CUDAPlace(0)``, which raises without CUDA.
    """

    def __init__(self, cost: Variable, optimizer, feed_list: Sequence[Variable],
                 place=None, mesh=None, plan=None,
                 metrics: Optional[Dict[str, Variable]] = None,
                 scope: Optional[Scope] = None,
                 check_nan_inf: Optional[bool] = None,
                 transpile: bool = False,
                 pad_to_multiple: Optional[int] = None):
        from .flags import FLAGS

        if mesh is not None or plan is not None:
            raise _not_ported("SGD(mesh=..., plan=...)", 10,
                              "SPMD training comes with the parallel plane")
        self.cost = cost
        self.metrics = dict(metrics or {})
        self.main_program: Program = cost.block.program
        self.startup_program = default_startup_program()
        # the test clone is taken BEFORE minimize appends the backward and
        # the updates, with is_test flipped (Program.clone(for_test=True))
        self.test_program = self.main_program.clone(for_test=True)
        if transpile:
            # the rewrites land before minimize appends the backward:
            # grad ops name the op list they were derived from, and the
            # fused replacements carry their own grad_fns
            from .transpiler import prune_pipeline, training_pipeline

            feeds = [v.name for v in feed_list]
            fetches = [cost.name] + [v.name for v in self.metrics.values()]
            training_pipeline().run(self.main_program, feeds, fetches,
                                    scope=scope or global_scope())
            prune_pipeline().run(self.test_program, feeds, fetches)
        optimizer.minimize(cost, startup_program=self.startup_program)
        if FLAGS.verify_program:
            raise _not_ported("FLAGS.verify_program", 9,
                              "the program verifier is the analysis plane's")
        self.feeder = DataFeeder(feed_list, pad_to_multiple=pad_to_multiple)
        self._feed_names = [v.name for v in feed_list]
        self.scope = scope or global_scope()
        self.exe = Executor(place if place is not None else CUDAPlace(0),
                            check_nan_inf=check_nan_inf)
        self._initialized = False
        self.goodput = None

    def _init_params(self):
        if not self._initialized:
            self.exe.run(self.startup_program, scope=self.scope)
            self._initialized = True

    def _fetch_list(self):
        return [self.cost] + list(self.metrics.values())

    def _split(self, fetched):
        cost = float(np.asarray(fetched[0]))
        names = list(self.metrics.keys())
        vals = {n: float(np.mean(np.asarray(v)))
                for n, v in zip(names, fetched[1:])}
        return cost, vals

    # ------------------------------------------------------------------
    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              test_reader: Optional[Callable] = None,
              run_log=None, async_depth: int = 1,
              checkpoint=None, mem_budget: Optional[float] = None,
              plan=None, goodput=None):
        """Run ``num_passes`` over ``reader`` (a batched reader: yields
        minibatches of rows ordered like ``feed_list``).

        Without an ``event_handler``, batch cost is printed every
        ``FLAGS.log_period`` batches.

        ``checkpoint`` (a :class:`paddle_tpu_torch.resilience.
        CheckpointConfig`) makes the run preemption-safe: the scope
        (parameters, optimizer slots, RNG key) plus the training position
        is checkpointed every ``every_n_steps`` completed steps (written
        off the loop with ``background=True``); SIGTERM/SIGINT drains the
        in-flight steps, writes a final checkpoint and ends the pass with
        ``EndPass(interrupted=True)``; and the next ``train`` call resumes
        from the latest intact checkpoint, skipping the batches the
        interrupted pass already consumed, to the bit-identical end state
        of an uninterrupted run.

        ``async_depth`` > 1 pipelines the loop: each batch is stacked
        and its copy queued from pinned memory while earlier steps run,
        each step is dispatched with ``Executor.run_async`` while up to
        ``async_depth`` earlier steps are still in flight, and cost and
        metrics resolve with that lag. ``EndIteration`` fires (in batch
        order) when a step's fetches resolve, with a full drain before
        ``EndPass``, so a ``BeginIteration`` for step k+1 can precede
        step k's ``EndIteration``. The same programs run in the same order on the
        same device state, so the numbers equal the synchronous loop's
        (``async_depth=1``, the default) bit for bit.

        ``goodput``: the default None creates a fresh
        :class:`paddle_tpu_torch.trace.GoodputMeter`, so every second of
        the run falls in one of its buckets; pass a meter to share one,
        or False for the bare loop. The meter is ``self.goodput``.

        ``run_log``, ``mem_budget`` and ``plan`` raise when given."""
        if run_log is not None:
            raise _not_ported("SGD.train(run_log=...)", 9,
                              "the run log is the trace plane's")
        if mem_budget is not None:
            raise _not_ported("SGD.train(mem_budget=...)", 9,
                              "the static memory estimate is the analysis "
                              "plane's")
        if plan is not None:
            raise _not_ported("SGD.train(plan=...)", 10,
                              "SPMD training comes with the parallel plane")
        event_handler = event_handler or _default_log_handler()
        self._init_params()
        from .trace.goodput import GoodputMeter

        if goodput is False:
            meter = None
        elif goodput is None or goodput is True:
            meter = GoodputMeter()
        else:
            meter = goodput
        self.goodput = meter
        rs = None
        from .flags import FLAGS
        from .resilience import TrainResilience, faults

        if (checkpoint is not None or FLAGS.fault_plan
                or faults.active_plan() is not None):
            rs = TrainResilience(checkpoint, scope=self.scope,
                                 device=self.exe.device)
            rs.resume()  # restores scope + position from the latest ckpt
        import contextlib

        ctx = rs.signal_context() if rs is not None \
            else contextlib.nullcontext()
        try:
            self._train_passes(ctx, rs, reader, num_passes, event_handler,
                               test_reader, async_depth, meter)
        except BaseException:
            if rs is not None:
                # join (never mask) an in-flight background save so no
                # thread keeps writing the checkpoint dir after the crash
                rs.abort()
            raise
        if rs is not None:
            rs.finalize()

    def _train_passes(self, ctx, rs, reader, num_passes, event_handler,
                      test_reader, async_depth, meter=None):
        with ctx:
            if meter is not None:
                # the residual anchor carries across passes: event
                # dispatch, reader setup and the EndPass->BeginPass gap
                # belong to the decomposition too
                t_anchor = time.perf_counter()
                acc0 = meter.total_seconds()
            for pass_id in range(rs.start_pass if rs else 0, num_passes):
                event_handler(evt.BeginPass(pass_id))
                skip_n = rs.skip_for_pass(pass_id) if rs else 0
                if async_depth > 1:
                    pass_costs, pass_metrics = self._run_pass_async(
                        pass_id, reader, event_handler, int(async_depth),
                        rs=rs, skip_n=skip_n, meter=meter)
                else:
                    pass_costs, pass_metrics = self._run_pass_sync(
                        pass_id, reader, event_handler, rs=rs,
                        skip_n=skip_n, meter=meter)
                if meter is not None:
                    # the residual (event handlers, splits, loop
                    # bookkeeping) closes the decomposition: bucket
                    # seconds sum to the measured pass wall
                    wall = time.perf_counter() - t_anchor
                    meter.account("host_dispatch",
                                  wall - (meter.total_seconds() - acc0))
                    meter.publish_stats(profiler.global_stat)
                    t_anchor = time.perf_counter()
                    acc0 = meter.total_seconds()
                summary = _mean_metrics(pass_metrics)
                summary["cost"] = float(np.mean(pass_costs)) \
                    if pass_costs else 0.0
                if rs is not None and rs.interrupted:
                    # graceful preemption: the final checkpoint is on
                    # disk already; no test pass on the way out
                    event_handler(evt.EndPass(pass_id, metrics=summary,
                                              interrupted=True))
                    break
                if test_reader is not None:
                    result = self.test(test_reader)
                    event_handler(evt.EndPass(pass_id, metrics=summary))
                    event_handler(result)
                else:
                    event_handler(evt.EndPass(pass_id, metrics=summary))

    def _before_step(self, rs, m):
        if rs is None:
            return
        # transient-fault retries (backoff included) are recovery
        if m is not None:
            with m.measure("recovery_rollback"):
                rs.before_step()
        else:
            rs.before_step()

    def _commit(self, rs, m, pass_id):
        if m is not None:
            with m.measure("checkpoint_stall"):
                return rs.commit(pass_id)
        return rs.commit(pass_id)

    def _run_pass_sync(self, pass_id, reader, event_handler, rs=None,
                       skip_n=0, meter=None):
        m = meter
        perf = time.perf_counter
        exe = self.exe
        pass_costs, pass_metrics = [], []
        it = enumerate(reader())
        while True:
            t_read0 = perf()
            try:
                batch_id, batch = next(it)
                while batch_id < skip_n:
                    # consumed before the interrupt (resume replay)
                    batch_id, batch = next(it)
            except StopIteration:
                if m is not None:
                    m.account("data_wait", perf() - t_read0)
                break
            if m is not None:
                m.account("data_wait", perf() - t_read0)
            t_step0 = perf()
            self._before_step(rs, m)
            event_handler(evt.BeginIteration(pass_id, batch_id))
            device_dt = step_mfu = None
            with profiler.timer("trainer/step"):
                t_feed0 = perf()
                feed = self.feeder.feed(batch)
                if m is not None:
                    m.account("data_wait", perf() - t_feed0)
                t_run0 = perf()
                fetched = exe.run(self.main_program, feed=feed,
                                  fetch_list=self._fetch_list(),
                                  scope=self.scope)
                if m is not None:
                    # the run returns host values, so it waited for the
                    # device: its wall is the step's device compute
                    device_dt = perf() - t_run0
                    m.account("device_compute", device_dt)
                    step_mfu = m.note_step(device_dt)
                cost, mvals = self._split(fetched)
            pass_costs.append(cost)
            pass_metrics.append(mvals)
            try:
                bs = len(batch)
            except TypeError:
                bs = None
            host_dt = None
            if m is not None:
                host_dt = max(0.0, perf() - t_step0 - device_dt)
            event_handler(evt.EndIteration(pass_id, batch_id, cost,
                                           mvals, batch_size=bs,
                                           host_wall_s=host_dt,
                                           device_wall_s=device_dt,
                                           mfu=step_mfu))
            if rs is not None:
                # a due/periodic save stalls the loop right here
                if m is not None:
                    with m.measure("checkpoint_stall"):
                        stop = rs.after_step(pass_id, batch_id, bs)
                else:
                    stop = rs.after_step(pass_id, batch_id, bs)
                if stop:
                    break  # graceful interrupt: checkpoint written
        return pass_costs, pass_metrics

    def _run_pass_async(self, pass_id, reader, event_handler, depth,
                        rs=None, skip_n=0, meter=None):
        """The overlapped pipeline: the dispatch loop stacks a batch and
        queues its copy from pinned memory on the step's stream, queues
        step k+1 while step k runs (at most ``depth`` in flight), and
        resolves the oldest step (one host sync) only when the window is
        full."""
        dev = self.exe.device
        m = meter
        perf = time.perf_counter
        exe = self.exe
        pending = deque()  # (batch_id, batch_size, RunHandle, host_wall)
        pass_costs, pass_metrics = [], []
        # Goodput on the overlapped path: the host's waits overlap the
        # device's work, and once CUDA's launch queue is full the host
        # blocks inside dispatch. So device_compute is each step's span
        # on the device (RunHandle.device_seconds; on a host device, the
        # dispatch wall that ran the step), the stalls that drain the
        # window are timed as they are, data_wait counts only as far as
        # the device was left idle, and the rest of the pass's wall is
        # the host_dispatch residual.
        t_pass0 = perf()
        acc0 = m.total_seconds() if m is not None else 0.0
        data_wait = 0.0

        def resolve_oldest():
            batch_id, bs, handle, host_dt = pending.popleft()
            with profiler.timer("trainer/resolve"):
                cost, mvals = self._split(handle.result())
            device_dt = step_mfu = None
            if m is not None:
                device_dt = handle.device_seconds()
                if device_dt is None:
                    device_dt = host_dt
                m.account("device_compute", device_dt)
                step_mfu = m.note_step(device_dt)
            pass_costs.append(cost)
            pass_metrics.append(mvals)
            event_handler(evt.EndIteration(pass_id, batch_id, cost,
                                           mvals, batch_size=bs,
                                           host_wall_s=host_dt,
                                           device_wall_s=device_dt,
                                           mfu=step_mfu))
            if rs is not None:
                # defer: the scope already holds later dispatched steps'
                # state; the dispatch loop drains, then commits
                rs.after_step(pass_id, batch_id, bs, defer=True)

        stopped = False
        try:
            it = enumerate(reader())
            while True:
                # reading, stacking and queuing the copy = data wait
                t_read0 = perf()
                try:
                    batch_id, batch = next(it)
                    while batch_id < skip_n:
                        # consumed before the interrupt (resume replay)
                        batch_id, batch = next(it)
                except StopIteration:
                    data_wait += perf() - t_read0
                    break
                try:
                    bs = len(batch)
                except TypeError:
                    bs = None
                feed = _to_device(self.feeder.feed(batch), dev)
                data_wait += perf() - t_read0
                self._before_step(rs, m)
                event_handler(evt.BeginIteration(pass_id, batch_id))
                t_disp0 = perf()
                with profiler.timer("trainer/dispatch"):
                    handle = exe.run_async(self.main_program, feed=feed,
                                           fetch_list=self._fetch_list(),
                                           scope=self.scope)
                host_dt = perf() - t_disp0
                pending.append((batch_id, bs, handle, host_dt))
                while len(pending) >= depth:
                    resolve_oldest()
                if rs is not None and rs.pause_requested:
                    # checkpoint due / shutdown: drain the whole window so
                    # resolved == dispatched == scope state, then save
                    while pending:
                        resolve_oldest()
                    if self._commit(rs, m, pass_id):
                        stopped = True
                        break
            while pending:  # drain: every EndIteration precedes EndPass
                resolve_oldest()
            if not stopped and rs is not None and rs.pause_requested:
                self._commit(rs, m, pass_id)
            if m is not None:
                idle = perf() - t_pass0 - (m.total_seconds() - acc0)
                m.account("data_wait", min(data_wait, idle))
        except BaseException:
            # In-flight steps' state is in the scope already; resolve
            # their handles (cost/metrics + EndIteration each) so the
            # event stream stays consistent with the scope before
            # propagating. If the drain itself keeps failing (e.g. the
            # handler raises), wait for the remaining handles instead of
            # abandoning them mid-flight.
            while pending:
                try:
                    resolve_oldest()
                except BaseException:
                    for _, _, h, _ in pending:
                        try:
                            h.block()
                        except Exception:  # noqa: BLE001 - best effort
                            pass
                    pending.clear()
            raise
        return pass_costs, pass_metrics

    def test(self, reader: Callable) -> "evt.TestResult":
        self._init_params()
        costs, metrics = [], []
        for batch in reader():
            feed = self.feeder.feed(batch)
            fetched = self.exe.run(self.test_program, feed=feed,
                                   fetch_list=self._fetch_list(),
                                   scope=self.scope)
            cost, mvals = self._split(fetched)
            costs.append(cost)
            metrics.append(mvals)
        return evt.TestResult(float(np.mean(costs)) if costs else 0.0,
                              _mean_metrics(metrics))

    # ------------------------------------------------------------------
    def save_params(self, dirname: str):
        io_mod.save_params(self.exe, dirname, self.main_program,
                           scope=self.scope)

    def load_params(self, dirname: str):
        self._init_params()
        io_mod.load_params(self.exe, dirname, self.main_program,
                           scope=self.scope)


def _to_device(feed, device):
    """A feed's arrays as tensors on a CUDA ``device``, copied from
    pinned memory on the current stream: the copy does not wait for the
    steps queued before it (one from pageable memory would), and the step
    dispatched next on that stream reads the batch after it lands. On the
    host the executor takes the arrays as they are."""
    if device.type != "cuda":
        return feed
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
        device, non_blocking=True) for k, v in feed.items()}


def _default_log_handler():
    from .flags import FLAGS

    period = max(int(FLAGS.log_period), 1)

    def handler(e):
        if isinstance(e, evt.EndIteration) and e.batch_id % period == 0:
            extra = "".join(f" {k}={v:.4f}" for k, v in
                            (e.metrics or {}).items())
            print(f"pass {e.pass_id} batch {e.batch_id} "
                  f"cost={e.cost:.6f}{extra}", flush=True)
        elif isinstance(e, evt.EndPass):
            print(f"pass {e.pass_id} done: "
                  + " ".join(f"{k}={v:.6f}" for k, v in
                             (e.metrics or {}).items()), flush=True)

    return handler


def _mean_metrics(per_batch):
    out: Dict[str, float] = {}
    if per_batch:
        for key in per_batch[0]:
            out[key] = float(np.mean([m[key] for m in per_batch]))
    return out
