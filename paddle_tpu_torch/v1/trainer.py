"""The v1 training entry point: what ``paddle_trainer --config=...`` did.

Counterpart of ``paddle_tpu/v1/trainer.py`` (reference
paddle/trainer/TrainerMain.cpp + Trainer.cpp, which drive passes over the
config's data provider, batching rows for the gradient machine).
:func:`train_from_config` parses the config, wires the provider into a
batched reader, builds the optimizer from settings() and runs the
executor's train loop: the whole v1 workflow in one call. The jobs run on
``CUDAPlace(0)`` unless the caller passes ``place`` (the CLI's
``--use_gpu=0``, the reference trainer's own flag, means ``CPUPlace()``).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from ..core.executor import CPUPlace, CUDAPlace, Executor
from ..core.scope import Scope
from ..data_feeder import DataFeeder
from ..reader.minibatch import batch as _batch
from . import data_provider as _dp
from .config_parser import ParsedConfig, parse_config


class V1DataFeeder(DataFeeder):
    """DataFeeder that also takes rows from PyDataProvider2 providers:
    dict rows (keyed by data-layer name) are put in feed order, and
    sparse *_sequence columns (per-timestep id lists) become [T, Kmax]
    with -1 padding before the base feeder pads the time axis."""

    def feed(self, data):
        names = [v.name for v in self.feed_vars]
        rows = [[row[n] for n in names] if isinstance(row, dict) else row
                for row in data]
        for i, var in enumerate(self.feed_vars):
            if not getattr(var, "sparse_seq", False):
                continue
            col = [row[i] for row in rows]
            kmax = max((len(ids) for seq in col for ids in seq),
                       default=1) or 1
            fixed = []
            for seq in col:
                arr = np.full((len(seq), kmax), -1, dtype=np.int64)
                for t, ids in enumerate(seq):
                    arr[t, :len(ids)] = ids
                fixed.append(arr)
            rows = [list(r) for r in rows]
            for r, arr in zip(rows, fixed):
                r[i] = arr
        return super().feed(rows)


def make_reader(parsed: ParsedConfig, split: str = "train"):
    """Batched reader over the config's define_py_data_sources2 sources:
    iterates the ``<split>_list`` file's data-file paths through the
    provider generator. Honors CACHE_PASS_IN_MEM."""
    ds = parsed.data_sources or {}
    provider = ds.get("provider")
    settings = ds.get("provider_settings")
    list_file = ds.get(f"{split}_list")
    if provider is None or list_file is None:
        raise ValueError(
            f"config has no usable {split} data source (module "
            f"{ds.get('module')!r} must expose a @provider {ds.get('obj')!r})")

    def resolve(path):
        """Relative data paths resolve against the CWD first (the
        reference trainer's contract: configs say './data/...' and
        paddle_trainer runs from the demo dir), then the config dir."""
        if os.path.isabs(path) or os.path.exists(path):
            return path
        alt = os.path.join(parsed.config_dir, path)
        return alt if os.path.exists(alt) else path

    list_file = resolve(list_file)
    cache = [] if provider.cache == _dp.CacheType.CACHE_PASS_IN_MEM else None
    batch_size = int(parsed.settings.get("batch_size", 100))

    def row_reader():
        if cache:
            yield from cache
            return
        with open(list_file) as fh:
            files = [ln.strip() for ln in fh if ln.strip()]
        for fname in files:
            for row in provider(settings, resolve(fname)):
                if cache is not None:
                    cache.append(row)
                yield row

    return _batch(row_reader, batch_size)


def _training_program(parsed: ParsedConfig):
    """Append the batch-mean cost, the backward and the updates to the
    parsed program; returns the mean cost. v1 cost layers are per row
    ([b, 1], e.g. a CRF's nll); the trainer optimizes their batch mean
    (reference Trainer.cpp cost averaging)."""
    from .. import layers as L
    from ..core.program import program_guard

    optimizer = parsed.build_optimizer()
    with program_guard(parsed.main_program, parsed.startup_program):
        cost = L.mean(parsed.cost)
        optimizer.minimize(cost, startup_program=parsed.startup_program)
    return cost


def train_from_config(config_file, config_arg_str: str = "",
                      num_passes: int = 1,
                      event_handler: Optional[Callable] = None,
                      scope: Optional[Scope] = None, place=None):
    """Parse and train: the ``paddle_trainer`` one-shot, on ``place``
    (``CUDAPlace(0)`` by default). Returns (parsed_config, scope,
    per-pass mean costs)."""
    parsed = parse_config(config_file, config_arg_str)
    cost = _training_program(parsed)
    scope = scope or Scope()
    exe = Executor(place)
    exe.run(parsed.startup_program, scope=scope)
    feeder = V1DataFeeder(parsed.input_vars)
    reader = make_reader(parsed)  # one reader: CACHE_PASS_IN_MEM replays
    pass_costs = []
    for pass_id in range(num_passes):
        costs = []
        for batch_id, rows in enumerate(reader()):
            out, = exe.run(parsed.main_program, feed=feeder.feed(rows),
                           fetch_list=[cost], scope=scope)
            costs.append(float(np.mean(np.asarray(out))))
            if event_handler is not None:
                event_handler({"pass": pass_id, "batch": batch_id,
                               "cost": costs[-1]})
        pass_costs.append(float(np.mean(costs)) if costs else 0.0)
    return parsed, scope, pass_costs


def time_from_config(config_file, config_arg_str: str = "",
                     n_batches: int = 5, warmup: int = 2, place=None):
    """The ``--job=time`` job (reference TrainerMain.cpp:58
    trainer.time()): times forward, backward and update over a few
    batches, each step synchronised with the device, and prints the wall
    ms a batch and the timer table. Returns the timing dict."""
    import time as _time

    from .. import profiler

    parsed = parse_config(config_file, config_arg_str)
    cost = _training_program(parsed)
    scope = Scope()
    exe = Executor(place)
    exe.run(parsed.startup_program, scope=scope)
    feeder = V1DataFeeder(parsed.input_vars)
    reader = make_reader(parsed)
    batches = []
    for rows in reader():
        batches.append(feeder.feed(rows))
        if len(batches) >= max(n_batches, warmup + 1):
            break
    if not batches:
        raise RuntimeError("--job=time: the train reader yielded no "
                           "batches")
    for i in range(warmup):
        exe.run(parsed.main_program, feed=batches[i % len(batches)],
                fetch_list=[cost], scope=scope)
    stats = profiler.StatSet()
    t0 = _time.perf_counter()
    for i in range(n_batches):
        with profiler.timer("train_step", stats, sync=True,
                            block_on=None):
            out, = exe.run(parsed.main_program,
                           feed=batches[i % len(batches)],
                           fetch_list=[cost], scope=scope,
                           return_numpy=False)
    np.asarray(out.cpu())
    total = _time.perf_counter() - t0
    result = {"batches": n_batches,
              "ms_per_batch": round(total / n_batches * 1e3, 3),
              "stats": stats.format()}
    print(f"--job=time: {n_batches} batches, "
          f"{result['ms_per_batch']} ms/batch")
    print(stats.format())
    return result


def test_from_config(config_file, config_arg_str: str = "", place=None):
    """The ``--job=test`` job: one forward pass over the test_list,
    reporting the mean cost (reference Trainer::test)."""
    parsed = parse_config(config_file, config_arg_str)
    scope = Scope()
    exe = Executor(place)
    exe.run(parsed.startup_program, scope=scope)
    feeder = V1DataFeeder(parsed.input_vars)
    split = "test"
    if not (parsed.data_sources or {}).get("test_list"):
        print("--job=test: config has no test_list; evaluating the "
              "train source")
        split = "train"
    reader = make_reader(parsed, split=split)
    costs = []
    for rows in reader():
        out, = exe.run(parsed.main_program, feed=feeder.feed(rows),
                       fetch_list=[parsed.cost], scope=scope)
        costs.append(float(np.mean(np.asarray(out))))
    mean = float(np.mean(costs)) if costs else 0.0
    print(f"--job=test: {len(costs)} batches, mean cost {mean:.6f}")
    return mean


def checkgrad_from_config(config_file, config_arg_str: str = "",
                          place=None):
    """The ``--job=checkgrad`` job (reference Trainer::checkGradient):
    finite-difference check of the config's cost gradients."""
    from .. import checkgrad as _cg
    from .. import layers as L
    from ..core.program import program_guard

    parsed = parse_config(config_file, config_arg_str)
    with program_guard(parsed.main_program, parsed.startup_program):
        cost = L.mean(parsed.cost)
    scope = Scope()
    exe = Executor(place)
    exe.run(parsed.startup_program, scope=scope)
    feeder = V1DataFeeder(parsed.input_vars)
    rows = next(iter(make_reader(parsed)()))
    kinks = []
    report = _cg.check_gradients(parsed.main_program, feeder.feed(rows),
                                 cost, scope=scope, executor=exe,
                                 startup_program=parsed.startup_program,
                                 kinks=kinks)
    for name, err in report:
        print(f"checkgrad {name}: max rel err {err:.2e}")
    if kinks:
        print(f"checkgrad: {len(kinks)} probe(s) reached across a kink "
              "and were held to one side's slope: "
              + ", ".join(f"{n}[{i}]" for n, i in kinks))
    return report


def _flag(value: str) -> bool:
    """A gflags-style boolean: 1/0, true/false, yes/no."""
    v = str(value).strip().lower()
    if v in ("1", "true", "t", "yes", "y"):
        return True
    if v in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"not a boolean: {value!r}")


def main(argv=None):
    """``python -m paddle_tpu_torch.v1.trainer --config=... --job=...``,
    the paddle_trainer command line (TrainerMain.cpp:32). Runs on the
    card; ``--use_gpu=0`` runs on the CPU."""
    import argparse

    p = argparse.ArgumentParser(prog="paddle_trainer")
    p.add_argument("--config", required=True)
    p.add_argument("--config_args", default="")
    p.add_argument("--job", default="train",
                   choices=["train", "test", "checkgrad", "time"])
    p.add_argument("--num_passes", type=int, default=1)
    p.add_argument("--use_gpu", type=_flag, default=True)
    args = p.parse_args(argv)
    place = CUDAPlace(0) if args.use_gpu else CPUPlace()
    if args.job == "train":
        _, _, costs = train_from_config(args.config, args.config_args,
                                        num_passes=args.num_passes,
                                        place=place)
        for i, c in enumerate(costs):
            print(f"pass {i}: mean cost {c:.6f}")
        return 0
    if args.job == "test":
        test_from_config(args.config, args.config_args, place=place)
        return 0
    if args.job == "checkgrad":
        checkgrad_from_config(args.config, args.config_args, place=place)
        return 0
    time_from_config(args.config, args.config_args, place=place)
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
