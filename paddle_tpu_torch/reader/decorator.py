"""Composable reader decorators.

Counterpart of ``paddle_tpu/reader/decorator.py``: ``map_readers``,
``buffered``, ``shuffle``, ``chain``, ``compose``, ``firstn``, ``cache``,
``bucket_by_length``, ``xmap_readers``, ``PipeReader`` and
``background_stage`` are the same pure-Python plumbing with the same
contracts. ``device_prefetch`` copies each feed onto a torch device from
pinned host memory on a side stream, and the consumer's stream waits for
that copy before it reads the batch. A *reader creator* is a zero-arg
callable returning an iterable of samples.
"""
from __future__ import annotations

import functools
import itertools
import queue
import random
import subprocess
import threading
import time
from typing import Any, Callable, List

__all__ = [
    "map_readers", "buffered", "bucket_by_length", "shuffle", "chain",
    "compose", "firstn", "xmap_readers", "cache", "PipeReader",
    "background_stage", "device_prefetch",
]


class _End:
    """Fill-thread sentinel: normal end of stream."""


class _Error:
    """Fill-thread sentinel: the source raised; re-raise in the consumer."""

    def __init__(self, exc):
        self.exc = exc


def background_stage(source, depth: int, transform: Callable = None):
    """Run ``source()`` (and optionally ``transform`` per item) on a
    background thread, staying up to ``depth`` items ahead of the
    consumer — the generic pipeline stage under ``buffered`` and
    ``device_prefetch``.

    Leak-safe: an abandoned consumer (early ``break``, GC of the
    generator) closes the stage — a stop flag is set and the queue
    drained so a fill thread parked on a full queue always unblocks and
    exits (one blocked inside ``source()`` itself is abandoned after a
    short deadline — closing must never hang on a stalled source);
    source errors propagate to the consumer instead of silently
    truncating the stream.
    """

    def staged():
        q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        stop = threading.Event()

        def fill():
            try:
                for d in source():
                    if stop.is_set():
                        return
                    q.put(transform(d) if transform is not None else d)
                    if stop.is_set():
                        return
                q.put(_End)
            except BaseException as exc:  # noqa: BLE001 - forwarded
                q.put(_Error(exc))

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        try:
            while True:
                e = q.get()
                if e is _End:
                    break
                if isinstance(e, _Error):
                    raise e.exc
                yield e
        finally:
            stop.set()
            # Unblock a fill() parked on a full queue: drain until the
            # thread has observed the stop flag and exited. Bounded: a
            # fill thread blocked inside source() itself (stalled pipe /
            # socket / slow reader) can't be interrupted from here — past
            # the deadline, abandon it (it's a daemon thread) rather than
            # hang the consumer's close/GC path.
            deadline = time.monotonic() + 0.5
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)

    return staged


def map_readers(func: Callable, *readers):
    """Apply func to the entries read from the given readers, zipped."""

    def reader():
        its = [r() for r in readers]
        for parts in zip(*its):
            yield func(*parts)

    return reader


def shuffle(reader, buf_size: int):
    """Shuffle within a sliding buffer of ``buf_size`` samples."""

    def shuffled():
        buf: List[Any] = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            random.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    """Concatenate readers back to back."""

    def reader():
        for r in readers:
            yield from r()

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment: bool = True):
    """Zip readers into combined tuples: (a, (b1, b2)) -> (a, b1, b2)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        its = [r() for r in readers]
        if check_alignment:
            for parts in zip(*its):
                yield sum((make_tuple(p) for p in parts), ())
            # detect ragged tails
            for it in its:
                if next(it, None) is not None:
                    raise ComposeNotAligned("readers have different lengths")
        else:
            for parts in zip(*its):
                yield sum((make_tuple(p) for p in parts), ())

    return reader


def bucket_by_length(reader, batch_size: int, key=None, buf_size: int = 1024,
                     shuffle_buckets: bool = True, seed: int = None,
                     pad_to_multiple: int = None):
    """Batch variable-length samples with like-length neighbours.

    Sorts a sliding ``buf_size`` window by ``key`` (default: len of the
    sample's first column), slices it into batches, and yields the batches
    in shuffled order so length doesn't correlate with training step. A
    padded batch costs max-length x batch FLOPs, so batching near-equal
    lengths recovers most of what ragged data loses.

    ``pad_to_multiple`` groups by length ROUNDED UP to the multiple (the
    serving engine's bucket-padding trick applied to training): paired
    with ``DataFeeder(pad_to_multiple=m)`` every batch pads to one of a
    handful of bucket lengths instead of its exact max, so a varlen run
    sees a bounded set of batch shapes.

    Returns a reader of BATCHES (lists of samples), like ``paddle.batch``.
    """
    key = key or (lambda sample: len(sample[0]))
    if pad_to_multiple and pad_to_multiple > 1:
        raw_key, m = key, int(pad_to_multiple)
        key = lambda sample: -(-raw_key(sample) // m) * m  # noqa: E731
    rng = random.Random(seed)

    def bucketed():
        buf: List[Any] = []

        def flush(buf, final):
            buf.sort(key=key)
            n_full = len(buf) // batch_size * batch_size
            batches = [buf[i:i + batch_size]
                       for i in range(0, n_full, batch_size)]
            if shuffle_buckets:
                rng.shuffle(batches)
            yield from batches
            # mid-stream remainders carry into the next window so every
            # batch but (at most) the epoch's last is full-sized
            if final and n_full < len(buf):
                yield buf[n_full:]
            else:
                buf[:n_full] = []

        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                yield from flush(buf, final=False)
        if buf:
            yield from flush(buf, final=True)

    return bucketed


def buffered(reader, size: int):
    """Prefetch up to ``size`` samples on a background thread (the
    DoubleBuffer analogue). Built on
    :func:`background_stage`, so abandoning the iterator early leaves no
    live fill thread."""
    return background_stage(reader, depth=size)


@functools.lru_cache(maxsize=None)
def _side_stream(device):
    """One copy stream per CUDA device, shared by every staged reader."""
    import torch

    return torch.cuda.Stream(device)


def _stage_to_device(feed, device):
    """Start copying a feed dict (numpy arrays or tensors) onto
    ``device``; returns ``(feed of device tensors, event or None)``.

    On a CUDA device the copies run on a side stream from pinned host
    memory, so they are asynchronous (a ``non_blocking`` copy from
    pageable memory is not) and overlap the compute stream's work; the
    event marks their end. Hand the pair to :func:`_landed` on the thread
    that reads the batch."""
    import numpy as np
    import torch

    dev = torch.device(device)
    host = {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in feed.items()}
    if dev.type != "cuda":
        return {k: t.to(dev) for k, t in host.items()}, None
    stream = _side_stream(dev)
    out = {}
    with torch.cuda.stream(stream):
        for k, t in host.items():
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            out[k] = t.to(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def _landed(feed, done):
    """Order the current stream after a :func:`_stage_to_device` copy:
    its kernels wait for ``done``, and each tensor is recorded as used
    by the current stream (the caching allocator may not hand its memory
    to the side stream again before that stream's work on it ends).
    Returns ``feed``."""
    if done is not None:
        import torch

        dev = next(iter(feed.values())).device
        current = torch.cuda.current_stream(dev)
        current.wait_event(done)
        for t in feed.values():
            t.record_stream(current)
    return feed


def device_prefetch(feed_reader, depth: int = 2, device=None):
    """Overlap host->device transfer with compute: yields feed dicts whose
    tensors are already on ``device`` (``cuda`` by default, raising
    without it), staying ``depth`` batches ahead on a background thread
    while the executor runs the current step. The copies leave pinned
    memory on a side stream; before a batch is yielded the consumer's
    stream is made to wait for its copy (:func:`_landed`), so a step can
    never read a batch that has not landed. The executor passes device
    tensors through without another copy.

    ``feed_reader()`` must yield {name: np.ndarray} dicts (e.g. a
    DataFeeder.feed applied to batches). Abandoning the iterator early
    leaves no fill thread alive (:func:`background_stage`).
    """
    from .. import resolve_device

    dev = resolve_device(device)
    staged = background_stage(
        feed_reader, depth=depth,
        transform=lambda feed: _stage_to_device(feed, dev))

    def prefetched():
        for feed, done in staged():
            yield _landed(feed, done)

    return prefetched


def firstn(reader, n: int):
    def reader_n():
        return itertools.islice(reader(), n)

    return reader_n


def cache(reader):
    """Materialise a reader once; replay from memory afterwards."""
    all_data: List[Any] = []
    loaded = [False]

    def cached():
        if not loaded[0]:
            for d in reader():
                all_data.append(d)
                yield d
            loaded[0] = True
        else:
            yield from all_data

    return cached


def xmap_readers(mapper: Callable, reader, process_num: int, buffer_size: int,
                 order: bool = False):
    """Parallel map over a reader with ``process_num`` worker threads."""

    def xreader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)
        end = object()

        def feed():
            for i, d in enumerate(reader()):
                in_q.put((i, d))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, d = item
                out_q.put((i, mapper(d)))

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()
        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            i, d = item
            if order:
                pending[i] = d
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
            else:
                yield d
        if order:
            for i in sorted(pending):
                yield pending[i]

    return xreader


class PipeReader:
    """Stream samples from a shell command's stdout
    (the reference's PipeReader)."""

    def __init__(self, command: str, bufsize: int = 8192, file_type: str = "plain"):
        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type

    def get_line(self, cut_lines: bool = True, line_break: bytes = b"\n"):
        proc = subprocess.Popen(self.command.split(), bufsize=self.bufsize,
                                stdout=subprocess.PIPE)
        remained = b""
        while True:
            buff = proc.stdout.read(self.bufsize)
            if not buff:
                break
            if cut_lines:
                lines = (remained + buff).split(line_break)
                remained = lines.pop()
                for line in lines:
                    yield line.decode()
            else:
                yield buff
        if remained:
            yield remained.decode()
