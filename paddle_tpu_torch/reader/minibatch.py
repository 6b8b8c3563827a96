"""Batching decorator. Counterpart of ``paddle_tpu/reader/minibatch.py``."""
from __future__ import annotations


def batch(reader, batch_size: int, drop_last: bool = False):
    """Group samples from ``reader`` into lists of ``batch_size``."""

    def batch_reader():
        b = []
        for d in reader():
            b.append(d)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
