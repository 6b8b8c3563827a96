"""Synthetic CTR click-stream, the Wide&Deep flagship's data.

Counterpart of ``paddle_tpu/dataset/ctr.py``: the same (sparse slot ids,
dense features, click label) impressions, bit for bit, for the same seed
name. Id popularity is Zipf-like (90% of lookups hit 200 hot ids while
the vocabulary stays large), and the click probability follows a few
"magic" id buckets and one dense feature, so AUC is learnable within a
short run. ``task_descs(n)`` names shards (``ctr:<shard>:<n>:<vocab>``)
and ``task_reader(desc)`` regenerates a shard's records from its name
alone, so a replayed shard gives the same records.

Samples: (ids int64[SLOTS], dense float32[DENSE_DIM], label float32[1]).
"""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ["SLOTS", "DENSE_DIM", "VOCAB_SIZE", "train", "task_descs",
           "task_reader", "make_batch"]

SLOTS = 8
DENSE_DIM = 4
VOCAB_SIZE = 100_000
HOT_IDS = 200          # the hot set most impressions hit
HOT_FRACTION = 0.9


def _impressions(rng: np.random.RandomState, n: int, vocab: int):
    """n impressions as (ids [n, SLOTS], dense [n, DENSE_DIM],
    label [n, 1])."""
    hot = rng.randint(0, min(HOT_IDS, vocab), size=(n, SLOTS))
    cold = rng.randint(0, vocab, size=(n, SLOTS))
    ids = np.where(rng.rand(n, SLOTS) < HOT_FRACTION, hot,
                   cold).astype(np.int64)
    dense = rng.rand(n, DENSE_DIM).astype(np.float32)
    # clickiness: a few magic id buckets and one dense feature
    signal = (ids % 7 == 3).sum(1) * 0.8 + dense[:, 0] * 2.0 - 2.2
    prob = 1.0 / (1.0 + np.exp(-signal))
    label = (rng.rand(n) < prob).astype(np.float32)[:, None]
    return ids, dense, label


def train(n: int = 4096, vocab: int = VOCAB_SIZE, seed: str = "ctr-train"):
    """A bounded reader of ``n`` (ids, dense, label) samples."""

    def reader():
        ids, dense, label = _impressions(common.synthetic_rng(seed), n,
                                         vocab)
        for i in range(n):
            yield ids[i], dense[i], label[i]

    return reader


def task_descs(n_shards: int, records_per_shard: int = 256,
               vocab: int = VOCAB_SIZE):
    """Shard names ``ctr:<shard>:<n>:<vocab>``; each determines its
    records."""
    return [f"ctr:{i}:{int(records_per_shard)}:{int(vocab)}"
            for i in range(n_shards)]


def task_reader(desc: str):
    """The records of one shard name."""
    tag, shard, n, vocab = desc.split(":")
    if tag != "ctr":
        raise ValueError(f"not a ctr task desc: {desc!r}")
    n, vocab = int(n), int(vocab)
    ids, dense, label = _impressions(
        common.synthetic_rng(f"ctr-shard-{shard}"), n, vocab)
    return ((ids[i], dense[i], label[i]) for i in range(n))


def make_batch(rows):
    """Stack (ids, dense, label) rows into the feeds a wide_deep program
    wants: {'ids', 'dense', 'label'}."""
    return {"ids": np.stack([r[0] for r in rows]),
            "dense": np.stack([r[1] for r in rows]),
            "label": np.stack([r[2] for r in rows])}
