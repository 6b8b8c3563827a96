"""The port's ``dataset.ctr`` against the JAX package's: the same seed
name gives the same click-stream bit for bit (ids, dense features,
labels, dtypes), the shard names are equal, a shard replays from its
name alone, and ``make_batch`` stacks the same feeds."""
import numpy as np
import pytest

from paddle_tpu.dataset import ctr as jctr
from paddle_tpu_torch.dataset import ctr as tctr


def _eq_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_constants():
    for name in ("SLOTS", "DENSE_DIM", "VOCAB_SIZE", "HOT_IDS",
                 "HOT_FRACTION"):
        assert getattr(tctr, name) == getattr(jctr, name), name
    assert tctr.__all__ == jctr.__all__


@pytest.mark.parametrize("n,vocab,seed", [(64, 1000, "ctr-train"),
                                          (300, 150, "other"),
                                          (512, 10 ** 6, "ctr-train")])
def test_train_stream_bit_for_bit(n, vocab, seed):
    got = list(tctr.train(n, vocab=vocab, seed=seed)())
    _eq_rows(got, list(jctr.train(n, vocab=vocab, seed=seed)()))
    ids = np.stack([r[0] for r in got])
    assert ids.dtype == np.int64 and ids.max() < vocab
    if vocab > tctr.HOT_IDS:  # most lookups hit the hot set
        assert (ids < tctr.HOT_IDS).mean() > 0.85


def test_task_descs_and_replay():
    descs = tctr.task_descs(3, records_per_shard=40, vocab=5000)
    assert descs == jctr.task_descs(3, records_per_shard=40, vocab=5000)
    for d in descs:
        first = list(tctr.task_reader(d))
        _eq_rows(first, list(jctr.task_reader(d)))
        _eq_rows(list(tctr.task_reader(d)), first)  # a replay
    with pytest.raises(ValueError, match="not a ctr"):
        list(tctr.task_reader("mnist:0:4:4"))


def test_make_batch():
    rows = list(tctr.train(16, vocab=300)())
    got, want = tctr.make_batch(rows), jctr.make_batch(rows)
    assert sorted(got) == ["dense", "ids", "label"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["ids"].shape == (16, tctr.SLOTS)
    assert got["label"].shape == (16, 1)
