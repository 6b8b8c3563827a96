"""IMDB movie-review sentiment (reference python/paddle/v2/dataset/imdb.py).

``word_dict()`` -> {word: idx}; ``train(word_idx)``/``test(word_idx)`` yield
``(ids, 0|1)`` — the reference's tokenized-to-ids interface. When the real
``aclImdb_v1.tar.gz`` corpus is present in the cache dir it is parsed with
the reference's own pipeline (punctuation-stripped lowercase tokenization,
frequency-cutoff dictionary with ``<unk>``, pos=0 / neg=1 — imdb.py:37-126);
otherwise a deterministic synthetic set with two disjoint sentiment "topics"
so conv/LSTM classifiers genuinely learn the signal.

Counterpart of ``paddle_tpu/dataset/imdb.py``, ported whole: the synthetic
readers yield the same samples bit for bit (``common.synthetic_rng``),
and the real-corpus branches read the same files under ``common.DATA_HOME``.
"""
from __future__ import annotations

import collections
import os
import re
import string
import tarfile

import numpy as np

from . import common

__all__ = ["word_dict", "build_dict", "train", "test"]

VOCAB_SIZE = 2048
TRAIN_SIZE = 2048
TEST_SIZE = 256

_TAR = "aclImdb_v1.tar.gz"
_PUNCT = str.maketrans("", "", string.punctuation)


def _real_path():
    p = os.path.join(common.DATA_HOME, "imdb", _TAR)
    return p if os.path.exists(p) else None


def _tokenize(pattern):
    """Tokenized docs for member files matching ``pattern`` (reference
    imdb.py:37 tokenize — sequential tarfile.next access)."""
    with tarfile.open(_real_path()) as tarf:
        tf = tarf.next()
        while tf is not None:
            if pattern.match(tf.name):
                text = tarf.extractfile(tf).read().decode(
                    "utf-8", errors="ignore")
                yield text.rstrip("\n\r").translate(_PUNCT).lower().split()
            tf = tarf.next()


def build_dict(pattern, cutoff):
    """{word: id} from the real corpus: keep words with freq > cutoff,
    ordered by (-freq, word), then append <unk> (reference imdb.py:60)."""
    word_freq = collections.defaultdict(int)
    for doc in _tokenize(pattern):
        for word in doc:
            word_freq[word] += 1
    kept = sorted(((w, f) for w, f in word_freq.items() if f > cutoff),
                  key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def word_dict():
    """{word: idx}; real corpus dictionary when present (cutoff 150, the
    reference's), else the synthetic vocabulary."""
    if _real_path():
        return build_dict(
            re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"),
            150)
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _real_reader(pos_pattern, neg_pattern, word_idx, seed_name):
    unk = word_idx["<unk>"]
    cache = []  # built on first pass (reference builds INS at creator
    # time; lazy here so creating a reader stays free of tarball IO)

    def reader():
        if not cache:
            for pattern, label in ((pos_pattern, 0), (neg_pattern, 1)):
                for doc in _tokenize(pattern):
                    cache.append(([word_idx.get(w, unk) for w in doc],
                                  label))
        # the reference random.shuffles; deterministic here
        order = common.synthetic_rng(seed_name).permutation(len(cache))
        for i in order:
            yield cache[i]

    return reader


def _synthetic_reader(n, seed_name, word_idx):
    v = len(word_idx)
    pos_words = np.arange(0, v // 4)
    neg_words = np.arange(v // 4, v // 2)
    common_words = np.arange(v // 2, v)

    def reader():
        rng = common.synthetic_rng(seed_name)
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 64))
            topic = pos_words if label else neg_words
            n_topic = max(1, length // 4)
            ids = np.concatenate([
                rng.choice(topic, size=n_topic),
                rng.choice(common_words, size=length - n_topic),
            ])
            rng.shuffle(ids)
            yield ids.astype(np.int64).tolist(), label

    return reader


def train(word_idx):
    if _real_path():
        return _real_reader(re.compile(r"aclImdb/train/pos/.*\.txt$"),
                            re.compile(r"aclImdb/train/neg/.*\.txt$"),
                            word_idx, "imdb-train-order")
    return _synthetic_reader(TRAIN_SIZE, "imdb-train", word_idx)


def test(word_idx):
    if _real_path():
        return _real_reader(re.compile(r"aclImdb/test/pos/.*\.txt$"),
                            re.compile(r"aclImdb/test/neg/.*\.txt$"),
                            word_idx, "imdb-test-order")
    return _synthetic_reader(TEST_SIZE, "imdb-test", word_idx)
