"""PTB language-model n-grams (reference python/paddle/v2/dataset/imikolov.py).

``build_dict()`` -> {word: idx}; ``train(word_idx, n)`` yields n-gram tuples
of ids (the word2vec book-test interface, imikolov.py reader_creator).
When the real ``simple-examples.tgz`` PTB corpus is present in the cache
dir it is parsed with the reference's rules (freq-cutoff dict over
train+valid with <s>/<e> counted per line and <unk> appended last,
n-gram windows over <s>-prefixed <e>-suffixed lines —
imikolov.py:35-103); otherwise a synthetic Markov-chain corpus with a
deterministic transition structure, so n-gram models (word2vec) have
real signal to fit.

Counterpart of ``paddle_tpu/dataset/imikolov.py``, ported whole: the synthetic
readers yield the same samples bit for bit (``common.synthetic_rng``),
and the real-corpus branches read the same files under ``common.DATA_HOME``.
"""
from __future__ import annotations

import collections
import os
import tarfile

import numpy as np

from . import common

__all__ = ["build_dict", "train", "test"]

_TRAIN_MEMBER = "./simple-examples/data/ptb.train.txt"
_TEST_MEMBER = "./simple-examples/data/ptb.valid.txt"


def _real_path():
    p = os.path.join(common.DATA_HOME, "imikolov", "simple-examples.tgz")
    return p if os.path.exists(p) else None


def _member(tf, name):
    try:
        return tf.extractfile(name)
    except KeyError:
        return tf.extractfile(name.lstrip("./"))


def _word_count(f, word_freq):
    for line in f:
        for w in line.decode("utf-8").strip().split():
            word_freq[w] += 1
        word_freq["<s>"] += 1
        word_freq["<e>"] += 1
    return word_freq


def _real_build_dict(min_word_freq):
    word_freq = collections.defaultdict(int)
    with tarfile.open(_real_path()) as tf:
        _word_count(_member(tf, _TRAIN_MEMBER), word_freq)
        _word_count(_member(tf, _TEST_MEMBER), word_freq)
    word_freq.pop("<unk>", None)  # re-added as the last index
    kept = sorted(((w, f) for w, f in word_freq.items()
                   if f > min_word_freq), key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _real_reader(member, word_idx, n):
    def reader():
        unk = word_idx["<unk>"]
        with tarfile.open(_real_path()) as tf:
            for line in _member(tf, member):
                words = (["<s>"] + line.decode("utf-8").strip().split()
                         + ["<e>"])
                if len(words) < n:
                    continue
                ids = [word_idx.get(w, unk) for w in words]
                for i in range(n, len(ids) + 1):
                    yield tuple(ids[i - n:i])

    return reader

VOCAB_SIZE = 256
TRAIN_SENTENCES = 2048
TEST_SENTENCES = 256


def build_dict(min_word_freq=50):
    if _real_path():
        return _real_build_dict(min_word_freq)
    d = {f"w{i}": i for i in range(VOCAB_SIZE - 2)}
    d["<s>"] = VOCAB_SIZE - 2
    d["<e>"] = VOCAB_SIZE - 1
    return d


def _transition(seed="imikolov-chain"):
    rng = common.synthetic_rng(seed)
    # each word strongly prefers 4 successors
    succ = rng.randint(0, VOCAB_SIZE - 2, size=(VOCAB_SIZE, 4))
    return succ


def _sentences(n, seed_name):
    succ = _transition()

    def gen():
        rng = common.synthetic_rng(seed_name)
        for _ in range(n):
            length = int(rng.randint(5, 20))
            w = int(rng.randint(0, VOCAB_SIZE - 2))
            sent = [w]
            for _ in range(length - 1):
                w = int(succ[w, rng.randint(0, 4)])
                sent.append(w)
            yield sent

    return gen


def _ngram_reader(n_sents, seed_name, word_idx, n):
    sents = _sentences(n_sents, seed_name)
    bos = len(word_idx) - 2
    eos = len(word_idx) - 1

    def reader():
        for sent in sents():
            # <s>*(n-1) + words + <e>, like the reference reader_creator
            padded = [bos] * (n - 1) + sent + [eos]
            for i in range(n - 1, len(padded)):
                yield tuple(padded[i - n + 1: i + 1])

    return reader


def train(word_idx, n):
    if _real_path():
        return _real_reader(_TRAIN_MEMBER, word_idx, n)
    return _ngram_reader(TRAIN_SENTENCES, "imikolov-train", word_idx, n)


def test(word_idx, n):
    if _real_path():
        return _real_reader(_TEST_MEMBER, word_idx, n)
    return _ngram_reader(TEST_SENTENCES, "imikolov-test", word_idx, n)
