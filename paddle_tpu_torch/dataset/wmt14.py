"""WMT-14 FR->EN translation (reference v2/dataset/wmt14.py API).

``train(dict_size)``/``test(dict_size)`` yield ``(src_ids, trg_ids,
trg_next_ids)`` with <s>/<e>/<unk> at ids 0/1/2 (wmt14.py START/END/UNK).
When the real ``wmt14.tgz`` shrunk corpus is present in the cache dir it
is parsed with the reference's rules (src.dict/trg.dict truncated to
dict_size, tab-separated parallel lines, >80-token pairs dropped,
<s>/<e> framing — wmt14.py:45-103); otherwise a synthetic fallback whose
"translation" is a deterministic word-for-word map with local reordering
— a seq2seq model can genuinely learn it.

Counterpart of ``paddle_tpu/dataset/wmt14.py``, ported whole: the synthetic
readers yield the same samples bit for bit (``common.synthetic_rng``),
and the real-corpus branches read the same files under ``common.DATA_HOME``.
"""
from __future__ import annotations

import os
import tarfile

import numpy as np

from . import common

__all__ = ["train", "test", "get_dict"]

START = 0  # <s>
END = 1    # <e>
UNK = 2    # <unk>
TRAIN_SIZE = 2048
TEST_SIZE = 256


def _word_map(dict_size):
    rng = common.synthetic_rng("wmt14-map")
    # bijective map over the content vocabulary [3, dict_size)
    content = np.arange(3, dict_size)
    perm = content.copy()
    rng.shuffle(perm)
    table = np.arange(dict_size)
    table[content] = perm
    return table


def _reader(n, seed_name, dict_size):
    table = _word_map(dict_size)

    def reader():
        rng = common.synthetic_rng(seed_name)
        for _ in range(n):
            length = int(rng.randint(3, 12))
            src = rng.randint(3, dict_size, size=length)
            trg = table[src]
            # local reordering: swap adjacent pairs deterministically
            for i in range(0, length - 1, 2):
                if src[i] % 2 == 0:
                    trg[i], trg[i + 1] = trg[i + 1], trg[i]
            src_ids = src.astype(np.int64).tolist()
            trg_in = [START] + trg.astype(np.int64).tolist()
            trg_next = trg.astype(np.int64).tolist() + [END]
            yield src_ids, trg_in, trg_next

    return reader


def _real_path():
    p = os.path.join(common.DATA_HOME, "wmt14", "wmt14.tgz")
    return p if os.path.exists(p) else None


def _read_to_dict(tar_file, dict_size):
    """First dict_size lines of the in-tar src.dict/trg.dict files
    (reference wmt14.py:45 __read_to_dict__)."""
    def to_dict(fd, size):
        out = {}
        for line_count, line in enumerate(fd):
            if line_count >= size:
                break
            out[line.decode("utf-8").strip()] = line_count
        return out

    with tarfile.open(tar_file, mode="r") as f:
        src_name, = [m.name for m in f if m.name.endswith("src.dict")]
        src_dict = to_dict(f.extractfile(src_name), dict_size)
        trg_name, = [m.name for m in f if m.name.endswith("trg.dict")]
        trg_dict = to_dict(f.extractfile(trg_name), dict_size)
    return src_dict, trg_dict


def _real_reader(tar_file, file_name, dict_size):
    def reader():
        src_dict, trg_dict = _read_to_dict(tar_file, dict_size)
        start, end = "<s>", "<e>"
        with tarfile.open(tar_file, mode="r") as f:
            names = [m.name for m in f if m.name.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    parts = line.decode("utf-8").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_words = parts[0].split()
                    src_ids = [src_dict.get(w, UNK)
                               for w in [start] + src_words + [end]]
                    trg_words = parts[1].split()
                    trg_ids = [trg_dict.get(w, UNK) for w in trg_words]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    yield (src_ids, [trg_dict[start]] + trg_ids,
                           trg_ids + [trg_dict[end]])

    return reader


def get_dict(dict_size, reverse=False):
    """(src_dict, trg_dict) — real in-tar dicts when present, else the
    synthetic id-named vocabulary (reference wmt14.py get_dict)."""
    if _real_path():
        src_dict, trg_dict = _read_to_dict(_real_path(), dict_size)
    else:
        src_dict = {("<s>" if i == 0 else "<e>" if i == 1 else
                     "<unk>" if i == 2 else f"w{i}"): i
                    for i in range(dict_size)}
        trg_dict = dict(src_dict)
    if reverse:
        return ({v: k for k, v in src_dict.items()},
                {v: k for k, v in trg_dict.items()})
    return src_dict, trg_dict


def train(dict_size):
    if _real_path():
        return _real_reader(_real_path(), "train/train", dict_size)
    return _reader(TRAIN_SIZE, "wmt14-train", dict_size)


def test(dict_size):
    if _real_path():
        return _real_reader(_real_path(), "test/test", dict_size)
    return _reader(TEST_SIZE, "wmt14-test", dict_size)
