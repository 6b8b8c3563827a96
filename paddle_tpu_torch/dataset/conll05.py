"""CoNLL-2005 semantic role labeling (reference v2/dataset/conll05.py API).

Samples are the reference's 9-feature SRL tuple ``(word_ids, ctx_n2,
ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids, mark, label_ids)``
(conll05.py:176 reader_creator yield order) consumed by the
label_semantic_roles book test. When the real corpus is present in the
cache dir (``conll05st-tests.tar.gz`` + the wordDict/verbDict/targetDict
text files), the bracket-tag props format is parsed with the reference's
own state machine (conll05.py:52-123); otherwise a synthetic fallback
whose tags follow a deterministic word-and-distance-to-predicate rule in
IOB space so the CRF tagger has learnable structure.

Counterpart of ``paddle_tpu/dataset/conll05.py``, ported whole: the synthetic
readers yield the same samples bit for bit (``common.synthetic_rng``),
and the real-corpus branches read the same files under ``common.DATA_HOME``.
"""
from __future__ import annotations

import gzip
import os
import tarfile

import numpy as np

from . import common

__all__ = ["get_dict", "get_embedding", "test", "load_dict"]

WORD_VOCAB = 512
PRED_VOCAB = 64
N_LABELS = 9  # 4 chunk types x B/I + O  (IOB encoding, tag 8 = O)
TEST_SIZE = 512

_DIR = "conll05st"
_TAR = "conll05st-tests.tar.gz"
_WORDS_NAME = "conll05st-release/test.wsj/words/test.wsj.words.gz"
_PROPS_NAME = "conll05st-release/test.wsj/props/test.wsj.props.gz"
UNK_IDX = 0


def _real_paths():
    d = os.path.join(common.DATA_HOME, _DIR)
    paths = {k: os.path.join(d, name) for k, name in
             (("tar", _TAR), ("word", "wordDict.txt"),
              ("verb", "verbDict.txt"), ("label", "targetDict.txt"))}
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    return None


def load_dict(filename):
    """Line-per-entry dict file -> {entry: line_no} (reference
    conll05.py:44 load_dict)."""
    d = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def _corpus_reader(data_path, words_name, props_name):
    """(sentence words, verb, bracket-decoded IOB label seq) triples —
    the reference's props state machine (conll05.py:52-123)."""

    def reader():
        with tarfile.open(data_path) as tf:
            wf = tf.extractfile(words_name)
            pf = tf.extractfile(props_name)
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                sentences, labels, one_seg = [], [], []
                for word, label in zip(words_file, props_file):
                    word = word.decode("utf-8").strip()
                    label = label.decode("utf-8").strip().split()
                    if not label:  # end of sentence
                        for i in range(len(one_seg[0]) if one_seg else 0):
                            labels.append([x[i] for x in one_seg])
                        if len(labels) >= 1:
                            verb_list = [x for x in labels[0] if x != "-"]
                            for i, lbl in enumerate(labels[1:]):
                                cur_tag, in_bracket = "O", False
                                lbl_seq = []
                                for l in lbl:
                                    if l == "*" and not in_bracket:
                                        lbl_seq.append("O")
                                    elif l == "*" and in_bracket:
                                        lbl_seq.append("I-" + cur_tag)
                                    elif l == "*)":
                                        lbl_seq.append("I-" + cur_tag)
                                        in_bracket = False
                                    elif "(" in l and ")" in l:
                                        cur_tag = l[1:l.find("*")]
                                        lbl_seq.append("B-" + cur_tag)
                                        in_bracket = False
                                    elif "(" in l:
                                        cur_tag = l[1:l.find("*")]
                                        lbl_seq.append("B-" + cur_tag)
                                        in_bracket = True
                                    else:
                                        raise RuntimeError(
                                            f"Unexpected label: {l}")
                                yield sentences, verb_list[i], lbl_seq
                        sentences, labels, one_seg = [], [], []
                    else:
                        sentences.append(word)
                        one_seg.append(label)

    return reader


def _real_reader(paths):
    word_dict = load_dict(paths["word"])
    predicate_dict = load_dict(paths["verb"])
    label_dict = load_dict(paths["label"])
    corpus = _corpus_reader(paths["tar"], _WORDS_NAME, _PROPS_NAME)

    def reader():
        for sentence, predicate, labels in corpus():
            sen_len = len(sentence)
            verb_index = labels.index("B-V")
            mark = [0] * len(labels)
            if verb_index > 0:
                mark[verb_index - 1] = 1
                ctx_n1 = sentence[verb_index - 1]
            else:
                ctx_n1 = "bos"
            if verb_index > 1:
                mark[verb_index - 2] = 1
                ctx_n2 = sentence[verb_index - 2]
            else:
                ctx_n2 = "bos"
            mark[verb_index] = 1
            ctx_0 = sentence[verb_index]
            if verb_index < len(labels) - 1:
                mark[verb_index + 1] = 1
                ctx_p1 = sentence[verb_index + 1]
            else:
                ctx_p1 = "eos"
            if verb_index < len(labels) - 2:
                mark[verb_index + 2] = 1
                ctx_p2 = sentence[verb_index + 2]
            else:
                ctx_p2 = "eos"
            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            yield (word_idx,
                   [word_dict.get(ctx_n2, UNK_IDX)] * sen_len,
                   [word_dict.get(ctx_n1, UNK_IDX)] * sen_len,
                   [word_dict.get(ctx_0, UNK_IDX)] * sen_len,
                   [word_dict.get(ctx_p1, UNK_IDX)] * sen_len,
                   [word_dict.get(ctx_p2, UNK_IDX)] * sen_len,
                   [predicate_dict.get(predicate)] * sen_len,
                   mark,
                   [label_dict.get(w) for w in labels])

    return reader


def get_dict():
    paths = _real_paths()
    if paths:
        return (load_dict(paths["word"]), load_dict(paths["verb"]),
                load_dict(paths["label"]))
    word_dict = {f"w{i}": i for i in range(WORD_VOCAB)}
    verb_dict = {f"v{i}": i for i in range(PRED_VOCAB)}
    label_dict = {}
    for c in range(4):
        label_dict[f"B-A{c}"] = 2 * c
        label_dict[f"I-A{c}"] = 2 * c + 1
    label_dict["O"] = 8
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Pretrained-style word embedding table [vocab, 32]: parsed from a
    whitespace-float ``emb`` file next to the real corpus when present,
    else deterministic synthetic SIZED TO THE ACTIVE DICT (so ids from
    get_dict() always index into it — with the real word dict loaded the
    table is [len(word_dict), 32], not the synthetic vocab)."""
    paths = _real_paths()
    emb_path = (os.path.join(common.DATA_HOME, _DIR, "emb")
                if paths else None)
    vocab = len(load_dict(paths["word"])) if paths else WORD_VOCAB
    if emb_path and os.path.exists(emb_path):
        try:
            table = np.loadtxt(emb_path, dtype=np.float32)
            if table.ndim == 2 and table.shape[0] >= vocab:
                return table[:vocab]
        except (ValueError, UnicodeDecodeError):
            pass  # the reference's emb is a binary Paddle parameter
            # file; fall through to a dict-sized synthetic table
    rng = common.synthetic_rng("conll05-emb")
    return rng.normal(0, 0.1, (vocab, 32)).astype(np.float32)


def _reader(n, seed_name):
    def reader():
        rng = common.synthetic_rng(seed_name)
        for _ in range(n):
            length = int(rng.randint(5, 18))
            words = rng.randint(0, WORD_VOCAB, size=length)
            pred_pos = int(rng.randint(0, length))
            pred = int(words[pred_pos] % PRED_VOCAB)
            # rule: arguments are 1-2 token spans adjacent to the predicate
            labels = np.full(length, 8, np.int64)  # O
            if pred_pos > 0:
                labels[pred_pos - 1] = 0  # B-A0
                if pred_pos > 1 and words[pred_pos - 2] % 2 == 0:
                    labels[pred_pos - 2] = 0
                    labels[pred_pos - 1] = 1  # I-A0
            if pred_pos + 1 < length:
                labels[pred_pos + 1] = 2  # B-A1
                if pred_pos + 2 < length and words[pred_pos + 2] % 2 == 1:
                    labels[pred_pos + 2] = 3  # I-A1
            ctx = []
            for off in (-2, -1, 0, 1, 2):
                p = min(max(pred_pos + off, 0), length - 1)
                ctx.append(int(words[p]))
            mark = (np.arange(length) == pred_pos).astype(np.int64)
            w = words.astype(np.int64).tolist()
            yield (w, [ctx[0]] * length, [ctx[1]] * length,
                   [ctx[2]] * length, [ctx[3]] * length, [ctx[4]] * length,
                   [pred] * length, mark.tolist(), labels.tolist())

    return reader


def test():
    paths = _real_paths()
    if paths:
        return _real_reader(paths)
    return _reader(TEST_SIZE, "conll05-test")
