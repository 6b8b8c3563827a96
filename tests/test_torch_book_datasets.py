"""The port's six book datasets against the JAX package's, bit for bit.

``uci_housing``, ``imikolov``, ``movielens``, ``imdb``, ``conll05`` and
``wmt14`` of ``paddle_tpu_torch.dataset`` must yield the same samples as
``paddle_tpu.dataset``'s: every sample of every synthetic reader, equal
in type, dtype and value (numpy arrays by their bytes), the same dicts
and helper values, and the same counts. Then the real-corpus branches:
the small corpora of ``tests/test_dataset_real_formats.py`` are written
under ``tmp_path``, both packages' ``DATA_HOME`` point there, and the
readers and helpers of both parse them to the same values.
"""
import gzip
import io
import re
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu.dataset as jds
import paddle_tpu_torch.dataset as tds

torch.set_num_threads(1)


def _same(a, b, where="sample"):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a.items()) == list(b.items()), where
    else:
        assert a == b, (where, a, b)


def _same_reader(jr, tr, where):
    j, t = list(jr()), list(tr())
    assert len(j) == len(t), where
    for i, (x, y) in enumerate(zip(j, t)):
        _same(x, y, f"{where} #{i}")
    return len(t)


def test_uci_housing():
    assert tds.uci_housing.feature_names == jds.uci_housing.feature_names
    assert _same_reader(jds.uci_housing.train(), tds.uci_housing.train(),
                        "train") == 404
    assert _same_reader(jds.uci_housing.test(), tds.uci_housing.test(),
                        "test") == 102


def test_imikolov():
    jd, td = jds.imikolov.build_dict(), tds.imikolov.build_dict()
    _same(jd, td, "dict")
    for n in (2, 5):
        assert _same_reader(jds.imikolov.train(jd, n),
                            tds.imikolov.train(td, n), f"train n{n}") > 2048
        _same_reader(jds.imikolov.test(jd, n), tds.imikolov.test(td, n),
                     f"test n{n}")


def test_movielens():
    for fn in ("max_user_id", "max_movie_id", "max_job_id",
               "movie_categories", "get_movie_title_dict", "ctr_vocab_size"):
        _same(getattr(jds.movielens, fn)(), getattr(tds.movielens, fn)(), fn)
    _same(jds.movielens.age_table, tds.movielens.age_table, "age_table")
    assert _same_reader(jds.movielens.train(), tds.movielens.train(),
                        "train") == 8192
    assert _same_reader(jds.movielens.test(), tds.movielens.test(),
                        "test") == 1024
    _same_reader(jds.movielens.ctr_test(), tds.movielens.ctr_test(), "ctr")


def test_imdb():
    jd, td = jds.imdb.word_dict(), tds.imdb.word_dict()
    _same(jd, td, "dict")
    assert _same_reader(jds.imdb.train(jd), tds.imdb.train(td),
                        "train") == 2048
    assert _same_reader(jds.imdb.test(jd), tds.imdb.test(td), "test") == 256


def test_conll05():
    for j, t in zip(jds.conll05.get_dict(), tds.conll05.get_dict()):
        _same(j, t, "dict")
    _same(jds.conll05.get_embedding(), tds.conll05.get_embedding(), "emb")
    assert _same_reader(jds.conll05.test(), tds.conll05.test(),
                        "test") == 512


def test_wmt14():
    for size in (64, 256):
        for rev in (False, True):
            _same(jds.wmt14.get_dict(size, rev), tds.wmt14.get_dict(
                size, rev), f"dict {size} {rev}")
        assert _same_reader(jds.wmt14.train(size), tds.wmt14.train(size),
                            f"train {size}") == 2048
        assert _same_reader(jds.wmt14.test(size), tds.wmt14.test(size),
                            f"test {size}") == 256


# --- the real-corpus branches, on small corpora under tmp_path -------------
@pytest.fixture
def data_home(tmp_path, monkeypatch):
    for pkg in (jds, tds):
        monkeypatch.setattr(pkg.common, "DATA_HOME", str(tmp_path))
        monkeypatch.setattr(pkg.movielens, "_META", None)
    return tmp_path


def _add_text(tf, name, text):
    data = text.encode()
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def test_real_imdb(data_home):
    d = data_home / "imdb"
    d.mkdir()
    with tarfile.open(d / "aclImdb_v1.tar.gz", "w:gz") as tf:
        _add_text(tf, "aclImdb/train/pos/0_9.txt", "A great, GREAT movie!")
        _add_text(tf, "aclImdb/train/pos/1_8.txt", "great fun. great")
        _add_text(tf, "aclImdb/train/neg/0_2.txt", "terrible; awful film")
        _add_text(tf, "aclImdb/test/pos/0_10.txt", "great")
        _add_text(tf, "aclImdb/test/neg/0_1.txt", "awful")
    pattern = re.compile(r"aclImdb/train/.*\.txt$")
    jd = jds.imdb.build_dict(pattern, cutoff=0)
    td = tds.imdb.build_dict(pattern, cutoff=0)
    _same(jd, td, "dict")
    assert td["great"] == 0 and td["<unk>"] == len(td) - 1
    _same(jds.imdb.word_dict(), tds.imdb.word_dict(), "word_dict")
    assert _same_reader(jds.imdb.train(jd), tds.imdb.train(td), "train") == 3
    assert _same_reader(jds.imdb.test(jd), tds.imdb.test(td), "test") == 2


def test_real_movielens(data_home):
    d = data_home / "movielens"
    d.mkdir()
    movies = ("1::Toy Story (1995)::Animation|Comedy\n"
              "2::Jumanji (1995)::Adventure\n")
    users = "1::M::25::12::55117\n2::F::45::7::02460\n"
    ratings = "".join(f"{u}::{m}::{r}::97830\n"
                      for u, m, r in ((1, 1, 5), (1, 2, 3), (2, 1, 4),
                                      (2, 2, 2)) for _ in range(4))
    with zipfile.ZipFile(d / "ml-1m.zip", "w") as z:
        z.writestr("ml-1m/movies.dat", movies)
        z.writestr("ml-1m/users.dat", users)
        z.writestr("ml-1m/ratings.dat", ratings)
    for fn in ("max_user_id", "max_movie_id", "max_job_id",
               "movie_categories", "get_movie_title_dict", "ctr_vocab_size"):
        _same(getattr(jds.movielens, fn)(), getattr(tds.movielens, fn)(), fn)
    n = (_same_reader(jds.movielens.train(), tds.movielens.train(), "train")
         + _same_reader(jds.movielens.test(), tds.movielens.test(), "test"))
    assert n == 16
    _same_reader(jds.movielens.ctr_train(), tds.movielens.ctr_train(), "ctr")


def test_real_conll05(data_home):
    d = data_home / "conll05st"
    d.mkdir()
    (d / "wordDict.txt").write_text("<unk>\nthe\ncat\nsat\nquickly\n")
    (d / "verbDict.txt").write_text("<unk>\nsit\n")
    (d / "targetDict.txt").write_text("O\nB-A0\nI-A0\nB-V\nB-AM\n")
    words = "The\ncat\nsat\nquickly\n\nthe\ncat\nsat\n\n"
    props = ("- (A0*\n- *)\nsit (V*)\n- (AM*)\n\n"
             "- *\n- (A0*)\nsit (V*)\n\n")

    def gz(text):
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="w") as g:
            g.write(text.encode())
        return buf.getvalue()

    with tarfile.open(d / "conll05st-tests.tar.gz", "w:gz") as tf:
        for name, text in (
                ("conll05st-release/test.wsj/words/test.wsj.words.gz", words),
                ("conll05st-release/test.wsj/props/test.wsj.props.gz",
                 props)):
            data = gz(text)
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    for j, t in zip(jds.conll05.get_dict(), tds.conll05.get_dict()):
        _same(j, t, "dict")
    _same(jds.conll05.get_embedding(), tds.conll05.get_embedding(), "emb")
    assert _same_reader(jds.conll05.test(), tds.conll05.test(), "test") == 2
    w, *_, labels = next(iter(tds.conll05.test()()))
    assert w == [0, 2, 3, 4] and labels == [1, 2, 3, 4]


def test_real_wmt14(data_home):
    d = data_home / "wmt14"
    d.mkdir()
    with tarfile.open(d / "wmt14.tgz", "w:gz") as tf:
        _add_text(tf, "wmt14/train/src.dict", "<s>\n<e>\n<unk>\nle\nchat\nnoir\n")
        _add_text(tf, "wmt14/train/trg.dict",
                  "<s>\n<e>\n<unk>\nthe\ncat\nblack\n")
        _add_text(tf, "wmt14/train/train",
                  "le chat\tthe cat\nle noir inconnu\tthe black unknown\n")
        _add_text(tf, "wmt14/test/test", "le chat noir\tthe black cat\n")
    for rev in (False, True):
        _same(jds.wmt14.get_dict(6, rev), tds.wmt14.get_dict(6, rev), "dict")
    assert _same_reader(jds.wmt14.train(6), tds.wmt14.train(6), "train") == 2
    assert _same_reader(jds.wmt14.test(6), tds.wmt14.test(6), "test") == 1
    assert next(iter(tds.wmt14.train(6)()))[0] == [0, 3, 4, 1]


def test_real_imikolov(data_home):
    d = data_home / "imikolov"
    d.mkdir()
    with tarfile.open(d / "simple-examples.tgz", "w:gz") as tf:
        _add_text(tf, "./simple-examples/data/ptb.train.txt",
                  "the cat sat\nthe cat ran far\n")
        _add_text(tf, "./simple-examples/data/ptb.valid.txt", "the dog sat\n")
    jd = jds.imikolov.build_dict(min_word_freq=0)
    td = tds.imikolov.build_dict(min_word_freq=0)
    _same(jd, td, "dict")
    assert _same_reader(jds.imikolov.train(jd, 3), tds.imikolov.train(td, 3),
                        "train") == 7
    _same_reader(jds.imikolov.test(jd, 3), tds.imikolov.test(td, 3), "test")


def test_real_uci_housing(data_home):
    d = data_home / "uci_housing"
    d.mkdir()
    rows = (np.random.RandomState(0).rand(10, 14) * 10).round(4)
    (d / "housing.data").write_text(
        "\n".join(" ".join(f"{v:.4f}" for v in r) for r in rows) + "\n")
    assert _same_reader(jds.uci_housing.train(), tds.uci_housing.train(),
                        "train") == 8
    assert _same_reader(jds.uci_housing.test(), tds.uci_housing.test(),
                        "test") == 2


def test_synthetic_again_without_files(data_home):
    """An empty DATA_HOME: every reader serves its synthetic stream."""
    assert len(tds.imdb.word_dict()) == tds.imdb.VOCAB_SIZE
    assert len(next(iter(tds.conll05.test()()))) == 9
    assert tds.movielens.max_user_id() == tds.movielens.N_USERS
