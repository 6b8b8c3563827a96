"""MovieLens-1M recommender data (reference v2/dataset/movielens.py API).

Samples are ``(user_id, gender_id, age_id, job_id, movie_id, category_ids,
title_ids, score)`` — the recommender book-test feature tuple. When the
real ``ml-1m.zip`` is present in the cache dir its '::'-separated
movies/users/ratings .dat files are parsed with the reference's rules
(title-year stripping, age bucketing via age_table, deterministic
0.1 train/test ratings split — movielens.py:101-160); otherwise a
low-rank latent-factor synthetic model generates consistent ratings, so
matrix-factorisation models can actually fit.

Counterpart of ``paddle_tpu/dataset/movielens.py``, ported whole: the synthetic
readers yield the same samples bit for bit (``common.synthetic_rng``),
and the real-corpus branches read the same files under ``common.DATA_HOME``.
"""
from __future__ import annotations

import os
import random
import re
import zipfile

import numpy as np

from . import common

__all__ = ["train", "test", "max_user_id", "max_movie_id", "max_job_id",
           "age_table", "movie_categories", "get_movie_title_dict",
           "ctr_train", "ctr_test", "ctr_vocab_size", "CTR_DENSE_DIM"]

N_USERS = 512
N_MOVIES = 256
N_JOBS = 21
N_CATEGORIES = 18
TITLE_VOCAB = 512
RANK = 6
TRAIN_SIZE = 8192
TEST_SIZE = 1024

age_table = [1, 18, 25, 35, 45, 50, 56]

_META = None  # (movies {mid: (cats, title_ids)}, users {uid: tuple},
#                title_dict, cat_dict) from the real zip, once parsed


def _real_path():
    p = os.path.join(common.DATA_HOME, "movielens", "ml-1m.zip")
    return p if os.path.exists(p) else None


def _meta():
    """Parse movies.dat/users.dat from the real zip (reference
    __initialize_meta_info__)."""
    global _META
    if _META is not None:
        return _META
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    movies, users = {}, {}
    title_words, cat_names = set(), set()
    raw_movies = []
    with zipfile.ZipFile(_real_path()) as pkg:
        with pkg.open("ml-1m/movies.dat") as f:
            for line in f:
                mid, title, cats = line.decode(
                    "latin1").strip().split("::")
                cats = cats.split("|")
                title = pattern.match(title).group(1)
                raw_movies.append((int(mid), cats, title))
                cat_names.update(cats)
                title_words.update(w.lower() for w in title.split())
        cat_dict = {c: i for i, c in enumerate(sorted(cat_names))}
        title_dict = {w: i for i, w in enumerate(sorted(title_words))}
        for mid, cats, title in raw_movies:
            movies[mid] = ([cat_dict[c] for c in cats],
                           [title_dict[w.lower()] for w in title.split()])
        with pkg.open("ml-1m/users.dat") as f:
            for line in f:
                uid, gender, age, job, _zip = line.decode(
                    "latin1").strip().split("::")
                users[int(uid)] = (int(uid), 0 if gender == "M" else 1,
                                   age_table.index(int(age)), int(job))
    _META = (movies, users, title_dict, cat_dict)
    return _META


def max_user_id():
    if _real_path():
        return max(_meta()[1])
    return N_USERS


def max_movie_id():
    if _real_path():
        return max(_meta()[0])
    return N_MOVIES


def max_job_id():
    if _real_path():
        return max(u[3] for u in _meta()[1].values())
    return N_JOBS - 1


def movie_categories():
    if _real_path():
        return dict(_meta()[3])
    return {f"cat{i}": i for i in range(N_CATEGORIES)}


def get_movie_title_dict():
    if _real_path():
        return dict(_meta()[2])
    return {f"t{i}": i for i in range(TITLE_VOCAB)}


def _real_reader(is_test, test_ratio=0.1, rand_seed=0):
    """Ratings stream from the real zip; the same deterministic
    rand.random() < test_ratio row split as the reference __reader__."""

    def reader():
        movies, users, _, _ = _meta()
        rand = random.Random(x=rand_seed)
        with zipfile.ZipFile(_real_path()) as pkg:
            with pkg.open("ml-1m/ratings.dat") as f:
                for line in f:
                    if (rand.random() < test_ratio) != is_test:
                        continue
                    uid, mid, score, _ts = line.decode(
                        "latin1").strip().split("::")
                    uid, mid = int(uid), int(mid)
                    cats, titles = movies[mid]
                    u = users[uid]
                    yield (u[0], u[1], u[2], u[3], mid, cats, titles,
                           float(score))

    return reader


def _factors():
    rng = common.synthetic_rng("movielens-factors")
    u = rng.normal(0, 1, (N_USERS + 1, RANK))
    m = rng.normal(0, 1, (N_MOVIES + 1, RANK))
    return u, m


def _movie_meta():
    rng = common.synthetic_rng("movielens-meta")
    cats = [rng.randint(0, N_CATEGORIES,
                        size=rng.randint(1, 4)).tolist()
            for _ in range(N_MOVIES + 1)]
    titles = [rng.randint(0, TITLE_VOCAB,
                          size=rng.randint(2, 6)).tolist()
              for _ in range(N_MOVIES + 1)]
    return cats, titles


def _reader(n, seed_name):
    u_f, m_f = _factors()
    cats, titles = _movie_meta()

    def reader():
        rng = common.synthetic_rng(seed_name)
        for _ in range(n):
            uid = int(rng.randint(1, N_USERS + 1))
            mid = int(rng.randint(1, N_MOVIES + 1))
            raw = float(u_f[uid] @ m_f[mid]) / RANK ** 0.5
            score = float(np.clip(np.round(3.0 + 1.5 * raw), 1, 5))
            gender = uid % 2
            age = int(rng.randint(0, len(age_table)))
            job = uid % N_JOBS
            yield (uid, gender, age, job, mid, cats[mid], titles[mid], score)

    return reader


def train():
    if _real_path():
        return _real_reader(is_test=False)
    return _reader(TRAIN_SIZE, "movielens-train")


def test():
    if _real_path():
        return _real_reader(is_test=True)
    return _reader(TEST_SIZE, "movielens-test")


# ---------------------------------------------------------------------------
# CTR impressions through the varlen plane: each rating
# becomes one impression whose sparse features are a single VARIABLE-
# LENGTH id list — the fixed slots (user, gender, age, job, movie) plus
# every category id and title word, each slot offset into its own
# disjoint band of one shared vocabulary. The ragged lists flow through
# reader.bucket_by_length + DataFeeder(pad_to_multiple=...) into an
# embedding + sequence_pool CTR tower; the label is click/no-click
# (score >= 4). Works identically off the real ml-1m.zip or the
# synthetic fallback — tests never touch the network.
# ---------------------------------------------------------------------------

CTR_DENSE_DIM = 4


def _ctr_bands():
    """(band base offsets, total vocab) for the shared id space."""
    n_users = max_user_id() + 1
    n_movies = max_movie_id() + 1
    n_jobs = max_job_id() + 1
    n_cats = len(movie_categories())
    n_title = len(get_movie_title_dict())
    bases = {}
    off = 0
    for name, size in (("user", n_users), ("gender", 2),
                       ("age", len(age_table)), ("job", n_jobs),
                       ("movie", n_movies), ("category", n_cats),
                       ("title", n_title)):
        bases[name] = off
        off += size
    return bases, off


def ctr_vocab_size() -> int:
    return _ctr_bands()[1]


def _ctr_reader(base_reader):
    bases, _ = _ctr_bands()

    def reader():
        for (uid, gender, age, job, mid, cats, titles,
             score) in base_reader():
            ids = [bases["user"] + uid, bases["gender"] + gender,
                   bases["age"] + age, bases["job"] + job,
                   bases["movie"] + mid]
            ids += [bases["category"] + c for c in cats]
            ids += [bases["title"] + t for t in titles]
            dense = np.asarray(
                [age / len(age_table), gender,
                 len(cats) / 6.0, len(titles) / 8.0], np.float32)
            label = np.asarray([1.0 if score >= 4.0 else 0.0],
                               np.float32)
            yield np.asarray(ids, np.int64), dense, label

    return reader


def ctr_train():
    """Varlen CTR impressions: ``(id_list int64[varlen],
    dense float32[CTR_DENSE_DIM], click float32[1])`` rows."""
    return _ctr_reader(train())


def ctr_test():
    return _ctr_reader(test())
