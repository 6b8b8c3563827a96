"""The Paddle book's first chapters (``tests/test_book.py``) built with
each package and trained side by side on the CPU: fit_a_line on
uci_housing, word2vec on imikolov, the recommender on movielens, and
understand_sentiment (the sequence_conv classifier and the stacked LSTM)
on imdb.

Each chapter's program is built by the same function,
``tests/test_book.py``'s own code with ``pt`` set to either package (the
names agree when both packages' ``Program._uid_counter`` start equal). Each package runs its
startup (the RNG plane draws the same weights, checked bit for bit), the
JAX values are carried into the port's scope with ``scope_from_numpy``,
and both train ``STEPS`` steps on the same batches, which
``DataFeeder`` + ``minibatch.batch`` make from the chapter's reader, with
the chapter's batch size and optimizer. Every fetched value (the loss,
and the sentiment chapters' batch accuracy) is held at ``LOSS_RTOL`` of
JAX's; accuracies of a batch (counts over 32) equal JAX's.

The CRF (label_semantic_roles, the book's ``db_lstm``) and machine
translation chapters are in ``tests/test_torch_book_srl_mt.py``.
"""
import numpy as np
import torch

import paddle_tpu as jpt
import paddle_tpu.dataset  # noqa: F401  (pt.dataset for both packages)
import paddle_tpu.reader.decorator  # noqa: F401
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog

torch.set_num_threads(1)
STEPS = 4
LOSS_RTOL = 2e-5


# --- the chapters' programs, tests/test_book.py's code for either package --
def fit_a_line(pt):
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data("x", shape=[13])
        y = layers.data("y", shape=[1])
        pred = layers.fc(x, size=1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        pt.optimizer.SGDOptimizer(learning_rate=0.01).minimize(
            loss, startup_program=startup)
    return dict(main=main, startup=startup, feeds=[x, y], fetch=[loss],
                reader=pt.dataset.uci_housing.train(), batch=32)


def word2vec(pt):
    layers = pt.layers
    word_dict = pt.dataset.imikolov.build_dict()
    V, emb_dim, N = len(word_dict), 16, 5
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ws = [layers.data(f"w{i}", shape=[1], dtype="int64")
              for i in range(N - 1)]
        nxt = layers.data("next", shape=[1], dtype="int64")
        shared = pt.ParamAttr(name="shared_emb")
        embs = [layers.embedding(w, size=[V, emb_dim], param_attr=shared)
                for w in ws]
        concat = layers.concat(embs, axis=1)
        hidden = layers.fc(concat, size=64, act="relu")
        logits = layers.fc(hidden, size=V)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, nxt))
        pt.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(
            loss, startup_program=startup)
    reader = pt.reader.decorator.firstn(
        pt.dataset.imikolov.train(word_dict, N), 2000)
    return dict(main=main, startup=startup, feeds=ws + [nxt], fetch=[loss],
                reader=reader, batch=64)


def recommender(pt):
    layers = pt.layers
    ml = pt.dataset.movielens
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        uid = layers.data("uid", shape=[1], dtype="int64")
        gender = layers.data("gender", shape=[1], dtype="int64")
        age = layers.data("age", shape=[1], dtype="int64")
        job = layers.data("job", shape=[1], dtype="int64")
        mid = layers.data("mid", shape=[1], dtype="int64")
        score = layers.data("score", shape=[1])
        usr = layers.concat([
            layers.embedding(uid, size=[ml.max_user_id() + 1, 16]),
            layers.embedding(gender, size=[2, 4]),
            layers.embedding(age, size=[len(ml.age_table), 4]),
            layers.embedding(job, size=[ml.max_job_id() + 1, 8]),
        ], axis=1)
        mov = layers.embedding(mid, size=[ml.max_movie_id() + 1, 16])
        usr_f = layers.fc(usr, size=32, act="tanh")
        mov_f = layers.fc(mov, size=32, act="tanh")
        both = layers.concat([usr_f, mov_f], axis=1)
        pred = layers.fc(both, size=1)
        loss = layers.mean(layers.square_error_cost(pred, score))
        pt.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(
            loss, startup_program=startup)

    def reader():
        for (u, g, a, j, m, _c, _t, s) in ml.train()():
            yield u, g, a, j, m, s

    return dict(main=main, startup=startup,
                feeds=[uid, gender, age, job, mid, score], fetch=[loss],
                reader=reader, batch=64)


def sentiment_conv(pt):
    layers = pt.layers
    word_dict = pt.dataset.imdb.word_dict()
    V = len(word_dict)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        words = layers.data("words", shape=[1], dtype="int64", lod_level=1)
        label = layers.data("label", shape=[1], dtype="int64")
        emb = layers.embedding(words, size=[V, 16])
        emb.seq_len = words.seq_len
        conv3 = layers.sequence_conv(emb, num_filters=16, filter_size=3,
                                     act="tanh")
        pooled = layers.sequence_pool(conv3, "max")
        logits = layers.fc(pooled, size=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        pt.optimizer.AdamOptimizer(learning_rate=2e-2).minimize(
            loss, startup_program=startup)
    reader = pt.reader.decorator.firstn(pt.dataset.imdb.train(word_dict), 512)
    return dict(main=main, startup=startup, feeds=[words, label],
                fetch=[loss, acc], reader=reader, batch=32)


def sentiment_lstm(pt):
    layers = pt.layers
    word_dict = pt.dataset.imdb.word_dict()
    V = len(word_dict)
    hid = 32
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        words = layers.data("words", shape=[1], dtype="int64", lod_level=1)
        label = layers.data("label", shape=[1], dtype="int64")
        emb = layers.embedding(words, size=[V, 16])
        emb.seq_len = words.seq_len
        x1 = layers.fc(emb, size=4 * hid, num_flatten_dims=2,
                       bias_attr=False)
        x1.seq_len = words.seq_len
        h1, _ = layers.dynamic_lstm(x1, 4 * hid)
        x2 = layers.fc(h1, size=4 * hid, num_flatten_dims=2,
                       bias_attr=False)
        x2.seq_len = words.seq_len
        h2, _ = layers.dynamic_lstm(x2, 4 * hid, is_reverse=True)
        feat = layers.concat([layers.sequence_pool(h1, "max"),
                              layers.sequence_pool(h2, "max")], axis=1)
        logits = layers.fc(feat, size=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        pt.optimizer.AdamOptimizer(learning_rate=2e-2).minimize(
            loss, startup_program=startup)
    reader = pt.reader.decorator.firstn(pt.dataset.imdb.train(word_dict), 384)
    return dict(main=main, startup=startup, feeds=[words, label],
                fetch=[loss, acc], reader=reader, batch=32)


# --- running both packages ----------------------------------------------------
def build_both(make):
    start = jprog.Program._uid_counter
    built = {}
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        built[pt] = make(pt)
    j, t = built[jpt], built[tpt]
    # the port's chunk evaluator casts chunk_eval's int64 counts to its
    # int32 states: the one op JAX (whose counts are int32) does without
    ops = lambda b: [op.type for op in b["main"].global_block.ops  # noqa
                     if op.type != "cast"]
    assert ops(t) == ops(j)
    return j, t


def scopes(jstartup, tstartup):
    """(JAX scope, port scope) after each startup; the port's values are
    JAX's, carried over with ``scope_from_numpy``. The startups' outputs
    pair by op position (the learning-rate vars' names follow each
    backward's count of names)."""
    jscope = jpt.Scope()
    jpt.Executor(jpt.CPUPlace()).run(jstartup, scope=jscope)
    own = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(tstartup, scope=own)
    jops, tops = jstartup.global_block.ops, tstartup.global_block.ops
    assert [op.type for op in jops] == [op.type for op in tops]
    values = {}
    for jop, top in zip(jops, tops):
        for jn, tn in zip(jop.output_names(), top.output_names()):
            values[tn] = np.asarray(jscope.get(jn))
            # the RNG plane: the port's startup draws the same values
            np.testing.assert_array_equal(own.get_numpy(tn), values[tn],
                                          err_msg=tn)
    tscope = tpt.scope_from_numpy(values, "cpu")
    tscope.set(tprog.RNG_VAR, own.get(tprog.RNG_VAR))
    return jscope, tscope


def batches(built, steps):
    feeder = tpt.data_feeder.DataFeeder(built["feeds"])
    out = []
    for rows in tpt.reader.minibatch.batch(built["reader"], built["batch"])():
        out.append(feeder.feed(rows))
        if len(out) == steps:
            break
    return out


def train_both(j, t, steps=STEPS, jscope=None, tscope=None):
    """Both packages' fetches over the first ``steps`` batches:
    ([JAX values a step], [port values a step], scopes)."""
    if jscope is None:
        jscope, tscope = scopes(j["startup"], t["startup"])
    feeds = batches(t, steps)
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    jvals, tvals = [], []
    for feed in feeds:
        jvals.append([np.asarray(v) for v in jexe.run(
            j["main"], feed=feed, fetch_list=j["fetch"], scope=jscope)])
        tvals.append(texe.run(t["main"], feed=feed, fetch_list=t["fetch"],
                              scope=tscope))
    return jvals, tvals, (jscope, tscope)


def assert_losses(jvals, tvals, rtol=LOSS_RTOL):
    for step, (jv, tv) in enumerate(zip(jvals, tvals)):
        np.testing.assert_allclose(
            np.asarray(tv[0], np.float64), np.asarray(jv[0], np.float64),
            rtol=rtol, err_msg=f"step {step}")
        assert np.isfinite(tv[0]).all()


def test_fit_a_line():
    jvals, tvals, _ = train_both(*build_both(fit_a_line))
    assert_losses(jvals, tvals)


def test_word2vec():
    jvals, tvals, _ = train_both(*build_both(word2vec))
    assert_losses(jvals, tvals)


def test_recommender():
    jvals, tvals, _ = train_both(*build_both(recommender))
    assert_losses(jvals, tvals)


def test_understand_sentiment_conv():
    jvals, tvals, _ = train_both(*build_both(sentiment_conv))
    assert_losses(jvals, tvals)
    for jv, tv in zip(jvals, tvals):
        np.testing.assert_array_equal(tv[1], jv[1])


def test_understand_sentiment_stacked_lstm():
    jvals, tvals, _ = train_both(*build_both(sentiment_lstm), steps=3)
    assert_losses(jvals, tvals)
    for jv, tv in zip(jvals, tvals):
        np.testing.assert_array_equal(tv[1], jv[1])
