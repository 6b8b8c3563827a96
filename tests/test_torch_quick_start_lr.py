"""v2's ``fc`` over sparse inputs and ``demos/quick_start.py``'s ``lr``
config: the port's v2 facade against the JAX package's on the CPU.

- An ``fc`` over a ``sparse_binary_vector``, a ``sparse_float_vector``
  and a dense input (one weight each, the bias on the dense sub-fc,
  joined by ``addto``): the same op types and parameters as JAX's, the
  feeder's padded id, length and value feeds equal JAX's, and from the
  JAX startup's values the forward within OUT_TOL of JAX's and one SGD
  step's weights within OUT_TOL. The sparse branches' embeddings keep a
  dense gradient, as the JAX package builds them.
- The ``lr`` demo (logistic regression over the bag of words of
  ``dataset.imdb``, ``bow_reader``'s view): the same program as JAX's,
  and from the same weights its first 5 losses on batches of 64 within
  LOSS_RTOL of JAX's, ``infer`` after them within OUT_TOL.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.v2 as jv2
import paddle_tpu_torch as tpt
import paddle_tpu_torch.v2 as tv2
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from test_torch_book import scopes
from test_torch_v2_demos import _losses

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
DIM, STEPS, BATCH = 50, 5, 64


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    tpt.flags.reset_flags()
    jpt.flags.reset_flags()


def _sparse_fc(pkg, v2):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = v2.layer.data("ids", v2.data_type.sparse_binary_vector(DIM))
        wts = v2.layer.data("wts", v2.data_type.sparse_float_vector(DIM))
        x = v2.layer.data("x", v2.data_type.dense_vector(4))
        out = v2.layer.fc(input=[ids, wts, x], size=3,
                          act=v2.activation.Tanh())
        loss = pkg.layers.mean(out)
        pkg.optimizer.SGDOptimizer(0.5).minimize(loss,
                                                 startup_program=startup)
    return main, startup, [ids, wts, x], out


def _rows(rng, n):
    rows = []
    for _ in range(n):
        k = rng.randint(1, 6)
        binary = sorted(rng.choice(DIM, k, replace=False).tolist())
        m = rng.randint(1, 5)
        floats = [(int(i), float(v)) for i, v in zip(
            rng.choice(DIM, m, replace=False), rng.randn(m))]
        rows.append((binary, floats, rng.rand(4).astype(np.float32)))
    return rows


def test_fc_over_sparse_inputs_matches_jax():
    tv2.init(use_gpu=False)
    uid = jprog.Program._uid_counter
    tprog.Program._uid_counter = uid
    jm, js, jfeeds, jout = _sparse_fc(jpt, jv2)
    tprog.Program._uid_counter = uid
    tm, ts, tfeeds, tout = _sparse_fc(tpt, tv2)
    types = [op.type for op in tm.global_block.ops]
    assert types == [op.type for op in jm.global_block.ops]
    assert types.count("addto") == 1 and types.count("lookup_table") == 2
    assert not any(op.attrs.get("is_sparse") for op in tm.global_block.ops
                   if op.type == "lookup_table")
    rows = _rows(np.random.RandomState(0), 6)
    feed = tpt.data_feeder.DataFeeder(tfeeds).feed(rows)
    jfeed = jpt.DataFeeder(jfeeds).feed(rows)
    assert sorted(feed) == sorted(jfeed) == ["ids", "ids@len", "wts",
                                             "wts@len", "wts@val", "x"]
    for k in feed:
        np.testing.assert_array_equal(feed[k], np.asarray(jfeed[k]),
                                      err_msg=k)
    jscope, tscope = scopes(js, ts)
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    params = [p.name for p in tm.global_block.all_parameters()]
    got, = texe.run(tm, feed=feed, fetch_list=[tout], scope=tscope)
    want, = jexe.run(jm, feed=jfeed, fetch_list=[jout], scope=jscope)
    np.testing.assert_allclose(got, np.asarray(want), **OUT_TOL)
    assert params
    for name in params:  # after the run's SGD step
        np.testing.assert_allclose(tscope.get_numpy(name),
                                   np.asarray(jscope.get(name)), **OUT_TOL)


def _lr(paddle, word_dim):
    """quick_start.py's ``build("lr", word_dim)``."""
    words = paddle.layer.data(
        "words", paddle.data_type.sparse_binary_vector(word_dim))
    output = paddle.layer.fc(input=words, size=2,
                             act=paddle.activation.Softmax())
    label = paddle.layer.data("label", paddle.data_type.integer_value(2))
    cost = paddle.layer.classification_cost(input=output, label=label)
    return cost, output


def _make(pkg, v2, word_dim):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        cost, out = _lr(v2, word_dim)
        params = v2.parameters.create(cost)
        trainer = v2.trainer.SGD(
            cost=cost, parameters=params,
            update_equation=v2.optimizer.Adam(learning_rate=2e-3))
    return main, params, trainer, out


def test_quick_start_lr_trains_as_jax():
    wd = jpt.dataset.imdb.word_dict()
    dim = len(wd)
    reader = jpt.dataset.imdb.train(wd)()
    rows = []
    for _ in range(STEPS * BATCH):  # quick_start.py's bow_reader
        ids, label = next(reader)
        rows.append((sorted(set(i for i in ids if i < dim)), label))
    batches = [rows[i * BATCH:(i + 1) * BATCH] for i in range(STEPS)]
    tv2.init(use_gpu=False, seed=7)
    jv2.init(seed=7)
    uid = jprog.Program._uid_counter
    tprog.Program._uid_counter = uid
    jmain, jparams, jtrainer, jout = _make(jpt, jv2, dim)
    tprog.Program._uid_counter = uid
    tmain, tparams, ttrainer, tout = _make(tpt, tv2, dim)
    assert ([op.type for op in tmain.global_block.ops]
            == [op.type for op in jmain.global_block.ops])
    jparams.init()
    tparams.init()
    for name in tparams.names():
        tparams.scope.set(name, torch.from_numpy(np.array(
            jparams.scope.get_numpy(name))))
    want = _losses(jtrainer, jv2, batches)
    got = _losses(ttrainer, tv2, batches)
    assert len(got) == STEPS and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    inputs = [(r[0],) for r in rows[:8]]
    np.testing.assert_allclose(
        np.asarray(tv2.infer(output_layer=tout, parameters=tparams,
                             input=inputs)),
        np.asarray(jv2.infer(output_layer=jout, parameters=jparams,
                             input=inputs)), **OUT_TOL)
