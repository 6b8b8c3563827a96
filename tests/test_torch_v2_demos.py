"""The three v2 demos' programs and first losses: the port's v2 facade
(paddle_tpu_torch.v2) against the JAX package's (paddle_tpu.v2) on the
CPU.

Each of ``demos/mnist_v2.py``, ``demos/traffic_prediction.py`` and
``demos/quick_start.py`` (its ``cnn`` and ``lstm`` configs) is built in
both packages from the demo's own topology (copied here: the demos
import the JAX package), with the name counters synced: the same op
types in the same order, and the same parameter names and shapes. The
JAX startup's state is carried into the port's scope by name, both
train 5 batches of the demo's own size (a fixed reader in place of the
demo's shuffle, so both see the same batches), and the 5 losses agree
within 1e-5 relative; ``infer`` after them agrees within 1e-5 too. The
cut: 5 batches of one pass, where the demos run 1-8 passes.
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

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
STEPS = 5
DEMOS = ("mnist_v2", "traffic_prediction", "quick_start_cnn",
         "quick_start_lstm")


def build(paddle, demo):
    """(cost, output layer(s), optimizer) of the demo's topology, as
    its ``build`` / ``main`` write it."""
    if demo == "mnist_v2":
        images = paddle.layer.data("pixel",
                                   paddle.data_type.dense_vector(784))
        label = paddle.layer.data("label",
                                  paddle.data_type.integer_value(10))
        h1 = paddle.layer.fc(input=images, size=128,
                             act=paddle.activation.Relu())
        h2 = paddle.layer.fc(input=h1, size=64,
                             act=paddle.activation.Relu())
        logits = paddle.layer.fc(input=h2, size=10)
        cost = paddle.layer.classification_cost(input=logits, label=label)
        return cost, logits, paddle.optimizer.Adam(learning_rate=1e-3)
    if demo == "traffic_prediction":
        link_encode = paddle.layer.data(
            "link_encode", paddle.data_type.dense_vector(24))
        shared = paddle.attr.Param(name="_link_vec.w")
        total, scores = None, []
        for i in range(24):
            link_vec = paddle.layer.fc(input=link_encode, size=16,
                                       act=paddle.activation.Tanh(),
                                       param_attr=shared)
            score = paddle.layer.fc(input=link_vec, size=4,
                                    act=paddle.activation.Softmax())
            label = paddle.layer.data(f"label_{(i + 1) * 5}min",
                                      paddle.data_type.integer_value(4))
            cls = paddle.layer.classification_cost(input=score, label=label)
            total = cls if total is None else total + cls
            scores.append(score)
        return total, scores, paddle.optimizer.Adam(learning_rate=1e-2)
    words = paddle.layer.data(
        "words", paddle.data_type.integer_value_sequence(2048))
    emb = paddle.layer.embedding(input=words, size=128)
    if demo == "quick_start_cnn":
        hidden = paddle.networks.sequence_conv_pool(
            input=emb, context_len=3, hidden_size=128)
    else:
        lstm = paddle.networks.simple_lstm(input=emb, size=128)
        hidden = paddle.layer.pooling(input=lstm,
                                      pooling_type=paddle.pooling.Max())
    output = paddle.layer.fc(input=hidden, size=2,
                             act=paddle.activation.Softmax())
    label = paddle.layer.data("label", paddle.data_type.integer_value(2))
    cost = paddle.layer.classification_cost(input=output, label=label)
    return cost, output, paddle.optimizer.Adam(learning_rate=2e-3)


def _series():
    """traffic_prediction's ``make_series``."""
    rng = np.random.RandomState(0)
    t = np.arange(30 * 288)
    base = 0.5 + 0.35 * np.sin(2 * np.pi * t / 288.0 - 1.2)
    rush = 0.15 * np.exp(-0.5 * ((t % 288 - 102) / 12.0) ** 2)
    return np.clip(base + rush + 0.05 * rng.randn(t.size), 0, 1)


def batches(demo, n=STEPS):
    """The first ``n`` batches the demo trains on, at its batch size."""
    if demo == "mnist_v2":
        rows = list(jpt.dataset.mnist.train()())[:n * 64]
        return [rows[i * 64:(i + 1) * 64] for i in range(n)]
    if demo == "traffic_prediction":  # the demo's ``windows`` reader
        s, rng, out = _series(), np.random.RandomState(1), []
        for _ in range(n):
            rows = []
            for _ in range(128):
                i = rng.randint(0, s.size - 48)
                levels = np.minimum((s[i + 24:i + 48] * 4).astype(np.int64),
                                    3)
                rows.append((s[i:i + 24].astype(np.float32),
                             *[np.array([lv]) for lv in levels]))
            out.append(rows)
        return out
    wd = jpt.dataset.imdb.word_dict()
    reader = jpt.dataset.imdb.train(wd)()
    rows = [next(reader) for _ in range(n * 64)]
    return [rows[i * 64:(i + 1) * 64] for i in range(n)]


def make(pkg, v2, demo):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        cost, out, opt = build(v2, demo)
        params = v2.parameters.create(cost)
        trainer = v2.trainer.SGD(cost=cost, parameters=params,
                                 update_equation=opt)
    return main, params, trainer, out


@pytest.fixture
def pair(request):
    demo = request.param
    tv2.init(use_gpu=False, seed=1)
    jv2.init(seed=1)
    uid = jprog.Program._uid_counter
    tprog.Program._uid_counter = uid
    j = make(jpt, jv2, demo)
    tprog.Program._uid_counter = uid
    t = make(tpt, tv2, demo)
    yield demo, j, t
    tpt.flags.reset_flags()
    jpt.flags.reset_flags()


@pytest.mark.parametrize("pair", DEMOS, indirect=True)
def test_program_equals_the_reference(pair):
    _, (jmain, *_), (tmain, *_) = pair
    assert ([op.type for op in tmain.global_block.ops]
            == [op.type for op in jmain.global_block.ops])
    shapes = {p.name: tuple(p.shape)
              for p in tmain.global_block.all_parameters()}
    assert shapes == {p.name: tuple(p.shape)
                      for p in jmain.global_block.all_parameters()}
    assert shapes


def _losses(trainer, v2, rows):
    seen = []
    trainer.train(lambda: iter(rows), num_passes=1, event_handler=lambda e:
                  seen.append(e.cost) if isinstance(e, v2.event.EndIteration)
                  else None)
    return np.array(seen)


@pytest.mark.parametrize("pair", DEMOS, indirect=True)
def test_first_losses_and_infer_equal_the_reference(pair):
    demo, (_, jparams, jtrainer, jout), (_, tparams, ttrainer, tout) = pair
    jparams.init()
    tparams.init()
    carried = 0
    for name, value in list(tparams.scope._vars.items()):
        if isinstance(value, torch.Tensor) and jparams.scope.has(name):
            tparams.scope.set(name, torch.from_numpy(np.array(
                jparams.scope.get_numpy(name))).to(value.dtype))
            carried += 1
    assert carried >= len(tparams.names())
    rows = batches(demo)
    want = _losses(jtrainer, jv2, rows)
    got = _losses(ttrainer, tv2, rows)
    assert len(got) == STEPS and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    inputs = [row[:1] for row in rows[0][:8]]
    np.testing.assert_allclose(
        np.asarray(tv2.infer(output_layer=tout, parameters=tparams,
                             input=inputs)),
        np.asarray(jv2.infer(output_layer=jout, parameters=jparams,
                             input=inputs)), rtol=1e-5, atol=1e-6)
