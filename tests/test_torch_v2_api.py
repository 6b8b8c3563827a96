"""The port's v2 user API (paddle_tpu_torch.v2): the twin of
tests/test_v2_api.py, every case of it, on the CPU (``init(use_gpu=
False)``; the default runs on the card). Each case builds in programs of
its own. The train/test/infer cycle is also held against the JAX
package's v2 from the same weights."""
import numpy as np
import pytest
import torch

import paddle_tpu.v2 as jv2
import paddle_tpu as jpt
import paddle_tpu_torch as pt
import paddle_tpu_torch.v2 as paddle
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.init(use_gpu=False)
    yield
    pt.flags.reset_flags()
    jpt.flags.reset_flags()


def _make_reader(rng, W, n=6, bs=16):
    def reader():
        for _ in range(n):
            xb = rng.randn(bs, 8).astype(np.float32)
            yb = np.argmax(xb @ W, axis=1).astype(np.int64)
            yield [(x, int(y)) for x, y in zip(xb, yb)]
    return reader


def _cycle_net(v2):
    images = v2.layer.data("x", v2.data_type.dense_vector(8))
    label = v2.layer.data("y", v2.data_type.integer_value(3))
    h = v2.layer.fc(input=images, size=24, act=v2.activation.Relu())
    logits = v2.layer.fc(input=h, size=3)
    cost = v2.layer.classification_cost(input=logits, label=label)
    parameters = v2.parameters.create(cost)
    trainer = v2.trainer.SGD(
        cost=cost, parameters=parameters,
        update_equation=v2.optimizer.Adam(learning_rate=5e-3))
    return logits, parameters, trainer


class TestV2EndToEnd:
    def test_train_test_infer_cycle(self):
        paddle.init(use_gpu=False, trainer_count=1, seed=7)
        with pt.program_guard(pt.Program(), pt.Program()):
            logits, parameters, trainer = _cycle_net(paddle)
        rng = np.random.RandomState(0)
        W = rng.randn(8, 3)
        seen = {"costs": [], "passes": 0}

        def handler(e):
            if isinstance(e, paddle.event.EndIteration):
                seen["costs"].append(e.cost)
            elif isinstance(e, paddle.event.EndPass):
                seen["passes"] += 1

        trainer.train(_make_reader(rng, W, n=8), num_passes=10,
                      event_handler=handler)
        assert seen["passes"] == 10
        assert seen["costs"][-1] < 0.5 * seen["costs"][0], (
            seen["costs"][0], seen["costs"][-1])

        result = trainer.test(_make_reader(rng, W, n=2))
        assert result.cost < 0.8 * seen["costs"][0]

        # parameters facade: numpy round trip
        names = parameters.names()
        assert names and all(isinstance(parameters[n], np.ndarray)
                             for n in names)
        w0 = parameters[names[0]]
        parameters[names[0]] = w0 * 1.0
        np.testing.assert_array_equal(parameters[names[0]], w0)
        # inference on the pre-optimizer clone
        xb = rng.randn(4, 8).astype(np.float32)
        probs = paddle.infer(output_layer=logits, parameters=parameters,
                             input=[(x,) for x in xb])
        assert probs.shape == (4, 3)
        acc = (np.argmax(probs, 1) == np.argmax(xb @ W, 1)).mean()
        assert acc >= 0.5, acc

    def test_cycle_equals_the_reference_from_the_same_weights(self):
        """Both packages' cycles from the JAX startup's weights: every
        cost and the infer output within 1e-5."""
        jv2.init(seed=7)
        uid = jprog.Program._uid_counter
        tprog.Program._uid_counter = uid
        with jpt.program_guard(jpt.Program(), jpt.Program()):
            jlogits, jparams, jtrainer = _cycle_net(jv2)
        tprog.Program._uid_counter = uid
        with pt.program_guard(pt.Program(), pt.Program()):
            tlogits, tparams, ttrainer = _cycle_net(paddle)
        assert tparams.names() == jparams.names()
        for name in jparams.names():
            tparams[name] = jparams[name]
        costs = {}
        for key, v2, trainer in (("jax", jv2, jtrainer),
                                 ("port", paddle, ttrainer)):
            rng = np.random.RandomState(0)
            W = rng.randn(8, 3)
            costs[key] = []
            trainer.train(_make_reader(rng, W, n=4), num_passes=2,
                          event_handler=lambda e, c=costs[key], v=v2:
                          c.append(e.cost)
                          if isinstance(e, v.event.EndIteration) else None)
        np.testing.assert_allclose(costs["port"], costs["jax"], rtol=1e-5)
        xb = [(x,) for x in np.random.RandomState(3).randn(4, 8).astype(
            np.float32)]
        np.testing.assert_allclose(
            paddle.infer(output_layer=tlogits, parameters=tparams, input=xb),
            jv2.infer(output_layer=jlogits, parameters=jparams, input=xb),
            rtol=1e-5, atol=1e-6)

    def test_parameters_tar_roundtrip(self, tmp_path):
        with pt.program_guard(pt.Program(), pt.Program()):
            x = paddle.layer.data("x", paddle.data_type.dense_vector(4))
            out = paddle.layer.fc(input=x, size=2)
            cost = paddle.layer.square_error_cost(
                input=out, label=paddle.layer.data(
                    "y", paddle.data_type.dense_vector(2)))
            params = paddle.parameters.create(cost).init()
        f = str(tmp_path / "params.npz")
        with open(f, "wb") as fh:
            params.to_tar(fh)
        loaded = paddle.parameters.Parameters.from_tar(f)
        for n in params.names():
            np.testing.assert_array_equal(loaded[n], params[n])


class TestV2Networks:
    def test_simple_lstm_runs(self):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            seq = paddle.layer.data(
                "seq", paddle.data_type.dense_vector_sequence(6))
            h = paddle.networks.simple_lstm(seq, size=5)
            pooled = paddle.layer.pooling(h, paddle.pooling.Max())
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        x = np.random.RandomState(0).randn(2, 7, 6).astype(np.float32)
        lens = np.array([7, 4], np.int32)
        out, = exe.run(main, feed={"seq": x, "seq@len": lens},
                       fetch_list=[pooled], scope=scope)
        assert np.asarray(out).shape == (2, 5)

    def test_conv_pool_shape(self):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            img = paddle.layer.data(
                "img", paddle.data_type.dense_vector(16 * 16 * 3))
            grid = paddle.layer.fc(input=img, size=16 * 16 * 3)
            grid = pt.layers.reshape(grid, shape=[-1, 16, 16, 3])
            out = paddle.networks.simple_img_conv_pool(
                grid, filter_size=3, num_filters=4, pool_size=2,
                pool_stride=2, act=paddle.activation.Relu())
        # reference defaults: conv_padding=0 (16 -> 14), pool 2/2 -> 7
        assert tuple(out.shape)[1:] == (7, 7, 4)

    def test_activation_and_pooling_objects(self):
        assert paddle.activation.Relu().name == "relu"
        assert paddle.activation.Linear().name == ""
        assert paddle.pooling.Max().name == "max"
        from paddle_tpu_torch.v2.activation import resolve
        assert resolve(paddle.activation.Softmax()) == "softmax"
        assert resolve(None) is None

    def test_unported_reexports_raise_naming_the_roadmap(self):
        for name in ("image", "master", "plot"):
            with pytest.raises(NotImplementedError, match="item 9"):
                getattr(paddle, name)
        assert paddle.dataset is pt.dataset and paddle.event is pt.event


class TestForTestClone:
    def test_infer_is_deterministic_with_dropout(self):
        """clone(for_test=True): dropout is a deterministic scale at
        inference (the reference's inference_optimize contract)."""
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = paddle.layer.data("x", paddle.data_type.dense_vector(6))
            h = paddle.layer.fc(input=x, size=8,
                                act=paddle.activation.Relu())
            h = paddle.layer.dropout(h, dropout_rate=0.5)
            out = paddle.layer.fc(input=h, size=2)
            y = paddle.layer.data("y", paddle.data_type.integer_value(2))
            cost = paddle.layer.classification_cost(input=out, label=y)
            params = paddle.parameters.create(cost)
        xb = np.random.RandomState(0).randn(3, 6).astype(np.float32)
        rows = [(r,) for r in xb]
        a = paddle.infer(output_layer=out, parameters=params, input=rows)
        b = paddle.infer(output_layer=out, parameters=params, input=rows)
        np.testing.assert_array_equal(a, b)

    def test_clone_for_test_flips_is_test(self):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.layers.data("x", shape=[4])
            pt.layers.dropout(x, dropout_prob=0.3)
        test_prog = main.clone(for_test=True)
        (op,) = [o for o in test_prog.global_block.ops
                 if o.type == "dropout"]
        assert op.attrs["is_test"] is True
        # the original program is untouched
        (op0,) = [o for o in main.global_block.ops if o.type == "dropout"]
        assert op0.attrs["is_test"] is False


class TestMultiOutputInfer:
    def test_infer_accepts_output_list(self):
        """reference configs end with outputs([maxid, prob]): infer
        serves several output layers from one pruned program."""
        paddle.init(use_gpu=False, seed=3)
        with pt.program_guard(pt.Program(), pt.Program()):
            x = paddle.layer.data("x", paddle.data_type.dense_vector(6))
            shared = paddle.layer.fc(input=x, size=8,
                                     act=paddle.activation.Tanh())
            head_a = paddle.layer.fc(input=shared, size=3,
                                     act=paddle.activation.Softmax())
            head_b = paddle.layer.fc(input=shared, size=2,
                                     act=paddle.activation.Softmax())
            label = paddle.layer.data("y", paddle.data_type.integer_value(3))
            cost = paddle.layer.classification_cost(input=head_a,
                                                    label=label)
            parameters = paddle.parameters.create(cost)

        rows = [(np.arange(6, dtype=np.float32) / 6.0,),
                (np.ones(6, dtype=np.float32),)]
        a, b = paddle.infer(output_layer=[head_a, head_b],
                            parameters=parameters, input=rows)
        assert a.shape == (2, 3) and b.shape == (2, 2)
        np.testing.assert_allclose(a.sum(axis=1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(b.sum(axis=1), 1.0, rtol=1e-5)
        # single-layer form still returns a bare array
        single = paddle.infer(output_layer=head_a, parameters=parameters,
                              input=rows)
        np.testing.assert_allclose(single, a, rtol=1e-6)


def test_default_place_is_the_card():
    paddle.init()
    with pt.program_guard(pt.Program(), pt.Program()):
        x = paddle.layer.data("x", paddle.data_type.dense_vector(4))
        cost = pt.layers.mean(x)
        if torch.cuda.is_available():
            params = paddle.parameters.create(cost)
            assert params.executor.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                paddle.parameters.create(cost)
