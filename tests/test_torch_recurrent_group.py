"""The v1 step-level recurrent DSL (recurrent_group, memory,
StaticInput, gru_step_layer, lstm_step_layer, nested groups) against
the JAX package's.

Each case of ``tests/test_recurrent_group.py`` is built by one function
with each package's ``v1.helpers`` and ``layers`` in turn (under a parse
context, as the DSL requires) and the name counters synced: the two
programs must be equal as ``program_to_dict`` writes them (the nested
bodies included, without the JAX package's ``_callsite`` attrs), and
the outputs, run from each package's own startup (the port's draws
JAX's values), agree within 8 f32 ulps of each tensor's largest |value|
(``test_torch_control_flow.ULPS``), as do the weight gradients of the GRU and LSTM groups. The
group's state wiring errors read as the JAX package's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu.v1 import helpers as JH
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.v1 import helpers as TH
from test_torch_control_flow import _strip_callsites, assert_pairs_close
from test_torch_transpiler import program_dict

torch.set_num_threads(1)
PKGS = ((jpt, jprog, JH), (tpt, tprog, TH))


def twin(body, feed, grads=False, seed=7, context=True):
    """``body(pt, H) -> [Variable]`` built and run in both packages; with
    ``grads`` the mean of the first output is differentiated and every
    parameter's gradient fetched too. Returns (JAX values, port
    values)."""
    start = jprog.Program._uid_counter
    results, dicts = [], []
    for pt, counter, H in PKGS:
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = seed
        prev = H._CTX
        H._CTX = H.ParseContext() if context else None
        try:
            with pt.program_guard(main, startup):
                fetches = list(body(pt, H))
                dicts.append(_strip_callsites(program_dict(pt, main)))
                if grads:
                    pg = pt.append_backward(pt.layers.mean(fetches[0]))
                    fetches += sorted((g for _, g in pg),
                                      key=lambda g: g.name)
        finally:
            H._CTX = prev
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        outs = exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
        results.append([np.asarray(o, np.float64) for o in outs])
    assert dicts[1] == dicts[0]
    return results


def test_group_simple_rnn_carries_state():
    def body(pt, H):
        x = pt.layers.data("x", shape=[4, 6])

        def step(x_t):
            mem = H.memory(name="state", size=8)
            return H.fc_layer(input=[x_t, mem], size=8,
                              act=H.TanhActivation(), name="state")

        return [H.recurrent_group(step=step, input=x)]

    xv = np.random.RandomState(0).rand(2, 4, 6).astype(np.float32)
    jv, tv = twin(body, {"x": xv}, grads=True)
    assert_pairs_close(jv, tv)
    xv2 = xv.copy()
    xv2[:, 0] += 1.0
    _, tv2 = twin(body, {"x": xv2})
    assert np.abs(tv2[0][:, 1] - tv[0][:, 1]).max() > 1e-5


def test_group_gru_step_matches_dynamic_gru():
    """recurrent_group + gru_step_layer against the monolithic gru op
    on the same weights, in both packages."""
    SZ = 5

    def body(pt, H):
        L = pt.layers
        xp = L.data("xp", shape=[3, 3 * SZ])
        ref = L.dynamic_gru(xp, SZ, param_attr=pt.ParamAttr(name="gru_w"),
                            bias_attr=False)

        def step(x_t):
            mem = H.memory(name="gru_state", size=SZ)
            return H.gru_step_layer(x_t, output_mem=mem, size=SZ,
                                    param_attr=pt.ParamAttr(name="gru_w"),
                                    bias_attr=False, name="gru_state")

        return [H.recurrent_group(step=step, input=xp), ref]

    xv = np.random.RandomState(1).rand(2, 3, 3 * SZ).astype(np.float32)
    jv, tv = twin(body, {"xp": xv}, grads=True)
    assert_pairs_close(jv, tv)
    np.testing.assert_allclose(tv[0], tv[1], rtol=1e-5, atol=1e-6)


def test_group_static_input_attention():
    def body(pt, H):
        L = pt.layers
        enc = L.data("enc", shape=[5, 4])
        dec = L.data("dec", shape=[3, 4])

        def step(q_t, enc_full):
            scores = L.matmul(L.reshape(q_t, shape=[0, 1, 4]), enc_full,
                              transpose_y=True)
            ctx = L.matmul(L.softmax(scores), enc_full)
            return L.reshape(ctx, shape=[0, 4])

        return [H.recurrent_group(step=step,
                                  input=[dec, H.StaticInput(enc)])]

    rng = np.random.RandomState(2)
    feed = {"enc": rng.rand(2, 5, 4).astype(np.float32),
            "dec": rng.rand(2, 3, 4).astype(np.float32)}
    jv, tv = twin(body, feed)
    assert tv[0].shape == (2, 3, 4)
    assert_pairs_close(jv, tv)


def test_group_lstm_step_layer_carries_cell():
    SZ = 6

    def body(pt, H):
        xp = pt.layers.data("xp", shape=[4, 4 * SZ])

        def step(x_t):
            cell = H.memory(name="c", size=SZ)
            return H.lstm_step_layer(x_t, state=cell, size=SZ)

        return [H.recurrent_group(step=step, input=xp)]

    xv = np.random.RandomState(3).rand(2, 4, 4 * SZ).astype(np.float32)
    jv, tv = twin(body, {"xp": xv}, grads=True)
    assert tv[0].shape == (2, 4, SZ)
    assert_pairs_close(jv, tv)


def test_group_reverse_flips_time():
    def body(pt, H):
        x = pt.layers.data("x", shape=[3], lod_level=1)

        def step(x_t):
            mem = H.memory(name="s", size=3)
            return H.addto_layer([x_t, mem], name="s")

        return [H.recurrent_group(step=step, input=x),
                H.recurrent_group(step=step, input=x, reverse=True)]

    xv = np.random.RandomState(4).rand(2, 4, 3).astype(np.float32)
    feed = {"x": xv, "x@len": np.array([4, 3], np.int32)}
    jv, tv = twin(body, feed)
    assert_pairs_close(jv, tv)
    np.testing.assert_allclose(tv[0][0, -1], xv[0].sum(0), rtol=1e-6)
    np.testing.assert_allclose(tv[1][1, 0], xv[1, :3].sum(0), rtol=1e-6)


def test_lstmemory_and_gru_groups():
    """networks.py's lstmemory_group and gru_group: the step is the
    group's, its projection inside."""
    def body(pt, H):
        x = pt.layers.data("x", shape=[8], lod_level=1)
        return [H.lstmemory_group(H.fc_layer(input=x, size=16), size=4),
                H.gru_group(H.fc_layer(input=x, size=12), size=4)]

    xv = np.random.RandomState(5).randn(3, 5, 8).astype(np.float32)
    feed = {"x": xv, "x@len": np.array([5, 1, 3], np.int32)}
    jv, tv = twin(body, feed, grads=True)
    assert_pairs_close(jv, tv)


def test_nested_groups_hierarchical_rnn():
    """An outer group over the sub-sequences of [b, S, T, d], an inner
    group over the words: the inner static_rnn op nests in the outer
    body."""
    def body(pt, H):
        x = pt.layers.data("x", shape=[3, 4, 2])

        def outer_step(sub):
            def inner_step(w_t):
                mem = H.memory(name="inner", size=2)
                return H.addto_layer([w_t, mem], name="inner")

            summed = pt.layers.sequence_last_step(
                H.recurrent_group(step=inner_step, input=sub))
            acc = H.memory(name="outer_acc", size=2)
            return H.addto_layer([summed, acc], name="outer_acc")

        return [H.recurrent_group(step=outer_step, input=x)]

    xv = np.random.RandomState(0).rand(2, 3, 4, 2).astype(np.float32)
    jv, tv = twin(body, {"x": xv}, context=False)
    assert_pairs_close(jv, tv)
    np.testing.assert_allclose(tv[0], np.cumsum(xv.sum(axis=2), axis=1),
                               rtol=1e-5)


def test_nested_groups_with_variable_inner_lengths():
    def body(pt, H):
        L = pt.layers
        x = L.data("x", shape=[3, 4, 2])
        lens = L.data("lens", shape=[3], dtype="int32")

        def outer_step(sub, len_s):
            sub.seq_len = len_s

            def inner_step(w_t):
                mem = H.memory(name="inner", size=2)
                return H.addto_layer([w_t, mem], name="inner")

            return L.sequence_last_step(
                H.recurrent_group(step=inner_step, input=sub))

        return [H.recurrent_group(step=outer_step, input=[x, lens])]

    xv = np.random.RandomState(0).rand(2, 3, 4, 2).astype(np.float32)
    lv = np.array([[4, 2, 3], [1, 4, 2]], np.int32)
    jv, tv = twin(body, {"x": xv, "lens": lv})
    assert_pairs_close(jv, tv)
    want = np.stack([[xv[b, s, :lv[b, s]].sum(0) for s in range(3)]
                     for b in range(2)])
    np.testing.assert_allclose(tv[0], want, rtol=1e-5)


def test_v2_namespace_carries_the_group_dsl_without_parse_context():
    from paddle_tpu_torch.v2 import layer as l2

    assert TH._CTX is None
    assert l2.StaticInput is TH.StaticInput
    assert l2.recurrent_group is TH.recurrent_group
    for name in l2._DSL_REEXPORTS:
        assert getattr(l2, name) is getattr(TH, name)

    def body(pt, H):
        from importlib import import_module

        v2l = import_module(f"{pt.__name__}.v2.layer")
        x = pt.layers.data("x", shape=[4, 3])

        def step(x_t):
            mem = v2l.memory(name="s", size=3)
            return H.addto_layer([x_t, mem], name="s")

        return [v2l.recurrent_group(step=step, input=x)]

    jv, tv = twin(body, {"x": np.ones((1, 4, 3), np.float32)},
                  context=False)
    np.testing.assert_array_equal(tv[0], jv[0])
    np.testing.assert_array_equal(tv[0][0, -1], [4.0, 4.0, 4.0])


def _wiring_error(H, pt):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4, 3])

        def step(x_t):
            H.memory(name="a", size=3)
            H.memory(name="b", size=3)
            return H.addto_layer([x_t, x_t])

        with pytest.raises(ValueError) as err:
            H.recurrent_group(step=step, input=x)
    return str(err.value)


def test_wiring_errors_read_as_jax():
    assert _wiring_error(TH, tpt) == _wiring_error(JH, jpt)
    assert "memory 'a' is never updated" in _wiring_error(TH, tpt)
    with pytest.raises(RuntimeError, match="recurrent_group"):
        TH.memory(name="x", size=4)
    with pytest.raises(NotImplementedError, match="decode ops"):
        TH.GeneratedInput(size=8)
