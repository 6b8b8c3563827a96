"""The port's widened v2 facade: the twin of tests/test_v2_facade.py on
the CPU, for every case whose layers and ops the port has: mixed_layer
and its projections, the layer-name tail's cos_sim / maxout / pad / eos,
the cost tail, and the GRU encoder-decoder without attention. The cases
that reach what the port lacks check that it raises, naming the ROADMAP
item: the legacy layers of the name tail (item 8) and the
``sequence_mask`` op of the attention composites (item 3). ``addto``
(the ResNet-in-v2 case) and ``fc`` over a sparse input are ported and
held to numpy. ``small_vgg`` (a slow test there) has no twin."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.v2 import activation, layer as l2, networks

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    pt.v2.init(use_gpu=False)
    yield
    pt.flags.reset_flags()


def _run(fetches, feed, main, startup):
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    outs = exe.run(main, feed=feed, fetch_list=list(fetches), scope=scope)
    return [np.asarray(o) for o in outs]


def test_mixed_layer_immediate_equals_fc():
    """A mixed layer with one full_matrix_projection sharing the fc's
    weight (by param name) equals fc without activation."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = l2.data("x", pt.v2.data_type.dense_vector(6))
        ref = l2.fc(x, 4, param_attr=pt.ParamAttr(name="w_shared"),
                    bias_attr=pt.ParamAttr(name="b_shared"))
        mix = l2.mixed_layer(size=4, input=[l2.full_matrix_projection(
            x, param_attr=pt.ParamAttr(name="w_shared"))],
            bias_attr=pt.ParamAttr(name="b_shared"))
    a, b = _run([ref, mix], {"x": np.random.RandomState(0).rand(
        3, 6).astype("float32")}, main, startup)
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_mixed_layer_context_manager_form():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = l2.data("x", pt.v2.data_type.dense_vector(6))
        ids = l2.data("ids", pt.v2.data_type.integer_value(11))
        with l2.mixed_layer(size=4) as m:
            m += l2.full_matrix_projection(x)
            m += l2.table_projection(ids)
        # the mixed object IS the output variable after the block
        y = l2.fc(m, 2, act=activation.Softmax())
    out, = _run([y], {
        "x": np.random.RandomState(0).rand(3, 6).astype("float32"),
        "ids": np.array([[1], [4], [10]], dtype="int64")}, main, startup)
    assert out.shape == (3, 2)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-4)


def test_identity_and_dotmul_and_scaling_projections():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = l2.data("x", pt.v2.data_type.dense_vector(8))
        ident = l2.mixed_layer(size=8, input=[l2.identity_projection(x)],
                               bias_attr=False)
        sliced = l2.mixed_layer(
            size=3, input=[l2.identity_projection(x, offset=2, size=3)],
            bias_attr=False)
        dm = l2.mixed_layer(size=8, input=[l2.dotmul_projection(x)],
                            bias_attr=False)
        sc = l2.mixed_layer(size=8, input=[l2.scaling_projection(x)],
                            bias_attr=False)
    xv = np.random.RandomState(0).rand(2, 8).astype("float32")
    i, s, d, c = _run([ident, sliced, dm, sc], {"x": xv}, main, startup)
    np.testing.assert_allclose(i, xv, rtol=1e-6)
    np.testing.assert_allclose(s, xv[:, 2:5], rtol=1e-6)
    assert d.shape == (2, 8) and c.shape == (2, 8)


def test_context_projection_matches_numpy():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = l2.data("x", pt.v2.data_type.dense_vector_sequence(3))
        ctx = l2.mixed_layer(
            size=9, input=[l2.context_projection(x, context_len=3)],
            bias_attr=False)
    rng = np.random.RandomState(0)
    xv = rng.rand(2, 4, 3).astype("float32")
    lens = np.array([4, 2], dtype="int32")
    out, = _run([ctx], {"x": xv, "x@len": lens}, main, startup)
    # manual shift-concat, zeros outside each row's true length
    xm = xv.copy()
    xm[1, 2:] = 0.0
    want = np.zeros((2, 4, 9), np.float32)
    for off_i, off in enumerate((-1, 0, 1)):
        for t in range(4):
            src = t + off
            if 0 <= src < 4:
                want[:, t, off_i * 3:(off_i + 1) * 3] = xm[:, src]
    want[1, 2:] = 0.0
    np.testing.assert_allclose(out, want, rtol=1e-6)


def test_layer_name_tail_builds_and_runs():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        a = l2.data("a", pt.v2.data_type.dense_vector(6))
        b = l2.data("b", pt.v2.data_type.dense_vector(6))
        fetches = [
            l2.cos_sim(a, b),
            l2.maxout(a, groups=2),
            l2.pad(a, paddings=[0, 0, 1, 1]),
            l2.eos(l2.data("ids", pt.v2.data_type.integer_value(7)), 3),
        ]
        # the legacy layers of the tail wait for ROADMAP item 8
        for build in (lambda: l2.dot_prod(a, b), lambda: l2.l2_distance(a, b),
                      lambda: l2.slope_intercept(a, slope=2.0),
                      lambda: l2.sum_to_one_norm(a),
                      lambda: l2.row_l2_norm(a)):
            with pytest.raises(NotImplementedError, match="item 8"):
                build()
    rng = np.random.RandomState(0)
    feed = {"a": rng.rand(2, 6).astype("float32"),
            "b": rng.rand(2, 6).astype("float32"),
            "ids": np.array([[3], [5]], dtype="int64")}
    cos, maxout, pad, eos = _run(fetches, feed, main, startup)
    av, bv = feed["a"], feed["b"]
    want = (av * bv).sum(-1) / (np.linalg.norm(av, axis=-1)
                                * np.linalg.norm(bv, axis=-1))
    np.testing.assert_allclose(cos.ravel(), want, rtol=1e-4)
    assert maxout.shape == (2, 3)       # maxout groups=2
    assert pad.shape == (2, 8)          # padded feature dim
    np.testing.assert_allclose(eos.ravel(), [1.0, 0.0])


def test_cost_tail():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = l2.data("x", pt.v2.data_type.dense_vector(1))
        y = l2.data("y", pt.v2.data_type.dense_vector(1))
        lbl = l2.data("lbl", pt.v2.data_type.integer_value(2))
        fetches = [l2.sum_cost(x),
                   l2.smooth_l1_cost(x, y),
                   l2.huber_classification_cost(x, lbl),
                   l2.multi_binary_label_cross_entropy(
                       x, l2.mixed_layer(size=1, input=[
                           l2.identity_projection(y)], bias_attr=False))]
    feed = {"x": np.array([[0.2], [2.0]], np.float32),
            "y": np.array([[0.1], [0.5]], np.float32),
            "lbl": np.array([[1], [0]], np.int64)}
    s, sl1, hub, mb = _run(fetches, feed, main, startup)
    np.testing.assert_allclose(s, 2.2, rtol=1e-5)
    # smooth-l1: |d|<1 -> 0.5 d^2 ; else |d|-0.5
    d = feed["x"] - feed["y"]
    want = np.where(np.abs(d) < 1, 0.5 * d * d, np.abs(d) - 0.5).mean()
    np.testing.assert_allclose(sl1, want, rtol=1e-5)
    assert np.isfinite(hub) and np.isfinite(mb)


def test_attention_composites_wait_for_sequence_mask():
    """dot_product_attention and simple_attention mask padding with the
    sequence_mask op (ROADMAP item 3)."""
    with pt.program_guard(pt.Program(), pt.Program()):
        enc = l2.data("enc", pt.v2.data_type.dense_vector_sequence(4))
        dec = l2.data("dec", pt.v2.data_type.dense_vector_sequence(4))
        with pytest.raises(NotImplementedError, match="item 3"):
            networks.dot_product_attention(enc, attending_sequence=dec)
        proj = l2.fc(enc, 5, bias_attr=False)
        proj.seq_len = enc.seq_len
        state = l2.data("st", pt.v2.data_type.dense_vector(6))
        with pytest.raises(NotImplementedError, match="item 3"):
            networks.simple_attention(enc, proj, state)


def test_gru_encoder_decoder_trains():
    """The recipe without attention (with it, the mask waits for item
    3): a teacher-forced GRU encoder-decoder descends."""
    V, B, T = 12, 4, 5
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        src = l2.data("src", pt.v2.data_type.integer_value_sequence(V))
        trg_in = l2.data("trg_in", pt.v2.data_type.integer_value_sequence(V))
        trg_next = l2.data("trg_next",
                           pt.v2.data_type.integer_value_sequence(V))
        logits = networks.gru_encoder_decoder(
            src, trg_in, src_dict_dim=V, trg_dict_dim=V,
            word_vector_dim=8, encoder_size=8, decoder_size=8,
            with_attention=False)
        L = pt.layers  # cost plumbing only
        tok_loss = L.softmax_with_cross_entropy(logits, trg_next)
        tok_loss.seq_len = trg_next.seq_len
        loss = L.mean(L.sequence_pool(tok_loss, "average"))
        pt.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(
            loss, startup_program=startup)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, V, size=(B, T)).astype("int64")
    feed = {"src": ids, "src@len": np.full(B, T, "int32"),
            "trg_in": ids, "trg_in@len": np.full(B, T, "int32"),
            "trg_next": np.roll(ids, -1, 1), "trg_next@len":
            np.full(B, T, "int32")}
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    vals = []
    for _ in range(18):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        vals.append(float(np.asarray(out)))
    assert np.isfinite(vals).all()
    assert vals[-1] < vals[0] * 0.8, vals
    with pt.program_guard(pt.Program(), pt.Program()):
        src = l2.data("src", pt.v2.data_type.integer_value_sequence(V))
        with pytest.raises(NotImplementedError, match="item 3"):
            networks.gru_encoder_decoder(src, src, V, V, 8, 8, 8)


def test_resnet_in_v2_waits_for_addto():
    """The ResNet-in-v2 case joins its branches with addto, ported now:
    the join is relu(x + c)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = l2.data("img", pt.v2.data_type.dense_vector(16 * 16 * 3))
        x = pt.layers.reshape(img, shape=[-1, 16, 16, 3])
        c = l2.batch_norm(l2.img_conv(x, 3, 8, padding=1, act=None,
                                      bias_attr=False),
                          act=activation.Relu())
        c = pt.layers.fc(c, size=16 * 16 * 3, num_flatten_dims=1)
        c = pt.layers.reshape(c, shape=[-1, 16, 16, 3])
        y = l2.addto([x, c], act=activation.Relu())
    assert [op.type for op in main.global_block.ops][-2:] == ["addto",
                                                             "relu"]
    feed = {"img": np.random.RandomState(0).rand(2, 768).astype("float32")}
    got, xv, cv = _run([y, x, c], feed, main, startup)
    np.testing.assert_allclose(got, np.maximum(xv + cv, 0), rtol=1e-6)


def test_mixed_layer_default_has_no_bias():
    """Reference mixed_layer is wrap_bias_attr_default(has_bias=False):
    unset bias_attr adds no parameter (layers.py:865)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = l2.data("x", pt.v2.data_type.dense_vector(6))
        l2.mixed_layer(size=4, input=[l2.full_matrix_projection(x)])
    names = [p.name for p in main.global_block.all_parameters()]
    assert len(names) == 1, names  # just the projection weight


def test_mixed_layer_context_form_honors_drop_rate():
    """drop_rate applies in the with-form too (v1 ExtraAttr contract)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = l2.data("x", pt.v2.data_type.dense_vector(6))
        with l2.mixed_layer(size=4, drop_rate=0.5) as m:
            m += l2.full_matrix_projection(x)
    types = [op.type for op in main.global_block.ops]
    assert "dropout" in types, types


def test_sparse_inputs_wait_for_selected_rows():
    """quick_start's lr config: fc over a sparse_binary_vector, ported
    now, is the sum of the active ids' weight rows (the multi-hot row
    times W) plus the bias, then the softmax."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        words = l2.data("words", pt.v2.data_type.sparse_binary_vector(50))
        assert words.input_type.sparse == "binary"
        out = l2.fc(input=words, size=2, act=activation.Softmax())
    types = [op.type for op in main.global_block.ops]
    assert types[:3] == ["lookup_table", "sequence_pool", "addto"], types
    rows = [([1, 7, 30],), ([4],)]
    feed = pt.data_feeder.DataFeeder([words]).feed(rows)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    got, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    w, b = (scope.get_numpy(p.name)
            for p in main.global_block.all_parameters())
    logits = np.stack([w[[1, 7, 30]].sum(0), w[4]]) + b
    want = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)