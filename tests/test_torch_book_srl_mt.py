"""The Paddle book's CRF and translation chapters built with each package
and trained side by side on the CPU (``tests/test_torch_book.py`` holds
the others, and the runner shared here):

- label_semantic_roles as ``tests/test_book.py`` builds it
  (sequence_conv + ``linear_chain_crf`` + ``crf_decoding`` +
  ``evaluator.ChunkEvaluator``) on the synthetic conll05: the losses at
  ``LOSS_RTOL`` of JAX's, and the chunk evaluator's int32 counts after
  the steps equal JAX's;
- the book's own SRL model, ``db_lstm`` (book chapter 07,
  label_semantic_roles: six word-context embeddings sharing the
  pretrained table ``emb``, a predicate and a mark embedding, ``fc`` +
  ``sums``, ``depth`` dynamic_lstm layers of alternating direction with
  relu candidate, sigmoid gate and sigmoid cell, a tanh emission, the
  CRF with its transition shared as ``ParamAttr(name="crfw")``, the
  chunk evaluator over ceil((labels - 1) / 2) types), here at depth 2
  and hidden_dim 32: the losses, the Viterbi paths and the counts;
- machine_translation (GRU encoder-decoder with attention, then the fused
  ``beam_search_decoder``): the losses at ``LOSS_RTOL``, then the beam
  decode over the same trained weights (JAX's, carried into the port)
  token for token, its scores within 1e-5.

The ``fc`` layers of ``db_lstm`` take ``num_flatten_dims=2``: a sequence
here is a padded [b, T, d] tensor, where the book's fluid model sees a
[sum of T, d] LoD tensor.
"""
import math

import numpy as np
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from test_torch_book import (LOSS_RTOL, assert_losses, build_both, scopes,
                             train_both)

torch.set_num_threads(1)


def label_semantic_roles(pt):
    """tests/test_book.py's SRL chapter."""
    layers = pt.layers
    word_d, verb_d, label_d = pt.dataset.conll05.get_dict()
    V, n_labels = len(word_d), len(label_d)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        word = layers.data("word", shape=[1], dtype="int64", lod_level=1)
        mark = layers.data("mark", shape=[1], dtype="int64", lod_level=1)
        tags = layers.data("tags", shape=[1], dtype="int64", lod_level=1)
        w_emb = layers.embedding(word, size=[V, 24])
        w_emb.seq_len = word.seq_len
        m_emb = layers.embedding(mark, size=[2, 4])
        m_emb.seq_len = mark.seq_len
        feat = layers.concat([w_emb, m_emb], axis=2)
        feat.seq_len = word.seq_len
        hidden = layers.sequence_conv(feat, num_filters=64, filter_size=5,
                                      act="tanh")
        emission = layers.fc(hidden, size=n_labels, num_flatten_dims=2)
        crf = layers.linear_chain_crf(emission, tags)
        avg = layers.mean(crf)
        decoded = layers.crf_decoding(emission, transition=crf.transition)
        chunk = pt.evaluator.ChunkEvaluator(decoded, tags,
                                            num_chunk_types=4)
        pt.optimizer.AdamOptimizer(learning_rate=2e-2).minimize(
            avg, startup_program=startup)

    def reader():
        for s in pt.dataset.conll05.test()():
            yield s[0], s[7], s[8]  # words, mark, labels

    return dict(main=main, startup=startup, feeds=[word, mark, tags],
                fetch=[avg], reader=reader, batch=32, chunk=chunk)


def db_lstm(pt, hidden_dim=512, depth=8):
    """The book's SRL model (chapter 07's ``db_lstm``: word_dim 32,
    mark_dim 5, the CRF transition's ``mix_hidden_lr`` 1e-3) and its
    training program (Adam 2e-3, batch 32, as ``chip_smoke.py`` trains
    it)."""
    word_dim, mark_dim, mix_hidden_lr = 32, 5, 1e-3
    layers = pt.layers
    word_d, verb_d, label_d = pt.dataset.conll05.get_dict()
    word_dict_len, pred_dict_len = len(word_d), len(verb_d)
    label_dict_len, mark_dict_len = len(label_d), 2
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        seq = lambda name: layers.data(  # noqa: E731
            name, shape=[1], dtype="int64", lod_level=1)
        word = seq("word_data")
        ctx = [seq(n) for n in ("ctx_n2_data", "ctx_n1_data", "ctx_0_data",
                                "ctx_p1_data", "ctx_p2_data")]
        predicate = seq("verb_data")
        mark = seq("mark_data")
        target = seq("target")
        predicate_embedding = layers.embedding(
            predicate, size=[pred_dict_len, word_dim], param_attr="vemb")
        mark_embedding = layers.embedding(mark, size=[mark_dict_len,
                                                      mark_dim])
        emb_layers = [layers.embedding(
            x, size=[word_dict_len, word_dim],
            param_attr=pt.ParamAttr(name="emb", trainable=False))
            for x in [word] + ctx]
        emb_layers += [predicate_embedding, mark_embedding]
        hidden_0 = layers.sums([layers.fc(emb, size=hidden_dim,
                                          num_flatten_dims=2)
                                for emb in emb_layers])
        lstm_0, _ = layers.dynamic_lstm(
            hidden_0, size=hidden_dim, candidate_activation="relu",
            gate_activation="sigmoid", cell_activation="sigmoid")
        input_tmp = [hidden_0, lstm_0]
        for i in range(1, depth):
            mix_hidden = layers.sums([
                layers.fc(input_tmp[0], size=hidden_dim, num_flatten_dims=2),
                layers.fc(input_tmp[1], size=hidden_dim, num_flatten_dims=2)])
            lstm, _ = layers.dynamic_lstm(
                mix_hidden, size=hidden_dim, candidate_activation="relu",
                gate_activation="sigmoid", cell_activation="sigmoid",
                is_reverse=(i % 2) == 1)
            input_tmp = [mix_hidden, lstm]
        feature_out = layers.sums([
            layers.fc(input_tmp[0], size=label_dict_len, act="tanh",
                      num_flatten_dims=2),
            layers.fc(input_tmp[1], size=label_dict_len, act="tanh",
                      num_flatten_dims=2)])
        crf_cost = layers.linear_chain_crf(
            feature_out, target,
            param_attr=pt.ParamAttr(name="crfw",
                                    learning_rate=mix_hidden_lr))
        avg_cost = layers.mean(crf_cost)
        crf_decode = layers.crf_decoding(
            feature_out, param_attr=pt.ParamAttr(name="crfw"))
        chunk = pt.evaluator.ChunkEvaluator(
            crf_decode, target, chunk_scheme="IOB",
            num_chunk_types=int(math.ceil((label_dict_len - 1) / 2.0)))
        pt.optimizer.AdamOptimizer(learning_rate=2e-3).minimize(
            avg_cost, startup_program=startup)
    return dict(main=main, startup=startup,
                feeds=[word] + ctx + [predicate, mark, target],
                fetch=[avg_cost, crf_decode], reader=pt.dataset.conll05.test(),
                batch=32, chunk=chunk)


MT = dict(dict_size=64, emb_dim=16, hid=32)


def machine_translation(pt):
    """tests/test_book.py's translation chapter, training program."""
    layers = pt.layers
    dict_size, emb_dim, hid = MT["dict_size"], MT["emb_dim"], MT["hid"]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        src = layers.data("src", shape=[1], dtype="int64", lod_level=1)
        trg_in = layers.data("trg_in", shape=[1], dtype="int64", lod_level=1)
        trg_next = layers.data("trg_next", shape=[1], dtype="int64",
                               lod_level=1)
        s_emb = layers.embedding(src, size=[dict_size, emb_dim],
                                 param_attr=pt.ParamAttr(name="src_emb"))
        s_emb.seq_len = src.seq_len
        s_proj = layers.fc(s_emb, size=3 * hid, num_flatten_dims=2,
                           bias_attr=False)
        enc = layers.dynamic_gru(s_proj, size=hid)
        enc_last = layers.sequence_last_step(enc)
        t_emb = layers.embedding(trg_in, size=[dict_size, emb_dim],
                                 param_attr=pt.ParamAttr(name="trg_emb"))
        t_emb.seq_len = trg_in.seq_len
        t_proj = layers.fc(t_emb, size=3 * hid, num_flatten_dims=2,
                           param_attr=pt.ParamAttr(name="dec_wx"),
                           bias_attr=pt.ParamAttr(name="dec_bx"))
        dec = layers.dynamic_gru(t_proj, size=hid, h0=enc_last,
                                 param_attr=pt.ParamAttr(name="dec_wh"),
                                 bias_attr=False)
        scores = layers.matmul(dec, enc, transpose_y=True)
        att_w = layers.softmax(scores)
        ctx = layers.matmul(att_w, enc)
        both = layers.concat([dec, ctx], axis=2)
        both.seq_len = trg_in.seq_len
        logits = layers.fc(both, size=dict_size, num_flatten_dims=2,
                           param_attr=pt.ParamAttr(name="dec_wout"),
                           bias_attr=False)
        tok_loss = layers.softmax_with_cross_entropy(logits, trg_next)
        tok_loss.seq_len = trg_next.seq_len
        loss = layers.mean(layers.sequence_pool(tok_loss, "average"))
        pt.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(
            loss, startup_program=startup)
    reader = pt.reader.decorator.firstn(pt.dataset.wmt14.train(dict_size),
                                        768)
    return dict(main=main, startup=startup, feeds=[src, trg_in, trg_next],
                fetch=[loss], reader=reader, batch=32)


def machine_translation_infer(pt):
    """tests/test_book.py's generation program: the fused beam decoder
    over the trained decoder weights, declared by name."""
    layers = pt.layers
    dict_size, emb_dim, hid = MT["dict_size"], MT["emb_dim"], MT["hid"]
    infer, istart = pt.Program(), pt.Program()
    with pt.program_guard(infer, istart):
        src_i = layers.data("src", shape=[1], dtype="int64", lod_level=1)
        s_emb_i = layers.embedding(src_i, size=[dict_size, emb_dim],
                                   param_attr=pt.ParamAttr(name="src_emb"))
        s_emb_i.seq_len = src_i.seq_len
        s_proj_i = layers.fc(s_emb_i, size=3 * hid, num_flatten_dims=2,
                             bias_attr=False)
        enc_i = layers.dynamic_gru(s_proj_i, size=hid)
        enc_last_i = layers.sequence_last_step(enc_i)
        gb = infer.global_block
        declare = lambda name, shape: gb.create_var(  # noqa: E731
            name=name, shape=shape, dtype="float32", persistable=True)
        trg_emb_v = declare("trg_emb", [dict_size, emb_dim])
        dec_wx = declare("dec_wx", [emb_dim, 3 * hid])
        dec_bx = declare("dec_bx", [3 * hid])
        dec_wh = declare("dec_wh", [hid, 3 * hid])
        dec_wout = declare("dec_wout", [2 * hid, dict_size])
        w_dec_half, _ = layers.split(dec_wout, [hid, hid], dim=0)
        ids, scores, lens = layers.beam_search_decoder(
            enc_last_i, trg_emb_v, (dec_wx, dec_wh, dec_bx),
            (w_dec_half, None),
            beam_size=3, max_len=12, bos_id=0, eos_id=1, cell="gru")
    return infer, istart, src_i, (ids, scores, lens)


def _chunk_counts(pt, chunk, scope):
    return [np.asarray(scope.get(v.name)) if pt is jpt
            else scope.get_numpy(v.name) for v in chunk.states]


def test_label_semantic_roles():
    j, t = build_both(label_semantic_roles)
    jscope, tscope = scopes(j["startup"], t["startup"])
    j["chunk"].reset(jpt.Executor(jpt.CPUPlace()), jscope)
    t["chunk"].reset(tpt.Executor(tpt.CPUPlace()), tscope)
    jvals, tvals, _ = train_both(j, t, steps=4, jscope=jscope,
                                 tscope=tscope)
    assert_losses(jvals, tvals)
    jc = _chunk_counts(jpt, j["chunk"], jscope)
    tc = _chunk_counts(tpt, t["chunk"], tscope)
    for a, b in zip(jc, tc):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(b, a)
    assert tc[1][0] > 0  # label chunks were counted
    assert t["chunk"].eval(None, tscope) == j["chunk"].eval(None, jscope)


def test_db_lstm_depth2():
    j, t = build_both(lambda pt: db_lstm(pt, hidden_dim=32, depth=2))
    jscope, tscope = scopes(j["startup"], t["startup"])
    # the book loads the pretrained word table into the frozen "emb"
    emb = tpt.dataset.conll05.get_embedding()
    jscope.set("emb", emb)
    tscope.set("emb", torch.from_numpy(emb))
    jvals, tvals, _ = train_both(j, t, steps=3, jscope=jscope,
                                 tscope=tscope)
    assert_losses(jvals, tvals)
    for jv, tv in zip(jvals, tvals):  # the Viterbi paths of each step
        np.testing.assert_array_equal(tv[1], jv[1])
    for a, b in zip(_chunk_counts(jpt, j["chunk"], jscope),
                    _chunk_counts(tpt, t["chunk"], tscope)):
        np.testing.assert_array_equal(b, a)


def test_machine_translation_and_beam():
    j, t = build_both(machine_translation)
    jvals, tvals, (jscope, tscope) = train_both(j, t, steps=3)
    assert_losses(jvals, tvals, rtol=LOSS_RTOL)
    # generation over JAX's trained scope, carried into the port
    start = jprog.Program._uid_counter
    ji, jstart, jsrc, jouts = machine_translation_infer(jpt)
    tprog.Program._uid_counter = start
    ti, tstart, tsrc, touts = machine_translation_infer(tpt)
    assert ([op.type for op in ti.global_block.ops]
            == [op.type for op in ji.global_block.ops])
    jexe = jpt.Executor(jpt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    values = {n: np.asarray(jscope.get(n)) for n in jscope.keys()
              if n != "@RNG_STATE@"}
    tscope = tpt.scope_from_numpy(values, "cpu")
    test_src = [s for s, _, _ in
                list(tpt.dataset.wmt14.test(MT["dict_size"])())[:4]]
    feed = tpt.data_feeder.DataFeeder([tsrc]).feed([(s,) for s in test_src])
    jids, jscores, jlens = (np.asarray(v) for v in jexe.run(
        ji, feed=feed, fetch_list=list(jouts), scope=jscope))
    tids, tscores, tlens = tpt.Executor(tpt.CPUPlace()).run(
        ti, feed=feed, fetch_list=list(touts), scope=tscope)
    assert tids.shape == (4, 3, 12) and tids.dtype == np.int32
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tlens, jlens)
    np.testing.assert_allclose(tscores, jscores, rtol=1e-5, atol=1e-5)
    assert np.all(np.diff(tscores, axis=1) <= 1e-5)
    assert tlens.max() > 0  # the beams generated tokens
