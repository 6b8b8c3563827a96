"""The Wide&Deep CTR flagship (``models.wide_deep``) in the port against
the JAX package, on ``dataset.ctr``'s click-stream, on the CPU.

- Both builders give equal programs as ``program_to_dict`` writes them
  (main and startup with their name counters renumbered by rank,
  ``test_torch_fused_head.trained_dict``: the learning-rate var's number
  follows each backward's count of names), with ``is_sparse`` on and
  off.
- From JAX's startup values (the port's own startup draws them bit for
  bit), 5 Adagrad steps over the same batches: the losses within
  LOSS_RTOL of JAX's, the AUC histograms equal, and the embedding
  tables' rows no batch looked up exact.
- The twin of ``tests/test_sparse_embedding.py``'s
  ``test_wide_deep_ctr_trains_large_vocab``: vocabulary 10^5, sparse
  gradients, 60 Adagrad steps; the loss falls and the AUC over the last
  20 steps exceeds 0.65.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.selected_rows import SelectedRows
from test_torch_book import scopes
from test_torch_fused_head import trained_dict

torch.set_num_threads(1)
VOCAB, EMBED, HIDDEN, BATCH = 5000, 8, (32, 16), 64
LOSS_RTOL = 1e-5


def build(pt, vocab=VOCAB, embed=EMBED, hidden=HIDDEN, is_sparse=True):
    main, startup = pt.Program(), pt.Program()
    ctr = pt.dataset.ctr
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[ctr.SLOTS], dtype="int64")
        dense = pt.layers.data("dense", shape=[ctr.DENSE_DIM])
        label = pt.layers.data("label", shape=[1])
        logit = pt.models.wide_deep(ids, dense, vocab_size=vocab,
                                    embed_dim=embed, hidden_sizes=hidden,
                                    is_sparse=is_sparse)
        loss, prob = pt.models.wide_deep_loss(logit, label)
        auc = pt.evaluator.Auc(prob, label, main_program=main,
                               startup_program=startup)
        pt.optimizer.AdagradOptimizer(learning_rate=0.05).minimize(
            loss, startup_program=startup)
    return main, startup, loss, auc


def _both(**kw):
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        built.append(build(pt, **kw))
    return built


def _batches(n, vocab=VOCAB, batch=BATCH):
    rows = list(tpt.dataset.ctr.train(n * batch, vocab=vocab)())
    return [tpt.dataset.ctr.make_batch(rows[i * batch:(i + 1) * batch])
            for i in range(n)]


@pytest.mark.parametrize("is_sparse", [True, False])
def test_wide_deep_builds_the_jax_programs(is_sparse):
    (jm, js, _, _), (tm, ts, _, _) = _both(is_sparse=is_sparse)
    assert trained_dict(tpt, tm) == trained_dict(jpt, jm)
    assert trained_dict(tpt, ts) == trained_dict(jpt, js)
    types = [op.type for op in tm.global_block.ops]
    assert types.count("sparse_adagrad") == (2 if is_sparse else 0)
    assert types.count("auc_histogram") == 1


def test_wide_deep_trains_as_jax():
    (jm, js, jl, jauc), (tm, ts, tl, tauc) = _both()
    jscope, tscope = scopes(js, ts)
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    tables = [op.inputs["W"][0] for op in tm.global_block.ops
              if op.type == "lookup_table"]
    w0 = {n: tscope.get_numpy(n).copy() for n in tables}
    seen = np.zeros(VOCAB, bool)
    jlosses, tlosses = [], []
    for feed in _batches(5):
        seen[feed["ids"].ravel()] = True
        jlosses.append(float(np.asarray(jexe.run(
            jm, feed=feed, fetch_list=[jl], scope=jscope)[0])))
        tlosses.append(float(texe.run(tm, feed=feed, fetch_list=[tl],
                                      scope=tscope)[0]))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    for jv, tv in zip(jauc.states, tauc.states):
        np.testing.assert_array_equal(tscope.get_numpy(tv.name),
                                      np.asarray(jscope.get(jv.name)))
    for n in tables:
        got, want = tscope.get_numpy(n), np.asarray(jscope.get(n))
        np.testing.assert_array_equal(got[~seen], w0[n][~seen])
        np.testing.assert_array_equal(got[~seen], want[~seen])
        np.testing.assert_allclose(got[seen], want[seen], rtol=1e-4,
                                   atol=1e-6)


def test_wide_deep_grad_stays_rows():
    """The sparse step's embedding gradients are SelectedRows of the
    batch's ids, never a [V, D] tensor."""
    main, startup, loss, _ = build(tpt)
    grads = {op.outputs["IG:W"][0] for op in main.global_block.ops
             if op.type == "grad_custom"
             and op.attrs["fwd_type"] == "lookup_table"}
    assert len(grads) == 2
    from paddle_tpu_torch.core.registry import get_op

    seen = {}
    fn = get_op("sparse_adagrad").fn

    def spy(attrs, ins):
        seen[len(seen)] = ins["Grad"][0]
        return fn(attrs, ins)

    get_op("sparse_adagrad").fn = spy
    try:
        scope = tpt.Scope()
        exe = tpt.Executor(tpt.CPUPlace())
        exe.run(startup, scope=scope)
        exe.run(main, feed=_batches(1)[0], scope=scope)
    finally:
        get_op("sparse_adagrad").fn = fn
    assert len(seen) == 2
    for g in seen.values():
        assert isinstance(g, SelectedRows) and g.height == VOCAB
        assert g.values.shape[0] == BATCH * tpt.dataset.ctr.SLOTS


def test_wide_deep_ctr_trains_large_vocab():
    """The CTR book test: vocabulary 10^5 with sparse gradients; the
    loss falls and the AUC of the trained model exceeds 0.65."""
    vocab = 100_000
    main, startup, loss, auc = build(tpt, vocab=vocab)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    losses = []
    for step, feed in enumerate(_batches(60, vocab=vocab)):
        if step == 40:  # the AUC of the trained model only
            auc.reset(exe, scope)
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), losses
    assert auc.eval(exe, scope) > 0.65
