"""The chunked LM head ``fused_head_cross_entropy`` in the port, against
the JAX package.

The op on numpy inputs from a seed, at the (vocab, chunk) cases of
``tests/test_fused_head.py`` and ``tests/test_modern_training.py``
(chunks that divide the vocab, a padded tail chunk, a vocab below one
chunk, label smoothing) and the ``gpt_modern`` demo's (211, 128, 0.05),
with [n, d] and rank-3 [b, T, d] inputs:

- f32: Loss and LSE within 1e-6 relative of JAX's (the online
  logsumexp's sums run in another order), dX and dW from the chunked
  backward within 1e-5 of each gradient's norm (the largest |gap| over
  the norm);
- bf16 (AMP in both packages): the products take bf16 operands with f32
  sums in both, and g = (p - target) * dLoss is rounded to bf16 before
  the dX/dW products, where a one-ulp difference in p moves an element
  of g by a bf16 ulp. Measured over 20 seeds of these cases: a one-ulp
  nudge of the saved LSE moves JAX's own dX by up to 3.0e-5 of its norm
  and dW by up to 3.7e-5, and the port stays within 1.7e-6 of JAX. Held:
  the loss within 1e-6 relative, the gradients within 1.5e-4 of their
  norms (4x the nudge's move).

Through programs: the layer builds the JAX package's program dict (its
name counters renumbered by rank, ``trained_dict``); one
SGD step from the same weights gives the same loss and gradients; the
fused head equals ``fc`` + ``softmax_with_cross_entropy`` in the port
too; labels on chunk boundaries gather the right logit;
``vocab_parallel=True`` without a mesh runs the serial path. And the
raises: a gradient without Loss@GRAD or with one on LSE, soft labels,
label_smoothing outside [0, 1), a headless stacked LM. Inside a recompute
segment autograd through the forward gives the chunked gradients.
"""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op as torch_op
from test_torch_book import scopes
from test_torch_transpiler import program_dict

torch.set_num_threads(1)
LOSS_RTOL = 1e-6
GRAD_NORM_TOL = 1e-5
BF16_GRAD_NORM_TOL = 1.5e-4

# (vocab, chunk, label_smoothing, lead shape of X)
CASES = [
    (64, 16, 0.0, (6,)), (96, 40, 0.0, (6,)), (50, 7, 0.0, (6,)),
    (128, 8192, 0.0, (6,)), (97, 32, 0.0, (6,)),
    (24, 8, 0.2, (6,)), (26, 8, 0.2, (6,)),
    (211, 128, 0.05, (3, 8)), (97, 32, 0.1, (2, 5)),
]


def _inputs(vocab, lead, d=16, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*lead, d) * 0.5).astype(np.float32)
    w = (rng.randn(d, vocab) * 0.3).astype(np.float32)
    lab = rng.randint(0, vocab, lead + (1,)).astype(np.int64)
    dloss = rng.rand(*lead, 1).astype(np.float32)
    return x, w, lab, dloss


def _both(attrs, x, w, lab, dloss):
    """(Loss, LSE, dX, dW) in each package, as numpy f32."""
    res = []
    for get, conv in ((jax_op, jnp.asarray), (torch_op, torch.from_numpy)):
        op = get("fused_head_cross_entropy")
        ins = {"X": [conv(x)], "W": [conv(w)], "Label": [conv(lab)]}
        outs = op.fn(attrs, ins)
        grads = op.grad_fn(attrs, ins, outs, {"Loss": [conv(dloss)]})
        res.append([_np(t) for t in (outs["Loss"][0], outs["LSE"][0],
                                     grads["X"][0], grads["W"][0])])
    return res


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def trained_dict(pt, program):
    """``program_dict`` of a program with a backward, its name counters
    renumbered by rank: the port's backward draws one more name a generic
    grad op (its ``_vjp_key``, stripped), so the names the backward and
    later layers make carry other numbers in each package, in the same
    order. Nested grad attrs lose JAX's ``_callsite`` too."""
    d = program_dict(pt, program)
    for b in d["blocks"]:
        for op in b["ops"]:
            op["attrs"].get("fwd_attrs", {}).pop("_callsite", None)
            op["attrs"].get("fwd_attrs", {}).pop("_vjp_key", None)
    text = json.dumps(d, sort_keys=True)
    uids = sorted({int(m) for m in re.findall(r"_(\d+)(?=[@.\"])", text)})
    rank = {u: i for i, u in enumerate(uids)}
    return json.loads(re.sub(r"_(\d+)(?=[@.\"])",
                             lambda m: f"_#{rank[int(m.group(1))]}", text))


def _norm_gap(got, want):
    return float(np.abs(got - want).max() / np.linalg.norm(want))


@pytest.mark.parametrize("vocab,chunk,eps,lead", CASES)
def test_op_and_chunked_grad_match_jax(vocab, chunk, eps, lead):
    x, w, lab, dloss = _inputs(vocab, lead)
    attrs = {"chunk": chunk, "label_smoothing": eps}
    (jl, jlse, jdx, jdw), (tl, tlse, tdx, tdw) = _both(attrs, x, w, lab,
                                                       dloss)
    assert tl.shape == jl.shape == lead + (1,)
    assert tlse.shape == jlse.shape == lead
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlse, jlse, rtol=LOSS_RTOL)
    assert tdx.shape == x.shape and tdw.shape == w.shape
    assert _norm_gap(tdx, jdx) <= GRAD_NORM_TOL
    assert _norm_gap(tdw, jdw) <= GRAD_NORM_TOL


@pytest.mark.parametrize("seed", [2, 5, 6])
@pytest.mark.parametrize("vocab,chunk,eps,lead",
                         [(128, 32, 0.0, (8,)), (211, 128, 0.05, (3, 8))])
def test_op_under_amp_matches_jax(monkeypatch, vocab, chunk, eps, lead,
                                  seed):
    monkeypatch.setattr(jpt.ops.common, "_AMP", True)
    monkeypatch.setattr(tpt.ops.common, "_AMP", True)
    x, w, lab, dloss = _inputs(vocab, lead, d=32, seed=seed)
    attrs = {"chunk": chunk, "label_smoothing": eps}
    (jl, jlse, jdx, jdw), (tl, tlse, tdx, tdw) = _both(attrs, x, w, lab,
                                                       dloss)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlse, jlse, rtol=LOSS_RTOL)
    assert _norm_gap(tdx, jdx) <= BF16_GRAD_NORM_TOL
    assert _norm_gap(tdw, jdw) <= BF16_GRAD_NORM_TOL


def test_amp_keeps_the_chunk_logits_in_f32(monkeypatch):
    """Under AMP the loss is the f32 logsumexp of bf16-operand products,
    not of logits rounded to bf16."""
    monkeypatch.setattr(tpt.ops.common, "_AMP", True)
    x, w, lab, _ = _inputs(64, (6,), d=32, seed=4)
    op = torch_op("fused_head_cross_entropy")
    got = op.fn({"chunk": 16}, {"X": [torch.from_numpy(x)],
                                "W": [torch.from_numpy(w)],
                                "Label": [torch.from_numpy(lab)]})
    xb = torch.from_numpy(x).bfloat16().double()
    wb = torch.from_numpy(w).bfloat16().double()
    logits = xb @ wb
    lse = torch.logsumexp(logits, dim=1)
    want = lse - logits.gather(1, torch.from_numpy(lab))[:, 0]
    assert got["Loss"][0].dtype == torch.float32
    np.testing.assert_allclose(got["Loss"][0][:, 0].numpy(), want.numpy(),
                               rtol=1e-6)


def test_grad_raises_without_loss_grad_or_with_lse_grad():
    x, w, lab, dloss = _inputs(32, (4,))
    op = torch_op("fused_head_cross_entropy")
    ins = {"X": [torch.from_numpy(x)], "W": [torch.from_numpy(w)],
           "Label": [torch.from_numpy(lab)]}
    outs = op.fn({"chunk": 8}, ins)
    with pytest.raises(NotImplementedError, match="Loss@GRAD"):
        op.grad_fn({"chunk": 8}, ins, outs, {})
    with pytest.raises(NotImplementedError, match="auxiliary"):
        op.grad_fn({"chunk": 8}, ins, outs,
                   {"Loss": [torch.from_numpy(dloss)],
                    "LSE": [torch.ones(4)]})
    with pytest.raises(NotImplementedError, match="hard labels"):
        op.fn({"chunk": 8, "soft_label": True}, ins)


def _build(pt, vocab, chunk, d, eps, fused=True, vocab_parallel=False):
    L = pt.layers
    x = L.data("x", shape=[d])
    x.stop_gradient = False
    lab = L.data("lab", shape=[1], dtype="int64")
    if fused:
        loss = L.fused_head_cross_entropy(
            x, lab, num_classes=vocab, chunk=chunk, label_smoothing=eps,
            vocab_parallel=vocab_parallel,
            param_attr=pt.ParamAttr(name="headw"))
    else:
        logits = L.fc(x, size=vocab, bias_attr=False,
                      param_attr=pt.ParamAttr(name="headw"))
        loss = L.softmax_with_cross_entropy(logits, lab,
                                            label_smoothing=eps)
    loss = L.mean(loss)
    pt.optimizer.SGDOptimizer(learning_rate=0.0).minimize(loss)
    return loss


def _programs(vocab, chunk, d, eps, **kw):
    """(main, startup, loss) in each package from the same name counter."""
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 7
        with pt.program_guard(main, startup):
            loss = _build(pt, vocab, chunk, d, eps, **kw)
        built.append((main, startup, loss))
    return built


def _step(pt, main, startup, loss, feed, fetch, scope=None):
    exe = pt.Executor(pt.CPUPlace())
    if scope is None:
        scope = pt.Scope()
        exe.run(startup, scope=scope)
    outs = exe.run(main, feed=feed, fetch_list=[loss] + fetch, scope=scope)
    return [np.asarray(o, np.float32) for o in outs]


@pytest.mark.parametrize("vocab,chunk,eps", [(97, 32, 0.0), (26, 8, 0.2)])
def test_layer_builds_the_jax_program_and_steps_alike(vocab, chunk, eps):
    d, n = 16, 6
    (jm, js, jloss), (tm, ts, tloss) = _programs(vocab, chunk, d, eps)
    for jp, tp in ((jm, tm), (js, ts), (jm.clone(for_test=True),
                                        tm.clone(for_test=True))):
        assert trained_dict(tpt, tp) == trained_dict(jpt, jp)
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(n, d).astype(np.float32),
            "lab": rng.randint(0, vocab, (n, 1)).astype(np.int64)}
    fetch = ["x@GRAD", "headw@GRAD"]
    jscope, tscope = scopes(js, ts)
    want = _step(jpt, jm, js, jloss, feed, fetch, scope=jscope)
    got = _step(tpt, tm, ts, tloss, feed, fetch, scope=tscope)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for g, w in zip(got[1:], want[1:]):
        assert _norm_gap(g, w) <= GRAD_NORM_TOL


@pytest.mark.parametrize("vocab,chunk,eps", [(64, 16, 0.0), (50, 7, 0.0),
                                             (26, 8, 0.2)])
def test_fused_head_equals_the_unfused_head_in_the_port(vocab, chunk, eps):
    d, n = 16, 6
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(n, d).astype(np.float32) * 0.5,
            "lab": rng.randint(0, vocab, (n, 1)).astype(np.int64)}
    fetch = ["x@GRAD", "headw@GRAD"]
    outs = []
    for fused in (True, False):
        main, startup = tpt.Program(), tpt.Program()
        startup.random_seed = 3
        with tpt.program_guard(main, startup):
            loss = _build(tpt, vocab, chunk, d, eps, fused=fused)
        outs.append(_step(tpt, main, startup, loss, feed, fetch))
    for g, w in zip(*outs):
        np.testing.assert_allclose(g, w, rtol=3e-5, atol=3e-6)


def test_vocab_parallel_without_a_mesh_runs_the_serial_path():
    d, n, vocab = 16, 6, 50
    rng = np.random.RandomState(2)
    feed = {"x": rng.randn(n, d).astype(np.float32),
            "lab": rng.randint(0, vocab, (n, 1)).astype(np.int64)}
    outs = []
    for vp in (False, True):
        main, startup = tpt.Program(), tpt.Program()
        startup.random_seed = 3
        with tpt.program_guard(main, startup):
            loss = _build(tpt, vocab, 16, d, 0.0, vocab_parallel=vp)
        outs.append(_step(tpt, main, startup, loss, feed,
                          ["x@GRAD", "headw@GRAD"]))
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)


def test_labels_on_chunk_boundaries_gather_the_right_logit():
    vocab, chunk, d = 64, 16, 8
    rng = np.random.RandomState(0)
    x = rng.randn(4, d).astype(np.float32)
    labs = np.array([[0], [15], [16], [63]], np.int64)
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        xv = tpt.layers.data("x", shape=[d])
        lab = tpt.layers.data("lab", shape=[1], dtype="int64")
        loss = tpt.layers.fused_head_cross_entropy(
            xv, lab, num_classes=vocab, chunk=chunk,
            param_attr=tpt.ParamAttr(name="bw"))
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    (lv,) = exe.run(main, feed={"x": x, "lab": labs}, fetch_list=[loss],
                    scope=scope)
    logits = x.astype(np.float64) @ scope.get_numpy("bw").astype(np.float64)
    lse = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) \
        + logits.max(1)
    want = (lse - logits[np.arange(4), labs[:, 0]])[:, None]
    np.testing.assert_allclose(np.asarray(lv), want, rtol=1e-5, atol=1e-6)


def test_layer_checks_label_smoothing_and_the_stacked_head():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", shape=[8])
        lab = tpt.layers.data("lab", shape=[1], dtype="int64")
        for eps in (-0.1, 1.0):
            with pytest.raises(ValueError, match="label_smoothing"):
                tpt.layers.fused_head_cross_entropy(
                    x, lab, num_classes=16, label_smoothing=eps)
        ids = tpt.layers.data("ids", shape=[8], dtype="int64")
        n_ops = len(main.global_block.ops)
        with pytest.raises(ValueError, match="include_head"):
            tpt.models.transformer_lm(ids, vocab_size=32, d_model=16,
                                      n_layers=1, num_heads=1, max_len=8,
                                      include_head=False,
                                      pipeline_stack=True)
        assert len(main.global_block.ops) == n_ops


def test_inside_a_recompute_segment_autograd_gives_the_chunked_grads():
    """``grad_fn_is_optimization``: in a recompute segment the head is
    differentiated through its forward by autograd, and gives the chunked
    backward's gradients (within GRAD_NORM_TOL of each norm)."""
    import contextlib

    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(6, 16).astype(np.float32),
            "lab": rng.randint(0, 50, (6, 1)).astype(np.int64)}
    outs, types = [], []
    for remat in (False, True):
        main, startup = tpt.Program(), tpt.Program()
        startup.random_seed = 3
        with tpt.program_guard(main, startup):
            x = tpt.layers.data("x", shape=[16])
            x.stop_gradient = False
            lab = tpt.layers.data("lab", shape=[1], dtype="int64")
            with (tpt.recompute_guard() if remat
                  else contextlib.nullcontext()):
                h = tpt.layers.fc(x, size=16, act="tanh",
                                  param_attr=tpt.ParamAttr(name="f.w"))
                loss = tpt.layers.fused_head_cross_entropy(
                    h, lab, num_classes=50, chunk=16, label_smoothing=0.1,
                    param_attr=tpt.ParamAttr(name="hw"))
            loss = tpt.layers.mean(loss)
            tpt.optimizer.SGDOptimizer(0.0).minimize(loss)
        types.append([op.type for op in main.global_block.ops])
        outs.append(_step(tpt, main, startup, loss, feed,
                          ["x@GRAD", "hw@GRAD", "f.w@GRAD"]))
    assert "grad_custom" in types[0] and "grad_seg" in types[1]
    assert "grad_custom" not in types[1]
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=LOSS_RTOL)
    for g, w in zip(outs[1][1:], outs[0][1:]):
        assert _norm_gap(g, w) <= GRAD_NORM_TOL
