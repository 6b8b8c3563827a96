"""The reference benchmark's recurrent and decode rows, built by the same
code in both packages.

``bench.py``'s ``bench_lstm_step`` (2 x LSTM over a fixed-T feed,
max-pooled, a 2-way head, Adam) and ``bench_lstm_varlen`` (the same over
a ``lod_level=1`` feed with ragged lengths, one of them 0 here), a
``dynamic_gru`` twin of each (3 x hidden projections), and
``bench_decode``'s ``transformer_lm_generate`` program, at hidden 8,
vocab 50, batch 4, T <= 12 (the LM at 2 layers, d 32). Each program is
built by one function with ``pt`` set to each package in turn, with the
name counters synced:

- every variable's dtype equals JAX's, in f32 and under AMP (where the
  ``lstm``/``gru`` weights and biases, and the ``fc`` layers behind a
  bf16 activation, are declared bf16, and Adam keeps them bf16);
- each package's own startup draws the same parameters bit for bit (the
  RNG plane);
- step 1's loss and every parameter gradient match JAX's: f32 at rtol
  1e-5 with an atol of 1e-6 of each tensor's largest |value|; under AMP
  the loss at rtol 2e-3 (the AMP LM test's) and each gradient within 8
  bf16 ulps of its largest |value| (``tests/test_torch_rnn.py``: XLA's
  bf16 sigmoid rounds differently from torch's). A bf16 hidden state one
  ulp apart can move the max-pool's argmax at a near-tie, which sends
  that feature's gradient down another time step: where the pooled
  argmax differs (measured: 1 of the 32 (row, feature) pairs of the
  fixed-T GRU twin), each difference must be a near-tie (within 2 bf16
  ulps of JAX's maximum), at most 1 in 16 of the pairs, and each
  gradient within 15% of its norm of JAX's (measured at most 11%);
- Hidden is 0 on padding and LastH is Hidden at length - 1;
- the greedy tokens of the generation program are equal.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.ops.common as jax_common
import paddle_tpu_torch as tpt
import paddle_tpu_torch.ops.common as torch_common
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog

torch.set_num_threads(1)
BATCH, SEQLEN, HIDDEN, VOCAB = 4, 12, 8, 50
LENGTHS = np.array([12, 5, 0, 9], np.int32)
F32_RTOL, F32_ATOL = 1e-5, 1e-6
AMP_LOSS_RTOL, AMP_ULPS = 2e-3, 8
AMP_FLIP_GAP = 0.15  # of each gradient's norm, after a max-pool flip


def _argmax_flips(want, got, ragged):
    """(row, feature) pairs of the max-pool whose argmax differs between
    JAX's pooled sequence ``want`` and the port's ``got`` [b, T, h]. Each
    must be a near-tie: the port's pick lies within 2 bf16 ulps of JAX's
    maximum."""
    lengths = LENGTHS if ragged else np.full(BATCH, SEQLEN)
    valid = np.arange(want.shape[1])[None, :, None] < lengths[:, None, None]
    low = np.float32(-3e38)
    w, g = np.where(valid, want, low), np.where(valid, got, low)
    picks_w, picks_g = w == w.max(1, keepdims=True), g == g.max(1,
                                                                keepdims=True)
    flipped = (picks_w != picks_g).any(axis=1)
    top = w.max(1)
    for row, feat in zip(*np.nonzero(flipped)):
        ulp = 2.0 ** (np.floor(np.log2(abs(top[row, feat]))) - 7)
        chosen = w[row, picks_g[row, :, feat], feat]
        assert (top[row, feat] - chosen <= 2 * ulp).all(), (row, feat)
    assert flipped.sum() <= flipped.size // 16, flipped.sum()
    return int(flipped.sum())


def _recurrent(pt, x, rnn):
    layers = pt.layers
    size = (4 if rnn == "lstm" else 3) * HIDDEN
    proj = layers.fc(x, size=size, num_flatten_dims=2, bias_attr=False)
    proj.seq_len = getattr(x, "seq_len", None)
    if rnn == "lstm":
        h, _ = layers.dynamic_lstm(proj, size)
    else:
        h = layers.dynamic_gru(proj, HIDDEN)
    return h


def _build(pt, ragged, rnn="lstm"):
    """bench_lstm_step (``ragged`` False) or bench_lstm_varlen (True)
    with ``pt`` the package; ``rnn="gru"`` swaps each dynamic_lstm for a
    dynamic_gru. Returns (main, startup, loss, [(param, grad)], the
    first layer's Hidden and LastH names and the pooled sequence's)."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 5
    with pt.program_guard(main, startup):
        if ragged:
            words = layers.data("words", shape=[1], dtype="int64",
                                lod_level=1)
        else:
            words = layers.data("words", shape=[SEQLEN], dtype="int64")
        label = layers.data("label", shape=[1], dtype="int64")
        emb = layers.embedding(words, size=[VOCAB, HIDDEN])
        emb.seq_len = getattr(words, "seq_len", None)
        h1 = _recurrent(pt, emb, rnn)
        h2 = _recurrent(pt, h1, rnn)
        pooled = layers.sequence_pool(h2, "max")
        logits = layers.fc(pooled, size=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        params_grads = pt.optimizer.AdamOptimizer(
            learning_rate=1e-3).minimize(loss, startup_program=startup)
    op = next(o for o in main.global_block.ops if o.type in ("lstm", "gru"))
    return (main, startup, loss, params_grads,
            (op.outputs["Hidden"][0], op.outputs["LastH"][0], h2.name))


def _feed(ragged):
    rng = np.random.RandomState(0)
    feed = {"words": rng.randint(0, VOCAB, (BATCH, SEQLEN)).astype("int64"),
            "label": rng.randint(0, 2, (BATCH, 1)).astype("int64")}
    if ragged:
        feed["words@len"] = LENGTHS
    return feed


def _norm(name):
    """A name without the counters each package's backward advances its
    own way (x@GRAD@R_9, learning_rate_11)."""
    return re.sub(r"(@[A-Z]+|learning_rate)_\d+", r"\1", name)


def _var_dtypes(program):
    """(name, dtype) of every variable; int64 reads as int32, as the JAX
    package carries it without x64."""
    return sorted((_norm(n), str(v.dtype).replace("torch.", "")
                   .replace("int64", "int32"))
                  for n, v in program.global_block.vars.items())


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tol(want, amp):
    top = float(np.abs(want).max())
    if amp:
        return dict(rtol=0, atol=AMP_ULPS * 2.0 ** (np.floor(np.log2(top))
                                                    - 7))
    return dict(rtol=F32_RTOL, atol=F32_ATOL * max(1.0, top))


@pytest.fixture(params=["f32", "amp"])
def amp(request, monkeypatch):
    on = request.param == "amp"
    monkeypatch.setattr(jax_common, "_AMP", on)
    monkeypatch.setattr(torch_common, "_AMP", on)
    return on


class _Pair:
    def __init__(self, ragged, rnn):
        start = jprog.Program._uid_counter
        self.j = _build(jpt, ragged, rnn)
        tprog.Program._uid_counter = start
        self.t = _build(tpt, ragged, rnn)
        self.feed = _feed(ragged)
        self.jscope, self.tscope = jpt.Scope(), tpt.Scope()
        self.jexe = jpt.Executor(jpt.CPUPlace())
        self.texe = tpt.Executor(tpt.CPUPlace())
        self.jexe.run(self.j[1], scope=self.jscope)
        self.texe.run(self.t[1], scope=self.tscope)

    def step(self, extra=()):
        names = [self.j[2].name] + [g.name for _, g in self.j[3]]
        names += list(extra)
        jout = self.jexe.run(self.j[0], feed=self.feed, fetch_list=names,
                             scope=self.jscope, return_numpy=False)
        tout = self.texe.run(self.t[0], feed=self.feed, fetch_list=names,
                             scope=self.tscope, return_numpy=False)
        return names, jout, tout


CASES = [(False, "lstm"), (True, "lstm"), (False, "gru"), (True, "gru")]
IDS = ["lstm", "lstm_varlen", "gru", "gru_varlen"]


@pytest.mark.parametrize("ragged,rnn", CASES, ids=IDS)
def test_step_one_matches_jax(amp, ragged, rnn):
    pair = _Pair(ragged, rnn)
    assert _var_dtypes(pair.t[0]) == _var_dtypes(pair.j[0])
    params = [p.name for p, _ in pair.j[3]]
    assert params == [p.name for p, _ in pair.t[3]]
    declared = {p.name: str(p.dtype) for p, _ in pair.j[3]}
    rnn_params = [n for n in params if n.startswith(rnn)]
    assert len(rnn_params) == 4
    want = "bfloat16" if amp else "float32"
    assert {declared[n] for n in rnn_params} == {want}
    assert declared[params[0]] == "float32"  # the embedding
    for name in params:  # each package's own startup: the same draws
        np.testing.assert_array_equal(
            tpt.core.types.to_numpy(pair.tscope.get(name)),
            _f32(pair.jscope.get(name)), err_msg=name)

    names, jout, tout = pair.step(pair.t[4])
    jl, tl = _f32(jout[0]), tpt.core.types.to_numpy(tout[0])
    np.testing.assert_allclose(
        tl, jl, rtol=AMP_LOSS_RTOL if amp else F32_RTOL, atol=0)
    flips = (_argmax_flips(_f32(jout[-1]), tout[-1].float().numpy(), ragged)
             if amp else 0)
    for name, j, t in zip(names[1:-3], jout[1:-3], tout[1:-3]):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), name
        w, g = _f32(j), tpt.core.types.to_numpy(t)
        assert np.isfinite(w).all() and np.abs(w).max() > 0, name
        if flips:
            gap = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert gap <= AMP_FLIP_GAP, (name, gap, flips)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **_tol(w, amp))
    h, lh = tout[-3].float(), tout[-2].float()
    if ragged:
        for row, n in enumerate(LENGTHS):
            assert not h[row, n:].any(), row
            if n:
                assert torch.equal(lh[row], h[row, n - 1]), row

    # Adam keeps every parameter in its declared dtype, in both
    for name in params:
        assert (str(pair.tscope.get(name).dtype).replace("torch.", "")
                == str(pair.jscope.get(name).dtype) == declared[name])


def test_varlen_trains_and_the_loss_falls():
    """The port's own startup and ten Adam steps on one ragged batch
    (f32): the loss falls, as bench.py's timed loop expects."""
    main, startup, loss, _, _ = _build(tpt, ragged=True)
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _feed(True)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(10)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# --- bench_decode: the generation program --------------------------------
LM = dict(vocab_size=61, d_model=32, n_layers=2, num_heads=2)
PROMPT, NEW = 9, 6


def _generate_program(pt):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 9
    with pt.program_guard(main, startup):
        prompt = pt.layers.data("prompt", shape=[PROMPT], dtype="int64")
        out_ids = pt.models.transformer_lm_generate(
            prompt, max_len=PROMPT + NEW, max_new_tokens=NEW, **LM)
    return main, startup, out_ids


def test_generate_program_greedy_tokens_equal_jax():
    start = jprog.Program._uid_counter
    jmain, jstart, jout = _generate_program(jpt)
    tprog.Program._uid_counter = start
    tmain, tstart, tout = _generate_program(tpt)
    assert _var_dtypes(tmain) == _var_dtypes(jmain)
    assert [op.type for op in tmain.global_block.ops] == [
        op.type for op in jmain.global_block.ops]
    feed = {"prompt": np.random.RandomState(1).randint(
        0, LM["vocab_size"], (3, PROMPT)).astype("int64")}
    jscope, tscope = jpt.Scope(), tpt.Scope()
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    want, = jexe.run(jmain, feed=feed, fetch_list=[jout], scope=jscope)
    got, = texe.run(tmain, feed=feed, fetch_list=[tout], scope=tscope)
    assert got.shape == (3, PROMPT + NEW)
    np.testing.assert_array_equal(got[:, :PROMPT], feed["prompt"])
    np.testing.assert_array_equal(got, np.asarray(want))
