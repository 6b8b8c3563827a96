"""``demos/gpt_modern.py``'s program in the port, against the JAX package,
at the demo's ``FAST`` size (T 24, 10 steps): the per-layer LM with
grouped-query attention (4 heads over 2 K/V heads), rotary positions and
RMSNorm, built headless (``include_head=False``) into the smoothed
chunked head (``fused_head_cross_entropy``, chunk 128 over vocab 211, so
the tail chunk is padded), the eval clone taken before ``minimize``,
AdamW under ``linear_lr_warmup(cosine_decay(...))``.

- The programs (main, startup, eval clone) are equal as
  ``program_to_dict`` writes them (main with its name counters
  renumbered by rank, ``test_torch_fused_head.trained_dict``).
- From JAX's startup values (the port's own startup draws them bit for
  bit), the 10 losses of the demo's loop on its synthetic corpus agree
  step by step within 2e-6 relative (measured: at most 1.8e-7; f32
  sums in another order through 10 AdamW steps), the learning rate a
  step bit for bit, and the eval clone's hidden states after training
  within 1e-5 of their largest |value| (measured: 7.9e-7), giving the
  same next-token predictions.
"""
import numpy as np
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from test_torch_book import scopes
from test_torch_fused_head import trained_dict
from test_torch_transpiler import program_dict

torch.set_num_threads(1)
VOCAB, T, D_MODEL, LAYERS, HEADS, KV_HEADS = 211, 24, 64, 2, 4, 2
BATCH, STEPS = 32, 10
LOSS_RTOL = 2e-6
HIDDEN_TOL = 1e-5


def synthetic_corpus(rng, vocab, n, T):
    """The demo's learnable language: token t+1 = (5*t + noise) % vocab."""
    x = np.zeros((n, T + 1), np.int64)
    x[:, 0] = rng.randint(0, vocab, size=n)
    for t in range(T):
        noise = rng.randint(0, 2, size=n)
        x[:, t + 1] = (5 * x[:, t] + noise) % vocab
    return x


def build(pt):
    """The demo's program in package ``pt``: (main, startup, eval clone,
    loss, hidden states, learning rate)."""
    layers, models = pt.layers, pt.models
    main_prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(main_prog, startup):
        ids = layers.data("ids", shape=[T], dtype="int64")
        tgt = layers.data("tgt", shape=[T, 1], dtype="int64")
        h = models.transformer_lm(
            ids, vocab_size=VOCAB, d_model=D_MODEL, n_layers=LAYERS,
            num_heads=HEADS, num_kv_heads=KV_HEADS, use_rope=True,
            norm_type="rms_norm", max_len=2 * T, include_head=False)
        loss = layers.mean(layers.fused_head_cross_entropy(
            h, tgt, num_classes=VOCAB, chunk=128, label_smoothing=0.05,
            param_attr=pt.ParamAttr(name="head.w")))
        eval_prog = main_prog.clone(for_test=True)
        decay = pt.learning_rate_decay
        lr = decay.linear_lr_warmup(decay.cosine_decay(3e-3,
                                                       decay_steps=150),
                                    warmup_steps=10, start_lr=3e-4,
                                    end_lr=3e-3)
        pt.optimizer.AdamWOptimizer(
            learning_rate=lr, weight_decay=0.01).minimize(
            loss, startup_program=startup)
    return main_prog, startup, eval_prog, loss, h, lr


def _both():
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        built.append(build(pt))
    return built


def test_gpt_modern_builds_the_jax_programs():
    j, t = _both()
    assert trained_dict(tpt, t[0]) == trained_dict(jpt, j[0])
    assert program_dict(tpt, t[1]) == program_dict(jpt, j[1])
    assert program_dict(tpt, t[2]) == program_dict(jpt, j[2])
    types = [op.type for op in t[0].global_block.ops]
    assert types.count("fused_head_cross_entropy") == 1
    assert "lr_warmup" in types and types.count("lr_schedule") == 1


def test_gpt_modern_trains_as_jax():
    (jm, js, je, jl, jh, jlr), (tm, ts, te, tl, th, tlr) = _both()
    jscope, tscope = scopes(js, ts)
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    rng = np.random.RandomState(0)
    jlosses, tlosses = [], []
    for _ in range(STEPS):
        seq = synthetic_corpus(rng, VOCAB, n=BATCH, T=T)
        feed = {"ids": seq[:, :-1], "tgt": seq[:, 1:, None]}
        jv = jexe.run(jm, feed=feed, fetch_list=[jl, jlr], scope=jscope)
        tv = texe.run(tm, feed=feed, fetch_list=[tl, tlr], scope=tscope)
        np.testing.assert_array_equal(np.asarray(tv[1]), np.asarray(jv[1]))
        jlosses.append(float(np.asarray(jv[0])))
        tlosses.append(float(np.asarray(tv[0])))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tlosses[-1] < tlosses[0]
    seq = synthetic_corpus(rng, VOCAB, n=16, T=T)
    feed = {"ids": seq[:, :-1], "tgt": seq[:, 1:, None]}
    jhv = np.asarray(jexe.run(je, feed=feed, fetch_list=[jh.name],
                              scope=jscope)[0], np.float32)
    thv = np.asarray(texe.run(te, feed=feed, fetch_list=[th.name],
                              scope=tscope)[0], np.float32)
    assert np.abs(thv - jhv).max() <= HIDDEN_TOL * np.abs(jhv).max()
    w = tscope.get_numpy("head.w")
    np.testing.assert_allclose(w, np.asarray(jscope.get("head.w")),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal((thv @ w).argmax(-1), (jhv @ w).argmax(-1))
