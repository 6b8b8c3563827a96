"""The per-layer transformer LM at head dim 1024, against the JAX package.

``transformer_lm(pipeline_stack=False)`` (the model the JAX package's
benchmark trains) at d_model 1024 with 1 head: head dim 1024, the head
dim of the card's per-layer LM at d2048 H2 (``chip_smoke.py`` phase 12f),
where under AMP the port's bf16 flash forward, dq and dkv run their slice
instances on ``wgmma`` (past head dim 512). Here, on the CPU, the flash
wrappers run their plain versions. L 2, T 80 (a ragged 64-row block past
the first), batch 2. Each package starts from its own startup program
(bit-exact draws); step one's loss and every parameter gradient equal
the JAX ``Executor``'s: f32 at rtol 1e-4, under AMP at rtol 2e-2 / atol
2e-3 (the JAX package's AMP tolerance, as in
``tests/test_torch_transformer_layers.py`` and
``tests/test_torch_wide_head_lm_d512.py`` at head dim 512), every
gradient in JAX's dtype.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.ops.common as jax_common
import paddle_tpu_torch as tpt
import paddle_tpu_torch.ops.common as torch_common
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from test_torch_transformer_layers import (AMP_TOL, F32_TOL, _assert_close,
                                           _name)

torch.set_num_threads(1)
V, T, D_MODEL, LAYERS, HEADS, BATCH = 61, 80, 1024, 2, 1, 2


def _build(pt, counter, start):
    """(main, startup, loss, parameter names) of the LM with Adam."""
    counter.Program._uid_counter = start
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[T], dtype="int64")
        logits = pt.models.transformer_lm(
            ids, vocab_size=V, d_model=D_MODEL, n_layers=LAYERS,
            num_heads=HEADS, max_len=T)
        tgt = pt.layers.data("tgt", shape=[T], dtype="int64")
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.reshape(logits, shape=[-1, V]),
            pt.layers.reshape(tgt, shape=[-1, 1])))
        pgs = pt.optimizer.AdamOptimizer(1e-3).minimize(
            loss, startup_program=startup)
    return main, startup, loss, [p.name for p, _ in pgs]


def _step_one():
    """Each package's own startup, then one step: (JAX fetches, port
    fetches, names) of the loss and every parameter gradient."""
    start = jprog.Program._uid_counter
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, V, size=(BATCH, T)).astype(np.int64),
            "tgt": rng.randint(0, V, size=(BATCH, T)).astype(np.int64)}
    fetched, names = [], None
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        main, startup, loss, params = _build(pt, counter, start)
        assert names is None or names[1:] == [f"{p}@GRAD" for p in params]
        names = [loss.name] + [f"{p}@GRAD" for p in params]
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        fetched.append(exe.run(main, feed=feed, fetch_list=names,
                               scope=scope, return_numpy=False))
    return fetched[0], fetched[1], names


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_head_dim_1024_step_one_matches_jax(amp, monkeypatch):
    monkeypatch.setattr(jax_common, "_AMP", amp)
    monkeypatch.setattr(torch_common, "_AMP", amp)
    jout, tout, names = _step_one()
    assert len(names) == 26  # the loss and 25 parameters
    if amp:
        assert {_name(t.dtype) for t in tout[1:]} == {"bfloat16", "float32"}
    for name, j, t in zip(names, jout, tout):
        _assert_close(t, j, AMP_TOL if amp else F32_TOL, name)
