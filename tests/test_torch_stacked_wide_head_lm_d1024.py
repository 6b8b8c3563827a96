"""The stacked transformer LM at head dim 1024, against the JAX package.

``transformer_lm(pipeline_stack=True)`` (the stacked LM that the port
trains and serves densely) at d_model 1024 with one head: head dim 1024,
the head dim of the card's stacked LM at d2048 H2, where the port's f32
flash forward, dq and dkv run their slice instances on the tensor cores.
The stack hands the flash kernels f32 q/k/v under AMP too (``_attn_proj``
casts the qkv product back to the hidden dtype, as the JAX op does).
Here, on the CPU, the flash wrappers run their plain versions. L 2, T 80
(one 64-row group of the slice instances' grid and part of the next),
batch 2. Each package starts from its own startup program (bit-exact
draws); step one's loss and every parameter gradient equal the JAX
``Executor``'s: f32 at rtol 1e-4, under AMP at rtol 2e-2 / atol 2e-3
(the JAX package's AMP tolerance, as in
``tests/test_torch_transformer_layers.py``), every gradient in JAX's
dtype.
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
from paddle_tpu_torch.ops import pipeline_ops
from test_torch_transformer_layers import (AMP_TOL, F32_TOL, _assert_close,
                                           _name)

torch.set_num_threads(1)
V, T, D_MODEL, LAYERS, HEADS, BATCH = 61, 80, 1024, 2, 1, 2


def _build(pt, counter, start):
    """(main, startup, loss, parameter names) of the stacked LM with
    Adam."""
    counter.Program._uid_counter = start
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[T], dtype="int64")
        logits = pt.models.transformer_lm(
            ids, vocab_size=V, d_model=D_MODEL, n_layers=LAYERS,
            num_heads=HEADS, max_len=T, pipeline_stack=True)
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
def test_stacked_head_dim_1024_step_one_matches_jax(amp, monkeypatch):
    monkeypatch.setattr(jax_common, "_AMP", amp)
    monkeypatch.setattr(torch_common, "_AMP", amp)
    seen = []  # q/k/v dtypes and head dim the step hands the kernels
    flash = pipeline_ops.flash_attention

    def recording(q, k, v, *args, **kwargs):
        if q.device.type == "cpu":  # not build-time shape inference
            seen.append((q.dtype, k.dtype, v.dtype, q.shape[-1]))
        return flash(q, k, v, *args, **kwargs)

    monkeypatch.setattr(pipeline_ops, "flash_attention", recording)
    jout, tout, names = _step_one()
    assert len(names) == 16  # the loss and 15 stacked or shared parameters
    assert seen == [(torch.float32,) * 3 + (1024,)] * LAYERS
    for name, j, t in zip(names, jout, tout):
        _assert_close(t, j, AMP_TOL if amp else F32_TOL, name)
