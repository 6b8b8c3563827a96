"""The stacked transformer op's ``remat`` in the port, against the JAX
package.

``transformer_lm(pipeline_stack=True)`` at vocab 61, d 64, 2 layers, 4
heads, T 40, batch 2, Adam, with ``remat`` False, True (each layer
recomputed whole in the backward, ``torch.utils.checkpoint``) and
``"dots"`` (the layer input and the four named tensors ``qkv_proj``,
``attn_ctx``, ``attn_out`` and ``ffn_hidden`` kept, the rest
recomputed), with learned positions and with RoPE. Each package starts
from its own startup (bit-exact draws); step one's loss and every
parameter gradient equal the JAX ``Executor``'s at rtol 1e-4 / atol 1e-6
(the port's f32 tolerance against JAX). ``remat=True`` equals the port's
``remat=False`` bit for bit (the same ops rerun); ``"dots"`` takes the
named products' gradients from their saved operands in another order of
sums, so it is held to ``remat=False`` at rtol 1e-5 / atol 1e-7. Under
both the flash forward runs twice a layer (``lse`` is not among the
four names).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.ops import pipeline_ops

torch.set_num_threads(1)
V, T, D_MODEL, LAYERS, HEADS, BATCH = 61, 40, 64, 2, 4, 2
TOL = dict(rtol=1e-4, atol=1e-6)
SELF_TOL = dict(rtol=1e-5, atol=1e-7)


def _step_one(pt, counter, start, remat, use_rope):
    """(loss and every parameter gradient of step one, their names)."""
    counter.Program._uid_counter = start
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[T], dtype="int64")
        logits = pt.models.transformer_lm(
            ids, vocab_size=V, d_model=D_MODEL, n_layers=LAYERS,
            num_heads=HEADS, max_len=T, pipeline_stack=True, remat=remat,
            use_rope=use_rope)
        tgt = pt.layers.data("tgt", shape=[T], dtype="int64")
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.reshape(logits, shape=[-1, V]),
            pt.layers.reshape(tgt, shape=[-1, 1])))
        pgs = pt.optimizer.AdamOptimizer(1e-3).minimize(
            loss, startup_program=startup)
    names = [loss.name] + [f"{p.name}@GRAD" for p, _ in pgs]
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, V, size=(BATCH, T)).astype(np.int64),
            "tgt": rng.randint(0, V, size=(BATCH, T)).astype(np.int64)}
    out = exe.run(main, feed=feed, fetch_list=names, scope=scope)
    return [np.asarray(a) for a in out], names


@pytest.mark.parametrize("use_rope", [False, True], ids=["pos", "rope"])
@pytest.mark.parametrize("remat", [False, True, "dots"],
                         ids=["none", "whole", "dots"])
def test_stack_remat_step_one_matches_jax(remat, use_rope, monkeypatch):
    calls = []
    real = pipeline_ops.flash_attention

    def counted(q, *args, **kwargs):
        if q.device.type != "meta":  # not the build's shape inference
            calls.append(1)
        return real(q, *args, **kwargs)

    start = jprog.Program._uid_counter
    jout, names = _step_one(jpt, jprog, start, remat, use_rope)
    plain, _ = _step_one(tpt, tprog, start, False, use_rope)
    monkeypatch.setattr(pipeline_ops, "flash_attention", counted)
    tout, tnames = _step_one(tpt, tprog, start, remat, use_rope)
    assert tnames == names
    assert len(calls) == (2 * LAYERS if remat else LAYERS)
    for name, j, t, p in zip(names, jout, tout, plain):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, err_msg=name, **TOL)
        if remat == "dots":
            np.testing.assert_allclose(t, p, err_msg=name, **SELF_TOL)
        else:
            np.testing.assert_array_equal(t, p, err_msg=name)
