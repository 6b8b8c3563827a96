"""The training program the port builds against the JAX package's.

``demos/transformer_lm.py``'s training half (``layers.data``,
``models.transformer_lm(pipeline_stack=True)``, reshape + softmax cross
entropy + mean, ``AdamOptimizer.minimize``) is built in both packages.
The main and startup programs must hold the same op types in the same
order with the same attrs (``_``-prefixed attrs are metadata and are
ignored), every grad op must differentiate the same forward op type, the
parameters must carry the same names and shapes, and build-time shape
inference (the port evaluates ops on ``meta`` tensors, the JAX package
with ``jax.eval_shape``) must give every forward output the same shape
and dtype, batch dimension included.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.types import dtype_name

torch.set_num_threads(1)
V, T, D_MODEL, LAYERS, HEADS = 97, 32, 64, 2, 4


def _build(pt, optimizer="adam"):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[T], dtype="int64")
        tgt = pt.layers.data("tgt", shape=[T], dtype="int64")
        logits = pt.models.transformer_lm(
            ids, vocab_size=V, d_model=D_MODEL, n_layers=LAYERS,
            num_heads=HEADS, max_len=2 * T, pipeline_stack=True)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.reshape(logits, shape=[-1, V]),
            pt.layers.reshape(tgt, shape=[-1, 1])))
        opt = (pt.optimizer.AdamOptimizer(learning_rate=3e-3)
               if optimizer == "adam"
               else pt.optimizer.SGDOptimizer(learning_rate=0.1))
        opt.minimize(loss, startup_program=startup)
    return main, startup


@pytest.fixture(scope="module", params=["adam", "sgd"])
def programs(request):
    return _build(jpt, request.param), _build(tpt, request.param)


def _public(attrs):
    """attrs without ``_``-prefixed keys, recursively; var names (which
    come from per-package counters) do not appear in attrs."""
    if isinstance(attrs, dict):
        return {k: _public(v) for k, v in attrs.items()
                if not (isinstance(k, str) and k.startswith("_"))}
    if isinstance(attrs, (list, tuple)):
        return [_public(v) for v in attrs]
    return attrs


@pytest.mark.parametrize("which", ["main", "startup"])
def test_same_op_types_in_order_with_same_attrs(programs, which):
    (jmain, jstartup), (tmain, tstartup) = programs
    jops = (jmain if which == "main" else jstartup).global_block.ops
    tops = (tmain if which == "main" else tstartup).global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    for i, (t, j) in enumerate(zip(tops, jops)):
        assert _public(t.attrs) == _public(j.attrs), (i, t.type)
        assert sorted(t.inputs) == sorted(j.inputs), (i, t.type)
        assert sorted(t.outputs) == sorted(j.outputs), (i, t.type)


def test_grad_ops_differentiate_the_same_forward_ops(programs):
    (jmain, _), (tmain, _) = programs

    def fwd_types(prog):
        return [(op.type, op.attrs["fwd_type"]) for op in
                prog.global_block.ops if op.type in ("grad", "grad_custom")]

    got = fwd_types(tmain)
    assert got == fwd_types(jmain)
    assert ("grad", "pipelined_transformer_stack") in got
    assert ("grad_custom", "softmax_with_cross_entropy") in got


def test_same_parameters(programs):
    (jmain, _), (tmain, _) = programs

    def params(prog):
        return sorted((p.name, tuple(p.shape)) for p in prog.all_parameters())

    got = params(tmain)
    assert got == params(jmain)
    names = {n for n, _ in got}
    assert {"tok_emb", "pos_emb", "final_ln.scale", "final_ln.bias",
            "lm_head.w", "lm_stack.stack_qkv_w"} <= names


def _jax_dtype(name):
    """The dtype JAX infers for ``name``: int64 is int32 unless x64 is
    enabled."""
    x64 = jax.config.read("jax_enable_x64")
    return "int32" if name == "int64" and not x64 else name


def test_shape_inference_matches(programs):
    """Every forward op's outputs: same shapes (-1 batch included) and
    dtypes."""
    (jmain, _), (tmain, _) = programs
    for t, j in zip(tmain.global_block.ops, jmain.global_block.ops):
        if t.type in ("grad", "grad_custom", "fill_constant"):
            break  # the backward section starts at the loss-grad seed
        for slot in j.outputs:
            for tn, jn in zip(t.outputs[slot], j.outputs[slot]):
                tv, jv = tmain.global_block.var(tn), jmain.global_block.var(jn)
                assert tv.shape == tuple(jv.shape), (t.type, slot)
                assert _jax_dtype(dtype_name(tv.dtype)) == np.dtype(
                    jv.dtype).name, (t.type, slot)


def test_unported_options_raise_and_name_their_slice():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        ids = tpt.layers.data("ids", shape=[T], dtype="int64")
        # recompute segments are ported now: each block is one segment
        n_ops = len(main.global_block.ops)
        tpt.models.transformer_lm(ids, vocab_size=V, d_model=D_MODEL,
                                  n_layers=1, num_heads=HEADS, remat=True)
        assert any(op.attrs.get("__recompute_seg__") is not None
                   for op in main.global_block.ops[n_ops:])
        # the headless model is ported now: it ends at the final norm,
        # its hidden states [b, T, d] (no head projection after it)
        h = tpt.models.transformer_lm(ids, vocab_size=V, d_model=D_MODEL,
                                      n_layers=1, num_heads=HEADS,
                                      include_head=False)
        assert main.global_block.ops[-1].type == "layer_norm"
        assert h.name in main.global_block.ops[-1].outputs["Y"]
        assert tuple(h.shape)[1:] == (T, D_MODEL)
        # so are sparse embeddings: a lookup_table with is_sparse set
        tpt.layers.embedding(ids, size=[V, D_MODEL], is_sparse=True)
        assert main.global_block.ops[-1].type == "lookup_table"
        assert main.global_block.ops[-1].attrs["is_sparse"] is True
        # padded sequence feeds are ported now: a [b, T, ...] feed and
        # its int32 lengths companion
        seq = tpt.layers.data("seq", shape=[T], dtype="int64", lod_level=1)
        assert seq.shape == (-1, -1, T) and seq.seq_len.name == "seq@len"
        emb = tpt.layers.embedding(ids, size=[V, D_MODEL])
        loss = tpt.layers.mean(emb)
        # so is gradient accumulation: a gated update on the mean
        tpt.optimizer.SGDOptimizer(0.1).minimize(loss, accumulate_steps=2)
        assert any(n.endswith("_gradsum_acc")
                   for n in main.global_block.vars)
