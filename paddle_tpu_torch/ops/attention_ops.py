"""Attention ops: rotary embedding and fused scaled-dot-product attention.

Counterpart of ``paddle_tpu/ops/attention_ops.py``. The attention op is
what the transpiler's attention rewrite (``FusePatterns``) emits for a
primitive matmul → softmax → matmul subgraph; it runs the hand-written
flash kernels (``kernels/flash_attention.py``) on a CUDA tensor and their
plain versions on a CPU one, differentiably. Ring attention over a
sequence-parallel mesh is not ported (``ROADMAP.md`` Queue 1 item 10).
"""
from __future__ import annotations

from ..core.registry import register_op
from ..kernels.flash_attention import flash_attention, rotary
from .common import maybe, out, single


@register_op("rotary_embed")
def rotary_embed(attrs, ins):
    """Rotary position embedding over [B, H, T, D] heads."""
    return out(Out=rotary(single(ins, "X"), base=attrs.get("base", 10000.0)))


@register_op("scaled_dot_product_attention", optional_inputs=("Length",))
def scaled_dot_product_attention(attrs, ins):
    """Q [B, H, T, D], K/V [B, Hkv, T, D] -> [B, H, T, D]; attrs causal,
    sm_scale. Hkv may divide H (grouped-query attention): K/V heads are
    repeated to their query groups. ``Length`` [B] masks K/V columns at
    and past each row's length."""
    if attrs.get("sequence_parallel", False):
        raise NotImplementedError(
            "sequence-parallel (ring) attention is not ported to "
            "paddle_tpu_torch; see ROADMAP.md Queue 1 item 10")
    q = single(ins, "Q")
    k = single(ins, "K")
    v = single(ins, "V")
    if k.shape[1] != q.shape[1]:
        if q.shape[1] % k.shape[1]:
            raise ValueError(
                f"query heads {q.shape[1]} not a multiple of kv heads "
                f"{k.shape[1]}")
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return out(Out=flash_attention(q, k, v, lengths=maybe(ins, "Length"),
                                   causal=attrs.get("causal", False),
                                   sm_scale=attrs.get("sm_scale")))
