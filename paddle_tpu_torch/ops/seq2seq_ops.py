"""Encoder-decoder (seq2seq / NMT) ops on the paged decode plane.

Counterpart of ``paddle_tpu/ops/seq2seq_ops.py``. The encoder runs once
a request (admission time): ``transformer_encdec_encode`` parks the
per-layer cross-attention K/V of the source in a slot-resident cache
``[L, S+1, Hkv, Ts, dh]`` beside the self-attention page pool (row ``S``
is the scrap row padding and vacant slots address). The decoder is the
paged continuous-batching loop plus one cross-attention block a layer
that reads the parked rows (``transformer_stack_cross_prefill``,
``transformer_stack_cross_decode``). ``transformer_encdec_teacher`` is
the teacher-forced training forward, differentiable end to end.

Attention routes follow the JAX ops: the encoder's self-attention and
every cross-attention are the plain length-masked ``reference_attention``
(the JAX ops take ``reference_attention`` there); the teacher's decoder
self-attention is the causal flash kernel, forward and backward; the
serving ops' decoder self-attention reads the paged context as the
paged ops do. The serving ops write the page pools and the cross caches
IN PLACE (the paged engine's captured decode step reads them at fixed
addresses). As in the JAX ops, the products outside ``_attn_proj`` and
``_attn_out_ffn`` (cross projections, the decoder's out-projection and
FFN, the teacher's head) take no AMP cast.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..kernels.flash_attention import flash_attention, reference_attention
from .common import matmul, maybe, out, single
from .pipeline_ops import (_SAMPLING_SLOTS, _STACK_SLOTS, _attn_out_ffn,
                           _attn_proj, _expand_kv, _gather_pages, _layer,
                           _ln, _lm_head, _maybe_topk, _paged_targets,
                           _pick_rows, _stack_params, _take_rows)

# encoder stack slots: the same 10-weight block layout, Enc-prefixed
_ENC_SLOTS = {f"Enc{slot}": key for slot, key in _STACK_SLOTS.items()}
# decoder cross-attention slots (per layer, stacked [L, ...])
_CROSS_SLOTS = ("XLnS", "XLnB", "XQW", "XOutW")


def _unpack_cross(ins):
    return {k.lower(): single(ins, k) for k in _CROSS_SLOTS}


def _cross_attend(h1, xw, i, ck_x, cv_x, src_len, num_heads):
    """Layer ``i``'s cross-attention block: pre-LN query projection
    against the parked encoder K/V rows. h1 [b, t, d]; ck_x/cv_x [b,
    Hkv, Ts, dh]; src_len [b]."""
    b, t, d = h1.shape
    hx = _ln(h1, xw["xlns"][i], xw["xlnb"][i])
    q = matmul(hx, xw["xqw"][i])
    q = q.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)
    ctx = reference_attention(q, ck_x, cv_x, lengths=src_len)
    return h1 + matmul(ctx.transpose(1, 2).reshape(b, t, d), xw["xoutw"][i])


def _decoder_rest(layer_p, xw, i, h, ctx, ck_x, cv_x, src_len, num_heads):
    """A decoder layer after its self-attention context ctx [b, t, d]:
    the self-attention residual, the cross block, then the FFN (GELU's
    tanh approximation, as ``jax.nn.gelu``'s default)."""
    h = h + matmul(ctx, layer_p["out_w"])
    h = _cross_attend(h, xw, i, ck_x, cv_x, src_len, num_heads)
    h2 = _ln(h, layer_p["ln2_s"], layer_p["ln2_b"])
    ff = F.gelu(matmul(h2, layer_p["ff_w1"]) + layer_p["ff_b1"],
                approximate="tanh")
    return h + matmul(ff, layer_p["ff_w2"]) + layer_p["ff_b2"]


def _encode_memory(ins, attrs, src, src_len):
    """The encoder forward: the embedded source through the Enc stack
    (bidirectional, length-masked) + the final LN -> memory [b, Ts, d]."""
    params = {key: single(ins, slot) for slot, key in _ENC_SLOTS.items()}
    pos_emb = maybe(ins, "SrcPosEmb")
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    b, Ts = src.shape
    d = params["ln1_s"].shape[1]
    h = _take_rows(single(ins, "SrcTokEmb"), src)
    if pos_emb is not None:
        h = h + pos_emb[None, :Ts]
    for i in range(params["ln1_s"].shape[0]):
        layer_p = _layer(params, i)
        q, k, v = _attn_proj(layer_p, h, num_heads, num_kv_heads)
        kx, vx = _expand_kv(k, v, num_heads)
        ctx = reference_attention(q, kx, vx, lengths=src_len)
        h = _attn_out_ffn(layer_p, h, ctx.transpose(1, 2).reshape(b, Ts, d))
    return _ln(h, single(ins, "EncLnS"), single(ins, "EncLnB"))


def _project_cross_kv(memory, xkv_w, num_kv_heads):
    """memory [b, Ts, d] x xkv_w [L, d, 2*Hkv*dh] -> per-layer cross K/V
    [L, b, Hkv, Ts, dh]."""
    b, Ts, _ = memory.shape
    L = xkv_w.shape[0]
    d_kv = xkv_w.shape[2] // 2
    dh = d_kv // num_kv_heads
    kv = matmul(memory[None], xkv_w[:, None])  # [L, b, Ts, 2*d_kv]

    def heads(a):
        return a.reshape(L, b, Ts, num_kv_heads, dh).transpose(2, 3)

    return heads(kv[..., :d_kv]), heads(kv[..., d_kv:])


@register_op("transformer_encdec_encode", optional_inputs=("SrcPosEmb",))
def transformer_encdec_encode(attrs, ins):
    """Run the encoder once for a batch of admitted sources and park
    their cross-attention K/V in the slot cache.

    SrcIds [b, Ts] int (right-padded), SrcLen [b], SlotIds [b]
    (cross-cache row per request; padding rows target the scrap row S),
    SrcTokEmb [Vs, d], SrcPosEmb [Tsmax, d] (optional), the Enc-prefixed
    stacked encoder weights + EncLnS/EncLnB [d], XKvW [L, d, 2*Hkv*dh]
    (the decoder's cross K/V projection, applied here so decode never
    touches the encoder memory), CrossK/CrossV [L, S+1, Hkv, Tsmax, dh].
    Returns Ok [b] (the slot ids echoed) and the cross caches with rows
    0..Ts-1 of each target row overwritten IN PLACE.
    """
    src = single(ins, "SrcIds")
    src_len = single(ins, "SrcLen").long()
    slot_ids = single(ins, "SlotIds")
    cross_k, cross_v = single(ins, "CrossK"), single(ins, "CrossV")
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    Ts = src.shape[1]
    if Ts > cross_k.shape[3]:
        raise ValueError(f"source bucket {Ts} exceeds the cross cache "
                         f"length {cross_k.shape[3]}")
    memory = _encode_memory(ins, attrs, src, src_len)
    k, v = _project_cross_kv(memory, single(ins, "XKvW"), num_kv_heads)
    rows = slot_ids.long()
    cross_k[:, rows, :, :Ts] = k
    cross_v[:, rows, :, :Ts] = v
    return out(Ok=slot_ids.to(torch.int32), CrossK=cross_k, CrossV=cross_v)


@register_op("transformer_stack_cross_prefill",
             optional_inputs=("PosEmb",) + _SAMPLING_SLOTS)
def transformer_stack_cross_prefill(attrs, ins, rng=None):
    """Paged chunk prefill of the target prefix with cross-attention.

    The ``transformer_stack_paged_prefill`` contract (Chunk/StartPos/
    Lengths/BlockTable + CacheK/CacheV page pools + the stacked-LM
    decoder weights) extended per layer with a cross-attention block over
    the parked encoder rows: XSlot [b] (each row's cross-cache row),
    SrcLen [b], CrossK/CrossV [L, S+1, Hkv, Tsmax, dh] (read only here)
    and the XLnS/XLnB/XQW/XOutW stacked cross weights. The per-row
    sampling plane and ``emit_topk`` behave as in the paged prefill.
    """
    chunk = single(ins, "Chunk")
    start = single(ins, "StartPos").long()
    lengths = single(ins, "Lengths").long()
    table = single(ins, "BlockTable").long()
    xslot = single(ins, "XSlot").long()
    src_len = single(ins, "SrcLen").long()
    cache_k, cache_v = single(ins, "CacheK"), single(ins, "CacheV")
    cross_k, cross_v = single(ins, "CrossK"), single(ins, "CrossV")
    tok_emb, pos_emb, logits_of, vocab = _lm_head(ins)
    params = _stack_params(ins)
    xw = _unpack_cross(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    b, Tc = chunk.shape
    d = params["ln1_s"].shape[1]
    pos, page_id, page_row = _paged_targets(start, lengths, table, Tc,
                                            cache_k.shape[3])
    h = _take_rows(tok_emb, chunk)
    if pos_emb is not None:
        h = h + pos_emb[pos.clamp(0, pos_emb.shape[0] - 1)]
    for i in range(params["qkv_w"].shape[0]):
        layer_p = _layer(params, i)
        ck_l, cv_l = cache_k[i], cache_v[i]
        q, k, v = _attn_proj(layer_p, h, num_heads, num_kv_heads,
                             pos0=start)
        ck_l[page_id, :, page_row] = k.transpose(1, 2)
        cv_l[page_id, :, page_row] = v.transpose(1, 2)
        ctx = reference_attention(q, _gather_pages(ck_l, table),
                                  _gather_pages(cv_l, table), causal=True,
                                  q_pos0=start)
        h = _decoder_rest(layer_p, xw, i, h,
                          ctx.transpose(1, 2).reshape(b, Tc, d),
                          cross_k[i][xslot], cross_v[i][xslot], src_len,
                          num_heads)
    rows = torch.arange(b, device=chunk.device)
    logits = logits_of(h[rows, lengths.clamp(1, Tc) - 1])
    nxt = _pick_rows(attrs, ins, rng, vocab, logits)
    outs = out(NextTok=nxt.to(chunk.dtype), CacheK=cache_k, CacheV=cache_v)
    return _maybe_topk(attrs, ins, logits, outs)


@register_op("transformer_stack_cross_decode",
             optional_inputs=("PosEmb",) + _SAMPLING_SLOTS)
def transformer_stack_cross_decode(attrs, ins, rng=None):
    """One decode step over every slot's paged target context plus a
    cross-attention read of its parked encoder rows.

    The ``transformer_stack_paged_decode`` contract extended with XSlot
    [S] (cross-cache row per slot; vacant slots address the scrap row),
    SrcLen [S], CrossK/CrossV [L, S+1, Hkv, Tsmax, dh] (read only:
    written once by ``transformer_encdec_encode``) and the stacked cross
    weights. The same per-row sampling plane and ``emit_topk`` beam
    plane; no shape depends on occupancy and nothing is read back, so
    the engine captures it as one CUDA graph on the card.
    """
    tok = single(ins, "Tok")
    pos = single(ins, "Pos").long()
    table = single(ins, "BlockTable").long()
    xslot = single(ins, "XSlot").long()
    src_len = single(ins, "SrcLen").long()
    cache_k, cache_v = single(ins, "CacheK"), single(ins, "CacheV")
    cross_k, cross_v = single(ins, "CrossK"), single(ins, "CrossV")
    tok_emb, pos_emb, logits_of, vocab = _lm_head(ins)
    params = _stack_params(ins)
    xw = _unpack_cross(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    S = tok.shape[0]
    ps = cache_k.shape[3]
    d = params["ln1_s"].shape[1]
    pos = pos.clamp(0, table.shape[1] * ps - 1)
    x = _take_rows(tok_emb, tok)
    if pos_emb is not None:
        x = x + pos_emb[pos.clamp(0, pos_emb.shape[0] - 1)]
    h1 = x[:, None, :]
    page_id = torch.gather(table, 1, (pos // ps)[:, None])[:, 0]
    page_row = pos % ps
    for i in range(params["qkv_w"].shape[0]):
        layer_p = _layer(params, i)
        ck_l, cv_l = cache_k[i], cache_v[i]
        q, k, v = _attn_proj(layer_p, h1, num_heads, num_kv_heads, pos0=pos)
        ck_l[page_id, :, page_row] = k[:, :, 0]
        cv_l[page_id, :, page_row] = v[:, :, 0]
        ctx = reference_attention(q, _gather_pages(ck_l, table),
                                  _gather_pages(cv_l, table),
                                  lengths=pos + 1)
        h1 = _decoder_rest(layer_p, xw, i, h1,
                           ctx.transpose(1, 2).reshape(S, 1, d),
                           cross_k[i][xslot], cross_v[i][xslot], src_len,
                           num_heads)
    logits = logits_of(h1[:, 0])
    nxt = _pick_rows(attrs, ins, rng, vocab, logits)
    outs = out(NextTok=nxt.to(tok.dtype), CacheK=cache_k, CacheV=cache_v)
    return _maybe_topk(attrs, ins, logits, outs)


@register_op("transformer_encdec_teacher",
             optional_inputs=("SrcPosEmb", "PosEmb"))
def transformer_encdec_teacher(attrs, ins):
    """Teacher-forced encoder-decoder forward: the NMT training (and
    reference-decode) path.

    SrcIds [b, Ts] + SrcLen [b] + the encoder and cross inputs of
    ``transformer_encdec_encode``, TgtIn [b, Tt] + the stacked-LM decoder
    weights + cross weights -> Logits [b, Tt, V]: decoder position t
    attends target positions <= t (the causal flash kernel, forward and
    backward) and every valid source position (cross). Differentiable
    through autograd: the executor records it when its grad op follows.
    """
    src = single(ins, "SrcIds")
    src_len = single(ins, "SrcLen").long()
    tgt_in = single(ins, "TgtIn")
    pos_emb = maybe(ins, "PosEmb")
    params = _stack_params(ins)
    xw = _unpack_cross(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    b, Tt = tgt_in.shape
    d = params["ln1_s"].shape[1]
    memory = _encode_memory(ins, attrs, src, src_len)
    xk, xv = _project_cross_kv(memory, single(ins, "XKvW"), num_kv_heads)
    h = _take_rows(single(ins, "TokEmb"), tgt_in)
    if pos_emb is not None:
        h = h + pos_emb[None, :Tt]
    for i in range(params["ln1_s"].shape[0]):
        layer_p = _layer(params, i)
        q, k, v = _attn_proj(layer_p, h, num_heads, num_kv_heads)
        kx, vx = _expand_kv(k, v, num_heads)
        ctx = flash_attention(q, kx, vx, causal=True)
        h = _decoder_rest(layer_p, xw, i, h,
                          ctx.transpose(1, 2).reshape(b, Tt, d), xk[i],
                          xv[i], src_len, num_heads)
    hn = _ln(h, single(ins, "FinalLnS"), single(ins, "FinalLnB"))
    return out(Logits=matmul(hn, single(ins, "HeadW")).float())
