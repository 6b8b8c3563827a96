"""Stacked transformer ops: L pre-LN blocks with stacked weights.

Counterpart of ``paddle_tpu/ops/pipeline_ops.py``, cut to the training
op (``pipelined_transformer_stack``) and the serving path of the dense
slot engine. Every weight carries a leading layer axis [L, ...] in the
JAX layout ([in, out], applied as ``x @ W``); where the JAX package scans
over that axis, the port runs a Python loop over layers. Op functions
take ``(attrs, ins)`` with ``ins`` a dict of slot name -> [tensor] and
return such a dict, exactly like their JAX twins.

Causal attention over a whole sequence (the training forward and the
prefill) is the sm_90a flash kernel (``kernels/flash_attention.py``),
differentiable through its backward kernels; decode attention over the
slot cache stays plain tensor code, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import (flash_attention, reference_attention,
                                       rotary)
from ..core.registry import register_op
from .common import maybe, out, single

_EPS = 1e-5

_STACK_SLOTS = {
    "Ln1S": "ln1_s", "Ln1B": "ln1_b", "QkvW": "qkv_w", "OutW": "out_w",
    "Ln2S": "ln2_s", "Ln2B": "ln2_b", "FfW1": "ff_w1", "FfB1": "ff_b1",
    "FfW2": "ff_w2", "FfB2": "ff_b2",
}


def _ln(x, scale, bias):
    """LayerNorm with the biased variance and eps inside the rsqrt."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + _EPS) * scale + bias


def _take_rows(table, ids):
    """table[ids] with XLA gather semantics: negative ids wrap once,
    out-of-range ids clamp to the table (they never raise)."""
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return table[ids]


def _attn_proj(p, h, num_heads, num_kv_heads=None, use_rope=False, pos0=0):
    """LN1 + qkv projection -> q [b, H, t, dh], k/v [b, Hkv, t, dh].
    ``use_rope`` rotates q/k at absolute positions pos0..pos0+t-1."""
    num_kv_heads = num_kv_heads or num_heads
    b, t, d = h.shape
    head_d = d // num_heads
    d_kv = head_d * num_kv_heads
    qkv = (_ln(h, p["ln1_s"], p["ln1_b"]) @ p["qkv_w"]).to(h.dtype)

    def heads(a, n):
        return a.reshape(b, t, n, head_d).transpose(1, 2)

    q = heads(qkv[..., :d], num_heads)
    k = heads(qkv[..., d:d + d_kv], num_kv_heads)
    v = heads(qkv[..., d + d_kv:], num_kv_heads)
    if use_rope:
        q = rotary(q, pos0)
        k = rotary(k, pos0)
    return q, k, v


def _expand_kv(k, v, num_heads):
    """Broadcast Hkv heads to their H/Hkv query groups."""
    rep = num_heads // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def _attn_out_ffn(p, x, ctx):
    """Out-projection + residual + FFN half of a block; ctx [b, t, d].
    The FFN's GELU is the tanh approximation, as ``jax.nn.gelu``'s
    default."""
    x = x + (ctx @ p["out_w"]).to(x.dtype)
    h2 = _ln(x, p["ln2_s"], p["ln2_b"])
    ff = F.gelu((h2 @ p["ff_w1"]).to(x.dtype) + p["ff_b1"],
                approximate="tanh")
    return x + (ff @ p["ff_w2"]).to(x.dtype) + p["ff_b2"]


def _layer(params, i):
    return {key: w[i] for key, w in params.items()}


def _block(p, x, num_heads, causal, num_kv_heads=None, use_rope=False):
    """One pre-LN transformer block over x [b, T, d]; p holds one layer's
    weights (no leading dim)."""
    b, T, d = x.shape
    q, k, v = _attn_proj(p, x, num_heads, num_kv_heads, use_rope)
    k, v = _expand_kv(k, v, num_heads)
    ctx = flash_attention(q, k, v, causal=causal)
    return _attn_out_ffn(p, x, ctx.transpose(1, 2).reshape(b, T, d))


@register_op("pipelined_transformer_stack")
def pipelined_transformer_stack(attrs, ins):
    """X [b, T, d] + stacked block weights (leading dim L) -> Out [b, T, d]:
    a loop over the L layers. Differentiable: the executor records it
    under autograd when its grad op follows. The port has no device mesh
    yet, so the JAX package's GPipe branch (a ``pp`` mesh axis) belongs
    to the parallel slice, and ``remat`` to the recompute slice."""
    if attrs.get("remat"):
        raise NotImplementedError(
            "pipelined_transformer_stack(remat=...) is not ported to "
            "paddle_tpu_torch yet: activation checkpointing lands with the "
            "recompute slice")
    x = single(ins, "X")
    params = _stack_params(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    use_rope = attrs.get("use_rope", False)
    causal = attrs.get("causal", True)
    # unbind, not w[i]: its backward stacks the L layer grads in one
    # allocation instead of scattering each into a zero [L, ...] tensor
    keys = list(params)
    h = x
    for layer_w in zip(*(params[key].unbind(0) for key in keys)):
        h = _block(dict(zip(keys, layer_w)), h, num_heads, causal,
                   num_kv_heads, use_rope)
    return out(Out=h)


def _stack_params(ins):
    return {key: single(ins, slot) for slot, key in _STACK_SLOTS.items()}


def _embed_fn(tok_emb, pos_emb):
    def embed(ids, pos0):
        x = _take_rows(tok_emb, ids)
        if pos_emb is None:  # RoPE: positions live in the attention rotation
            return x
        t = ids.shape[1]
        # dynamic-slice semantics: the start clamps so the window fits
        start = max(0, min(int(pos0), pos_emb.shape[0] - t))
        return x + pos_emb[start:start + t][None]

    return embed


def _logits_fn(ln_s, ln_b, head_w):
    def logits_of(h_last):
        return (_ln(h_last, ln_s, ln_b) @ head_w).float()

    return logits_of


def _prefill(params, x, num_heads, b, Tp, num_kv_heads=None,
             use_rope=False):
    """Run the stack over the prompt capturing every layer's K/V: returns
    (hidden [b, Tp, d], ks, vs), ks/vs lists of L [b, Hkv, Tp, dh]
    tensors (the caches hold KV heads only). Attention is the causal
    flash kernel."""
    h = x
    ks, vs = [], []
    for i in range(params["qkv_w"].shape[0]):
        layer_p = _layer(params, i)
        q, k, v = _attn_proj(layer_p, h, num_heads, num_kv_heads, use_rope)
        kx, vx = _expand_kv(k, v, num_heads)
        ctx = flash_attention(q, kx, vx, causal=True)
        ctx = ctx.transpose(1, 2).reshape(b, Tp, x.shape[-1])
        h = _attn_out_ffn(layer_p, h, ctx)
        ks.append(k)
        vs.append(v)
    return h, ks, vs


def _make_pick(temperature, top_k, vocab, generator=None):
    """Next-token selection shared by the decode ops: argmax when
    ``temperature`` == 0 (draws nothing), otherwise temperature/top-k
    sampling from ``generator``. The draws are not JAX's threefry bits:
    only greedy decoding is token-exact with the JAX package."""
    if top_k and not 0 < top_k <= vocab:
        raise ValueError(f"top_k {top_k} outside [1, vocab {vocab}]")

    def pick(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        z = logits
        if top_k:
            kth = torch.topk(z, top_k, dim=-1).values[:, -1:]
            z = torch.where(z >= kth, z, torch.full_like(z, -math.inf))
        probs = torch.softmax(z / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return pick


def _decode_layer(layer_p, h1, ck_l, cv_l, pos, num_heads, num_kv_heads,
                  use_rope):
    """One-token decode of one layer against its cache planes (updated in
    place at row ``pos``); cache rows < pos+1 are visible."""
    b, _, d = h1.shape
    q, k, v = _attn_proj(layer_p, h1, num_heads, num_kv_heads, use_rope,
                         pos0=pos)
    row = min(pos, ck_l.shape[2] - 1)  # dynamic-update-slice clamps
    ck_l[:, :, row] = k[:, :, 0]
    cv_l[:, :, row] = v[:, :, 0]
    lengths = torch.full((b,), pos + 1, device=h1.device)
    ctx = reference_attention(q, ck_l, cv_l, lengths=lengths)
    return _attn_out_ffn(layer_p, h1, ctx.transpose(1, 2).reshape(b, 1, d))


def transformer_stack_generate(attrs, ins, generator=None):
    """One-shot incremental decoding with a per-layer KV cache: Prompt
    [b, Tp] int + the stacked block weights + TokEmb [V, d], PosEmb
    [maxlen, d], FinalLnS/FinalLnB [d], HeadW [d, V] -> Out [b, Tp +
    max_new_tokens] int. Prefill runs the stack once over the prompt;
    each later token attends the cache."""
    prompt = single(ins, "Prompt")
    tok_emb, pos_emb = single(ins, "TokEmb"), maybe(ins, "PosEmb")
    ln_s, ln_b = single(ins, "FinalLnS"), single(ins, "FinalLnB")
    head_w = single(ins, "HeadW")
    params = _stack_params(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    use_rope = attrs.get("use_rope", False)
    N = attrs["max_new_tokens"]
    b, Tp = prompt.shape
    Ttot = Tp + N
    if pos_emb is not None and Ttot > pos_emb.shape[0]:
        raise ValueError(f"prompt {Tp} + {N} new tokens exceeds max_len "
                         f"{pos_emb.shape[0]}")
    if N == 0:
        return out(Out=prompt)
    embed = _embed_fn(tok_emb, pos_emb)
    logits_of = _logits_fn(ln_s, ln_b, head_w)
    pick = _make_pick(attrs.get("temperature") or 0.0,
                      attrs.get("top_k") or 0, head_w.shape[1], generator)

    h, ks, vs = _prefill(params, embed(prompt, 0), num_heads, b, Tp,
                         num_kv_heads, use_rope)
    L = len(ks)
    shape = (L, b, ks[0].shape[1], Ttot, ks[0].shape[3])
    cache_k = torch.zeros(shape, dtype=ks[0].dtype, device=prompt.device)
    cache_v = torch.zeros_like(cache_k)
    cache_k[:, :, :, :Tp] = torch.stack(ks)
    cache_v[:, :, :, :Tp] = torch.stack(vs)
    tok = pick(logits_of(h[:, -1]))
    generated = [tok]
    # prefill produced token Tp; the loop decodes the remaining N - 1
    for n in range(N - 1):
        pos = Tp + n
        h1 = embed(tok[:, None], pos)
        for i in range(L):
            h1 = _decode_layer(_layer(params, i), h1, cache_k[i],
                               cache_v[i], pos, num_heads, num_kv_heads,
                               use_rope)
        tok = pick(logits_of(h1[:, 0]))
        generated.append(tok)
    gen = torch.stack(generated, dim=1).to(prompt.dtype)
    return out(Out=torch.cat([prompt, gen], dim=1))


# ---------------------------------------------------------------------------
# Slot-cache decode ops: the continuous-batching serving path
# (serving/generation.py). The KV cache is a slot table [L, S, Hkv, Tmax,
# dh]: requests claim a slot, prefill scatters their prompt K/V into it,
# and every decode step advances ALL slots one token, each at its own
# position. Where the JAX ops return updated copies (donated buffers),
# these ops update CacheK/CacheV IN PLACE and return the same tensors.
# ---------------------------------------------------------------------------

def transformer_stack_slot_prefill(attrs, ins, generator=None):
    """Prefill a batch of prompts into their cache slots.

    Prompt [b, Tp] int (right-padded to the bucket width), SlotIds [b]
    (target slot per row; duplicate ids are legal only for a scrap
    slot), Lengths [b] (true prompt lengths, 1..Tp), CacheK/CacheV [L, S,
    Hkv, Tmax, dh], plus the shared LM weights. Returns NextTok [b] (the
    first generated token per row, from the hidden state at each row's
    true last prompt position) and the caches with rows 0..Tp-1 of each
    target slot overwritten. Pad rows write pad K/V into rows
    length..Tp-1, which decode never attends and progressively
    overwrites.
    """
    prompt = single(ins, "Prompt")
    slot_ids = single(ins, "SlotIds").long()
    lengths = single(ins, "Lengths").long()
    cache_k, cache_v = single(ins, "CacheK"), single(ins, "CacheV")
    tok_emb, pos_emb = single(ins, "TokEmb"), maybe(ins, "PosEmb")
    ln_s, ln_b = single(ins, "FinalLnS"), single(ins, "FinalLnB")
    head_w = single(ins, "HeadW")
    params = _stack_params(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    use_rope = attrs.get("use_rope", False)
    b, Tp = prompt.shape
    Tmax = cache_k.shape[3]
    if Tp > Tmax:
        raise ValueError(f"prompt bucket {Tp} exceeds cache length {Tmax}")
    if pos_emb is not None and Tp > pos_emb.shape[0]:
        raise ValueError(f"prompt bucket {Tp} exceeds max_len "
                         f"{pos_emb.shape[0]}")
    embed = _embed_fn(tok_emb, pos_emb)
    pick = _make_pick(attrs.get("temperature") or 0.0,
                      attrs.get("top_k") or 0, head_w.shape[1], generator)
    h, ks, vs = _prefill(params, embed(prompt, 0), num_heads, b, Tp,
                         num_kv_heads, use_rope)
    rows = torch.arange(b, device=h.device)
    last = h[rows, lengths.clamp(1, Tp) - 1]  # [b, d]
    next_tok = pick(_logits_fn(ln_s, ln_b, head_w)(last))
    # each batch row lands in its slot's rows 0..Tp-1
    for i, (k, v) in enumerate(zip(ks, vs)):
        cache_k[i, slot_ids, :, :Tp] = k
        cache_v[i, slot_ids, :, :Tp] = v
    return out(NextTok=next_tok.to(prompt.dtype), CacheK=cache_k,
               CacheV=cache_v)


def transformer_stack_slot_decode(attrs, ins, generator=None):
    """One decode step over EVERY cache slot, each at its own position.

    Tok [S] int (the pending token per slot; its K/V is not yet cached),
    Pos [S] int (that token's position == cache rows already filled),
    CacheK/CacheV [L, S, Hkv, Tmax, dh], plus the shared LM weights.
    Returns NextTok [S] and the caches with row Pos[s] of every slot s
    overwritten by Tok's K/V. Vacant slots compute a token the host
    ignores; attention masks each slot to rows <= Pos[s].
    """
    tok = single(ins, "Tok")
    pos = single(ins, "Pos").long()
    cache_k, cache_v = single(ins, "CacheK"), single(ins, "CacheV")
    tok_emb, pos_emb = single(ins, "TokEmb"), maybe(ins, "PosEmb")
    ln_s, ln_b = single(ins, "FinalLnS"), single(ins, "FinalLnB")
    head_w = single(ins, "HeadW")
    params = _stack_params(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    use_rope = attrs.get("use_rope", False)
    S = tok.shape[0]
    if S != cache_k.shape[1]:
        raise ValueError(f"Tok has {S} slots but the cache holds "
                         f"{cache_k.shape[1]}")
    d = params["ln1_s"].shape[1]
    Tmax = cache_k.shape[3]
    pos = pos.clamp(0, Tmax - 1)
    x = _take_rows(tok_emb, tok)
    if pos_emb is not None:
        x = x + pos_emb[pos.clamp(0, pos_emb.shape[0] - 1)]
    h1 = x[:, None, :]  # [S, 1, d]
    pick = _make_pick(attrs.get("temperature") or 0.0,
                      attrs.get("top_k") or 0, head_w.shape[1], generator)
    srange = torch.arange(S, device=tok.device)[:, None]
    for i in range(params["qkv_w"].shape[0]):
        layer_p = _layer(params, i)
        q, k, v = _attn_proj(layer_p, h1, num_heads, num_kv_heads, use_rope,
                             pos0=pos)
        hrange = torch.arange(k.shape[1], device=tok.device)[None, :]
        cache_k[i][srange, hrange, pos[:, None]] = k[:, :, 0]
        cache_v[i][srange, hrange, pos[:, None]] = v[:, :, 0]
        ctx = reference_attention(q, cache_k[i], cache_v[i],
                                  lengths=pos + 1)
        h1 = _attn_out_ffn(layer_p, h1, ctx.transpose(1, 2).reshape(S, 1, d))
    nxt = pick(_logits_fn(ln_s, ln_b, head_w)(h1[:, 0]))
    return out(NextTok=nxt.to(tok.dtype), CacheK=cache_k, CacheV=cache_v)
