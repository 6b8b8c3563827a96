"""Stacked transformer ops: L pre-LN blocks with stacked weights.

Counterpart of ``paddle_tpu/ops/pipeline_ops.py``: the training op
(``pipelined_transformer_stack``), the one-shot decoders (greedy or
sampled, beam search, self-speculative) and the serving paths of the
dense slot engine and the paged engine. Every weight carries a leading layer
axis [L, ...] in the JAX layout ([in, out], applied as ``x @ W``); where
the JAX package scans over that axis, the port runs a Python loop over
layers. Op functions take ``(attrs, ins)`` with ``ins`` a dict of slot
name -> [tensor] and return such a dict, exactly like their JAX twins.

Under AMP (``ops/common.py``) the four projections and the head take
bf16 operands (``amp_cast``, ``common.matmul``: f32 accumulation) and their
results are cast back to the activations' dtype, as the JAX op casts them,
so activations, q/k/v and the flash kernels stay f32.

Causal attention over a whole sequence (the training forward and every
one-shot decoder's and the dense engine's prefill) is the sm_90a flash kernel (``kernels/flash_attention.py``),
differentiable through its backward kernels; decode attention over the
slot cache, and both paged ops' attention over their gathered pages, stay
plain tensor code (``reference_attention``), as the JAX package leaves
them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import prng
from ..core.registry import register_op
from ..kernels.flash_attention import (flash_attention, reference_attention,
                                       rotary)
from ..kernels.sampling import sample_rows, top_logprobs
from .common import amp_cast, matmul, maybe, out, product_precision, single
from .control_flow_ops import _log_softmax, _top_k

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
    return _heads(_qkv_proj(p, h), h.shape[-1], num_heads, num_kv_heads,
                  use_rope, pos0)


def _qkv_proj(p, h):
    """LN1 and the qkv projection [b, t, d + 2 * d_kv] (the tensor the
    JAX op names ``qkv_proj``)."""
    hn_c, qkv_c = amp_cast(_ln(h, p["ln1_s"], p["ln1_b"]), p["qkv_w"])
    return matmul(hn_c, qkv_c).to(h.dtype)


def _heads(qkv, d, num_heads, num_kv_heads=None, use_rope=False, pos0=0):
    """q [b, H, t, dh], k/v [b, Hkv, t, dh] from the qkv projection."""
    num_kv_heads = num_kv_heads or num_heads
    b, t, _ = qkv.shape
    head_d = d // num_heads
    d_kv = head_d * num_kv_heads

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
    x = x + matmul(*amp_cast(ctx, p["out_w"])).to(x.dtype)
    h2 = _ln(x, p["ln2_s"], p["ln2_b"])
    ff = F.gelu(matmul(*amp_cast(h2, p["ff_w1"])).to(x.dtype) + p["ff_b1"],
                approximate="tanh")
    return x + (matmul(*amp_cast(ff, p["ff_w2"])).to(x.dtype) + p["ff_b2"])


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


def _dot_grads(a, w, g):
    """(da, dw) of ``matmul(*amp_cast(a, w)).to(g.dtype)`` for the
    cotangent ``g``, as its autograd computes them, without the product:
    a 2-D ``w`` folds a's leading dims into one product for dw."""
    a_c, w_c = amp_cast(a, w)
    g_c = g.to(a_c.dtype)
    with product_precision(a_c, w_c):
        da = torch.matmul(g_c, w_c.mT)
        dw = torch.matmul(a_c.reshape(-1, a_c.shape[-1]).mT,
                          g_c.reshape(-1, g.shape[-1]))
    return da.to(a.dtype), dw.to(w.dtype)


class _DotsLayer(torch.autograd.Function):
    """One block under ``remat="dots"``, the JAX op's
    ``save_only_these_names("qkv_proj", "attn_ctx", "attn_out",
    "ffn_hidden")``: the forward keeps the layer's input, its weights and
    the four named tensors (the qkv projection, the attention context
    [b, T, d], the out-projection and the FFN's GELU output); the
    backward recomputes the rest: both norms, the heads and the flash
    forward (its lse is not among the names, so the flash forward runs
    again), and the first FFN product under its GELU. The products whose
    outputs are named are not rerun: their gradients come from the
    saved operands (``_dot_grads``)."""

    @staticmethod
    def forward(ctx, x, cfg, keys, *weights):
        num_heads, causal, num_kv_heads, use_rope = cfg
        p = dict(zip(keys, weights))
        b, T, d = x.shape
        qkv = _qkv_proj(p, x)
        q, k, v = _heads(qkv, d, num_heads, num_kv_heads, use_rope)
        k, v = _expand_kv(k, v, num_heads)
        attn_ctx = flash_attention(q, k, v, causal=causal) \
            .transpose(1, 2).reshape(b, T, d)
        attn_out = matmul(*amp_cast(attn_ctx, p["out_w"])).to(x.dtype)
        mid = x + attn_out
        ffn_hidden = F.gelu(matmul(*amp_cast(
            _ln(mid, p["ln2_s"], p["ln2_b"]), p["ff_w1"])).to(x.dtype)
            + p["ff_b1"], approximate="tanh")
        ctx.cfg, ctx.keys = cfg, keys
        ctx.save_for_backward(x, qkv, attn_ctx, attn_out, ffn_hidden,
                              *weights)
        return mid + (matmul(*amp_cast(ffn_hidden, p["ff_w2"])).to(x.dtype)
                      + p["ff_b2"])

    @staticmethod
    def backward(ctx, g):
        num_heads, causal, num_kv_heads, use_rope = ctx.cfg
        x, qkv, attn_ctx, attn_out, ffn_hidden, *weights = ctx.saved_tensors
        p = dict(zip(ctx.keys, weights))
        grads = dict.fromkeys(ctx.keys)
        b, T, d = x.shape
        # out = mid + ffn_hidden @ ff_w2 + ff_b2
        grads["ff_b2"] = g.sum(dim=(0, 1)).to(p["ff_b2"].dtype)
        d_ff, grads["ff_w2"] = _dot_grads(ffn_hidden, p["ff_w2"], g)
        # ffn_hidden = gelu(LN2(mid) @ ff_w1 + ff_b1), mid = x + attn_out
        with torch.enable_grad():
            xl = x.detach().requires_grad_(True)
            al = attn_out.detach().requires_grad_(True)
            wl = {k: p[k].detach().requires_grad_(True)
                  for k in ("ln2_s", "ln2_b", "ff_w1", "ff_b1")}
            mid = xl + al
            hid = F.gelu(matmul(*amp_cast(
                _ln(mid, wl["ln2_s"], wl["ln2_b"]), wl["ff_w1"]))
                .to(x.dtype) + wl["ff_b1"], approximate="tanh")
            got = torch.autograd.grad([hid, mid], [xl, al, *wl.values()],
                                      [d_ff, g])
        dx, d_attn = got[0], got[1]
        grads.update(zip(wl, got[2:]))
        # attn_out = attn_ctx @ out_w
        d_ctx, grads["out_w"] = _dot_grads(attn_ctx, p["out_w"], d_attn)
        # attn_ctx = flash(heads of qkv), rerun for its lse
        with torch.enable_grad():
            ql = qkv.detach().requires_grad_(True)
            q, k, v = _heads(ql, d, num_heads, num_kv_heads, use_rope)
            k, v = _expand_kv(k, v, num_heads)
            o = flash_attention(q, k, v, causal=causal)
            d_qkv, = torch.autograd.grad(
                o.transpose(1, 2).reshape(b, T, d), [ql], [d_ctx])
        # qkv = LN1(x) @ qkv_w
        with torch.enable_grad():
            xl = x.detach().requires_grad_(True)
            wl = {k: p[k].detach().requires_grad_(True)
                  for k in ("ln1_s", "ln1_b")}
            hn = _ln(xl, wl["ln1_s"], wl["ln1_b"])
        d_hn, grads["qkv_w"] = _dot_grads(hn.detach(), p["qkv_w"], d_qkv)
        got = torch.autograd.grad([hn], [xl, *wl.values()], [d_hn])
        grads.update(zip(wl, got[1:]))
        dx = dx + got[0]
        return (dx, None, None) + tuple(grads[k] for k in ctx.keys)


@register_op("pipelined_transformer_stack")
def pipelined_transformer_stack(attrs, ins):
    """X [b, T, d] + stacked block weights (leading dim L) -> Out [b, T, d]:
    a loop over the L layers. Differentiable: the executor records it
    under autograd when its grad op follows. ``remat=True`` recomputes
    each layer in the backward (``torch.utils.checkpoint``), ``"dots"``
    all but its four named tensors (``_DotsLayer``). The port has no
    device mesh yet, so the JAX package's GPipe branch (a ``pp`` mesh
    axis) belongs to the parallel slice."""
    x = single(ins, "X")
    params = _stack_params(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    use_rope = attrs.get("use_rope", False)
    causal = attrs.get("causal", True)
    remat = attrs.get("remat", False)
    # unbind, not w[i]: its backward stacks the L layer grads in one
    # allocation instead of scattering each into a zero [L, ...] tensor
    keys = list(params)
    cfg = (num_heads, causal, num_kv_heads, use_rope)
    recording = torch.is_grad_enabled()
    h = x
    for layer_w in zip(*(params[key].unbind(0) for key in keys)):
        if recording and remat == "dots":
            h = _DotsLayer.apply(h, cfg, keys, *layer_w)
        elif recording and remat:
            h = checkpoint(_block_of, h, keys, cfg, *layer_w,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = _block(dict(zip(keys, layer_w)), h, num_heads, causal,
                       num_kv_heads, use_rope)
    return out(Out=h)


def _block_of(h, keys, cfg, *layer_w):
    return _block(dict(zip(keys, layer_w)), h, *cfg)


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
        return matmul(*amp_cast(_ln(h_last, ln_s, ln_b), head_w)).float()

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


def _make_pick(temperature, top_k, vocab, rng=None):
    """Next-token selection shared by the decode ops: argmax when
    ``temperature`` == 0 (draws nothing: the ops' needs_rng predicate
    leaves the scope key alone), otherwise temperature/top-k sampling as
    ``jax.random.categorical(fold_in(rng, step), z / T)``: the argmax of
    gumbel noise plus the scaled logits (``core/prng.py``), so sampled
    tokens equal the JAX package's."""
    if top_k and not 0 < top_k <= vocab:
        raise ValueError(f"top_k {top_k} outside [1, vocab {vocab}]")

    def pick(logits, step):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        z = logits
        if top_k:
            kth = torch.topk(z, top_k, dim=-1).values[:, -1:]
            z = torch.where(z >= kth, z, torch.full_like(z, -math.inf))
        z = z / torch.tensor(temperature, dtype=z.dtype, device=z.device)
        noise = prng.gumbel(prng.fold_in(rng, step), tuple(z.shape))
        return torch.argmax(noise + z, dim=-1)

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


@register_op("transformer_stack_generate", optional_inputs=("PosEmb",),
             needs_rng=lambda attrs: (attrs.get("temperature") or 0) > 0)
def transformer_stack_generate(attrs, ins, rng=None):
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
                      attrs.get("top_k") or 0, head_w.shape[1], rng)

    h, ks, vs = _prefill(params, embed(prompt, 0), num_heads, b, Tp,
                         num_kv_heads, use_rope)
    L = len(ks)
    shape = (L, b, ks[0].shape[1], Ttot, ks[0].shape[3])
    cache_k = torch.zeros(shape, dtype=ks[0].dtype, device=prompt.device)
    cache_v = torch.zeros_like(cache_k)
    cache_k[:, :, :, :Tp] = torch.stack(ks)
    cache_v[:, :, :, :Tp] = torch.stack(vs)
    tok = pick(logits_of(h[:, -1]), 0)
    generated = [tok]
    # prefill produced token Tp; the loop decodes the remaining N - 1
    for n in range(N - 1):
        pos = Tp + n
        h1 = embed(tok[:, None], pos)
        for i in range(L):
            h1 = _decode_layer(_layer(params, i), h1, cache_k[i],
                               cache_v[i], pos, num_heads, num_kv_heads,
                               use_rope)
        tok = pick(logits_of(h1[:, 0]), n + 1)
        generated.append(tok)
    gen = torch.stack(generated, dim=1).to(prompt.dtype)
    return out(Out=torch.cat([prompt, gen], dim=1))


def _unpack_lm_ins(ins):
    """(prompt, tok_emb, pos_emb, final LN scale, bias, head_w, stacked
    block weights) of a one-shot decoder's inputs."""
    return (single(ins, "Prompt"), single(ins, "TokEmb"),
            maybe(ins, "PosEmb"), single(ins, "FinalLnS"),
            single(ins, "FinalLnB"), single(ins, "HeadW"),
            _stack_params(ins))


def _padded_cache(ks, vs, T):
    """The prefill's per-layer K/V lists as [L, b, Hkv, T, dh] caches,
    rows past the prompt zero."""
    Tp = ks[0].shape[2]
    shape = (len(ks), ks[0].shape[0], ks[0].shape[1], T, ks[0].shape[3])
    cache_k = torch.zeros(shape, dtype=ks[0].dtype, device=ks[0].device)
    cache_v = torch.zeros_like(cache_k)
    cache_k[:, :, :, :Tp] = torch.stack(ks)
    cache_v[:, :, :, :Tp] = torch.stack(vs)
    return cache_k, cache_v


@register_op("transformer_stack_beam_search", optional_inputs=("PosEmb",))
def transformer_stack_beam_search(attrs, ins):
    """Beam search over the KV-cache decode path.

    Same inputs as transformer_stack_generate; attrs: num_heads,
    max_new_tokens, beam_size, length_penalty (GNMT
    ((5+len)/6)^alpha score normalisation), eos_id (-1 = none).
    Out [b, K, Tp + N] int (beams sorted best-first) and Scores [b, K]
    f32 (length-normalised log-probs).

    The beams ride the batch axis (caches [L, b*K, ...]); every step
    gathers each layer's cache by the surviving beams' parent index. The
    JAX op's scan over steps is a Python loop here, each step's top-K a
    stable sort, so ties break as ``lax.top_k`` breaks them."""
    (prompt, tok_emb, pos_emb, ln_s, ln_b, head_w,
     params) = _unpack_lm_ins(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    use_rope = attrs.get("use_rope", False)
    N = attrs["max_new_tokens"]
    K = attrs.get("beam_size", 4)
    alpha = attrs.get("length_penalty") or 0.0
    eos_id = attrs.get("eos_id", -1)
    if eos_id is None:
        eos_id = -1
    b, Tp = prompt.shape
    V = head_w.shape[1]
    if pos_emb is not None and Tp + N > pos_emb.shape[0]:
        raise ValueError(f"prompt {Tp} + {N} new tokens exceeds max_len "
                         f"{pos_emb.shape[0]}")
    if N < 1:
        raise ValueError("beam search needs max_new_tokens >= 1")
    if not 0 < K <= V:
        raise ValueError(f"beam_size {K} outside [1, vocab {V}]")
    dev = prompt.device
    embed = _embed_fn(tok_emb, pos_emb)
    logits_of = _logits_fn(ln_s, ln_b, head_w)

    # prefill over the bare batch, then tile to beams
    h, ks, vs = _prefill(params, embed(prompt, 0), num_heads, b, Tp,
                         num_kv_heads, use_rope)
    cache_k, cache_v = _padded_cache(ks, vs, Tp + N)
    cache_k = cache_k.repeat_interleave(K, dim=1)  # [L, b*K, Hkv, T, dh]
    cache_v = cache_v.repeat_interleave(K, dim=1)
    scores, tok0 = _top_k(_log_softmax(logits_of(h[:, -1])), K)  # [b, K]
    tokens = torch.full((b, K, N), eos_id if eos_id >= 0 else 0,
                        dtype=prompt.dtype, device=dev)
    tokens[:, :, 0] = tok0.to(prompt.dtype)
    alive = (tok0 != eos_id) if eos_id >= 0 else \
        torch.ones((b, K), dtype=torch.bool, device=dev)
    if eos_id >= 0:
        frozen = torch.full((V,), -math.inf, device=dev)
        frozen[eos_id] = 0.0
    batch_ix = torch.arange(b, device=dev)[:, None]
    for n in range(N - 1):
        pos = Tp + n  # the query's position
        h1 = embed(tokens[:, :, n].reshape(b * K)[:, None], pos)
        for i in range(cache_k.shape[0]):
            h1 = _decode_layer(_layer(params, i), h1, cache_k[i],
                               cache_v[i], pos, num_heads, num_kv_heads,
                               use_rope)
        logp = _log_softmax(logits_of(h1[:, 0])).reshape(b, K, V)
        # finished beams: only the eos continuation keeps their score
        if eos_id >= 0:
            logp = torch.where(alive[:, :, None], logp, frozen)
        cand = scores[:, :, None] + logp  # [b, K, V]
        scores, flat_idx = _top_k(cand.reshape(b, K * V), K)
        parent = flat_idx // V  # [b, K]
        tok = (flat_idx % V).to(tokens.dtype)
        tokens = tokens[batch_ix, parent]
        tokens[:, :, n + 1] = tok
        if eos_id >= 0:
            alive = alive[batch_ix, parent] & (tok != eos_id)
        flat_parent = (batch_ix * K + parent).reshape(b * K)
        cache_k = cache_k[:, flat_parent]
        cache_v = cache_v[:, flat_parent]

    if alpha:
        # GNMT length normalisation over the generated (non-frozen) length
        if eos_id >= 0:
            hit = tokens == eos_id
            gen_len = torch.clamp(hit.int().argmax(dim=2) + 1, max=N).float()
            gen_len = torch.where(hit.any(dim=2), gen_len,
                                  torch.full_like(gen_len, float(N)))
        else:
            gen_len = torch.full((b, K), float(N), device=dev)
        scores = scores / ((5.0 + gen_len) / 6.0) ** alpha
    order = torch.sort(-scores, dim=1, stable=True).indices
    tokens = tokens[batch_ix, order]
    scores = scores[batch_ix, order]
    prompts = prompt[:, None, :].expand(b, K, Tp)
    return out(Out=torch.cat([prompts, tokens], dim=2), Scores=scores)


def _window_verify(params, xw, cache_k, cache_v, pos0, num_heads,
                   num_kv_heads, use_rope):
    """Forward a w-token window through every layer against the cache
    (block-causal: window token i attends cache rows <= pos0 + i),
    writing the window's K/V at rows pos0..pos0+w-1 in place: the verify
    pass of speculative decoding. Returns the hidden [b, w, d]."""
    b, w, d = xw.shape
    row = max(0, min(pos0, cache_k.shape[3] - w))  # dynamic-update clamp
    h = xw
    for i in range(cache_k.shape[0]):
        layer_p = _layer(params, i)
        q, k, v = _attn_proj(layer_p, h, num_heads, num_kv_heads, use_rope,
                             pos0=pos0)
        cache_k[i, :, :, row:row + w] = k
        cache_v[i, :, :, row:row + w] = v
        ctx = reference_attention(q, cache_k[i], cache_v[i], causal=True,
                                  q_pos0=pos0)
        h = _attn_out_ffn(layer_p, h, ctx.transpose(1, 2).reshape(b, w, d))
    return h


@register_op("transformer_stack_speculative_generate",
             optional_inputs=("PosEmb",))
def transformer_stack_speculative_generate(attrs, ins):
    """Self-speculative greedy decoding: an early-exit draft proposes,
    the full stack verifies.

    Same inputs as transformer_stack_generate plus a draft head
    (DraftLnS/DraftLnB [d], DraftHeadW [d, V]); attrs: num_heads,
    max_new_tokens, draft_layers (k < L), gamma (proposals a round).
    Each round the first k layers of the same stack plus the draft head
    decode gamma tokens through the cache's first k layer planes; the
    full stack scores the window in one block-causal pass, and the
    longest prefix every batch row agrees on is accepted with the
    target's correction token. Out [b, Tp + N] int is exactly the greedy
    decode; Rounds [1] int32 counts the verify rounds.

    The JAX op's ``while_loop`` is a host loop: each round reads the
    batch-minimum acceptance back (one synchronisation a round)."""
    (prompt, tok_emb, pos_emb, ln_s, ln_b, head_w,
     params) = _unpack_lm_ins(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    use_rope = attrs.get("use_rope", False)
    N = attrs["max_new_tokens"]
    k_layers = attrs["draft_layers"]
    gamma = attrs.get("gamma", 4)
    b, Tp = prompt.shape
    L = params["ln1_s"].shape[0]
    if not 0 < k_layers < L:
        raise ValueError(f"draft_layers {k_layers} outside [1, {L - 1}]")
    if N < 1 or gamma < 1:
        raise ValueError("max_new_tokens and gamma must be >= 1")
    # cache slack: a round may write gamma + 1 rows past the last emit
    Ttot = Tp + N + gamma + 1
    if pos_emb is not None and Ttot > pos_emb.shape[0]:
        raise ValueError(
            f"prompt {Tp} + {N} new tokens (+{gamma + 1} speculative "
            f"slack) exceeds max_len {pos_emb.shape[0]}")
    if prompt.is_meta:  # shape inference: the loop's length is data
        return out(Out=torch.empty((b, Tp + N), dtype=prompt.dtype),
                   Rounds=torch.empty((1,), dtype=torch.int32))
    embed = _embed_fn(tok_emb, pos_emb)
    logits_of = _logits_fn(ln_s, ln_b, head_w)
    draft_logits_of = _logits_fn(single(ins, "DraftLnS"),
                                 single(ins, "DraftLnB"),
                                 single(ins, "DraftHeadW"))

    h, ks, vs = _prefill(params, embed(prompt, 0), num_heads, b, Tp,
                         num_kv_heads, use_rope)
    cache_k, cache_v = _padded_cache(ks, vs, Ttot)
    cur = torch.argmax(logits_of(h[:, -1]), dim=-1).to(prompt.dtype)
    tokens = torch.zeros((b, N + gamma + 1), dtype=prompt.dtype,
                         device=prompt.device)
    tokens[:, 0] = cur
    n, pos, rounds = 0, Tp, 0
    # tokens[0] came from the prefill; indices 0..n are filled
    while n < N - 1:
        # 1. draft chain: k-layer incremental decode of gamma proposals
        dtok, dtoks = cur, []
        for i in range(gamma):
            h1 = embed(dtok[:, None], pos + i)
            for j in range(k_layers):
                h1 = _decode_layer(_layer(params, j), h1, cache_k[j],
                                   cache_v[j], pos + i, num_heads,
                                   num_kv_heads, use_rope)
            dtok = torch.argmax(draft_logits_of(h1[:, 0]),
                                dim=-1).to(prompt.dtype)
            dtoks.append(dtok)
        dtoks = torch.stack(dtoks, dim=1)  # [b, gamma]
        # 2. verify: the full stack over [cur, d_0..d_{gamma-1}] at once
        window = torch.cat([cur[:, None], dtoks], dim=1)
        hw = _window_verify(params, embed(window, pos), cache_k, cache_v,
                            pos, num_heads, num_kv_heads, use_rope)
        t = torch.argmax(logits_of(hw.reshape(b * (gamma + 1), -1)),
                         dim=-1).reshape(b, gamma + 1).to(prompt.dtype)
        # 3. lockstep acceptance: the batch-min longest agreeing prefix
        agree = (t[:, :gamma] == dtoks).int()
        a = int(torch.cumprod(agree, dim=1).sum(dim=1).min())
        tokens[:, n + 1:n + 2 + a] = t[:, :a + 1]
        cur = t[:, a]
        n, pos, rounds = n + 1 + a, pos + 1 + a, rounds + 1
    return out(Out=torch.cat([prompt, tokens[:, :N]], dim=1),
               Rounds=torch.tensor([rounds], dtype=torch.int32,
                                   device=prompt.device))


# ---------------------------------------------------------------------------
# Slot-cache decode ops: the continuous-batching serving path
# (serving/generation.py). The KV cache is a slot table [L, S, Hkv, Tmax,
# dh]: requests claim a slot, prefill scatters their prompt K/V into it,
# and every decode step advances ALL slots one token, each at its own
# position. Where the JAX ops return updated copies (donated buffers),
# these ops update CacheK/CacheV IN PLACE and return the same tensors.
# Both are registered ops, as in the JAX package; ``rng`` is the key
# engine-wide sampling draws from (the engine's split of its scope key).
# ---------------------------------------------------------------------------

def _sampled(attrs):
    return (attrs.get("temperature") or 0) > 0


@register_op("transformer_stack_slot_prefill", optional_inputs=("PosEmb",),
             needs_rng=_sampled)
def transformer_stack_slot_prefill(attrs, ins, rng=None):
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
                      attrs.get("top_k") or 0, head_w.shape[1], rng)
    h, ks, vs = _prefill(params, embed(prompt, 0), num_heads, b, Tp,
                         num_kv_heads, use_rope)
    rows = torch.arange(b, device=h.device)
    last = h[rows, lengths.clamp(1, Tp) - 1]  # [b, d]
    next_tok = pick(_logits_fn(ln_s, ln_b, head_w)(last), 0)
    # each batch row lands in its slot's rows 0..Tp-1
    for i, (k, v) in enumerate(zip(ks, vs)):
        cache_k[i, slot_ids, :, :Tp] = k
        cache_v[i, slot_ids, :, :Tp] = v
    return out(NextTok=next_tok.to(prompt.dtype), CacheK=cache_k,
               CacheV=cache_v)


@register_op("transformer_stack_slot_decode", optional_inputs=("PosEmb",),
             needs_rng=_sampled)
def transformer_stack_slot_decode(attrs, ins, rng=None):
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
                      attrs.get("top_k") or 0, head_w.shape[1], rng)
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
    nxt = pick(_logits_fn(ln_s, ln_b, head_w)(h1[:, 0]), 0)
    return out(NextTok=nxt.to(tok.dtype), CacheK=cache_k, CacheV=cache_v)


# ---------------------------------------------------------------------------
# Paged-cache decode ops: the block-table serving path (vLLM's
# PagedAttention layout on the slot-op machinery). The KV cache is a PAGE
# POOL [L, N, Hkv, page_size, dh]; a per-row int32 block table maps
# logical positions to physical pages, so a sequence holds exactly
# ceil(len / page_size) pages, and a page shared by several sequences (a
# common system prompt) is stored ONCE. Page 0 is the scrap page: padding
# rows and vacant decode slots write there and nothing attends to it.
# Where the JAX ops return updated pools (donated buffers), these ops
# write CacheK/CacheV IN PLACE and return the same tensors: the paged
# engine's captured decode step needs the pools at fixed addresses.
# Attention gathers each row's table-width context per layer and runs the
# plain ``reference_attention``, as the JAX package does (no Pallas kernel
# on this path there, none here).
# ---------------------------------------------------------------------------

_SAMPLING_SLOTS = ("Temperature", "TopK", "TopP", "Seed", "Step", "Mask")


def _row_sampling(ins):
    """The per-row sampling plane, when fed: (temperature [rows], top_k
    [rows], top_p [rows], seed [rows], step [rows], mask [rows, V] or
    None), or None (the engine-wide attrs path)."""
    temp = maybe(ins, "Temperature")
    if temp is None:
        return None
    return (temp, single(ins, "TopK"), single(ins, "TopP"),
            single(ins, "Seed"), single(ins, "Step"), maybe(ins, "Mask"))


def _pick_rows(attrs, ins, rng, vocab, logits):
    """Next-token selection for the paged decode family: the per-row
    plane (``kernels.sampling.sample_rows``: seeds are inputs, ``rng`` is
    not drawn) when fed, else the engine-wide attrs drawing from ``rng``."""
    plane = _row_sampling(ins)
    if plane is None:
        return _make_pick(attrs.get("temperature") or 0.0,
                          attrs.get("top_k") or 0, vocab, rng)(logits, 0)
    return sample_rows(logits, *plane)


def _maybe_topk(attrs, ins, logits, outs):
    """Attach TopV/TopI (each row's top-``emit_topk`` masked log-probs)
    to ``outs`` when the op is asked for the beam plane."""
    k = attrs.get("emit_topk") or 0
    if k:
        vals, ids = top_logprobs(logits, int(k), maybe(ins, "Mask"))
        outs["TopV"], outs["TopI"] = [vals], [ids]
    return outs


def _gather_pages(pool_l, table):
    """pool_l [N, Hkv, ps, dh] gathered by table [b, P] -> the flattened
    context [b, Hkv, P*ps, dh]: flattened position j holds the token at
    sequence position j (table entry i covers positions i*ps..(i+1)*ps-1,
    so position order survives the transpose/reshape)."""
    b, P = table.shape
    _, hkv, ps, dh = pool_l.shape
    ctx = pool_l[table]  # [b, P, Hkv, ps, dh]
    return ctx.transpose(1, 2).reshape(b, hkv, P * ps, dh)


def _paged_targets(start, lengths, table, Tc, ps):
    """Absolute positions [b, Tc] of a prefill chunk and each token's
    (page, row) target; padding tokens write the scrap page 0."""
    P = table.shape[1]
    steps = torch.arange(Tc, device=start.device)
    pos = start[:, None] + steps[None, :]
    valid = steps[None, :] < lengths[:, None]
    entry = (pos // ps).clamp(0, P - 1)
    zero = torch.zeros_like(pos)
    page_id = torch.where(valid, torch.gather(table, 1, entry), zero)
    page_row = torch.where(valid, pos % ps, zero)
    return pos, page_id, page_row


def _lm_head(ins):
    return (single(ins, "TokEmb"), maybe(ins, "PosEmb"),
            _logits_fn(single(ins, "FinalLnS"), single(ins, "FinalLnB"),
                       single(ins, "HeadW")), single(ins, "HeadW").shape[1])


@register_op("transformer_stack_paged_prefill",
             optional_inputs=("PosEmb",) + _SAMPLING_SLOTS,
             needs_rng=_sampled)
def transformer_stack_paged_prefill(attrs, ins, rng=None):
    """Prefill ONE CHUNK of each row's prompt into its block-table pages.

    Chunk [b, Tc] int (right-padded), StartPos [b] int (absolute sequence
    position of each row's first chunk token: 0 for a plain prefill, the
    shared-prefix length for a prefix-cache hit, k*chunk for the k-th
    chunk of a streaming long prompt), Lengths [b] int (valid tokens in
    THIS chunk, 0..Tc; 0 marks a padding row), BlockTable [b, P] int (the
    row's full logical->physical page map; padding entries 0),
    CacheK/CacheV [L, N, Hkv, ps, dh] page pools, plus the shared LM
    weights. Returns NextTok [b] (from each row's LAST VALID chunk
    position: the first generated token when this chunk completes the
    prompt) and the pools, written IN PLACE with the chunk's K/V at rows
    StartPos..StartPos+Lengths-1 of each row's pages.

    Queries attend the row's WHOLE gathered context block-causally (chunk
    token at absolute position p sees cached position j iff j <= p), so a
    later chunk attends every earlier chunk's pages and a shared-prefix
    row attends shared pages it never prefilled.

    Optional per-row sampling plane (Temperature/TopK/TopP/Seed/Step [b]
    + Mask [b, V]): when fed, NextTok comes from ``sample_rows`` and
    ``rng`` is never drawn. ``emit_topk`` > 0 adds TopV/TopI.
    """
    chunk = single(ins, "Chunk")
    start = single(ins, "StartPos").long()
    lengths = single(ins, "Lengths").long()
    table = single(ins, "BlockTable").long()
    cache_k, cache_v = single(ins, "CacheK"), single(ins, "CacheV")
    tok_emb, pos_emb, logits_of, vocab = _lm_head(ins)
    params = _stack_params(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    use_rope = attrs.get("use_rope", False)
    b, Tc = chunk.shape
    d = params["ln1_s"].shape[1]
    dev = chunk.device
    pos, page_id, page_row = _paged_targets(start, lengths, table, Tc,
                                            cache_k.shape[3])
    h = _take_rows(tok_emb, chunk)
    if pos_emb is not None:
        h = h + pos_emb[pos.clamp(0, pos_emb.shape[0] - 1)]
    for i in range(params["qkv_w"].shape[0]):
        layer_p = _layer(params, i)
        ck_l, cv_l = cache_k[i], cache_v[i]  # pools [N, Hkv, ps, dh]
        q, k, v = _attn_proj(layer_p, h, num_heads, num_kv_heads, use_rope,
                             pos0=start)
        # k/v [b, Hkv, Tc, dh] -> page (page_id, page_row) per token
        ck_l[page_id, :, page_row] = k.transpose(1, 2)
        cv_l[page_id, :, page_row] = v.transpose(1, 2)
        ctx = reference_attention(q, _gather_pages(ck_l, table),
                                  _gather_pages(cv_l, table), causal=True,
                                  q_pos0=start)
        h = _attn_out_ffn(layer_p, h, ctx.transpose(1, 2).reshape(b, Tc, d))
    rows = torch.arange(b, device=dev)
    logits = logits_of(h[rows, lengths.clamp(1, Tc) - 1])
    nxt = _pick_rows(attrs, ins, rng, vocab, logits)
    outs = out(NextTok=nxt.to(chunk.dtype), CacheK=cache_k, CacheV=cache_v)
    return _maybe_topk(attrs, ins, logits, outs)


@register_op("transformer_stack_paged_decode",
             optional_inputs=("PosEmb",) + _SAMPLING_SLOTS,
             needs_rng=_sampled)
def transformer_stack_paged_decode(attrs, ins, rng=None):
    """One decode step over every slot's paged context.

    Tok [S] int (the pending token per slot), Pos [S] int (its sequence
    position == rows already cached for the slot), BlockTable [S, P] int
    (per-slot page map; vacant slots feed all-zeros + Pos 0, so their
    write lands in the scrap page), CacheK/CacheV [L, N, Hkv, ps, dh] page
    pools, plus the shared LM weights. Returns NextTok [S] and the pools,
    written IN PLACE with each slot's token K/V at page
    BlockTable[s, Pos//ps] row Pos%ps.

    The slot axis is the batch axis and the table width is static, so no
    shape depends on occupancy or sequence lengths and no value is read
    back to the host: the paged engine captures this op (with the
    sampling plane fed) once and replays it as a CUDA graph.

    Optional per-row sampling plane (Temperature/TopK/TopP/Seed/Step [S]
    + Mask [S, V]): per-request policy inside the one step; each row's
    token depends only on its context, policy, seed and step.
    ``emit_topk`` > 0 adds TopV/TopI [S, emit_topk].
    """
    tok = single(ins, "Tok")
    pos = single(ins, "Pos").long()
    table = single(ins, "BlockTable").long()
    cache_k, cache_v = single(ins, "CacheK"), single(ins, "CacheV")
    tok_emb, pos_emb, logits_of, vocab = _lm_head(ins)
    params = _stack_params(ins)
    num_heads = attrs["num_heads"]
    num_kv_heads = attrs.get("num_kv_heads") or num_heads
    use_rope = attrs.get("use_rope", False)
    S = tok.shape[0]
    if S != table.shape[0]:
        raise ValueError(f"Tok has {S} slots but the block table holds "
                         f"{table.shape[0]}")
    ps = cache_k.shape[3]
    P = table.shape[1]
    d = params["ln1_s"].shape[1]
    pos = pos.clamp(0, P * ps - 1)
    x = _take_rows(tok_emb, tok)
    if pos_emb is not None:
        x = x + pos_emb[pos.clamp(0, pos_emb.shape[0] - 1)]
    h1 = x[:, None, :]  # [S, 1, d]
    page_id = torch.gather(table, 1, (pos // ps)[:, None])[:, 0]  # [S]
    page_row = pos % ps
    for i in range(params["qkv_w"].shape[0]):
        layer_p = _layer(params, i)
        ck_l, cv_l = cache_k[i], cache_v[i]  # pools [N, Hkv, ps, dh]
        q, k, v = _attn_proj(layer_p, h1, num_heads, num_kv_heads, use_rope,
                             pos0=pos)
        ck_l[page_id, :, page_row] = k[:, :, 0]
        cv_l[page_id, :, page_row] = v[:, :, 0]
        ctx = reference_attention(q, _gather_pages(ck_l, table),
                                  _gather_pages(cv_l, table),
                                  lengths=pos + 1)
        h1 = _attn_out_ffn(layer_p, h1, ctx.transpose(1, 2).reshape(S, 1, d))
    logits = logits_of(h1[:, 0])
    nxt = _pick_rows(attrs, ins, rng, vocab, logits)
    outs = out(NextTok=nxt.to(tok.dtype), CacheK=cache_k, CacheV=cache_v)
    return _maybe_topk(attrs, ins, logits, outs)


@register_op("kv_cache_page_copy")
def kv_cache_page_copy(attrs, ins):
    """Copy whole KV pages inside the pools: the copy-on-write step.

    Src [n] int, Dst [n] int (distinct destination pages), CacheK/CacheV
    [L, N, Hkv, ps, dh]. Writes pool[:, Dst[i]] = pool[:, Src[i]] for both
    pools IN PLACE and echoes Dst as Ok [n]. The serving engine runs this
    when a sequence is about to write into a page whose refcount > 1 (a
    shared prefix page it is diverging from)."""
    src, dst = single(ins, "Src"), single(ins, "Dst")
    cache_k, cache_v = single(ins, "CacheK"), single(ins, "CacheV")
    cache_k[:, dst.long()] = cache_k[:, src.long()]
    cache_v[:, dst.long()] = cache_v[:, src.long()]
    return out(Ok=dst, CacheK=cache_k, CacheV=cache_v)
