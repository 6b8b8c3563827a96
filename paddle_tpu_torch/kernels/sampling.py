"""Per-row token selection for the decode platform.

Counterpart of ``paddle_tpu/kernels/sampling.py``, which has no
``pallas_call``: plain tensor code is the port. One batched computation
selects the next token for EVERY decode row, each row carrying its own
policy as device scalars: temperature (0 = greedy argmax), top-k (0 =
off), top-p (1.0 = off), a per-row seed and the row's sampling step.
Randomness derives from ``fold_in(PRNGKey(seed), step)`` alone
(``core/prng.py``, bit-exact with ``jax.random``), so a row's token is a
pure function of (logits, policy, seed, step): invariant to batch
composition and tick interleaving, and equal to the JAX package's. No op
here reads a value back to the host, so the paged engine's decode step,
sampling included, replays as one CUDA graph.

``masked_logprobs``/``top_logprobs`` are the beam-search twins: the
per-row log-softmax (mask applied first) and its top-K.
"""
from __future__ import annotations

import torch

from ..core import prng

_NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free
# on rows whose mask bans everything (the host validates masks, but the
# device math must not poison the batch if one slips through)


def apply_mask(logits, mask):
    """Ban tokens where ``mask`` <= 0 (mask is [rows, V] float, 1 = allowed).
    None = no constraint."""
    if mask is None:
        return logits
    return torch.where(mask > 0, logits, torch.full_like(logits, _NEG_INF))


def masked_logprobs(logits, mask=None):
    """Per-row log-softmax with the token mask applied first."""
    return torch.log_softmax(apply_mask(logits.float(), mask), dim=-1)


def top_logprobs(logits, k: int, mask=None):
    """(values [rows, k], ids [rows, k] int32): each row's top-k masked
    log-probs, descending (ties: the lower token id first)."""
    lp = masked_logprobs(logits, mask)
    vals, ids = torch.sort(lp, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k].to(torch.int32)


def _topk_filter(z, top_k):
    """Per-row top-k: keep each row's k largest logits (k = 0 disables).
    Rows carry different k, so a sort and a per-row threshold."""
    V = z.shape[-1]
    kk = torch.where(top_k <= 0, V, top_k.clamp(1, V)).long()
    sorted_desc = torch.sort(z, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1, (kk - 1)[:, None])
    return torch.where(z >= kth, z, torch.full_like(z, _NEG_INF))


def _topp_filter(z, top_p):
    """Per-row nucleus filter over the (already temperature-scaled,
    top-k-filtered) logits: keep the smallest prefix of the descending
    distribution whose probability mass reaches top_p (always >= 1
    token). top_p >= 1 disables."""
    sorted_desc = torch.sort(z, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs  # exclusive prefix mass
    keep = cum_excl < top_p.clamp(0.0, 1.0)[:, None]
    keep[:, 0] = True
    # threshold: the smallest kept logit per row
    kept_min = torch.where(keep, sorted_desc,
                           torch.full_like(sorted_desc, torch.inf)).amin(-1)
    filt = torch.where(z >= kept_min[:, None], z,
                       torch.full_like(z, _NEG_INF))
    return torch.where((top_p >= 1.0)[:, None], z, filt)


def sample_rows(logits, temperature, top_k, top_p, seed, step, mask=None):
    """Select one token per row.

    logits [rows, V] f32; temperature [rows] f32; top_k [rows] int;
    top_p [rows] f32; seed [rows] int (uint32 values); step [rows] int
    (tokens this request has sampled so far); mask [rows, V] f32 or None.
    Returns ids [rows] int32. temperature == 0 rows take the masked argmax
    (no randomness consumed); sampled rows draw from the
    temperature-scaled, top-k- then top-p-filtered distribution by
    argmax(gumbel + z) with key ``fold_in(PRNGKey(seed), step)``.
    """
    z = apply_mask(logits.float(), mask)
    greedy = torch.argmax(z, dim=-1)
    temp = temperature.float().clamp(min=1e-6)
    zs = z / temp[:, None]
    zs = _topk_filter(zs, top_k)
    zs = _topp_filter(zs, top_p.float())
    key = prng.fold_in(prng.prng_key(seed), step)
    sampled = torch.argmax(prng.gumbel(key, zs.shape[-1]) + zs, dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)
