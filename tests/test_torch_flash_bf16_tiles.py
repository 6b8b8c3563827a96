"""The bf16 flash kernels' rounding at the CUDA kernels' tiles, on the CPU.

The bf16 forward and dkv kernels (``csrc/flash_attention_bf16.cu``) run
on ``wgmma``: the forward walks 128-key K/V tiles for 128 q rows, dkv
walks 64-query Q/dO tiles for 128 keys. Where a tile ends changes how P
is rounded (the forward rounds P against the running max of the tiles
seen so far) and in what order the f32 sums run. The Pallas kernels (in
interpret mode, as the JAX package's tests run them) at those tiles
meet the gate the CUDA kernels are held to on the card
(``chip_smoke.py``'s bf16 gate, copied below): each of o, dq, dk and dv
at most 2x as far from the f32 truth (the plain version on the same
bf16 values) as the bf16 plain version, plus one bf16 ulp of the largest
|truth|, and its error's Frobenius norm at most 1.5x the plain
version's. A stale K/V stage planted in the plain version (a 64- or
128-key tile reading the tile before it) fails that gate.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)
FWD_BLOCK_Q = FWD_BLOCK_K = 128  # the forward: q rows x keys a tile
DKV_BLOCK_Q, DKV_BLOCK_K = 64, 128  # dkv: queries a tile x keys owned
FRO_RATIO = 1.5  # chip_smoke.py BF16_FRO_RATIO

# (B, H, T, D, causal, lengths)
CASES = {
    "causal_d128": (1, 2, 512, 128, True, None),
    "causal_lengths_d64": (2, 1, 384, 64, True, [384, 200]),
    "full_lengths_fully_masked_row_d128": (2, 1, 256, 128, False, [256, 0]),
}


def _errors(got, plain, truth):
    """chip_smoke.py's ``_bf16_errors``: max |error| of the output and of
    the bf16 plain version against the f32 truth over its finite
    elements, the max-abs limit (2x the plain's + one bf16 ulp of max
    |truth|) and the ratio of their errors' Frobenius norms."""
    fin = truth.isfinite()
    t = truth[fin]
    dk, dp = got.float()[fin] - t, plain.float()[fin] - t
    top = float(t.abs().max()) if t.numel() else 0.0
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0
    ep = float(dp.abs().max()) if t.numel() else 0.0
    nk, np_ = float(dk.norm()), float(dp.norm())
    return {"kernel": float(dk.abs().max()) if t.numel() else 0.0,
            "limit": 2 * ep + ulp,
            "fro_ratio": nk / np_ if np_ else (0.0 if nk == 0 else math.inf)}


def _passes(e):
    return e["kernel"] <= e["limit"] and e["fro_ratio"] <= FRO_RATIO


def _stale_stage(t, tile):
    """``t`` with its middle ``tile``-key tile holding the tile before it."""
    j = t.shape[2] // tile // 2
    out = t.clone()
    out[:, :, j * tile:(j + 1) * tile] = t[:, :, (j - 1) * tile:j * tile]
    return out


def _torch(a):
    """A bf16 jax array as a bf16 tensor (f32 numpy in between: exact)."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


def _pallas_at_cuda_tiles(q, k, v, g, lengths, causal, sm):
    """(o, dq, dk, dv) of the Pallas kernels in interpret mode: the
    forward at 128 q rows x 128 keys, the backward at 64 queries x 128
    keys, T padded to 128 lanes as the JAX op pads it."""
    T = q.shape[2]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    qp, kp, vp, lens, _ = jfa._pad_to_lanes(q, k, v, jl)
    o, lse = jfa._flash_forward(qp, kp, vp, lens, causal, sm, FWD_BLOCK_Q,
                                FWD_BLOCK_K, interpret=True)
    gp = jnp.pad(g, ((0, 0), (0, 0), (0, qp.shape[2] - T), (0, 0)))
    dq, dk, dv = jfa._flash_backward(qp, kp, vp, o, lse, lens, gp, causal,
                                     sm, DKV_BLOCK_Q, DKV_BLOCK_K,
                                     interpret=True)
    return tuple(_torch(a[:, :, :T]) for a in (o, dq, dk, dv))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_tiles_meet_the_card_gate(case):
    B, H, T, D, causal, lengths = CASES[case]
    rng = np.random.RandomState(T + D)
    q, k, v, g = (jnp.asarray(rng.randn(B, H, T, D).astype(np.float32),
                              jnp.bfloat16) for _ in range(4))
    sm = 1.0 / math.sqrt(D)
    got = _pallas_at_cuda_tiles(q, k, v, g, lengths, causal, sm)
    lens = None if lengths is None else torch.tensor(lengths)
    tq, tk, tv, tg = (_torch(a) for a in (q, k, v, g))
    po, plse = tfa.flash_attention_reference(tq, tk, tv, lens, causal, sm)
    plain = (po, *tfa.flash_attention_backward_reference(
        tq, tk, tv, po, plse, tg, lens, causal, sm))
    f32 = [t.float() for t in (tq, tk, tv, tg)]
    to, _ = tfa.flash_attention_reference(*f32[:3], lens, causal, sm)
    truth = (to, *tfa.flash_attention_backward_reference(
        *f32[:3], po.float(), plse, f32[3], lens, causal, sm))
    for name, a, b, t in zip(("o", "dq", "dk", "dv"), got, plain, truth):
        e = _errors(a, b, t)
        assert _passes(e), (name, e)
        assert e["fro_ratio"] < 1.05, (name, e)  # one rounding, not drift
    for tile in (64, 128):  # a stale stage of either ring
        sk, sv = _stale_stage(tk, tile), _stale_stage(tv, tile)
        fo, _ = tfa.flash_attention_reference(tq, sk, sv, lens, causal, sm)
        planted = (fo, *tfa.flash_attention_backward_reference(
            tq, sk, sv, po, plse, tg, lens, causal, sm))
        for name, f, b, t in zip(("o", "dq", "dk", "dv"), planted, plain,
                                 truth):
            e = _errors(f, b, t)
            assert not _passes(e), (tile, name, e)
