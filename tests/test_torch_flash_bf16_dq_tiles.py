"""The bf16 flash dq kernel's rounding at its CUDA tiles, on the CPU.

The bf16 dq kernel (``csrc/flash_attention_bf16.cu``) runs on ``wgmma``:
a block owns 128 query rows and walks 64-key K/V tiles, carrying dq in
the tensor cores' f32 accumulator from one tile to the next. Where a
tile ends changes the order of the f32 sums. The Pallas dq kernel (in
interpret mode, as the JAX package's tests run it) at those tiles meets
the gate the CUDA kernel is held to on the card (``chip_smoke.py``'s
bf16 gate, the copy in ``tests/test_torch_flash_bf16_tiles.py``): dq at
most 2x as far from the f32 truth (the plain version on the same bf16
values) as the bf16 plain version, plus one bf16 ulp of the largest
|truth|, and its error's Frobenius norm at most 1.5x the plain
version's. A stale K/V stage planted in the plain version at the
kernel's key tile (a 64-key tile reading the tile before it) fails that
gate.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa
from test_torch_flash_bf16_tiles import (CASES, FWD_BLOCK_K, FWD_BLOCK_Q,
                                         _errors, _passes, _stale_stage,
                                         _torch)

torch.set_num_threads(1)
DQ_BLOCK_Q, DQ_BLOCK_K = 128, 64  # dq: query rows a block owns x keys a tile


def _pallas_dq_at_cuda_tiles(q, k, v, g, lengths, causal, sm):
    """dq of the Pallas kernels in interpret mode: the forward at its CUDA
    tiles (128 q rows x 128 keys) for o and lse, the backward at dq's (128
    q rows x 64 keys), T padded to 128 lanes as the JAX op pads it."""
    T = q.shape[2]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    qp, kp, vp, lens, _ = jfa._pad_to_lanes(q, k, v, jl)
    o, lse = jfa._flash_forward(qp, kp, vp, lens, causal, sm, FWD_BLOCK_Q,
                                FWD_BLOCK_K, interpret=True)
    gp = jnp.pad(g, ((0, 0), (0, 0), (0, qp.shape[2] - T), (0, 0)))
    dq, _, _ = jfa._flash_backward(qp, kp, vp, o, lse, lens, gp, causal, sm,
                                   DQ_BLOCK_Q, DQ_BLOCK_K, interpret=True)
    return _torch(dq[:, :, :T])


@pytest.mark.parametrize("case", sorted(CASES))
def test_dq_tiles_meet_the_card_gate(case):
    B, H, T, D, causal, lengths = CASES[case]
    rng = np.random.RandomState(T + D)
    q, k, v, g = (jnp.asarray(rng.randn(B, H, T, D).astype(np.float32),
                              jnp.bfloat16) for _ in range(4))
    sm = 1.0 / math.sqrt(D)
    got = _pallas_dq_at_cuda_tiles(q, k, v, g, lengths, causal, sm)
    lens = None if lengths is None else torch.tensor(lengths)
    tq, tk, tv, tg = (_torch(a) for a in (q, k, v, g))
    po, plse = tfa.flash_attention_reference(tq, tk, tv, lens, causal, sm)
    di = tfa._row_dot(tg, po)
    plain = tfa.flash_dq_reference(tq, tk, tv, plse, di, tg, lens, causal,
                                   sm)
    f32 = [t.float() for t in (tq, tk, tv, tg)]
    truth = tfa.flash_dq_reference(*f32[:3], plse, di, f32[3], lens, causal,
                                   sm)
    e = _errors(got, plain, truth)
    assert _passes(e), e
    assert e["fro_ratio"] < 1.05, e  # one rounding, not drift
    sk, sv = _stale_stage(tk, DQ_BLOCK_K), _stale_stage(tv, DQ_BLOCK_K)
    planted = tfa.flash_dq_reference(tq, sk, sv, plse, di, tg, lens, causal,
                                     sm)
    e = _errors(planted, plain, truth)
    assert not _passes(e), e
