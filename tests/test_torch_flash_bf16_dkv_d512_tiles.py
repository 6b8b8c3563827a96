"""The bf16 flash dkv past head dim 256, on the CPU.

On a CUDA tensor a bf16 head dim in 257-384 is zero-padded to 384 and one
in 385-512 to 512, and dkv runs its ``wgmma`` instances there
(``csrc/flash_attention_bf16.cu``, ``dkv_half``): a block owns 64 keys
and computes one of the two outputs, the grid's z axis. The
dK half walks 16-query Q/dO tiles: each consumer warpgroup forms S^T =
K Q^T and dP^T = V dO^T over its half of D, the two f32 partials are
exchanged through shared memory and summed (both consumers hold the same
sum: f32 addition commutes), dS^T = P^T (dP^T - Di) is rounded to bf16
and each adds dS^T Q to its half of dK. The dV half walks 32-query
tiles, exchanges S^T's partials the same way, rounds P^T = exp(S^T
sm_scale - lse) and adds P^T dO to its half of dV.

Here that decomposition is emulated (the tile widths read from the
source) and held, at D384 and D512, causal and ragged with a fully
masked row, inputs from a numpy seed, to the gate the CUDA kernel is
held to on the card (``chip_smoke.py``'s bf16 gate, the copy in
``tests/test_torch_flash_bf16_tiles.py``, the tolerances of
``tests/test_torch_flash_bf16_d512_tiles.py``): against the bf16 plain
version and against the JAX package's Pallas backward in interpret mode
at the same tiles (64 owned keys, 16-query tiles for dk and 32-query
ones for dv), each output at most 2x as far from the f32 truth plus one
bf16 ulp of max |truth|, its error's Frobenius norm within 1.05x. Two
planted faults fail that gate: a stale Q/dO stage, and a stale exchange
(the other half's partial of the tile before). Then the shared memory
of both halves, as the source lays it out and its header states it.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa
from test_torch_flash_bf16_d512_tiles import (CASES, FWD_KEYS, LOG2E, ROWS,
                                              SMEM_LIMIT, SOURCE, _exchanged,
                                              _halves, _klen, _padded,
                                              _visible)
from test_torch_flash_bf16_tiles import _errors, _passes, _stale_stage, _torch

torch.set_num_threads(1)


def _half_ring(name):
    """(queries a tile, stages at 384, stages at 512, owned tiles,
    partials, stats a query) of a dkv half's ``SplitRing`` alias of the
    source (``DkHalf``, ``DvHalf``)."""
    found = re.search(rf"using {name} = SplitRing<D, (\d+), (\w+)\(D\), "
                      rf"(\d+), (\d+), (\d+)>;", SOURCE)
    stages = re.search(rf"constexpr int {found.group(2)}\(int D\) {{ "
                       r"return D <= 384 \? (\d+) : (\d+); }", SOURCE)
    return (int(found.group(1)), int(stages.group(1)), int(stages.group(2)),
            int(found.group(3)), int(found.group(4)), int(found.group(5)))


DK = _half_ring("DkHalf")
DV = _half_ring("DvHalf")
DK_QUERIES, DV_QUERIES = DK[0], DV[0]


def _half(q, k, v, lse, di, do, lens, causal, sm, nq, fault=None):
    """dk (``nq`` = DK_QUERIES) or dv (DV_QUERIES) [B, H, T, D] bf16 as
    dkv_half's dK or dV half computes it: 64 keys a block, ``nq``-query
    tiles from the causal bound, S^T (and dP^T) from two half-D f32
    partials,
    P^T = 2^(s c - lse log2 e) (0 where masked), dS^T = P^T (dP^T - Di)
    rounded to bf16 before dS^T Q (P^T before P^T dO), each half of D
    accumulated on its own; dk = sm_scale acc, dv = acc, rounded once."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    half = Dp // 2
    q3, k3, v3, do3 = (_padded(x, Dp) for x in (q, k, v, do))
    lse3, di3 = lse.reshape(B * H, T), di.reshape(B * H, T)
    klen = _klen(lens, B, H, T)
    c = sm * LOG2E
    dk = nq == DK_QUERIES
    out = torch.zeros(B * H, T, Dp)
    for k0 in range(0, T, ROWS):
        keys = torch.arange(k0, min(k0 + ROWS, T))
        acc = torch.zeros(B * H, keys.numel(), Dp)
        prev_s = prev_dp = None
        for q0 in range(k0 // nq * nq if causal else 0, T, nq):
            cols = torch.arange(q0, min(q0 + nq, T))
            s, prev_s = _exchanged(_halves(k3[:, keys], q3[:, cols], half),
                                   prev_s, fault)
            p = torch.exp2(s * c - (lse3[:, cols] * LOG2E)[:, None, :])
            ok = _visible(cols, keys, klen, causal).transpose(1, 2)
            a = torch.where(ok, p, 0.0)
            if dk:
                dp, prev_dp = _exchanged(_halves(v3[:, keys], do3[:, cols],
                                                 half), prev_dp, fault)
                a = a * (dp - di3[:, None, cols])
            b = (q3 if dk else do3)[:, cols]
            a = a.bfloat16().float()
            for h in (slice(0, half), slice(half, Dp)):  # each consumer's
                acc[..., h] = acc[..., h] + a @ b[..., h]
        out[:, keys] = (acc * (sm if dk else 1.0)).bfloat16().float()
    return out[..., :D].reshape(B, H, T, D).bfloat16()


def _pallas_dkv(q, k, v, g, lengths, causal, sm):
    """(dk, dv) of the Pallas kernels in interpret mode at the halves'
    tiles: the forward at the split forward's (ROWS q rows x FWD_KEYS
    keys) for o and lse, dkv at 64 owned keys and DK_QUERIES-query tiles
    for dk, DV_QUERIES-query ones for dv; T zero-padded to a multiple of
    all (padded keys masked by the lengths, padded queries carry dO = 0),
    D zero-padded as the CUDA route pads it."""
    B, T, D = q.shape[0], q.shape[2], q.shape[3]
    step = math.lcm(ROWS, FWD_KEYS, DK_QUERIES, DV_QUERIES)
    pad = ((0, 0), (0, 0), (0, -T % step),
           (0, tfa._kernel_head_dim(D) - D))
    qp, kp, vp, gp = (jnp.pad(a, pad) for a in (q, k, v, g))
    lens = jnp.asarray(lengths if lengths is not None else [T] * B,
                       jnp.int32)
    o, lse = jfa._flash_forward(qp, kp, vp, lens, causal, sm, ROWS,
                                FWD_KEYS, interpret=True)
    _, dk, _ = jfa._flash_backward(qp, kp, vp, o, lse, lens, gp, causal, sm,
                                   DK_QUERIES, ROWS, interpret=True)
    _, _, dv = jfa._flash_backward(qp, kp, vp, o, lse, lens, gp, causal, sm,
                                   DV_QUERIES, ROWS, interpret=True)
    return _torch(dk[:, :, :T, :D]), _torch(dv[:, :, :T, :D])


def _case(case):
    B, H, T, D, causal, lengths = CASES[case]
    rng = np.random.RandomState(T + D + 1)
    q, k, v, g = (jnp.asarray(rng.randn(B, H, T, D).astype(np.float32),
                              jnp.bfloat16) for _ in range(4))
    sm = 1.0 / math.sqrt(D)
    lens = None if lengths is None else torch.tensor(lengths)
    tq, tk, tv, tg = (_torch(a) for a in (q, k, v, g))
    po, plse = tfa.flash_attention_reference(tq, tk, tv, lens, causal, sm)
    di = tfa._row_dot(tg, po)
    plain = tfa.flash_dkv_reference(tq, tk, tv, plse, di, tg, lens, causal,
                                    sm)
    f32 = [t.float() for t in (tq, tk, tv, tg)]
    truth = tfa.flash_dkv_reference(*f32[:3], plse, di, f32[3], lens,
                                    causal, sm)
    return (q, k, v, g, lengths, causal, sm), (tq, tk, tv, tg, lens, plse,
                                               di), plain, truth


def _emulated(t, causal, sm, fault=None, stale=False):
    """(dk, dv) of the emulation; with ``stale`` each half's Q/dO stage
    holds the tile before it at its own tile width."""
    tq, tk, tv, tg, lens, plse, di = t
    out = []
    for nq in (DK_QUERIES, DV_QUERIES):
        q, g = ((_stale_stage(tq, nq), _stale_stage(tg, nq)) if stale
                else (tq, tg))
        out.append(_half(q, tk, tv, plse, di, g, lens, causal, sm, nq,
                         fault))
    return tuple(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dkv_halves_meet_the_card_gate(case):
    jax_in, t, plain, truth = _case(case)
    got = _emulated(t, jax_in[5], jax_in[6])
    pallas = _pallas_dkv(*jax_in)
    for name, a, b, p, tr in zip(("dk", "dv"), got, plain, pallas, truth):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        for ref in (b, p):  # the plain version; Pallas at the same tiles
            e = _errors(a, ref, tr)
            assert _passes(e), (name, e)
            assert e["fro_ratio"] < 1.05, (name, e)  # one rounding
        e = _errors(p, b, tr)  # and Pallas at these tiles meets the gate
        assert _passes(e) and e["fro_ratio"] < 1.05, (name, e)
    lengths = jax_in[4]
    if lengths is not None:  # a head with no keys: dk = dv = 0
        masked = [b for b, n in enumerate(lengths) if n == 0]
        assert masked and not any(x[masked].float().any() for x in got)


@pytest.mark.parametrize("fault", ["stale_qdo", "exchange"])
@pytest.mark.parametrize("case", ["causal_d512", "ragged_d384"])
def test_planted_fault_fails_the_gate(case, fault):
    """A stale Q/dO stage (a query tile reading the one before it) or a
    stale exchange (the other half's partial of the tile before) moves
    dk and dv past the gate."""
    jax_in, t, plain, truth = _case(case)
    got = _emulated(t, jax_in[5], jax_in[6],
                    fault="exchange" if fault == "exchange" else None,
                    stale=fault == "stale_qdo")
    for name, a, b, tr in zip(("dk", "dv"), got, plain, truth):
        assert not _passes(_errors(a, b, tr)), (fault, name)


@pytest.mark.parametrize("ring,D,want", [
    (DK, 384, 229960), (DK, 512, 229672),
    (DV, 384, 229816), (DV, 512, 229672)])
def test_dkv_half_rings_fit_the_shared_memory(ring, D, want):
    """Each half's ``SplitRing`` bytes, as the source lays them out: the
    owned tiles (64 keys each: K; K and V), the Q/dO stages, two exchange
    buffers of both consumers' f32 partials, each stage's lse (and Di),
    the barriers; what the source's header states, under the 232,448
    bytes a block may opt in to. A launch asks for the larger half's."""
    queries, stages384, stages512, owned, parts, stats = ring
    stages = stages384 if D <= 384 else stages512
    nb = D // 64
    owned_bytes = owned * nb * ROWS * 128
    ring_bytes = stages * 2 * nb * queries * 128
    exchange = 2 * 2 * parts * ROWS * queries * 4
    stat_bytes = stages * stats * queries * 4
    smem = (owned_bytes + ring_bytes + exchange + stat_bytes
            + (1 + 2 * stages) * 8)
    assert smem == want <= SMEM_LIMIT
    assert f"{want:,}" in SOURCE
    assert (owned, parts, stats) == ((2, 2, 2) if ring is DK else (1, 1, 1))
