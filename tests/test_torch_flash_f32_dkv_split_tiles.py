"""The f32 flash dkv at head dims 129-256, on the CPU.

On a CUDA tensor an f32 head dim in 129-192 is zero-padded to 192 and one
in 193-256 to 256, and dkv runs its 3xTF32 tensor-core instance there
(``flash_bwd_dkv_tf32x3_split_kernel`` in ``csrc/flash_attention_bwd.cu``):
a block owns 64 keys and walks 16-query Q/dO tiles from the first one
that can see them; each warpgroup owns half of D of dK and dV and forms
S^T = K Q^T and dP^T = V dO^T for all 64 keys over its half of D, adding
its partner warps' partials for the other half (exchanged through shared
memory); P^T comes from lse, dS^T = P^T (dP^T - Di), and each tile's
P^T dO and dS^T Q are summed fresh and added to the half's dV and dK in
f32; dK is scaled once at the end. Here that tiling is emulated (the tile
sizes read from the source) and held against the JAX package's Pallas
backward in interpret mode at D160, D192 and D256, causal (T = 80: a
ragged second key block) and ragged (lengths [80, 37, 0], a fully masked
row), inputs from a numpy seed, f32, atol = rtol = 1e-5; both halves'
P^T and dS^T must agree bitwise. The route to it is checked in
``tests/test_torch_flash_f32_wide_tiles.py`` and
``tests/test_torch_flash_bf16_dkv_wide_tiles.py``.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
SOURCE = (Path(tfa.__file__).resolve().parent / "csrc"
          / "flash_attention_bwd.cu")


def _constant(name):
    """``constexpr int name = value;`` of the source's ``dsplit``
    namespace, which the dq and dkv split instances share."""
    text = SOURCE.read_text()
    block = text[text.index("namespace dsplit {"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", block).group(1))


# keys a block owns and queries a streamed tile
KEYS = _constant("BOWN")
QUERIES = _constant("BSTREAM")

# (B, H, T, causal, lengths): T = 80 leaves a ragged second key block; a
# length of 0 is a fully masked row, 37 ends inside a query tile
CASES = {"causal": (2, 2, 80, True, None),
         "ragged": (3, 1, 80, False, [80, 37, 0])}
DIMS = [160, 192, 256]


def _inputs(B, H, T, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, T, D).astype(np.float32) for _ in range(4))


def _pallas(q, k, v, g, lens, causal, sm):
    """(o, lse, dk, dv) of the JAX package's Pallas kernels in interpret
    mode."""
    B, H, T, D = q.shape
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = jfa._flash_forward(jq, jk, jv, jlens, causal, sm, block_q=16,
                                block_k=8, interpret=True)
    o = o.reshape(B, H, T, D)
    _, dk, dv = jfa._flash_backward(jq, jk, jv, o, lse.reshape(B * H, 1, T),
                                    jlens, jg, causal, sm, 16, 8,
                                    interpret=True)
    return (np.array(o), np.array(lse).reshape(B, H, T), np.array(dk),
            np.array(dv))


def _flat(x, Dp):
    B, H, T, D = x.shape
    return F.pad(torch.from_numpy(x), (0, Dp - D)).reshape(B * H, T, Dp)


def _dkv_tiles(q, k, v, lse, do, di, lens, causal, sm):
    """(dk, dv, the number of tiles whose halves were compared) as the
    split dkv kernel computes them: per 64-key block, per 16-query tile
    from the first that can see the block, S^T and dP^T as each
    warpgroup's own half-D partial plus its partner's (the two halves
    must agree bitwise), P^T from lse, dS^T = P^T (dP^T - Di), each
    tile's P^T dO and dS^T Q a fresh sum added to the half's dV and dK;
    dK scaled once at the end."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    q3, k3, v3, do3 = (_flat(x, Dp) for x in (q, k, v, do))
    lse3 = torch.from_numpy(lse).reshape(B * H, T)
    di3 = di.reshape(B * H, T)
    klen = (torch.full((B,), T) if lens is None
            else torch.tensor(lens)).clamp(0, T).repeat_interleave(H)
    halves = (slice(0, Dp // 2), slice(Dp // 2, Dp))
    dk = torch.zeros(B * H, T, Dp)
    dv = torch.zeros(B * H, T, Dp)
    compared = 0
    for k0 in range(0, T, KEYS):
        keys = torch.arange(k0, min(k0 + KEYS, T))
        dk_acc = torch.zeros(B * H, keys.numel(), Dp)
        dv_acc = torch.zeros_like(dk_acc)
        first = k0 // QUERIES if causal else 0
        for q0 in range(first * QUERIES, T, QUERIES):
            rows = torch.arange(q0, min(q0 + QUERIES, T))
            ok = keys[None, :, None] < klen[:, None, None]
            if causal:
                ok = ok & (rows[None, :] >= keys[:, None])[None]
            parts = [(k3[:, keys, h] @ q3[:, rows, h].transpose(1, 2),
                      v3[:, keys, h] @ do3[:, rows, h].transpose(1, 2))
                     for h in halves]
            pds = []
            for own in (0, 1):  # each warpgroup: its partial, then ^ 4's
                s = parts[own][0] + parts[1 - own][0]
                dp = parts[own][1] + parts[1 - own][1]
                p = torch.where(ok, torch.exp(s * sm - lse3[:, None, rows]),
                                0.0)
                pds.append((p, p * (dp - di3[:, None, rows])))
            assert torch.equal(pds[0][0], pds[1][0])
            assert torch.equal(pds[0][1], pds[1][1])
            compared += 1
            for own, h in enumerate(halves):
                p, ds = pds[own]
                dv_acc[..., h] += p @ do3[:, rows, h]
                dk_acc[..., h] += ds @ q3[:, rows, h]
        dk[:, keys] = dk_acc * sm
        dv[:, keys] = dv_acc
    return (dk[..., :D].reshape(B, H, T, D), dv[..., :D].reshape(B, H, T, D),
            compared)


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_dkv_matches_pallas_backward_interpret(case, D):
    B, H, T, causal, lens = CASES[case]
    q, k, v, g = _inputs(B, H, T, D, seed=D + 2)
    sm = 1.0 / math.sqrt(D)  # the true head dim's scale
    jo, jlse, want_dk, want_dv = _pallas(q, k, v, g, lens, causal, sm)
    di = (torch.from_numpy(g) * torch.from_numpy(jo)).sum(-1)
    dk, dv, compared = _dkv_tiles(q, k, v, jlse, g, di, lens, causal, sm)
    assert compared > 0
    assert dk.shape == dv.shape == (B, H, T, D)
    np.testing.assert_allclose(dk.numpy(), want_dk, **TOL)
    np.testing.assert_allclose(dv.numpy(), want_dv, **TOL)
    assert want_dk.any() and want_dv.any()
    if lens is not None:  # keys past a row's length get no gradient
        for b, n in enumerate(lens):
            assert not dk[b, :, n:].any() and not dv[b, :, n:].any()


def test_split_dkv_tiles_fit_the_grid_and_the_shared_memory():
    """The emulation's tiles are the source's (64 keys a block, 16-query
    tiles), the grid's y axis holds 65535 blocks of 64 keys, and K, V,
    two stages of Q, dO, lse and Di and the 16 KB exchange fit a block's
    232,448 bytes at D256: 216,320."""
    assert (KEYS, QUERIES) == (64, 16)
    for D in (192, 256):
        assert tfa._max_t(D) == 65535 * KEYS
    stride = 256 + 4
    exchange = 8 * 2 * (QUERIES // 8) * 4 * 32 * 4
    smem = (2 * KEYS * stride * 4 + 2 * 2 * QUERIES * stride * 4
            + 2 * 2 * QUERIES * 4 + exchange)
    assert (exchange, smem) == (16384, 216320) and smem <= 232448

