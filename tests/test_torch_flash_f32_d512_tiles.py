"""The f32 flash forward and dq at head dims 257-512, on the CPU.

On a CUDA tensor an f32 head dim in 257-384 is zero-padded to 384 and one
in 385-512 to 512, and the forward and dq run their 3xTF32 tensor-core
instances there (``flash_fwd_tf32x3_quarter_kernel`` in
``csrc/flash_attention_fwd.cu``, ``flash_bwd_dq_tf32x3_quarter_kernel``
in ``csrc/flash_attention_bwd.cu``): a block owns 32 q rows as two row
tiles of 16 and walks K/V tiles (16 keys in the forward, 8 in dq) up to
the causal bound; each of its 8 warps owns a quarter of D of its row
tile's output and forms S (and dP) for its 16 rows over that quarter,
the four partials of a row tile summed in part order by every warp of
it; each tile's P V (dS K) is summed fresh and added in f32. Here that
tiling is emulated (the tile sizes read from the sources) and held
against the JAX package's Pallas forward and backward in interpret mode
at D320, D384, D448 and D512, causal and ragged with a fully masked row,
inputs from a numpy seed, f32, atol = rtol = 1e-5; the four parts' row
max, denominator and lse must agree bitwise. Then the tiles against a
block's shared memory.
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
CSRC = Path(tfa.__file__).resolve().parent / "csrc"
SMEM_LIMIT = 232448  # bytes of shared memory a block may have


def _constant(source, name, namespace="qsplit"):
    """``constexpr int name = value;`` of the first block of ``namespace``
    in a kernel source (the file's top level with ``namespace`` None)."""
    text = (CSRC / source).read_text()
    if namespace is not None:
        text = text[text.index(f"namespace {namespace} {{"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


NWARPS = _constant("flash_attention_fwd.cu", "NWARPS", None)
# q rows a block owns and keys a tile, of the forward and of dq
FWD_ROWS = _constant("flash_attention_fwd.cu", "BQ")
FWD_KEYS = _constant("flash_attention_fwd.cu", "BK")
FWD_STAGES = _constant("flash_attention_fwd.cu", "STAGES")
DQ_ROWS = _constant("flash_attention_bwd.cu", "BOWN")
DQ_KEYS = _constant("flash_attention_bwd.cu", "BSTREAM")
# parts of D: the warps of a block over its 16-row row tiles
FWD_PARTS = NWARPS // (FWD_ROWS // 16)
DQ_PARTS = NWARPS // (DQ_ROWS // 16)

# (B, H, T, causal, lengths): T = 80 leaves a ragged last q block and an
# upper half past T in the last 64-row pair; a length of 0 is a fully
# masked row, 37 ends inside a key tile
CASES = {"causal": (2, 2, 80, True, None),
         "ragged": (3, 1, 80, False, [80, 37, 0])}
DIMS = [320, 384, 448, 512]


def _inputs(B, H, T, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, T, D).astype(np.float32) for _ in range(4))


def _pallas(q, k, v, g, lens, causal, sm):
    """(o, lse, dq) of the JAX package's Pallas kernels in interpret mode."""
    B, H, T, D = q.shape
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = jfa._flash_forward(jq, jk, jv, jlens, causal, sm, block_q=16,
                                block_k=8, interpret=True)
    o = o.reshape(B, H, T, D)
    dq, _, _ = jfa._flash_backward(jq, jk, jv, o, lse.reshape(B * H, 1, T),
                                   jlens, jg, causal, sm, 16, 8,
                                   interpret=True)
    return np.array(o), np.array(lse).reshape(B, H, T), np.array(dq)


def _flat(x, Dp):
    B, H, T, D = x.shape
    return F.pad(torch.from_numpy(x), (0, Dp - D)).reshape(B * H, T, Dp)


def _klen(lens, B, H, T):
    lens = torch.full((B,), T) if lens is None else torch.tensor(lens)
    return lens.clamp(0, T).repeat_interleave(H)


def _visible(rows, cols, klen, causal):
    """[BH, m, n]: key ``cols`` is visible from query ``rows``."""
    ok = cols[None, None, :] < klen[:, None, None]
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None])[None]
    return ok


def _parts(a, b, parts):
    """a [BH, m, Dp] . b [BH, n, Dp]^T as the sum, in part order, of the
    products over each part of D: each warp's partial."""
    w = a.shape[-1] // parts
    out = a[..., :w] @ b[..., :w].transpose(1, 2)
    for p in range(1, parts):
        c = slice(p * w, (p + 1) * w)
        out = out + a[..., c] @ b[..., c].transpose(1, 2)
    return out


def _n_keys(q0, rows, T, causal):
    """Keys a block's tiles reach: the causal bound of its last row."""
    return min(q0 + rows, T) if causal else T


def _forward_tiles(q, k, v, lens, causal, sm):
    """(o, lse, each part's lse) as the quarter forward computes them: per
    32-row q block, per key tile up to the causal bound, S as the sum
    of the parts' partial products (formed alike for each part of O), an
    online softmax, each tile's P V a fresh sum added to the part's O."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    w = Dp // FWD_PARTS
    q3, k3, v3 = (_flat(x, Dp) for x in (q, k, v))
    klen = _klen(lens, B, H, T)
    o = torch.zeros(B * H, T, Dp)
    part_lse = []
    for part in range(FWD_PARTS):  # the warps of a row tile
        cols = slice(part * w, (part + 1) * w)
        lse = torch.empty(B * H, T)
        for q0 in range(0, T, FWD_ROWS):
            rows = torch.arange(q0, min(q0 + FWD_ROWS, T))
            m = torch.full((B * H, rows.numel()), -math.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros(B * H, rows.numel(), w)
            for k0 in range(0, _n_keys(q0, FWD_ROWS, T, causal), FWD_KEYS):
                keys = torch.arange(k0, min(k0 + FWD_KEYS, T))
                s = _parts(q3[:, rows], k3[:, keys], FWD_PARTS) * sm
                s = s.masked_fill(~_visible(rows, keys, klen, causal),
                                  -math.inf)
                mnew = torch.maximum(m, s.amax(-1))
                m_safe = torch.where(torch.isfinite(mnew), mnew, 0.0)
                alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                    0.0)
                p = torch.exp(s - m_safe[..., None])
                l = l * alpha + p.sum(-1)
                m = mnew
                acc = acc * alpha[..., None] + p @ v3[:, keys, cols]
            o[:, rows, cols] = acc / l.clamp(min=1e-30)[..., None]
            lse[:, rows] = torch.where(
                l > 0, m + torch.log(l.clamp(min=1e-30)), math.inf)
        part_lse.append(lse)
    return (o[..., :D].reshape(B, H, T, D), part_lse[0].reshape(B, H, T),
            part_lse)


def _dq_tiles(q, k, v, lse, do, di, lens, causal, sm):
    """dq as the quarter dq kernel computes it: per 32-row q block and
    part of D, per key tile up to the causal bound, S and dP as the
    sums of the parts' partial products, P from lse, dS = P (dP - Di),
    each tile's dS K a fresh sum added to the part's dq; scaled once at
    the end."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    w = Dp // DQ_PARTS
    q3, k3, v3, do3 = (_flat(x, Dp) for x in (q, k, v, do))
    lse3 = torch.from_numpy(lse).reshape(B * H, T)
    di3 = di.reshape(B * H, T)
    klen = _klen(lens, B, H, T)
    dq = torch.zeros(B * H, T, Dp)
    for part in range(DQ_PARTS):
        cols = slice(part * w, (part + 1) * w)
        for q0 in range(0, T, DQ_ROWS):
            rows = torch.arange(q0, min(q0 + DQ_ROWS, T))
            acc = torch.zeros(B * H, rows.numel(), w)
            for k0 in range(0, _n_keys(q0, DQ_ROWS, T, causal), DQ_KEYS):
                keys = torch.arange(k0, min(k0 + DQ_KEYS, T))
                s = _parts(q3[:, rows], k3[:, keys], DQ_PARTS)
                dp = _parts(do3[:, rows], v3[:, keys], DQ_PARTS)
                p = torch.where(_visible(rows, keys, klen, causal),
                                torch.exp(s * sm - lse3[:, rows, None]), 0.0)
                ds = p * (dp - di3[:, rows, None])
                acc = acc + ds @ k3[:, keys, cols]
            dq[:, rows, cols] = acc * sm
    return dq[..., :D].reshape(B, H, T, D)


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_quarter_forward_matches_pallas_forward_interpret(case, D):
    B, H, T, causal, lens = CASES[case]
    q, k, v, g = _inputs(B, H, T, D, seed=D)
    sm = 1.0 / math.sqrt(D)  # the true head dim's scale
    want_o, want_lse, _ = _pallas(q, k, v, g, lens, causal, sm)
    o, lse, part_lse = _forward_tiles(q, k, v, lens, causal, sm)
    for other in part_lse[1:]:
        assert torch.equal(part_lse[0], other)
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    fin = np.isfinite(want_lse)
    assert np.array_equal(np.isfinite(lse.numpy()), fin)
    np.testing.assert_allclose(lse.numpy()[fin], want_lse[fin], **TOL)
    if lens is not None:
        masked = [b for b, n in enumerate(lens) if n == 0]
        assert masked and not o[masked].any()


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_quarter_dq_matches_pallas_backward_interpret(case, D):
    B, H, T, causal, lens = CASES[case]
    q, k, v, g = _inputs(B, H, T, D, seed=D + 1)
    sm = 1.0 / math.sqrt(D)
    jo, jlse, want = _pallas(q, k, v, g, lens, causal, sm)
    di = (torch.from_numpy(g) * torch.from_numpy(jo)).sum(-1)
    dq = _dq_tiles(q, k, v, jlse, g, di, lens, causal, sm)
    assert dq.shape == (B, H, T, D)
    np.testing.assert_allclose(dq.numpy(), want, **TOL)
    if lens is not None:
        masked = [b for b, n in enumerate(lens) if n == 0]
        assert masked and not dq[masked].any()


@pytest.mark.parametrize("D", [384, 512])
def test_quarter_tiles_fit_a_block(D):
    """The emulation's tiles are the sources' (32 q rows as two row tiles,
    four parts of D, 16 keys in the forward, 8 in dq), each part's columns
    take the accumulator's groups of 8-column tiles, and each kernel's
    shared memory, by the layout its source states, fits a block: the
    forward's K/V ring, exchange and Q, dq's Q and dO, K/V ring and
    exchange. The grid's y axis holds 65535 pairs of 32-row blocks (z
    picks the half)."""
    assert (FWD_ROWS, FWD_KEYS, DQ_ROWS, DQ_KEYS) == (32, 16, 32, 8)
    assert FWD_PARTS == DQ_PARTS == 4
    assert (D // FWD_PARTS) % 16 == 0
    st = D + 4  # row stride in floats
    fwd = (FWD_STAGES * FWD_KEYS * st * 2
           + NWARPS * (FWD_KEYS // 8) * 4 * 32 + FWD_ROWS * st) * 4
    dq = (2 * DQ_ROWS * st + 2 * DQ_KEYS * st * 2
          + NWARPS * 2 * (DQ_KEYS // 8) * 4 * 32) * 4
    assert {384: (157184, 157184), 512: (206336, 206336)}[D] == (fwd, dq)
    assert max(fwd, dq) <= SMEM_LIMIT
    assert tfa._max_t(D) == 65535 * 2 * FWD_ROWS
