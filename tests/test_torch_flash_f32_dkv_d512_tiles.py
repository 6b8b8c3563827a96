"""The f32 flash dkv at head dims 257-512, on the CPU.

On a CUDA tensor an f32 head dim in 257-384 is zero-padded to 384 and one
in 385-512 to 512, and dkv runs its 3xTF32 tensor-core instance there
(``flash_bwd_dkv_tf32x3_quarter_kernel`` in ``csrc/flash_attention_bwd.cu``):
a block owns 32 keys as two key tiles of 16 and walks 8-query Q/dO tiles
from the first one that can see them; each of its 8 warps owns a quarter
of D of its key tile's dK and dV and forms S^T = K Q^T and dP^T = V dO^T
for its 16 keys over that quarter, the four partials of a key tile summed
in part order by every warp of it; P^T comes from lse, dS^T = P^T (dP^T -
Di), and each tile's P^T dO and dS^T Q are summed fresh and added to the
quarter's dV and dK in f32; dK is scaled once at the end. Here that tiling
is emulated (the tile sizes read from the source) and held against the
JAX package's Pallas backward in interpret mode at D320, D384, D448 and
D512, causal (T = 80: a ragged last key block) and ragged (lengths [80,
37, 0]: a full row, one that ends inside a query tile and a fully masked
one), inputs from a numpy seed, f32, atol = rtol = 1e-5; the four parts'
P^T and dS^T must agree bitwise. Then the tiles against a block's shared
memory and the grid. The route to it is checked in
``tests/test_torch_flash_f32_wide_tiles.py``.
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
SMEM_LIMIT = 232448  # bytes of shared memory a block may have


def _constant(name, namespace="qsplit"):
    """``constexpr int name = value;`` of the first block of ``namespace``
    in the source (the file's top level with ``namespace`` None)."""
    text = SOURCE.read_text()
    if namespace is not None:
        text = text[text.index(f"namespace {namespace} {{"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


NWARPS = _constant("NWARPS", None)
# keys a block owns and queries a streamed tile (the dq quarter instance's
# q rows and keys: the two share their layout)
KEYS = _constant("BOWN")
QUERIES = _constant("BSTREAM")
# parts of D: the warps of a block over its 16-key key tiles
PARTS = NWARPS // (KEYS // 16)

# (B, H, T, causal, lengths): T = 80 leaves a last 32-key block of 16
# keys; a length of 0 is a fully masked row, 37 ends inside a query tile
CASES = {"causal": (2, 2, 80, True, None),
         "ragged": (3, 1, 80, False, [80, 37, 0])}
DIMS = [320, 384, 448, 512]


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


def _part_sum(a, b, parts):
    """a [BH, m, Dp] . b [BH, n, Dp]^T as the sum, in part order, of the
    products over each part of D: each warp's partial."""
    w = a.shape[-1] // parts
    out = a[..., :w] @ b[..., :w].transpose(1, 2)
    for p in range(1, parts):
        c = slice(p * w, (p + 1) * w)
        out = out + a[..., c] @ b[..., c].transpose(1, 2)
    return out


def _dkv_tiles(q, k, v, lse, do, di, lens, causal, sm):
    """(dk, dv, the number of tiles whose parts were compared) as the
    quarter dkv kernel computes them: per 32-key block, per 8-query tile
    from the first that can see the block, S^T and dP^T as the sums of
    the four parts' partial products (formed alike by the warp of each
    part, which must agree bitwise), P^T from lse, dS^T = P^T (dP^T -
    Di), each tile's P^T dO and dS^T Q a fresh sum added to the part's dV
    and dK; dK scaled once at the end."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    w = Dp // PARTS
    q3, k3, v3, do3 = (_flat(x, Dp) for x in (q, k, v, do))
    lse3 = torch.from_numpy(lse).reshape(B * H, T)
    di3 = di.reshape(B * H, T)
    klen = (torch.full((B,), T) if lens is None
            else torch.tensor(lens)).clamp(0, T).repeat_interleave(H)
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
            pds = []
            for _ in range(PARTS):  # each warp sums the exchange alike
                s = _part_sum(k3[:, keys], q3[:, rows], PARTS)
                dp = _part_sum(v3[:, keys], do3[:, rows], PARTS)
                p = torch.where(ok, torch.exp(s * sm - lse3[:, None, rows]),
                                0.0)
                pds.append((p, p * (dp - di3[:, None, rows])))
            for p, ds in pds[1:]:
                assert torch.equal(pds[0][0], p)
                assert torch.equal(pds[0][1], ds)
            compared += 1
            for part, (p, ds) in enumerate(pds):
                c = slice(part * w, (part + 1) * w)
                dv_acc[..., c] = dv_acc[..., c] + p @ do3[:, rows, c]
                dk_acc[..., c] = dk_acc[..., c] + ds @ q3[:, rows, c]
        dk[:, keys] = dk_acc * sm
        dv[:, keys] = dv_acc
    return (dk[..., :D].reshape(B, H, T, D), dv[..., :D].reshape(B, H, T, D),
            compared)


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_quarter_dkv_matches_pallas_backward_interpret(case, D):
    B, H, T, causal, lens = CASES[case]
    q, k, v, g = _inputs(B, H, T, D, seed=D + 3)
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


@pytest.mark.parametrize("D", [384, 512])
def test_quarter_dkv_tiles_fit_the_grid_and_the_shared_memory(D):
    """The emulation's tiles are the source's (32 keys a block as two key
    tiles of 16, four parts of D, 8-query tiles), each part's columns take
    the accumulator's groups of four 8-column tiles, and K, V, two stages of
    Q, dO, lse and Di and the 8 KB exchange fit a block's 232,448 bytes.
    The grid's y axis holds 65535 pairs of 32-key blocks (z picks the
    half), the 64 keys a y index that ``_max_t`` counts."""
    assert (KEYS, QUERIES, PARTS) == (32, 8, 4)
    assert (D // PARTS) % 32 == 0
    assert tfa._kernel_head_dim(D) == D
    assert tfa._max_t(D) == 65535 * 2 * KEYS
    st = D + 4  # row stride in floats
    exchange = NWARPS * 2 * (QUERIES // 8) * 4 * 32 * 4
    smem = (2 * KEYS * st * 4 + 2 * 2 * QUERIES * st * 4 + exchange
            + 2 * 2 * QUERIES * 4)
    assert exchange == 8192
    assert smem == {384: 157312, 512: 206464}[D] and smem <= SMEM_LIMIT
