"""The f32 flash dq and dkv past head dim 512, on the CPU.

On a CUDA tensor a head dim past 512 is zero-padded to a multiple of 128
(Dp), and dq and dkv run their 3xTF32 slice instances on the tensor cores
(``flash_bwd_dq_tf32x3_slice_kernel`` and
``flash_bwd_dkv_tf32x3_slice_kernel`` in ``csrc/flash_attention_bwd.cu``):
a block owns 16 rows (q rows for dq, keys for dkv) and its 8 warps are 8
parts of D, part p owning 16 columns of every 128; the outputs are cut into
slices of up to 1024 columns on the grid's z axis, and every block forms S
and dP (S^T and dP^T in dkv) over all of Dp: part p sums, over each 128
columns in order, the products over its 16 of them as two chains (one an
8-column k-step) summed after, and the eight partials are summed in part
order. So every slice holds the same P and dS (P^T and dS^T) bit for bit.
dq walks 16-key tiles up to the causal bound and adds each tile's dS K
over its slice; dkv walks 8-query tiles from the first that can see its
keys and adds each tile's P^T dO and dS^T Q over its slice; each tile's
products are fresh sums added in f32, and dq and dK are scaled once at
the end. The owned rows stay resident up to Dp 1152 and are streamed with
the steps past it (the same arithmetic).

Here both tilings are emulated (tile sizes and slice width read from the
source) and held against the JAX package's Pallas backward in interpret
mode at D576 (Dp 640), D640, D1024 and D1200 (Dp 1280, past the resident
limit: two slices, 1024 and 256 columns), causal (T 80) and ragged
(lengths [80, 37, 0]: a fully masked row), inputs from a numpy seed, f32,
atol = rtol = 1e-5; every slice's P and dS must agree bitwise. Then the
instances' shared memory at every Dp the route can hand over, the grid,
and the route.
"""
import functools
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
          / "flash_attention_bwd.cu").read_text()
SMEM_LIMIT = 232448  # bytes of shared memory a block may have


def _constant(name, namespace="bslice"):
    """``constexpr int name = value;`` of the first block of ``namespace``
    in the source (the file's top level with ``namespace`` None)."""
    text = SOURCE
    if namespace is not None:
        text = text[text.index(f"namespace {namespace} {{"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


NWARPS = _constant("NWARPS", None)
OWN = _constant("OWN")        # rows a block owns: q rows (dq), keys (dkv)
ROWS = _constant("ROWS")      # rows of a step: keys (dq), 8 q rows x 2 (dkv)
STEP = _constant("CH")        # columns of a step
SLICE = _constant("SLICE")    # output columns a block owns at most
SLOTS = _constant("SLOTS")
GROUP = _constant("GROUP")    # 16-row blocks a grid y index holds
RES_MAX = _constant("RES_MAX")
KEYS = ROWS                   # keys a dq tile
QUERIES = ROWS // 2           # queries a dkv tile
PART = STEP // NWARPS         # a part's columns of each step

# (B, H, T, causal, lengths): T = 80 leaves a ragged last 16-row block; a
# length of 0 is a fully masked row, 37 ends inside a tile
CASES = {"causal": (2, 2, 80, True, None),
         "ragged": (3, 1, 80, False, [80, 37, 0])}
DIMS = [576, 640, 1024, 1200]


def _inputs(B, H, T, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, T, D).astype(np.float32) for _ in range(4))


@functools.lru_cache(maxsize=None)
def _case(case, D):
    """Inputs and the Pallas backward in interpret mode: (q, k, v, g, lens,
    causal, sm, o, lse, (dq, dk, dv))."""
    B, H, T, causal, lens = CASES[case]
    q, k, v, g = _inputs(B, H, T, D, seed=D + len(case))
    sm = 1.0 / math.sqrt(D)  # the true head dim's scale
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = jfa._flash_forward(jq, jk, jv, jlens, causal, sm, block_q=16,
                                block_k=8, interpret=True)
    o = o.reshape(B, H, T, D)
    grads = jfa._flash_backward(jq, jk, jv, o, lse.reshape(B * H, 1, T),
                                jlens, jg, causal, sm, 16, 8, interpret=True)
    return (q, k, v, g, lens, causal, sm, np.array(o),
            np.array(lse).reshape(B, H, T), tuple(np.array(x) for x in grads))


def _flat(x, Dp):
    B, H, T, D = x.shape
    return F.pad(torch.from_numpy(x), (0, Dp - D)).reshape(B * H, T, Dp)


def _klen(lens, B, H, T):
    lens = torch.full((B,), T) if lens is None else torch.tensor(lens)
    return lens.clamp(0, T).repeat_interleave(H)


def _slices(Dp):
    """(first column, width) of each output slice on the grid's z axis."""
    return [(s0, min(SLICE, Dp - s0)) for s0 in range(0, Dp, SLICE)]


def _partial(a, b, part):
    """Part ``part``'s partial of a [BH, m, Dp] . b [BH, n, Dp]^T: over
    each STEP columns of Dp in order, the products over its PART columns
    of them, as two chains (one an 8-column k-step) summed after."""
    chains = []
    for kk in range(PART // 8):
        out = None
        for c0 in range(part * PART + 8 * kk, a.shape[-1], STEP):
            prod = a[..., c0:c0 + 8] @ b[..., c0:c0 + 8].transpose(1, 2)
            out = prod if out is None else out + prod
        chains.append(out)
    return chains[0] + chains[1]


def _parts(a, b):
    """The eight parts' partials summed in part order."""
    out = _partial(a, b, 0)
    for part in range(1, NWARPS):
        out = out + _partial(a, b, part)
    return out


def _visible(rows, cols, klen, causal):
    """[BH, m, n]: key ``cols`` is visible from query ``rows``."""
    ok = cols[None, None, :] < klen[:, None, None]
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None])[None]
    return ok


def _tensors(case, D):
    q, k, v, g, lens, causal, sm, o, lse, _ = _case(case, D)
    B, H, T, _ = q.shape
    Dp = tfa._kernel_head_dim(D)
    q3, k3, v3, do3 = (_flat(x, Dp) for x in (q, k, v, g))
    lse3 = torch.from_numpy(lse).reshape(B * H, T)
    di3 = (torch.from_numpy(g) * torch.from_numpy(o)).sum(-1).reshape(B * H,
                                                                      T)
    return q3, k3, v3, do3, lse3, di3, _klen(lens, B, H, T), causal, sm, Dp


def _dq_tiles(case, D):
    """(dq [BH, T, Dp], each slice's P and dS by tile) as the dq slice
    instance computes them: per slice, per 16-row q block, per 16-key
    tile up to the causal bound, S and dP as the parts' partials summed in
    part order, P from lse, dS = P (dP - Di), each tile's dS K over the
    slice a fresh sum added to dq; scaled once at the end."""
    q3, k3, v3, do3, lse3, di3, klen, causal, sm, Dp = _tensors(case, D)
    T = q3.shape[1]
    dq = torch.zeros_like(q3)
    seen = []
    for s0, width in _slices(Dp):
        tiles = []
        for q0 in range(0, T, OWN):
            rows = torch.arange(q0, min(q0 + OWN, T))
            acc = torch.zeros(q3.shape[0], rows.numel(), width)
            kend = min(q0 + OWN, T) if causal else T
            for k0 in range(0, kend, KEYS):
                keys = torch.arange(k0, min(k0 + KEYS, T))
                s = _parts(q3[:, rows], k3[:, keys])
                dp = _parts(do3[:, rows], v3[:, keys])
                p = torch.where(_visible(rows, keys, klen, causal),
                                torch.exp(s * sm - lse3[:, rows, None]), 0.0)
                ds = p * (dp - di3[:, rows, None])
                tiles.append((p, ds))
                acc = acc + ds @ k3[:, keys, s0:s0 + width]
            dq[:, rows, s0:s0 + width] = acc * sm
        seen.append(tiles)
    return dq, seen


def _dkv_tiles(case, D):
    """(dk, dv [BH, T, Dp], each slice's P^T and dS^T by tile) as the dkv
    slice instance computes them: per slice, per 16-key block, per 8-query
    tile from the first that can see the block, S^T and dP^T as the parts'
    partials summed in part order, P^T from lse, dS^T = P^T (dP^T - Di),
    each tile's P^T dO and dS^T Q over the slice fresh sums added to dV
    and dK; dK scaled once at the end."""
    q3, k3, v3, do3, lse3, di3, klen, causal, sm, Dp = _tensors(case, D)
    T = q3.shape[1]
    dk, dv = torch.zeros_like(k3), torch.zeros_like(v3)
    seen = []
    for s0, width in _slices(Dp):
        tiles = []
        for k0 in range(0, T, OWN):
            keys = torch.arange(k0, min(k0 + OWN, T))
            dk_acc = torch.zeros(k3.shape[0], keys.numel(), width)
            dv_acc = torch.zeros_like(dk_acc)
            first = k0 // QUERIES * QUERIES if causal else 0
            for q0 in range(first, T, QUERIES):
                qs = torch.arange(q0, min(q0 + QUERIES, T))
                st = _parts(k3[:, keys], q3[:, qs])
                dpt = _parts(v3[:, keys], do3[:, qs])
                vis = _visible(qs, keys, klen, causal).transpose(1, 2)
                pt = torch.where(vis, torch.exp(st * sm - lse3[:, None, qs]),
                                 0.0)
                dst = pt * (dpt - di3[:, None, qs])
                tiles.append((pt, dst))
                dv_acc = dv_acc + pt @ do3[:, qs, s0:s0 + width]
                dk_acc = dk_acc + dst @ q3[:, qs, s0:s0 + width]
            dk[:, keys, s0:s0 + width] = dk_acc * sm
            dv[:, keys, s0:s0 + width] = dv_acc
        seen.append(tiles)
    return dk, dv, seen


def _same_in_every_slice(seen):
    """Every slice formed the same P and dS, tile by tile, bit for bit."""
    for other in seen[1:]:
        assert len(other) == len(seen[0])
        for (p, ds), (p0, ds0) in zip(other, seen[0]):
            assert torch.equal(p, p0) and torch.equal(ds, ds0)


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_dq_matches_pallas_backward_interpret(case, D):
    q, lens = _case(case, D)[0], _case(case, D)[4]
    want = _case(case, D)[-1][0]
    dq, seen = _dq_tiles(case, D)
    Dp = tfa._kernel_head_dim(D)
    assert len(seen) == -(-Dp // SLICE)
    _same_in_every_slice(seen)
    dq = dq[..., :D].reshape(q.shape)
    np.testing.assert_allclose(dq.numpy(), want, **TOL)
    if lens is not None:
        masked = [b for b, n in enumerate(lens) if n == 0]
        assert masked and not dq[masked].any()


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_dkv_matches_pallas_backward_interpret(case, D):
    q, lens = _case(case, D)[0], _case(case, D)[4]
    _, want_dk, want_dv = _case(case, D)[-1]
    dk, dv, seen = _dkv_tiles(case, D)
    Dp = tfa._kernel_head_dim(D)
    assert len(seen) == -(-Dp // SLICE)
    _same_in_every_slice(seen)
    dk, dv = (x[..., :D].reshape(q.shape) for x in (dk, dv))
    np.testing.assert_allclose(dk.numpy(), want_dk, **TOL)
    np.testing.assert_allclose(dv.numpy(), want_dv, **TOL)
    if lens is not None:
        masked = [b for b, n in enumerate(lens) if n == 0]
        assert masked and not dk[masked].any() and not dv[masked].any()


def _ring_bytes(dkv, Dp):
    """The slice instances' ``Ring``, as the source lays it out: SLOTS
    steps (16 streamed rows of STEP columns at stride STEP + 4, and past
    RES_MAX the owned rows of the step: Q's or dO's 16 for dq, K's and V's
    16 each for dkv), the exchange (the S and dP partials of the 8 warps:
    2 x tiles x 4 values a lane), and up to RES_MAX the two owned tiles
    [16, Dp] at stride Dp + 4."""
    resident = Dp <= RES_MAX
    nt = (QUERIES if dkv else KEYS) // 8
    owned_rows = 0 if resident else (2 if dkv else 1) * OWN
    slot = (ROWS + owned_rows) * (STEP + 4)
    exchange = NWARPS * 2 * nt * 4 * 32
    owned = 2 * OWN * (Dp + 4) if resident else 0
    return (SLOTS * slot + exchange + owned) * 4


@pytest.mark.parametrize("Dp,dq,dkv", [
    (640, 166400, 158208), (1024, 215552, 207360), (1152, 231936, 223744),
    (1280, 151552, 210944), (4096, 151552, 210944)])
def test_slice_rings_fit_the_shared_memory(Dp, dq, dkv):
    """Each instance's shared memory at Dp, as its source lays it out and
    states it: the owned rows resident up to Dp 1152, streamed with the
    steps past it, so nothing grows past that; every Dp the route hands
    over (a multiple of 128 past 512) fits the 232,448 bytes a block may
    opt in to."""
    assert RES_MAX == 1152
    assert (_ring_bytes(False, Dp), _ring_bytes(True, Dp)) == (dq, dkv)
    for d in (1024, 1152, 1280):
        for kind in (False, True):
            assert f"{_ring_bytes(kind, d):,}" in SOURCE
    for d in range(640, 8192 + 1, STEP):
        assert max(_ring_bytes(False, d), _ring_bytes(True, d)) <= SMEM_LIMIT
    # a slice's steps of 128 columns, two n-tiles a warp each
    assert SLICE % STEP == 0 and PART == 16 and OWN == 16


@pytest.mark.parametrize("D", [513, 576, 1000, 1024, 1100, 1152, 1200,
                               4096])
def test_slice_grid_and_route(D):
    """Past 512 f32 dq and dkv take their slice instances at D padded to a
    multiple of 128 (as bf16's take theirs), and the grid holds it: bh on
    x, 64-row groups on y (GROUP blocks of 16 rows on z, beside the
    slices), so the grid's y axis holds 65535 x 64 rows, the limit
    ``_max_t`` checks, and z stays far below its 65535."""
    kd = -(-D // STEP) * STEP
    assert tfa._kernel_head_dim(D) == kd
    for kind in ("dq", "dkv"):
        entry = SOURCE[SOURCE.index(
            f'extern "C" int paddle_flash_attention_bwd_{kind}_f32'):]
        assert f"launch_{kind}_slice<" in entry[:entry.index("\n}\n")]
    assert GROUP * OWN == 64
    assert tfa._max_t(kd) == 65535 * GROUP * OWN
    assert GROUP * -(-kd // SLICE) <= 65535
