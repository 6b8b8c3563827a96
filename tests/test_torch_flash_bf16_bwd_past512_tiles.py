"""The bf16 flash dq and dkv past head dim 512, on the CPU.

On a CUDA tensor a head dim past 512 is zero-padded to a multiple of 128
(Dp), and bf16 dq and dkv run their slice instances on ``wgmma`` fed by
TMA (``flash_bwd_dq_slice_bf16_kernel`` and
``flash_bwd_dkv_slice_bf16_kernel``, ``bwd_slice`` in
``csrc/flash_attention_bf16.cu``): a block owns 64 rows (q rows for dq,
keys for dkv) and walks tiles of 32 streamed rows (keys for dq, queries
for dkv, from the first that can see its keys). One consumer warpgroup
forms S (S^T) and the other dP (dP^T), each over all of Dp's 64-column
boxes in order, the two are exchanged, and both form P and dS (P^T and
dS^T) from them; so every slice of the outputs holds the same P and dS
bit for bit. The outputs are cut into slices on the grid's z axis: dq's
of 512 columns (each consumer half of them, dq += dS K over the slice's
boxes), dk's and dv's of 256 (consumer 0 dk += dS^T Q, consumer 1 dv +=
P^T dO); P and dS are rounded to the inputs' dtype before those products
(bf16 on the card, nothing in f32), each tile's product is a fresh sum
added in f32, and dq and dk are scaled once at the end. The first owned
tile (Q, K) stays resident up to Dp 1024 and the second comes with each
tile's stages, both past 1024: the same arithmetic.

Here both tilings are emulated (tile rows, slice widths, stages and
resident limits read from the source) and held against the JAX
package's Pallas backward in interpret mode at D576 (Dp 640), D640,
D1024 and D1200 (Dp 1280, past the resident limit), causal (T 80) and
ragged (lengths [80, 37, 0]: a fully masked row), inputs from a numpy
seed, f32, atol = rtol = 1e-5; every slice's P and dS must agree
bitwise. Then the instances' shared memory at every Dp the route can
hand over, the grid, and the route: the CUDA route with the kernel
entries swapped for their plain versions, and no wide route left.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import flash_attention as tfa
from test_torch_flash_bf16_wide_tiles import _PlainKernels
from test_torch_flash_f32_bwd_past512_tiles import (CASES, TOL, _case,
                                                    _same_in_every_slice,
                                                    _tensors, _visible)

torch.set_num_threads(1)
CSRC = Path(tfa.__file__).resolve().parent / "csrc"
SOURCE = (CSRC / "flash_attention_bf16.cu").read_text()
SMEM_LIMIT = 232448  # bytes of shared memory a block may have
LOG2E = 1.4426950408889634


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


OWN = _constant("SPLIT_OWN")        # rows a block owns: q rows, keys
ROWS = _constant("BWD_SLICE_ROWS")  # streamed rows a tile: keys, queries
DQ_SLICE = _constant("DQ_SLICE")    # dq columns a block owns at most
DKV_SLICE = _constant("DKV_SLICE")  # dk and dv columns a block owns at most
RES_MAX = _constant("BWD_RES_MAX")  # the first owned tile resident to here
_stages = re.search(r"struct BwdSliceRing \{.*?STAGES = ARES \? (\d+) : "
                    r"(\d+);", SOURCE, re.S)
STAGES = {True: int(_stages.group(1)), False: int(_stages.group(2))}
BOX = 64  # columns of a TMA box
DIMS = [576, 640, 1024, 1200]


def _slices(Dp, width):
    """(first column, width) of each output slice on the grid's z axis."""
    return [(s0, min(width, Dp - s0)) for s0 in range(0, Dp, width)]


def _boxes(a, b):
    """a [BH, m, Dp] . b [BH, n, Dp]^T as one consumer forms it: the
    products over Dp's 64-column boxes, summed in box order."""
    out = None
    for c0 in range(0, a.shape[-1], BOX):
        prod = a[..., c0:c0 + BOX] @ b[..., c0:c0 + BOX].transpose(1, 2)
        out = prod if out is None else out + prod
    return out


def _rounded(x, like):
    """P or dS rounded to the operands' dtype before the product that
    takes it (bf16 on the card; a no-op on these f32 inputs)."""
    return x.to(like.dtype).float()


def _dq_tiles(case, D):
    """(dq [BH, T, Dp], each slice's P and dS by tile) as the dq slice
    instance computes them: per slice, per 64-row q block, per 32-key tile
    up to the causal bound, S and dP over Dp's boxes in order, P = 2^(s
    sm log2 e - lse log2 e) (0 where masked), dS = P (dP - Di), each
    tile's dS K over the slice a fresh sum added to dq; scaled once."""
    q3, k3, v3, do3, lse3, di3, klen, causal, sm, Dp = _tensors(case, D)
    T = q3.shape[1]
    c = sm * LOG2E
    dq = torch.zeros_like(q3)
    seen = []
    for s0, width in _slices(Dp, DQ_SLICE):
        tiles = []
        for q0 in range(0, T, OWN):
            rows = torch.arange(q0, min(q0 + OWN, T))
            acc = torch.zeros(q3.shape[0], rows.numel(), width)
            kend = min(q0 + OWN, T) if causal else T
            for k0 in range(0, kend, ROWS):
                keys = torch.arange(k0, min(k0 + ROWS, T))
                s = _boxes(q3[:, rows], k3[:, keys])
                dp = _boxes(do3[:, rows], v3[:, keys])
                p = torch.where(_visible(rows, keys, klen, causal),
                                torch.exp2(s * c - lse3[:, rows, None]
                                           * LOG2E), 0.0)
                ds = p * (dp - di3[:, rows, None])
                tiles.append((p, ds))
                acc = acc + _rounded(ds, k3) @ k3[:, keys, s0:s0 + width]
            dq[:, rows, s0:s0 + width] = acc * sm
        seen.append(tiles)
    return dq, seen


def _dkv_tiles(case, D):
    """(dk, dv [BH, T, Dp], each slice's P^T and dS^T by tile) as the dkv
    slice instance computes them: per slice, per 64-key block, per
    32-query tile from the first that can see the block, S^T and dP^T
    over Dp's boxes in order, P^T from lse, dS^T = P^T (dP^T - Di), each
    tile's dS^T Q and P^T dO over the slice fresh sums added to dK and
    dV; dK scaled once."""
    q3, k3, v3, do3, lse3, di3, klen, causal, sm, Dp = _tensors(case, D)
    T = q3.shape[1]
    c = sm * LOG2E
    dk, dv = torch.zeros_like(k3), torch.zeros_like(v3)
    seen = []
    for s0, width in _slices(Dp, DKV_SLICE):
        tiles = []
        for k0 in range(0, T, OWN):
            keys = torch.arange(k0, min(k0 + OWN, T))
            dk_acc = torch.zeros(k3.shape[0], keys.numel(), width)
            dv_acc = torch.zeros_like(dk_acc)
            first = k0 // ROWS * ROWS if causal else 0
            for t0 in range(first, T, ROWS):
                qs = torch.arange(t0, min(t0 + ROWS, T))
                st = _boxes(k3[:, keys], q3[:, qs])
                dpt = _boxes(v3[:, keys], do3[:, qs])
                vis = _visible(qs, keys, klen, causal).transpose(1, 2)
                pt = torch.where(vis, torch.exp2(st * c - lse3[:, None, qs]
                                                 * LOG2E), 0.0)
                dst = pt * (dpt - di3[:, None, qs])
                tiles.append((pt, dst))
                dk_acc = dk_acc + _rounded(dst, q3) @ q3[:, qs,
                                                         s0:s0 + width]
                dv_acc = dv_acc + _rounded(pt, do3) @ do3[:, qs,
                                                          s0:s0 + width]
            dk[:, keys, s0:s0 + width] = dk_acc * sm
            dv[:, keys, s0:s0 + width] = dv_acc
        seen.append(tiles)
    return dk, dv, seen


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_slice_dq_matches_pallas_backward_interpret(case, D):
    q, lens = _case(case, D)[0], _case(case, D)[4]
    want = _case(case, D)[-1][0]
    dq, seen = _dq_tiles(case, D)
    Dp = tfa._kernel_head_dim(D)
    assert len(seen) == -(-Dp // DQ_SLICE)
    _same_in_every_slice(seen)
    dq = dq[..., :D].reshape(q.shape)
    np.testing.assert_allclose(dq.numpy(), want, **TOL)
    if lens is not None:
        masked = [b for b, n in enumerate(lens) if n == 0]
        assert masked and not dq[masked].any()


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_slice_dkv_matches_pallas_backward_interpret(case, D):
    q, lens = _case(case, D)[0], _case(case, D)[4]
    _, want_dk, want_dv = _case(case, D)[-1]
    dk, dv, seen = _dkv_tiles(case, D)
    Dp = tfa._kernel_head_dim(D)
    assert len(seen) == -(-Dp // DKV_SLICE)
    _same_in_every_slice(seen)
    dk, dv = (x[..., :D].reshape(q.shape) for x in (dk, dv))
    np.testing.assert_allclose(dk.numpy(), want_dk, **TOL)
    np.testing.assert_allclose(dv.numpy(), want_dv, **TOL)
    if lens is not None:
        masked = [b for b, n in enumerate(lens) if n == 0]
        assert masked and not dk[masked].any() and not dv[masked].any()


def _ring_bytes(Dp):
    """``BwdSliceRing<ARES>``'s bytes, as the source lays them out: the
    first owned tile's Dp / 64 boxes of 64 rows (ARES, up to RES_MAX),
    the stages (the two streamed boxes of ROWS rows, the second owned
    tile's box and without ARES the first's), two exchange buffers of
    both consumers' [64, ROWS] f32 products, the barriers."""
    ares = Dp <= RES_MAX
    a_box, b_box = OWN * 128, ROWS * 128
    stage = 2 * b_box + (1 if ares else 2) * a_box
    resident = (Dp // BOX) * a_box if ares else 0
    exchange = 2 * 2 * OWN * ROWS * 4
    return (resident + STAGES[ares] * stage + exchange
            + (1 + 2 * STAGES[ares]) * 8)


@pytest.mark.parametrize("Dp,want", [
    (640, 180296), (768, 196680), (1024, 229448), (1152, 229512),
    (1280, 229512), (4096, 229512)])
def test_bf16_slice_rings_fit_the_shared_memory(Dp, want):
    """The instances' shared memory at Dp, as the source lays it out and
    states it: the first owned tile resident to Dp 1024, both streamed
    past it, so nothing grows past that; every Dp the route hands over (a
    multiple of 128 past 512) fits the 232,448 bytes a block may opt in
    to, and the outputs leave through offset 0 (the first owned tile's
    boxes, or the ring past 1024), which holds both consumers' four
    boxes."""
    assert (RES_MAX, ROWS, OWN) == (1024, 32, 64)
    assert _ring_bytes(Dp) == want
    for d in (640, RES_MAX, RES_MAX + 128):
        assert f"{_ring_bytes(d):,}" in SOURCE
    for d in range(640, 8192 + 1, 128):
        assert _ring_bytes(d) <= SMEM_LIMIT
        staged = ((d // BOX) * OWN * 128 if d <= RES_MAX
                  else STAGES[False] * (2 * ROWS * 128 + 2 * OWN * 128))
        assert staged >= 2 * 4 * OWN * 128
    # each consumer's output: at most 4 boxes (128 f32 registers)
    assert DQ_SLICE // 2 // BOX == 4 and DKV_SLICE // BOX == 4


@pytest.mark.parametrize("D", [513, 576, 1000, 1024, 1100, 1152, 1200,
                               4096])
def test_bf16_slice_grid_and_route(D):
    """Past 512 bf16 dq and dkv take their slice instances at D padded to
    a multiple of 128, and the grid holds it: bh on x, 64-row blocks on y
    (the 65535 x 64 rows ``_max_t`` checks), the slices on z (dq's of
    512 columns, dk's and dv's of 256), far below z's 65535. The C entry
    points hand every multiple of 128 past 512 to the slice launches and
    no wide route is left."""
    kd = -(-D // 128) * 128
    assert tfa._kernel_head_dim(D) == kd
    assert tfa._max_t(kd) == 65535 * OWN
    assert -(-kd // DKV_SLICE) <= 65535 and kd % (2 * BOX) == 0
    for kind in ("dq", "dkv"):
        entry = SOURCE[SOURCE.index(
            f'extern "C" int paddle_flash_attention_bwd_{kind}_bf16'):]
        entry = entry[:entry.index("\n}\n")]
        assert "if (!slice_d(D)) return (int)cudaErrorInvalidValue;" in entry
        assert all(f"launch_{kind}_slice<{r}>" in entry
                   for r in ("true", "false"))
    assert not (CSRC / "flash_wide.cuh").exists()
    assert "wide" not in "".join(re.findall(r"#include \"(\w+\.cuh)\"",
                                            SOURCE))
    assert not any(hasattr(tfa.flash_backward, f"{k}_wide_launches")
                   for k in ("dq", "dkv"))


@pytest.mark.parametrize("D,padded", [(1000, 1024), (1200, 1280)])
def test_bf16_slice_route_pads_counts_and_slices_back(D, padded,
                                                      monkeypatch):
    """flash_forward and flash_backward on the CUDA route hand each bf16
    kernel the head dim padded to a multiple of 128, count one bf16
    launch of each, and give back the plain version's results on the
    zero-padded inputs, sliced back (sm_scale from the true D)."""
    rng = np.random.RandomState(D + 3)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 1, 40, D).astype(
        np.float32)).bfloat16() for _ in range(4))
    lens = torch.tensor([40, 0])
    sm = 1.0 / math.sqrt(D)
    qp, kp, vp, gp = (F.pad(t, (0, padded - D)) for t in (q, k, v, g))
    o_want, lse_want = tfa.flash_attention_reference(qp, kp, vp, lens, True,
                                                     sm)
    grads_want = tuple(t[..., :D] for t in (
        tfa.flash_attention_backward_reference(qp, kp, vp, o_want, lse_want,
                                               gp, lens, True, sm)))
    kernels = _PlainKernels(monkeypatch)
    o, lse = tfa.flash_forward(q, k, v, lens, True)
    grads = tfa.flash_backward(q, k, v, o, lse, g, lens, True)
    assert kernels.head_dims == [("fwd", padded), ("dq", padded),
                                 ("dkv", padded)]
    assert kernels.counts() == (1, 1, 1)
    torch.testing.assert_close(o, o_want[..., :D], atol=0, rtol=0)
    torch.testing.assert_close(lse, lse_want, atol=0, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads_want):
        assert a.dtype == torch.bfloat16 and a.shape == (2, 1, 40, D), name
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
