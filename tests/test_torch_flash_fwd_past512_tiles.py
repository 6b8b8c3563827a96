"""The flash forward past head dim 512, both dtypes, on the CPU.

On a CUDA tensor a head dim past 512 is zero-padded to a multiple of 128
(Dp), and the forward runs its slice instances on the tensor cores
(``flash_fwd_slice_bf16_kernel`` in ``csrc/flash_attention_bf16.cu``,
``flash_fwd_tf32x3_slice_kernel`` in ``csrc/flash_attention_fwd.cu``):
O is cut into slices of up to 512 columns (bf16; 640 in f32) on the
grid's z axis, and every block forms S over all of Dp, so every slice
holds the same S, row max, denominator and P, and slice 0 alone writes
lse.

- bf16: a block owns 64 q rows and walks 32-key K/V tiles; each of its two
  consumer warpgroups sums its S partial over its half of Dp's 64-column
  boxes in order (boxes NBH c .. NBH c + NBH - 1, NBH = Dp / 128), the two
  partials are exchanged and summed, P is rounded to bf16 against the
  running max, and each consumer adds P V for its half of the slice's V
  boxes; o is rounded once.
- f32: a block owns 32 q rows as two row tiles of 16 and walks 16-key
  tiles; each of the four parts of a row tile sums its S partial over
  its 32 columns of every 128 of Dp, in order (as four chains of
  8-column k-steps, summed in pairs), the partials are summed in part
  order, and each part adds each tile's P V, a fresh sum, to its 32
  columns of every 128 of the slice.

Here both tilings are emulated (the widths read from the sources) and
held against the JAX package's Pallas forward in interpret mode at D576
(padded to 640: bf16 slices of 512 and 128, one f32 slice) and D1024
(bf16 two slices of 512, f32 slices of 640 and 384),
causal and ragged with a fully masked row, inputs from a numpy seed: f32
at atol = rtol = 1e-5; bf16 at the gate the CUDA kernels are held to on
the card (``tests/test_torch_flash_bf16_d512_tiles.py``'s), against the
bf16 plain version and Pallas at the same tiles; a stale K/V stage and a
slice reading the wrong V box fail it. Every slice's lse and P are
bitwise equal. Then the route with the kernel entries swapped for their
plain versions (padding, counters), and the slice instances' shared
memory.
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
from test_torch_flash_bf16_d512_tiles import _klen, _padded as _flat, _visible
from test_torch_flash_bf16_tiles import _errors, _passes, _stale_stage, _torch
from test_torch_flash_bf16_wide_tiles import _PlainKernels as _Bf16Kernels
from test_torch_flash_f32_wide_tiles import _PlainKernels as _F32Kernels

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
CSRC = Path(tfa.__file__).resolve().parent / "csrc"
BF16_SOURCE = (CSRC / "flash_attention_bf16.cu").read_text()
F32_SOURCE = (CSRC / "flash_attention_fwd.cu").read_text()
SMEM_LIMIT = 232448  # bytes of shared memory a block may have
LOG2E = 1.4426950408889634


def _constant(text, name, namespace=None):
    """``constexpr int name = value;`` of a source (the first block of
    ``namespace`` where given)."""
    if namespace is not None:
        text = text[text.index(f"namespace {namespace} {{"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


BF16_ROWS = _constant(BF16_SOURCE, "SPLIT_OWN")
BF16_SLICE = _constant(BF16_SOURCE, "SLICE")
BF16_KEYS = _constant(BF16_SOURCE, "SLICE_KEYS")
BF16_STAGES = _constant(BF16_SOURCE, "SLICE_STAGES")
BF16_Q_MAX = _constant(BF16_SOURCE, "SLICE_Q_MAX")
NWARPS = _constant(F32_SOURCE, "NWARPS")
F32_ROWS = _constant(F32_SOURCE, "BQ", "qsplit")
F32_KEYS = _constant(F32_SOURCE, "BK", "qsplit")
F32_PARTS = NWARPS // (F32_ROWS // 16)
F32_SLICE = _constant(F32_SOURCE, "SLICE", "wsplit")
F32_STEP = _constant(F32_SOURCE, "CH", "wsplit")
F32_SLOTS = _constant(F32_SOURCE, "SLOTS", "wsplit")
F32_Q_MAX = _constant(F32_SOURCE, "SLICE_Q_MAX", "wsplit")

# f32: (B, H, T, causal, lengths); T = 80 leaves a ragged last q block, a
# length of 0 is a fully masked row, 37 ends inside a key tile
F32_CASES = {"causal": (2, 2, 80, True, None),
             "ragged": (3, 1, 80, False, [80, 37, 0])}
DIMS = [576, 1024]
# bf16: (B, H, T, D, causal, lengths); T = 150 leaves a ragged third
# 64-row block, 71 ends inside a key tile
BF16_CASES = {
    "causal_d576_fully_masked_row": (2, 1, 150, 576, True, [150, 0]),
    "ragged_d576": (2, 1, 150, 520, False, [150, 71]),
    "causal_d1024": (1, 2, 150, 1024, True, None),
    "ragged_d1024_fully_masked_row": (3, 1, 150, 1000, False, [150, 0, 71]),
}


def _slices(Dp, width):
    """(first column, width) of each slice of O on the grid's z axis."""
    return [(s0, min(width, Dp - s0)) for s0 in range(0, Dp, width)]


# -- f32: flash_fwd_tf32x3_slice_kernel -----------------------------------
def _f32_partial(a, b, part):
    """Part ``part``'s S partial: over each F32_STEP columns of Dp in
    order, the products over its F32_STEP / F32_PARTS columns of them,
    as four chains (one an 8-column k-step) summed in pairs after."""
    w = F32_STEP // F32_PARTS
    chains = []
    for kk in range(4):
        out = None
        for c0 in range(part * w + kk * w // 4, a.shape[-1], F32_STEP):
            c = slice(c0, c0 + w // 4)
            prod = a[..., c] @ b[..., c].transpose(1, 2)
            out = prod if out is None else out + prod
        chains.append(out)
    return (chains[0] + chains[1]) + (chains[2] + chains[3])


def _f32_slice_forward(q, k, v, lens, causal, sm):
    """(o, lse, each slice's lse) as the f32 slice forward computes them:
    per slice of O, per 32-row q block, per 16-key tile up to the causal
    bound, S as the four parts' partials summed in part order, the
    online softmax, each tile's P V a fresh sum added to O."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    q3, k3, v3 = (_flat(x, Dp) for x in (q, k, v))
    klen = _klen(lens, B, H, T)
    o = torch.zeros(B * H, T, Dp)
    slice_lse = []
    for s0, width in _slices(Dp, F32_SLICE):
        lse = torch.empty(B * H, T)
        for q0 in range(0, T, F32_ROWS):
            rows = torch.arange(q0, min(q0 + F32_ROWS, T))
            m = torch.full((B * H, rows.numel()), -math.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros(B * H, rows.numel(), width)
            kend = min(q0 + F32_ROWS, T) if causal else T
            for k0 in range(0, kend, F32_KEYS):
                keys = torch.arange(k0, min(k0 + F32_KEYS, T))
                s = _f32_partial(q3[:, rows], k3[:, keys], 0)
                for part in range(1, F32_PARTS):
                    s = s + _f32_partial(q3[:, rows], k3[:, keys], part)
                s = (s * sm).masked_fill(~_visible(rows, keys, klen, causal),
                                         -math.inf)
                mnew = torch.maximum(m, s.amax(-1))
                m_safe = torch.where(torch.isfinite(mnew), mnew, 0.0)
                alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                    0.0)
                p = torch.exp(s - m_safe[..., None])
                l = l * alpha + p.sum(-1)
                m = mnew
                acc = acc * alpha[..., None] + p @ v3[:, keys,
                                                      s0:s0 + width]
            o[:, rows, s0:s0 + width] = acc / l.clamp(min=1e-30)[..., None]
            lse[:, rows] = torch.where(
                l > 0, m + torch.log(l.clamp(min=1e-30)), math.inf)
        slice_lse.append(lse)
    return (o[..., :D].reshape(B, H, T, D), slice_lse[0].reshape(B, H, T),
            slice_lse)


def _pallas_forward(q, k, v, lens, causal, sm):
    """(o, lse) of the Pallas forward in interpret mode (f32)."""
    B, H, T, D = q.shape
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    o, lse = jfa._flash_forward(*(jnp.asarray(a) for a in (q, k, v)), jlens,
                                causal, sm, block_q=16, block_k=8,
                                interpret=True)
    return np.array(o).reshape(B, H, T, D), np.array(lse).reshape(B, H, T)


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_f32_slice_forward_matches_pallas_forward_interpret(case, D):
    B, H, T, causal, lens = F32_CASES[case]
    rng = np.random.RandomState(D)
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    sm = 1.0 / math.sqrt(D)  # the true head dim's scale
    want_o, want_lse = _pallas_forward(q, k, v, lens, causal, sm)
    o, lse, slice_lse = _f32_slice_forward(
        *(torch.from_numpy(a) for a in (q, k, v)), lens, causal, sm)
    Dp = tfa._kernel_head_dim(D)
    assert len(slice_lse) == -(-Dp // F32_SLICE)
    assert all(torch.equal(x, slice_lse[0]) for x in slice_lse)
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    fin = np.isfinite(want_lse)
    assert np.array_equal(np.isfinite(lse.numpy()), fin)
    np.testing.assert_allclose(lse.numpy()[fin], want_lse[fin], **TOL)
    if lens is not None:
        masked = [b for b, n in enumerate(lens) if n == 0]
        assert masked and not o[masked].any()


# -- bf16: flash_fwd_slice_bf16_kernel ------------------------------------
def _bf16_partial(a, b, consumer, nbh):
    """Consumer ``consumer``'s S partial: the products over its boxes of
    Dp, box NBH c + j for j = 0 .. NBH - 1, summed in order."""
    out = None
    for j in range(nbh):
        c0 = 64 * (consumer * nbh + j)
        prod = a[..., c0:c0 + 64] @ b[..., c0:c0 + 64].transpose(1, 2)
        out = prod if out is None else out + prod
    return out


def _bf16_slice_forward(q, k, v, lens, causal, sm, fault=None):
    """(o [B, H, T, D] bf16, lse, each slice's lse, each slice's P) as the
    bf16 slice forward computes them: per slice of O, per 64-row q block,
    per 32-key tile up to the causal bound, S = the two consumers'
    partials summed, the online softmax in base 2 (P = 2^(s c - m c), c =
    sm_scale log2 e), P rounded to bf16 before P V over each consumer's
    boxes of the slice's V, o rounded once. ``fault="v_box"`` has the
    second consumer read the V box after its own (a slice off by one
    box)."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    q3, k3, v3 = (_flat(x, Dp) for x in (q, k, v))
    klen = _klen(lens, B, H, T)
    c = sm * LOG2E
    nbh = Dp // 128
    o = torch.zeros(B * H, T, Dp)
    slice_lse, slice_p = [], []
    for s0, width in _slices(Dp, BF16_SLICE):
        hb = width // 128  # V boxes a consumer
        lse = torch.empty(B * H, T)
        ps = []
        for q0 in range(0, T, BF16_ROWS):
            rows = torch.arange(q0, min(q0 + BF16_ROWS, T))
            m = torch.full((B * H, rows.numel()), -math.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros(B * H, rows.numel(), width)
            kend = min(q0 + BF16_ROWS, T) if causal else T
            for k0 in range(0, kend, BF16_KEYS):
                cols = torch.arange(k0, min(k0 + BF16_KEYS, T))
                parts = [_bf16_partial(q3[:, rows], k3[:, cols], cw, nbh)
                         for cw in range(2)]
                s = parts[0] + parts[1]
                assert torch.equal(s, parts[1] + parts[0])  # both consumers
                s = s.masked_fill(~_visible(rows, cols, klen, causal),
                                  -math.inf)
                mnew = torch.maximum(m, s.amax(-1))
                msafe = torch.where(mnew == -math.inf, 0.0, mnew)
                alpha = torch.where(m == -math.inf, 0.0,
                                    torch.exp2((m - msafe) * c))
                p = torch.exp2(s * c - (msafe * c)[..., None])  # masked: 0
                l = l * alpha + p.sum(-1)
                m = mnew
                pb = p.bfloat16().float()
                ps.append(pb)
                acc = acc * alpha[..., None]
                for cw in range(2):
                    for kk in range(hb):
                        box = s0 // 64 + cw * hb + kk
                        if fault == "v_box" and cw:
                            box = min(box + 1, Dp // 64 - 1)
                        j = (cw * hb + kk) * 64
                        acc[..., j:j + 64] += pb @ v3[:, cols,
                                                      64 * box:64 * box + 64]
            inv = 1.0 / l.clamp(min=1e-30)
            o[:, rows, s0:s0 + width] = (acc * inv[..., None]).bfloat16() \
                .float()
            lse[:, rows] = torch.where(
                l > 0, m * sm + torch.log(l.clamp(min=1e-30)), math.inf)
        slice_lse.append(lse)
        slice_p.append(ps)
    return (o[..., :D].reshape(B, H, T, D).bfloat16(),
            slice_lse[0].reshape(B, H, T), slice_lse, slice_p)


def _pallas_at_slice_tiles(q, k, v, lengths, causal, sm):
    """o of the Pallas forward in interpret mode at the bf16 slice
    instance's tiles (64 q rows x 32 keys), T zero-padded to a multiple of
    both (padded keys masked by the lengths, padded rows sliced off), D
    zero-padded as the CUDA route pads it."""
    B, T, D = q.shape[0], q.shape[2], q.shape[3]
    pad = ((0, 0), (0, 0), (0, -T % math.lcm(BF16_ROWS, BF16_KEYS)),
           (0, tfa._kernel_head_dim(D) - D))
    qp, kp, vp = (jnp.pad(a, pad) for a in (q, k, v))
    lens = jnp.asarray(lengths if lengths is not None else [T] * B,
                       jnp.int32)
    o, _ = jfa._flash_forward(qp, kp, vp, lens, causal, sm, BF16_ROWS,
                              BF16_KEYS, interpret=True)
    return _torch(o[:, :, :T, :D])


def _bf16_case(case):
    B, H, T, D, causal, lengths = BF16_CASES[case]
    rng = np.random.RandomState(T + D)
    q, k, v = (jnp.asarray(rng.randn(B, H, T, D).astype(np.float32),
                           jnp.bfloat16) for _ in range(3))
    sm = 1.0 / math.sqrt(D)
    lens = None if lengths is None else torch.tensor(lengths)
    tq, tk, tv = (_torch(a) for a in (q, k, v))
    po, plse = tfa.flash_attention_reference(tq, tk, tv, lens, causal, sm)
    to, _ = tfa.flash_attention_reference(tq.float(), tk.float(), tv.float(),
                                          lens, causal, sm)
    return (q, k, v, lengths, causal, sm), (tq, tk, tv, lens), po, plse, to


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_slice_tiles_meet_the_card_gate(case):
    jax_in, (tq, tk, tv, lens), po, plse, to = _bf16_case(case)
    causal, sm = jax_in[4], jax_in[5]
    o, lse, slice_lse, slice_p = _bf16_slice_forward(tq, tk, tv, lens, causal,
                                                     sm)
    Dp = tfa._kernel_head_dim(tq.shape[-1])
    assert len(slice_lse) == -(-Dp // BF16_SLICE) == 2
    for other_lse, other_p in zip(slice_lse[1:], slice_p[1:]):
        assert torch.equal(other_lse, slice_lse[0])  # the same bits
        assert all(torch.equal(a, b) for a, b in zip(other_p, slice_p[0]))
    assert torch.equal(lse.isinf(), plse.isinf())
    fin = plse.isfinite()
    assert float((lse - plse)[fin].abs().max()) <= 1e-4  # BF16_LSE_ATOL
    pallas = _pallas_at_slice_tiles(*jax_in)
    assert o.dtype == torch.bfloat16
    for ref in (po, pallas):  # the plain version; Pallas at the same tiles
        e = _errors(o, ref, to)
        assert _passes(e), e
        assert e["fro_ratio"] < 1.05, e  # one rounding
    e = _errors(pallas, po, to)  # and Pallas at these tiles meets the gate
    assert _passes(e) and e["fro_ratio"] < 1.05, e
    lengths = jax_in[3]
    if lengths is not None:  # a fully masked row: o = 0
        masked = [b for b, n in enumerate(lengths) if n == 0]
        assert not o[masked].float().any()


@pytest.mark.parametrize("fault", ["stale_kv", "v_box"])
def test_bf16_planted_fault_fails_the_gate(fault):
    """A stale K/V stage (a tile reading the one before it) or a consumer
    reading the V box after its own moves o past the gate."""
    jax_in, (tq, tk, tv, lens), po, _, to = _bf16_case("causal_d1024")
    causal, sm = jax_in[4], jax_in[5]
    if fault == "stale_kv":
        tk, tv = _stale_stage(tk, BF16_KEYS), _stale_stage(tv, BF16_KEYS)
    o = _bf16_slice_forward(tq, tk, tv, lens, causal, sm,
                            fault=fault if fault == "v_box" else None)[0]
    assert not _passes(_errors(o, po, to)), fault


# -- the route and the shared memory --------------------------------------
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,padded", [(576, 640), (1024, 1024),
                                      (1100, 1152)])
def test_forward_past_512_pads_counts_and_slices_back(D, padded, dtype,
                                                      monkeypatch):
    """flash_forward and flash_backward on the CUDA route hand each kernel
    the head dim padded to a multiple of 128, count one launch of each on
    the dtype's counters (no wide launch is counted: every kernel of
    either dtype runs its slice instance there), and give back the plain
    version's results on the zero-padded inputs, sliced back."""
    rng = np.random.RandomState(D)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 2, 40, D).astype(
        np.float32)).to(dtype) for _ in range(4))
    lens = torch.tensor([40, 0])
    sm = 1.0 / math.sqrt(D)
    qp, kp, vp, gp = (F.pad(t, (0, padded - D)) for t in (q, k, v, g))
    o_want, lse_want = tfa.flash_attention_reference(qp, kp, vp, lens, True,
                                                     sm)
    grads_want = tuple(t[..., :D] for t in (
        tfa.flash_attention_backward_reference(qp, kp, vp, o_want, lse_want,
                                               gp, lens, True, sm)))
    kernels = (_F32Kernels if dtype == F32 else _Bf16Kernels)(monkeypatch)
    o, lse = tfa.flash_forward(q, k, v, lens, True)
    grads = tfa.flash_backward(q, k, v, o, lse, g, lens, True)
    assert kernels.head_dims == [("fwd", padded), ("dq", padded),
                                 ("dkv", padded)]
    assert kernels.counts() == (1, 1, 1)
    assert not any(hasattr(fn, f"{kind}wide_launches")
                   for fn, kind in ((tfa.flash_attention, ""),
                                    (tfa.flash_backward, "dq_"),
                                    (tfa.flash_backward, "dkv_")))
    torch.testing.assert_close(o, o_want[..., :D], atol=0, rtol=0)
    torch.testing.assert_close(lse, lse_want, atol=0, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads_want):
        assert a.dtype == dtype and a.shape == (2, 2, 40, D), name
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("D", [513, 576, 640, 1000, 1024, 1025, 2048, 4096])
def test_forward_never_runs_wide(D):
    """Past 512 the forward of either dtype runs its slice instance at D
    padded to a multiple of 128 (so do dq and dkv), no source of the
    flash libraries holds a wide instance, and the grid's y axis holds
    65535 blocks of 64 q rows (bf16; f32: pairs of 32-row blocks, the
    pair's halves and the slices on z)."""
    kd = -(-D // 128) * 128
    assert tfa._kernel_head_dim(D) == kd
    for name in ("flash_attention_fwd.cu", "flash_attention_bf16.cu"):
        assert "_wide_kernel" not in (CSRC / name).read_text()
    assert tfa._max_t(kd) == 65535 * BF16_ROWS == 65535 * 2 * F32_ROWS


def _bf16_ring_bytes(Dp):
    """``SliceRing``'s bytes, as the source lays them out: Q's Dp / 64
    boxes of 64 rows where Dp <= BF16_Q_MAX, the stages (two K or V boxes
    of BF16_KEYS rows, and with Q streamed two Q boxes), two exchange
    buffers of both consumers' f32 S partials, the barriers."""
    resident = Dp <= BF16_Q_MAX
    stage = 2 * BF16_KEYS * 128 + (0 if resident else 2 * BF16_ROWS * 128)
    q = Dp // 64 * BF16_ROWS * 128 if resident else 0
    exchange = 2 * 2 * BF16_ROWS * BF16_KEYS * 4
    return q + BF16_STAGES * stage + exchange + (1 + 2 * BF16_STAGES) * 8


def _f32_ring_bytes(Dp):
    """The f32 slice forward's ``Ring``: SLOTS steps (16 K or V rows of
    128 columns at stride 132, and with Q streamed Q's 32 rows), the
    exchange, and Q [32, Dp] at stride Dp + 4 where Dp <= F32_Q_MAX."""
    resident = Dp <= F32_Q_MAX
    cst = F32_STEP + 4
    slot = F32_KEYS * cst + (0 if resident else F32_ROWS * cst)
    exchange = NWARPS * (F32_KEYS // 8) * 4 * 32
    q = F32_ROWS * (Dp + 4) if resident else 0
    return (F32_SLOTS * slot + exchange + q) * 4


@pytest.mark.parametrize("Dp,bf16,f32", [
    (640, 180360, 158208), (1024, 229512, 207360), (1152, 229512, 210944),
    (4096, 229512, 210944)])
def test_slice_rings_fit_the_shared_memory(Dp, bf16, f32):
    """Each slice instance's shared memory at Dp, as its source lays it
    out: Q resident up to Dp 1024, streamed with K past it, so nothing
    grows past that; the largest of each is what its source states, under
    the 232,448 bytes a block may opt in to. The bf16 ring holds both
    consumers' output tiles (64 rows x 256 columns each) at the end."""
    assert (BF16_Q_MAX, F32_Q_MAX) == (1024, 1024)
    assert (_bf16_ring_bytes(Dp), _f32_ring_bytes(Dp)) == (bf16, f32)
    assert max(bf16, f32) <= SMEM_LIMIT
    assert f"{max(_bf16_ring_bytes(d) for d in (1024, 1152)):,}" in \
        BF16_SOURCE
    assert f"{_f32_ring_bytes(1024):,}" in F32_SOURCE
    assert f"{_f32_ring_bytes(1152):,}" in F32_SOURCE
    assert BF16_STAGES * 2 * BF16_KEYS * 128 >= 2 * BF16_ROWS * 256 * 2
