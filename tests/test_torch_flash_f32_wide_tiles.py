"""The f32 flash forward and dq at head dims 129-256, on the CPU.

On a CUDA tensor an f32 head dim in 129-192 is zero-padded to 192 and one
in 193-256 to 256, and the forward and dq run their 3xTF32 tensor-core
instances there (``flash_fwd_tf32x3_split_kernel`` in
``csrc/flash_attention_fwd.cu``, ``flash_bwd_dq_tf32x3_split_kernel`` in
``csrc/flash_attention_bwd.cu``): a block owns 64 q rows and walks
16-key K/V tiles up to the causal bound; each warpgroup owns half of D
of the output and forms S (and dP) for all 64 rows over its half of D,
the other half's partial products coming from its partner warps through
shared memory; each tile's P V (dS K) is summed fresh and added in f32.
Here that tiling is emulated (the tile sizes read from the sources) and
held against the JAX package's Pallas forward and backward in interpret
mode at D160, D192 and D256, causal and ragged with a fully masked row,
inputs from a numpy seed, f32, atol = rtol = 1e-5; both halves' row max,
denominator and lse must agree bitwise. dkv runs its own split instance
at 192 and 256 (``tests/test_torch_flash_f32_dkv_split_tiles.py``
emulates it); all three run their quarter instances at 384 and 512
(``tests/test_torch_flash_f32_d512_tiles.py``, and for dkv
``tests/test_torch_flash_f32_dkv_d512_tiles.py``); past 512 the forward
runs its slice instance (``tests/test_torch_flash_fwd_past512_tiles.py``)
and so do dq and dkv (``tests/test_torch_flash_f32_bwd_past512_tiles.py``).
Then the route: the head dim each f32 kernel takes, and the launch wiring
with the kernel entries swapped for their plain versions (padded D
handed over, outputs sliced back, the f32 launch counters).
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


def _constant(source, name):
    """``constexpr int name = value;`` of the ``dsplit`` namespace of a
    kernel source."""
    text = (CSRC / source).read_text()
    block = text[text.index("namespace dsplit {"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", block).group(1))


# q rows a block owns and keys a tile, of the forward and of dq
FWD_ROWS = _constant("flash_attention_fwd.cu", "BQ")
FWD_KEYS = _constant("flash_attention_fwd.cu", "BK")
DQ_ROWS = _constant("flash_attention_bwd.cu", "BOWN")
DQ_KEYS = _constant("flash_attention_bwd.cu", "BSTREAM")

# (B, H, T, causal, lengths): T = 80 leaves a ragged second q block; a
# length of 0 is a fully masked row, 37 ends inside a key tile
CASES = {"causal": (2, 2, 80, True, None),
         "ragged": (3, 1, 80, False, [80, 37, 0])}
DIMS = [160, 192, 256]


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


def _halves(a, b):
    """a [BH, m, Dp] . b [BH, n, Dp]^T as the sum of the two halves of D's
    products, each warpgroup's partial."""
    h = a.shape[-1] // 2
    return (a[..., :h] @ b[..., :h].transpose(1, 2)
            + a[..., h:] @ b[..., h:].transpose(1, 2))


def _n_keys(q0, rows, T, causal):
    """Keys a block's tiles reach: the causal bound of its last row."""
    return min(q0 + rows, T) if causal else T


def _forward_tiles(q, k, v, lens, causal, sm):
    """(o, lse, each half's lse) as the split forward computes them: per
    64-row q block, per 16-key tile up to the causal bound, S as the sum
    of the halves' partial products (formed alike for each half of O), an
    online softmax, each tile's P V a fresh sum added to the half's O."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    q3, k3, v3 = (_flat(x, Dp) for x in (q, k, v))
    klen = _klen(lens, B, H, T)
    o = torch.zeros(B * H, T, Dp)
    half_lse = []
    for half in (slice(0, Dp // 2), slice(Dp // 2, Dp)):  # the warpgroups
        lse = torch.empty(B * H, T)
        for q0 in range(0, T, FWD_ROWS):
            rows = torch.arange(q0, min(q0 + FWD_ROWS, T))
            m = torch.full((B * H, rows.numel()), -math.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros(B * H, rows.numel(), Dp // 2)
            for k0 in range(0, _n_keys(q0, FWD_ROWS, T, causal), FWD_KEYS):
                cols = torch.arange(k0, min(k0 + FWD_KEYS, T))
                s = _halves(q3[:, rows], k3[:, cols]) * sm
                s = s.masked_fill(~_visible(rows, cols, klen, causal),
                                  -math.inf)
                mnew = torch.maximum(m, s.amax(-1))
                m_safe = torch.where(torch.isfinite(mnew), mnew, 0.0)
                alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                    0.0)
                p = torch.exp(s - m_safe[..., None])
                l = l * alpha + p.sum(-1)
                m = mnew
                acc = acc * alpha[..., None] + p @ v3[:, cols, half]
            o[:, rows, half] = acc / l.clamp(min=1e-30)[..., None]
            lse[:, rows] = torch.where(
                l > 0, m + torch.log(l.clamp(min=1e-30)), math.inf)
        half_lse.append(lse)
    return (o[..., :D].reshape(B, H, T, D), half_lse[0].reshape(B, H, T),
            half_lse)


def _dq_tiles(q, k, v, lse, do, di, lens, causal, sm):
    """dq as the split dq kernel computes it: per 64-row q block and half
    of D, per 16-key tile up to the causal bound, S and dP as the sums of
    the halves' partial products, P from lse, dS = P (dP - Di), each
    tile's dS K a fresh sum added to the half's dq; scaled once at the
    end."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    q3, k3, v3, do3 = (_flat(x, Dp) for x in (q, k, v, do))
    lse3 = torch.from_numpy(lse).reshape(B * H, T)
    di3 = di.reshape(B * H, T)
    klen = _klen(lens, B, H, T)
    dq = torch.zeros(B * H, T, Dp)
    for half in (slice(0, Dp // 2), slice(Dp // 2, Dp)):
        for q0 in range(0, T, DQ_ROWS):
            rows = torch.arange(q0, min(q0 + DQ_ROWS, T))
            acc = torch.zeros(B * H, rows.numel(), Dp // 2)
            for k0 in range(0, _n_keys(q0, DQ_ROWS, T, causal), DQ_KEYS):
                cols = torch.arange(k0, min(k0 + DQ_KEYS, T))
                s = _halves(q3[:, rows], k3[:, cols])
                dp = _halves(do3[:, rows], v3[:, cols])
                p = torch.where(_visible(rows, cols, klen, causal),
                                torch.exp(s * sm - lse3[:, rows, None]), 0.0)
                ds = p * (dp - di3[:, rows, None])
                acc = acc + ds @ k3[:, cols, half]
            dq[:, rows, half] = acc * sm
    return dq[..., :D].reshape(B, H, T, D)


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_forward_matches_pallas_forward_interpret(case, D):
    B, H, T, causal, lens = CASES[case]
    q, k, v, g = _inputs(B, H, T, D, seed=D)
    sm = 1.0 / math.sqrt(D)  # the true head dim's scale
    want_o, want_lse, _ = _pallas(q, k, v, g, lens, causal, sm)
    o, lse, half_lse = _forward_tiles(q, k, v, lens, causal, sm)
    assert torch.equal(half_lse[0], half_lse[1])
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    fin = np.isfinite(want_lse)
    assert np.array_equal(np.isfinite(lse.numpy()), fin)
    np.testing.assert_allclose(lse.numpy()[fin], want_lse[fin], **TOL)
    if lens is not None:
        masked = [b for b, n in enumerate(lens) if n == 0]
        assert masked and not o[masked].any()


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_dq_matches_pallas_backward_interpret(case, D):
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


def test_split_tiles_fit_the_grid_and_the_emulation():
    """The emulation's tiles are the sources' (64 q rows, 16 keys), and
    the grid's y axis holds 65535 blocks of them."""
    assert (FWD_ROWS, FWD_KEYS, DQ_ROWS, DQ_KEYS) == (64, 16, 64, 16)
    for D in (192, 256):
        assert tfa._max_t(D) == 65535 * FWD_ROWS


F32 = torch.float32


_INSTANCE_CASES = [
    (129, "fwd", 192), (160, "dq", 192), (192, "fwd", 192), (193, "dq", 256),
    (256, "fwd", 256), (256, "dq", 256), (160, "dkv", 192), (256, "dkv", 256),
    (257, "fwd", 384), (320, "dq", 384), (128, "dkv", 128), (512, "fwd", 512),
    (448, "dq", 512), (320, "dkv", 384), (512, "dkv", 512), (576, "fwd", 640),
    (576, "dq", 640), (576, "dkv", 640),
]


# the ids the cases were written with, when each instance was a (head dim,
# wide) pair
@pytest.mark.parametrize("D,kind,instance", _INSTANCE_CASES, ids=[
    f"{d}-{kind}-instance{i}"
    for i, (d, kind, _) in enumerate(_INSTANCE_CASES)])
def test_f32_kernel_instance(D, kind, instance):
    """f32's forward, dq and dkv take the tensor-core instances at a
    padded 192 and 256, and past 256 (a head dim in 257-512 padded to 384
    or 512, as in bf16) their quarter instances on the tensor cores; past
    512 (padded to a multiple of 128) their slice instances on the tensor
    cores."""
    assert tfa._kernel_head_dim(D) == instance


class _PlainKernels:
    """The kernel entries swapped for their plain versions on the CPU:
    the head dims the CUDA route hands each kernel are recorded, and the
    f32 launch counters start at 0 (and go back after)."""

    def __init__(self, monkeypatch):
        self.head_dims = []
        monkeypatch.setattr(tfa, "_launch_fwd", self.forward)
        monkeypatch.setattr(tfa, "_launch_bwd", self.backward)
        monkeypatch.setattr(tfa, "_plain_device", lambda t: False)
        for fn, names in ((tfa.flash_attention, ("launches",)),
                          (tfa.flash_backward, (
                              "dq_launches", "dkv_launches"))):
            for name in names:
                monkeypatch.setattr(fn, name, 0)

    def forward(self, q, k, v, lengths, causal, sm_scale):
        self.head_dims.append(("fwd", q.shape[-1]))
        return tfa.flash_attention_reference(q, k, v, lengths, causal,
                                             sm_scale)

    def backward(self, kind, outs, q, k, v, lse, di, do, lengths, causal,
                 sm_scale):
        self.head_dims.append((kind, q.shape[-1]))
        if kind == "dq":
            got = (tfa.flash_dq_reference(q, k, v, lse, di, do, lengths,
                                          causal, sm_scale),)
        else:
            got = tfa.flash_dkv_reference(q, k, v, lse, di, do, lengths,
                                          causal, sm_scale)
        for out, t in zip(outs, got):
            out.copy_(t)

    @staticmethod
    def counts():
        return (tfa.flash_attention.launches,
                tfa.flash_backward.dq_launches,
                tfa.flash_backward.dkv_launches)


# the cases keep the ids they were written with, when a third value
# counted the wide launches, D320 padded to 320 and D576 ran the wide dq
# and dkv
@pytest.mark.parametrize("D,padded", [
    pytest.param(160, 192, id="160-192-wide0"),
    pytest.param(256, 256, id="256-256-wide1"),
    pytest.param(320, 384, id="320-320-wide2"),
    pytest.param(512, 512, id="512-512-wide3"),
    pytest.param(576, 640, id="576-576-wide4")])
def test_f32_route_pads_counts_and_slices_back(D, padded, monkeypatch):
    """flash_forward and flash_backward on the CUDA route hand each f32
    kernel the head dim padded to its instance, count one launch of each
    (past 512 dq and dkv run their slice instances), and give back the
    unpadded plain version's results (sm_scale from the true D)."""
    rng = np.random.RandomState(D)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 2, 40, D).astype(np.float32))
                  for _ in range(4))
    lens = torch.tensor([40, 0])
    o_want, lse_want = tfa.flash_attention_reference(q, k, v, lens, True)
    grads_want = tfa.flash_attention_backward_reference(
        q, k, v, o_want, lse_want, g, lens, True)
    kernels = _PlainKernels(monkeypatch)
    o, lse = tfa.flash_forward(q, k, v, lens, True)
    grads = tfa.flash_backward(q, k, v, o, lse, g, lens, True)
    assert kernels.head_dims == [("fwd", padded), ("dq", padded),
                                 ("dkv", padded)]
    assert kernels.counts() == (1, 1, 1)
    torch.testing.assert_close(o, o_want, **TOL)
    torch.testing.assert_close(lse, lse_want, **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads_want):
        assert a.dtype == F32 and a.shape == (2, 2, 40, D), name
        torch.testing.assert_close(a, b, msg=name, **TOL)
