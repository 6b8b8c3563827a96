"""The bf16 flash forward and dq past head dim 256, on the CPU.

On a CUDA tensor a bf16 head dim in 257-384 is zero-padded to 384 and one
in 385-512 to 512, and the forward and dq run their split ``wgmma``
instances there (``fwd_split``, ``dq_split`` in
``csrc/flash_attention_bf16.cu``): a block owns 64 q rows, shared by both
consumer warpgroups, and each consumer owns half of D of the output. Each
forms S (and, in dq, dP) over its half of D only, the two f32 partials
are exchanged through shared memory and summed (both consumers hold the
same sum: f32 addition commutes), and each adds P V (dS K) for its half.
The forward walks 32-key K/V tiles, rounding P to bf16 against the
running max of the tiles seen so far; dq walks 16-key tiles, rounding dS.

Here that decomposition is emulated (the tile widths and rows read from
the source) and held, at D384 and D512, causal and ragged with a fully
masked row, inputs from a numpy seed, to the gate the CUDA kernels are
held to on the card (``chip_smoke.py``'s bf16 gate, the copy in
``tests/test_torch_flash_bf16_tiles.py``, the tolerances of
``tests/test_torch_flash_bf16_wide_tiles.py``): against the bf16 plain
version and against the JAX package's Pallas forward and backward in
interpret mode at the same tiles (64 q rows x 32 or 16 keys), each
output at most 2x as far from the f32 truth plus one bf16 ulp of max
|truth|, its error's Frobenius norm within 1.05x. Two planted faults
fail that gate: a stale K/V stage, and a stale exchange (the other
half's partial of the tile before). Then the route: the instance each
kernel takes past 256, the
launch wiring with the kernel entries swapped for their plain versions,
and the shared memory of the split instances (past 512 the slice
instances: ``tests/test_torch_flash_bf16_bwd_past512_tiles.py``).
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
from test_torch_flash_bf16_tiles import _errors, _passes, _stale_stage, _torch
from test_torch_flash_bf16_wide_tiles import _PlainKernels

torch.set_num_threads(1)
SOURCE = (Path(tfa.__file__).resolve().parent / "csrc" /
          "flash_attention_bf16.cu").read_text()


def _split_ring(name):
    """(keys, stages at 384, stages at 512, owned tiles, partials) of a
    ``SplitRing`` alias of the source (``FwdSplit``, ``DqSplit``)."""
    found = re.search(rf"using {name} = SplitRing<D, (\d+), (\w+)\(D\), "
                      rf"(\d+), (\d+)>;", SOURCE)
    stages = re.search(rf"constexpr int {found.group(2)}\(int D\) {{ "
                       r"return D <= 384 \? (\d+) : (\d+); }", SOURCE)
    return (int(found.group(1)), int(stages.group(1)), int(stages.group(2)),
            int(found.group(3)), int(found.group(4)))


ROWS = int(re.search(r"constexpr int SPLIT_OWN = (\d+);", SOURCE).group(1))
FWD = _split_ring("FwdSplit")
DQ = _split_ring("DqSplit")
FWD_KEYS, DQ_KEYS = FWD[0], DQ[0]
LOG2E = 1.4426950408889634
SMEM_LIMIT = 232448

# (B, H, T, D, causal, lengths); a length of 0 is a fully masked row, 171
# ends inside a key tile; T = 150 leaves a ragged third 64-row block
CASES = {
    "causal_d384_fully_masked_row": (2, 1, 150, 384, True, [150, 0]),
    "ragged_d384": (3, 1, 150, 300, False, [150, 71, 0]),
    "causal_d512": (1, 2, 150, 512, True, None),
    "ragged_d512_fully_masked_row": (3, 1, 150, 448, False, [150, 0, 71]),
}


def _padded(x, Dp):
    """[B, H, T, D] bf16 -> [BH, T, Dp] f32 (the bf16 values, exact)."""
    B, H, T, D = x.shape
    return F.pad(x.float(), (0, Dp - D)).reshape(B * H, T, Dp)


def _visible(rows, cols, klen, causal):
    ok = cols[None, None, :] < klen[:, None, None]
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None])[None]
    return ok


def _klen(lens, B, H, T):
    lens = torch.full((B,), T) if lens is None else torch.as_tensor(lens)
    return lens.clamp(0, T).repeat_interleave(H)


def _halves(a, b, half):
    """The two consumers' f32 partials of a b^T, each over its half of D."""
    return (a[..., :half] @ b[..., :half].transpose(1, 2),
            a[..., half:] @ b[..., half:].transpose(1, 2))


def _exchanged(parts, prev, fault):
    """S (or dP) as both consumers hold it after the exchange: their own
    partial plus the other's; ``fault="exchange"`` adds the other's
    partial of the tile before instead (a stale exchange buffer)."""
    s0, s1 = parts
    if fault == "exchange" and prev is not None and prev.shape == s1.shape:
        s1 = prev
    first, second = s0 + s1, s1 + s0  # consumer 0's sum, consumer 1's
    assert torch.equal(first, second)
    return first, parts[1]


def _split_forward(q, k, v, lens, causal, sm, fault=None):
    """(o [B, H, T, D] bf16, lse [B, H, T]) as fwd_split computes them:
    64 q rows a block, FWD_KEYS-key tiles to the causal bound, S from two
    half-D partials, the online softmax in base 2 (P = 2^(s c - m c),
    c = sm_scale log2 e), P rounded to bf16 before P V, o = acc / max(l,
    1e-30) rounded once."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    q3, k3, v3 = (_padded(x, Dp) for x in (q, k, v))
    klen = _klen(lens, B, H, T)
    c = sm * LOG2E
    o = torch.zeros(B * H, T, Dp)
    lse = torch.empty(B * H, T)
    for q0 in range(0, T, ROWS):
        rows = torch.arange(q0, min(q0 + ROWS, T))
        m = torch.full((B * H, rows.numel()), -math.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(B * H, rows.numel(), Dp)
        kend = min(T, q0 + ROWS) if causal else T
        prev = None
        for k0 in range(0, kend, FWD_KEYS):
            cols = torch.arange(k0, min(k0 + FWD_KEYS, T))
            s, prev = _exchanged(_halves(q3[:, rows], k3[:, cols], Dp // 2),
                                 prev, fault)
            s = s.masked_fill(~_visible(rows, cols, klen, causal), -math.inf)
            mnew = torch.maximum(m, s.amax(-1))
            msafe = torch.where(mnew == -math.inf, 0.0, mnew)
            alpha = torch.where(m == -math.inf, 0.0,
                                torch.exp2((m - msafe) * c))
            p = torch.exp2(s * c - (msafe * c)[..., None])  # masked: 0
            l = l * alpha + p.sum(-1)
            m = mnew
            acc = (acc * alpha[..., None]
                   + p.bfloat16().float() @ v3[:, cols])
        inv = 1.0 / l.clamp(min=1e-30)
        o[:, rows] = (acc * inv[..., None]).bfloat16().float()
        lse[:, rows] = torch.where(
            l > 0, m * sm + torch.log(l.clamp(min=1e-30)), math.inf)
    return (o[..., :D].reshape(B, H, T, D).bfloat16(),
            lse.reshape(B, H, T))


def _split_dq(q, k, v, lse, di, do, lens, causal, sm, fault=None):
    """dq [B, H, T, D] bf16 as dq_split computes it: 64 q rows a block,
    DQ_KEYS-key tiles to the causal bound, S and dP from two half-D
    partials, P = 2^(s c - lse log2 e) (0 where masked), dS = P (dP - Di)
    rounded to bf16 before dS K, dq = sm_scale acc rounded once."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    q3, k3, v3, do3 = (_padded(x, Dp) for x in (q, k, v, do))
    lse3, di3 = lse.reshape(B * H, T), di.reshape(B * H, T)
    klen = _klen(lens, B, H, T)
    c = sm * LOG2E
    dq = torch.zeros(B * H, T, Dp)
    for q0 in range(0, T, ROWS):
        rows = torch.arange(q0, min(q0 + ROWS, T))
        acc = torch.zeros(B * H, rows.numel(), Dp)
        kend = min(T, q0 + ROWS) if causal else T
        prev_s = prev_dp = None
        for k0 in range(0, kend, DQ_KEYS):
            cols = torch.arange(k0, min(k0 + DQ_KEYS, T))
            s, prev_s = _exchanged(_halves(q3[:, rows], k3[:, cols],
                                           Dp // 2), prev_s, fault)
            dp, prev_dp = _exchanged(_halves(do3[:, rows], v3[:, cols],
                                             Dp // 2), prev_dp, fault)
            p = torch.exp2(s * c - (lse3[:, rows] * LOG2E)[..., None])
            p = torch.where(_visible(rows, cols, klen, causal), p, 0.0)
            ds = p * (dp - di3[:, rows, None])
            acc = acc + ds.bfloat16().float() @ k3[:, cols]
        dq[:, rows] = (acc * sm).bfloat16().float()
    return dq[..., :D].reshape(B, H, T, D).bfloat16()


def _pallas_at_split_tiles(q, k, v, g, lengths, causal, sm):
    """(o, dq) of the Pallas kernels in interpret mode at the split
    instances' tiles: the forward at ROWS q rows x FWD_KEYS keys, dq at
    ROWS x DQ_KEYS, T zero-padded to a multiple of both (padded keys
    masked by the lengths, padded q rows sliced off), D zero-padded as
    the CUDA route pads it."""
    B, T, D = q.shape[0], q.shape[2], q.shape[3]
    step = math.lcm(ROWS, FWD_KEYS, DQ_KEYS)
    pad = ((0, 0), (0, 0), (0, -T % step),
           (0, tfa._kernel_head_dim(D) - D))
    qp, kp, vp, gp = (jnp.pad(a, pad) for a in (q, k, v, g))
    lens = jnp.asarray(lengths if lengths is not None else [T] * B,
                       jnp.int32)
    o, lse = jfa._flash_forward(qp, kp, vp, lens, causal, sm, ROWS,
                                FWD_KEYS, interpret=True)
    dq, _, _ = jfa._flash_backward(qp, kp, vp, o, lse, lens, gp, causal, sm,
                                   ROWS, DQ_KEYS, interpret=True)
    return _torch(o[:, :, :T, :D]), _torch(dq[:, :, :T, :D])


def _case(case):
    B, H, T, D, causal, lengths = CASES[case]
    rng = np.random.RandomState(T + D)
    q, k, v, g = (jnp.asarray(rng.randn(B, H, T, D).astype(np.float32),
                              jnp.bfloat16) for _ in range(4))
    sm = 1.0 / math.sqrt(D)
    lens = None if lengths is None else torch.tensor(lengths)
    tq, tk, tv, tg = (_torch(a) for a in (q, k, v, g))
    po, plse = tfa.flash_attention_reference(tq, tk, tv, lens, causal, sm)
    di = tfa._row_dot(tg, po)
    plain = (po, tfa.flash_dq_reference(tq, tk, tv, plse, di, tg, lens,
                                        causal, sm))
    f32 = [t.float() for t in (tq, tk, tv, tg)]
    to, _ = tfa.flash_attention_reference(*f32[:3], lens, causal, sm)
    truth = (to, tfa.flash_dq_reference(*f32[:3], plse, di, f32[3], lens,
                                        causal, sm))
    return (q, k, v, g, lengths, causal, sm), (tq, tk, tv, tg, lens, plse,
                                               di), plain, truth


def _emulated(t, causal, sm, fault=None, stale=False):
    """(o, dq) of the emulation, its K/V stale at its own tiles if
    ``stale``."""
    tq, tk, tv, tg, lens, plse, di = t
    fk, fv = ((_stale_stage(tk, FWD_KEYS), _stale_stage(tv, FWD_KEYS))
              if stale else (tk, tv))
    qk, qv = ((_stale_stage(tk, DQ_KEYS), _stale_stage(tv, DQ_KEYS))
              if stale else (tk, tv))
    o, lse = _split_forward(tq, fk, fv, lens, causal, sm, fault)
    dq = _split_dq(tq, qk, qv, plse, di, tg, lens, causal, sm, fault)
    return (o, dq), lse


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_tiles_meet_the_card_gate(case):
    jax_in, t, plain, truth = _case(case)
    (o, dq), lse = _emulated(t, jax_in[5], jax_in[6])
    plse = t[5]
    assert torch.equal(lse.isinf(), plse.isinf())
    fin = plse.isfinite()
    assert float((lse - plse)[fin].abs().max()) <= 1e-4  # BF16_LSE_ATOL
    pallas = _pallas_at_split_tiles(*jax_in)
    for name, a, b, p, tr in zip(("o", "dq"), (o, dq), plain, pallas,
                                 truth):
        assert a.dtype == torch.bfloat16, name
        for ref in (b, p):  # the plain version; Pallas at the same tiles
            e = _errors(a, ref, tr)
            assert _passes(e), (name, e)
            assert e["fro_ratio"] < 1.05, (name, e)  # one rounding
        e = _errors(p, b, tr)  # and Pallas at these tiles meets the gate
        assert _passes(e) and e["fro_ratio"] < 1.05, (name, e)
    lengths = jax_in[4]
    if lengths is not None:  # a fully masked row: o = 0, dq = 0
        masked = [b for b, n in enumerate(lengths) if n == 0]
        assert masked and not o[masked].float().any()
        assert not dq[masked].float().any()


@pytest.mark.parametrize("fault", ["stale_kv", "exchange"])
@pytest.mark.parametrize("case", ["causal_d512",
                                  "ragged_d384"])
def test_planted_fault_fails_the_gate(case, fault):
    """A stale K/V stage (a tile reading the one before it) or a stale
    exchange (the other half's partial of the tile before) moves o and dq
    past the gate."""
    jax_in, t, plain, truth = _case(case)
    (o, dq), _ = _emulated(t, jax_in[5], jax_in[6],
                           fault=fault if fault == "exchange" else None,
                           stale=fault == "stale_kv")
    for name, a, b, tr in zip(("o", "dq"), (o, dq), plain, truth):
        assert not _passes(_errors(a, b, tr)), (fault, name)


BF16, F32 = torch.bfloat16, torch.float32


_INSTANCE_CASES = [
    (257, BF16, "fwd", 384), (300, BF16, "dq", 384), (384, BF16, "fwd", 384),
    (384, BF16, "dq", 384), (385, BF16, "fwd", 512), (448, BF16, "dq", 512),
    (512, BF16, "fwd", 512), (512, BF16, "dq", 512), (384, BF16, "dkv", 384),
    (512, BF16, "dkv", 512), (513, BF16, "fwd", 640), (576, BF16, "dq", 640),
    (384, F32, "fwd", 384), (512, F32, "dq", 512), (320, F32, "dkv", 384),
    (640, F32, "fwd", 640),
]


# the ids the cases were written with, when each instance was a (head dim,
# wide) pair
@pytest.mark.parametrize("D,dtype,kind,instance", _INSTANCE_CASES, ids=[
    f"{d}-dtype{i}-{kind}-instance{i}"
    for i, (d, _, kind, _) in enumerate(_INSTANCE_CASES)])
def test_split_instance_by_head_dim(D, dtype, kind, instance):
    """Every bf16 kernel runs wgmma at a padded 384 and 512; the f32
    forward, dq and dkv take their quarter instances on the tensor cores
    there (the same padded head dim); past 512, padded to a multiple of
    128, all three run their slice instances. The grid's y axis holds
    65535 blocks of 64 q rows."""
    assert tfa._kernel_head_dim(D) == instance
    assert tfa._max_t(instance) == 65535 * ROWS


# the cases keep the ids they were written with, when a third value
# counted the wide launches and D576 ran the wide dq and dkv
@pytest.mark.parametrize("D,padded", [
    pytest.param(300, 384, id="300-384-wide0"),
    pytest.param(384, 384, id="384-384-wide1"),
    pytest.param(448, 512, id="448-512-wide2"),
    pytest.param(512, 512, id="512-512-wide3"),
    pytest.param(576, 640, id="576-576-wide4")])
def test_bf16_split_route_pads_counts_and_slices_back(D, padded,
                                                      monkeypatch):
    """flash_forward and flash_backward on the CUDA route hand each kernel
    the bf16 head dim padded to 384 or 512 (a multiple of 128 past 512),
    count one bf16 launch of each, and give back the plain version's
    results on the zero-padded inputs, sliced back (sm_scale from the true
    D; the zero columns change S's f32 sums only in their order)."""
    rng = np.random.RandomState(D + 2)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 2, 40, D).astype(
        np.float32)).bfloat16() for _ in range(4))
    lens = torch.tensor([40, 0])
    sm = 1.0 / math.sqrt(D)
    qp, kp, vp, gp = (F.pad(t, (0, padded - D)) for t in (q, k, v, g))
    o_want, lse_want = tfa.flash_attention_reference(qp, kp, vp, lens, True,
                                                     sm)
    grads_want = tuple(t[..., :D] for t in (
        tfa.flash_attention_backward_reference(qp, kp, vp, o_want, lse_want,
                                               gp, lens, True, sm)))
    o_want = o_want[..., :D]
    kernels = _PlainKernels(monkeypatch)
    o, lse = tfa.flash_forward(q, k, v, lens, True)
    grads = tfa.flash_backward(q, k, v, o, lse, g, lens, True)
    assert kernels.head_dims == [("fwd", padded), ("dq", padded),
                                 ("dkv", padded)]
    assert kernels.counts() == (1, 1, 1)
    torch.testing.assert_close(o, o_want, atol=0, rtol=0)
    torch.testing.assert_close(lse, lse_want, atol=0, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads_want):
        assert a.dtype == BF16 and a.shape == (2, 2, 40, D), name
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("ring,D,want", [
    (FWD, 384, 229432), (FWD, 512, 229416),
    (DQ, 384, 229448), (DQ, 512, 229416)])
def test_split_rings_fit_the_shared_memory(ring, D, want):
    """``SplitRing``'s bytes, as the source lays them out: the owned
    tiles (64 rows each), the K/V stages, two exchange buffers of both
    consumers' f32 partials, the barriers; what the source's header
    states, under the 232,448 bytes a block may opt in to."""
    keys, stages384, stages512, owned, parts = ring
    stages = stages384 if D <= 384 else stages512
    nb = D // 64
    owned_bytes = owned * nb * ROWS * 128
    ring_bytes = stages * 2 * nb * keys * 128
    exchange = 2 * 2 * parts * ROWS * keys * 4
    smem = owned_bytes + ring_bytes + exchange + (1 + 2 * stages) * 8
    assert smem == want <= SMEM_LIMIT
    assert f"{want:,}" in SOURCE
