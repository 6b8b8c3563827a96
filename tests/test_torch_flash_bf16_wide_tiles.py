"""The bf16 flash forward and dq past head dim 128, on the CPU.

On a CUDA tensor a bf16 head dim in 129-192 is zero-padded to 192 and
one in 193-256 to 256, and the forward and dq run their ``wgmma``
instances there (``csrc/flash_attention_bf16.cu``): 128 q rows a block,
K/V tiles narrowed so that Q (and dO), two or three ring stages and a
consumer's accumulator as wide as D fit (``fwd_keys``/``dq_keys``: the
forward 64 keys, dq 48, at D192 and D256). Where a tile ends
changes how P is rounded (the forward rounds it against the running max
of the tiles seen so far) and the order of the f32 sums. The Pallas
kernels in interpret mode at those tiles meet the gate the CUDA kernels
are held to on the card (``chip_smoke.py``'s bf16 gate, the copy in
``tests/test_torch_flash_bf16_tiles.py``), at D160, D192 and D256,
causal and ragged with a fully masked row, inputs from a numpy seed; a
stale K/V stage planted at those tiles fails it. dkv runs its own
``wgmma`` instances at 192 and 256 (64 owned keys a block; its tiles are
checked in ``tests/test_torch_flash_bf16_dkv_wide_tiles.py``). Past 256
the forward and dq run their ``wgmma`` instances at 384 and 512
(``tests/test_torch_flash_bf16_d512_tiles.py``), and dkv its own there
(``tests/test_torch_flash_bf16_dkv_d512_tiles.py``); past 512 the forward
runs its slice instance (``tests/test_torch_flash_fwd_past512_tiles.py``)
and dq and dkv theirs (``tests/test_torch_flash_bf16_bwd_past512_tiles.py``
emulates them). Then the route
itself: which head dim each kernel takes by dtype, the
launch wiring with the kernel entries swapped for their plain versions
(padded D handed over, outputs sliced back, the launch counters), and
the input checks on meta tensors.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa
from test_torch_flash_bf16_tiles import _errors, _passes, _stale_stage, _torch

torch.set_num_threads(1)
BLOCK_Q = 128  # q rows a block owns, the forward's and dq's
# the key tiles of the wgmma instances by padded head dim: (forward, dq)
# (csrc/flash_attention_bf16.cu fwd_keys, dq_keys)
KEY_TILES = {192: (64, 48), 256: (64, 48)}

# (B, H, T, D, causal, lengths); a length of 0 is a fully masked row
CASES = {
    "causal_d160": (1, 2, 300, 160, True, None),
    "ragged_d160": (2, 1, 300, 160, False, [300, 0]),
    "causal_d192_fully_masked_row": (2, 1, 300, 192, True, [300, 0]),
    "ragged_d192": (3, 1, 300, 192, False, [300, 171, 0]),
    "causal_d256": (1, 2, 300, 256, True, None),
    "ragged_d256_fully_masked_row": (3, 1, 300, 256, False, [300, 0, 171]),
}


def _pallas_at_cuda_tiles(q, k, v, g, lengths, causal, sm, fwd_keys,
                          dq_keys):
    """(o, dq) of the Pallas kernels in interpret mode at the CUDA
    kernels' tiles: the forward at 128 q rows x ``fwd_keys``, dq at 128 q
    rows x ``dq_keys``, T zero-padded to a multiple of both and of 128
    (padded keys masked by the lengths, padded q rows sliced off)."""
    B, T = q.shape[0], q.shape[2]
    step = math.lcm(BLOCK_Q, fwd_keys, dq_keys)
    pad = ((0, 0), (0, 0), (0, -T % step), (0, 0))
    qp, kp, vp, gp = (jnp.pad(a, pad) for a in (q, k, v, g))
    lens = jnp.asarray(lengths if lengths is not None else [T] * B,
                       jnp.int32)
    o, lse = jfa._flash_forward(qp, kp, vp, lens, causal, sm, BLOCK_Q,
                                fwd_keys, interpret=True)
    dq, _, _ = jfa._flash_backward(qp, kp, vp, o, lse, lens, gp, causal, sm,
                                   BLOCK_Q, dq_keys, interpret=True)
    return _torch(o[:, :, :T]), _torch(dq[:, :, :T])


@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_tiles_meet_the_card_gate(case):
    B, H, T, D, causal, lengths = CASES[case]
    fwd_keys, dq_keys = KEY_TILES[tfa._kernel_head_dim(D)]
    rng = np.random.RandomState(T + D)
    q, k, v, g = (jnp.asarray(rng.randn(B, H, T, D).astype(np.float32),
                              jnp.bfloat16) for _ in range(4))
    sm = 1.0 / math.sqrt(D)
    got = _pallas_at_cuda_tiles(q, k, v, g, lengths, causal, sm, fwd_keys,
                                dq_keys)
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
    for name, a, b, t in zip(("o", "dq"), got, plain, truth):
        e = _errors(a, b, t)
        assert _passes(e), (name, e)
        assert e["fro_ratio"] < 1.05, (name, e)  # one rounding, not drift
    # a stale stage of each kernel's ring, at its own key tile
    sk, sv = _stale_stage(tk, fwd_keys), _stale_stage(tv, fwd_keys)
    fo, _ = tfa.flash_attention_reference(tq, sk, sv, lens, causal, sm)
    assert not _passes(_errors(fo, plain[0], truth[0]))
    sk, sv = _stale_stage(tk, dq_keys), _stale_stage(tv, dq_keys)
    fdq = tfa.flash_dq_reference(tq, sk, sv, plse, di, tg, lens, causal, sm)
    assert not _passes(_errors(fdq, plain[1], truth[1]))


BF16, F32 = torch.bfloat16, torch.float32


_INSTANCE_CASES = [
    (160, BF16, "fwd", 192), (160, BF16, "dq", 192), (192, BF16, "fwd", 192),
    (256, BF16, "dq", 256), (200, BF16, "fwd", 256), (160, BF16, "dkv", 192),
    (256, BF16, "dkv", 256), (320, BF16, "fwd", 384), (320, BF16, "dq", 384),
    (96, BF16, "dkv", 128), (160, F32, "fwd", 192), (256, F32, "dq", 256),
    (96, F32, "fwd", 128), (64, F32, "dkv", 64), (256, F32, "dkv", 256),
    (320, F32, "fwd", 384),
]


# the ids the cases were written with, when each instance was a (head dim,
# wide) pair
@pytest.mark.parametrize("D,dtype,kind,instance", _INSTANCE_CASES, ids=[
    f"{d}-dtype{i}-{kind}-instance{i}"
    for i, (d, _, kind, _) in enumerate(_INSTANCE_CASES)])
def test_kernel_instance_by_dtype(D, dtype, kind, instance):
    """bf16 pads 160 to 192 and 256 to 256 on wgmma (all three kernels),
    and 320 to 384, where all three run wgmma too; f32 runs its
    forward, dq and dkv on the tensor cores at 192, 256 and 384, and the
    padded head dim is the same in both (every instance of either dtype
    runs on the tensor cores)."""
    assert tfa._kernel_head_dim(D) == instance


class _PlainKernels:
    """The kernel entries swapped for their plain versions on the CPU:
    the head dims the CUDA route hands each kernel are recorded, and the
    launch counters start at 0 and go back to their values after."""

    def __init__(self, monkeypatch):
        self.head_dims = []
        monkeypatch.setattr(tfa, "_launch_fwd", self.forward)
        monkeypatch.setattr(tfa, "_launch_bwd", self.backward)
        monkeypatch.setattr(tfa, "_plain_device", lambda t: False)
        for fn, names in ((tfa.flash_attention, ("bf16_launches",)),
                          (tfa.flash_backward, (
                              "dq_bf16_launches", "dkv_bf16_launches"))):
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
        return (tfa.flash_attention.bf16_launches,
                tfa.flash_backward.dq_bf16_launches,
                tfa.flash_backward.dkv_bf16_launches)


# the cases keep the ids they were written with, when a third value
# counted the wide launches and D320 padded to 320
@pytest.mark.parametrize("D,padded", [
    pytest.param(160, 192, id="160-192-wide0"),
    pytest.param(256, 256, id="256-256-wide1"),
    pytest.param(320, 384, id="320-320-wide2")])
def test_bf16_route_pads_counts_and_slices_back(D, padded, monkeypatch):
    """flash_forward and flash_backward on the CUDA route hand each kernel
    the bf16 head dim padded to its instance, count one bf16 launch of
    each (at D320, padded to 384, all three on wgmma), and give back the
    unpadded plain version's results (sm_scale from the true D)."""
    rng = np.random.RandomState(D)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 2, 40, D).astype(
        np.float32)).bfloat16() for _ in range(4))
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
    torch.testing.assert_close(o, o_want, atol=0, rtol=0)
    torch.testing.assert_close(lse, lse_want, atol=0, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads_want):
        assert a.dtype == BF16 and a.shape == (2, 2, 40, D), name
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def _meta(B, H, T, D, dtype):
    return tuple(torch.empty(B, H, T, D, device="meta", dtype=dtype)
                 for _ in range(4))


@pytest.mark.parametrize("D", [160, 192, 256, 320])
def test_kernel_checks_take_bf16_wide_heads(D):
    """bf16 q/k/v/o/dO past head dim 128 pass the checks; dkv's 64-key
    blocks on the grid's y axis bound T at 65535 x 64."""
    q, k, v, do = _meta(2, 4, 16, D, BF16)
    tfa._check_kernel_inputs(q, k, v)
    tfa._check_kernel_inputs(q, k, v, q, do)
    q, k, v, _ = _meta(1, 1, 65535 * 64 + 1, D, BF16)
    with pytest.raises(ValueError, match="grid's y limit"):
        tfa._check_kernel_inputs(q, k, v)
    tfa._check_kernel_inputs(*(t[:, :, :65535 * 64] for t in (q, k, v)))
