"""The bf16 flash dkv past head dim 128, on the CPU.

On a CUDA tensor a bf16 head dim in 129-192 is zero-padded to 192 and
one in 193-256 to 256, and dkv runs its ``wgmma`` instances there
(``csrc/flash_attention_bf16.cu``, ``dkv_split``): a block owns 64 keys,
shared by both consumer warpgroups, and walks 64-query Q/dO tiles; each
consumer rounds P^T and dS^T for 32 of a tile's queries to bf16 and adds
the tile's products to its columns of dK and dV. Where a query tile ends
changes the order of the f32 sums. The Pallas dkv kernel in interpret
mode at those tiles (64 owned keys, 64-query tiles) meets the gate the
CUDA kernel is held to on the card (``chip_smoke.py``'s bf16 gate, the
copy in ``tests/test_torch_flash_bf16_tiles.py``), at D160, D192 and
D256, causal and ragged with a fully masked row, inputs from a numpy
seed; a stale Q/dO stage planted at the query tile fails it. Then the
route: dkv's instance by head dim, and the launch wiring with the kernel
entry swapped for its plain version (padded D handed over, outputs
sliced back, ``dkv_bf16_launches`` counted; D257-512 runs the instances
of ``tests/test_torch_flash_bf16_dkv_d512_tiles.py``, and past 512 those of
``tests/test_torch_flash_bf16_bwd_past512_tiles.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa
from test_torch_flash_bf16_tiles import _errors, _passes, _stale_stage, _torch
from test_torch_flash_bf16_wide_tiles import (BLOCK_Q, CASES, KEY_TILES,
                                              _PlainKernels)

torch.set_num_threads(1)
# dkv past D = 128: keys a block owns x queries a Q/dO tile
# (csrc/flash_attention_bf16.cu DkvRing<D>::KEYS, DKV_QUERIES)
DKV_KEYS, DKV_QUERIES = 64, 64


def _pallas_dkv_at_cuda_tiles(q, k, v, g, lengths, causal, sm, fwd_keys):
    """(dk, dv) of the Pallas kernels in interpret mode: the forward at
    its CUDA tiles (128 q rows x ``fwd_keys``) for o and lse, dkv at 64
    owned keys x 64-query tiles, T zero-padded to a multiple of both
    (padded keys masked by the lengths, padded queries carry dO = 0)."""
    B, T = q.shape[0], q.shape[2]
    step = math.lcm(BLOCK_Q, fwd_keys, DKV_KEYS, DKV_QUERIES)
    pad = ((0, 0), (0, 0), (0, -T % step), (0, 0))
    qp, kp, vp, gp = (jnp.pad(a, pad) for a in (q, k, v, g))
    lens = jnp.asarray(lengths if lengths is not None else [T] * B,
                       jnp.int32)
    o, lse = jfa._flash_forward(qp, kp, vp, lens, causal, sm, BLOCK_Q,
                                fwd_keys, interpret=True)
    _, dk, dv = jfa._flash_backward(qp, kp, vp, o, lse, lens, gp, causal, sm,
                                    DKV_QUERIES, DKV_KEYS, interpret=True)
    return _torch(dk[:, :, :T]), _torch(dv[:, :, :T])


@pytest.mark.parametrize("case", sorted(CASES))
def test_dkv_tiles_meet_the_card_gate(case):
    B, H, T, D, causal, lengths = CASES[case]
    fwd_keys = KEY_TILES[tfa._kernel_head_dim(D)][0]
    rng = np.random.RandomState(T + D)
    q, k, v, g = (jnp.asarray(rng.randn(B, H, T, D).astype(np.float32),
                              jnp.bfloat16) for _ in range(4))
    sm = 1.0 / math.sqrt(D)
    got = _pallas_dkv_at_cuda_tiles(q, k, v, g, lengths, causal, sm,
                                    fwd_keys)
    lens = None if lengths is None else torch.tensor(lengths)
    tq, tk, tv, tg = (_torch(a) for a in (q, k, v, g))
    po, plse = tfa.flash_attention_reference(tq, tk, tv, lens, causal, sm)
    di = tfa._row_dot(tg, po)
    plain = tfa.flash_dkv_reference(tq, tk, tv, plse, di, tg, lens, causal,
                                    sm)
    f32 = [t.float() for t in (tq, tk, tv, tg)]
    truth = tfa.flash_dkv_reference(*f32[:3], plse, di, f32[3], lens,
                                    causal, sm)
    for name, a, b, t in zip(("dk", "dv"), got, plain, truth):
        e = _errors(a, b, t)
        assert _passes(e), (name, e)
        assert e["fro_ratio"] < 1.05, (name, e)  # one rounding, not drift
    # a stale stage of the Q/dO ring: a query tile reading the one before
    sq, sg = (_stale_stage(t, DKV_QUERIES) for t in (tq, tg))
    planted = tfa.flash_dkv_reference(sq, tk, tv, plse, di, sg, lens,
                                      causal, sm)
    for name, f, b, t in zip(("dk", "dv"), planted, plain, truth):
        e = _errors(f, b, t)
        assert not _passes(e), (name, e)


BF16, F32 = torch.bfloat16, torch.float32


_INSTANCE_CASES = [(129, 192), (160, 192), (192, 192), (193, 256),
                   (256, 256), (257, 384), (512, 512)]


# instance: the padded head dim of either dtype (the ids the cases were
# written with, when it was a pair of (head dim, wide) pairs)
@pytest.mark.parametrize("D,instance", _INSTANCE_CASES, ids=[
    f"{d}-instance{i}" for i, (d, _) in enumerate(_INSTANCE_CASES)])
def test_dkv_instance_by_head_dim(D, instance):
    """bf16 dkv runs wgmma up to a padded 512 (at 257-512 padded to 384
    or 512, as the forward and dq), and so does f32 dkv, on its 3xTF32
    instances. The grid's y axis holds 65535 blocks of 64 keys past
    128."""
    assert tfa._kernel_head_dim(D) == instance
    assert tfa._max_t(instance) == 65535 * DKV_KEYS


# the cases keep the ids they were written with, when a third value
# counted the wide launches, D320 padded to 320 and both ran the wide
# instance
@pytest.mark.parametrize("D,padded", [
    pytest.param(160, 192, id="160-192-0"),
    pytest.param(192, 192, id="192-192-0"),
    pytest.param(256, 256, id="256-256-0"),
    pytest.param(320, 384, id="320-320-1"),
    pytest.param(512, 512, id="512-512-1")])
def test_bf16_dkv_route_pads_counts_and_slices_back(D, padded, monkeypatch):
    """flash_dkv on the CUDA route hands the kernel the bf16 head dim
    padded to its instance, counts one bf16 launch, and gives back the
    unpadded plain version's dk and dv (sm_scale from the true D)."""
    rng = np.random.RandomState(D + 1)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 2, 40, D).astype(
        np.float32)).bfloat16() for _ in range(4))
    lens = torch.tensor([40, 0])
    o, lse = tfa.flash_attention_reference(q, k, v, lens, True)
    di = tfa._row_dot(g, o)
    want = tfa.flash_dkv_reference(q, k, v, lse, di, g, lens, True,
                                   1.0 / math.sqrt(D))
    kernels = _PlainKernels(monkeypatch)
    got = tfa.flash_dkv(q, k, v, lse, di, g, lens, True)
    assert kernels.head_dims == [("dkv", padded)]
    assert kernels.counts() == (0, 0, 1)
    for name, a, b in zip(("dk", "dv"), got, want):
        assert a.dtype == BF16 and a.shape == (2, 2, 40, D), name
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
