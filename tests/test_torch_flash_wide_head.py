"""Head dims past 128 on the port's CUDA route: the flash backward's wide
instances.

On a CUDA tensor a head dim D > 128 is zero-padded to a multiple of 64,
one in 257-512 to 384 or 512, and one past 512 to a multiple of 128.
Past 512 only the bf16 dq and dkv run the wide instances
(``csrc/flash_wide.cuh``; the f32 ones run their 3xTF32 slice instances,
``tests/test_torch_flash_f32_bwd_past512_tiles.py``): every product that
sums over D (S = QK^T, dP = dO V^T) accumulates 64-column chunks, and
each output's D axis is
cut into 128-wide slices on the grid's z axis, each block recomputing S
for its own slice. Here that decomposition is emulated on the CPU (64-row
tiles, chunk sums in order, the dkv loop starting at the causal bound)
and held against the JAX package's Pallas backward kernels in interpret
mode at D = 320 (padded to 384) and 512, causal and ragged with a fully
masked row (D = 576, padded to 640, is emulated in
``tests/test_torch_flash_bf16_d512_tiles.py``; the forward past 512 runs
its slice instance on the tensor cores:
``tests/test_torch_flash_fwd_past512_tiles.py``). (The f32 kernels at
129-512 run on the tensor cores: ``tests/test_torch_flash_f32_wide_tiles.py``,
``tests/test_torch_flash_f32_dkv_split_tiles.py``,
``tests/test_torch_flash_f32_d512_tiles.py`` and
``tests/test_torch_flash_f32_dkv_d512_tiles.py``; the bf16 forward
and dq at 257-512: ``tests/test_torch_flash_bf16_d512_tiles.py``, dkv
there: ``tests/test_torch_flash_bf16_dkv_d512_tiles.py``.) The
launch
wiring is checked with the kernel entries swapped for their plain
versions, and the input checks on meta tensors. Inputs come from a numpy
seed; f32 throughout, atol = rtol = 1e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
WIDE_DIMS = [320, 512]  # the decomposition at 384 and 512 (320 at 384)
ROUTE_DIMS = [160, 256]  # padded to 192 and 256
BT, DC, DS = 64, 64, 128  # tile rows, D chunk, D slice (flash_wide.cuh)
# (B, H, T, causal, lengths); T = 80 leaves a ragged second 64-row tile,
# and a length of 0 is a fully masked row
CASES = {"causal": (2, 2, 80, True, None),
         "ragged": (3, 1, 80, False, [80, 37, 0])}


def _inputs(B, H, T, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, T, D).astype(np.float32) for _ in range(4))


def _jax_forward(q, k, v, lens, causal, sm):
    B, H, T, D = q.shape
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    jo, jlse = jfa._flash_forward(*(jnp.asarray(a) for a in (q, k, v)),
                                  jlens, causal, sm, block_q=16, block_k=8,
                                  interpret=True)
    return np.array(jo).reshape(B, H, T, D), np.array(jlse).reshape(
        B, H, T)


def _jax_backward(q, k, v, g, lens, causal, sm):
    B, H, T, D = q.shape
    jo, jlse = _jax_forward(q, k, v, lens, causal, sm)
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    grads = jfa._flash_backward(
        *(jnp.asarray(a) for a in (q, k, v, jo)),
        jnp.asarray(jlse).reshape(B * H, 1, T), jlens, jnp.asarray(g),
        causal, sm, 16, 8, interpret=True)
    return jo, jlse, [np.asarray(x) for x in grads]


# -- the wide instances' decomposition, emulated --------------------------
def _flat(x, Dp):
    B, H, T, D = x.shape
    return F.pad(x, (0, Dp - D)).reshape(B * H, T, Dp)


def _chunked(a, b):
    """a [BH, m, Dp] . b [BH, n, Dp]^T summed over 64-column chunks of D
    in order, as chunk_product accumulates them."""
    s = torch.zeros(a.shape[0], a.shape[1], b.shape[1])
    for d0 in range(0, a.shape[-1], DC):
        s = s + a[..., d0:d0 + DC] @ b[..., d0:d0 + DC].transpose(1, 2)
    return s


def _visible(qpos, kpos, klen, causal):
    """[BH, m, n]: key kpos is visible from query qpos."""
    ok = kpos[None, None, :] < klen[:, None, None]
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])[None]
    return ok


def _klen(lens, B, H, Tk):
    lens = torch.full((B,), Tk) if lens is None else torch.tensor(lens)
    return lens.clamp(0, Tk).repeat_interleave(H)


def _p_ds(q3, k3, v3, do3, lse3, di3, rows, cols, klen, causal, sm):
    """P and dS of one (q tile, k tile) pair, S and dP chunk-summed."""
    s = _chunked(q3[:, rows], k3[:, cols]) * sm
    dp = _chunked(do3[:, rows], v3[:, cols])
    ok = _visible(rows, cols, klen, causal)
    p = torch.where(ok, torch.exp(s - lse3[:, rows, None]), 0.0)
    return p, p * (dp - di3[:, rows, None])


def _wide_backward(q, k, v, o, lse, do, lens, causal, sm):
    """(dq, dk, dv) as the wide dq and dkv instances compute them: dq per
    (q tile, slice) over the k tiles to the causal bound; dk and dv per
    (k tile, slice) over the q tiles from the first that sees it."""
    B, H, T, D = q.shape
    Dp = tfa._kernel_head_dim(D)
    q3, k3, v3, do3 = (_flat(x, Dp) for x in (q, k, v, do))
    lse3 = lse.reshape(B * H, T)
    di3 = (do * o).sum(-1).reshape(B * H, T)
    klen = _klen(lens, B, H, T)
    dq, dk, dv = (torch.zeros(B * H, T, Dp) for _ in range(3))
    for s0 in range(0, Dp, DS):
        sl = slice(s0, s0 + DS)
        for q0 in range(0, T, BT):
            rows = torch.arange(q0, min(q0 + BT, T))
            kend = min(T, q0 + BT) if causal else T
            for k0 in range(0, kend, BT):
                cols = torch.arange(k0, min(k0 + BT, T))
                _, ds = _p_ds(q3, k3, v3, do3, lse3, di3, rows, cols, klen,
                              causal, sm)
                dq[:, rows, sl] += ds @ k3[:, cols, sl]
        for k0 in range(0, T, BT):
            cols = torch.arange(k0, min(k0 + BT, T))
            for q0 in range(k0 if causal else 0, T, BT):
                rows = torch.arange(q0, min(q0 + BT, T))
                p, ds = _p_ds(q3, k3, v3, do3, lse3, di3, rows, cols, klen,
                              causal, sm)
                dv[:, cols, sl] += p.transpose(1, 2) @ do3[:, rows, sl]
                dk[:, cols, sl] += ds.transpose(1, 2) @ q3[:, rows, sl]
    return tuple((x[..., :D] * scale).reshape(B, H, T, D)
                 for x, scale in ((dq, sm), (dk, sm), (dv, 1.0)))


@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_backward_matches_pallas_backward_interpret(case, D):
    B, H, T, causal, lens = CASES[case]
    q, k, v, g = _inputs(B, H, T, D, seed=D + 1)
    sm = 1.0 / math.sqrt(D)
    jo, jlse, want = _jax_backward(q, k, v, g, lens, causal, sm)
    got = _wide_backward(*(torch.from_numpy(a) for a in (q, k, v, jo, jlse,
                                                          g)),
                         lens, causal, sm)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (B, H, T, D), name
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)


@pytest.mark.parametrize("D,kernel_d", [(129, 192), (160, 192), (192, 192),
                                        (256, 256), (500, 512)])
def test_wide_head_dims_pad_to_a_multiple_of_64(D, kernel_d):
    assert tfa._kernel_head_dim(D) == kernel_d


def _meta(B, H, T, D):
    return tuple(torch.empty(B, H, T, D, device="meta") for _ in range(4))


@pytest.mark.parametrize("D", [160, 256, 512])
def test_kernel_checks_take_head_dims_past_128(D):
    q, k, v, do = _meta(2, 4, 16, D)
    tfa._check_kernel_inputs(q, k, v)
    tfa._check_kernel_inputs(q, k, v, q, do)


def test_wide_kernel_checks_refuse_sequences_past_the_grid():
    """Past 128 the tiles are 64 rows (the wide instances' and the f32
    forward's and dq's): 65535 of them on the grid's y axis at most."""
    q, k, v, _ = _meta(1, 1, 65535 * 64 + 1, 192)
    with pytest.raises(ValueError, match="grid's y limit"):
        tfa._check_kernel_inputs(q, k, v)
    tfa._check_kernel_inputs(*(t[:, :, :65535 * 64] for t in (q, k, v)))


@pytest.mark.parametrize("D", ROUTE_DIMS)
def test_cuda_route_pads_wide_head_dims_and_slices_back(D, monkeypatch):
    """flash_forward, flash_backward, flash_dq and flash_dkv on the CUDA
    route hand the kernel D padded to a multiple of 64, count the backward
    launches, and give back the unpadded plain version's results."""
    head_dims = []

    def forward(q, k, v, lengths, causal, sm_scale):
        head_dims.append(q.shape[-1])
        return tfa.flash_attention_reference(q, k, v, lengths, causal,
                                             sm_scale)

    def backward(kind, outs, q, k, v, lse, di, do, lengths, causal,
                 sm_scale):
        head_dims.append(q.shape[-1])
        if kind == "dq":
            got = (tfa.flash_dq_reference(q, k, v, lse, di, do, lengths,
                                          causal, sm_scale),)
        else:
            got = tfa.flash_dkv_reference(q, k, v, lse, di, do, lengths,
                                          causal, sm_scale)
        for out, t in zip(outs, got):
            out.copy_(t)

    monkeypatch.setattr(tfa, "_launch_fwd", forward)
    monkeypatch.setattr(tfa, "_launch_bwd", backward)
    monkeypatch.setattr(tfa, "_plain_device", lambda t: False)
    monkeypatch.setattr(tfa.flash_attention, "launches", 0)
    monkeypatch.setattr(tfa.flash_backward, "dq_launches", 0)
    monkeypatch.setattr(tfa.flash_backward, "dkv_launches", 0)
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(2, 2, 24, D, seed=4))
    lens = torch.tensor([24, 0])
    o_want, lse_want = tfa.flash_attention_reference(q, k, v, lens, True)
    grads_want = tfa.flash_attention_backward_reference(
        q, k, v, o_want, lse_want, g, lens, True)
    di = (g * o_want).sum(-1)
    o, lse = tfa.flash_forward(q, k, v, lens, True)
    grads = tfa.flash_backward(q, k, v, o, lse, g, lens, True)
    dq = tfa.flash_dq(q, k, v, lse, di, g, lens, True)
    dk, dv = tfa.flash_dkv(q, k, v, lse, di, g, lens, True)
    assert head_dims == [tfa._kernel_head_dim(D)] * 5
    assert (tfa.flash_backward.dq_launches,
            tfa.flash_backward.dkv_launches) == (2, 2)
    torch.testing.assert_close(o, o_want, **TOL)
    torch.testing.assert_close(lse, lse_want, **TOL)
    for name, a, b, c in zip(("dq", "dk", "dv"), grads, grads_want,
                             (dq, dk, dv)):
        assert a.shape == b.shape == c.shape == (2, 2, 24, D), name
        torch.testing.assert_close(a, b, msg=name, **TOL)
        torch.testing.assert_close(c, b, msg=name, **TOL)
