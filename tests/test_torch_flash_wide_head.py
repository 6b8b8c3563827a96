"""Head dims past 128 on the port's CUDA route: padding, checks, wiring.

On a CUDA tensor a head dim D > 128 is zero-padded to a multiple of 64,
one in 257-512 to 384 or 512, and one past 512 to a multiple of 128, in
either dtype and for every kernel, and every instance there runs on the
tensor cores: the f32 and bf16 kernels at 192 and 256
(``tests/test_torch_flash_f32_wide_tiles.py``,
``tests/test_torch_flash_f32_dkv_split_tiles.py``,
``tests/test_torch_flash_bf16_wide_tiles.py``,
``tests/test_torch_flash_bf16_dkv_wide_tiles.py``), at 384 and 512
(``tests/test_torch_flash_f32_d512_tiles.py``,
``tests/test_torch_flash_f32_dkv_d512_tiles.py``,
``tests/test_torch_flash_bf16_d512_tiles.py``,
``tests/test_torch_flash_bf16_dkv_d512_tiles.py``) and past 512, the
slice instances (``tests/test_torch_flash_fwd_past512_tiles.py``,
``tests/test_torch_flash_f32_bwd_past512_tiles.py``,
``tests/test_torch_flash_bf16_bwd_past512_tiles.py``). Here: the padded
head dims, the input checks on meta tensors, and the launch wiring with
the kernel entries swapped for their plain versions. Inputs come from a
numpy seed; f32 throughout, atol = rtol = 1e-5.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
ROUTE_DIMS = [160, 256]  # padded to 192 and 256


def _inputs(B, H, T, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, T, D).astype(np.float32) for _ in range(4))


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
    """Past 128 a grid's y index holds 64 rows (one block, or pairs or
    fours of smaller ones on z): 65535 of them at most."""
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
