"""Head dims other than the flash kernels' instances (64 and 128), and any
batch*heads, on the port's CUDA route.

On a CUDA tensor the flash wrappers zero-pad the head dim up to the next
kernel instance and slice the outputs back (``_at_kernel_head_dim``),
keeping ``sm_scale`` from the true head dim. Here that helper runs the
plain versions on the CPU, at the head dims the repository's own
configurations use (8, 16, 32) and two more (48, 96), against the JAX
package's Pallas forward and backward kernels in interpret mode. The
launch wiring is checked with the kernel entry swapped for its plain
version, and the input checks on meta tensors: D <= 128 and B*H = 70000
pass (head dims past 128: ``test_torch_flash_wide_head.py``). Inputs come
from a numpy seed; f32 throughout, atol = rtol = 1e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
HEAD_DIMS = [8, 16, 32, 48, 96]
# (B, H, T, causal, lengths); a length of 0 is a fully masked row
CASES = {"causal": (2, 2, 32, True, None),
         "lengths": (3, 2, 32, False, [32, 11, 0])}


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


def _torch_lens(lens):
    return None if lens is None else torch.tensor(lens)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_padded_forward_matches_pallas_forward_interpret(case, D):
    B, H, T, causal, lens = CASES[case]
    q, k, v, _ = _inputs(B, H, T, D, seed=D)
    sm = 1.0 / math.sqrt(D)  # the true head dim's scale
    want_o, want_lse = _jax_forward(q, k, v, lens, causal, sm)
    tl = _torch_lens(lens)
    o, lse = tfa._at_kernel_head_dim(
        lambda q, k, v: tfa.flash_attention_reference(q, k, v, tl, causal,
                                                      sm),
        *(torch.from_numpy(a) for a in (q, k, v)))
    assert o.shape == (B, H, T, D) and lse.shape == (B, H, T)
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    fin = np.isfinite(want_lse)
    assert np.array_equal(np.isfinite(lse.numpy()), fin)
    np.testing.assert_allclose(lse.numpy()[fin], want_lse[fin], **TOL)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_padded_backward_matches_pallas_backward_interpret(case, D):
    B, H, T, causal, lens = CASES[case]
    q, k, v, g = _inputs(B, H, T, D, seed=D + 1)
    sm = 1.0 / math.sqrt(D)
    jo, jlse = _jax_forward(q, k, v, lens, causal, sm)
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    want = jfa._flash_backward(
        *(jnp.asarray(a) for a in (q, k, v, jo)),
        jnp.asarray(jlse).reshape(B * H, 1, T), jlens, jnp.asarray(g),
        causal, sm, 16, 8, interpret=True)
    tl = _torch_lens(lens)
    lse = torch.from_numpy(jlse)
    got = tfa._at_kernel_head_dim(
        lambda q, k, v, o, do: tfa.flash_attention_backward_reference(
            q, k, v, o, lse, do, tl, causal, sm),
        *(torch.from_numpy(a) for a in (q, k, v, jo, g)))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (B, H, T, D), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("D,kernel_d", [(1, 64), (8, 64), (64, 64),
                                        (65, 128), (96, 128), (128, 128)])
def test_kernel_head_dim_is_the_next_instance(D, kernel_d):
    assert tfa._kernel_head_dim(D) == kernel_d


def _meta(B, H, T, D):
    return tuple(torch.empty(B, H, T, D, device="meta") for _ in range(4))


@pytest.mark.parametrize("B,H,D", [(2, 4, 8), (2, 4, 48), (2, 4, 128),
                                   (7000, 10, 32), (70000, 1, 64)])
def test_kernel_checks_take_any_head_dim_to_128_and_any_batch_heads(B, H, D):
    q, k, v, do = _meta(B, H, 16, D)
    tfa._check_kernel_inputs(q, k, v)
    tfa._check_kernel_inputs(q, k, v, q, do)


def test_kernel_checks_refuse_sequences_past_the_grid():
    """The q and k tiles (128 rows) lie on the grid's y axis, 65535 at
    most."""
    q, k, v, _ = _meta(1, 2, 65535 * 128 + 1, 64)
    with pytest.raises(ValueError, match="grid's y limit"):
        tfa._check_kernel_inputs(q, k, v)
    tfa._check_kernel_inputs(*(t[:, :, :65535 * 128] for t in (q, k, v)))


class _PlainKernels:
    """The kernel entries swapped for their plain versions on the CPU:
    what the CUDA route hands a kernel (shapes, head dim) is recorded."""

    def __init__(self, monkeypatch):
        self.head_dims = []
        monkeypatch.setattr(tfa, "_launch_fwd", self.forward)
        monkeypatch.setattr(tfa, "_launch_bwd", self.backward)
        monkeypatch.setattr(tfa, "_plain_device", lambda t: False)
        # the counters go back to their values after the test
        monkeypatch.setattr(tfa.flash_attention, "launches", 0)
        monkeypatch.setattr(tfa.flash_backward, "dq_launches", 0)
        monkeypatch.setattr(tfa.flash_backward, "dkv_launches", 0)

    def forward(self, q, k, v, lengths, causal, sm_scale):
        self.head_dims.append(q.shape[-1])
        return tfa.flash_attention_reference(q, k, v, lengths, causal,
                                             sm_scale)

    def backward(self, kind, outs, q, k, v, lse, di, do, lengths, causal,
                 sm_scale):
        self.head_dims.append(q.shape[-1])
        if kind == "dq":
            got = (tfa.flash_dq_reference(q, k, v, lse, di, do, lengths,
                                          causal, sm_scale),)
        else:
            got = tfa.flash_dkv_reference(q, k, v, lse, di, do, lengths,
                                          causal, sm_scale)
        for out, t in zip(outs, got):
            out.copy_(t)


@pytest.mark.parametrize("D", [16, 96])
def test_cuda_route_pads_to_the_kernel_and_slices_back(D, monkeypatch):
    """flash_forward, flash_backward, flash_dq and flash_dkv on the CUDA
    route hand the kernel D padded to 64 or 128 and give back the
    unpadded plain version's results, sm_scale from the true D."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(2, 3, 24, D, seed=4))
    lens = torch.tensor([24, 0])
    o_want, lse_want = tfa.flash_attention_reference(q, k, v, lens, True)
    grads_want = tfa.flash_attention_backward_reference(
        q, k, v, o_want, lse_want, g, lens, True)
    di = (g * o_want).sum(-1)
    kernels = _PlainKernels(monkeypatch)
    o, lse = tfa.flash_forward(q, k, v, lens, True)
    grads = tfa.flash_backward(q, k, v, o, lse, g, lens, True)
    dq = tfa.flash_dq(q, k, v, lse, di, g, lens, True)
    dk, dv = tfa.flash_dkv(q, k, v, lse, di, g, lens, True)
    assert kernels.head_dims == [tfa._kernel_head_dim(D)] * 5
    torch.testing.assert_close(o, o_want, **TOL)
    torch.testing.assert_close(lse, lse_want, **TOL)
    for name, a, b, c in zip(("dq", "dk", "dv"), grads, grads_want,
                             (dq, dk, dv)):
        assert a.shape == b.shape == c.shape == (2, 3, 24, D), name
        torch.testing.assert_close(a, b, msg=name, **TOL)
        torch.testing.assert_close(c, b, msg=name, **TOL)
