"""The port's flash-attention backward against the JAX package.

``flash_attention_backward_reference`` (the plain version of the dq and
dkv CUDA kernels) is held against the Pallas backward kernels themselves,
run in interpret mode on the CPU (``_flash_backward(..., interpret=True)``)
on the same o and logsumexp, and against ``jax.vjp`` of
``reference_attention``; autograd through ``flash_attention`` on the CPU
is held against the plain backward; and the backward launchers refuse
what the kernels do not take before anything is built. Inputs come from a
numpy seed; f32 throughout, atol = rtol = 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)

# (B, H, Tq, Tk, D, causal, lengths, block_q, block_k), as the forward's
CASES = {
    "causal_square": (2, 2, 32, 32, 8, True, None, 16, 8),
    "full_square": (2, 2, 32, 32, 8, False, None, 8, 16),
    "causal_lengths_fully_masked_row": (3, 2, 32, 32, 8, True, [25, 0, 32],
                                        16, 8),
    "full_lengths": (2, 3, 16, 16, 16, False, [16, 7], 8, 8),
    "causal_tq_ne_tk": (2, 2, 16, 48, 8, True, [40, 48], 8, 16),
    "full_tq_ne_tk": (1, 2, 24, 40, 8, False, None, 8, 8),
    "ragged_t100": (1, 2, 100, 100, 16, True, [100], 512, 512),
    "ragged_t100_lengths": (2, 1, 100, 100, 8, False, [63, 100], 512, 512),
}


def _inputs(B, H, Tq, Tk, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Tq, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32),
            rng.randn(B, H, Tq, D).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a, np.float32)) for a in arrays)


def _lens(lengths):
    return None if lengths is None else np.asarray(lengths, np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas_backward_interpret(case):
    B, H, Tq, Tk, D, causal, lengths, bq, bk = CASES[case]
    q, k, v, g = _inputs(B, H, Tq, Tk, D, seed=len(case))
    sm = 1.0 / math.sqrt(D)
    lens = _lens(lengths)
    jlens = None if lens is None else jnp.asarray(lens)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jlse = jfa._flash_forward(jq, jk, jv, jlens, causal, sm, block_q=bq,
                                  block_k=bk, interpret=True)
    jo = jo.reshape(B, H, Tq, D)
    want = jfa._flash_backward(jq, jk, jv, jo, jlse, jlens, jg, causal, sm,
                               bq, bk, interpret=True)
    # the same o and lse on both sides: only the backward is under test
    o, lse = _t(np.asarray(jo), np.asarray(jlse).reshape(B, H, Tq))
    got = tfa.flash_attention_backward_reference(
        *_t(q, k, v), o, lse, *_t(g),
        None if lens is None else torch.from_numpy(lens), causal, sm)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    if lens is not None and (lens == 0).any():  # fully masked rows
        for a in got:
            assert np.all(a.numpy()[lens == 0] == 0.0)


@pytest.mark.parametrize("case", ["causal_square", "full_lengths",
                                  "causal_tq_ne_tk", "ragged_t100_lengths"])
def test_plain_backward_matches_vjp_of_reference_attention(case):
    B, H, Tq, Tk, D, causal, lengths, _, _ = CASES[case]
    q, k, v, g = _inputs(B, H, Tq, Tk, D, seed=4)
    lens = _lens(lengths)
    jlens = None if lens is None else jnp.asarray(lens)
    _, vjp = jax.vjp(lambda a, b, c: jfa.reference_attention(
        a, b, c, jlens, causal=causal), *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = _t(q, k, v, g)
    tlens = None if lens is None else torch.from_numpy(lens)
    o, lse = tfa.flash_attention_reference(tq, tk, tv, tlens, causal)
    got = tfa.flash_attention_backward_reference(tq, tk, tv, o, lse, tg,
                                                 tlens, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("case", ["causal_lengths_fully_masked_row",
                                  "causal_tq_ne_tk", "ragged_t100"])
@pytest.mark.parametrize("transform", ["autograd", "torch_func"])
def test_autograd_through_flash_attention_matches_plain_backward(case,
                                                                 transform):
    """``flash_attention`` is differentiable on the CPU, through
    ``torch.autograd.grad`` and through ``torch.func.vjp`` (the
    ``setup_context`` form), without launching anything."""
    B, H, Tq, Tk, D, causal, lengths, _, _ = CASES[case]
    q, k, v, g = _t(*_inputs(B, H, Tq, Tk, D, seed=6))
    lens = None if lengths is None else torch.tensor(lengths)

    def f(a, b, c):
        return tfa.flash_attention(a, b, c, lens, causal=causal)

    if transform == "autograd":
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(f(*leaves), leaves, g)
    else:
        _, vjp = torch.func.vjp(f, q, k, v)
        got = vjp(g)
    o, lse = tfa.flash_attention_reference(q, k, v, lens, causal)
    want = tfa.flash_attention_backward_reference(q, k, v, o, lse, g, lens,
                                                  causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)
    assert tfa.flash_backward.dq_launches == 0
    assert tfa.flash_backward.dkv_launches == 0


def test_split_plain_versions_compose_the_backward():
    """dq and (dk, dv) from the per-kernel plain versions are the plain
    backward's, given Di = rowsum(dO * o)."""
    B, H, Tq, Tk, D, causal, lengths, _, _ = CASES["causal_tq_ne_tk"]
    q, k, v, g = _t(*_inputs(B, H, Tq, Tk, D, seed=2))
    lens = torch.tensor(lengths)
    o, lse = tfa.flash_attention_reference(q, k, v, lens, causal)
    di = (g * o).sum(-1)
    dq, dk, dv = tfa.flash_attention_backward_reference(q, k, v, o, lse, g,
                                                        lens, causal)
    assert torch.equal(tfa.flash_dq(q, k, v, lse, di, g, lens, causal), dq)
    got_dk, got_dv = tfa.flash_dkv(q, k, v, lse, di, g, lens, causal)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)


def test_backward_shapes_on_meta_without_computing():
    """Build-time shape inference runs the wrappers on meta tensors."""
    q, k, v, g = (torch.empty(2, 4, 33, 64, device="meta") for _ in range(4))
    o, lse = tfa.flash_forward(q, k, v, None, True)
    assert o.device.type == "meta" and tuple(lse.shape) == (2, 4, 33)
    dq, dk, dv = tfa.flash_backward(q, k, v, o, lse, g, None, True)
    assert all(t.device.type == "meta" and t.shape == q.shape
               for t in (dq, dk, dv))


def _bad_backward_inputs(case):
    q, k, v, g = _t(*_inputs(1, 2, 8, 8, 64, seed=9))
    lse = torch.zeros(1, 2, 8)
    di = torch.zeros(1, 2, 8)
    if case == "head_dim":
        return (q[..., :32], k[..., :32], v[..., :32], lse, di,
                g[..., :32]), ValueError
    if case == "dtype":
        return (q.double(), k.double(), v.double(), lse, di,
                g.double()), TypeError
    if case == "do_shape":
        return (q, k, v, lse, di, g[:, :, :4]), ValueError
    if case == "lse_shape":
        return (q, k, v, lse[..., :4], di, g), ValueError
    return (q, k, v, lse, di.double(), g), ValueError  # "di_dtype"


@pytest.mark.parametrize("launcher", ["_launch_dq", "_launch_dkv"])
@pytest.mark.parametrize("case", ["head_dim", "dtype", "do_shape",
                                  "lse_shape", "di_dtype"])
def test_backward_launch_refuses_what_the_kernels_do_not_take(launcher,
                                                              case):
    """The CUDA launch path validates before it builds or binds anything
    (a build here would raise KernelBuildError: no nvcc), so these checks
    run on the CPU too."""
    args, exc = _bad_backward_inputs(case)
    with pytest.raises(exc):
        getattr(tfa, launcher)(*args, None, True, 0.125)
    assert tfa.flash_backward.dq_launches == 0
    assert tfa.flash_backward.dkv_launches == 0


def test_wrappers_refuse_other_devices():
    class FakeDevice:
        type = "xpu"

    class FakeTensor:
        device = FakeDevice()
        shape = (1, 1, 8, 64)

    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        tfa.flash_dq(FakeTensor(), None, None, None, None, None)
