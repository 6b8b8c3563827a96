"""The flash kernels' plain versions on bf16 inputs against the Pallas kernels.

Under AMP the per-layer transformer hands the flash op bf16 q/k/v. The
Pallas kernels (run in interpret mode on the CPU) keep S and every
accumulator in f32, round P (and dS) to bf16 before the products that
take them, and round o, dq, dk and dv once at the end; Di = rowsum(dO o)
is f32. The port's plain versions (``flash_attention_reference``,
``flash_attention_backward_reference``), which the CUDA kernels are held
to on the card, must round at the same places: o, dq, dk and dv within
one bf16 ulp of each value (the ulp floored at 1/256 of the largest
|value|: the Pallas forward's running max per 128-key block rounds P
against a different max than the plain version's one global max), lse
within 1e-5. Cases: causal and not, ``lengths`` with a fully masked row,
T not a multiple of the block (padded to 128 lanes as the JAX op pads
it), head dims 64, 128 and 160. The wrappers keep the dtype (o and the
gradients bf16, lse f32) and refuse a mix of dtypes before anything is
built. The Pallas kernels at 64-key blocks also meet the card's norm
gate (error norm against the f32 truth within 1.5x the plain version's),
which a stale K/V stage planted in the plain version fails.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)
BLOCK = 128
LSE_ATOL = 1e-5
# the card's second bf16 gate (chip_smoke.py BF16_FRO_RATIO): an output's
# error norm against the f32 truth at most this multiple of the plain
# version's
FRO_RATIO = 1.5

# (B, H, T, D, causal, lengths)
CASES = {
    "causal_d64": (1, 2, 256, 64, True, None),
    "full_d64": (2, 2, 256, 64, False, None),
    "causal_lengths_fully_masked_row_d128": (3, 1, 256, 128, True,
                                              [256, 100, 0]),
    "ragged_t456_causal_d64": (1, 2, 456, 64, True, None),
    "full_lengths_d160": (2, 1, 128, 160, False, [128, 77]),
}


def bf16_ulps(got, want):
    """The largest |got - want| in bf16 ulps of each wanted value, the ulp
    floored at 1/256 of max |want|."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(w), 2.0 ** -126)
    ulp = np.maximum(np.exp2(np.floor(np.log2(mag)) - 7),
                     np.abs(w).max() / 256)
    return float((np.abs(g - w) / ulp).max())


def _bf16_inputs(B, H, T, D, seed):
    """q, k, v, dO as bf16 jax arrays (from numpy normals)."""
    rng = np.random.RandomState(seed)
    return [jnp.asarray(rng.randn(B, H, T, D).astype(np.float32),
                        jnp.bfloat16) for _ in range(4)]


def _torch(a):
    """A bf16 jax array as a bf16 tensor (f32 numpy in between: exact)."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


def _f32(t):
    return t.float().numpy()


def _pallas(q, k, v, g, lengths, causal, sm, block=BLOCK):
    """(o, lse, dq, dk, dv) of the Pallas kernels in interpret mode at
    ``block``-row blocks, T padded to 128 lanes as ``_attention`` pads
    it."""
    T = q.shape[2]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    qp, kp, vp, lens, _ = jfa._pad_to_lanes(q, k, v, jl)
    o, lse = jfa._flash_forward(qp, kp, vp, lens, causal, sm, block, block,
                                interpret=True)
    gp = jnp.pad(g, ((0, 0), (0, 0), (0, qp.shape[2] - T), (0, 0)))
    dq, dk, dv = jfa._flash_backward(qp, kp, vp, o, lse, lens, gp, causal,
                                     sm, block, block, interpret=True)
    B, H = q.shape[:2]
    lse = lse.reshape(B, H, -1)
    return tuple(a[:, :, :T] for a in (o, lse, dq, dk, dv))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_rounds_as_the_pallas_kernel(case):
    B, H, T, D, causal, lengths = CASES[case]
    q, k, v, g = _bf16_inputs(B, H, T, D, seed=len(case))
    sm = 1.0 / math.sqrt(D)
    jo, jlse = _pallas(q, k, v, g, lengths, causal, sm)[:2]
    lens = None if lengths is None else torch.tensor(lengths)
    o, lse = tfa.flash_attention_reference(
        *(_torch(a) for a in (q, k, v)), lens, causal, sm)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want_o = np.asarray(jo.astype(jnp.float32))
    assert bf16_ulps(_f32(o), want_o) <= 1.0, bf16_ulps(_f32(o), want_o)
    want_lse = np.asarray(jlse)
    fin = np.isfinite(want_lse)
    assert np.array_equal(np.isfinite(lse.numpy()), fin)
    np.testing.assert_allclose(lse.numpy()[fin], want_lse[fin], rtol=0,
                               atol=LSE_ATOL)
    if lengths is not None and 0 in lengths:  # a fully masked row: o = 0
        assert not _f32(o)[np.asarray(lengths) == 0].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_rounds_as_the_pallas_kernels(case):
    """dq, dk, dv from the Pallas forward's own o and lse, so that only
    the backward is under test."""
    B, H, T, D, causal, lengths = CASES[case]
    q, k, v, g = _bf16_inputs(B, H, T, D, seed=len(case) + 1)
    sm = 1.0 / math.sqrt(D)
    jo, jlse, *want = _pallas(q, k, v, g, lengths, causal, sm)
    lens = None if lengths is None else torch.tensor(lengths)
    got = tfa.flash_attention_backward_reference(
        *(_torch(a) for a in (q, k, v, jo)),
        torch.from_numpy(np.array(jlse)), _torch(g), lens, causal, sm)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        err = bf16_ulps(_f32(a), np.asarray(b.astype(jnp.float32)))
        assert err <= 1.0, (name, err)


def test_wrappers_keep_bf16_and_lse_f32_on_cpu_and_meta():
    q, k, v, g = (_torch(a) for a in _bf16_inputs(1, 2, 40, 64, seed=3))
    o, lse = tfa.flash_forward(q, k, v, None, True)
    assert (o.dtype, lse.dtype) == (torch.bfloat16, torch.float32)
    grads = tfa.flash_backward(q, k, v, o, lse, g, None, True)
    assert all(t.dtype == torch.bfloat16 for t in grads)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    y = tfa.flash_attention(*leaves, causal=True)
    y.backward(g)
    assert y.dtype == torch.bfloat16
    for leaf, want in zip(leaves, grads):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, want)
    meta = [torch.empty(2, 4, 33, 64, dtype=torch.bfloat16, device="meta")
            for _ in range(4)]
    o, lse = tfa.flash_forward(*meta[:3], None, True)
    assert (o.dtype, lse.dtype, o.device.type) == (torch.bfloat16,
                                                   torch.float32, "meta")


@pytest.mark.parametrize("mix", ["q_f32", "k_f32", "v_f16", "do_f32"])
def test_kernel_launchers_refuse_a_mix_of_dtypes(mix):
    """The CUDA launch path validates before it builds or binds anything
    (no nvcc here), naming every input's dtype."""
    q, k, v, g = (_torch(a) for a in _bf16_inputs(1, 2, 8, 64, seed=5))
    lse = di = torch.zeros(1, 2, 8)
    if mix == "q_f32":
        q = q.float()
    elif mix == "k_f32":
        k = k.float()
    elif mix == "v_f16":
        v = v.half()
    else:
        g = g.float()
    before = (tfa.flash_attention.bf16_launches,
              tfa.flash_backward.dq_bf16_launches,
              tfa.flash_backward.dkv_bf16_launches)
    with pytest.raises(TypeError, match="bfloat16.*float|float.*bfloat16"):
        if mix == "do_f32":
            tfa._launch_dq(q, k, v, lse, di, g, None, True, 0.125)
        else:
            tfa._launch(q, k, v, None, True, 0.125)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        tfa._launch_dkv(q, k, v, lse, di, g, None, True, 0.125)
    assert (tfa.flash_attention.bf16_launches,
            tfa.flash_backward.dq_bf16_launches,
            tfa.flash_backward.dkv_bf16_launches) == before


class _Bound(Exception):
    """Raised by the stand-in ``_bind``: the launch got as far as naming
    its library and entry point."""


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_route_picks_the_instance_of_the_dtype(dtype, monkeypatch):
    """On the CUDA route (forced here) each launcher binds the library and
    entry point of its inputs' dtype; the zero-padding to the kernel's
    head dim keeps the dtype."""
    q, k, v, g = (_torch(a).to(dtype)
                  for a in _bf16_inputs(1, 2, 24, 96, seed=7))
    lse = di = torch.zeros(1, 2, 24)
    bound, padded = [], []

    def bind(lib, fn, n_ptrs):
        bound.append((lib, fn))
        raise _Bound

    monkeypatch.setattr(tfa, "_bind", bind)
    monkeypatch.setattr(tfa, "_plain_device", lambda t: False)
    real_fwd = tfa._launch_fwd

    def launch_fwd(q, k, v, *args):
        padded.append((q.dtype, q.shape[-1]))
        return real_fwd(q, k, v, *args)

    monkeypatch.setattr(tfa, "_launch_fwd", launch_fwd)
    for call in (lambda: tfa.flash_forward(q, k, v, None, True),
                 lambda: tfa.flash_dq(q, k, v, lse, di, g, None, True),
                 lambda: tfa.flash_dkv(q, k, v, lse, di, g, None, True)):
        with pytest.raises(_Bound):
            call()
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    libs = (["flash_attention_bf16"] * 3 if dtype == torch.bfloat16 else
            ["flash_attention_fwd"] + ["flash_attention_bwd"] * 2)
    assert bound == list(zip(libs, [
        f"paddle_flash_attention_{n}_{suffix}"
        for n in ("fwd", "bwd_dq", "bwd_dkv")]))
    assert padded == [(dtype, 128)]


def _stale_stage(t, tile=64):
    """``t`` with its middle 64-key tile holding the tile before it."""
    j = t.shape[2] // tile // 2
    out = t.clone()
    out[:, :, j * tile:(j + 1) * tile] = t[:, :, (j - 1) * tile:j * tile]
    return out


@pytest.mark.parametrize("case", [(1, 2, 512, 128, True, None),
                                  (2, 1, 384, 64, False, [384, 200])])
def test_pallas_error_norm_is_the_plain_versions(case):
    """The gate the CUDA kernels meet on the card, met by the Pallas
    kernels at the CUDA kernels' 64-key tiles: each of o, dq, dk, dv lies
    from the f32 truth (the plain version on the same bf16 values) with
    an error norm at most FRO_RATIO x the bf16 plain version's; a stale
    K/V stage planted in the plain version lies far past it."""
    B, H, T, D, causal, lengths = case
    q, k, v, g = _bf16_inputs(B, H, T, D, seed=T)
    sm = 1.0 / math.sqrt(D)
    jo, jlse, *jg = _pallas(q, k, v, g, lengths, causal, sm, block=64)
    lens = None if lengths is None else torch.tensor(lengths)
    tq, tk, tv, tg = (_torch(a) for a in (q, k, v, g))
    po, plse = tfa.flash_attention_reference(tq, tk, tv, lens, causal, sm)
    pgr = tfa.flash_attention_backward_reference(tq, tk, tv, po, plse, tg,
                                                 lens, causal, sm)
    f32 = [t.float() for t in (tq, tk, tv, tg)]
    to, _ = tfa.flash_attention_reference(*f32[:3], lens, causal, sm)
    tgr = tfa.flash_attention_backward_reference(
        *f32[:3], po.float(), plse, f32[3], lens, causal, sm)
    sk, sv = _stale_stage(tk), _stale_stage(tv)
    fo, _ = tfa.flash_attention_reference(tq, sk, sv, lens, causal, sm)
    fgr = tfa.flash_attention_backward_reference(tq, sk, sv, po, plse, tg,
                                                 lens, causal, sm)
    pallas = [_torch(a) for a in (jo, *jg)]
    for name, a, b, t, f in zip(("o", "dq", "dk", "dv"), pallas,
                                (po, *pgr), (to, *tgr), (fo, *fgr)):
        plain = float((b.float() - t).norm())
        ratio = float((a.float() - t).norm()) / plain
        stale = float((f.float() - t).norm()) / plain
        assert ratio <= FRO_RATIO, (name, ratio)
        assert stale > 10 * FRO_RATIO, (name, stale)
