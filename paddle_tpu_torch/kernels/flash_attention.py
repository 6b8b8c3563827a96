"""Flash attention: a hand-written sm_90a CUDA kernel with online softmax.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``. The TPU kernel it
replaces is ``_flash_kernel`` (launched by ``_flash_forward`` through
``pl.pallas_call``); its CUDA twin is ``csrc/flash_attention_fwd.cu``:
one thread block per (batch*head, 64-row q tile) loops over 64-row K/V
tiles kept in shared memory, carrying the softmax max, denominator and
output accumulator in f32, so the [T, T] scores never reach device
memory.

What bounds it on the H100: at the serving prefill shape (B8 H16 T1024
D64, causal) the kernel does ~17 GFLOP on ~134 MB, well above the
card's FLOP:byte ridge, so it is bound by operations. This first
version uses f32 FMA on CUDA cores (the path is f32: ``_attn_proj``
casts qkv back to the hidden dtype); register tiles reuse every
shared-memory load 4-8 times, causal tiles above the diagonal and tiles
past a row's K length are skipped, and the ragged edge is masked in the
kernel instead of padding to 128 lanes. Tensor cores (wgmma, TMA) are
later work.

``flash_attention`` dispatches on the tensor's device: a CPU tensor runs
``flash_attention_reference`` (the plain version, with the kernel's exact
edge semantics); a CUDA tensor launches the kernel or raises. The
backward kernels (``_flash_dq_kernel``/``_flash_dkv_kernel``) land with
the training slice; until then a CUDA input that requires grad raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

_LIB = "flash_attention_fwd"


def rotary(x, pos0=0, base=10000.0):
    """Rotary position embedding over [B, H, T, D] heads at positions
    pos0..pos0+T-1 (RoFormer pairing: (x[2i], x[2i+1]) rotates by
    pos * base^(-2i/D)). ``pos0`` may be a [B] tensor of per-row offsets
    (the slot-decode path, where every batch row sits at its own
    position)."""
    D, T = x.shape[-1], x.shape[2]
    half = D // 2
    dev = x.device
    inv = base ** (-torch.arange(0, half, dtype=torch.float32, device=dev)
                   / half)
    pos0 = torch.as_tensor(pos0, dtype=torch.float32, device=dev)
    steps = torch.arange(T, dtype=torch.float32, device=dev)
    if pos0.ndim:  # per-row offsets: [B] -> angles [B, 1, T, half]
        ang = (pos0[:, None] + steps[None, :])[:, :, None] * inv
        ang = ang[:, None]
    else:
        ang = ((pos0 + steps)[:, None] * inv)[None, None]  # [1, 1, T, half]
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def reference_attention(q, k, v, lengths=None, causal=False, sm_scale=None,
                        q_pos0=0):
    """Plain attention over [B, H, T, D]; the semantic ground truth.

    K/V may carry Hkv < H head planes (grouped-query attention: query
    head h reads kv head h // (H // Hkv)); the group structure stays in
    the einsum, so no [B, H, T, D] expansion is materialised. ``q_pos0``
    offsets the queries' global positions for causal masking, as an int
    or a [B] tensor of per-row offsets. Fully masked rows give zeros."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if H != Hkv:
        if H % Hkv:
            raise ValueError(f"query heads {H} not a multiple of kv heads "
                             f"{Hkv}")
        rep = H // Hkv
        qg = q.reshape(B, Hkv, rep, Tq, D)
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k).float() * sm_scale
        s = s.reshape(B, H, Tq, Tk)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    dev = q.device
    kj = torch.arange(Tk, device=dev)
    neg = torch.tensor(-math.inf, dtype=s.dtype, device=dev)
    if causal:
        p0 = torch.as_tensor(q_pos0, device=dev)
        if p0.ndim:  # per-row offsets: [B] -> mask [B, 1, Tq, Tk]
            qi = p0[:, None] + torch.arange(Tq, device=dev)[None, :]
            s = torch.where(qi[:, None, :, None] >= kj, s, neg)
        else:
            qi = q_pos0 + torch.arange(Tq, device=dev)[:, None]
            s = torch.where(qi >= kj[None, :], s, neg)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
        s = torch.where(kj < lengths[:, None, None, None], s, neg)
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0).to(v.dtype)  # fully masked rows -> 0
    if H != Hkv:
        pg = p.reshape(B, Hkv, rep, Tq, Tk)
        return torch.einsum("bgrqk,bgkd->bgrqd", pg, v).reshape(q.shape)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def flash_attention_reference(q, k, v, lengths=None, causal=False,
                              sm_scale=None):
    """The kernel's plain version: (o [B, H, Tq, D], lse [B, H, Tq] f32)
    with the TPU kernel's edge semantics. Rows attend keys k_pos <
    lengths[b] (and k_pos <= q_pos when causal, queries counted from 0);
    a fully masked row gives o = 0 and lse = +inf, and the softmax
    denominator is max(l, 1e-30)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    Tq, Tk = q.shape[2], k.shape[2]
    dev = q.device
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    kj = torch.arange(Tk, device=dev)
    mask = torch.ones(Tq, Tk, dtype=torch.bool, device=dev)
    if causal:
        mask = torch.arange(Tq, device=dev)[:, None] >= kj[None, :]
    mask = mask[None, None]
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
        mask = mask & (kj < lengths[:, None, None, None])
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    o = (o / torch.clamp(l, min=1e-30)).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, math.inf))
    return o, lse[..., 0]


def _bind():
    from . import build

    lib = build.load(_LIB)
    fn = lib.paddle_flash_attention_fwd_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _aligned(t):
    """Contiguous, with a 16-byte aligned base (the kernel loads float4)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch(q, k, v, lengths, causal, sm_scale):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {D}")
    if q.dtype != torch.float32 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 q/k/v, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)} (expand GQA heads "
                         "first)")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if B * H > 65535:
        raise ValueError(f"batch*heads {B * H} exceeds the grid's y limit")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash backward kernels land with the training slice; "
            "run CUDA attention under torch.no_grad() until then")
    lib, fn = _bind()
    dev = q.device
    if lengths is None:
        lens = torch.full((B,), Tk, dtype=torch.int32, device=dev)
    else:
        lens = torch.as_tensor(lengths, device=dev).to(torch.int32)
    lens_bh = lens.repeat_interleave(H).contiguous()  # [BH]
    q3, k3, v3 = (_aligned(t) for t in (q, k, v))
    o = torch.empty_like(q3)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                 lens_bh.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 B * H, Tq, Tk, D, int(bool(causal)), float(sm_scale),
                 stream)
    if err:
        raise RuntimeError(
            f"flash_attention_fwd launch failed: CUDA error {err} "
            f"({lib.paddle_cuda_error_string(err).decode()})")
    flash_attention.launches += 1
    return o, lse


def flash_forward(q, k, v, lengths=None, causal=False, sm_scale=None):
    """(o [B, H, Tq, D], lse [B, H, Tq] f32) over [B, H, T, D] tensors:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU one.
    ``lengths`` [B] masks K/V columns at and past each row's length."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    return _launch(q, k, v, lengths, causal, sm_scale)


def flash_attention(q, k, v, lengths=None, causal=False, sm_scale=None):
    """Scaled-dot-product attention over [B, H, T, D] tensors: the
    sm_90a flash kernel on CUDA, its plain version on the CPU.
    ``flash_attention.launches`` counts the kernel's launches."""
    return flash_forward(q, k, v, lengths, causal, sm_scale)[0]


flash_attention.launches = 0
