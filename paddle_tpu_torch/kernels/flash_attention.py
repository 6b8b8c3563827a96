"""Flash attention: hand-written sm_90a CUDA kernels, forward and backward.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``. The TPU kernels
it replaces, each launched through ``pl.pallas_call``:

- ``_flash_kernel`` (``_flash_forward``) -> ``csrc/flash_attention_fwd.cu``:
  one thread block per (batch*head, 128-row q tile) walks the K/V tiles
  through a shared-memory ring, carrying the softmax max, denominator and
  output accumulator in f32 registers, so the [T, T] scores never reach
  device memory. It also returns the logsumexp the backward needs.
- ``_flash_dq_kernel`` and ``_flash_dkv_kernel`` (``_flash_backward``) ->
  ``csrc/flash_attention_bwd.cu``: the dq kernel keeps one 128-row q tile
  (Q, dO, lse, Di) and walks the K/V tiles; the dkv kernel keeps one
  128-row k tile (K, V) and walks the q tiles from the causal lower bound.
  Both recompute P from the saved logsumexp, so the backward too stays
  O(T*d) in memory, and neither uses atomics: two launches on the same
  inputs give bitwise-equal gradients.

What bounds them on the H100: at the serving prefill shape (B8 H16 T1024
D64) the forward does ~17 GFLOP on ~134 MB, and at the training shape
(B8 H8 T2048 D128) dq and dkv do 103 and 137 GFLOP on ~0.4 GB, all far
above the card's FLOP:byte ridge, so every kernel is bound by
operations. Each kernel has an f32 instance and a bf16 one. The stacked
transformer and the serving paths hand them f32 (``_attn_proj`` casts
qkv back to the hidden dtype, as the JAX op does); the per-layer
transformer under AMP hands them bf16 q/k/v, and the bf16 instances
(``csrc/flash_attention_bf16.cu``: bf16 operands, f32 accumulators and
softmax, P and dS rounded to bf16 before their products, outputs rounded
once, as the Pallas kernels round) take them: all three on ``wgmma`` fed
by TMA (a producer warpgroup and two consumer warpgroups, 128 owned rows
a block; dkv past head dim 128, 64). The f32 kernels
run every product on the tensor cores as 3xTF32 (each operand split into
two tf32 parts, three products summed in f32: f32 accuracy at up to 165
TFLOP/s): the forward's S = QK^T on ``wgmma``
from shared memory, every other product on ``mma.sync``, fed by
asynchronous tile copies; the forward's softmax and P stay in
registers. All of them
skip causal tiles above the diagonal and tiles past a row's K length, and
mask the ragged edge in the kernel instead of padding to 128 lanes.

The tensor-core kernels are built for head dims 64 and 128; on a CUDA
tensor the wrappers zero-pad any other head dim up to 128 to the next of
them and slice the outputs back (``_at_kernel_head_dim``), with
``sm_scale`` from the true head dim. A head dim past 128 is zero-padded to
a multiple of 64, one in 257-512 to 384 or 512, and one past 512 to a
multiple of 128, in every dtype and for every kernel. In bf16 all three
kernels run it on ``wgmma`` up to
256 (their instances at 192 and 256: the forward and dq with one
accumulator as wide as D and K/V tiles narrowed to fit; dkv with 64
owned keys shared by both consumer warpgroups, each forming P^T and dS^T
for half the queries and accumulating dK and dV for its boxes of D), and
all three at 384 and 512 too (the forward and dq with 64 q rows a
block, each consumer warpgroup owning half of D of the output and
forming S, and dP, over that half; the f32 partials exchanged through
shared memory and summed; 32-key tiles in the forward, 16-key ones in
dq; dkv with 64 keys a block, as two halves on the grid's z axis: dK
over 16-query Q/dO tiles, dV over 32-query ones, each consumer forming
S^T, and dP^T, over its half of D). In
f32 all three run 192 and 256 on the tensor cores as 3xTF32: the
forward and dq with 64 q rows a block and 16-key tiles, dkv with 64 keys
a block and 16-query tiles; each warpgroup owns half of D of the output
and forms S (and dP; S^T and dP^T in dkv) over that half, the partial
products exchanged through shared memory. All three f32 kernels run
384 and 512 on the tensor cores too: 32 q rows (dkv: 32 keys) a block as
two row tiles of 16, each of the 8 warps owning a quarter of D of its
row tile's output and forming S (and dP; S^T and dP^T in dkv) over that
quarter on ``mma.sync``, the four partials exchanged through shared
memory and summed in a fixed order; 16-key K/V tiles in the forward,
8-key ones in dq, 8-query Q/dO tiles in dkv. Past 512 the forward of
either dtype runs its slice instance on the tensor cores
(``flash_fwd_slice_bf16_kernel``, ``flash_fwd_tf32x3_slice_kernel``): O
is cut into slices of up to 512 columns (640 in f32) on the grid's z
axis, and every block forms S over all of D, split as at 512 (two halves
of D's 64-column boxes in bf16, four parts of every 128 columns in f32),
K and V streamed through the ring in boxes of D, Q resident up to D 1024
and streamed with K past it, so any head dim is taken. So do the f32 dq
and dkv (``flash_bwd_dq_tf32x3_slice_kernel``,
``flash_bwd_dkv_tf32x3_slice_kernel``, 3xTF32 on ``mma.sync``): 16 q
rows (dkv: 16 keys) a block as 8 parts of every 128 columns of D, the
outputs in slices of up to 1024 columns on the grid's z axis, every
block forming S and dP (S^T and dP^T) over all of D with the eight
partials summed in part order, the owned rows resident up to D 1152 and
streamed past it. And so do the bf16 dq and dkv
(``flash_bwd_dq_slice_bf16_kernel``, ``flash_bwd_dkv_slice_bf16_kernel``,
on ``wgmma`` fed by TMA): 64 q rows (dkv: 64 keys) a block, 32-key
(32-query) tiles, one consumer warpgroup forming S (S^T) and the other
dP (dP^T) over all of D, exchanged through shared memory, the outputs in
slices on the grid's z axis (dq 512 columns, half a consumer; dk and dv
256, one a consumer), Q or K resident up to D 1024 and streamed with
each tile past it. Any batch*heads is taken (it is the grid's x axis).

``flash_attention`` is differentiable (``_FlashAttention``). Every
wrapper dispatches on the tensor's device: a CPU tensor runs the plain
version (``flash_attention_reference``,
``flash_attention_backward_reference``, with the kernels' exact edge
semantics and, on bf16 inputs, the Pallas kernels' rounding), a meta
tensor (build-time shape inference) runs it too and computes nothing,
and a CUDA tensor launches the kernel of its dtype or raises (a mix of
dtypes raises). ``flash_attention.launches``,
``flash_backward.dq_launches`` and ``flash_backward.dkv_launches`` count
the f32 launches, ``flash_attention.bf16_launches``,
``flash_backward.dq_bf16_launches`` and
``flash_backward.dkv_bf16_launches`` the bf16 ones.
"""
from __future__ import annotations

import ctypes
import math

import torch

_LIB = "flash_attention_fwd"
_LIB_BWD = "flash_attention_bwd"
_LIB_BF16 = "flash_attention_bf16"


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
    neg = torch.full((), -math.inf, dtype=s.dtype, device=dev)
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
    denominator is max(l, 1e-30). On bf16 inputs it rounds where the
    Pallas kernel does: S and the sums in f32, P rounded to bf16 before
    P V, o rounded once."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    Tq, Tk = q.shape[2], k.shape[2]
    dev = q.device
    s = _scores(q, k, sm_scale)
    mask = _mask(Tq, Tk, lengths, causal, dev)
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", _rounded(p, v.dtype), v.float())
    o = (o / torch.clamp(l, min=1e-30)).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, math.inf))
    return o, lse[..., 0]


def _scores(q, k, sm_scale):
    """S = q k^T * sm_scale in f32 from the operands as they are (bf16
    products are exact in f32): the Pallas kernels' ``dot_general`` with
    ``preferred_element_type=f32``."""
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale


def _rounded(x, dtype):
    """f32 ``x`` rounded to the operands' dtype and widened again: the
    Pallas kernels' ``p.astype(v.dtype)`` (and dS's) before a product
    that accumulates in f32. A no-op in f32."""
    return x.to(dtype).float()


def _mask(Tq, Tk, lengths, causal, dev):
    """[B or 1, 1, Tq, Tk] bool: key k_pos is visible from query q_pos
    (k_pos < lengths[b], and k_pos <= q_pos when causal)."""
    kj = torch.arange(Tk, device=dev)
    mask = torch.ones(Tq, Tk, dtype=torch.bool, device=dev)
    if causal:
        mask = torch.arange(Tq, device=dev)[:, None] >= kj[None, :]
    mask = mask[None, None]
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
        mask = mask & (kj < lengths[:, None, None, None])
    return mask


def _p_ds(q, k, v, lse, di, do, lengths, causal, sm_scale):
    """P and dS of the backward kernels over the full [Tq, Tk] square:
    ``p = where(mask, exp(s - lse), 0)`` and ``ds = p * (dO v^T - Di)``."""
    mask = _mask(q.shape[2], k.shape[2], lengths, causal, q.device)
    s = _scores(q, k, sm_scale)
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros((), dtype=s.dtype, device=s.device))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - di[..., None])


def flash_dq_reference(q, k, v, lse, di, do, lengths=None, causal=False,
                       sm_scale=None):
    """The dq kernel's plain version: dq = sm_scale * dS k, with P
    recomputed from ``lse`` [B, H, Tq] and ``di`` = rowsum(dO * o)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _p_ds(q, k, v, lse, di, do, lengths, causal, sm_scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", _rounded(ds, k.dtype),
                      k.float()) * sm_scale
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, lse, di, do, lengths=None, causal=False,
                        sm_scale=None):
    """The dkv kernel's plain version: (dk = sm_scale * dS^T q,
    dv = P^T dO)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _p_ds(q, k, v, lse, di, do, lengths, causal, sm_scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", _rounded(ds, q.dtype),
                      q.float()) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", _rounded(p, do.dtype), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _row_dot(do, o):
    """Di = rowsum(dO * o) [B, H, Tq] f32: formed outside the kernels, as
    the JAX package leaves it to XLA."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_backward_reference(q, k, v, o, lse, do, lengths=None,
                                       causal=False, sm_scale=None):
    """The backward kernels' plain version: (dq, dk, dv) of the flash
    forward, with P recomputed from ``lse`` [B, H, Tq] exactly as the
    Pallas bodies do, ``p = where(mask, exp(s - lse), 0)``. A fully
    masked row has lse = +inf, so its P is 0 and it contributes nothing
    (never ``inf - inf``). On bf16 inputs S, dP, Di and the sums stay
    f32, P and dS are rounded to bf16 before the products that take
    them, and dq, dk, dv are rounded once, as in the Pallas kernels."""
    di = _row_dot(do, o)
    dq = flash_dq_reference(q, k, v, lse, di, do, lengths, causal, sm_scale)
    dk, dv = flash_dkv_reference(q, k, v, lse, di, do, lengths, causal,
                                 sm_scale)
    return dq, dk, dv


def _bind(lib_name, fn_name, n_ptrs):
    """(library, entry point) of a kernel library, its ctypes signature
    set: ``n_ptrs`` device pointers, the ints BH, Tq, Tk, D, causal, the
    float sm_scale and the stream."""
    from . import build

    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _aligned(t):
    """Contiguous, with a 16-byte aligned base (the kernel loads float4)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


# the head dims the tensor-core kernels are built for; the wrappers pad
# up to them, and past the last one to a multiple of _WIDE_D (192 and 256),
# in 257-512 to one of _SPLIT_HEAD_DIMS: the bf16 kernels' instances there
# split D into two halves of whole 64-column boxes between their consumer
# warpgroups, the f32 ones into four quarters between their warps; past 512
# to a multiple of _SLICE_D, so that the forward's slices of D split into
# halves (bf16) and quarters (f32) of whole 64- and 32-column boxes
KERNEL_HEAD_DIMS = (64, 128)
_WIDE_D = 64
_SPLIT_HEAD_DIMS = (384, 512)
_SLICE_D = 128
# rows of a q/k tile: the tiles lie on the grid's y axis (limit 65535);
# past D = 128 every instance owns 64 rows a block, or, the f32 ones at
# 384 and 512 and the f32 forward past 512, a pair of 32-row blocks on the
# grid's z axis, the f32 dq and dkv past 512 four 16-row blocks
_TILE_ROWS = 128
_WIDE_TILE_ROWS = 64


def _kernel_head_dim(D):
    """The head dim of the kernel instance that takes D: the smallest of
    ``KERNEL_HEAD_DIMS`` that is >= D, else D rounded up to a multiple of
    64 and, past 256, up to the smallest of ``_SPLIT_HEAD_DIMS`` that
    holds it, and past 512 up to a multiple of 128 (the same for every
    dtype and kernel: ``flash_backward`` pads once for dq and dkv)."""
    if D < 1:
        raise ValueError(f"flash kernels take head_dim >= 1, got {D}")
    for kd in KERNEL_HEAD_DIMS:
        if D <= kd:
            return kd
    if D > _SPLIT_HEAD_DIMS[-1]:
        return -(-D // _SLICE_D) * _SLICE_D
    kd = -(-D // _WIDE_D) * _WIDE_D
    if kd > 256:
        return next(sd for sd in _SPLIT_HEAD_DIMS if kd <= sd)
    return kd


def _max_t(D):
    """The longest sequence the grid's y axis holds at head dim D (past
    128 every instance takes 64 rows a y index: one block, or two 32-row
    or four 16-row blocks on z)."""
    rows = _TILE_ROWS if D <= KERNEL_HEAD_DIMS[-1] else _WIDE_TILE_ROWS
    return 65535 * rows


def _at_kernel_head_dim(fn, *tensors):
    """``fn(*tensors)`` at the kernel's head dim: every [B, H, T, D] tensor
    zero-padded along D to ``_kernel_head_dim(D)``, every 4-D output
    sliced back to D. Zero columns change no score (q.k), add zero
    columns to o, dq, dk and dv, and leave lse and Di as they are; the
    caller passes ``sm_scale`` from the true D."""
    D = tensors[0].shape[-1]
    pad = _kernel_head_dim(D) - D
    if not pad:
        return fn(*tensors)
    out = fn(*(torch.nn.functional.pad(t, (0, pad)) for t in tensors))
    if isinstance(out, torch.Tensor):
        return out[..., :D]
    return tuple(t[..., :D] if t.ndim == 4 else t for t in out)


def _check_kernel_inputs(q, k, v, *more):
    """What every flash kernel takes, checked before anything is built:
    [B, H, T, D] q/k/v all f32 or all bf16 (any D >= 1) with K/V heads
    expanded, on one device; ``more`` are tensors that must match q's
    shape and dtype (o, dO)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    max_t = _max_t(_kernel_head_dim(D))
    tensors = (q, k, v) + more
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) > 1 or dtypes - {torch.float32, torch.bfloat16}:
        raise TypeError(
            "flash kernels take q, k, v (and o, dO) all float32 or all "
            "bfloat16, got " + ", ".join(str(t.dtype) for t in tensors))
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)} (expand GQA heads "
                         "first)")
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"o/dO shapes {[tuple(t.shape) for t in more]} do "
                         f"not match q {tuple(q.shape)}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash kernel inputs must lie on one CUDA device")
    if max(Tq, Tk) > max_t:
        raise ValueError(f"sequence length {max(Tq, Tk)} exceeds the grid's "
                         f"y limit ({max_t})")


def _lens_bh(lengths, B, H, Tk, dev):
    """Per-(batch*head) K lengths, int32 [BH]."""
    if lengths is None:
        lens = torch.full((B,), Tk, dtype=torch.int32, device=dev)
    else:
        lens = torch.as_tensor(lengths, device=dev).to(torch.int32)
    return lens.repeat_interleave(H).contiguous()


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({lib.paddle_cuda_error_string(err).decode()})")


def _launch(q, k, v, lengths, causal, sm_scale):
    _check_kernel_inputs(q, k, v)

    def launch(q, k, v):
        out = _launch_fwd(q, k, v, lengths, causal, sm_scale)
        _count_launch("fwd", q)
        return out

    return _at_kernel_head_dim(launch, q, k, v)


# each dtype's kernel instances: (forward library, backward library,
# entry-point suffix, launch-counter suffix). The f32 (3xTF32) instances
# count ``flash_attention.launches`` and ``flash_backward.dq_launches``/
# ``.dkv_launches``; the bf16 ones (``csrc/flash_attention_bf16.cu``) the
# same names with ``bf16_`` before ``launches``.
_INSTANCES = {
    torch.float32: (_LIB, _LIB_BWD, "f32", "launches"),
    torch.bfloat16: (_LIB_BF16, _LIB_BF16, "bf16", "bf16_launches"),
}


def _count(fn, counter):
    """One more launch on ``fn``'s counter ``counter``."""
    setattr(fn, counter, getattr(fn, counter) + 1)


def _count_launch(kind, q):
    """One more launch of kernel ``kind`` ("fwd", "dq" or "dkv") on its
    dtype's counter."""
    fn, prefix = ((flash_attention, "") if kind == "fwd"
                  else (flash_backward, f"{kind}_"))
    _count(fn, prefix + _INSTANCES[q.dtype][3])


def _launch_fwd(q, k, v, lengths, causal, sm_scale):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    fwd_lib, _, suffix, _ = _INSTANCES[q.dtype]
    lib, fn = _bind(fwd_lib, f"paddle_flash_attention_fwd_{suffix}", 6)
    dev = q.device
    lens_bh = _lens_bh(lengths, B, H, Tk, dev)
    q3, k3, v3 = (_aligned(t) for t in (q, k, v))
    o = torch.empty_like(q3)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                 lens_bh.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 B * H, Tq, Tk, D, int(bool(causal)), float(sm_scale),
                 stream)
    _raise_on(lib, err, "flash_attention_fwd")
    return o, lse


def _check_backward_inputs(q, k, v, lse, di, do):
    _check_kernel_inputs(q, k, v, do)
    want = tuple(q.shape[:3])
    for name, t in (("lse", lse), ("di", di)):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [B, H, Tq] = {want}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def _launch_bwd(kind, outs, q, k, v, lse, di, do, lengths, causal,
                sm_scale):
    """Launch the backward kernel ``kind`` ("dq" or "dkv") of q's dtype on
    the current stream, writing ``outs``."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    _, bwd_lib, suffix, _ = _INSTANCES[q.dtype]
    fn_name = f"paddle_flash_attention_bwd_{kind}_{suffix}"
    lib, fn = _bind(bwd_lib, fn_name, 7 + len(outs))
    dev = q.device
    lens_bh = _lens_bh(lengths, B, H, Tk, dev)
    q3, k3, v3, do3 = (_aligned(t) for t in (q, k, v, do))
    lse3, di3 = lse.contiguous(), di.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
                 lse3.data_ptr(), di3.data_ptr(), lens_bh.data_ptr(),
                 *(t.data_ptr() for t in outs), B * H, Tq, Tk, D,
                 int(bool(causal)), float(sm_scale), stream)
    _raise_on(lib, err, fn_name)


def _launch_dq(q, k, v, lse, di, do, lengths, causal, sm_scale):
    _check_backward_inputs(q, k, v, lse, di, do)

    def launch(q, k, v, do):
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _launch_bwd("dq", (dq,), q, k, v, lse, di, do, lengths, causal,
                    sm_scale)
        _count_launch("dq", q)
        return dq

    return _at_kernel_head_dim(launch, q, k, v, do)


def _launch_dkv(q, k, v, lse, di, do, lengths, causal, sm_scale):
    _check_backward_inputs(q, k, v, lse, di, do)

    def launch(q, k, v, do):
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        _launch_bwd("dkv", (dk, dv), q, k, v, lse, di, do, lengths, causal,
                    sm_scale)
        _count_launch("dkv", q)
        return dk, dv

    return _at_kernel_head_dim(launch, q, k, v, do)


def _plain_device(t):
    """True where a wrapper runs the plain version: a CPU tensor computes
    it, a meta tensor (build-time shape inference) only shapes it. A
    CUDA tensor takes the kernel; any other device raises."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                         f"{t.device.type}")
    return False


def flash_forward(q, k, v, lengths=None, causal=False, sm_scale=None):
    """(o [B, H, Tq, D], lse [B, H, Tq] f32) over [B, H, T, D] tensors:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU or
    meta one. ``lengths`` [B] masks K/V columns at and past each row's
    length."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _plain_device(q):
        return flash_attention_reference(q, k, v, lengths, causal, sm_scale)
    return _launch(q, k, v, lengths, causal, sm_scale)


def flash_dq(q, k, v, lse, di, do, lengths=None, causal=False,
             sm_scale=None):
    """dq of the flash forward given lse and Di = rowsum(dO * o), both
    [B, H, Tq] f32: the dq CUDA kernel for a CUDA tensor, the plain
    version for a CPU or meta one."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _plain_device(q):
        return flash_dq_reference(q, k, v, lse, di, do, lengths, causal,
                                  sm_scale)
    return _launch_dq(q, k, v, lse, di, do, lengths, causal, sm_scale)


def flash_dkv(q, k, v, lse, di, do, lengths=None, causal=False,
              sm_scale=None):
    """(dk, dv) of the flash forward: the dkv CUDA kernel for a CUDA
    tensor, the plain version for a CPU or meta one."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _plain_device(q):
        return flash_dkv_reference(q, k, v, lse, di, do, lengths, causal,
                                   sm_scale)
    return _launch_dkv(q, k, v, lse, di, do, lengths, causal, sm_scale)


def flash_backward(q, k, v, o, lse, do, lengths=None, causal=False,
                   sm_scale=None):
    """(dq, dk, dv) of the flash forward given its o and lse and the
    output gradient ``do``: Di = rowsum(dO * o) in torch, then the dq and
    the dkv kernel (their plain versions for a CPU or meta tensor).
    ``flash_backward.dq_launches``/``.dkv_launches`` count the kernels'
    launches."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _plain_device(q):
        return flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  lengths, causal, sm_scale)
    _check_kernel_inputs(q, k, v, o, do)  # refuse before any work

    def kernels(q, k, v, o, do):  # padded once for both kernels
        # dO arrives through transpose(1, 2).reshape(...): copy it (and
        # any unaligned input) once for both kernels
        q, k, v, do = (_aligned(t) for t in (q, k, v, do))
        di = _row_dot(do, o)
        return (_launch_dq(q, k, v, lse, di, do, lengths, causal, sm_scale),
                *_launch_dkv(q, k, v, lse, di, do, lengths, causal,
                             sm_scale))

    return _at_kernel_head_dim(kernels, q, k, v, o, do)


flash_backward.dq_launches = 0
flash_backward.dkv_launches = 0
flash_backward.dq_bf16_launches = 0
flash_backward.dkv_bf16_launches = 0


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, saving q, k,
    v, o and lse; the backward is ``flash_backward`` (the counterpart of
    the JAX package's ``_attention`` custom_vjp). In the ``setup_context``
    form, so ``torch.func`` transforms can see through it."""

    @staticmethod
    def forward(q, k, v, lengths, causal, sm_scale):
        return flash_forward(q, k, v, lengths, causal, sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, lengths, causal, sm_scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.lengths, ctx.causal, ctx.sm_scale = lengths, causal, sm_scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.lengths,
                                    ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, lengths=None, causal=False, sm_scale=None):
    """Scaled-dot-product attention over [B, H, T, D] tensors: the
    sm_90a flash kernels on CUDA, their plain versions on the CPU;
    differentiable through ``_FlashAttention``.
    ``flash_attention.launches`` counts the forward kernel's launches."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, lengths, causal,
                                 float(sm_scale))[0]


flash_attention.launches = 0
flash_attention.bf16_launches = 0
