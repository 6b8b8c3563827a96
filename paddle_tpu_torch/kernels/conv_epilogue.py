"""Fused 1x1-conv + batch-norm epilogue: hand-written sm_90a CUDA kernels.

Counterpart of ``paddle_tpu/kernels/conv_epilogue.py``. The TPU kernels it
replaces, each launched through ``pl.pallas_call``, all in
``csrc/conv_epilogue.cu``:

- ``conv1x1_stats`` (``_stats_kernel``): y = x . W for [R, I] x [I, O]
  plus the per-channel sum and sum of squares of that y, in f32, from the
  same pass, so training-mode BN never re-reads y for its statistics. The
  TPU carried the sums across its sequential grid in VMEM; CUDA blocks run
  in no order, so each 128-row tile writes partial sums and a second small
  kernel adds them in a fixed order (deterministic, no float atomics).
- ``conv1x1_epilogue`` (``_epilogue_kernel``): act((x . W) * scale + shift
  [+ residual]) for inference: the affine, residual and relu ride the GEMM
  tile's epilogue and the raw product never reaches device memory.
- ``scale_shift_act`` (``_apply_kernel``): act(y * scale + shift
  [+ residual]) in one read and one write of [R, O].

What bounds them on the H100: the two GEMM kernels do 2*R*I*O FLOPs on
4*(R*I + I*O + R*O) bytes, above the card's f32 FLOP:byte ridge once I and
O reach 128 (bound by operations; by bytes at 64). They run a 128 x 128
output tile per 256-thread block with 8 x 8 register tiles on CUDA cores
(f32 FMA; tensor cores are later work), sharing one main loop.
``scale_shift_act`` is bound by bytes and moves float4s when O % 4 == 0.
Every R, I and O is taken: ragged edges are masked in the kernels, where
the TPU wrappers fall back to XLA when ``_pick_block_r`` finds no tile.

Every wrapper dispatches on the tensor's device: a CPU tensor runs the
plain version (``*_reference``), a meta tensor (build-time shape
inference) runs it too and computes nothing, and a CUDA tensor launches
the kernel or raises. ``conv1x1_stats.launches``,
``conv1x1_epilogue.launches`` and ``scale_shift_act.launches`` count the
launches.
"""
from __future__ import annotations

import ctypes

import torch

_LIB = "conv_epilogue"
_INT_MAX = 2**31 - 1


# --- the plain versions -----------------------------------------------------
def _affine_act(y, scale, shift, residual, act):
    """act(y * scale + shift [+ residual]) in f32, as the Pallas bodies
    compute it."""
    y = y.float() * scale.float() + shift.float()
    if residual is not None:
        y = y + residual.float()
    if act == "relu":
        y = torch.relu(y)
    return y


def conv1x1_stats_reference(x2, w):
    """(y = x2 @ w in x2's dtype, stats [2, O] f32 = (sum y, sum y*y))."""
    y = torch.matmul(x2, w)
    yf = y.float()
    return y.to(x2.dtype), torch.stack([yf.sum(0), (yf * yf).sum(0)])


def conv1x1_epilogue_reference(x2, w, scale, shift, residual=None, act=None):
    """act((x2 @ w) * scale + shift [+ residual]) in x2's dtype."""
    return _affine_act(torch.matmul(x2, w), scale, shift, residual,
                       act).to(x2.dtype)


def scale_shift_act_reference(y_raw, scale, shift, residual=None, act=None):
    """act(y_raw * scale + shift [+ residual]) in y_raw's dtype."""
    return _affine_act(y_raw, scale, shift, residual, act).to(y_raw.dtype)


# --- the CUDA launches ------------------------------------------------------
_ARGTYPES = {
    # x, w, y, partial, stats, R, I, O, stream
    "paddle_conv1x1_stats_f32": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    # x, w, scale, shift, residual, out, R, I, O, relu, stream
    "paddle_conv1x1_epilogue_f32": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    # y, scale, shift, residual, out, R (long long), O, relu, stream
    "paddle_scale_shift_act_f32": [ctypes.c_void_p] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _bind(fn_name):
    """(library, entry point) with its ctypes signature set."""
    from . import build

    lib = build.load(_LIB)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        lib.paddle_conv1x1_row_tile.restype = ctypes.c_int
    return lib, fn


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({lib.paddle_cuda_error_string(err).decode()})")


def _aligned(t):
    """Contiguous, with a 16-byte aligned base (the kernels move float4)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check(what, x, w, vecs=(), residual=None):
    """What the kernels take, checked before anything is built: f32
    ``x`` [R, I] and ``w`` [I, O] (``w`` None for scale_shift_act, whose
    ``x`` is [R, O]), [O] scale/shift and an [R, O] residual, all on one
    CUDA device, with R, I and O inside an int."""
    mats = [t for t in (x, w) if t is not None]
    tensors = mats + list(vecs) + ([residual] if residual is not None
                                   else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} takes float32 tensors, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what} inputs must lie on one CUDA device")
    if any(t.ndim != 2 for t in mats):
        raise ValueError(f"{what} takes 2-D matrices, got "
                         f"{[tuple(t.shape) for t in mats]}")
    R, O = x.shape[0], (x.shape[1] if w is None else w.shape[1])
    if w is not None and w.shape[0] != x.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    for t in vecs:
        if tuple(t.shape) != (O,):
            raise ValueError(f"{what}: scale/shift must be [{O}], got "
                             f"{tuple(t.shape)}")
    if residual is not None and tuple(residual.shape) != (R, O):
        raise ValueError(f"{what}: residual must be [{R}, {O}], got "
                         f"{tuple(residual.shape)}")
    if max(R, O, x.shape[1]) > _INT_MAX:
        raise ValueError(f"{what}: a dimension of {tuple(x.shape)} x "
                         f"{O} exceeds an int")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_stats(x2, w):
    _check("conv1x1_stats", x2, w)
    (R, I), O = x2.shape, w.shape[1]
    lib, fn = _bind("paddle_conv1x1_stats_f32")
    dev = x2.device
    x2, w = _aligned(x2), _aligned(w)
    tiles = -(-R // lib.paddle_conv1x1_row_tile())
    y = torch.empty((R, O), dtype=torch.float32, device=dev)
    partial = torch.empty((tiles, 2, O), dtype=torch.float32, device=dev)
    stats = torch.empty((2, O), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), stats.data_ptr(), R, I, O, _stream(dev))
    _raise_on(lib, err, "conv1x1_stats")
    conv1x1_stats.launches += 1
    return y, stats


def _f32_vec(t):
    return _aligned(t.float())


def _launch_epilogue(x2, w, scale, shift, residual, act):
    scale, shift = _f32_vec(scale), _f32_vec(shift)
    _check("conv1x1_epilogue", x2, w, (scale, shift), residual)
    (R, I), O = x2.shape, w.shape[1]
    lib, fn = _bind("paddle_conv1x1_epilogue_f32")
    dev = x2.device
    x2, w = _aligned(x2), _aligned(w)
    res = None if residual is None else _aligned(residual)
    out = torch.empty((R, O), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), None if res is None else res.data_ptr(),
                 out.data_ptr(), R, I, O, int(act == "relu"), _stream(dev))
    _raise_on(lib, err, "conv1x1_epilogue")
    conv1x1_epilogue.launches += 1
    return out


def _launch_apply(y_raw, scale, shift, residual, act):
    scale, shift = _f32_vec(scale), _f32_vec(shift)
    _check("scale_shift_act", y_raw, None, (scale, shift), residual)
    R, O = y_raw.shape
    lib, fn = _bind("paddle_scale_shift_act_f32")
    dev = y_raw.device
    y = _aligned(y_raw)
    res = None if residual is None else _aligned(residual)
    out = torch.empty((R, O), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 None if res is None else res.data_ptr(), out.data_ptr(),
                 R, O, int(act == "relu"), _stream(dev))
    _raise_on(lib, err, "scale_shift_act")
    scale_shift_act.launches += 1
    return out


def _plain_device(t):
    """True where a wrapper runs the plain version: a CPU tensor computes
    it, a meta tensor (build-time shape inference) only shapes it. A
    CUDA tensor takes the kernel; any other device raises."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type != "cuda":
        raise ValueError(f"conv_epilogue runs on cuda, cpu or meta, not "
                         f"{t.device.type}")
    return False


# --- the wrappers -----------------------------------------------------------
def conv1x1_stats(x2, w):
    """(y_raw = x2 @ w [R, O], stats [2, O] f32 = (sum y, sum y*y)): the
    CUDA kernels for a CUDA tensor, the plain version for a CPU or meta
    one."""
    if _plain_device(x2):
        return conv1x1_stats_reference(x2, w)
    return _launch_stats(x2, w)


def conv1x1_epilogue(x2, w, scale, shift, residual=None, act=None):
    """act((x2 @ w) * scale + shift [+ residual]) with the raw product never
    written: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU or meta one. scale/shift are the folded BN affine ([O] f32)."""
    if _plain_device(x2):
        return conv1x1_epilogue_reference(x2, w, scale, shift, residual, act)
    return _launch_epilogue(x2, w, scale, shift, residual, act)


def scale_shift_act(y_raw, scale, shift, residual=None, act=None):
    """act(y_raw * scale + shift [+ residual]) in one pass: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU or meta one."""
    if _plain_device(y_raw):
        return scale_shift_act_reference(y_raw, scale, shift, residual, act)
    return _launch_apply(y_raw, scale, shift, residual, act)


conv1x1_stats.launches = 0
conv1x1_epilogue.launches = 0
scale_shift_act.launches = 0
