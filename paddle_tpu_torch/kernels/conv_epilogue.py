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
  tile's epilogue and the raw product never reaches device memory, unless
  the tile plan splits K (small grids), when the slices' partial products
  do and are added in a fixed order before the affine.
- ``scale_shift_act`` (``_apply_kernel``): act(y * scale + shift
  [+ residual]) in one read and one write of [R, O].

Each kernel has two instances, chosen by x's dtype, as the Pallas
kernels take either, and the two GEMM kernels a third, chosen by the
precision policy (``ops/common.py``), as the Pallas bodies take
``precision``:

- f32 (AMP off): the two GEMM kernels do 2*R*I*O FLOPs on
  4*(R*I + I*O + R*O) bytes: bound by operations once I and O reach 128,
  by bytes at I = 64. They run their products on the tensor cores as
  3xTF32 ``wgmma`` (f32 accuracy: each operand split into a tf32 hi and
  lo, three products summed), W split once per launch by a pre-pass, x
  split by the thread that reads it, sharing one main loop over a ring
  of 32-deep K stages. That is the instance of the policies ``high`` and
  ``highest``.
- 1xTF32 (f32 operands under the policy ``default``, the Pallas bodies'
  ``precision=None``: the backend's fast path, as XLA's ``DEFAULT`` on
  this card): the same kernel with each operand rounded once to tf32
  (round to nearest, ties away from zero, as ``cvt.rna.tf32.f32``: x by
  the thread that reads it, W by its pre-pass, which writes only the
  rounded copy) and one ``wgmma`` a k8 step. The statistics, the
  epilogue and the tile plan are the 3xTF32 instance's. At the tensor
  cores' dense TF32 rate (494.7 TFLOP/s) the ridge is ~148 FLOP/byte,
  about I*O/(2(I+O)) at large R: bound by bytes at ResNet-50's shapes
  with I or O <= 256, by operations at 512 x 1024 and up. Its plain
  version
  (``*_tf32_reference``) rounds the operands the same way and multiplies
  them in f32.
- bf16 (AMP on, ``ops/common.py``): x and W in bf16, scale and shift in
  f32, a residual in bf16 or f32 (the transpiled serving program's
  BN-folded shortcuts add an f32 bias), the output in bf16. One bf16
  ``wgmma`` (k16) per product, both operands read by TMA as they are
  stored (x K-major, W [I, O] MN-major), over 64-deep K stages; the
  products accumulate in f32, the statistics are summed from that f32
  accumulator and the affine, residual and relu applied in f32, and only
  the output is rounded to bf16, as the Pallas bodies compute it
  (``preferred_element_type=jnp.float32``). Half the bytes of the f32
  instance and the tensor cores' full bf16 rate: bound by bytes where
  I*O/(I+O) is below ~300 (ResNet-50's shapes with I or O <= 256), by
  operations above. At those shapes a 128 x BN tile is one to a few K
  stages, so its epilogue, not its products, is what a tile costs beyond
  its bytes. The kernel is persistent and warp-specialised: ``grid``
  blocks of the plan (one an SM, or one a work item where there are
  fewer) each walk work items (tile, K slice), a producer warpgroup
  streams their stages through a TMA ring across item boundaries while
  the consumers run an item's epilogue, and outputs leave by TMA stores.

``tile_plan`` sizes the grid from (R, I, O): 64-wide tiles when O <= 64,
and, for the epilogue, K cut into slices where the output tiles fill less
than one wave of the SMs (the slices are added in a fixed order); the bf16
kernel's persistent ``grid`` and its walk order follow from the plan
(``TilePlan.grid``).
``scale_shift_act`` is bound by bytes and moves four values a thread
when O % 4 == 0. Every R, I and O is taken: ragged edges are handled in
the kernels (a bf16 row whose stride is not a multiple of 16 bytes, which
TMA does not take, is padded by the wrapper), where the TPU wrappers fall
back to XLA when ``_pick_block_r`` finds no tile.

Every wrapper dispatches on the tensor's device: a CPU tensor runs the
plain version (``*_reference``), a meta tensor (build-time shape
inference) runs it too and computes nothing, and a CUDA tensor launches
the instance of its dtypes (and, for f32, of the policy) or raises,
naming them. ``conv1x1_stats.launches``, ``conv1x1_epilogue.launches``
and ``scale_shift_act.launches`` count the f32 instances' launches (the
GEMMs' 3xTF32 ones), ``conv1x1_stats.tf32_launches`` and
``conv1x1_epilogue.tf32_launches`` the 1xTF32 ones, ``.bf16_launches``
the bf16 ones. On the CPU every policy runs the f32 plain version, as
XLA's CPU backend computes every precision in f32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

_LIB = "conv_epilogue"
_INT_MAX = 2**31 - 1

# --- the tile plan ----------------------------------------------------------
ROW_TILE = 128        # output rows per block (csrc: BM)
K_TILE = 32           # K depth of one f32 ring stage (csrc: BK)
K_TILE_BF16 = 64      # K depth of one bf16 ring stage (csrc: BK16)
SMS = 132             # streaming multiprocessors of an H100 SXM
MIN_SLICE_STEPS = 4   # a split-K slice runs at least 4 f32 stages (128 deep)
BLOCKS_PER_SM_BF16 = 1  # the bf16 kernel's 384-thread blocks an SM


class TilePlan(NamedTuple):
    """How the GEMM kernels cut one [R, I] x [I, O] product."""
    bn: int           # output columns per block: 64 or 128
    tiles_r: int      # row tiles, ceil(R / ROW_TILE)
    tiles_o: int      # column tiles, ceil(O / bn)
    slices: int       # K slices (split-K; 1 = none)
    slice_steps: int  # K_TILE-deep steps per slice
    i_pad: int        # I rounded up to K_TILE
    o_pad: int        # O rounded up to bn

    @property
    def wt_shape(self) -> Tuple[int, int, int]:
        """W's hi and lo copies, transposed and padded."""
        return (2, self.o_pad, self.i_pad)

    @property
    def wt_shape_tf32(self) -> Tuple[int, int, int]:
        """W's rounded copy (the 1xTF32 instance), transposed and
        padded."""
        return (1, self.o_pad, self.i_pad)

    def partial_shape(self, O: int) -> Tuple[int, int, int]:
        """Per-row-tile BN sums of ``conv1x1_stats``."""
        return (self.tiles_r, 2, O)

    def slices_shape(self, R: int, O: int) -> Optional[Tuple[int, int, int]]:
        """The split-K partial products, or None without a split."""
        return (self.slices, R, O) if self.slices > 1 else None

    @property
    def work(self) -> int:
        """Work items of the bf16 kernel's walk: (row tile, column tile,
        K slice)."""
        return self.tiles_r * self.tiles_o * self.slices

    @property
    def grid(self) -> int:
        """Blocks of the bf16 kernel's persistent grid: one a work item,
        at most BLOCKS_PER_SM_BF16 on each of the SMS SMs. Block b walks
        the items b, b + grid, ... (column tiles fastest, then row tiles,
        then slices), so the blocks at work at one moment share x's
        rows."""
        return max(1, min(self.work, SMS * BLOCKS_PER_SM_BF16))


def tile_plan(R, I, O, split_k=False, k_tile=K_TILE):
    """The kernels' grid for an [R, I] x [I, O] product: 64-wide tiles
    when O <= 64 (no half tile of padding), else 128. With ``split_k``
    (the epilogue; the stats need none at ResNet's shapes), where the
    128-row tiles fill less than one wave of the SMS SMs, K is cut into
    slices at least 128 deep (MIN_SLICE_STEPS f32 stages). ``k_tile`` is
    a stage's depth: K_TILE (f32: one block a tile, so slices until the
    tiles fill a wave) or K_TILE_BF16 (the persistent kernel: as many
    slices as keep every item in one round of its grid, so no block runs
    a second item while others idle)."""
    bn = 64 if O <= 64 else 128
    tiles_r, tiles_o = -(-R // ROW_TILE), -(-O // bn)
    k_steps = -(-I // k_tile)
    min_steps = MIN_SLICE_STEPS * K_TILE // k_tile
    slices = 1
    tiles = tiles_r * tiles_o
    if split_k and 0 < tiles < SMS and k_tile == K_TILE_BF16:
        slices = max(1, min(SMS * BLOCKS_PER_SM_BF16 // tiles,
                            k_steps // min_steps))
    elif split_k and 0 < tiles < SMS:
        slices = max(1, min(-(-SMS // tiles), k_steps // min_steps))
    slice_steps = -(-k_steps // slices) if k_steps else 0
    slices = -(-k_steps // slice_steps) if slice_steps else 1
    return TilePlan(bn, tiles_r, tiles_o, slices, slice_steps,
                    k_steps * k_tile, tiles_o * bn)


# --- the plain versions -----------------------------------------------------
# What the Pallas bodies compute, for f32 and bf16 operands alike: the
# product of the operands upcast to f32 (a product of two bf16 values is
# exact in f32), summed in f32 (``preferred_element_type=jnp.float32``);
# statistics from that f32 product, the affine, residual and relu in f32;
# only the output rounded to the operands' dtype.
def _affine_act(y, scale, shift, residual, act):
    """act(y * scale + shift [+ residual]) in f32, as the Pallas bodies
    compute it."""
    y = y.float() * scale.float() + shift.float()
    if residual is not None:
        y = y + residual.float()
    if act == "relu":
        y = torch.relu(y)
    return y


def _f32_product(x2, w):
    return torch.matmul(x2.float(), w.float())


def conv1x1_stats_reference(x2, w):
    """(y = x2 @ w in x2's dtype, stats [2, O] f32 = (sum y, sum y*y) of
    the f32 product, before y is rounded)."""
    y = _f32_product(x2, w)
    return y.to(x2.dtype), torch.stack([y.sum(0), (y * y).sum(0)])


def conv1x1_epilogue_reference(x2, w, scale, shift, residual=None, act=None):
    """act((x2 @ w) * scale + shift [+ residual]) in x2's dtype."""
    return _affine_act(_f32_product(x2, w), scale, shift, residual,
                       act).to(x2.dtype)


def scale_shift_act_reference(y_raw, scale, shift, residual=None, act=None):
    """act(y_raw * scale + shift [+ residual]) in y_raw's dtype."""
    return _affine_act(y_raw, scale, shift, residual, act).to(y_raw.dtype)


# The 1xTF32 instance's plain versions: each f32 operand rounded to tf32
# as the kernels round it, then an f32 product (the products of two tf32
# values are exact in f32; only the order of the f32 sums differs from
# the tensor cores'). For holding the kernels on the card, not for the
# main path, which runs the kernels there and the f32 product on the CPU.
def round_tf32(t):
    """f32 ``t`` rounded to tf32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: +0x1000 on the bit pattern
    and the low 13 bits cleared (a carry into the exponent is the right
    rounding, up to infinity past the largest tf32). NaN stays NaN."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2**31, r - 2**32, r).to(torch.int32)
    return torch.where(torch.isnan(t), t, r.view(torch.float32))


def _tf32_product(x2, w):
    from ..ops.common import library_precision

    with library_precision(False):
        return torch.matmul(round_tf32(x2), round_tf32(w))


def conv1x1_stats_tf32_reference(x2, w):
    """``conv1x1_stats_reference`` of f32 operands with the 1xTF32
    kernel's rounding."""
    y = _tf32_product(x2, w)
    return y, torch.stack([y.sum(0), (y * y).sum(0)])


def conv1x1_epilogue_tf32_reference(x2, w, scale, shift, residual=None,
                                    act=None):
    """``conv1x1_epilogue_reference`` of f32 operands with the 1xTF32
    kernel's rounding."""
    return _affine_act(_tf32_product(x2, w), scale, shift, residual, act)


# --- the CUDA launches ------------------------------------------------------
_ARGTYPES = {
    # x, w, wt, y, partial, stats, R, I, O, bn, stream
    "paddle_conv1x1_stats_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    # x, w, wt, scale, shift, residual, out, slice_out, R, I, O, relu, bn,
    # slices, slice_steps, stream
    "paddle_conv1x1_epilogue_f32": [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    # the 1xTF32 instances take the 3xTF32 ones' arguments
    "paddle_conv1x1_stats_tf32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "paddle_conv1x1_epilogue_tf32": [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    # y, scale, shift, residual, out, R (long long), O, relu, stream
    "paddle_scale_shift_act_f32": [ctypes.c_void_p] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    # x, w, y, partial, stats, R, I, O, ldx, ldw, bn, grid, stream
    "paddle_conv1x1_stats_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    # x, w, scale, shift, residual, out, slice_out, R, I, O, ldx, ldw,
    # res_f32, relu, bn, slices, slice_steps, grid, stream
    "paddle_conv1x1_epilogue_bf16": [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 11 + [ctypes.c_void_p],
    # y, scale, shift, residual, out, R (long long), O, res_f32, relu,
    # stream
    "paddle_scale_shift_act_bf16": [ctypes.c_void_p] * 5
    + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
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
        tiles = (lib.paddle_conv1x1_row_tile(), lib.paddle_conv1x1_k_tile(),
                 lib.paddle_conv1x1_k_tile_bf16(),
                 lib.paddle_conv1x1_blocks_per_sm_bf16())
        want = (ROW_TILE, K_TILE, K_TILE_BF16, BLOCKS_PER_SM_BF16)
        if tiles != want:
            raise RuntimeError(f"{_LIB} was built with tiles and blocks an "
                               f"SM {tiles}, the plan expects {want}")
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
    """What the kernels take, checked before anything is built: ``x``
    [R, I] and ``w`` [I, O] (``w`` None for scale_shift_act, whose ``x``
    is [R, O]), [O] scale/shift and an [R, O] residual, all on one CUDA
    device, with R, I and O inside an int. The dtypes are one of the two
    instances': all f32; or x and w bf16, scale and shift f32 and the
    residual bf16 or f32, as the Pallas kernels take them under AMP. Any
    other mix raises, naming the dtypes."""
    mats = [t for t in (x, w) if t is not None]
    tensors = mats + list(vecs) + ([residual] if residual is not None
                                   else [])
    f32, bf16 = torch.float32, torch.bfloat16
    ok = (all(t.dtype == f32 for t in tensors)
          or (all(t.dtype == bf16 for t in mats)
              and all(t.dtype == f32 for t in vecs)
              and (residual is None or residual.dtype in (f32, bf16))))
    if not ok:
        names = ["x", "w"] if w is not None else ["y"]
        names += ["scale", "shift"][:len(vecs)]
        names += ["residual"] if residual is not None else []
        raise TypeError(
            f"{what} takes all-float32 tensors, or bfloat16 "
            f"{' and '.join(names[:len(mats)])} with float32 scale/shift "
            f"and a bfloat16 or float32 residual; got "
            + ", ".join(f"{n} {t.dtype}" for n, t in zip(names, tensors)))
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


def _empty(shape, dev, dtype=torch.float32):
    return None if shape is None else torch.empty(shape, dtype=dtype,
                                                  device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tma_rows(t):
    """(t, its row stride in values): a bf16 matrix whose rows TMA can
    read, i.e. whose stride is a multiple of 16 bytes. Ragged widths get
    zero columns (the kernels read only the true width)."""
    pad = -t.shape[1] % 8
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    return _aligned(t), t.shape[1]


def _launch_stats_bf16(x2, w):
    (R, I), O = x2.shape, w.shape[1]
    lib, fn = _bind("paddle_conv1x1_stats_bf16")
    dev = x2.device
    (x2, ldx), (w, ldw) = _tma_rows(x2), _tma_rows(w)
    plan = tile_plan(R, I, O, k_tile=K_TILE_BF16)
    partial = _empty(plan.partial_shape(O), dev)
    y = _empty((R, O), dev, torch.bfloat16)
    stats = _empty((2, O), dev)
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), stats.data_ptr(), R, I, O, ldx, ldw,
                 plan.bn, plan.grid, _stream(dev))
    _raise_on(lib, err, "conv1x1_stats")
    conv1x1_stats.bf16_launches += 1
    return y, stats


def _launch_stats(x2, w, tf32=False):
    _check("conv1x1_stats", x2, w)
    if x2.dtype == torch.bfloat16:
        return _launch_stats_bf16(x2, w)
    (R, I), O = x2.shape, w.shape[1]
    lib, fn = _bind("paddle_conv1x1_stats_tf32" if tf32 else
                    "paddle_conv1x1_stats_f32")
    dev = x2.device
    x2, w = _aligned(x2), _aligned(w)
    plan = tile_plan(R, I, O)
    wt = _empty(plan.wt_shape_tf32 if tf32 else plan.wt_shape, dev)
    partial = _empty(plan.partial_shape(O), dev)
    y = _empty((R, O), dev)
    stats = _empty((2, O), dev)
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), w.data_ptr(), wt.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), stats.data_ptr(), R, I, O, plan.bn,
                 _stream(dev))
    _raise_on(lib, err, "conv1x1_stats")
    if tf32:
        conv1x1_stats.tf32_launches += 1
    else:
        conv1x1_stats.launches += 1
    return y, stats


def _f32_vec(t):
    return _aligned(t.float())


def _launch_epilogue_bf16(x2, w, scale, shift, residual, act):
    (R, I), O = x2.shape, w.shape[1]
    lib, fn = _bind("paddle_conv1x1_epilogue_bf16")
    dev = x2.device
    (x2, ldx), (w, ldw) = _tma_rows(x2), _tma_rows(w)
    res = None if residual is None else _aligned(residual)
    plan = tile_plan(R, I, O, split_k=True, k_tile=K_TILE_BF16)
    slices = _empty(plan.slices_shape(R, O), dev)
    out = _empty((R, O), dev, torch.bfloat16)
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), _ptr(res), out.data_ptr(), _ptr(slices),
                 R, I, O, ldx, ldw,
                 int(res is not None and res.dtype == torch.float32),
                 int(act == "relu"), plan.bn, plan.slices, plan.slice_steps,
                 plan.grid, _stream(dev))
    _raise_on(lib, err, "conv1x1_epilogue")
    conv1x1_epilogue.bf16_launches += 1
    return out


def _launch_epilogue(x2, w, scale, shift, residual, act, tf32=False):
    scale, shift = _f32_vec(scale), _f32_vec(shift)
    _check("conv1x1_epilogue", x2, w, (scale, shift), residual)
    if x2.dtype == torch.bfloat16:
        return _launch_epilogue_bf16(x2, w, scale, shift, residual, act)
    (R, I), O = x2.shape, w.shape[1]
    lib, fn = _bind("paddle_conv1x1_epilogue_tf32" if tf32 else
                    "paddle_conv1x1_epilogue_f32")
    dev = x2.device
    x2, w = _aligned(x2), _aligned(w)
    res = None if residual is None else _aligned(residual)
    plan = tile_plan(R, I, O, split_k=True)
    wt = _empty(plan.wt_shape_tf32 if tf32 else plan.wt_shape, dev)
    slices = _empty(plan.slices_shape(R, O), dev)
    out = _empty((R, O), dev)
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), w.data_ptr(), wt.data_ptr(),
                 scale.data_ptr(), shift.data_ptr(), _ptr(res),
                 out.data_ptr(), _ptr(slices), R, I, O, int(act == "relu"),
                 plan.bn, plan.slices, plan.slice_steps, _stream(dev))
    _raise_on(lib, err, "conv1x1_epilogue")
    if tf32:
        conv1x1_epilogue.tf32_launches += 1
    else:
        conv1x1_epilogue.launches += 1
    return out


def _launch_apply(y_raw, scale, shift, residual, act):
    scale, shift = _f32_vec(scale), _f32_vec(shift)
    _check("scale_shift_act", y_raw, None, (scale, shift), residual)
    R, O = y_raw.shape
    bf16 = y_raw.dtype == torch.bfloat16
    lib, fn = _bind("paddle_scale_shift_act_bf16" if bf16 else
                    "paddle_scale_shift_act_f32")
    dev = y_raw.device
    y = _aligned(y_raw)
    res = None if residual is None else _aligned(residual)
    out = _empty((R, O), dev, y_raw.dtype)
    args = [y.data_ptr(), scale.data_ptr(), shift.data_ptr(), _ptr(res),
            out.data_ptr(), R, O]
    if bf16:
        args.append(int(res is not None and res.dtype == torch.float32))
    with torch.cuda.device(dev):
        err = fn(*args, int(act == "relu"), _stream(dev))
    _raise_on(lib, err, "scale_shift_act")
    if bf16:
        scale_shift_act.bf16_launches += 1
    else:
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


def _tf32_instance(x2):
    """True where f32 operands take the 1xTF32 instance: the policy is
    ``default``."""
    from ..ops.common import mxu_precision

    return x2.dtype == torch.float32 and mxu_precision() is None


# --- the wrappers -----------------------------------------------------------
def conv1x1_stats(x2, w):
    """(y_raw = x2 @ w [R, O] in x2's dtype, stats [2, O] f32 = (sum y,
    sum y*y) of the f32 product): the CUDA kernels for a CUDA tensor (f32
    in 1xTF32 under the policy ``default``, 3xTF32 otherwise), the plain
    version for a CPU or meta one."""
    if _plain_device(x2):
        return conv1x1_stats_reference(x2, w)
    return _launch_stats(x2, w, _tf32_instance(x2))


def conv1x1_epilogue(x2, w, scale, shift, residual=None, act=None):
    """act((x2 @ w) * scale + shift [+ residual]) in x2's dtype with the
    raw product never written: the CUDA kernel for a CUDA tensor (f32 in
    1xTF32 under the policy ``default``, 3xTF32 otherwise), the plain
    version for a CPU or meta one. scale/shift are the folded BN affine
    ([O] f32)."""
    if _plain_device(x2):
        return conv1x1_epilogue_reference(x2, w, scale, shift, residual, act)
    return _launch_epilogue(x2, w, scale, shift, residual, act,
                            _tf32_instance(x2))


def scale_shift_act(y_raw, scale, shift, residual=None, act=None):
    """act(y_raw * scale + shift [+ residual]) in one pass, in f32, out in
    y_raw's dtype: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU or meta one."""
    if _plain_device(y_raw):
        return scale_shift_act_reference(y_raw, scale, shift, residual, act)
    return _launch_apply(y_raw, scale, shift, residual, act)


# launches of the f32 instances (.launches: the GEMMs' 3xTF32 ones), of
# the GEMMs' 1xTF32 ones (.tf32_launches) and of the bf16 ones
for _wrapper in (conv1x1_stats, conv1x1_epilogue, scale_shift_act):
    _wrapper.launches = 0
    _wrapper.bf16_launches = 0
conv1x1_stats.tf32_launches = conv1x1_epilogue.tf32_launches = 0
del _wrapper
