"""The arithmetic and the tile plan of the port's conv-epilogue GEMM
kernels, emulated on the CPU.

``conv1x1_stats`` and ``conv1x1_epilogue`` run their products on the
tensor cores as 3xTF32: each f32 operand splits into a tf32 hi (x rounded
to nearest, ties away, through the int32 view) and lo = x - hi (read
truncated to tf32), and each product sums lo.hi + hi.lo + hi.hi. The
kernels sum each 32-deep K stage in fresh registers and add the stages to
the tile's sum in f32, in K order; a split K's slices are added in their
fixed order; the BN statistics are summed per 128-row tile (two rows per
thread, a shuffle tree over 8 lanes, 8 warps in order) and the tiles in
the fixed order of ``stats_reduce_kernel``. Emulated so at every K of
ResNet-50's 1x1 convs, the GEMM and its statistics lie within
chip_smoke.py's tolerances of the plain versions
(``conv1x1_stats_reference``/``conv1x1_epilogue_reference``, which
tests/test_torch_conv_epilogue.py holds against the Pallas kernels) and
within 1.5x of f32's own distance from f64, while 1xTF32 errs at least
10x more. The tile plan is checked at every ``conv1x1_bn_act`` shape of
ResNet-50 at batch 256 and 16 and at ragged shapes. Inputs come from a
numpy seed.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import layers, models
from paddle_tpu_torch.kernels import conv_epilogue as tke

torch.set_num_threads(1)

GEMM_TOL = 1e-4   # chip_smoke.py's GEMM_TOL, absolute and relative
STATS_TOL = 1e-5  # chip_smoke.py's STATS_TOL, of each channel's summed mass
KS = (64, 128, 256, 512, 1024, 2048)  # the K (= I) of ResNet-50's 1x1 convs
R, O = 300, 40  # narrow and ragged: 3 row tiles, one 64-wide column tile


def _tf32_rna(x):
    """x rounded to the nearest tf32 (10 mantissa bits), ties away from
    zero, through the int32 view (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor cores read of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_trunc(x - hi)


def _stage_3xtf32(xs, ws):
    (xh, xl), (wh, wl) = _split(xs), _split(ws)
    return xl @ wh + xh @ wl + xh @ wh  # the small terms first


def _stage_1xtf32(xs, ws):
    return _tf32_rna(xs) @ _tf32_rna(ws)


def _gemm(x, w, plan, stage_fn):
    """x @ w as the kernels sum it: each K_TILE-deep stage in fresh f32,
    added to its slice's sum in K order; the slices in order."""
    k_steps = plan.i_pad // tke.K_TILE
    y = None
    for z in range(plan.slices):
        acc = torch.zeros(x.shape[0], w.shape[1])
        for step in range(z * plan.slice_steps,
                          min((z + 1) * plan.slice_steps, k_steps)):
            k = slice(step * tke.K_TILE, (step + 1) * tke.K_TILE)
            acc = acc + stage_fn(x[:, k], w[k])
        y = acc if y is None else y + acc
    return y


def _tile_sums(v):
    """Column sums of one 128-row tile as the stats epilogue takes them:
    thread (warp, g) adds rows 16 warp + g and + 8, a shuffle tree adds
    the 8 lanes g, then the 8 warps in order."""
    t = torch.zeros(tke.ROW_TILE, v.shape[1])
    t[:v.shape[0]] = v  # rows past R are exact zeros
    t = t.view(8, 2, 8, -1)
    s = t[:, 0] + t[:, 1]
    while s.shape[1] > 1:
        s = s[:, 0::2] + s[:, 1::2]
    total = s[0, 0]
    for w in range(1, 8):
        total = total + s[w, 0]
    return total


def _stats(y):
    """(sum y, sum y*y) per column: per-tile sums, then the tiles in
    stats_reduce_kernel's order (32 lanes over tiles t, t + 32, ...;
    then the lanes in order)."""
    tiles = [(_tile_sums(y[r:r + tke.ROW_TILE]),
              _tile_sums(y[r:r + tke.ROW_TILE] ** 2))
             for r in range(0, y.shape[0], tke.ROW_TILE)]
    out = []
    for stat in range(2):
        lanes = []
        for lane in range(32):
            acc = torch.zeros(y.shape[1])
            for t in range(lane, len(tiles), 32):
                acc = acc + tiles[t][stat]
            lanes.append(acc)
        total = lanes[0]
        for acc in lanes[1:]:
            total = total + acc
        out.append(total)
    return torch.stack(out)


def _inputs(I, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(R, I).astype(np.float32))
    w = torch.from_numpy((rng.randn(I, O) * I ** -0.5).astype(np.float32))
    scale = torch.from_numpy((1.0 + 0.2 * rng.randn(O)).astype(np.float32))
    shift = torch.from_numpy((0.1 * rng.randn(O)).astype(np.float32))
    res = torch.from_numpy(rng.randn(R, O).astype(np.float32))
    return x, w, scale, shift, res


def _max(a, b):
    return float((a.double() - b.double()).abs().max())


def test_tf32_split_emulation():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -12, 1 + 2 ** -10 + 2 ** -11])
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10,
                         1 + 2 ** -9])  # ties go away from zero
    assert torch.equal(_tf32_rna(x), want)
    x = torch.from_numpy(np.random.RandomState(3).randn(4096)
                         .astype(np.float32) * 100)
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()


@pytest.mark.parametrize("I", KS)
def test_3xtf32_stats_keep_f32_accuracy(I):
    """conv1x1_stats as the kernel computes it: y within GEMM_TOL of the
    plain version and the statistics within STATS_TOL of the summed mass;
    y and the statistics within 1.5x of f32's distance from f64; 1xTF32's
    y errs at least 10x more."""
    x, w, *_ = _inputs(I, seed=I)
    plan = tke.tile_plan(R, I, O)
    assert plan.slices == 1
    y = _gemm(x, w, plan, _stage_3xtf32)
    stats = _stats(y)
    ry, rstats = tke.conv1x1_stats_reference(x, w)
    torch.testing.assert_close(y, ry, atol=GEMM_TOL, rtol=GEMM_TOL)
    mass = torch.stack([ry.abs().sum(0), (ry * ry).sum(0)])
    assert float(((stats - rstats).abs() / mass).max()) <= STATS_TOL

    yd = x.double() @ w.double()
    sd = torch.stack([yd.sum(0), (yd * yd).sum(0)])
    massd = mass.double()
    assert _max(y, yd) <= 1.5 * _max(ry, yd), (_max(y, yd), _max(ry, yd))
    s_err = float(((stats.double() - sd).abs() / massd).max())
    f32_err = float(((rstats.double() - sd).abs() / massd).max())
    assert s_err <= 1.5 * f32_err, (s_err, f32_err)
    y1 = _gemm(x, w, plan, _stage_1xtf32)
    assert _max(y1, ry) >= 10 * _max(y, ry), (_max(y1, ry), _max(y, ry))


@pytest.mark.parametrize("I", KS)
def test_3xtf32_epilogue_keeps_f32_accuracy(I):
    """conv1x1_epilogue under its tile plan (split K from I = 256 on at
    this narrow shape: its slices added in order before the affine):
    within GEMM_TOL of the plain version, within 1.5x of f32's distance
    from f64; 1xTF32 errs at least 10x more."""
    x, w, scale, shift, res = _inputs(I, seed=I + 1)
    plan = tke.tile_plan(R, I, O, split_k=True)
    assert plan.slices == max(1, min(-(-tke.SMS // plan.tiles_r),
                                     I // tke.K_TILE // tke.MIN_SLICE_STEPS))

    def epilogue(y):
        return torch.relu(y * scale + shift + res)

    got = epilogue(_gemm(x, w, plan, _stage_3xtf32))
    want = tke.conv1x1_epilogue_reference(x, w, scale, shift, res, "relu")
    torch.testing.assert_close(got, want, atol=GEMM_TOL, rtol=GEMM_TOL)
    exact = torch.relu((x.double() @ w.double()) * scale.double()
                       + shift.double() + res.double())
    assert _max(got, exact) <= 1.5 * _max(want, exact), (
        _max(got, exact), _max(want, exact))
    got1 = epilogue(_gemm(x, w, plan, _stage_1xtf32))
    assert _max(got1, want) >= 10 * _max(got, want)


# --- the tile plan ----------------------------------------------------------
@pytest.fixture(scope="module")
def resnet50_shapes():
    """(R, I, O) of every conv1x1_bn_act of ResNet-50 (224 x 224) at
    batch 256 (training) and 16 (inference), from the port's program."""
    pt.flags.FLAGS.fused_conv_epilogue = True
    try:
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            images = layers.data("images", [224, 224, 3])
            models.resnet_imagenet(images, num_classes=1000, depth=50)
    finally:
        pt.flags.FLAGS.fused_conv_epilogue = False
    blk = main.global_block
    hwio = []
    for op in blk.ops:
        if op.type == "conv1x1_bn_act":
            _, H, W, I = blk.var(op.inputs["X"][0]).shape
            hwio.append((H * W, I, blk.var(op.inputs["Filter"][0]).shape[-1]))
    assert len(hwio) == 33
    return {"train": sorted({(256 * hw, i, o) for hw, i, o in hwio}),
            "infer": sorted({(16 * hw, i, o) for hw, i, o in hwio})}


RAGGED = [(100, 32, 16), (1000, 72, 40), (257, 30, 9), (1, 1, 1)]


def _check_plan(R_, I, O_, plan, split_k):
    assert plan.bn == (64 if O_ <= 64 else 128)
    rows = plan.tiles_r * tke.ROW_TILE
    assert rows - tke.ROW_TILE < R_ <= rows
    assert (plan.tiles_o - 1) * plan.bn < O_ <= plan.tiles_o * plan.bn
    assert plan.o_pad == plan.tiles_o * plan.bn
    assert plan.i_pad == -(-I // tke.K_TILE) * tke.K_TILE
    k_steps = plan.i_pad // tke.K_TILE
    assert plan.slices * plan.slice_steps >= k_steps
    assert (plan.slices - 1) * plan.slice_steps < k_steps  # none empty
    if not split_k:
        assert plan.slices == 1
    tiles = plan.tiles_r * plan.tiles_o
    if plan.slices > 1:
        assert plan.slice_steps >= tke.MIN_SLICE_STEPS
        assert tiles < tke.SMS
    if split_k and tiles < tke.SMS:  # fills a wave, or K allows no more
        assert (tiles * plan.slices >= tke.SMS
                or plan.slices >= k_steps // tke.MIN_SLICE_STEPS)
    assert plan.wt_shape == (2, plan.o_pad, plan.i_pad)
    assert plan.partial_shape(O_) == (plan.tiles_r, 2, O_)
    assert plan.slices_shape(R_, O_) == (
        (plan.slices, R_, O_) if plan.slices > 1 else None)


@pytest.mark.parametrize("kind", ["train", "infer", "ragged"])
def test_tile_plan_covers_every_shape(kind, resnet50_shapes):
    shapes = RAGGED if kind == "ragged" else resnet50_shapes[kind]
    for R_, I, O_ in shapes:
        for split_k in (False, True):
            _check_plan(R_, I, O_, tke.tile_plan(R_, I, O_, split_k),
                        split_k)
    def tiles(plan):
        return plan.tiles_r * plan.tiles_o

    if kind == "train":  # the stats need no split: >= 392 tiles each
        assert all(tiles(tke.tile_plan(*s)) >= 392 for s in shapes)
    if kind == "infer":  # every grid under one wave gets split K slices
        small = [s for s in shapes if tiles(tke.tile_plan(*s)) < tke.SMS]
        assert {s[0] for s in small} >= {784, 3136}
        for s in small:
            plan = tke.tile_plan(*s, split_k=True)
            assert plan.slices > 1, (s, plan)
            assert tiles(plan) * plan.slices >= tke.SMS, (s, plan)


def test_wrappers_allocate_what_the_plan_says(monkeypatch):
    """The launch paths size W's split copies, the per-tile statistics and
    the split-K slices from the plan (the C entry points trust them)."""
    shapes, calls = [], []
    empty = tke._empty

    def record(shape, dev):
        shapes.append(shape)
        return empty(shape, dev)

    class Lib:
        @staticmethod
        def paddle_cuda_error_string(err):
            return b"none"

    def fn(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(tke.conv1x1_stats, "launches", 0)
    monkeypatch.setattr(tke.conv1x1_epilogue, "launches", 0)
    monkeypatch.setattr(tke, "_empty", record)
    monkeypatch.setattr(tke, "_bind", lambda name: (Lib, fn))
    monkeypatch.setattr(tke, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullContext())
    for R_, I, O_ in [(784, 2048, 512), (1000, 72, 40), (50176, 64, 64),
                      (5, 0, 3)]:
        x, w = torch.zeros(R_, I), torch.zeros(I, O_)
        vec = torch.ones(O_)
        shapes.clear()
        tke._launch_stats(x, w)
        plan = tke.tile_plan(R_, I, O_)
        assert shapes == [plan.wt_shape, plan.partial_shape(O_), (R_, O_),
                          (2, O_)]
        assert calls[-1][-2] == plan.bn
        shapes.clear()
        tke._launch_epilogue(x, w, vec, vec, None, "relu")
        plan = tke.tile_plan(R_, I, O_, split_k=True)
        assert shapes == [plan.wt_shape, plan.slices_shape(R_, O_), (R_, O_)]
        assert (calls[-1][7] is None) == (plan.slices == 1)
        assert calls[-1][-4:-1] == (plan.bn, plan.slices, plan.slice_steps)


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
