"""The persistent grid of the port's bf16 1x1-conv GEMM kernel, checked on
the CPU.

Under AMP, ``conv1x1_stats`` and ``conv1x1_epilogue`` launch
``conv1x1_bf16_kernel`` (``kernels/csrc/conv_epilogue.cu``) on a
persistent grid: ``TilePlan.grid`` blocks, at most one a work item (a 128 x
BN output tile and K slice) and at most ``BLOCKS_PER_SM_BF16`` on each of
the ``SMS`` SMs; block b walks the items b, b + grid, ... with column
tiles fastest, then row tiles, then K slices (``work_item`` in the CUDA
source, mirrored here). What Python decides is held here at every
``conv1x1_bn_act`` shape of ResNet-50 at batch 256 (the statistics, no
split K) and 16 (the epilogue, K split into as many slices as keep every
item in one round of the grid where the tiles fill less than one), and at
ragged shapes: the grid stays inside the items and the card, the walk
visits every item exactly once and leaves no slice empty, the statistics
keep one partial row a 128-row tile, and the wrappers hand the C entry
points what the plan says (a stand-in takes the ctypes call).
The kernel's arithmetic is unchanged from the one-block-a-tile kernel it
replaces (each 64-deep K stage summed in fresh registers and added in f32
in stage order; the statistics' fixed order), so the plain versions'
parity with the Pallas kernels stays where
tests/test_torch_amp_conv_epilogue.py holds it.
"""
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import layers, models
from paddle_tpu_torch.kernels import conv_epilogue as tke

torch.set_num_threads(1)

# (R, I, O): more items than the grid with a partial last row tile; fewer
# tiles than SMs with a ragged K; 64-wide tiles at O = 40, more items than
# the grid; ragged widths TMA cannot take as they are; one of everything
RAGGED = [(132 * 128 * 3 + 77, 64, 256), (900, 1000, 200), (50000, 128, 40),
          (1000, 72, 40), (257, 30, 9), (100, 136, 200), (1, 1, 1)]


@pytest.fixture(scope="module")
def resnet50_shapes():
    """(R, I, O) of every conv1x1_bn_act of ResNet-50 (224 x 224) at batch
    256 (training) and 16 (serving), from the port's program."""
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


def _cases(kind, shapes):
    """(R, I, O, split_k) of ``kind``: the statistics at batch 256 (no
    split K), the epilogue at batch 16, the ragged shapes both ways."""
    if kind == "train":
        return [s + (False,) for s in shapes["train"]]
    if kind == "infer":
        return [s + (True,) for s in shapes["infer"]]
    return [s + (split,) for s in RAGGED for split in (False, True)]


def _plan(R, I, O, split_k):
    return tke.tile_plan(R, I, O, split_k, tke.K_TILE_BF16)


def _walk(plan, grid):
    """{block: [(slice, row tile, column tile, first K step, K steps)]}:
    the items each block runs, in its order, as ``work_item`` decodes
    them."""
    k_steps = plan.i_pad // tke.K_TILE_BF16
    tiles = plan.tiles_r * plan.tiles_o
    walk = {}
    for b in range(grid):
        for t in range(b, plan.work, grid):
            z, rc = divmod(t, tiles)
            tile_r, tile_o = divmod(rc, plan.tiles_o)
            step0 = z * plan.slice_steps
            nk = max(0, min(plan.slice_steps, k_steps - step0))
            walk.setdefault(b, []).append((z, tile_r, tile_o, step0, nk))
    return walk


@pytest.mark.parametrize("kind", ["train", "infer", "ragged"])
def test_grid_stays_inside_the_items_and_the_card(kind, resnet50_shapes):
    cap = tke.SMS * tke.BLOCKS_PER_SM_BF16
    for R, I, O, split_k in _cases(kind, resnet50_shapes):
        plan = _plan(R, I, O, split_k)
        assert plan.work == plan.tiles_r * plan.tiles_o * plan.slices
        assert 1 <= plan.grid <= min(plan.work, cap), (R, I, O, plan)
        # a grid short of the card only where the items run out
        assert plan.grid == min(plan.work, cap), (R, I, O, plan)
    if kind == "train":  # every training shape fills the card
        assert all(_plan(R, I, O, s).grid == cap
                   for R, I, O, s in _cases(kind, resnet50_shapes))


@pytest.mark.parametrize("kind", ["train", "infer", "ragged"])
def test_stride_walk_visits_every_item_once(kind, resnet50_shapes):
    for R, I, O, split_k in _cases(kind, resnet50_shapes):
        plan = _plan(R, I, O, split_k)
        walk = _walk(plan, plan.grid)
        assert sorted(walk) == list(range(plan.grid)), "an idle block"
        items = [it[:3] for run in walk.values() for it in run]
        assert len(items) == len(set(items)) == plan.work, (R, I, O)
        assert set(items) == {(z, r, o) for z in range(plan.slices)
                              for r in range(plan.tiles_r)
                              for o in range(plan.tiles_o)}
        # the slices cover K exactly, none of them empty (I = 0: no step)
        k_steps = plan.i_pad // tke.K_TILE_BF16
        for z in range(plan.slices):
            step0, nk = next(it[3:] for run in walk.values() for it in run
                             if it[0] == z)
            assert nk > 0 or k_steps == 0, (R, I, O, plan)
            assert step0 == sum(
                next(it[4] for run in walk.values() for it in run
                     if it[0] == zz) for zz in range(z))
        assert sum(next(it[4] for run in walk.values() for it in run
                        if it[0] == z)
                   for z in range(plan.slices)) == k_steps
        # each block's items in ascending order, and the blocks at work at
        # one moment on consecutive items (column tiles fastest)
        for b, run in walk.items():
            order = [(z * plan.tiles_r + r) * plan.tiles_o + o
                     for z, r, o, _, _ in run]
            assert order == list(range(b, plan.work, plan.grid))


def test_walk_puts_a_row_tiles_column_tiles_side_by_side():
    """Items t and t + 1 of one row tile are its neighbouring column tiles,
    run by neighbouring blocks in the same round, so the second read of x's
    rows comes from L2."""
    plan = _plan(802816, 64, 256, False)
    assert (plan.tiles_o, plan.grid) == (2, tke.SMS)
    walk = _walk(plan, plan.grid)
    assert walk[0][0][:3] == (0, 0, 0) and walk[1][0][:3] == (0, 0, 1)
    assert walk[2][0][:3] == (0, 1, 0)
    assert walk[0][1][:3] == (0, 66, 0)  # the next round: item 132


@pytest.mark.parametrize("kind", ["train", "ragged"])
def test_statistics_keep_one_partial_row_a_row_tile(kind, resnet50_shapes):
    for R, I, O, split_k in _cases(kind, resnet50_shapes):
        plan = _plan(R, I, O, split_k)
        assert plan.partial_shape(O) == (-(-R // tke.ROW_TILE), 2, O)


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def launcher(monkeypatch):
    """A stand-in for the bf16 ctypes entry points: records each call's
    arguments and the shapes the wrapper allocated, launches nothing."""
    calls, shapes = [], []
    empty = tke._empty

    def record(shape, dev, dtype=torch.float32):
        shapes.append(shape)
        return empty(shape, dev, dtype)

    class Lib:
        @staticmethod
        def paddle_cuda_error_string(err):
            return b"none"

    def bind(name):
        def fn(*args):
            assert len(args) == len(tke._ARGTYPES[name]), (name, len(args))
            calls.append((name, args))
            return 0
        return Lib, fn

    monkeypatch.setattr(tke.conv1x1_stats, "bf16_launches", 0)
    monkeypatch.setattr(tke.conv1x1_epilogue, "bf16_launches", 0)
    monkeypatch.setattr(tke, "_empty", record)
    monkeypatch.setattr(tke, "_bind", bind)
    monkeypatch.setattr(tke, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullContext())
    return calls, shapes


WRAPPER_SHAPES = [(784, 2048, 512), (3136, 1024, 256), (50176, 64, 256),
                  (1000, 72, 40), (900, 1000, 200), (257, 30, 9), (5, 0, 3)]


@pytest.mark.parametrize("R,I,O", WRAPPER_SHAPES)
def test_stats_wrapper_passes_the_plan(launcher, R, I, O):
    calls, shapes = launcher
    x, w = torch.zeros(R, I).bfloat16(), torch.zeros(I, O).bfloat16()
    y, stats = tke._launch_stats(x, w)
    plan = _plan(R, I, O, False)
    name, args = calls[-1]
    assert name == "paddle_conv1x1_stats_bf16"
    # x, w, y, partial, stats, R, I, O, ldx, ldw, bn, grid, stream
    assert args[5:] == (R, I, O, -(-I // 8) * 8, -(-O // 8) * 8, plan.bn,
                        plan.grid, 0)
    assert shapes == [plan.partial_shape(O), (R, O), (2, O)]
    assert y.dtype == torch.bfloat16 and stats.dtype == torch.float32
    assert tke.conv1x1_stats.bf16_launches == 1


@pytest.mark.parametrize("R,I,O", WRAPPER_SHAPES)
@pytest.mark.parametrize("residual", [None, torch.bfloat16, torch.float32])
def test_epilogue_wrapper_passes_the_plan(launcher, R, I, O, residual):
    calls, shapes = launcher
    x, w = torch.zeros(R, I).bfloat16(), torch.zeros(I, O).bfloat16()
    vec = torch.ones(O)
    res = None if residual is None else torch.zeros(R, O, dtype=residual)
    out = tke._launch_epilogue(x, w, vec, vec, res, "relu")
    plan = _plan(R, I, O, True)
    name, args = calls[-1]
    assert name == "paddle_conv1x1_epilogue_bf16"
    # x, w, scale, shift, residual, out, slice_out, R, I, O, ldx, ldw,
    # res_f32, relu, bn, slices, slice_steps, grid, stream
    assert (args[4] is None) == (residual is None)
    assert (args[6] is None) == (plan.slices == 1)
    assert args[7:] == (R, I, O, -(-I // 8) * 8, -(-O // 8) * 8,
                        int(residual == torch.float32), 1, plan.bn,
                        plan.slices, plan.slice_steps, plan.grid, 0)
    assert shapes == [plan.slices_shape(R, O), (R, O)]
    assert out.dtype == torch.bfloat16
    assert tke.conv1x1_epilogue.bf16_launches == 1


@pytest.mark.parametrize("kind", ["infer", "ragged"])
def test_bf16_split_keeps_every_item_in_one_round(kind, resnet50_shapes):
    """Where the tiles fill less than one round of the persistent grid, K
    is cut into as many slices (each at least 128 deep) as keep every
    work item in one round: a block never runs a second item while
    others idle, and a split that would buy no round writes no f32
    slices."""
    cap = tke.SMS * tke.BLOCKS_PER_SM_BF16
    min_steps = tke.MIN_SLICE_STEPS * tke.K_TILE // tke.K_TILE_BF16
    for R, I, O, split_k in _cases(kind, resnet50_shapes):
        plan = _plan(R, I, O, split_k)
        tiles = plan.tiles_r * plan.tiles_o
        k_steps = plan.i_pad // tke.K_TILE_BF16
        if not split_k or tiles >= tke.SMS:
            assert plan.slices == 1, (R, I, O, plan)
            continue
        assert plan.work <= cap, (R, I, O, plan)
        assert plan.slices == max(1, min(cap // tiles, k_steps // min_steps))
        if plan.slices > 1:
            assert plan.slice_steps * tke.K_TILE_BF16 >= 128
    if kind == "infer":  # the served batch's small grids, as planned
        got = {(R, I, O): _plan(R, I, O, True).slices
               for R, I, O in resnet50_shapes["infer"]}
        assert got[(784, 2048, 512)] == 4 and got[(3136, 1024, 256)] == 2
        assert got[(784, 512, 2048)] == got[(3136, 1024, 512)] == 1
