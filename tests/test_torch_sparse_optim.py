"""The row-sparse (SelectedRows) gradient plane of the port against the
JAX package's, on the CPU.

- The update ops' row rules (``sgd``, ``momentum`` with and without
  Nesterov, lazy ``adam`` with and without decoupled decay, ``adagrad``)
  and ``sparse_sgd``/``sparse_adagrad``, run through both registries on
  the same numpy inputs (ids with duplicates, the padding sentinel and
  ids past the table). Every untouched row of every output is exact. The
  touched rows are bit for bit where no root is taken (``sgd``,
  ``momentum``, ``sparse_sgd``, every moment); a parameter stepped
  through a square root (``adam``, ``adagrad``, ``sparse_adagrad``)
  within ROOT_ULPS f32 ulps, as torch's CPU ``sqrt`` is not correctly
  rounded.
- The twins of ``tests/test_sparse_embedding.py``'s program tests in the
  port: sparse training equals dense training (sgd, adagrad), lazy Adam
  by hand, the gradient is a SelectedRows, the padding row, gradient
  accumulation densifies, ``sum`` mixes rows and dense.
- A sparse embedding trained in both packages from the same weights
  (sgd, adagrad, Nesterov momentum, lazy Adam): 5 losses within
  LOSS_RTOL (measured: at most 1.1e-7), the table within rtol 1e-5,
  atol 1e-6 (the dense layers' products sum in another order), its rows
  never looked up exact.
- Clipping on rows: ``clip``, ``clip_by_norm`` and
  ``clip_by_global_norm`` keep a SelectedRows and equal JAX's dense
  view within CLIP_TOL.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu_torch.core.registry import get_op as torch_op
from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR
from test_torch_book import scopes

torch.set_num_threads(1)
V, D, N = 30, 5, 23
ROOT_ULPS = 4
LOSS_RTOL = 1e-6
CLIP_TOL = dict(rtol=2e-6, atol=1e-7)


def _ulps(got, want):
    """The f32 ulp distance of two arrays, elementwise."""
    a = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _grad(seed):
    rng = np.random.RandomState(seed)
    rows = np.where(rng.rand(N) < 0.7, rng.randint(0, 4, N),
                    rng.randint(0, V, N))
    rows[rng.rand(N) < 0.15] = V          # the padding sentinel
    rows[3] = V + 7                       # an id past the table
    vals = rng.randn(N, D).astype(np.float32)
    return rows.astype(np.int64), vals


def _state(seed, shape, positive=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(x) + 0.1 if positive else x


CASES = {
    # op: (attrs, {slot: state}, root taken in ParamOut)
    "sgd": ({}, {}, False),
    "momentum": ({"mu": 0.9}, {"Velocity": (1, False)}, False),
    "momentum_nesterov": ({"mu": 0.9, "use_nesterov": True},
                          {"Velocity": (1, False)}, False),
    "adam": ({"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             {"Moment1": (1, False), "Moment2": (2, True)}, True),
    "adamw": ({"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
               "weight_decay": 0.01},
              {"Moment1": (1, False), "Moment2": (2, True)}, True),
    "adagrad": ({"epsilon": 1e-6}, {"Moment": (2, True)}, True),
    "sparse_sgd": ({"vocab_axis": "mp"}, {}, False),
    "sparse_adagrad": ({"epsilon": 1e-6, "vocab_axis": "mp"},
                       {"Moment": (2, True)}, True),
}


def _op_ins(case, seed):
    attrs, states, _ = CASES[case]
    rows, vals = _grad(seed)
    ins = {"Param": _state(seed + 10, (V, D)),
           "LearningRate": np.array([0.05], np.float32)}
    for slot, (s, pos) in states.items():
        ins[slot] = _state(seed + 20 + s, (V, D), pos)
    if case.startswith("adam"):
        ins["Beta1Pow"] = np.array([0.9 ** 3], np.float32)
        ins["Beta2Pow"] = np.array([0.999 ** 3], np.float32)
    op = {"momentum_nesterov": "momentum", "adamw": "adam"}.get(case, case)
    return op, attrs, ins, rows, vals


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_row_rules_match_jax(case, seed):
    op, attrs, ins, rows, vals = _op_ins(case, seed)
    jins = {k: [jnp.asarray(v)] for k, v in ins.items()}
    tins = {k: [torch.from_numpy(v.copy())] for k, v in ins.items()}
    jins["Grad"] = [JSR(jnp.asarray(rows, jnp.int32), jnp.asarray(vals), V)]
    tins["Grad"] = [TSR(torch.from_numpy(rows), torch.from_numpy(vals), V)]
    want = jax_op(op).fn(attrs, jins)
    got = torch_op(op).fn(attrs, tins)
    assert sorted(got) == sorted(want)
    touched = np.zeros(V, bool)
    touched[rows[rows < V]] = True
    root = CASES[case][2]
    for slot in want:
        w, g = np.asarray(want[slot][0]), got[slot][0].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, slot
        if w.shape != (V, D):  # the beta powers
            np.testing.assert_array_equal(g, w, err_msg=slot)
            continue
        np.testing.assert_array_equal(g[~touched], w[~touched],
                                      err_msg=f"{slot} untouched")
        np.testing.assert_array_equal(g[~touched], ins[slot[:-3]][~touched])
        if root and slot == "ParamOut":
            assert _ulps(g[touched], w[touched]).max() <= ROOT_ULPS, slot
        else:
            np.testing.assert_array_equal(g[touched], w[touched],
                                          err_msg=f"{slot} touched")


@pytest.mark.parametrize("op", ["sparse_sgd", "sparse_adagrad"])
def test_sparse_ops_take_a_dense_gradient(op):
    """A dense gradient (a sparse and a dense contribution summed) takes
    the dense formula, as in JAX."""
    _, attrs, ins, _, _ = _op_ins(op, 3)
    ins["Grad"] = _state(9, (V, D))
    want = jax_op(op).fn(attrs, {k: [jnp.asarray(v)] for k, v in ins.items()})
    got = torch_op(op).fn(attrs, {k: [torch.from_numpy(v)]
                                  for k, v in ins.items()})
    for slot in want:
        assert _ulps(got[slot][0].numpy(), want[slot][0]).max() <= ROOT_ULPS


@pytest.mark.parametrize("op", ["adamax", "decayed_adagrad", "rmsprop",
                                "adadelta"])
def test_ops_without_a_row_rule_densify(op):
    """The update ops with no row rule see the dense gradient."""
    rows, vals = _grad(4)
    sr = TSR(torch.from_numpy(rows), torch.from_numpy(vals), V)
    shapes = {"adamax": ("Moment", "InfNorm"),
              "decayed_adagrad": ("Moment",),
              "rmsprop": ("MeanSquare", "Moment"),
              "adadelta": ("AvgSquaredGrad", "AvgSquaredUpdate")}[op]
    ins = {"Param": [torch.from_numpy(_state(1, (V, D)))],
           "LearningRate": [torch.tensor([0.05])]}
    for i, slot in enumerate(shapes):
        ins[slot] = [torch.from_numpy(_state(2 + i, (V, D), True))]
    if op == "adamax":
        ins["Beta1Pow"] = [torch.tensor([0.9])]
    a = torch_op(op).fn({}, dict(ins, Grad=[sr]))
    b = torch_op(op).fn({}, dict(ins, Grad=[sr.to_dense()]))
    for slot in a:
        np.testing.assert_array_equal(a[slot][0].numpy(), b[slot][0].numpy())


# --- the program twins of tests/test_sparse_embedding.py ---------------------
def _train_embedding(is_sparse, optimizer_fn, steps=4, vocab=50, dim=8):
    """A one-embedding bow classifier; returns (final table, losses)."""
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        ids = tpt.layers.data("ids", shape=[5], dtype="int64")
        label = tpt.layers.data("label", shape=[1], dtype="int64")
        emb = tpt.layers.embedding(ids, size=[vocab, dim],
                                   is_sparse=is_sparse,
                                   param_attr=tpt.ParamAttr(name="emb"))
        bow = tpt.layers.reshape(emb, [-1, 5 * dim])
        logits = tpt.layers.fc(bow, size=2)
        loss = tpt.layers.mean(
            tpt.layers.softmax_with_cross_entropy(logits, label))
        optimizer_fn().minimize(loss, startup_program=startup)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(steps):
        idb = rng.randint(0, vocab, size=(8, 5)).astype(np.int64)
        lb = rng.randint(0, 2, size=(8, 1)).astype(np.int64)
        out, = exe.run(main, feed={"ids": idb, "label": lb},
                       fetch_list=[loss], scope=scope)
        losses.append(float(out))
    return scope.get_numpy("emb"), losses


@pytest.mark.parametrize("opt", [
    lambda pt: pt.optimizer.SGDOptimizer(learning_rate=0.1),
    lambda pt: pt.optimizer.AdagradOptimizer(learning_rate=0.1),
])
def test_sparse_training_matches_dense(opt):
    """The row updates of sgd and adagrad are the dense update on the
    touched rows (test_CompareSparse.cpp's contract)."""
    w_dense, l_dense = _train_embedding(False, lambda: opt(tpt))
    w_sparse, l_sparse = _train_embedding(True, lambda: opt(tpt))
    np.testing.assert_allclose(w_sparse, w_dense, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(l_sparse, l_dense, rtol=2e-5)


def test_sparse_adam_touched_rows_match_manual():
    """Lazy Adam: touched rows follow the dense formula; untouched rows
    (and their moments) stay exactly put."""
    vocab, dim = 20, 4
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        ids = tpt.layers.data("ids", shape=[3], dtype="int64")
        emb = tpt.layers.embedding(ids, size=[vocab, dim], is_sparse=True,
                                   param_attr=tpt.ParamAttr(name="emb"))
        loss = tpt.layers.mean(emb)
        tpt.optimizer.AdamOptimizer(learning_rate=0.01).minimize(
            loss, startup_program=startup)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    w0 = scope.get_numpy("emb").copy()
    idb = np.array([[2, 5, 5]], np.int64)  # row 5 twice: grads accumulate
    exe.run(main, feed={"ids": idb}, scope=scope)
    w1 = scope.get_numpy("emb")
    g = np.zeros_like(w0)
    for i in idb.ravel():
        g[i] += 1.0 / (idb.size * dim)
    lr, b1, b2, eps = 0.01, 0.9, 0.999, 1e-8
    lr_t = lr * np.sqrt(1 - b2) / (1 - b1)
    expect = w0.copy()
    for r in (2, 5):
        expect[r] -= lr_t * (1 - b1) * g[r] / (np.sqrt((1 - b2) * g[r] ** 2)
                                               + eps)
    np.testing.assert_allclose(w1, expect, rtol=1e-5, atol=1e-7)
    untouched = [i for i in range(vocab) if i not in (2, 5)]
    np.testing.assert_array_equal(w1[untouched], w0[untouched])


def test_sparse_grad_is_selected_rows_not_dense():
    """The sparse path emits a SelectedRows, not a [V, D] tensor."""
    grads = torch_op("lookup_table").grad_fn(
        {"is_sparse": True}, {"W": [torch.ones(1000, 4)],
                              "Ids": [torch.tensor([[1], [7]])]},
        {}, {"Out": [torch.ones(2, 4)]})
    gw = grads["W"][0]
    assert isinstance(gw, TSR) and grads["Ids"] == [None]
    assert gw.values.shape == (2, 4) and gw.height == 1000
    assert gw.rows.tolist() == [1, 7]


def test_sparse_padding_idx_gets_no_update():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        ids = tpt.layers.data("ids", shape=[4], dtype="int64")
        emb = tpt.layers.embedding(ids, size=[10, 3], is_sparse=True,
                                   padding_idx=0,
                                   param_attr=tpt.ParamAttr(name="emb"))
        loss = tpt.layers.mean(emb)
        tpt.optimizer.SGDOptimizer(learning_rate=1.0).minimize(
            loss, startup_program=startup)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    w0 = scope.get_numpy("emb").copy()
    exe.run(main, feed={"ids": np.array([[0, 0, 3, 4]], np.int64)},
            scope=scope)
    w1 = scope.get_numpy("emb")
    np.testing.assert_array_equal(w1[0], w0[0])  # the padding row
    assert not np.allclose(w1[3], w0[3])
    np.testing.assert_array_equal(w1[5:], w0[5:])


def test_sparse_grad_accumulation_densifies():
    """Gradient accumulation over a sparse weight: ``acc += grad`` takes
    the dense view, the other runs leave the weight as it is, and the
    k-th run applies the mean."""
    vocab, dim = 32, 4
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        ids = tpt.layers.data("ids", shape=[3], dtype="int64")
        emb = tpt.layers.embedding(ids, size=[vocab, dim], is_sparse=True,
                                   param_attr=tpt.ParamAttr(name="emb"))
        loss = tpt.layers.mean(emb)
        tpt.optimizer.SGDOptimizer(learning_rate=0.5).minimize(
            loss, startup_program=startup, accumulate_steps=2)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    w0 = scope.get_numpy("emb").copy()
    feed = {"ids": np.array([[1, 2, 3]], np.int64)}
    exe.run(main, feed=feed, scope=scope)
    np.testing.assert_array_equal(scope.get_numpy("emb"), w0)
    acc = [n for n in scope.keys() if n.endswith("_gradsum_acc")]
    assert acc and scope.get(acc[0]).shape == (vocab, dim)
    exe.run(main, feed=feed, scope=scope)
    w2 = scope.get_numpy("emb")
    np.testing.assert_allclose(w2[[1, 2, 3]], w0[[1, 2, 3]]
                               - 0.5 / (3 * dim), rtol=1e-6)
    np.testing.assert_array_equal(w2[0], w0[0])


def test_sum_op_mixes_sparse_and_dense():
    """A fan-out: two SelectedRows sum to one; a dense operand densifies."""
    a = TSR(torch.tensor([1]), torch.ones(1, 2), 4)
    b = TSR(torch.tensor([3]), torch.ones(1, 2), 4)
    r = torch_op("sum").fn({}, {"X": [a, b]})["Out"][0]
    assert isinstance(r, TSR) and r.rows.tolist() == [1, 3]
    r2 = torch_op("sum").fn({}, {"X": [a, torch.ones(4, 2)]})["Out"][0]
    assert not isinstance(r2, TSR)
    np.testing.assert_array_equal(r2.numpy()[1], [2.0, 2.0])
    np.testing.assert_array_equal(r2.numpy()[0], [1.0, 1.0])
    s = torch_op("scale").fn({"scale": 0.5}, {"X": [a]})["Out"][0]
    assert isinstance(s, TSR) and s.values.tolist() == [[0.5, 0.5]]
    with pytest.raises(ValueError, match="bias"):
        torch_op("scale").fn({"scale": 0.5, "bias": 1.0}, {"X": [a]})


def test_fetched_sparse_grad_is_dense_and_nan_checked():
    """Fetched, a SelectedRows gradient comes back dense (JAX's fetch);
    check_nan_inf scans its values."""
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        ids = tpt.layers.data("ids", shape=[3], dtype="int64")
        emb = tpt.layers.embedding(ids, size=[6, 2], is_sparse=True,
                                   param_attr=tpt.ParamAttr(name="emb"))
        loss = tpt.layers.mean(emb)
        pg = tpt.optimizer.SGDOptimizer(0.1).minimize(
            loss, startup_program=startup)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace(), check_nan_inf=True)
    exe.run(startup, scope=scope)
    grad, = exe.run(main, feed={"ids": np.array([[1, 1, 4]])},
                    fetch_list=[pg[0][1]], scope=scope)
    want = np.zeros((6, 2), np.float32)
    want[[1, 4]] = [[2 / 6] * 2, [1 / 6] * 2]
    np.testing.assert_allclose(grad, want, rtol=1e-6)
    from paddle_tpu_torch.core import executor

    bad = TSR(torch.tensor([0]), torch.tensor([[np.nan, 1.0]]), 6)
    with pytest.raises(FloatingPointError, match="1 NaN"):
        executor._check_nan_inf("g", bad)


# --- a sparse embedding trained in both packages -----------------------------
def _bow(pt, opt, sparse=True):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[6], dtype="int64")
        label = pt.layers.data("label", shape=[1], dtype="int64")
        emb = pt.layers.embedding(ids, size=[V, D], is_sparse=sparse,
                                  padding_idx=0)
        logits = pt.layers.fc(pt.layers.reshape(emb, [-1, 6 * D]), size=3)
        loss = pt.layers.mean(
            pt.layers.softmax_with_cross_entropy(logits, label))
        opt(pt).minimize(loss, startup_program=startup)
    return main, startup, loss


@pytest.mark.parametrize("opt", [
    lambda pt: pt.optimizer.SGDOptimizer(0.5),
    lambda pt: pt.optimizer.AdagradOptimizer(0.1),
    lambda pt: pt.optimizer.MomentumOptimizer(0.1, 0.9, use_nesterov=True),
    lambda pt: pt.optimizer.AdamOptimizer(0.01),
])
def test_sparse_embedding_trains_as_jax(opt):
    from paddle_tpu.core import program as jprog
    from paddle_tpu_torch.core import program as tprog

    start = jprog.Program._uid_counter
    jprog.Program._uid_counter = tprog.Program._uid_counter = start
    jm, js, jl = _bow(jpt, opt)
    tprog.Program._uid_counter = start
    tm, ts, tl = _bow(tpt, opt)
    assert [op.type for op in tm.global_block.ops] == [
        op.type for op in jm.global_block.ops]
    jscope, tscope = scopes(js, ts)
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    rng = np.random.RandomState(5)
    for _ in range(5):
        # a hot set: rows repeat within and across steps
        feed = {"ids": rng.randint(0, 6, size=(16, 6)).astype(np.int64),
                "label": rng.randint(0, 3, size=(16, 1)).astype(np.int64)}
        jv, = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        tv, = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        np.testing.assert_allclose(float(tv), float(np.asarray(jv)),
                                   rtol=LOSS_RTOL)
    emb = [op for op in tm.global_block.ops if op.type == "lookup_table"]
    name = emb[0].inputs["W"][0]
    got, want = tscope.get_numpy(name), np.asarray(jscope.get(name))
    np.testing.assert_array_equal(got[6:], want[6:])  # never looked up
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --- clipping on rows ---------------------------------------------------------
@pytest.mark.parametrize("op,attrs", [
    ("clip", {"min": -0.3, "max": 0.4}),
    ("clip_by_norm", {"max_norm": 1.5}),
    ("clip_by_global_norm", {"max_norm": 2.0}),
])
def test_clipping_on_rows(op, attrs):
    rows, vals = _grad(6)
    jg = JSR(jnp.asarray(rows, jnp.int32), jnp.asarray(vals), V)
    tg = TSR(torch.from_numpy(rows), torch.from_numpy(vals), V)
    dense = _state(8, (4, 3))
    jins, tins = {"X": [jg]}, {"X": [tg]}
    if op == "clip_by_global_norm":
        jins["X"].append(jnp.asarray(dense))
        tins["X"].append(torch.from_numpy(dense))
    want = jax_op(op).fn(attrs, jins)["Out"]
    got = torch_op(op).fn(attrs, tins)["Out"]
    assert isinstance(got[0], TSR)
    np.testing.assert_allclose(got[0].to_dense().numpy(),
                               np.asarray(want[0].to_dense()), **CLIP_TOL)
    if op == "clip":
        assert got[0].rows.tolist() == np.asarray(want[0].rows).tolist()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CLIP_TOL)


@pytest.mark.parametrize("opt", [
    lambda pt: pt.optimizer.SGDOptimizer(0.5),
    lambda pt: pt.optimizer.AdagradOptimizer(0.1),
    lambda pt: pt.optimizer.MomentumOptimizer(0.1, 0.9),
    lambda pt: pt.optimizer.AdamOptimizer(0.01),
])
def test_row_rules_write_the_table_in_place(opt):
    """A sparse step allocates no new [V, D] table: the weight and its
    moments stay the scope's tensors, written in place (the JAX executor
    donates them); a dense step gives new ones."""
    for sparse in (True, False):
        main, startup, loss = _bow(tpt, opt, sparse=sparse)
        scope = tpt.Scope()
        exe = tpt.Executor(tpt.CPUPlace())
        exe.run(startup, scope=scope)
        tables = [n for n in scope.keys()
                  if isinstance(scope.get(n), torch.Tensor)
                  and tuple(scope.get(n).shape) == (V, D)]
        assert len(tables) >= 1 + (not isinstance(opt(tpt),
                                                  tpt.optimizer.SGDOptimizer))
        before = {n: scope.get(n) for n in tables}
        exe.run(main, feed={"ids": np.array([[1, 2, 2, 0, 5, 9]]),
                            "label": np.array([[1]])}, scope=scope)
        for n in tables:
            assert (scope.get(n) is before[n]) == sparse, (n, sparse)
