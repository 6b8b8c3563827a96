"""``ModelAverage``, the pruning hook and their ops in the port, against
the JAX package.

- ``model_average_update`` on numpy inputs across the window's roll:
  bit for bit (one add and selects);
- ``ModelAverage`` over a 2-layer MLP trained by Momentum for six steps
  with a window of three: the sums and counts equal JAX's within rtol
  1e-5 / atol 1e-6 (the parameters' own f32 gap after six steps),
  ``apply`` puts (Sum1 + Sum2) / (Num1 + Num2) into the scope within
  the same of JAX's, as tensors of the parameter's dtype and device,
  and hands the live tensors themselves back on exit; under
  ``min_average_window`` the live parameters stay;
- ``static_prune_mask``: the mask equals JAX's bit for bit, ties too
  (constant weights keep the lowest indices, as ``jax.lax.top_k`` does);
- ``ParamAttr(update_hooks=StaticPruningHook(...))``: the same programs
  (the startup builds the mask and prunes the initial weights; the
  main program masks the weight after each update, with and without
  ``accumulate_steps``), and after four steps the pruned weights are
  still 0 and every weight equals JAX's within rtol 1e-5 / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op as torch_op
from test_torch_book import scopes
from test_torch_fused_head import trained_dict

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _both(op, attrs, ins):
    want = jax_op(op).fn(attrs, {k: [jnp.asarray(a) for a in v]
                                 for k, v in ins.items()})
    got = torch_op(op).fn(attrs, {k: [torch.from_numpy(a) for a in v]
                                  for k, v in ins.items()})
    return ({k: v[0].numpy() for k, v in got.items()},
            {k: np.asarray(v[0]) for k, v in want.items()})


@pytest.mark.parametrize("n1", [0.0, 1.0, 2.0])
def test_model_average_update_rolls_as_jax(n1):
    rng = np.random.RandomState(0)
    ins = {"Param": [rng.randn(3, 4).astype(np.float32)],
           "Sum1": [rng.randn(3, 4).astype(np.float32)],
           "Sum2": [rng.randn(3, 4).astype(np.float32)],
           "Num1": [np.array([n1], np.float32)],
           "Num2": [np.array([3.0], np.float32)]}
    got, want = _both("model_average_update", {"max_average_window": 3},
                      ins)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if n1 == 2.0:  # the window filled: Sum2 takes it, Sum1 restarts
        assert not got["Sum1Out"].any() and got["Num2Out"][0] == 3.0


@pytest.mark.parametrize("shape,ratio", [((6, 5), 0.6), ((7,), 0.3),
                                         ((4, 4), 0.0), ((3, 3), 0.95)])
def test_static_prune_mask_matches_jax(shape, ratio):
    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got, want = _both("static_prune_mask", {"sparsity_ratio": ratio},
                      {"Param": [w]})
    np.testing.assert_array_equal(got["Mask"], want["Mask"])
    keep = max(1, int(round(w.size * (1.0 - ratio))))
    assert got["Mask"].sum() == keep


@pytest.mark.parametrize("fill", [0.25, -1.0])
def test_static_prune_mask_ties_keep_the_lowest_indices(fill):
    w = np.full((5, 6), fill, np.float32)
    w[4, 5] = 2.0  # the largest, kept first
    got, want = _both("static_prune_mask", {"sparsity_ratio": 0.6},
                      {"Param": [w]})
    np.testing.assert_array_equal(got["Mask"], want["Mask"])
    flat = got["Mask"].reshape(-1)
    assert flat[-1] == 1 and flat[:11].all() and not flat[11:-1].any()


def _mlp(pt, hook=False, accumulate=1, average=None):
    L = pt.layers
    x = L.data("x", shape=[6])
    y = L.data("y", shape=[1], dtype="int64")
    attr = pt.ParamAttr(
        name="fc1.w", update_hooks=(pt.param_attr.Hook("pruning", 0.5)
                                    if hook else None))
    h = L.fc(x, size=8, act="relu", param_attr=attr)
    logits = L.fc(h, size=4, param_attr=pt.ParamAttr(name="fc2.w"))
    loss = L.mean(L.softmax_with_cross_entropy(logits, y))
    pt.optimizer.MomentumOptimizer(0.2, 0.9).minimize(
        loss, accumulate_steps=accumulate)
    ma = None
    if average is not None:
        ma = pt.optimizer.ModelAverage(min_average_window=average[0],
                                       max_average_window=average[1])
    return loss, ma


def _train_both(steps, **kw):
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 13
        with pt.program_guard(main, startup):
            loss, ma = _mlp(pt, **kw)
        built.append((main, startup, loss, ma))
    (jm, js, jl, jma), (tm, ts, tl, tma) = built
    assert trained_dict(tpt, tm) == trained_dict(jpt, jm)
    assert trained_dict(tpt, ts) == trained_dict(jpt, js)
    jscope, tscope = scopes(js, ts)
    rng = np.random.RandomState(7)
    for _ in range(steps):
        feed = {"x": rng.randn(16, 6).astype(np.float32),
                "y": rng.randint(0, 4, (16, 1)).astype(np.int64)}
        jpt.Executor(jpt.CPUPlace()).run(jm, feed=feed, fetch_list=[jl],
                                         scope=jscope)
        tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed, fetch_list=[tl],
                                         scope=tscope)
    return (jm, jscope, jma), (tm, tscope, tma)


def test_model_average_apply_matches_jax():
    (jm, jscope, jma), (tm, tscope, tma) = _train_both(6, average=(2, 3))
    names = [p.name for p in tm.global_block.all_parameters()]
    for n in tscope.keys():
        if "@MA_" in n:
            np.testing.assert_allclose(tscope.get_numpy(n),
                                       np.asarray(jscope.get(n)),
                                       err_msg=n, **TOL)
    live = {n: tscope.get(n) for n in names}
    with jma.apply(jscope), tma.apply(tscope):
        for n in names:
            got = tscope.get(n)
            assert isinstance(got, torch.Tensor)
            assert got.dtype == live[n].dtype
            assert got.device == live[n].device
            assert not torch.equal(got, live[n])
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(jscope.get(n)),
                                       err_msg=n, **TOL)
    for n in names:
        assert tscope.get(n) is live[n]


def test_model_average_keeps_live_params_under_the_minimum_window():
    _, (tm, tscope, tma) = _train_both(2, average=(5, 10))
    names = [p.name for p in tm.global_block.all_parameters()]
    live = {n: tscope.get(n) for n in names}
    with tma.apply(tscope):
        assert all(tscope.get(n) is live[n] for n in names)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_pruned_weights_stay_pruned_as_in_jax(accumulate):
    (jm, jscope, _), (tm, tscope, _) = _train_both(
        4, hook=True, accumulate=accumulate)
    mask = tscope.get_numpy("fc1.w@PRUNE_MASK")
    np.testing.assert_array_equal(mask,
                                  np.asarray(jscope.get("fc1.w@PRUNE_MASK")))
    assert mask.sum() == mask.size // 2
    w = tscope.get_numpy("fc1.w")
    assert not w[mask == 0].any() and w[mask == 1].all()
    for n in ("fc1.w", "fc2.w"):
        np.testing.assert_allclose(tscope.get_numpy(n),
                                   np.asarray(jscope.get(n)), err_msg=n,
                                   **TOL)
    ops = [op.type for op in tm.global_block.ops]
    assert ops[-1] == "elementwise_mul"


def test_hook_factory_and_its_checks():
    hook = tpt.param_attr.Hook("pruning", 0.25)
    assert isinstance(hook, tpt.param_attr.StaticPruningHook)
    assert hook.sparsity_ratio == 0.25
    with pytest.raises(ValueError, match="unknown updater hook"):
        tpt.param_attr.Hook("dynamic")
    with pytest.raises(ValueError, match="sparsity_ratio"):
        tpt.param_attr.StaticPruningHook(1.0)
    attr = tpt.ParamAttr(update_hooks=hook)
    assert attr.update_hooks == [hook]
    assert tpt.ParamAttr().update_hooks == []
