"""The ``top_k`` and ``accuracy`` ops, and ``layers.topk`` /
``layers.accuracy``, in the port against the JAX package.

``top_k`` must give ``jax.lax.top_k``'s values and int64 indices, ties
included (the lower index first): inputs drawn from a handful of
integers tie often. ``accuracy`` gives the same share and counts, with
labels inside and outside the top k. Exact equality: both ops select
and count, they do not round.
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core.registry import get_op as jget_op
from paddle_tpu_torch.core.registry import get_op as tget_op

torch.set_num_threads(1)


def _ties(shape, seed, levels=4):
    return np.random.RandomState(seed).randint(0, levels, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,k,levels", [
    ((7,), 3, 3), ((5, 9), 1, 4), ((5, 9), 4, 2), ((2, 3, 16), 16, 5),
    ((6, 10), 5, 1000)])
def test_top_k_matches_jax_ties_included(shape, k, levels):
    x = _ties(shape, seed=k, levels=levels)
    j = jget_op("top_k").fn({"k": k}, {"X": [jax.numpy.asarray(x)]})
    t = tget_op("top_k").fn({"k": k}, {"X": [torch.from_numpy(x)]})
    assert t["Indices"][0].dtype == torch.int64
    np.testing.assert_array_equal(t["Out"][0].numpy(), np.asarray(j["Out"][0]))
    np.testing.assert_array_equal(t["Indices"][0].numpy(),
                                  np.asarray(j["Indices"][0]))


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_op_matches_jax(k):
    logits = _ties((12, 6), seed=7)
    label = np.random.RandomState(8).randint(0, 6, (12, 1)).astype(np.int64)
    label[:4, 0] = np.argmax(logits[:4], axis=1)  # inside the top k
    jv, ji = jax.lax.top_k(jax.numpy.asarray(logits), k)
    j = jget_op("accuracy").fn({}, {"Out": [jv], "Indices": [ji],
                                    "Label": [jax.numpy.asarray(label)]})
    tk = tget_op("top_k").fn({"k": k}, {"X": [torch.from_numpy(logits)]})
    t = tget_op("accuracy").fn({}, {"Out": tk["Out"],
                                    "Indices": tk["Indices"],
                                    "Label": [torch.from_numpy(label)]})
    for slot in ("Accuracy", "Correct", "Total"):
        got, want = t[slot][0].numpy(), np.asarray(j[slot][0])
        assert got.dtype == want.dtype, slot
        np.testing.assert_array_equal(got, want, err_msg=slot)
    assert 4 <= int(t["Correct"][0]) < 12


def _program(pt, k):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[6])
        y = pt.layers.data("y", shape=[1], dtype="int64")
        vals, idx = pt.layers.topk(x, k)
        acc = pt.layers.accuracy(x, y, k=k)
    return main, [vals, idx, acc]


@pytest.mark.parametrize("k", [1, 2])
def test_layers_topk_and_accuracy_in_a_program_match_jax(k):
    feed = {"x": _ties((10, 6), seed=3),
            "y": np.random.RandomState(4).randint(0, 6, (10, 1))
            .astype(np.int64)}
    jmain, jf = _program(jpt, k)
    tmain, tf = _program(tpt, k)
    assert [op.type for op in tmain.global_block.ops] == [
        op.type for op in jmain.global_block.ops]
    assert tf[1].shape == jf[1].shape and tf[2].shape == jf[2].shape
    j = jpt.Executor(jpt.CPUPlace()).run(jmain, feed=feed, fetch_list=jf,
                                         scope=jpt.Scope())
    t = tpt.Executor(tpt.CPUPlace()).run(tmain, feed=feed, fetch_list=tf,
                                         scope=tpt.Scope())
    for got, want in zip(t, j):
        np.testing.assert_array_equal(got, np.asarray(want))
