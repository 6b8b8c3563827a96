"""Recompute segments (``recompute_guard``) in the port, against the JAX
package.

The per-layer LM (``transformer_lm(pipeline_stack=False, remat=True)``:
each block one recompute segment) at vocab 61, d 64, 2 layers, 4 heads,
T 40, batch 2, Adam, built in both packages from the same name counter.
After ``minimize`` both programs hold the same op types in the same
order (``seg_fwd`` in place of each block, ``grad_seg`` in the
backward). Each package starts from its own startup (bit-exact draws);
step one's loss and every parameter gradient equal the JAX ``Executor``'s
at rtol 1e-4 / atol 1e-6 (the port's f32 tolerance against JAX, as in
``tests/test_torch_transformer_layers.py``), and the port's ``remat=False``
run at rtol 1e-5 / atol 1e-7: not bitwise, since inside a segment the
norms are differentiated by autograd through their forward where outside
one their hand-written ``grad_fn`` runs (the JAX package differentiates
them the same way). Only the outputs of ``SEGMENT_SAVE_OPS`` ops and
tensors of at most one dim survive a ``seg_fwd`` (read through its
stash), and ``grad_seg`` frees the stash.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch import transpiler
from paddle_tpu_torch.core import backward as tback
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core import program as tprog

torch.set_num_threads(1)
V, T, D_MODEL, LAYERS, HEADS, BATCH = 61, 40, 64, 2, 4, 2
TOL = dict(rtol=1e-4, atol=1e-6)
SELF_TOL = dict(rtol=1e-5, atol=1e-7)


def _build(pt, counter, start, remat=True):
    """(main, startup, loss, parameter names, logits) of the LM with Adam;
    the test clone is taken before ``minimize``."""
    counter.Program._uid_counter = start
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[T], dtype="int64")
        logits = pt.models.transformer_lm(
            ids, vocab_size=V, d_model=D_MODEL, n_layers=LAYERS,
            num_heads=HEADS, max_len=T, remat=remat)
        tgt = pt.layers.data("tgt", shape=[T], dtype="int64")
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.reshape(logits, shape=[-1, V]),
            pt.layers.reshape(tgt, shape=[-1, 1])))
        pgs = pt.optimizer.AdamOptimizer(1e-3).minimize(
            loss, startup_program=startup)
    return main, startup, loss, [p.name for p, _ in pgs], logits


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, V, size=(BATCH, T)).astype(np.int64),
            "tgt": rng.randint(0, V, size=(BATCH, T)).astype(np.int64)}


def _step_one(pt, counter, start, remat=True):
    main, startup, loss, params, _ = _build(pt, counter, start, remat)
    names = [loss.name] + [f"{p}@GRAD" for p in params]
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    out = exe.run(main, feed=_feed(), fetch_list=names, scope=scope)
    return [np.asarray(a) for a in out], names


def test_op_types_after_minimize_match_jax():
    start = jprog.Program._uid_counter
    jmain = _build(jpt, jprog, start)[0]
    tmain = _build(tpt, tprog, start)[0]
    jtypes = [op.type for op in jmain.global_block.ops]
    ttypes = [op.type for op in tmain.global_block.ops]
    assert ttypes == jtypes
    assert ttypes.count("seg_fwd") == LAYERS
    assert ttypes.count("grad_seg") == LAYERS


def test_step_one_matches_jax_and_the_plain_backward():
    start = jprog.Program._uid_counter
    jout, names = _step_one(jpt, jprog, start)
    tout, tnames = _step_one(tpt, tprog, start)
    plain, _ = _step_one(tpt, tprog, start, remat=False)
    assert tnames == names and len(names) == 26  # the loss, 25 parameters
    for name, j, t, p in zip(names, jout, tout, plain):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, err_msg=name, **TOL)
        np.testing.assert_allclose(t, p, err_msg=name, **SELF_TOL)


def _kept_bytes(stash):
    """(bytes of the storages the stash's tensors hold, bytes of those
    and of every leaf its recorded vjps' graphs hold)."""
    storages = {}

    def add(t):
        storages[t.untyped_storage().data_ptr()] = \
            t.untyped_storage().nbytes()

    for t in list(stash.saved.values()) + list(stash.ext.values()):
        add(t)
    own = sum(storages.values())
    for _, _, outs in stash.closures.values():
        todo = [o.grad_fn for vals in outs.values() for o in vals
                if o is not None]
        done = set()
        while todo:
            fn = todo.pop()
            if fn is None or id(fn) in done:
                continue
            done.add(id(fn))
            if hasattr(fn, "variable"):  # a graph leaf
                add(fn.variable)
            todo.extend(f for f, _ in fn.next_functions)
    return own, sum(storages.values())


def _capture_stashes(monkeypatch):
    """Every seg_fwd the executor runs with a stash: (attrs, the stash by
    reference, what it saved, how many vjps it recorded and
    ``_kept_bytes`` of it)."""
    seen = []
    real = texec.segment_forward

    def capture(attrs, ins, stash=None):
        result = real(attrs, ins, stash)
        if stash is not None:
            seen.append((attrs, stash, dict(stash.saved),
                         len(stash.closures), _kept_bytes(stash)))
        return result

    monkeypatch.setattr(texec, "segment_forward", capture)
    return seen


def test_only_saved_op_outputs_and_small_tensors_survive(monkeypatch):
    seen = _capture_stashes(monkeypatch)
    main, startup, loss, _, _ = _build(tpt, tprog, jprog.Program._uid_counter)
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert len(seen) == LAYERS
    for attrs, stash, saved, n_closures, (own, kept) in seen:
        producer = {n: sop["type"] for sop in attrs["seg_ops"]
                    for names in sop["outs"].values() for n in names}
        expect = {n for sop in attrs["seg_ops"]
                  for names in sop["outs"].values() for n in names
                  if sop["type"] in tback.SEGMENT_SAVE_OPS}
        small = set(saved) - expect
        assert all(saved[n].ndim <= 1 for n in small), small
        assert expect <= set(saved)
        # the block's four projections, and not one [b, T, *] intermediate
        # of the norms, heads, attention, GELU or residual adds
        assert sum(producer[n] == "mul" for n in saved) == 4
        assert all(saved[n].ndim <= 1 or producer[n] == "mul"
                   for n in saved)
        assert n_closures == 4
        # the vjps' graphs hold no intermediate beyond one element a leaf
        assert kept - own <= 4 * 4 * n_closures, (own, kept)
        # grad_seg ran and freed the stash
        assert not stash.saved and not stash.closures and not stash.ext


def test_run_async_frees_every_stash(monkeypatch):
    seen = _capture_stashes(monkeypatch)
    main, startup, loss, _, _ = _build(tpt, tprog, jprog.Program._uid_counter)
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    handle = exe.run_async(main, feed=_feed(), fetch_list=[loss],
                           scope=scope)
    assert np.isfinite(handle.result()[0])
    assert len(seen) == LAYERS
    assert all(not s.saved and not s.closures for _, s, *_ in seen)


def test_expand_recompute_segments_gives_back_the_plain_ops():
    start = jprog.Program._uid_counter
    remat = _build(tpt, tprog, start)[0]
    plain = _build(tpt, tprog, start, remat=False)[0]
    n_fwd = next(i for i, op in enumerate(plain.global_block.ops)
                 if op.type == "fill_constant")
    transpiler.ExpandRecomputeSegments().apply(remat, None)
    flat = remat.global_block.ops
    assert "seg_fwd" not in [op.type for op in flat]
    for got, want in zip(flat[:n_fwd], plain.global_block.ops[:n_fwd]):
        assert (got.type, got.inputs, got.outputs) == (
            want.type, want.inputs, want.outputs)
    assert flat[n_fwd].type == "fill_constant"


def test_a_second_minimize_over_a_segment_program_raises():
    main, startup, loss, _, _ = _build(tpt, tprog,
                                       jprog.Program._uid_counter)
    with pytest.raises(NotImplementedError, match="seg_fwd"):
        with tpt.program_guard(main, startup):
            tpt.optimizer.SGDOptimizer(0.1).minimize(loss)


def test_inference_pipeline_takes_a_recomputed_programs_test_clone():
    """The trained program's for_test clone (segments inlined, backward
    dropped) serves the logits of the plain program's clone."""
    start = jprog.Program._uid_counter
    exe = tpt.Executor(tpt.CPUPlace())
    got = []
    for remat in (True, False):
        main, startup, _, _, logits = _build(tpt, tprog, start, remat)
        scope = tpt.Scope()
        exe.run(startup, scope=scope)
        served = transpiler.inference_pipeline().run(
            main.clone(for_test=True), ["ids"], [logits.name], scope=scope)
        types = [op.type for op in served.global_block.ops]
        assert "seg_fwd" not in types and "grad_seg" not in types
        got.append(exe.run(served, feed={"ids": _feed()["ids"]},
                           fetch_list=[logits.name], scope=scope)[0])
    np.testing.assert_array_equal(got[0], got[1])
