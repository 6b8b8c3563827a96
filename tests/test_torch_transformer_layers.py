"""The per-layer transformer LM and its new ops against the JAX package.

``transformer_lm(pipeline_stack=False)`` is the model the JAX package's
benchmark trains: ``n_layers`` ``transformer_encoder_layer`` blocks
(``multi_head_attention``: one fused qkv product, ``split``, ``reshape``
and ``transpose`` into heads, ``scaled_dot_product_attention``, the
out-projection; an FFN of ``fc`` + ``gelu`` + ``fc``; pre-norms), at
d 32, L 2, T 16 here.

- ``split``, ``transpose``, ``gelu`` and ``rms_norm`` (its grad_fn) run in
  both packages' registries on the same inputs: outputs and gradients
  (f32 at 1e-5; bf16 within the AMP tolerance or one bf16 ulp, see
  ``_assert_bf16_close``; bf16 ``gelu`` against JAX's f32 gelu of the
  same values rounded to bf16, because XLA rounds each of its seven bf16
  steps where torch's fused gelu rounds once); a program that uses two
  of a split's three parts trains through the generic backward as JAX's
  does.
- ``io.program_to_dict`` of the per-layer LM, f32 and under AMP, equals
  JAX's (op types, attrs, parameter names, declared dtypes).
- Step one's loss and every parameter gradient equal the JAX
  ``Executor``'s, each package starting from its own startup program
  (bit-exact draws): f32 at rtol 1e-4 (the base model and its GQA, RoPE
  and RMSNorm variants); under AMP at rtol 2e-2 / atol 2e-3, the JAX
  package's AMP tolerance (tests/test_norm_grads.py), every gradient in
  JAX's dtype.
- ``scaled_dot_product_attention`` on bf16 q/k/v (causal with
  ``Length``, and GQA) against JAX's CPU op, outputs and gradients,
  within the AMP tolerance or one bf16 ulp. That op runs
  ``reference_attention``, which takes S in bf16, so it lies off the
  Pallas kernels (whose rounding the port follows) by one ulp on some
  values: at B2 H4 T24 D16 causal, 9 of the port's 3072 outputs and 10
  of the Pallas kernel's lie outside the AMP tolerance alone.
- What is not ported raises: ``remat``, ``include_head=False``,
  ``moe_experts``, ``sequence_parallel``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.ops.common as jax_common
import paddle_tpu_torch as tpt
import paddle_tpu_torch.ops.common as torch_common
from paddle_tpu.core import program as jprog
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op as torch_op
from paddle_tpu_torch.core.types import to_numpy
from test_torch_transpiler import program_dict

torch.set_num_threads(1)
V, T, D_MODEL, LAYERS, HEADS, BATCH = 61, 16, 32, 2, 4, 3
OP_TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL = dict(rtol=1e-4, atol=1e-6)
AMP_TOL = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(params=[False, True], ids=["f32", "amp"])
def amp(request, monkeypatch):
    monkeypatch.setattr(jax_common, "_AMP", request.param)
    monkeypatch.setattr(torch_common, "_AMP", request.param)
    return request.param


def _f32(a):
    if isinstance(a, torch.Tensor):
        return to_numpy(a.detach())
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _assert_close(got, want, tol, what):
    assert _name(got.dtype) == _name(want.dtype), (what, got.dtype,
                                                    want.dtype)
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape)
    np.testing.assert_allclose(_f32(got), _f32(want), err_msg=what, **tol)


def _assert_bf16_close(got, want, what):
    """bf16 values within the AMP tolerance or one bf16 ulp of the wanted
    value, the ulp floored at 1/256 of max |want|: torch and XLA round
    bf16 at other places (XLA's bf16 ops round each step, ``gelu``'s
    seven and the reference attention's bf16 S; torch's fused ops round
    once), which moves single values by one ulp."""
    assert _name(got.dtype) == _name(want.dtype), (what, got.dtype,
                                                    want.dtype)
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape)
    g, w = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    ulp = np.maximum(np.exp2(np.floor(np.log2(np.maximum(np.abs(w),
                                                         2.0 ** -126))) - 7),
                     np.abs(w).max() / 256)
    err = np.abs(g - w)
    bad = (err > AMP_TOL["atol"] + AMP_TOL["rtol"] * np.abs(w)) & (err > ulp)
    assert not bad.any(), (what, int(bad.sum()), float(err[bad].max()))


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor in ``dtype``."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else dtype)
    return j, torch.from_numpy(_f32(j).copy()).to(getattr(torch, dtype))


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --- the ops -----------------------------------------------------------------
# (op, attrs, {slot: [(array, dtype)]}, differentiated slots, output slots)
OPS = {
    "split_sections": ("split", {"sections": [8, 4, 4], "axis": 2},
                       {"X": [(_r(2, 5, 16), "float32")]}, ["X"], ["Out"]),
    "split_num_bf16": ("split", {"num": 3, "axis": 1},
                       {"X": [(_r(2, 6, 4, seed=1), "bfloat16")]}, ["X"],
                       ["Out"]),
    "transpose": ("transpose", {"axis": [0, 2, 1, 3]},
                  {"X": [(_r(2, 5, 4, 3, seed=2), "float32")]}, ["X"],
                  ["Out"]),
    "transpose_bf16": ("transpose", {"axis": [0, 2, 1, 3]},
                       {"X": [(_r(2, 5, 4, 3, seed=3), "bfloat16")]}, ["X"],
                       ["Out"]),
    "gelu": ("gelu", {}, {"X": [(_r(4, 33, seed=4) * 3, "float32")]}, ["X"],
             ["Out"]),
    "gelu_bf16": ("gelu", {}, {"X": [(_r(4, 33, seed=5) * 3, "bfloat16")]},
                  ["X"], ["Out"]),
    "rms_norm": ("rms_norm", {"begin_norm_axis": 2, "epsilon": 1e-6},
                 {"X": [(_r(2, 3, 16, seed=6), "float32")],
                  "Scale": [(1 + _r(16, seed=7) * 0.1, "float32")]},
                 ["X", "Scale"], ["Y"]),
    "rms_norm_shift_bf16": ("rms_norm", {"begin_norm_axis": 2},
                            {"X": [(_r(2, 3, 16, seed=8), "bfloat16")],
                             "Scale": [(1 + _r(16, seed=9), "float32")],
                             "Bias": [(_r(16, seed=10), "float32")]},
                            ["X", "Scale", "Bias"], ["Y"]),
}


WIDEN = ("gelu_bf16",)


@pytest.mark.parametrize("case", sorted(OPS))
def test_op_and_its_gradient_match_jax(case):
    """Outputs, then the gradients of every output (one random cotangent
    each, in its dtype) with respect to the ``diff`` slots: the registered
    grad_fn where the op has one (rms_norm), else autograd against
    ``jax.vjp``, as the generic grad op differentiates the forward."""
    op_type, attrs, ins, diff, outs = OPS[case]
    close = (_assert_bf16_close if "bf16" in case else
             lambda g, w, what: _assert_close(g, w, OP_TOL, what))
    j = {s: [_pair(a, d)[0] for a, d in v] for s, v in ins.items()}
    t = {s: [_pair(a, d)[1] for a, d in v] for s, v in ins.items()}
    if case in WIDEN:
        # JAX's bf16 gelu rounds each of its seven steps (its gradient
        # more), the port's fused one once: hold the port to JAX's f32
        # gelu of the same bf16 values, rounded to bf16
        j = {s: [a.astype(jnp.float32) for a in v] for s, v in j.items()}
    jdef, tdef = jax_op(op_type), torch_op(op_type)
    want = jdef.fn(attrs, j)
    rng = np.random.RandomState(11)
    if tdef.grad_fn is not None:
        got = tdef.fn(attrs, t)
        cts = {s: rng.randn(*want[s][0].shape).astype(np.float32)
               for s in outs}
        jg = jdef.grad_fn(attrs, j, want, {
            s: [jnp.asarray(c).astype(want[s][0].dtype)]
            for s, c in cts.items()})
        tg = tdef.grad_fn(attrs, t, got, {
            s: [torch.from_numpy(c).to(got[s][0].dtype)]
            for s, c in cts.items()})
        grads = [(tg[s][0], jg[s][0], s) for s in diff]
    else:
        def jf(*xs):
            full = dict(j)
            for s, x in zip(diff, xs):
                full[s] = [x] + list(j[s][1:])
            o = jdef.fn(attrs, full)
            return [y for s in outs for y in o[s]]

        ys, vjp = jax.vjp(jf, *(j[s][0] for s in diff))
        cts = [_f32(jnp.asarray(rng.randn(*y.shape), jnp.bfloat16))
               for y in ys]  # bf16 values, exact in either dtype
        jgs = vjp([jnp.asarray(c).astype(y.dtype) for c, y in zip(cts, ys)])
        leaves = [t[s][0].requires_grad_() for s in diff]
        got = tdef.fn(attrs, t)
        tys = [y for s in outs for y in got[s]]
        tgs = torch.autograd.grad(tys, leaves, [
            torch.from_numpy(c).to(y.dtype) for c, y in zip(cts, tys)])
        grads = list(zip(tgs, jgs, diff))
    if case in WIDEN:
        want = {s: [w.astype(jnp.bfloat16) for w in v]
                for s, v in want.items()}
        grads = [(g, w.astype(jnp.bfloat16), s) for g, w, s in grads]
    for s in outs:
        assert len(got[s]) == len(want[s]), s
        for g, w in zip(got[s], want[s]):
            close(g, w, f"{op_type}.{s}")
    for g, w, s in grads:
        close(g, w, f"d{op_type}/d{s}")


def _split_net(pt):
    """An fc whose output is split in three, two parts reaching the loss:
    the generic backward gives the unused part a zero gradient."""
    x = pt.layers.data("x", shape=[6])
    h = pt.layers.fc(x, size=12)
    a, _, c = pt.layers.split(h, 3, dim=1)
    loss = pt.layers.elementwise_add(
        pt.layers.mean(a), pt.layers.scale(pt.layers.mean(pt.layers.transpose(
            pt.layers.reshape(c, [-1, 2, 2]), [0, 2, 1])), scale=2.0))
    return loss


def test_a_split_with_an_unused_part_trains_as_in_jax():
    feed = {"x": _r(5, 6, seed=12)}
    got = []
    start = jprog.Program._uid_counter
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 3
        with pt.program_guard(main, startup):
            loss = _split_net(pt)
            pgs = pt.optimizer.SGDOptimizer(0.1).minimize(loss)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        got.append(exe.run(main, feed=feed, scope=scope, fetch_list=[
            loss.name] + [g.name for _, g in pgs]))
    for j, t in zip(*got):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), **OP_TOL)
    assert np.abs(np.asarray(got[1][1])).sum() > 0


# --- the model ---------------------------------------------------------------
VARIANTS = {
    "base": {},
    "gqa": {"num_kv_heads": 2},
    "rope": {"use_rope": True},
    "rms_norm": {"norm_type": "rms_norm"},
}
# parameters at L2: 12 a block, the embeddings, the final norm and head;
# RoPE has no position table, RMSNorm no norm shifts
N_PARAMS = {"base": 25, "gqa": 25, "rope": 24, "rms_norm": 20}


def _lm(pt, variant="base", loss=True):
    ids = pt.layers.data("ids", shape=[T], dtype="int64")
    logits = pt.models.transformer_lm(
        ids, vocab_size=V, d_model=D_MODEL, n_layers=LAYERS,
        num_heads=HEADS, max_len=2 * T, **VARIANTS[variant])
    if not loss:
        return logits
    tgt = pt.layers.data("tgt", shape=[T], dtype="int64")
    return pt.layers.mean(pt.layers.softmax_with_cross_entropy(
        pt.layers.reshape(logits, shape=[-1, V]),
        pt.layers.reshape(tgt, shape=[-1, 1])))


def _build_both(variant, loss=True, optimizer=True):
    """(main, startup, out, param names) in each package, the names
    synced."""
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 5
        with pt.program_guard(main, startup):
            out = _lm(pt, variant, loss)
            params = []
            if optimizer:
                pgs = pt.optimizer.AdamOptimizer(1e-3).minimize(
                    out, startup_program=startup)
                params = [p.name for p, _ in pgs]
        built.append((main, startup, out, params))
    return built


def test_program_dicts_equal_jax(amp):
    (jmain, jstart, _, _), (tmain, tstart, _, _) = _build_both(
        "base", loss=False, optimizer=False)
    for jp, tp in ((jmain, tmain), (jstart, tstart),
                   (jmain.clone(for_test=True), tmain.clone(for_test=True))):
        assert program_dict(tpt, tp) == program_dict(jpt, jp)
    types = [op.type for op in tmain.global_block.ops]
    assert types.count("scaled_dot_product_attention") == LAYERS
    assert types.count("split") == types.count("gelu") == LAYERS
    dtypes = {v.name: _name(v.dtype)
              for v in tmain.global_block.all_parameters()}
    assert len(dtypes) == 25
    assert sorted(set(dtypes.values())) == (["bfloat16", "float32"] if amp
                                            else ["float32"])


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, V, size=(BATCH, T)).astype(np.int64),
            "tgt": rng.randint(0, V, size=(BATCH, T)).astype(np.int64)}


def _step_one(variant):
    """Each package's own startup, then one step: (JAX fetches, port
    fetches, names) of the loss and every parameter gradient."""
    (jmain, jstart, jloss, params), (tmain, tstart, tloss, tparams) = \
        _build_both(variant)
    assert tparams == params and len(params) == N_PARAMS[variant]
    names = [jloss.name] + [f"{p}@GRAD" for p in params]
    fetched = []
    for pt, main, start in ((jpt, jmain, jstart), (tpt, tmain, tstart)):
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(start, scope=scope)
        fetched.append(exe.run(main, feed=_feed(), fetch_list=names,
                               scope=scope, return_numpy=False))
    return fetched[0], fetched[1], names


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_one_loss_and_every_gradient_match_jax_f32(variant):
    jout, tout, names = _step_one(variant)
    for name, j, t in zip(names, jout, tout):
        _assert_close(t, j, F32_TOL, name)


@pytest.mark.parametrize("variant", ["base", "gqa"])
def test_step_one_loss_and_every_gradient_match_jax_under_amp(variant,
                                                              monkeypatch):
    monkeypatch.setattr(jax_common, "_AMP", True)
    monkeypatch.setattr(torch_common, "_AMP", True)
    jout, tout, names = _step_one(variant)
    assert {_name(t.dtype) for t in tout[1:]} == {"bfloat16", "float32"}
    for name, j, t in zip(names, jout, tout):
        _assert_close(t, j, AMP_TOL, name)


def test_per_layer_lm_trains():
    (_, _, _, _), (tmain, tstart, tloss, _) = _build_both("base")
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    exe.run(tstart, scope=scope)
    losses = [float(exe.run(tmain, feed=_feed(), fetch_list=[tloss],
                            scope=scope)[0]) for _ in range(4)]
    assert losses[-1] < losses[0], losses


# --- attention on bf16 heads ------------------------------------------------
@pytest.mark.parametrize("case", ["causal_length", "gqa"])
def test_sdpa_on_bf16_heads_matches_jax_cpu_op(case):
    B, H, Tn, D = 2, 4, 24, 16
    Hkv = 2 if case == "gqa" else H
    ins = {"Q": [(_r(B, H, Tn, D, seed=20), "bfloat16")],
           "K": [(_r(B, Hkv, Tn, D, seed=21), "bfloat16")],
           "V": [(_r(B, Hkv, Tn, D, seed=22), "bfloat16")]}
    attrs = {"causal": True}
    j = {s: [_pair(a, d)[0] for a, d in v] for s, v in ins.items()}
    t = {s: [_pair(a, d)[1] for a, d in v] for s, v in ins.items()}
    if case == "causal_length":
        j["Length"] = [jnp.asarray([Tn, 9], jnp.int32)]
        t["Length"] = [torch.tensor([Tn, 9])]
    slots = ("Q", "K", "V")

    def jf(q, k, v):
        return jax_op("scaled_dot_product_attention").fn(
            attrs, dict(j, Q=[q], K=[k], V=[v]))["Out"][0]

    y, vjp = jax.vjp(jf, *(j[s][0] for s in slots))
    ct = _r(*y.shape, seed=23)
    jgs = vjp(jnp.asarray(ct, jnp.bfloat16))
    leaves = [t[s][0].requires_grad_() for s in slots]
    got = torch_op("scaled_dot_product_attention").fn(attrs, t)["Out"][0]
    tgs = torch.autograd.grad(got, leaves,
                              torch.from_numpy(ct).to(torch.bfloat16))
    _assert_bf16_close(got, y, "Out")
    for s, g, w in zip(slots, tgs, jgs):
        _assert_bf16_close(g, w, f"d{s}")


# --- what is not ported -----------------------------------------------------
@pytest.mark.parametrize("kw", [{"include_head": False},
                                {"include_head": False, "remat": True}])
def test_unported_model_options_raise_naming_roadmap(kw):
    """The headless model is ported now (the chunked fused head): on the
    per-layer path it builds, with or without remat, and ends at the
    final norm; on the stacked path it raises the reference's ValueError
    before building anything."""
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        ids = tpt.layers.data("ids", shape=[T], dtype="int64")
        with pytest.raises(ValueError, match="include_head"):
            tpt.models.transformer_lm(ids, vocab_size=V, d_model=D_MODEL,
                                      n_layers=1, num_heads=HEADS,
                                      pipeline_stack=True, **kw)
        assert not main.global_block.ops  # nothing built before the raise
        h = tpt.models.transformer_lm(ids, vocab_size=V, d_model=D_MODEL,
                                      n_layers=1, num_heads=HEADS, **kw)
    assert main.global_block.ops[-1].type == "layer_norm"
    assert tuple(h.shape)[1:] == (T, D_MODEL)


@pytest.mark.parametrize("kw", [{"moe_experts": 4},
                                {"sequence_parallel": True}])
def test_unported_layer_options_raise_naming_roadmap(kw):
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", shape=[T, D_MODEL])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpt.layers.transformer_encoder_layer(x, num_heads=HEADS,
                                                 d_ff=64, **kw)
