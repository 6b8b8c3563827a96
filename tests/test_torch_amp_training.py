"""Training and serving under mixed precision (AMP) against the JAX package.

Both packages build, train and serve with AMP on (set by ``monkeypatch``
in each: no ``set_amp`` call pins the JAX package's state):

- the narrow fused ResNet of ``tests/test_torch_resnet.py`` (7
  ``conv1x1_bn_act`` ops, Momentum) built under AMP with the name
  counters synced: every variable of the program carries JAX's dtype (a
  parameter fed by a bf16 activation is declared bf16, as in JAX). From
  each package's own startup (the port's values equal JAX's bit for bit),
  step one's loss matches at rtol 3e-3 (measured
  1.2e-3; JAX's own AMP loss is 6e-4 off its f32 loss), every gradient's
  dtype is JAX's, and so are every persistable variable's dtype after the
  step (Momentum's f32 velocity widens the bf16-declared parameters to
  f32, in both) and the BN running statistics' values. This net's step-1
  gradients are ill-conditioned under bf16: JAX's own AMP gradients lie
  11-57% (of their norm) from its f32 ones, because 12 BN layers over 32
  to 512 values amplify bf16's 2^-9 rounding ~75 times. So each gradient's
  distance from JAX's AMP one is held to 3 times JAX's own AMP-to-f32
  distance (measured at most 1.8 times) and all of them together to 1.5
  times (measured 1.02), which a dropped cast or a wrong op (moving a
  gradient by its whole size) fails;
- the 2-layer stacked LM of ``tests/test_torch_training.py`` (Adam):
  every variable's dtype, step one's loss and every gradient, and the
  state after the step (the head's logits are bf16, its parameters stay
  f32; a weight within 2 lr, since Adam's first step moves each weight by
  ~lr * sign(g) and a gradient that is zero up to rounding may flip);
- the AMP LM's prefill logits through the dense engine's path (the
  stack's ``_prefill`` and ``_logits_fn``, and the slot-prefill op's next
  tokens) and the paged engine's prefill op (its log-probs over the whole
  vocabulary).

Tolerance: rtol 2e-2 / atol 2e-3 of each value (the JAX package's own AMP
tolerance, tests/test_norm_grads.py), the loss at rtol 2e-3; next tokens
equal wherever the top two logits are further apart than the tolerance.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.ops.common as jax_common
import paddle_tpu_torch as tpt
import paddle_tpu_torch.ops.common as torch_common
from paddle_tpu.ops import pipeline_ops as jops
from paddle_tpu_torch.core.types import to_numpy
from paddle_tpu_torch.ops import pipeline_ops as tops

torch.set_num_threads(1)
TOL = dict(rtol=2e-2, atol=2e-3)
LOSS_RTOL = 2e-3
RESNET_LOSS_RTOL = 3e-3
GRAD_FACTOR, GRAD_TOTAL = 3.0, 1.5  # x JAX's own AMP-to-f32 move


@pytest.fixture
def amp(monkeypatch):
    monkeypatch.setattr(jax_common, "_AMP", True)
    monkeypatch.setattr(torch_common, "_AMP", True)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _port_startup(tstart, values):
    """The port's own startup run into a new Scope; every value equals the
    JAX startup's (``values``, under the port's names) bit for bit, in its
    own dtype (int64 reads as the int32 JAX holds it as without x64)."""
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(tstart, scope=scope)
    for name, a in values.items():
        t = scope.get(name)
        assert _name(t.dtype).replace("int64", "int32") == a.dtype.name, (
            name, t.dtype, a.dtype)
        np.testing.assert_array_equal(to_numpy(t), _f32(a) if a.dtype.name
                                      == "bfloat16" else a, err_msg=name)
    return scope


def _carry(jstart, tstart, jscope):
    """The JAX startup's values under the port's names (the startup
    programs hold the same ops in the same order)."""
    values = {}
    for jop, top in zip(jstart.global_block.ops, tstart.global_block.ops):
        for jn, tn in zip(jop.output_names(), top.output_names()):
            values[tn] = np.asarray(jscope.get(jn))
    return values


def _norm(name):
    """A name without the counters each package's backward advances its
    own way (x@GRAD@R_9, x@PRE_7, learning_rate_11)."""
    return re.sub(r"(@[A-Z]+|learning_rate)_\d+", r"\1", name)


def _var_dtypes(program):
    """(name, dtype) of every variable; int64 reads as int32, as the JAX
    package carries it without x64 (a difference in kind)."""
    return sorted((_norm(n), str(v.dtype).replace("torch.", "")
                   .replace("int64", "int32"))
                  for n, v in program.global_block.vars.items())


def _assert_same(got, want, what, tol=TOL):
    assert _name(got.dtype) == _name(want.dtype), (what, got.dtype,
                                                    want.dtype)
    np.testing.assert_allclose(to_numpy(got), _f32(want), err_msg=what,
                               **tol)


def _step(jexe, jmain, jscope, texe, tmain, tscope, feed, fetch):
    jout = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope,
                    return_numpy=False)
    tout = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope,
                    return_numpy=False)
    return jout, tout


def _check_step(jout, tout, names):
    _assert_same(tout[0], jout[0], "loss", dict(rtol=LOSS_RTOL, atol=0))
    for name, j, t in zip(names[1:], jout[1:], tout[1:]):
        _assert_same(t, j, name)


# --- the narrow fused ResNet -------------------------------------------------
def _resnet_f32_grads(start, values, feed, names):
    """JAX's f32 step-1 loss and gradients of the same net (names synced
    to ``start``) from the same startup values, widened to f32: the
    yardstick of how far bf16 rounding moves them."""
    from paddle_tpu.core import program as jprog
    from test_torch_resnet import _build, _narrow

    jprog.Program._uid_counter = start
    main, startup = _build(jpt, _narrow, 32, fused=True)[:2]
    scope, exe = jpt.Scope(), jpt.Executor(jpt.CPUPlace())
    exe.run(startup, scope=scope)
    for name, a in values.items():
        scope.set(name, jnp.asarray(_f32(a)))
    return exe.run(main, feed=feed, fetch_list=names, scope=scope)


def test_fused_resnet_step_under_amp_matches_jax(amp, monkeypatch):
    from paddle_tpu.core import program as jprog
    from test_torch_resnet import _build_both, _feeds, _narrow

    start = jprog.Program._uid_counter
    (jmain, jstart, _, jloss, _, params), \
        (tmain, tstart, _, tloss, _, tparams) = _build_both(
            _narrow, 32, fused=True)
    assert tparams == params
    assert sum(op.type == "conv1x1_bn_act"
               for op in tmain.global_block.ops) == 7
    assert _var_dtypes(tmain) == _var_dtypes(jmain)
    dtypes = dict(_var_dtypes(tmain))
    assert dtypes[params[0]] == "float32"  # fed by the f32 images
    assert "bfloat16" in [dtypes[p] for p in params]
    jscope, jexe = jpt.Scope(), jpt.Executor(jpt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    values = _carry(jstart, tstart, jscope)
    tscope = _port_startup(tstart, values)
    texe = tpt.Executor(tpt.CPUPlace())
    names = [jloss.name] + [f"{p}@GRAD" for p in params]
    feed = _feeds(1, seed=1)[0]
    jout, tout = _step(jexe, jmain, jscope, texe, tmain, tscope, feed,
                       names)
    _assert_same(tout[0], jout[0], "loss",
                 dict(rtol=RESNET_LOSS_RTOL, atol=0))
    for name in sorted(values):  # the state after the step
        if "learning_rate" in name:  # named apart by each backward
            continue
        _assert_same(tscope.get(name), jscope.get(name), name,
                     TOL if name.endswith((".mean", ".var")) else
                     dict(rtol=np.inf, atol=np.inf))  # dtype only
    assert all(tscope.get(p).dtype == torch.float32 for p in params)
    monkeypatch.setattr(jax_common, "_AMP", False)
    f32 = _resnet_f32_grads(start, values, feed, names)
    d_port, d_amp = [], []
    for name, j, t, f in zip(names[1:], jout[1:], tout[1:], f32[1:]):
        assert _name(t.dtype) == _name(j.dtype), (name, t.dtype, j.dtype)
        j = _f32(j)
        d_port.append(float(np.linalg.norm(to_numpy(t) - j)))
        d_amp.append(float(np.linalg.norm(_f32(f) - j)))
        assert d_port[-1] <= GRAD_FACTOR * d_amp[-1], (name, d_port[-1],
                                                      d_amp[-1])
    assert np.linalg.norm(d_port) <= GRAD_TOTAL * np.linalg.norm(d_amp)


# --- the 2-layer stacked LM --------------------------------------------------
def test_stacked_lm_step_under_amp_matches_jax(amp):
    from paddle_tpu.core import program as jprog
    from paddle_tpu_torch.core import program as tprog
    from test_torch_training import _batches, _build

    start = jprog.Program._uid_counter
    jmain, jstart, jloss, params = _build(jpt, "adam")
    tprog.Program._uid_counter = start  # every name agrees
    tmain, tstart, tloss, tparams = _build(tpt, "adam")
    assert tparams == params and len(params) == 15
    assert {n: d for n, d in _var_dtypes(tmain) if "@" not in n} == \
        {n: d for n, d in _var_dtypes(jmain) if "@" not in n}
    jscope, jexe = jpt.Scope(), jpt.Executor(jpt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    values = _carry(jstart, tstart, jscope)
    tscope = _port_startup(tstart, values)
    texe = tpt.Executor(tpt.CPUPlace())
    names = [jloss.name] + [f"{p}@GRAD" for p in params]
    jout, tout = _step(jexe, jmain, jscope, texe, tmain, tscope,
                       _batches(1)[0], names)
    _check_step(jout, tout, names)
    # the head's logits are a bf16 product; the parameters stay f32
    logits = [n for n in tmain.global_block.vars if n.startswith("fc.out")]
    assert tmain.global_block.var(logits[0]).dtype == torch.bfloat16
    assert all(tscope.get(p).dtype == torch.float32 for p in params)
    # Adam's first step moves each weight by ~lr * sign(g): a gradient
    # that is zero up to rounding may flip a weight by 2 lr (3e-3 here)
    for name in sorted(values):
        if "learning_rate" in name:
            continue
        tol = (dict(rtol=0, atol=2 * 3e-3 + TOL["atol"]) if name in params
               else TOL)
        _assert_same(tscope.get(name), jscope.get(name), name, tol)


# --- prefill logits of the AMP LM through both engines' paths ---------------
V, D, L, H = 97, 32, 2, 4


def _lm_ins(seed=0):
    from paddle_tpu_torch.models.transformer import init_params
    from paddle_tpu_torch.serving import LMSpec

    spec = LMSpec(vocab_size=V, d_model=D, n_layers=L, num_heads=H,
                  max_len=64)
    w = init_params(spec, seed)
    rng = np.random.RandomState(seed + 1)
    for name in w:  # non-trivial norms and biases
        if name.endswith(("_s", "_b", "_b1", "_b2", ".scale", ".bias")):
            w[name] = (w[name] + 0.1 * rng.randn(*w[name].shape)).astype(
                np.float32)
    lm = {"TokEmb": w["tok_emb"], "PosEmb": w["pos_emb"],
          "FinalLnS": w["final_ln.scale"], "FinalLnB": w["final_ln.bias"],
          "HeadW": w["lm_head.w"]}
    for slot, key in tops._STACK_SLOTS.items():
        lm[slot] = w[f"lm_stack.stack_{key}"]
    return lm


def _both(arrays):
    return ({k: [jnp.asarray(a)] for k, a in arrays.items()},
            {k: [torch.from_numpy(np.array(a))] for k, a in arrays.items()})


def _clear_argmax(logits):
    """Rows whose top two logits are further apart than the tolerance."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > TOL["atol"] + TOL["rtol"] * np.abs(
        top2[:, 1])


def test_dense_prefill_logits_under_amp_match_jax(amp):
    lm = _lm_ins()
    prompt = np.random.RandomState(3).randint(0, V, (3, 12)).astype(np.int64)
    jins, tins = _both(dict(lm, Prompt=prompt))

    def logits(ops, ins, stack):
        params = {k: ins[s][0] for s, k in ops._STACK_SLOTS.items()}
        x = ops._embed_fn(ins["TokEmb"][0], ins["PosEmb"][0])(stack(prompt),
                                                               0)
        h = ops._prefill(params, x, H, 3, 12)[0]
        return ops._logits_fn(ins["FinalLnS"][0], ins["FinalLnB"][0],
                              ins["HeadW"][0])(h[:, -1])

    want = logits(jops, jins, jnp.asarray)
    got = logits(tops, tins, torch.from_numpy)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the slot-prefill op picks its first token from these logits
    cache = np.zeros((L, 4, H, 16, D // H), np.float32)
    attrs = {"num_heads": H, "temperature": 0.0, "top_k": 0}
    jo = jops.transformer_stack_slot_prefill(attrs, _both(dict(
        lm, Prompt=prompt, SlotIds=np.arange(3, dtype=np.int32),
        Lengths=np.full(3, 12, np.int32), CacheK=cache, CacheV=cache))[0])
    to = tops.transformer_stack_slot_prefill(attrs, _both(dict(
        lm, Prompt=prompt, SlotIds=np.arange(3, dtype=np.int32),
        Lengths=np.full(3, 12, np.int32), CacheK=cache, CacheV=cache))[1])
    clear = _clear_argmax(np.asarray(want))
    assert clear.any()
    np.testing.assert_array_equal(to["NextTok"][0].numpy()[clear],
                                  np.asarray(jo["NextTok"][0])[clear])


def test_paged_prefill_logprobs_under_amp_match_jax(amp):
    lm = _lm_ins(seed=2)
    rng = np.random.RandomState(4)
    b, tc, ps, pmax, n_pages = 3, 8, 4, 6, 20
    pool = rng.randn(L, n_pages, H, ps, D // H).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, n_pages))[:pmax]
                      for _ in range(b)]).astype(np.int32)
    ins = dict(lm, Chunk=rng.randint(0, V, (b, tc)),
               StartPos=np.array([0, 5, 11], np.int32),
               Lengths=np.array([8, 3, 6], np.int32), BlockTable=table,
               CacheK=pool, CacheV=pool[::-1].copy())
    attrs = {"num_heads": H, "page_size": ps, "emit_topk": V}
    jins, tins = _both(ins)
    want = jops.transformer_stack_paged_prefill(attrs, jins)
    got = tops.transformer_stack_paged_prefill(attrs, tins)

    def full(vals, ids):
        out = np.zeros((b, V), np.float32)
        np.put_along_axis(out, np.asarray(ids).astype(np.int64),
                          np.asarray(vals), axis=1)
        return out

    jl = full(want["TopV"][0], want["TopI"][0])
    tl = full(got["TopV"][0].numpy(), got["TopI"][0].numpy())
    np.testing.assert_allclose(tl, jl, **TOL)
    clear = _clear_argmax(jl)
    assert clear.any()
    np.testing.assert_array_equal(got["NextTok"][0].numpy()[clear],
                                  np.asarray(want["NextTok"][0])[clear])
    for slot in ("CacheK", "CacheV"):  # K/V are f32 (cast back from bf16)
        a, w = got[slot][0].numpy()[:, 1:], np.asarray(want[slot][0])[:, 1:]
        np.testing.assert_allclose(a, w, **TOL)


# --- an AMP program through the inference pipeline --------------------------
@pytest.mark.parametrize("fused", [False, True])
def test_amp_program_through_the_inference_pipeline_matches_jax(amp, fused):
    """The narrow ResNet built under AMP (parameters fed by bf16
    activations declared bf16) through both packages' inference
    pipelines: equal program dicts, and every folded weight and bias in
    JAX's dtype and bitwise equal to JAX's (rounded to bf16 by torch,
    which needs no ml_dtypes); the transpiled programs' logits under AMP
    agree within 3e-2 of the largest |logit| (tests/tpu_tier.py's AMP
    tolerance; measured 8e-3: twelve convs round the activations to bf16
    in turn, and two sums in another order round apart at a tie)."""
    from paddle_tpu.core import program as jprog
    from paddle_tpu_torch.core import program as tprog
    from test_torch_transpiler import program_dict, resnet_net

    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        pt.flags.FLAGS.fused_conv_epilogue = fused
        try:
            main, startup = pt.Program(), pt.Program()
            startup.random_seed = 5
            with pt.program_guard(main, startup):
                feeds, fetch = resnet_net(pt)
        finally:
            pt.flags.FLAGS.fused_conv_epilogue = False
        built.append((main.clone(for_test=True), startup, fetch.name))
    (jmain, jstart, name), (tmain, tstart, _) = built
    jscope = jpt.Scope()
    jpt.Executor(jpt.CPUPlace()).run(jstart, scope=jscope)
    tscope = _port_startup(tstart, _carry(jstart, tstart, jscope))
    feed = {k: v.astype(np.float32) for k, v in feeds.items()}
    out = []
    for pt, main, scope in ((jpt, jmain, jscope), (tpt, tmain, tscope)):
        pt.flags.FLAGS.fused_conv_epilogue = fused
        try:
            child = pt.Scope(parent=scope)
            prog = pt.transpiler.inference_pipeline().run(
                main.clone(), sorted(feed), [name], scope=child)
        finally:
            pt.flags.FLAGS.fused_conv_epilogue = False
        logits = pt.Executor(pt.CPUPlace()).run(
            prog, feed=feed, fetch_list=[name], scope=child,
            return_numpy=False)[0]
        out.append((prog, child, logits))
    (jp, jchild, jl), (tp, tchild, tl) = out
    assert program_dict(tpt, tp) == program_dict(jpt, jp)
    new = sorted(jchild.keys())
    assert sorted(tchild.keys()) == new
    assert any(n.endswith("@bnfold_bias") and
               _name(tchild.get(n).dtype) == "bfloat16" for n in new)
    for n in new:
        assert _name(tchild.get(n).dtype) == _name(jchild.get(n).dtype), n
        np.testing.assert_array_equal(to_numpy(tchild.get(n)),
                                      _f32(jchild.get(n)), err_msg=n)
    assert _name(tl.dtype) == _name(jl.dtype)
    err = np.abs(to_numpy(tl) - _f32(jl)).max()
    assert err <= 3e-2 * np.abs(_f32(jl)).max(), err
