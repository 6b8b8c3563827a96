"""The transformer NMT family against the JAX package's.

- The four seq2seq ops (``transformer_encdec_encode``,
  ``transformer_stack_cross_prefill``, ``transformer_stack_cross_decode``,
  ``transformer_encdec_teacher``) are called directly in both packages
  with the same ``ins`` from a numpy seed: logits within 1e-5 (abs, f32
  values of order 1), the cross K/V and the page pools within 1e-5,
  next tokens and TopI equal, TopV within 1e-5.
- ``demos/nmt_transformer.py``'s training program is built in both
  packages (name counters synced; the JAX startup's values carried over
  by op position). After one Adam step from the same weights, step 2's
  loss and every parameter gradient must sit within ``NUDGE_MULT`` times
  the port's own move under a one-ulp nudge of the weights (each
  tensor's gap in its norm; a floor of 1e-6 of the norm); the decoder's
  flash attention runs its plain version here. The demo's first 5 losses
  agree step by step within 1e-5 relative (long runs drift: Adam's
  first steps amplify rounding).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.ops import seq2seq_ops as jops
from paddle_tpu_torch.ops import seq2seq_ops as tops
from test_torch_book import build_both, scopes

torch.set_num_threads(1)
ATOL = 1e-5
LOSS_RTOL = 1e-5
NUDGE_MULT = 4.0
GRAD_FLOOR = 1e-6
VS, VT, D, L, H, F = 23, 19, 16, 2, 2, 40
TSMAX, TTMAX, SLOTS, PS, NPAGES = 12, 16, 3, 4, 9

_DEMO = Path(__file__).resolve().parents[1] / "demos" / "nmt_transformer.py"


def _demo():
    spec = importlib.util.spec_from_file_location("nmt_demo", _DEMO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weights(rng, kv_heads=H):
    dkv = D // H * kv_heads

    def w(*shape, scale=0.3):
        return (scale * rng.randn(*shape)).astype(np.float32)

    def stack(prefix):
        return {f"{prefix}Ln1S": 1 + w(L, D, scale=0.1),
                f"{prefix}Ln1B": w(L, D, scale=0.1),
                f"{prefix}QkvW": w(L, D, D + 2 * dkv),
                f"{prefix}OutW": w(L, D, D),
                f"{prefix}Ln2S": 1 + w(L, D, scale=0.1),
                f"{prefix}Ln2B": w(L, D, scale=0.1),
                f"{prefix}FfW1": w(L, D, F), f"{prefix}FfB1": w(L, F),
                f"{prefix}FfW2": w(L, F, D), f"{prefix}FfB2": w(L, D)}

    dec = {"TokEmb": w(VT, D), "PosEmb": w(TTMAX, D),
           "FinalLnS": 1 + w(D, scale=0.1), "FinalLnB": w(D, scale=0.1),
           "HeadW": w(D, VT), "XLnS": 1 + w(L, D, scale=0.1),
           "XLnB": w(L, D, scale=0.1), "XQW": w(L, D, D),
           "XOutW": w(L, D, D), **stack("")}
    enc = {"SrcTokEmb": w(VS, D), "SrcPosEmb": w(TSMAX, D),
           "EncLnS": 1 + w(D, scale=0.1), "EncLnB": w(D, scale=0.1),
           "XKvW": w(L, D, 2 * dkv), **stack("Enc")}
    return dec, enc


def _both(arrays):
    return ({k: [jnp.asarray(a)] for k, a in arrays.items()},
            {k: [torch.from_numpy(np.array(a))] for k, a in arrays.items()})


def _close(got, want, slots, exact=("NextTok", "TopI", "Ok")):
    for slot in slots:
        g, w = got[slot][0].numpy(), np.asarray(want[slot][0])
        if slot in exact:
            np.testing.assert_array_equal(g, w, err_msg=slot)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=slot)


KV = {"mha": H, "gqa": 1}


@pytest.mark.parametrize("kv", sorted(KV))
def test_seq2seq_ops_match_jax(kv):
    rng = np.random.RandomState(1)
    dec, enc = _weights(rng, KV[kv])
    attrs = {"num_heads": H, "num_kv_heads": KV[kv]}
    dkv = D // H * KV[kv]
    cross_shape = (L, SLOTS + 1, KV[kv], TSMAX, dkv // KV[kv])
    # encode: two sources into rows 2 and 0, a padding row into scrap
    src = rng.randint(0, VS, (3, 8)).astype(np.int64)
    src_len = np.array([8, 5, 1], np.int32)
    ins = dict(enc, SrcIds=src, SrcLen=src_len,
               SlotIds=np.array([2, 0, SLOTS], np.int32),
               CrossK=rng.randn(*cross_shape).astype(np.float32),
               CrossV=rng.randn(*cross_shape).astype(np.float32))
    jins, tins = _both(ins)
    jout = jops.transformer_encdec_encode(attrs, jins)
    tout = tops.transformer_encdec_encode(attrs, tins)
    _close(tout, jout, ("Ok", "CrossK", "CrossV"))
    assert tout["CrossK"][0] is tins["CrossK"][0]  # written in place
    cross_k = np.asarray(jout["CrossK"][0])
    cross_v = np.asarray(jout["CrossV"][0])

    # chunk prefill of three rows (one padding) against those rows
    b, tc, P = 3, 8, 4
    pool_shape = (L, NPAGES, KV[kv], PS, dkv // KV[kv])
    pool = rng.randn(*pool_shape).astype(np.float32)
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0]], np.int32)
    plane = {"Temperature": np.array([0.0, 0.8, 0.0], np.float32),
             "TopK": np.array([0, 5, 0], np.int32),
             "TopP": np.array([1.0, 1.0, 1.0], np.float32),
             "Seed": np.array([1, 2, 3], np.int32),
             "Step": np.array([0, 4, 0], np.int32),
             "Mask": (rng.rand(b, VT) > 0.2).astype(np.float32)}
    a = dict(attrs, page_size=PS, emit_topk=3)
    ins = dict(dec, **plane, Chunk=rng.randint(0, VT, (b, tc)),
               StartPos=np.array([0, 2, 0], np.int32),
               Lengths=np.array([7, 5, 0], np.int32), BlockTable=table,
               XSlot=np.array([2, 0, SLOTS], np.int32),
               SrcLen=np.array([8, 5, 1], np.int32), CacheK=pool,
               CacheV=pool[::-1].copy(), CrossK=cross_k, CrossV=cross_v)
    jins, tins = _both(ins)
    jout = jops.transformer_stack_cross_prefill(a, jins)
    tout = tops.transformer_stack_cross_prefill(a, tins)
    _close(tout, jout, ("NextTok", "CacheK", "CacheV", "TopV", "TopI"))

    # one decode step over every slot (the last vacant: scrap row, page 0)
    ins = dict(dec, **plane, Tok=rng.randint(0, VT, (b,)),
               Pos=np.array([7, 9, 0], np.int32), BlockTable=table,
               XSlot=np.array([2, 0, SLOTS], np.int32),
               SrcLen=np.array([8, 5, 1], np.int32),
               CacheK=np.asarray(jout["CacheK"][0]),
               CacheV=np.asarray(jout["CacheV"][0]), CrossK=cross_k,
               CrossV=cross_v)
    jins, tins = _both(ins)
    jout = jops.transformer_stack_cross_decode(a, jins)
    tout = tops.transformer_stack_cross_decode(a, tins)
    _close(tout, jout, ("NextTok", "CacheK", "CacheV", "TopV", "TopI"))

    # the teacher-forced forward
    ins = dict(dec, **enc, SrcIds=src, SrcLen=src_len,
               TgtIn=rng.randint(0, VT, (3, 10)).astype(np.int64))
    jins, tins = _both(ins)
    _close(tops.transformer_encdec_teacher(attrs, tins),
           jops.transformer_encdec_teacher(attrs, jins), ("Logits",))


def test_the_four_ops_are_registered():
    from paddle_tpu_torch.core.registry import get_op

    for name in ("transformer_encdec_encode", "transformer_stack_cross_prefill",
                 "transformer_stack_cross_decode",
                 "transformer_encdec_teacher"):
        assert get_op(name).fn is getattr(tops, name)


def _demo_train(demo):
    def build(pt):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            src = pt.layers.data("src", shape=[demo.TS], dtype="int64")
            slen = pt.layers.data("slen", shape=[], dtype="int32")
            tgt_in = pt.layers.data("tgt_in", shape=[demo.TT], dtype="int64")
            tgt_next = pt.layers.data("tgt_next", shape=[demo.TT],
                                      dtype="int64")
            logits = pt.models.transformer_nmt_teacher(
                src, slen, tgt_in, src_vocab_size=demo.SRC_V,
                tgt_vocab_size=demo.TGT_V, d_model=demo.D,
                n_layers=demo.L, num_heads=demo.H, max_src_len=demo.TS,
                max_tgt_len=demo.TT)
            loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
                pt.layers.reshape(logits, shape=[-1, demo.TGT_V]),
                pt.layers.reshape(tgt_next, shape=[-1, 1])))
            pt.optimizer.AdamOptimizer(learning_rate=4e-3).minimize(
                loss, startup_program=startup)
        return dict(main=main, startup=startup, loss=loss)
    return build


def _feeds(demo, n, bs=32):
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(n):
        src, slen, tgt_in, tgt_next = demo.make_batch(rng, bs, demo.TS)
        feeds.append({"src": src, "slen": slen, "tgt_in": tgt_in,
                      "tgt_next": tgt_next})
    return feeds


def test_demo_losses_match_jax_step_by_step():
    demo = _demo()
    j, t = build_both(_demo_train(demo))
    jscope, tscope = scopes(j["startup"], t["startup"])
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    for step, feed in enumerate(_feeds(demo, 5)):
        jl, = jexe.run(j["main"], feed=feed, fetch_list=[j["loss"]],
                       scope=jscope)
        tl, = texe.run(t["main"], feed=feed, fetch_list=[t["loss"]],
                       scope=tscope)
        np.testing.assert_allclose(float(np.asarray(tl)),
                                   float(np.asarray(jl)), rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")


def _params(program):
    return sorted(v.name for v in program.global_block.vars.values()
                  if type(v).__name__ == "Parameter")


def test_teacher_gradients_after_an_adam_step_match_jax():
    demo = _demo()
    j, t = build_both(_demo_train(demo))
    jscope, tscope = scopes(j["startup"], t["startup"])
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    f1, f2 = _feeds(demo, 2)
    jexe.run(j["main"], feed=f1, fetch_list=[j["loss"]], scope=jscope)
    texe.run(t["main"], feed=f1, fetch_list=[t["loss"]], scope=tscope)
    params = _params(t["main"])
    assert len(params) == 34 and params == _params(j["main"])
    names = [t["loss"].name] + [f"{p}@GRAD" for p in params]
    # the port's own move: the same step from weights one ulp up
    state = {n: tscope.get_numpy(n) for n in params}
    nudged = tpt.Scope()
    for n in tscope.keys():
        v = tscope.get(n)
        nudged.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    for n, v in state.items():
        nudged.set(n, torch.from_numpy(np.nextafter(v, np.float32(np.inf))))
    want = jexe.run(j["main"], feed=f2, fetch_list=names, scope=jscope)
    got = texe.run(t["main"], feed=f2, fetch_list=names, scope=tscope)
    move = texe.run(t["main"], feed=f2, fetch_list=names, scope=nudged)
    for name, g, w, m in zip(names, got, want, move):
        g, w, m = (np.asarray(x, np.float64) for x in (g, w, m))
        norm = max(np.linalg.norm(w), 1e-30)
        gap = np.linalg.norm(g - w) / norm
        own = np.linalg.norm(m - g) / norm
        assert gap <= NUDGE_MULT * own + GRAD_FLOOR, (name, gap, own)
