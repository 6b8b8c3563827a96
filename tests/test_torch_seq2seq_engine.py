"""The port's ``Seq2SeqGenerationEngine`` against the JAX package's.

On the same NMT weights (a JAX startup's values, carried into the port
through ``scope_from_numpy``): ``translate`` over a mixed-length source
batch (encoder batching by source bucket) and ``translate_beam`` (beam
forks sharing the source's cross-KV row) must give the JAX engine's ids
token for token, beam scores within 1e-5 relative, and equal ``encodes``,
``encode_batches``, ``beam_forks`` and ``beam_shared_pages`` counters
(after ``tests/test_nmt_decode.py``). Greedy tokens must also equal the
argmax of the port's own teacher-forced forward re-run on each prefix,
the reference's witness. Tiny model (Vs24 Vt20 d16 L2 H2), f32 on the
CPU.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.decoding import Seq2SeqGenerationEngine as JaxSeq2Seq
from paddle_tpu.decoding import Seq2SeqSpec as JaxSpec
from paddle_tpu_torch.decoding import (Seq2SeqGenerationEngine,
                                       Seq2SeqSpec)

torch.set_num_threads(1)
VS, VT, D, L, H = 24, 20, 16, 2, 2
TS, TT = 16, 32
BOS, EOS = 0, 1
SCORE_RTOL = 1e-5
COUNTERS = ("encodes", "encode_batches", "beam_jobs", "beam_forks",
            "beam_shared_pages", "beam_parked", "completed", "prefills",
            "decode_steps", "decode_tokens", "kv_cow_copies")
_WEIGHTS = {}


def _teacher(pt, ts=TS, tt=4):
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        src = pt.layers.data(f"src{ts}", shape=[ts], dtype="int64")
        slen = pt.layers.data(f"slen{ts}", shape=[], dtype="int32")
        tgt = pt.layers.data(f"tgt{tt}", shape=[tt], dtype="int64")
        logits = pt.models.transformer_nmt_teacher(
            src, slen, tgt, src_vocab_size=VS, tgt_vocab_size=VT,
            d_model=D, n_layers=L, num_heads=H, max_src_len=TS,
            max_tgt_len=TT)
    return prog, startup, logits


def _weights(seed=11):
    if seed not in _WEIGHTS:
        scope = jpt.Scope()
        _, startup, _ = _teacher(jpt)
        startup.random_seed = seed
        jpt.Executor(jpt.CPUPlace()).run(startup, scope=scope)
        _WEIGHTS[seed] = {n: np.asarray(scope.get(n)) for n in scope.keys()}
    return _WEIGHTS[seed]


def _engines(**kw):
    kw = dict(dict(slots=5, page_size=4, bos_id=BOS, beam_width=4), **kw)
    spec = dict(src_vocab_size=VS, tgt_vocab_size=VT, d_model=D,
                n_layers=L, num_heads=H, max_src_len=TS, max_tgt_len=TT)
    jscope = jpt.Scope()
    for n, v in _weights().items():
        jscope.set(n, v)
    jeng = JaxSeq2Seq(JaxSpec(**spec), jscope, **kw)
    eng = Seq2SeqGenerationEngine(
        Seq2SeqSpec(**spec), tpt.scope_from_numpy(_weights(), "cpu"),
        device="cpu", **kw)
    return jeng, eng


def _same_counters(eng, jeng):
    for name in COUNTERS:
        assert eng.metrics.counter(name) == jeng.metrics.counter(name), name


def _sources(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, VS, (n,)).astype(np.int64) for n in lens]


def _teacher_argmax(srcs, n_new):
    """Greedy decode by re-running the port's teacher-forced forward on
    each prefix."""
    exe = tpt.Executor(tpt.CPUPlace())
    scope = tpt.scope_from_numpy(_weights(), "cpu")
    out = []
    for src in srcs:
        s = np.zeros((1, TS), np.int64)
        s[0, :src.size] = src
        gen = [BOS]
        for _ in range(n_new):
            prog, _, lv = _teacher(tpt, tt=len(gen))
            lo, = exe.run(prog, feed={f"src{TS}": s,
                                      f"slen{TS}": np.asarray([src.size],
                                                              np.int32),
                                      f"tgt{len(gen)}": np.asarray(
                                          gen, np.int64)[None]},
                          fetch_list=[lv], scope=scope)
            gen.append(int(np.argmax(np.asarray(lo)[0, -1])))
        out.append(np.asarray(gen, np.int64))
    return out


def test_translate_matches_jax_with_encoder_batching():
    srcs = _sources(3, (9, 13, 6, 11, 4, 16, 7))  # more than the slots
    jeng, eng = _engines()
    want = jeng.translate(srcs, max_new_tokens=5)
    got = eng.translate(srcs, max_new_tokens=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    _same_counters(eng, jeng)
    assert eng.metrics.counter("encodes") == len(srcs)
    assert eng.metrics.counter("encode_batches") < len(srcs)
    assert eng.pool.pages_in_use() == 0
    assert int(eng._xrow_ref.sum()) == 0
    np.testing.assert_array_equal(got[0], _teacher_argmax(srcs[:1], 5)[0])


def test_batch_one_encoding_gives_the_same_tokens():
    """``encode_batch_buckets=(1,)`` encodes each source alone: the same
    tokens as the pooled passes, one encode batch a source."""
    srcs = _sources(17, (6, 9, 11))
    jeng, eng = _engines()
    pooled = eng.translate(srcs, max_new_tokens=5)
    jeng.translate(srcs, max_new_tokens=5)
    # lengths (6, 9, 11) group as source buckets {8: [6], 16: [9, 11]}
    assert eng.metrics.counter("encode_batches") == 2
    _same_counters(eng, jeng)
    _, alone = _engines(encode_batch_buckets=(1,))
    got = alone.translate(srcs, max_new_tokens=5)
    for g, w in zip(got, pooled):
        np.testing.assert_array_equal(g, w)
    assert alone.metrics.counter("encode_batches") == len(srcs)


@pytest.mark.parametrize("K,alpha", [(4, 0.6), (3, 0.0)])
def test_translate_beam_matches_jax_and_shares_the_cross_row(K, alpha):
    src = _sources(5, (9,))[0]
    jeng, eng = _engines()
    want_ids, want_sc = jeng.translate_beam(src, beam_size=K,
                                            max_new_tokens=5, eos_id=EOS,
                                            length_penalty=alpha)
    max_ref = [0]
    orig = eng._gauges

    def gauged():
        orig()
        max_ref[0] = max(max_ref[0], int(eng._xrow_ref.max()))

    eng._gauges = gauged
    ids, sc = eng.translate_beam(src, beam_size=K, max_new_tokens=5,
                                 eos_id=EOS, length_penalty=alpha)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    np.testing.assert_allclose(sc, np.asarray(want_sc), rtol=SCORE_RTOL,
                               atol=0)
    _same_counters(eng, jeng)
    assert eng.metrics.counter("encodes") == 1  # encoded once
    assert eng.metrics.counter("beam_forks") > 0
    assert max_ref[0] >= 2  # the forks shared the row
    assert int(eng._xrow_ref.sum()) == 0 and eng.pool.pages_in_use() == 0


def test_beam_and_greedy_translations_share_a_batch_like_jax():
    srcs = _sources(9, (7, 12, 5))
    jeng, eng = _engines(slots=7)
    results = []
    for e, cls in ((jeng, jpt.serving.Request), (eng, tpt.serving.Request)):
        reqs = [cls({"src": srcs[0]}, {"max_new_tokens": 6, "eos_id": EOS,
                                        "beam_size": 4,
                                        "length_penalty": 0.6,
                                        "return_beams": True}, None)]
        reqs += [cls({"src": s}, {"max_new_tokens": 6, "eos_id": EOS}, None)
                 for s in srcs[1:]]
        e._drive(reqs)
        results.append([r.future.result(0.1) for r in reqs])
    want, got = results
    np.testing.assert_array_equal(got[0][0], np.asarray(want[0][0]))
    np.testing.assert_allclose(got[0][1], np.asarray(want[0][1]),
                               rtol=SCORE_RTOL, atol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, np.asarray(w))
    _same_counters(eng, jeng)


def test_warmup_touches_only_scrap_rows():
    _, eng = _engines()
    n = eng.warmup()
    assert n == len(eng._chunk_widths) * len(eng.prefill_batch_buckets) \
        + 2 + len(eng.src_buckets) * len(eng.encode_batch_buckets)
    assert float(eng.cross_k[:, :eng.slots].abs().sum()) == 0.0
    assert float(eng.cache_k[:, 1:].abs().sum()) == 0.0


@pytest.mark.parametrize("payload,match", [
    ({"prompt": [1, 2]}, "src"), ({"src": []}, "empty src"),
    ({"src": list(range(2, 2 + TS + 1))}, "source bucket")])
def test_bad_sources_fail_typed(payload, match):
    _, eng = _engines()
    req = tpt.serving.Request(payload, {"max_new_tokens": 2}, None)
    assert eng.admit([req]) == 0
    with pytest.raises(tpt.serving.BadRequestError, match=match):
        req.future.result(timeout=1)
