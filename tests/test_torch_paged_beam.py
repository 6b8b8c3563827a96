"""The port's paged beam plane against the JAX package's.

``PagedGenerationEngine(beam_width=K)``: ``generate_beam``, beam requests
mixed with greedy ones in one continuous batch, a pool small enough to
park a job, and the GQA + RoPE leg must give the JAX
``PagedGenerationEngine``'s ids token for token on the same weights,
scores within 1e-5 relative, and the same fork, shared-page, park and
pool counters; the best beam must equal the fused
``transformer_stack_beam_search`` op's. Beam requests are validated with
the reference's errors (after ``tests/test_decoding.py``). A tiny LM
(V32 d16 L2 H2), weights made with numpy from a seed; f32 on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu.serving import LMSpec as JaxLMSpec
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu_torch.models.transformer import init_params
from paddle_tpu_torch.ops import pipeline_ops as tops
from paddle_tpu_torch.serving import (DynamicBatcher, GenerationEngine,
                                      LMSpec, Request)

torch.set_num_threads(1)
VOCAB, D, L, H, MAXLEN = 32, 16, 2, 2, 64
SCORE_RTOL = 1e-5
BEAM_COUNTERS = ("beam_jobs", "beam_forks", "beam_shared_pages",
                 "beam_parked", "completed", "prefills", "decode_steps",
                 "decode_tokens", "cache_exhausted", "kv_cow_copies")


def _spec_kw(**kw):
    return dict(vocab_size=VOCAB, d_model=D, n_layers=L, num_heads=H,
                max_len=MAXLEN, **kw)


def _weights(seed=7, **kw):
    return init_params(LMSpec(**_spec_kw(**kw)), seed)


def _engines(lm_kw=None, **kw):
    """(JAX engine, port engine) on the same weights."""
    lm_kw = lm_kw or {}
    w = _weights(**lm_kw)
    scope = pt.Scope()
    for n, v in w.items():
        scope.set(n, jnp.asarray(v))
    jeng = JaxGenerationEngine(JaxLMSpec(**_spec_kw(**lm_kw)), scope, **kw)
    eng = GenerationEngine(LMSpec(**_spec_kw(**lm_kw)), w, device="cpu",
                           **kw)
    return jeng, eng


def _fused_beam(prompt, K, N, alpha, eos, lm_kw=None):
    """The fused op's beams: the independent reference path."""
    lm_kw = lm_kw or {}
    w = _weights(**lm_kw)
    slot_of = {"tok_emb": "TokEmb", "pos_emb": "PosEmb",
               "final_ln.scale": "FinalLnS", "final_ln.bias": "FinalLnB",
               "lm_head.w": "HeadW"}
    slot_of.update({f"lm_stack.stack_{k}": s
                    for s, k in tops._STACK_SLOTS.items()})
    ins = {slot_of[n]: [torch.from_numpy(a)] for n, a in w.items()}
    ins["Prompt"] = [torch.from_numpy(prompt[None])]
    res = tops.transformer_stack_beam_search(
        {"num_heads": H, "num_kv_heads": lm_kw.get("num_kv_heads"),
         "use_rope": lm_kw.get("use_rope", False), "max_new_tokens": N,
         "beam_size": K, "length_penalty": alpha,
         "eos_id": -1 if eos is None else eos}, ins)
    return res["Out"][0][0].numpy(), res["Scores"][0][0].numpy()


def _same_counters(eng, jeng):
    for name in BEAM_COUNTERS:
        assert eng.metrics.counter(name) == jeng.metrics.counter(name), name


def _pool_stats(eng):
    return {k: v for k, v in eng.pool.stats().items()}


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, VOCAB, (n,)).astype(
        np.int64)


@pytest.mark.parametrize("K,alpha,eos,page_size", [(3, 0.0, None, 8),
                                                   (4, 0.6, 1, 8),
                                                   (4, 0.6, 3, 4)])
def test_generate_beam_matches_jax_and_the_fused_op(K, alpha, eos,
                                                    page_size):
    prompt = _prompt(5, 17)  # three pages of 8: the boundary is mid-page
    N = 8
    kw = dict(slots=K + 1, page_size=page_size, beam_width=K,
              prefix_sharing=False, prompt_buckets=(32,))
    jeng, eng = _engines(**kw)
    assert eng.n_pages == jeng.n_pages  # the beam engine's bigger pool
    want_ids, want_sc = jeng.generate_beam(prompt, beam_size=K,
                                           max_new_tokens=N, eos_id=eos,
                                           length_penalty=alpha)
    ids, sc = eng.generate_beam(prompt, beam_size=K, max_new_tokens=N,
                                eos_id=eos, length_penalty=alpha)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    np.testing.assert_allclose(sc, np.asarray(want_sc), rtol=SCORE_RTOL,
                               atol=0)
    _same_counters(eng, jeng)
    assert eng.metrics.counter("beam_forks") >= K - 1
    assert eng.metrics.counter("beam_shared_pages") > 0
    assert _pool_stats(eng) == _pool_stats(jeng)
    assert eng.pool.pages_in_use() == 0 and eng.active == 0
    fused_ids, fused_sc = _fused_beam(prompt, K, N, alpha, eos)
    np.testing.assert_array_equal(ids, fused_ids)
    np.testing.assert_allclose(sc, fused_sc, rtol=SCORE_RTOL, atol=0)
    # the best beam alone, cut after its eos
    best = eng.generate_beam(prompt, beam_size=K, max_new_tokens=N,
                             eos_id=eos, length_penalty=alpha,
                             return_all=False)
    np.testing.assert_array_equal(best, jeng.generate_beam(
        prompt, beam_size=K, max_new_tokens=N, eos_id=eos,
        length_penalty=alpha, return_all=False))


def _mixed(req_cls, seed=6):
    """Two beam requests (beam 3 and 4) and three greedy ones."""
    reqs = []
    for i, n in enumerate((9, 5, 12, 7, 3)):
        p = _prompt(seed + i, n)
        if i in (0, 2):
            meta = {"beam_size": 3 + i // 2, "max_new_tokens": 6,
                    "length_penalty": 0.6 * (i // 2), "eos_id": 2,
                    "return_beams": True}
        else:
            meta = {"max_new_tokens": 5}
        reqs.append(req_cls({"prompt": p}, meta, None))
    return reqs


def test_beam_requests_ride_the_continuous_batch_like_jax():
    kw = dict(slots=9, page_size=4, beam_width=4, prompt_buckets=(8, 16))
    jeng, eng = _engines(**kw)
    jreqs, reqs = _mixed(JaxRequest), _mixed(Request)
    jeng._drive(jreqs)
    eng._drive(reqs)
    for r, jr in zip(reqs, jreqs):
        got, want = r.future.result(0.1), jr.future.result(0.1)
        if isinstance(want, tuple):
            np.testing.assert_array_equal(got[0], np.asarray(want[0]))
            np.testing.assert_allclose(got[1], np.asarray(want[1]),
                                       rtol=SCORE_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got, np.asarray(want))
    _same_counters(eng, jeng)
    assert eng.metrics.counter("beam_jobs") == 2
    assert _pool_stats(eng) == _pool_stats(jeng)
    # each greedy request equals its solo decode, each beam the fused op
    solo = _engines(slots=2, page_size=4, prompt_buckets=(8, 16))[1]
    for r in (reqs[1], reqs[3], reqs[4]):
        np.testing.assert_array_equal(r.future.result(0.1), solo.generate_all(
            [r.payload["prompt"]], max_new_tokens=5)[0])
    for r in (reqs[0], reqs[2]):
        m = r.meta
        ids, _ = _fused_beam(r.payload["prompt"], m["beam_size"], 6,
                             m["length_penalty"], 2)
        np.testing.assert_array_equal(r.future.result(0.1)[0], ids)


def test_serve_step_takes_beam_requests_from_the_batcher():
    jeng, eng = _engines(slots=5, page_size=8, beam_width=3,
                         prompt_buckets=(8, 16))
    prompt_b, prompt_g = _prompt(11, 9), _prompt(12, 5)
    batcher = DynamicBatcher(buckets=(1, 2, 4), max_wait_ms=1)
    fut_b = batcher.submit({"prompt": prompt_b}, beam_size=3,
                           max_new_tokens=6, return_beams=True)
    fut_g = batcher.submit({"prompt": prompt_g}, max_new_tokens=4)
    for _ in range(300):
        eng.serve_step(batcher, idle_wait_s=0)
        if fut_b.done() and fut_g.done():
            break
    ids, sc = fut_b.result(timeout=1)
    want_ids, want_sc = jeng.generate_beam(prompt_b, beam_size=3,
                                           max_new_tokens=6)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    np.testing.assert_allclose(sc, np.asarray(want_sc), rtol=SCORE_RTOL,
                               atol=0)
    np.testing.assert_array_equal(
        fut_g.result(timeout=1),
        jeng.generate_all([prompt_g], max_new_tokens=4)[0])


def test_a_starved_pool_parks_the_job_like_jax():
    """A pool too small for the job's forks while a greedy request holds
    pages: the job parks after its prefill, retries as the greedy
    request's pages free, and finishes with the same beams and counters
    as JAX's."""
    kw = dict(slots=6, page_size=4, beam_width=4, n_pages=12,
              prefix_sharing=False, prompt_buckets=(8, 16))
    jeng, eng = _engines(**kw)

    def reqs(cls):
        return [cls({"prompt": _prompt(22, 5)}, {"max_new_tokens": 10},
                    None),
                cls({"prompt": _prompt(21, 10)},
                    {"beam_size": 3, "max_new_tokens": 6,
                     "return_beams": True}, None)]
    jr, r = reqs(JaxRequest), reqs(Request)
    jeng._drive(jr)
    eng._drive(r)
    np.testing.assert_array_equal(r[0].future.result(0.1),
                                  np.asarray(jr[0].future.result(0.1)))
    np.testing.assert_array_equal(r[1].future.result(0.1)[0],
                                  np.asarray(jr[1].future.result(0.1)[0]))
    _same_counters(eng, jeng)
    assert eng.metrics.counter("beam_parked") > 0
    assert eng.pool.pages_in_use() == 0


def test_gqa_rope_beam_leg_matches_jax():
    lm_kw = dict(use_rope=True, num_kv_heads=1)
    kw = dict(slots=5, page_size=4, beam_width=4, prompt_buckets=(16,))
    jeng, eng = _engines(lm_kw, **kw)
    prompt = _prompt(8, 10)
    want_ids, want_sc = jeng.generate_beam(prompt, beam_size=4,
                                           max_new_tokens=6, eos_id=1,
                                           length_penalty=0.6)
    ids, sc = eng.generate_beam(prompt, beam_size=4, max_new_tokens=6,
                                eos_id=1, length_penalty=0.6)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    np.testing.assert_allclose(sc, np.asarray(want_sc), rtol=SCORE_RTOL,
                               atol=0)
    np.testing.assert_array_equal(ids, _fused_beam(prompt, 4, 6, 0.6, 1,
                                                   lm_kw)[0])
    _same_counters(eng, jeng)


@pytest.mark.parametrize("engine_kw,meta", [
    (dict(), {"beam_size": 4}),                       # no beam plane
    (dict(beam_width=2), {"beam_size": 4}),           # over beam_width
    (dict(beam_width=8, slots=4), {"beam_size": 6}),  # over the slots
    (dict(beam_width=64, slots=64), {"beam_size": VOCAB + 1}),  # vocab
])
def test_beam_request_validation_raises_the_reference_errors(engine_kw,
                                                             meta):
    kw = dict(dict(slots=4, page_size=8, prompt_buckets=(8, 16)),
              **engine_kw)
    jeng, eng = _engines(**kw)
    errors = []
    for e, cls in ((jeng, JaxRequest), (eng, Request)):
        req = cls({"prompt": np.arange(4, dtype=np.int64)},
                  dict(meta, max_new_tokens=4), None)
        assert e.admit([req]) == 0
        with pytest.raises(Exception) as ei:
            req.future.result(timeout=1)
        errors.append(ei.value)
    assert type(errors[1]).__name__ == type(errors[0]).__name__
    assert str(errors[1]) == str(errors[0])
    assert "beam" in str(errors[1])
    assert eng.metrics.counter("bad_requests") == 1


def test_beam_width_must_not_be_negative():
    with pytest.raises(ValueError, match="beam_width"):
        GenerationEngine(LMSpec(**_spec_kw()), _weights(), device="cpu",
                         beam_width=-1)
