"""The port's paged decode plane against the JAX package's.

``PagedGenerationEngine`` (the default of ``GenerationEngine``) must emit
the JAX ``PagedGenerationEngine``'s tokens on the same weights and
prompts, greedy and sampled (threefry bits equal ``jax.random``'s), with
prefix hits, chunked prefill, copy-on-write, deferred admission and
``CacheExhaustedError`` exercised, and leave the same page-pool and
prefix-index statistics. Each paged op must equal its JAX op, and the
paged engine must equal the port's dense engine. Tiny LM (V32 d16 L2 H2),
weights from a JAX startup carried over as numpy; f32 on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import layers, models
from paddle_tpu.decoding import SamplingParams as JaxSamplingParams
from paddle_tpu.decoding import TokenBanMask as JaxTokenBanMask
from paddle_tpu.ops import pipeline_ops as jops
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu.serving import LMSpec as JaxLMSpec
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu_torch.core.registry import get_op
from paddle_tpu_torch.decoding import SamplingParams, TokenBanMask
from paddle_tpu_torch.ops import pipeline_ops as tops
from paddle_tpu_torch.serving import (BadRequestError, CacheExhaustedError,
                                      DynamicBatcher, GenerationEngine,
                                      LMSpec, PagedGenerationEngine, Request,
                                      Server)

torch.set_num_threads(1)
VOCAB, D, L, H, MAXLEN = 32, 16, 2, 2, 64
_WEIGHTS = {}


def _weights(seed=7):
    if seed not in _WEIGHTS:
        scope = pt.Scope()
        prog, startup = pt.Program(), pt.Program()
        with pt.program_guard(prog, startup):
            prompt = layers.data("p_init", shape=[8], dtype="int64")
            models.transformer_lm_generate(
                prompt, vocab_size=VOCAB, d_model=D, n_layers=L,
                num_heads=H, max_len=MAXLEN, max_new_tokens=1)
        startup.random_seed = seed
        pt.Executor(pt.TPUPlace()).run(startup, scope=scope)
        _WEIGHTS[seed] = {n: np.asarray(scope.get(n)) for n in scope.keys()}
    return _WEIGHTS[seed]


def _jax_engine(**kw):
    scope = pt.Scope()
    for n, v in _weights().items():
        scope.set(n, jnp.asarray(v))
    spec = JaxLMSpec(vocab_size=VOCAB, d_model=D, n_layers=L, num_heads=H,
                     max_len=MAXLEN)
    return JaxGenerationEngine(spec, scope, **kw)


def _spec():
    return LMSpec(vocab_size=VOCAB, d_model=D, n_layers=L, num_heads=H,
                  max_len=MAXLEN)


def _engine(**kw):
    return GenerationEngine(_spec(), _weights(), device="cpu", **kw)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).astype(np.int64) for n in lens]


def _pool_stats(eng):
    return {k: v for k, v in eng.cache_stats().items()
            if k.startswith(("kv_pages_", "kv_prefix_"))}


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


COUNTERS = ("completed", "prefills", "prefill_chunks", "prefix_hits",
            "prefix_hit_tokens", "kv_cow_copies", "admission_deferred",
            "cache_exhausted", "decode_steps", "decode_tokens",
            "stop_sequence_hits")


def _same_counters(a, b):
    for name in COUNTERS:
        assert a.metrics.counter(name) == b.metrics.counter(name), name


def test_default_engine_is_paged_and_dense_stays_dense():
    eng = GenerationEngine(_spec(), _weights(), device="cpu")
    assert isinstance(eng, PagedGenerationEngine)
    assert eng.page_size == 64 and eng.pmax == 1
    assert eng.n_pages == 8 * 1 + 1 and eng.prefill_chunk == 64
    dense = GenerationEngine(_spec(), _weights(), kv_cache="dense",
                             device="cpu")
    assert not isinstance(dense, PagedGenerationEngine)
    with pytest.raises(ValueError, match="kv_cache"):
        GenerationEngine(_spec(), _weights(), kv_cache="ring", device="cpu")


def test_paged_greedy_is_token_exact_with_jax_and_dense():
    """A mixed-length greedy wave, more requests than slots (mid-flight
    joins): the port's paged engine, the JAX paged engine and the port's
    dense engine emit the same tokens; pools end in the same state."""
    prompts = _prompts(0, [3, 5, 8, 11, 6, 14, 2, 16])
    kw = dict(slots=4, page_size=8, prompt_buckets=(4, 8, 16))
    jeng = _jax_engine(**kw)
    want = jeng.generate_all(prompts, max_new_tokens=5)
    eng = _engine(**kw)
    got = eng.generate_all(prompts, max_new_tokens=5)
    _equal(got, want)
    _same_counters(eng, jeng)
    assert _pool_stats(eng) == {k: v for k, v in jeng.cache_stats().items()
                                if k.startswith(("kv_pages_", "kv_prefix_"))}
    # every page back, only the prefix index's references remain
    assert eng.pool.pages_in_use() == len(eng.prefix_index)
    assert eng.pool.stats()["shared"] == 0
    dense = _engine(slots=4, prompt_buckets=(4, 8, 16), kv_cache="dense")
    _equal(dense.generate_all(prompts, max_new_tokens=5), got)


def _policies():
    """Greedy, temperature, top-k, top-p, a stop sequence, a banned-token
    mask, an engine-assigned seed."""
    return [
        dict(),
        dict(temperature=0.8, seed=11),
        dict(temperature=1.0, top_k=5, seed=3),
        dict(temperature=0.7, top_p=0.9, seed=2 ** 31 - 5),
        dict(temperature=1.3, top_k=8, top_p=0.95, seed=5, stop=[[7]]),
        dict(temperature=0.9, seed=21, mask=[1, 2, 3, 4, 5]),
        dict(temperature=1.1),
    ]


def _sampling(cls, mask_cls, policy):
    policy = dict(policy)
    banned = policy.pop("mask", None)
    if banned is not None:
        policy["logits_processor"] = mask_cls(VOCAB, banned)
    return cls(**policy)


def test_sampled_requests_are_token_exact_with_jax():
    prompts = _prompts(1, [6, 9, 4, 12, 7, 10, 5])
    kw = dict(slots=3, page_size=8, prompt_buckets=(8, 16))
    jeng = _jax_engine(**kw)
    want = jeng.generate_all(
        prompts, max_new_tokens=8,
        sampling=[_sampling(JaxSamplingParams, JaxTokenBanMask, p)
                  for p in _policies()])
    eng = _engine(**kw)
    sampling = [_sampling(SamplingParams, TokenBanMask, p)
                for p in _policies()]
    got = eng.generate_all(prompts, max_new_tokens=8, sampling=sampling)
    _equal(got, want)
    _same_counters(eng, jeng)
    banned = got[5][prompts[5].size:]
    assert not np.isin(banned, [1, 2, 3, 4, 5]).any()
    # batch invariance: each sampled request served alone gives the same
    # tokens
    for i in (1, 3, 5):
        alone = _engine(**kw).generate_all([prompts[i]], max_new_tokens=8,
                                           sampling=sampling[i])
        np.testing.assert_array_equal(alone[0], got[i])


def test_prefix_sharing_and_copy_on_write_match_jax():
    """Requests sharing a 2-page system prompt skip its prefill; a
    repeated whole prompt is a full hit that copies the shared tail page
    before writing it. Tokens, counters and pool state equal JAX's."""
    ps = 8
    rng = np.random.RandomState(4)
    sys_prompt = rng.randint(0, VOCAB, (2 * ps,)).astype(np.int64)
    prompts = [np.concatenate([sys_prompt, t])
               for t in _prompts(5, [3, 5, 7])]
    kw = dict(slots=4, page_size=ps, prompt_buckets=(8, 16, 32))
    jeng, eng = _jax_engine(**kw), _engine(**kw)
    for batch in ([prompts[0]], prompts[1:], [prompts[0]], [prompts[0]]):
        want = jeng.generate_all(batch, max_new_tokens=4)
        _equal(eng.generate_all(batch, max_new_tokens=4), want)
    _same_counters(eng, jeng)
    assert eng.metrics.counter("prefix_hit_tokens") == \
        2 * 2 * ps + 2 * prompts[0].size
    assert eng.metrics.counter("kv_cow_copies") >= 1
    assert _pool_stats(eng) == {k: v for k, v in jeng.cache_stats().items()
                                if k.startswith(("kv_pages_", "kv_prefix_"))}
    plain = _engine(prefix_sharing=False, **kw)
    _equal(plain.generate_all(prompts, max_new_tokens=4),
           eng.generate_all(prompts, max_new_tokens=4))


def test_chunked_prefill_interleaves_and_matches_jax():
    """A 48-token prompt streams in 8-token chunks while a short request
    keeps decoding one token per tick."""
    short, long_p = _prompts(9, [6, 48])
    kw = dict(slots=2, page_size=8, prefill_chunk=8, prompt_buckets=(8, 16))

    def run(eng, req_cls):
        r_short = req_cls({"prompt": short}, {"max_new_tokens": 10}, None)
        r_long = req_cls({"prompt": long_p}, {"max_new_tokens": 4}, None)
        eng.admit([r_short])
        eng.decode_tick()
        eng.admit([r_long])
        progress = []
        while eng.prefilling:
            eng.prefill_tick()
            eng.decode_tick()
            progress.append(len(eng._slots[0].generated))
        while eng.active:
            eng.prefill_tick()
            eng.decode_tick()
        return [r_short.future.result(1), r_long.future.result(1)], progress

    want, jprog = run(_jax_engine(**kw), JaxRequest)
    eng = _engine(**kw)
    got, prog = run(eng, Request)
    _equal(got, want)
    assert prog == jprog and prog == sorted(prog) and len(prog) >= 5
    assert eng.metrics.counter("prefill_chunks") == 6


def test_cache_exhausted_and_deferral_match_jax():
    kw = dict(slots=2, page_size=8, n_pages=3, prompt_buckets=(8, 16, 32))
    big = np.arange(30, dtype=np.int64) % VOCAB  # 5 pages, pool holds 2
    for eng, req_cls in ((_jax_engine(**kw), JaxRequest),
                         (_engine(**kw), Request)):
        req = req_cls({"prompt": big}, {"max_new_tokens": 4}, None)
        assert eng.admit([req]) == 0
        with pytest.raises(Exception) as ei:
            req.future.result(timeout=1)
        assert type(ei.value).__name__ == "CacheExhaustedError"
        assert (ei.value.pages_needed, ei.value.pages_free) == (5, 2)
        assert eng.free_slots == 2
    assert isinstance(ei.value, CacheExhaustedError)
    # two requests that each fit but not together: the second defers
    prompts = _prompts(3, [10, 10])
    kw = dict(kw, prefix_sharing=False, prompt_buckets=(8, 16))
    jeng, eng = _jax_engine(**kw), _engine(**kw)
    _equal(eng.generate_all(prompts, max_new_tokens=4),
           jeng.generate_all(prompts, max_new_tokens=4))
    assert eng.metrics.counter("admission_deferred") >= 1
    _same_counters(eng, jeng)
    assert eng.pool.pages_in_use() == 0


def test_deferred_requests_drain_through_serve_step():
    eng = _engine(slots=3, page_size=8, n_pages=3, prefix_sharing=False,
                  prompt_buckets=(8, 16))
    batcher = DynamicBatcher(buckets=(1, 2, 4), max_wait_ms=1)
    futs = [batcher.submit({"prompt": p}, max_new_tokens=3)
            for p in _prompts(5, [9, 9, 9])]
    for _ in range(200):
        eng.serve_step(batcher, idle_wait_s=0)
        if all(f.done() for f in futs):
            break
    assert all(f.result(timeout=1).size == 12 for f in futs)
    assert eng.metrics.counter("admission_deferred") >= 1
    assert eng.pool.pages_in_use() == 0


def test_server_carries_per_request_sampling_and_typed_cache_failures():
    prompts = _prompts(2, [5, 7, 9])
    metas = [dict(temperature=0.8, top_k=6, seed=4),
             dict(temperature=1.0, top_p=0.9, seed=9, stop=[[3, 3]]),
             dict()]
    want = _engine(slots=2, page_size=8).generate_all(
        prompts, max_new_tokens=6,
        sampling=[SamplingParams(**m) for m in metas])
    eng = _engine(slots=2, page_size=8, n_pages=4)
    srv = Server(eng).start()
    try:
        futs = [srv.submit({"prompt": p}, max_new_tokens=6, **m)
                for p, m in zip(prompts, metas)]
        got = [f.result(timeout=60) for f in futs]
        too_big = srv.submit({"prompt": np.arange(40) % VOCAB},
                             max_new_tokens=20)
        with pytest.raises(CacheExhaustedError):
            too_big.result(timeout=60)
        bad = srv.submit({"prompt": [1, 2]}, max_new_tokens=2, top_p=0.0)
        with pytest.raises(BadRequestError, match="top_p"):
            bad.result(timeout=60)
    finally:
        srv.stop()
    _equal(got, want)
    assert srv.metrics.counter("cache_exhausted") == 1
    assert srv.metrics.counter("dispatch_errors") == 0


def _op_inputs(rng, b, tc, n_pages, ps, pmax):
    w = _weights()
    lm = {"TokEmb": w["tok_emb"], "PosEmb": w["pos_emb"],
          "FinalLnS": w["final_ln.scale"], "FinalLnB": w["final_ln.bias"],
          "HeadW": w["lm_head.w"]}
    for slot, key in tops._STACK_SLOTS.items():
        lm[slot] = w[f"lm_stack.stack_{key}"]
    pool = rng.randn(L, n_pages, H, ps, D // H).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, n_pages))[:pmax]
                      for _ in range(b)]).astype(np.int32)
    return lm, pool, table


def _run_both(name, attrs, ins):
    want = getattr(jops, name)(attrs, {k: [jnp.asarray(v)]
                                       for k, v in ins.items()})
    tins = {k: [torch.from_numpy(np.array(v))] for k, v in ins.items()}
    got = get_op(name).fn(attrs, tins)
    assert got["CacheK"][0] is tins["CacheK"][0]  # written in place
    return got, want


def _close(got, want, names):
    """Outputs within 1e-5; the pools past page 0, the scrap page, where
    padding rows write in an unspecified order in both packages."""
    for name in names:
        a, b = got[name][0].numpy(), np.asarray(want[name][0])
        if name in ("CacheK", "CacheV"):
            a, b = a[:, 1:], b[:, 1:]
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("sampled", [False, True])
def test_each_paged_op_matches_its_jax_op(sampled):
    rng = np.random.RandomState(3 + sampled)
    b, tc, ps, pmax = 3, 8, 4, 6
    lm, pool, table = _op_inputs(rng, b, tc, 20, ps, pmax)
    attrs = {"num_heads": H, "page_size": ps, "emit_topk": 3}
    plane = {}
    if sampled:
        plane = {"Temperature": np.array([0.0, 0.8, 1.2], np.float32),
                 "TopK": np.array([0, 5, 0], np.int32),
                 "TopP": np.array([1.0, 1.0, 0.9], np.float32),
                 "Seed": np.array([1, 2, 3], np.int32),
                 "Step": np.array([0, 4, 9], np.int32),
                 "Mask": (rng.rand(b, VOCAB) > 0.2).astype(np.float32)}
    ins = dict(lm, Chunk=rng.randint(0, VOCAB, (b, tc)),
               StartPos=np.array([0, 5, 11], np.int32),
               Lengths=np.array([8, 3, 0], np.int32), BlockTable=table,
               CacheK=pool, CacheV=pool[::-1].copy(), **plane)
    got, want = _run_both("transformer_stack_paged_prefill", attrs, ins)
    _close(got, want, ("NextTok", "CacheK", "CacheV", "TopV", "TopI"))
    ins = dict(lm, Tok=rng.randint(0, VOCAB, (b,)),
               Pos=np.array([0, 13, 23], np.int32), BlockTable=table,
               CacheK=pool, CacheV=pool[::-1].copy(), **plane)
    got, want = _run_both("transformer_stack_paged_decode", attrs, ins)
    _close(got, want, ("NextTok", "CacheK", "CacheV", "TopV", "TopI"))
    ins = {"Src": np.array([3, 7], np.int32),
           "Dst": np.array([9, 1], np.int32), "CacheK": pool,
           "CacheV": pool[::-1].copy()}
    got, want = _run_both("kv_cache_page_copy", {}, ins)
    _close(got, want, ("Ok", "CacheK", "CacheV"))


def test_slot_ops_are_registered_as_in_the_jax_package():
    for name in ("transformer_stack_slot_prefill",
                 "transformer_stack_slot_decode",
                 "transformer_stack_paged_prefill",
                 "transformer_stack_paged_decode", "kv_cache_page_copy"):
        assert get_op(name).fn is getattr(tops, name)
    assert get_op("transformer_stack_paged_decode").optional_inputs == (
        "PosEmb", "Temperature", "TopK", "TopP", "Seed", "Step", "Mask")


def test_later_slices_raise_naming_the_roadmap():
    eng = _engine(slots=2, page_size=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(share_cache_with=eng)
    for call in (lambda: eng.export_slot(0), lambda: eng.adopt_slot({}),
                 lambda: eng.swap_params({}), eng.save_manifest,
                 eng.warm_from_manifest):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    req = Request({"prompt": [1, 2]},
                  dict(max_new_tokens=2, resume_tokens=[3]), None)
    assert eng.admit([req]) == 0
    with pytest.raises(BadRequestError, match="ROADMAP"):
        req.future.result(timeout=1)
    # the beam plane is ported: without it a beam request fails typed,
    # as in the JAX package
    with pytest.raises(BadRequestError, match="beam plane"):
        eng.generate_beam([1, 2])


def test_kill_fails_in_flight_and_returns_every_page():
    eng = _engine(slots=2, page_size=8, prefill_chunk=8,
                  prompt_buckets=(8, 16))
    reqs = [Request({"prompt": p}, {"max_new_tokens": 9}, None)
            for p in _prompts(8, [6, 30, 5])]
    eng.admit(reqs)
    eng.decode_tick()
    assert eng.pool.pages_in_use() > 0
    assert eng.kill() == 3
    for r in reqs:
        with pytest.raises(ConnectionError):
            r.future.result(timeout=1)
    assert eng.pool.pages_in_use() == len(eng.prefix_index)
    assert eng.pool.stats()["shared"] == 0 and eng.active == 0


def test_warmup_runs_every_shape_on_the_scrap_page():
    eng = _engine(slots=4, page_size=8, prompt_buckets=(8, 16))
    assert eng.warmup() == len(eng._chunk_widths) * 3 + 2
    assert eng.pool.pages_in_use() == 0
    live = eng.cache_k[:, 1:].abs().sum()
    assert float(live) == 0.0  # only the scrap page was written


def _fake_capture(self):
    """The decode graph's capture on the CPU: ``replay`` re-runs the op
    over the same static buffers the CUDA graph would read."""
    feed = self._neutral_decode_feed()
    self._static = {k: torch.from_numpy(v) for k, v in feed.items()}
    self._mask_open = True
    ins, attrs = self._decode_ins(self._static), self._decode_attrs()

    def replay():
        with torch.no_grad():
            nxt = tops.transformer_stack_paged_decode(attrs, ins)
        self._static_next.copy_(nxt["NextTok"][0])

    self._static_next = torch.zeros(self.slots, dtype=torch.int64)
    self._graph = type("Graph", (), {"replay": staticmethod(replay)})()
    self.metrics.inc("decode_graph_captures")


def test_replayed_step_feeds_its_static_buffers_like_the_eager_step(
        monkeypatch):
    """The replay path (static inputs written from the host feed, the
    mask only when a row is masked now or was last tick) picks the eager
    step's tokens, with masked, sampled and greedy rows coming and
    going."""
    prompts = _prompts(6, [5, 9, 4, 7, 6])
    sampling = [_sampling(SamplingParams, TokenBanMask, p)
                for p in _policies()[1:6]]
    kw = dict(slots=2, page_size=8, prompt_buckets=(8, 16))
    want = _engine(**kw).generate_all(prompts, max_new_tokens=6,
                                      sampling=sampling)
    monkeypatch.setattr(PagedGenerationEngine, "_capture_decode",
                        _fake_capture)
    monkeypatch.setattr(PagedGenerationEngine, "_decode_step",
                        PagedGenerationEngine._decode_step_replay)
    eng = _engine(**kw)
    _equal(eng.generate_all(prompts, max_new_tokens=6, sampling=sampling),
           want)
    stats = eng.cache_stats()
    assert stats["decode_graph_captures"] == 1
    assert stats["decode_graph_replays"] == eng.metrics.counter(
        "decode_steps") > 0


def test_server_generate_takes_the_request_sampling_fields():
    prompt = _prompts(12, [6])[0]
    policy = dict(temperature=0.9, top_k=7, top_p=0.9, seed=17)
    want = _engine(slots=2, page_size=8).generate_all(
        [prompt], max_new_tokens=5, sampling=SamplingParams(**policy))[0]
    srv = Server(_engine(slots=2, page_size=8)).start()
    try:
        got = srv.generate(prompt, max_new_tokens=5, **policy)
        with pytest.raises(TypeError, match="unknown generate fields"):
            srv.generate(prompt, max_new_tokens=5, beam_size=2)
    finally:
        srv.stop()
    np.testing.assert_array_equal(got, want)
