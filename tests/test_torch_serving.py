"""paddle_tpu_torch serving slice against the JAX package, end to end.

Weights come from a JAX scope (``models.transformer_lm_generate`` plus a
startup run) and carry into the port through ``load_jax_params``. The
port's dense engine and its ``Server`` must return token-identical
greedy outputs to JAX ``GenerationEngine(kv_cache="dense")``, with more
requests than slots, different horizons and mid-flight joins. The JAX
reference outputs are built once per module.
"""
import ast
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import layers, models
from paddle_tpu.serving import GenerationEngine as JaxGenerationEngine
from paddle_tpu.serving import LMSpec as JaxLMSpec
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu_torch.models.transformer import TransformerLM
from paddle_tpu_torch.serving import (BadRequestError, DynamicBatcher,
                                      EngineClosedError, GenerationEngine,
                                      LMSpec, MetricsRegistry,
                                      QueueFullError, Request,
                                      RequestTimeoutError, Server)

torch.set_num_threads(1)
VOCAB, D, L, H, MAXLEN = 97, 32, 2, 4, 64
SLOTS, BUCKETS = 2, (8, 16)
PROMPT_LENS = (8, 5, 12, 3, 16, 7)
HORIZONS = (7, 3, 5, 7, 4, 6)
REPO = Path(__file__).resolve().parents[1]


def _jax_scope(seed=7):
    scope = pt.Scope()
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        prompt = layers.data("p_init", shape=[8], dtype="int64")
        models.transformer_lm_generate(
            prompt, vocab_size=VOCAB, d_model=D, n_layers=L, num_heads=H,
            max_len=MAXLEN, max_new_tokens=1)
    startup.random_seed = seed
    pt.Executor(pt.TPUPlace()).run(startup, scope=scope)
    return scope


def _drive(engine, requests):
    """Admit into free slots as they open, one decode tick per round, so
    later requests join while earlier ones are mid-flight."""
    pending = list(requests)
    while pending or engine.active:
        k = min(len(pending), engine.free_slots)
        if k:
            engine.admit(pending[:k])
            pending = pending[k:]
        engine.decode_tick()
    return [r.future.result(timeout=1) for r in requests]


@pytest.fixture(scope="module")
def ref():
    """JAX weights (as numpy) and the JAX dense engine's outputs."""
    scope = _jax_scope()
    params = {n: np.asarray(scope.get(n)) for n in scope.keys()}
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, VOCAB, (n,)).astype(np.int64)
               for n in PROMPT_LENS]
    spec = JaxLMSpec(vocab_size=VOCAB, d_model=D, n_layers=L, num_heads=H,
                     max_len=MAXLEN)
    eng = JaxGenerationEngine(spec, scope, slots=SLOTS,
                              prompt_buckets=BUCKETS, kv_cache="dense")
    outs = _drive(eng, [JaxRequest({"prompt": p}, {"max_new_tokens": h},
                                   None)
                        for p, h in zip(prompts, HORIZONS)])
    return params, prompts, outs


def _spec():
    return LMSpec(vocab_size=VOCAB, d_model=D, n_layers=L, num_heads=H,
                  max_len=MAXLEN)


def _engine(params, **kw):
    return GenerationEngine(_spec(), params, slots=SLOTS,
                            prompt_buckets=BUCKETS, kv_cache="dense",
                            device="cpu", **kw)


def test_load_jax_params_carries_every_weight(ref):
    params, _, _ = ref
    model = TransformerLM(_spec(), device="cpu")
    model.load_jax_params(params)
    names = dict(model.named_parameters())
    assert set(names) == {
        "tok_emb", "pos_emb", "final_ln.scale", "final_ln.bias",
        "lm_head.w", *(f"lm_stack.stack_{k}" for k in (
            "ln1_s", "ln1_b", "qkv_w", "out_w", "ln2_s", "ln2_b", "ff_w1",
            "ff_b1", "ff_w2", "ff_b2"))}
    for name, p in names.items():
        np.testing.assert_array_equal(p.numpy(), params[name])
        assert not p.requires_grad
    with pytest.raises(KeyError, match="lm_head.w"):
        model.load_jax_params({k: v for k, v in params.items()
                               if k != "lm_head.w"})


def test_dense_engine_is_token_exact_with_jax(ref):
    params, prompts, want = ref
    model = TransformerLM.from_jax_params(_spec(), params, device="cpu")
    eng = _engine(model)
    got = _drive(eng, [Request({"prompt": p}, {"max_new_tokens": h}, None)
                       for p, h in zip(prompts, HORIZONS)])
    for g, w, p, h in zip(got, want, prompts, HORIZONS):
        assert g.dtype == np.int64 and g.shape == (p.size + h,)
        np.testing.assert_array_equal(g, w)
    assert eng.metrics.counter("completed") == len(prompts)
    assert eng.metrics.counter("prefills") >= len(prompts) // SLOTS


def test_generate_all_is_token_exact_with_jax(ref):
    """Greedy continuations are prefix-consistent: a 3-token horizon
    gives the first 3 tokens of every longer reference run."""
    params, prompts, want = ref
    got = _engine(params).generate_all(prompts, max_new_tokens=3)
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, w[:p.size + 3])


def test_server_submit_and_generate_are_token_exact_with_jax(ref):
    params, prompts, want = ref
    eng = _engine(params)
    srv = Server(eng).start()
    try:
        futs = [srv.submit({"prompt": p}, max_new_tokens=h)
                for p, h in zip(prompts, HORIZONS)]
        got = [f.result(timeout=60) for f in futs]
        # one more request joins on the warm engine
        last = srv.generate(prompts[0], max_new_tokens=HORIZONS[0],
                            timeout_s=60)
        snap = srv.metrics_snapshot()
    finally:
        srv.stop()
    for g, w in zip(got + [last], want + [want[0]]):
        np.testing.assert_array_equal(g, w)
    assert snap["counters"].get("dispatch_errors", 0) == 0
    assert snap["counters"]["completed"] == len(prompts) + 1
    assert snap["queue_depth"] == 0


def test_over_long_prompt_is_a_bad_request(ref):
    params, _, _ = ref
    eng = _engine(params)
    too_long = np.zeros(BUCKETS[-1] + 1, np.int64)
    req = Request({"prompt": too_long}, {"max_new_tokens": 2}, None)
    assert eng.admit([req]) == 0
    with pytest.raises(BadRequestError, match="prompt bucket"):
        req.future.result(timeout=1)
    over_context = Request({"prompt": np.zeros(10, np.int64)},
                           {"max_new_tokens": MAXLEN}, None)
    eng.admit([over_context])
    with pytest.raises(BadRequestError, match="serving context"):
        over_context.future.result(timeout=1)
    srv = Server(eng).start()
    try:
        with pytest.raises(BadRequestError):
            srv.generate(too_long, max_new_tokens=2, timeout_s=30)
    finally:
        srv.stop()
    assert eng.metrics.counter("bad_requests") == 3
    assert eng.active == 0


def test_malformed_payloads_are_bad_requests(ref):
    eng = _engine(ref[0])
    reqs = [Request(payload, {"max_new_tokens": 2}, None) for payload in (
        {"prompt": []}, {"ids": [1, 2]}, {"prompt": ["a", "b"]})]
    assert eng.admit(reqs) == 0
    for req in reqs:
        with pytest.raises(BadRequestError):
            req.future.result(timeout=1)
    assert eng.metrics.counter("bad_requests") == len(reqs)
    assert eng.active == 0 and eng.metrics.counter("prefills") == 0


def test_warmup_runs_every_shape_without_touching_live_slots(ref):
    params, prompts, want = ref
    eng = _engine(params)
    shapes = len(BUCKETS) * len(eng.prefill_batch_buckets) + 1
    assert eng.warmup() == shapes
    assert eng.metrics.counter("warmup_compiles") == shapes
    assert eng.active == 0 and eng.free_slots == SLOTS
    got = eng.generate_all(prompts[:2], max_new_tokens=3)
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, w[:p.size + 3])


def test_metrics_count_every_token_and_step(ref):
    """One TTFT sample per request, one TPOT sample and one decode token
    per later token, one latency sample per prefill and decode step."""
    params, prompts, _ = ref
    eng = _engine(params)
    _drive(eng, [Request({"prompt": p}, {"max_new_tokens": h}, None)
                 for p, h in zip(prompts, HORIZONS)])
    snap = eng.metrics.snapshot()
    counters, hist, lat = snap["counters"], snap["hist"], snap["latency"]
    later = sum(h - 1 for h in HORIZONS)
    assert hist["ttft"]["count"] == len(prompts)
    assert hist["tpot"]["count"] == later == counters["decode_tokens"]
    assert hist["queue_wait"]["count"] == len(prompts)
    assert lat["prefill_ms"]["count"] == counters["prefills"]
    assert lat["decode_step_ms"]["count"] == counters["decode_steps"]
    assert lat["request_ms"]["count"] == counters["completed"] == len(prompts)
    assert snap["gauges"]["active_slots"] == 0


def test_kill_fails_in_flight_and_revive_serves_again(ref):
    params, prompts, want = ref
    eng = _engine(params)
    live = [Request({"prompt": p}, {"max_new_tokens": h}, None)
            for p, h in zip(prompts[:SLOTS], HORIZONS[:SLOTS])]
    assert eng.admit(live) == SLOTS
    eng.decode_tick()
    assert eng.kill() == SLOTS
    for req in live:
        with pytest.raises(ConnectionError):
            req.future.result(timeout=1)
    assert eng.active == 0
    batcher = DynamicBatcher(buckets=eng.prefill_batch_buckets)
    queued = batcher.submit({"prompt": prompts[2]}, max_new_tokens=2)
    assert eng.serve_step(batcher, idle_wait_s=0)
    with pytest.raises(ConnectionError):
        queued.result(timeout=1)
    eng.revive()
    got = eng.generate_all(prompts[:3], max_new_tokens=3)
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, w[:p.size + 3])
    assert eng.metrics.counter("replica_kills") == 1
    assert eng.metrics.counter("killed_in_flight") == SLOTS


def test_engine_wide_sampling_draws_from_a_seeded_generator(ref):
    """top_k=1 keeps only the argmax, so sampling at any temperature must
    reproduce the greedy (JAX) tokens; a wider top-k is reproducible from
    the seed."""
    params, prompts, want = ref
    got = _engine(params, temperature=0.7, top_k=1).generate_all(
        prompts, max_new_tokens=3)
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, w[:p.size + 3])
    a, b = (_engine(params, temperature=1.0, top_k=5, seed=3).generate_all(
        prompts[:3], max_new_tokens=4) for _ in range(2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert ((x >= 0) & (x < VOCAB)).all()
    with pytest.raises(ValueError, match="temperature"):
        _engine(params, temperature=-1.0)
    with pytest.raises(ValueError, match="top_k"):
        _engine(params, top_k=VOCAB + 1)


@pytest.mark.parametrize("kv_cache", [None, "paged"])
def test_paged_kv_cache_is_not_ported_yet(ref, kv_cache):
    with pytest.raises(NotImplementedError, match="paged"):
        GenerationEngine(_spec(), ref[0], kv_cache=kv_cache, device="cpu")


def test_construction_without_cuda_and_without_device_raises(ref,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(_spec(), ref[0], kv_cache="dense")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(_spec())


def test_batcher_admission_control_is_typed():
    """Partial buckets dispatch at the deadline; a full queue, an expired
    deadline and a closed batcher each fail with their own type."""
    m = MetricsRegistry()
    b = DynamicBatcher(buckets=(4, 8), max_wait_ms=20, max_queue=3,
                       metrics=m)
    for i in range(3):
        b.submit({"x": i})
    with pytest.raises(QueueFullError):
        b.submit({"x": 3})
    t0 = time.monotonic()
    assert [r.payload["x"] for r in b.next_batch()] == [0, 1, 2]
    assert 0.015 <= time.monotonic() - t0 < 1.0
    dead = b.submit(1, timeout_ms=5)
    live = b.submit(2)
    time.sleep(0.02)
    assert [r.payload for r in b.next_batch()] == [2]
    with pytest.raises(RequestTimeoutError):
        dead.result(timeout=1)
    queued = b.submit(3)
    b.close()
    with pytest.raises(EngineClosedError):
        queued.result(timeout=1)
    with pytest.raises(EngineClosedError):
        b.submit(4)
    assert not live.done()
    assert (m.counter("rejected_queue_full"), m.counter("timeouts")) == (1, 1)


def _port_sources():
    return sorted((REPO / "paddle_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _forbidden(name):
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "jaxlib", "paddle_tpu"))


def test_port_imports_neither_jax_nor_the_jax_package():
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert offenders == []
    assert not _forbidden("paddle_tpu_torch")
    assert _forbidden("paddle_tpu.serving") and _forbidden("jax.numpy")


def test_port_path_calls_no_library_attention_or_compiler():
    """The yardstick call may appear in chip_smoke.py only. The one
    mention of cuDNN allowed is conv2d's switch that turns its TF32 off
    (``ops/common.py``), which calls nothing."""
    for path in sorted((REPO / "paddle_tpu_torch").rglob("*.py")):
        text = path.read_text().replace("torch.backends.cudnn.allow_tf32",
                                        "")
        for banned in ("scaled_dot_product_attention", "torch.compile",
                       "cudnn"):
            assert banned not in text, f"{path}: {banned}"
