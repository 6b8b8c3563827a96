#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each fatal on failure (nonzero exit, no result line):

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi). Without CUDA it raises.
2. Build: every CUDA kernel of the port, with nvcc from the repository's
   sources (kernels/build.py), all sources started together.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (plus ragged and D=128 cases), then timed
   with CUDA events beside the plain version and the PyTorch library call
   that computes the same function, with its roofline bound.
4. Serving: the d1024/L8/H16/V16384 transformer LM (random weights from a
   seed, carried in through ``load_jax_params``) serves requests with
   700-1024-token prompts through ``GenerationEngine(kv_cache="dense")``
   and ``Server``. Checks every result, zero dispatch errors, that the
   prefill went through the flash kernel (launches == layers x
   prefills), and that the served tokens match the plain path on the
   card.
5. Backward kernels: the flash dq and dkv kernels against their plain
   versions at the training shape (B8 H8 T2048 D128 causal), the serving
   shape and a ragged case with a fully masked row, then timed beside
   their plain versions, their bounds and the backward of
   ``F.scaled_dot_product_attention`` (its backend pinned and recorded).
6. Training: the d1024/L8/H8/V16384 LM (d_ff 4096, batch 8 x 2048
   tokens, f32, Adam lr 1e-4) built with the port's ``layers`` and
   ``models.transformer_lm(pipeline_stack=True)``, trained through
   ``AdamOptimizer.minimize`` and ``Executor(CUDAPlace())`` from the
   startup program's seeded weights. Checks one step's loss and every
   parameter gradient against the plain path on the card, that each step
   launched the forward, dq and dkv kernels once per layer, and that the
   loss is finite and falls over the timed steps on one fixed batch.

Prints a ``{"kernels": [...]}`` line and the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# f32 on both sides; the kernel sums over <= 1024 keys in another order
# (64-key tiles, online rescaling, sequential FMA) than cuBLAS does for
# the plain version, so expect ~1e-6 and allow 5e-5.
ATOL = RTOL = 5e-5
# Published peaks at the full power limit (NVIDIA H100 data sheet, dense,
# f32 outside the tensor cores): (f32 FLOP/s, memory bytes/s).
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12),
         "nvl": (60e12, 3.9e12)}


def _peaks(name):
    low = name.lower()
    return PEAKS["pcie" if "pcie" in low else "nvl" if "nvl" in low
                 else "sxm"]


def _cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _max_err(got, want):
    """Max abs error over finite entries; inf positions must agree."""
    import torch

    inf_g, inf_w = torch.isinf(got), torch.isinf(want)
    if not torch.equal(inf_g, inf_w):
        raise AssertionError("kernel and plain version disagree on which "
                             "rows are fully masked")
    fin = ~inf_w
    torch.testing.assert_close(got[fin], want[fin], atol=ATOL, rtol=RTOL)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def _visible_pairs(B, H, Tq, Tk, causal, lengths):
    """(query, key) pairs these inputs let attend: the work every flash
    kernel does for them."""
    vis = 0
    for b in range(B):
        n = Tk if lengths is None else max(0, min(int(lengths[b]), Tk))
        if causal:
            vis += sum(min(i + 1, n) for i in range(Tq))
        else:
            vis += Tq * n
    return H * vis


def _attention_work(B, H, Tq, Tk, D, causal, lengths):
    """(matmul FLOPs, bytes) the forward needs for these inputs: 4*D per
    visible (query, key) pair; q/k/v read once, o and lse written once."""
    flops = 4.0 * D * _visible_pairs(B, H, Tq, Tk, causal, lengths)
    nbytes = 4.0 * (B * H * (2 * Tq * D + 2 * Tk * D + Tq))
    return flops, nbytes


def _backward_work(kernel, B, H, Tq, Tk, D, causal, lengths):
    """(matmul FLOPs, bytes) of one backward kernel for these inputs. Per
    visible pair dq does Q.K^T, dO.V^T and dS.K (6*D FLOPs) and dkv also
    P^T.dO and dS^T.Q (8*D). Both read q, dO, k, v, lse and Di once; dq
    writes dq, dkv writes dk and dv."""
    pairs = _visible_pairs(B, H, Tq, Tk, causal, lengths)
    per_pair, writes = (6, Tq * D) if kernel == "dq" else (8, 2 * Tk * D)
    nbytes = 4.0 * B * H * (2 * Tq * D + 2 * Tk * D + 2 * Tq + writes)
    return per_pair * D * pairs, nbytes


def _bound(flops, nbytes, gpu_name):
    """(bound ms, what bounds it) at the card's published f32 peaks."""
    peak_flops, peak_bw = _peaks(gpu_name)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_phase(gpu_name):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(B, H, T, D):
        return tuple(torch.randn(B, H, T, D, device="cuda", generator=gen)
                     for _ in range(3))

    errs = []
    cases = [  # (B, H, T, D, causal, lengths): the serving shape first
        (8, 16, 1024, 64, True, None),
        (8, 16, 1000, 64, True, [1000, 999, 700, 513, 64, 1, 0, 1000]),
        (2, 4, 300, 128, False, [300, 17]),
    ]
    for B, H, T, D, causal, lengths in cases:
        q, k, v = qkv(B, H, T, D)
        lens = None if lengths is None else torch.tensor(lengths,
                                                         device="cuda")
        o, lse = fa.flash_forward(q, k, v, lens, causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, lens, causal)
        torch.cuda.synchronize()
        err = max(_max_err(o, ro), _max_err(lse, rlse))
        errs.append(err)
        print(f"flash_attention_fwd B{B} H{H} T{T} D{D} causal={causal} "
              f"lengths={lengths}: max_abs_err {err:.3e} (tol {ATOL})")

    B, H, T, D = 8, 16, 1024, 64
    q, k, v = qkv(B, H, T, D)
    ms = _cuda_ms(lambda: fa.flash_forward(q, k, v, None, True))
    plain_ms = _cuda_ms(
        lambda: fa.flash_attention_reference(q, k, v, None, True))
    library_ms = _cuda_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    flops, nbytes = _attention_work(B, H, T, T, D, True, None)
    bound_ms, bound_by = _bound(flops, nbytes, gpu_name)
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:229",
        "launches": None, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": f"B{B} H{H} T{T} D{D} causal f32",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    }


def serving_phase(record, gpu_name):
    import numpy as np
    import torch

    from paddle_tpu_torch import init_params
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import TransformerLM
    from paddle_tpu_torch.ops import pipeline_ops
    from paddle_tpu_torch.serving import GenerationEngine, LMSpec, Server

    peak_bw = _peaks(gpu_name)[1]
    spec = LMSpec(vocab_size=16384, d_model=1024, n_layers=8, num_heads=16,
                  max_len=2048)
    t0 = time.perf_counter()
    model = TransformerLM(spec, device="cuda")
    model.load_jax_params(init_params(spec, SEED))
    eng = GenerationEngine(spec, model, slots=8, kv_cache="dense",
                           device="cuda")
    t1 = time.perf_counter()
    combos = eng.warmup()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"serving: weights {t1 - t0:.2f} s, warmup {combos} shapes "
          f"{t2 - t1:.2f} s")

    rng = np.random.RandomState(SEED)
    n_req = 12  # more than the 8 slots: later requests join mid-flight
    prompts = [rng.randint(0, spec.vocab_size, rng.randint(700, 1025))
               .astype(np.int64) for _ in range(n_req)]
    horizons = [int(h) for h in rng.randint(32, 129, n_req)]
    horizons[0] = 128

    fa.flash_attention.launches = 0  # count the main path's launches only
    srv = Server([eng]).start()
    try:
        t3 = time.perf_counter()
        futs = [srv.submit({"prompt": p}, max_new_tokens=h)
                for p, h in zip(prompts, horizons)]
        results = [f.result(timeout=600) for f in futs]
        t4 = time.perf_counter()
    finally:
        srv.stop()
    launches = fa.flash_attention.launches
    snap = srv.metrics_snapshot()
    counters = snap["counters"]
    prefills = counters["prefills"]

    for p, h, r in zip(prompts, horizons, results):
        assert r.shape == (p.size + h,), (r.shape, p.size, h)
        assert np.array_equal(r[:p.size], p)
        assert ((r >= 0) & (r < spec.vocab_size)).all()
    assert counters.get("dispatch_errors", 0) == 0, counters
    assert counters["completed"] == n_req, counters
    assert prefills > 0 and launches == spec.n_layers * prefills, (
        launches, prefills)

    # the served tokens against the plain path on the card: one-shot
    # decode of request 0 with the flash kernel swapped for its plain
    # version (greedy, so the tokens must be equal)
    n_check = 8
    p0 = torch.from_numpy(prompts[0][None]).cuda()

    def plain(q, k, v, causal=False):
        return fa.flash_attention_reference(q, k, v, causal=causal)[0]

    kernel = pipeline_ops.flash_attention
    pipeline_ops.flash_attention = plain
    try:
        with torch.no_grad():
            ref = pipeline_ops.transformer_stack_generate(
                {"num_heads": spec.num_heads, "max_new_tokens": n_check},
                dict(model.shared_lm_inputs(), Prompt=[p0]))["Out"][0]
    finally:
        pipeline_ops.flash_attention = kernel
    ref = ref[0, prompts[0].size:].cpu().numpy()
    served = results[0][prompts[0].size:prompts[0].size + n_check]
    assert np.array_equal(served, ref), (served, ref)
    print(f"serving: request 0's first {n_check} tokens equal the plain "
          f"path's on the card: {served.tolist()}")

    lat = snap["latency"]
    gen_tokens = sum(horizons)
    # a decode step reads every non-embedding weight and, in the plain
    # slot attention, the whole dense cache: its byte floor
    step_bytes = 4.0 * sum(p.numel() for n, p in model.named_parameters()
                           if n not in ("tok_emb", "pos_emb"))
    step_bytes += 2.0 * eng.cache_k.numel() * eng.cache_k.element_size()
    serving = {
        "requests": n_req, "prompt_tokens": int(sum(p.size for p in prompts)),
        "generated_tokens": gen_tokens, "wall_s": t4 - t3,
        "tokens_per_s": gen_tokens / (t4 - t3),
        "prefills": prefills, "flash_launches": launches,
        "prefill_ms_mean": lat["prefill_ms"]["mean"],
        "prefill_ms_p50": lat["prefill_ms"]["p50"],
        "decode_step_ms_mean": lat["decode_step_ms"]["mean"],
        "decode_step_ms_p50": lat["decode_step_ms"]["p50"],
        "decode_steps": counters["decode_steps"],
        "decode_step_floor_ms": step_bytes / peak_bw * 1e3,
        "decode_step_bytes": step_bytes,
        "ttft_ms_p50": snap["hist"]["ttft"]["p50_ms"],
        "peak_mem_bytes": snap["gauges"].get("mem/cuda0_peak_bytes_in_use"),
        "warmup_s": t2 - t1,
    }
    print(f"serving: {n_req} requests, {serving['prompt_tokens']} prompt "
          f"tokens, {gen_tokens} generated in {t4 - t3:.3f} s = "
          f"{serving['tokens_per_s']:.1f} tok/s; {prefills} prefills "
          f"(mean {serving['prefill_ms_mean']:.2f} ms), decode step mean "
          f"{serving['decode_step_ms_mean']:.2f} ms over "
          f"{serving['decode_steps']} steps (byte floor "
          f"{serving['decode_step_floor_ms']:.3f} ms); flash launches "
          f"{launches}")
    record["launches"] = launches
    return serving


# (B, H, T, D, causal, lengths): the training shape first, then the
# serving shape and a ragged case with a fully masked row (length 0)
BWD_CASES = [
    (8, 8, 2048, 128, True, None),
    (8, 16, 1024, 64, True, None),
    (4, 4, 1000, 64, True, [1000, 517, 0, 63]),
    (2, 4, 300, 128, False, [300, 17]),
]
# The training configuration: bench_transformer_step's defaults with the
# stacked layer path (pipeline_stack=True), f32.
TRAIN = dict(vocab=16384, d_model=1024, n_layers=8, num_heads=8, d_ff=4096,
             max_len=2048, batch=8, seq=2048, lr=1e-4)
# One step's loss and gradients, kernels against plain versions: both run
# the same f32 program from the same state and differ only in the
# attention's summation order (64-key tiles, FMA chains vs cuBLAS), which
# moves each gradient by ~1e-6 of its norm after 8 layers; allow 1e-4 of
# the norm per parameter and 1e-5 relative on the loss.
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5


def backward_kernel_phase(gpu_name):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    errs = {"dq": [], "dkv": []}
    for B, H, T, D, causal, lengths in BWD_CASES:
        q, k, v, do = (randn(B, H, T, D) for _ in range(4))
        lens = None if lengths is None else torch.tensor(lengths,
                                                         device="cuda")
        o, lse = fa.flash_forward(q, k, v, lens, causal)
        dq, dk, dv = fa.flash_backward(q, k, v, o, lse, do, lens, causal)
        torch.cuda.synchronize()
        rq, rk, rv = fa.flash_attention_backward_reference(q, k, v, o, lse,
                                                           do, lens, causal)
        torch.cuda.synchronize()
        for name, t in (("dq", rq), ("dk", rk), ("dv", rv)):
            assert t.abs().max() > 0, f"plain {name} is all zero"
        got = {"dq": _max_err(dq, rq),
               "dkv": max(_max_err(dk, rk), _max_err(dv, rv))}
        for name, err in got.items():
            errs[name].append(err)
        if lengths is not None and 0 in lengths:
            row = lengths.index(0)
            assert not dq[row].any() and not dk[row].any() \
                and not dv[row].any(), "fully masked row got a gradient"
        print(f"flash_attention_bwd B{B} H{H} T{T} D{D} causal={causal} "
              f"lengths={lengths}: max_abs_err dq {got['dq']:.3e} dk/dv "
              f"{got['dkv']:.3e} (tol {ATOL}); max |dq| "
              f"{float(rq.abs().max()):.3e} |dk| {float(rk.abs().max()):.3e} "
              f"|dv| {float(rv.abs().max()):.3e}")
        del q, k, v, do, o, lse, dq, dk, dv, rq, rk, rv

    # timing at the training shape
    B, H, T, D, causal, _ = BWD_CASES[0]
    q, k, v, do = (randn(B, H, T, D) for _ in range(4))
    o, lse = fa.flash_forward(q, k, v, None, causal)
    di = (do * o).sum(-1)
    ms = {"dq": _cuda_ms(lambda: fa.flash_dq(q, k, v, lse, di, do, None,
                                             causal), iters=10),
          "dkv": _cuda_ms(lambda: fa.flash_dkv(q, k, v, lse, di, do, None,
                                               causal), iters=10)}
    plain_ms = {
        "dq": _cuda_ms(lambda: fa.flash_dq_reference(q, k, v, lse, di, do,
                                                     None, causal), iters=5),
        "dkv": _cuda_ms(lambda: fa.flash_dkv_reference(q, k, v, lse, di, do,
                                                       None, causal),
                        iters=5)}
    fwd_ms = _cuda_ms(lambda: fa.flash_forward(q, k, v, None, causal),
                      iters=10)
    library_ms, backend = _sdpa_backward_ms(F, q, k, v, do)
    print(f"flash_attention_bwd timing B{B} H{H} T{T} D{D} causal: dq "
          f"{ms['dq']:.3f} ms (plain {plain_ms['dq']:.3f}), dkv "
          f"{ms['dkv']:.3f} ms (plain {plain_ms['dkv']:.3f}), forward "
          f"{fwd_ms:.3f} ms; SDPA backward ({backend}) {library_ms:.3f} ms")
    records = []
    for name, line in (("dq", 364), ("dkv", 386)):
        flops, nbytes = _backward_work(name, B, H, T, T, D, causal, None)
        bound_ms, bound_by = _bound(flops, nbytes, gpu_name)
        records.append({
            "name": f"flash_attention_bwd_{name}", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "launches": None, "max_abs_err": max(errs[name]),
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bound_ms, "bound_by": bound_by,
            # SDPA's backward computes dq, dk and dv in one call: it is
            # the yardstick for the two kernels together
            "library_ms": library_ms, "library": f"sdpa backward, {backend}",
            "shape": f"B{B} H{H} T{T} D{D} causal f32",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "fwd_ms_training_shape": fwd_ms,
        })
    return records


def _sdpa_backward_ms(F, q, k, v, do):
    """(ms, backend) of the backward of F.scaled_dot_product_attention
    (is_causal) on these inputs: forward + backward minus the forward
    alone, with the backend pinned to the first that takes f32."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, do)

    names = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
             "MATH")
    for backend in (getattr(SDPBackend, n) for n in names
                    if hasattr(SDPBackend, n)):
        try:  # a backend that refuses f32 warns, then raises
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                fwd_bwd()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        with sdpa_kernel(backend):
            total = _cuda_ms(fwd_bwd, iters=10)
            forward = _cuda_ms(fwd, iters=10)
        return total - forward, backend.name
    raise RuntimeError("no SDPA backend ran f32 attention")


def transformer_train_flops(bs, T, d, n_layers, vocab, d_ff=None):
    """Model FLOPs of one train step (2 per MAC, forward x 3 for forward
    plus backward), attention at its causal cost, as bench.py counts
    them."""
    d_ff = d_ff or 4 * d
    dense = n_layers * (2 * bs * T * d * (4 * d)
                        + 2 * bs * T * d * (2 * d_ff))
    attn = n_layers * 2 * bs * T * T * d
    head = 2 * bs * T * d * vocab
    return 3 * (dense + attn + head)


def _build_training_program(pt, c):
    from paddle_tpu_torch import layers, models

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        ids = layers.data("ids", shape=[c["seq"]], dtype="int64")
        tgt = layers.data("tgt", shape=[c["seq"]], dtype="int64")
        logits = models.transformer_lm(
            ids, vocab_size=c["vocab"], d_model=c["d_model"],
            n_layers=c["n_layers"], num_heads=c["num_heads"],
            d_ff=c["d_ff"], max_len=c["max_len"], pipeline_stack=True)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.reshape(logits, shape=[-1, c["vocab"]]),
            layers.reshape(tgt, shape=[-1, 1])))
        params_grads = pt.optimizer.AdamOptimizer(
            learning_rate=c["lr"]).minimize(loss, startup_program=startup)
    return main, startup, loss, params_grads


def _launch_counts(fa):
    return (fa.flash_attention.launches, fa.flash_backward.dq_launches,
            fa.flash_backward.dkv_launches)


def _reset_launch_counts(fa):
    fa.flash_attention.launches = 0
    fa.flash_backward.dq_launches = 0
    fa.flash_backward.dkv_launches = 0


def training_phase(records, gpu_name):
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import flash_attention as fa

    c = TRAIN
    L, tokens = c["n_layers"], c["batch"] * c["seq"]
    t0 = time.perf_counter()
    main, startup, loss, params_grads = _build_training_program(pt, c)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace())
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(scope.get(p.name).numel() for p, _ in params_grads)
    print(f"training: program of {len(main.global_block.ops)} ops, "
          f"{len(params_grads)} parameters ({n_params / 1e6:.1f} M), built "
          f"and initialised in {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(SEED)
    feed = {"ids": rng.randint(0, c["vocab"], size=(c["batch"], c["seq"]))
            .astype("int64"),
            "tgt": rng.randint(0, c["vocab"], size=(c["batch"], c["seq"]))
            .astype("int64")}
    state = {n: scope.get(n).clone() for n in list(scope.keys())
             if isinstance(scope.get(n), torch.Tensor)}

    def restore():
        for n, t in state.items():
            scope.set(n, t.clone())

    # parity on the card: one step's loss and every gradient, with the
    # kernels and then with their plain versions, from the same state
    grad_names = [g.name for _, g in params_grads]
    fetch = [loss.name] + grad_names
    kern = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False)
    restore()
    # every flash wrapper dispatches through _plain_device: answering yes
    # for the CUDA tensors too swaps in the plain versions on the card
    dispatch = fa._plain_device
    fa._plain_device = lambda t: True
    before = _launch_counts(fa)
    try:
        plain = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
    finally:
        fa._plain_device = dispatch
    assert _launch_counts(fa) == before, "the plain path launched a kernel"
    restore()
    lk, lp = float(kern[0]), float(plain[0])
    assert np.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp), (lk, lp)
    worst = (-1.0, "")
    for name, gk, gp in zip(grad_names, kern[1:], plain[1:]):
        assert torch.isfinite(gk).all(), name
        rel = float((gk - gp).norm() / gp.norm().clamp_min(1e-30))
        worst = max(worst, (rel, name))
    assert worst[0] <= GRAD_RTOL, worst
    print(f"training: step loss kernels {lk:.6f} plain {lp:.6f}; worst "
          f"gradient |kernel - plain| / |plain| {worst[0]:.3e} ({worst[1]}) "
          f"over {len(grad_names)} parameters (tol {GRAD_RTOL})")
    del kern, plain

    # the main path: 1 warm step, then 6 timed steps on one fixed batch
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    _reset_launch_counts(fa)
    for step in range(7):
        t1 = time.perf_counter()
        lo, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        step_s.append(time.perf_counter() - t1)
        losses.append(float(lo))
    launches = _launch_counts(fa)
    assert launches == (7 * L,) * 3, launches
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    peak_mem = torch.cuda.max_memory_allocated()
    med = float(np.median(step_s[1:]))
    flops = transformer_train_flops(c["batch"], c["seq"], c["d_model"], L,
                                    c["vocab"], c["d_ff"])
    peak_flops = _peaks(gpu_name)[0]
    for rec in records:
        rec["launches"] = launches[1 if rec["name"].endswith("_dq") else 2] \
            // 7
    kern_ms = {"fwd": records[0]["fwd_ms_training_shape"],
               "dq": records[0]["ms"], "dkv": records[1]["ms"]}
    kern_step_ms = {k: v * L for k, v in kern_ms.items()}
    print(f"training: losses {[round(x, 5) for x in losses]}")
    print(f"training: step median {med * 1e3:.1f} ms over 6 steps "
          f"({[round(x * 1e3, 1) for x in step_s]} ms), "
          f"{tokens / med:.0f} tokens/s, {flops / 1e12:.2f} TFLOP/step = "
          f"{flops / med / peak_flops * 100:.1f}% of the f32 peak, peak "
          f"memory {peak_mem / 2**30:.2f} GiB; launches per step fwd/dq/dkv "
          f"{[n // 7 for n in launches]}; kernels per step (timed alone x "
          f"{L}): fwd {kern_step_ms['fwd']:.1f} ms, dq "
          f"{kern_step_ms['dq']:.1f} ms, dkv {kern_step_ms['dkv']:.1f} ms = "
          f"{sum(kern_step_ms.values()) / (med * 1e3) * 100:.1f}% of the "
          f"step")
    profile = _profile_step(exe, main, feed, loss, scope)
    return {
        "config": c, "params": n_params, "losses": losses,
        "step_ms": [x * 1e3 for x in step_s], "step_ms_median": med * 1e3,
        "tokens_per_s": tokens / med, "tflop_per_step": flops / 1e12,
        "f32_peak_share": flops / med / peak_flops,
        "peak_mem_bytes": peak_mem, "launches_per_step": {
            "fwd": launches[0] // 7, "dq": launches[1] // 7,
            "dkv": launches[2] // 7},
        "kernel_ms_per_step_timed_alone": kern_step_ms,
        "parity": {"loss_kernels": lk, "loss_plain": lp,
                   "worst_grad_rel": worst[0], "worst_grad": worst[1]},
        "profile": profile,
    }


def _profile_step(exe, main, feed, loss, scope):
    """Device time of one train step by kernel, from torch.profiler (CUPTI);
    a measurement aid, not a check: without device times it says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
        # kernels only: an op's device time repeats its kernels'
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0)
            if dev_us:
                rows.append((dev_us / 1e3, e.count, e.key))
    except Exception as exc:  # noqa: BLE001 - report, do not fail the run
        print(f"profile: not measured ({type(exc).__name__}: {exc})")
        return None
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        print("profile: no device time recorded")
        return None
    groups = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for ms, _, key in rows:
        for g in groups:
            if g in key:
                groups[g] += ms
    print(f"profile: one step, {total:.1f} ms of device time; flash fwd "
          f"{groups['flash_fwd']:.1f} ms, dq {groups['flash_bwd_dq']:.1f} "
          f"ms, dkv {groups['flash_bwd_dkv']:.1f} ms")
    for ms, n, key in rows[:12]:
        print(f"profile: {ms:9.2f} ms {n:5d}x {key[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_profile.txt").write_text("\n".join(
        f"{ms:.4f}\t{n}\t{key}" for ms, n, key in rows))
    return {"device_ms": total, "kernels_ms": groups,
            "top": [[ms, n, key] for ms, n, key in rows[:25]]}


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device and found none")
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.kernels import build

    # full-f32 references: no TF32 in either matmul path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    gpu = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {gpu}")

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name in build.SOURCES:
        for line in build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    kern = kernel_phase(gpu)
    serving = serving_phase(kern, gpu)
    bwd = backward_kernel_phase(gpu)
    training = training_phase(bwd, gpu)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernels": [kern] + bwd, "serving": serving,
         "training": training, "build_s": built}, indent=1))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in [kern] + bwd]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
