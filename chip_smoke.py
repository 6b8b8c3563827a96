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
7. TF32: the port's conv2d (3x3 s2 p1, NHWC, 64 -> 64) on the card, with
   cuDNN's TF32 at PyTorch's default (on), against the same op in f64 on
   the CPU: output, dX and dW within 1e-5 of the largest reference value.
8. Conv-epilogue kernels: conv1x1_stats, conv1x1_epilogue and
   scale_shift_act against their plain versions at every distinct shape
   of the ResNet-50 train step (batch 256) and inference batch (16) and
   at ragged shapes, then timed at each of those shapes beside the plain
   version, the roofline bound and a library yardstick.
9. ResNet-50 training: ``models.resnet_imagenet(depth=50)`` at 224 x 224,
   1000 classes, batch 256, f32, under ``--fused_conv_epilogue``, trained
   through ``MomentumOptimizer(0.1, 0.9).minimize`` from the startup
   program's seeded weights. Checks one step's loss and gradients against
   the plain path (gradients against the plain path's own move when its
   statistics are summed in f64), 33 conv1x1_stats and 33 scale_shift_act
   launches per step, and a finite, falling loss over the timed steps on
   one fixed batch; profiles one step (``chiprun_out/resnet_profile.txt``).
10. ResNet-50 inference: the ``clone(for_test=True)`` program on the
    trained scope at batch 16: logits against the plain path and 33
    conv1x1_epilogue launches per batch.

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


def _profile_step(exe, main, feed, loss, scope, path="train_profile.txt",
                  groups=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
    """Device time of one train step by kernel, from torch.profiler (CUPTI),
    summed per group of kernel names (``groups``: substrings) and written
    to ``chiprun_out/<path>``; a measurement aid, not a check: without
    device times it says so."""
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
    sums = {g: 0.0 for g in groups}
    for ms, _, key in rows:
        for g in groups:  # the first group that matches takes the kernel
            if g in key:
                sums[g] += ms
                break
    print(f"profile: one step, {total:.1f} ms of device time; "
          + ", ".join(f"{g} {ms:.1f} ms" for g, ms in sums.items()))
    for ms, n, key in rows[:12]:
        print(f"profile: {ms:9.2f} ms {n:5d}x {key[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / path).write_text("\n".join(
        f"{ms:.4f}\t{n}\t{key}" for ms, n, key in rows))
    return {"device_ms": total, "kernels_ms": sums,
            "top": [[ms, n, key] for ms, n, key in rows[:25]]}


# --- ResNet-50 under --fused_conv_epilogue ------------------------------------
# bench.py's ResNet-50 training configuration (measure_resnet): 224x224x3
# images, 1000 classes, Momentum(lr 0.1, momentum 0.9), batch 256, in f32
# where the bench runs AMP; inference on the for_test clone at
# bench_inference's batch 16.
RESNET = dict(size=224, classes=1000, depth=50, batch=256, infer_batch=16,
              lr=0.1, momentum=0.9)
FUSED_OPS = 33  # conv1x1_bn_act ops of ResNet-50 under the flag
# Kernel against plain version, f32 on both sides:
# - GEMM outputs (y of conv1x1_stats, conv1x1_epilogue's out): K <= 2048
#   products summed in 8-deep slices by one FMA chain per output against
#   cuBLAS's order; ~3e-5 at K = 2048, allow 1e-4 absolute and relative.
# - statistics: per-channel sums over up to 802816 rows, in another order
#   (8 rows a thread, 16 threads, 128-row tiles in a fixed order) than
#   torch.sum; rounding grows with the summed mass, so the error of each
#   channel's sum (sum of squares) is held to 1e-5 of sum |y| (sum y^2):
#   a dropped 128-row tile is 1.6e-4 of the mass at the largest R.
# - scale_shift_act: elementwise, differing at most by an FMA contraction;
#   allow 1e-5 absolute and relative.
# - the logits of 53 BN layers' worth of these kernels against the plain
#   path: 1e-4 of the largest |logit|.
# - one train step's gradients: at this initialisation they are as
#   sensitive to the rounding of the BN statistics as the loss is not.
#   Measured on the card (H100, batch 256 and 32): the plain path alone
#   moves its parameter gradients by 2.5% of their norm (median; 3.1%
#   worst) when only the fused ops' statistics are summed in f64 instead
#   of f32, and the kernels' f32 sums land as close. So each gradient's
#   distance from the plain path is held to SENS_FACTOR times the plain
#   path's own distance under that f64 summation (or GRAD_RTOL of its
#   norm, if larger), and the distance over all gradients together to
#   SENS_TOTAL times; a dropped tile or a wrong row moves them by far
#   more.
GEMM_TOL = 1e-4
STATS_TOL = 1e-5
APPLY_TOL = 1e-5
LOGIT_RTOL = 1e-4
# The port's conv2d on the card against the same op on the CPU in f64: a
# K = 576 f32 sum errs ~1e-6 of the largest output; TF32 ~1e-3.
TF32_RTOL = 1e-5
SENS_FACTOR = 4.0
SENS_TOTAL = 2.0
CONV_KERNELS = ("conv1x1_stats", "conv1x1_epilogue", "scale_shift_act")
CONV_REPLACES = {"conv1x1_stats": 94, "conv1x1_epilogue": 169,
                 "scale_shift_act": 235}


def _conv_counts(ke):
    return tuple(getattr(ke, n).launches for n in CONV_KERNELS)


def _reset_conv_counts(ke):
    for n in CONV_KERNELS:
        getattr(ke, n).launches = 0


def _build_resnet(pt, c):
    """ResNet-50 under --fused_conv_epilogue: (main, startup, test_prog,
    loss, logits, params_grads), the for_test clone taken before
    minimize, as fluid does."""
    from paddle_tpu_torch import layers, models

    pt.flags.FLAGS.fused_conv_epilogue = True
    try:
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = SEED
        with pt.program_guard(main, startup):
            images = layers.data("images", [c["size"], c["size"], 3])
            label = layers.data("label", [1], "int64")
            logits = models.resnet_imagenet(images, num_classes=c["classes"],
                                            depth=c["depth"])
            test_prog = main.clone(for_test=True)
            loss = layers.mean(layers.softmax_with_cross_entropy(logits,
                                                                 label))
            params_grads = pt.optimizer.MomentumOptimizer(
                learning_rate=c["lr"], momentum=c["momentum"]).minimize(
                    loss, startup_program=startup)
    finally:
        pt.flags.FLAGS.fused_conv_epilogue = False
    return main, startup, test_prog, loss, logits, params_grads


def _fused_shapes(program, batch):
    """(R, I, O, residual, act) of every conv1x1_bn_act op of ``program``
    at ``batch``, in program order."""
    blk = program.global_block
    shapes = []
    for op in blk.ops:
        if op.type != "conv1x1_bn_act":
            continue
        _, H, W, I = blk.var(op.inputs["X"][0]).shape
        O = blk.var(op.inputs["Filter"][0]).shape[-1]
        shapes.append((batch * H * W, I, O, bool(op.inputs.get("Residual")),
                       op.attrs.get("act") or None))
    return shapes


def _resnet_train_flops(program, batch):
    """Model FLOPs of one train step: 2 per MAC of every conv, fused conv
    and fc in the forward, times 3 for forward plus backward."""
    blk = program.global_block
    fwd = 0
    for op in blk.ops:
        if op.type == "conv2d":
            out = blk.var(op.outputs["Output"][0]).shape
            kh, kw, ci, _ = blk.var(op.inputs["Filter"][0]).shape
            fwd += 2 * batch * out[1] * out[2] * out[3] * kh * kw * ci
        elif op.type == "conv1x1_bn_act":
            _, H, W, I = blk.var(op.inputs["X"][0]).shape
            O = blk.var(op.inputs["Filter"][0]).shape[-1]
            fwd += 2 * batch * H * W * I * O
        elif op.type == "mul":
            k, n = blk.var(op.inputs["Y"][0]).shape
            fwd += 2 * batch * k * n
    return 3 * fwd


def _conv_work(kind, R, I, O, residual, act):
    """(FLOPs, bytes) of one kernel call: 2*R*I*O for the products (an
    elementwise pass counts its multiply, add, residual add and relu per
    value); every input read once and every output written once."""
    rows = R * O * (1 + int(residual))  # [R, O] inputs: y or residual
    if kind == "scale_shift_act":
        flops = R * O * (2 + int(residual) + int(act == "relu"))
        return flops, 4.0 * (rows + R * O + 2 * O)
    nbytes = R * I + I * O + R * O + 2 * O  # stats out, or scale/shift in
    if kind == "conv1x1_epilogue" and residual:
        nbytes += R * O
    return 2.0 * R * I * O, 4.0 * nbytes


def _assert_close(got, want, tol, what):
    import torch

    try:
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    except AssertionError as exc:
        raise AssertionError(f"{what}: {exc}") from None
    return float((got - want).abs().max())


def conv_epilogue_kernel_phase(gpu_name, train_shapes, infer_shapes):
    """Each conv-epilogue kernel against its plain version at every
    distinct shape of the ResNet-50 train step and inference batch, and
    at ragged shapes; then timed at each of the main path's shapes."""
    import torch

    from paddle_tpu_torch.kernels import conv_epilogue as ke

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def inputs(R, I, O, residual):
        x = torch.randn(R, I, device="cuda", generator=gen)
        w = torch.randn(I, O, device="cuda", generator=gen) * I ** -0.5
        scale = 1.0 + 0.2 * torch.randn(O, device="cuda", generator=gen)
        shift = 0.1 * torch.randn(O, device="cuda", generator=gen)
        res = (torch.randn(R, O, device="cuda", generator=gen)
               if residual else None)
        return x, w, scale, shift, res

    ragged = [(R, I, O, res, act) for R, I, O in ((100, 32, 16),
                                                  (1000, 72, 40))
              for res, act in ((False, None), (True, "relu"))]
    errs = {k: 0.0 for k in CONV_KERNELS}
    stats_err = 0.0
    for R, I, O, res, act in sorted(set(train_shapes) | set(ragged)):
        x, w, scale, shift, r = inputs(R, I, O, res)
        y, stats = ke.conv1x1_stats(x, w)
        torch.cuda.synchronize()
        ry, rstats = ke.conv1x1_stats_reference(x, w)
        err = _assert_close(y, ry, GEMM_TOL, f"conv1x1_stats y {R}x{I}x{O}")
        mass = torch.stack([ry.abs().sum(0), (ry * ry).sum(0)])
        s_err = float(((stats - rstats).abs() / mass.clamp_min(1e-30)).max())
        assert s_err <= STATS_TOL, (R, I, O, s_err)
        out = ke.scale_shift_act(ry, scale, shift, r, act)
        torch.cuda.synchronize()
        a_err = _assert_close(
            out, ke.scale_shift_act_reference(ry, scale, shift, r, act),
            APPLY_TOL, f"scale_shift_act {R}x{O}")
        errs["conv1x1_stats"] = max(errs["conv1x1_stats"], err)
        errs["scale_shift_act"] = max(errs["scale_shift_act"], a_err)
        stats_err = max(stats_err, s_err)
        print(f"conv1x1_stats/scale_shift_act R{R} I{I} O{O} residual={res} "
              f"act={act}: y {err:.3e} (tol {GEMM_TOL}), stats {s_err:.3e} "
              f"of the summed mass (tol {STATS_TOL}), apply {a_err:.3e} "
              f"(tol {APPLY_TOL})")
        del x, w, r, y, ry, out
    for R, I, O, res, act in sorted(set(infer_shapes) | set(ragged)):
        x, w, scale, shift, r = inputs(R, I, O, res)
        out = ke.conv1x1_epilogue(x, w, scale, shift, r, act)
        torch.cuda.synchronize()
        err = _assert_close(
            out, ke.conv1x1_epilogue_reference(x, w, scale, shift, r, act),
            GEMM_TOL, f"conv1x1_epilogue {R}x{I}x{O}")
        errs["conv1x1_epilogue"] = max(errs["conv1x1_epilogue"], err)
        print(f"conv1x1_epilogue R{R} I{I} O{O} residual={res} act={act}: "
              f"{err:.3e} (tol {GEMM_TOL})")
        del x, w, r, out

    # timing at every shape the main path runs, weighted by its count
    timed = {k: {} for k in CONV_KERNELS}
    for kind, shapes in (("conv1x1_stats", train_shapes),
                         ("scale_shift_act", train_shapes),
                         ("conv1x1_epilogue", infer_shapes)):
        for shape in sorted(set(shapes)):
            R, I, O, res, act = shape
            x, w, scale, shift, r = inputs(R, I, O, res)
            if kind == "conv1x1_stats":
                calls = (lambda: ke.conv1x1_stats(x, w),
                         lambda: ke.conv1x1_stats_reference(x, w),
                         lambda: torch.matmul(x, w))
            elif kind == "conv1x1_epilogue":
                calls = (lambda: ke.conv1x1_epilogue(x, w, scale, shift, r,
                                                     act),
                         lambda: ke.conv1x1_epilogue_reference(
                             x, w, scale, shift, r, act),
                         lambda: torch.matmul(x, w))
            else:
                y = torch.randn(R, O, device="cuda", generator=gen)
                calls = (lambda: ke.scale_shift_act(y, scale, shift, r, act),
                         lambda: ke.scale_shift_act_reference(y, scale, shift,
                                                              r, act),
                         lambda: torch.addcmul(shift, y, scale))
            ms, plain, lib = (_cuda_ms(f, iters=10) for f in calls)
            flops, nbytes = _conv_work(kind, R, I, O, res, act)
            bound, by = _bound(flops, nbytes, gpu_name)
            row = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": bound, "bound_by": by,
                   "count": shapes.count(shape)}
            if kind == "scale_shift_act":  # the same pass as addcmul's
                row["ms_no_residual_no_act"] = _cuda_ms(
                    lambda: ke.scale_shift_act(y, scale, shift), iters=10)
            timed[kind][shape] = row
            print(f"{kind} R{R} I{I} O{O} residual={res} act={act} "
                  f"x{row['count']}: {ms:.4f} ms, plain {plain:.4f}, "
                  f"library {lib:.4f}, bound {bound:.4f} ({by})")
            del x, w, r, calls
    _reset_conv_counts(ke)  # comparison launches do not count

    library = {"conv1x1_stats": "torch.matmul, product only",
               "conv1x1_epilogue": "torch.matmul, product only",
               "scale_shift_act": "torch.addcmul(shift, y, scale), no "
                                  "residual, no act"}
    records = []
    for kind in CONV_KERNELS:
        rows = timed[kind]
        shape, top = max(rows.items(), key=lambda kv: kv[1]["bound_ms"])
        per_step = {k: sum(r[k] * r["count"] for r in rows.values())
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        rec = {
            "name": kind, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/conv_epilogue.cu",
            "replaces": f"paddle_tpu/kernels/conv_epilogue.py:"
                        f"{CONV_REPLACES[kind]}",
            "launches": None, "max_abs_err": errs[kind], "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "library": library[kind],
            "shape": "R{} I{} O{} residual={} act={}".format(*shape),
            "per_step": per_step,
            "per_shape": [[list(k), v] for k, v in rows.items()],
        }
        if kind == "conv1x1_stats":
            rec["stats_err_of_mass"] = stats_err
        if kind == "scale_shift_act":
            rec["ms_no_residual_no_act"] = top["ms_no_residual_no_act"]
        print(f"{kind}: heaviest shape {rec['shape']} {top['ms']:.4f} ms vs "
              f"bound {top['bound_ms']:.4f} ({top['bound_by']}); per "
              f"{'batch' if kind == 'conv1x1_epilogue' else 'step'} "
              f"{per_step['ms']:.3f} ms (plain {per_step['plain_ms']:.3f}, "
              f"library {per_step['library_ms']:.3f}, bound "
              f"{per_step['bound_ms']:.3f})")
        records.append(rec)
    return records


def tf32_phase():
    """The port's conv2d (3x3 s2 p1, NHWC, I = O = 64) on the card, with
    cuDNN's TF32 left at PyTorch's default (on), against the same op on
    the CPU in f64: output, dX and dW within TF32_RTOL of the largest
    reference value. TF32 would err by ~1e-3."""
    import torch

    from paddle_tpu_torch.core.registry import get_op

    conv = get_op("conv2d").fn
    attrs = {"strides": 2, "paddings": 1, "dilations": 1, "groups": 1,
             "data_format": "NHWC"}
    gen = torch.Generator().manual_seed(SEED + 4)
    x = torch.randn(8, 56, 56, 64, generator=gen, dtype=torch.float64)
    w = torch.randn(3, 3, 64, 64, generator=gen,
                    dtype=torch.float64) / 24.0
    gy = torch.randn(8, 28, 28, 64, generator=gen, dtype=torch.float64)

    def run(dev, dtype):
        xx = x.to(dev, dtype).requires_grad_()
        ww = w.to(dev, dtype).requires_grad_()
        y = conv(attrs, {"Input": [xx], "Filter": [ww]})["Output"][0]
        dx, dw = torch.autograd.grad(y, [xx, ww], gy.to(dev, dtype))
        return [t.detach().double().cpu() for t in (y, dx, dw)]

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the op must turn it off itself
    try:
        got = run("cuda", torch.float32)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    want = run("cpu", torch.float64)
    errs = {name: float((g - r).abs().max() / r.abs().max())
            for name, g, r in zip(("out", "dX", "dW"), got, want)}
    assert all(e <= TF32_RTOL for e in errs.values()), errs
    print(f"conv2d 3x3 s2 p1 NHWC 64->64 on the card vs f64 on the CPU, "
          f"cuDNN TF32 on by default: max error / max |ref| "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {TF32_RTOL})")
    return errs


def resnet_training_phase(records, gpu_name, built):
    """ResNet-50 at batch 256 trained through Momentum.minimize and
    Executor(CUDAPlace()): one step's loss and gradients with the kernels
    against the plain path, then 1 warm + 6 timed steps on one batch."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import conv_epilogue as ke

    c = RESNET
    B = c["batch"]
    main, startup, test_prog, loss, logits, params_grads = built
    t0 = time.perf_counter()
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace())
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(scope.get(p.name).numel() for p, _ in params_grads)
    print(f"resnet: program of {len(main.global_block.ops)} ops "
          f"({sum(op.type == 'conv1x1_bn_act' for op in main.global_block.ops)}"
          f" conv1x1_bn_act), {len(params_grads)} parameters "
          f"({n_params / 1e6:.2f} M), initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    feed = {"images": torch.randn(B, c["size"], c["size"], 3, device="cuda",
                                  generator=gen),
            "label": torch.randint(0, c["classes"], (B, 1), device="cuda",
                                   generator=gen)}
    state = {n: scope.get(n).clone() for n in list(scope.keys())
             if isinstance(scope.get(n), torch.Tensor)}

    def restore():
        for n, t in state.items():
            scope.set(n, t.clone())

    grad_names = [g.name for _, g in params_grads]
    fetch = [loss.name] + grad_names
    kern = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False)
    restore()
    plain = _plain_step(exe, main, feed, fetch, scope, ke)
    restore()
    # the plain path's own sensitivity: its statistics summed in f64
    plain64 = _plain_step(exe, main, feed, fetch, scope, ke, f64_stats=True)
    restore()
    del state
    lk, lp = float(kern[0]), float(plain[0])
    assert np.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp), (lk, lp)
    d_kp, d_pp, norms, worst = [], [], [], (-1.0, "")
    for name, gk, gp, g64 in zip(grad_names, kern[1:], plain[1:],
                                 plain64[1:]):
        assert torch.isfinite(gk).all(), name
        dk, dp, n = (float((gk - gp).norm()), float((g64 - gp).norm()),
                     float(gp.norm()))
        d_kp.append(dk)
        d_pp.append(dp)
        norms.append(n)
        worst = max(worst, (dk / max(GRAD_RTOL * n, SENS_FACTOR * dp, 1e-30),
                            name))
    total_k = float(np.linalg.norm(d_kp)) / float(np.linalg.norm(norms))
    total_p = float(np.linalg.norm(d_pp)) / float(np.linalg.norm(norms))
    rel_k = np.array(d_kp) / np.maximum(norms, 1e-30)
    rel_p = np.array(d_pp) / np.maximum(norms, 1e-30)
    print(f"resnet: step loss kernels {lk:.6f} plain {lp:.6f} plain with "
          f"f64 statistics {float(plain64[0]):.6f}; gradients |kernel - "
          f"plain| / |plain| median {np.median(rel_k):.3e} max "
          f"{rel_k.max():.3e}, all together {total_k:.3e}; the plain path's "
          f"own move under f64 statistics median {np.median(rel_p):.3e} max "
          f"{rel_p.max():.3e}, all together {total_p:.3e}; worst "
          f"kernel-to-allowance ratio {worst[0]:.3f} ({worst[1]}) over "
          f"{len(grad_names)} parameters")
    assert worst[0] <= 1.0, worst
    assert total_k <= max(SENS_TOTAL * total_p, GRAD_RTOL), (total_k,
                                                              total_p)
    del kern, plain, plain64

    # the main path: 1 warm step, then 6 timed steps on one fixed batch
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    _reset_conv_counts(ke)
    for _ in range(7):
        t1 = time.perf_counter()
        lo, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        step_s.append(time.perf_counter() - t1)
        losses.append(float(lo))
    launches = _conv_counts(ke)
    assert launches == (7 * FUSED_OPS, 0, 7 * FUSED_OPS), launches
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    peak_mem = torch.cuda.max_memory_allocated()
    med = float(np.median(step_s[1:]))
    flops = _resnet_train_flops(main, B)
    peak_flops = _peaks(gpu_name)[0]
    by_name = {r["name"]: r for r in records}
    by_name["conv1x1_stats"]["launches"] = launches[0] // 7
    by_name["scale_shift_act"]["launches"] = launches[2] // 7
    kern_ms = {k: by_name[k]["per_step"]["ms"]
               for k in ("conv1x1_stats", "scale_shift_act")}
    print(f"resnet: losses {[round(x, 5) for x in losses]}")
    print(f"resnet: step median {med * 1e3:.1f} ms over 6 steps "
          f"({[round(x * 1e3, 1) for x in step_s]} ms), {B / med:.1f} "
          f"images/s, {flops / 1e12:.2f} TFLOP/step = "
          f"{flops / med / peak_flops * 100:.1f}% of the f32 peak, peak "
          f"memory {peak_mem / 2**30:.2f} GiB; launches per step "
          f"stats/epilogue/apply {[n // 7 for n in launches]}; kernels per "
          f"step (timed alone): stats {kern_ms['conv1x1_stats']:.1f} ms, "
          f"apply {kern_ms['scale_shift_act']:.1f} ms = "
          f"{sum(kern_ms.values()) / (med * 1e3) * 100:.1f}% of the step")
    profile = _profile_step(
        exe, main, feed, loss, scope, "resnet_profile.txt",
        # the port's kernels, cuDNN (its kernels carry "cudnn" or
        # "engine"), cuBLAS ("cublas" or cutlass "sgemm"), torch's own
        groups=("conv1x1_gemm_kernel", "stats_reduce_kernel",
                "scale_shift_act_kernel", "cudnn", "engine", "cublas",
                "sgemm", "elementwise", "reduce"))
    del feed
    return scope, {
        "config": c, "params": n_params, "losses": losses,
        "step_ms": [x * 1e3 for x in step_s], "step_ms_median": med * 1e3,
        "images_per_s": B / med, "tflop_per_step": flops / 1e12,
        "f32_peak_share": flops / med / peak_flops,
        "peak_mem_bytes": peak_mem, "launches_per_step": {
            k: n // 7 for k, n in zip(CONV_KERNELS, launches)},
        "kernel_ms_per_step_timed_alone": kern_ms,
        "parity": {"loss_kernels": lk, "loss_plain": lp,
                   "grad_rel_median": float(np.median(rel_k)),
                   "grad_rel_max": float(rel_k.max()),
                   "grad_rel_total": total_k,
                   "plain_f64_stats_rel_median": float(np.median(rel_p)),
                   "plain_f64_stats_rel_max": float(rel_p.max()),
                   "plain_f64_stats_rel_total": total_p,
                   "worst_ratio_to_allowance": worst[0],
                   "worst_grad": worst[1]},
        "profile": profile,
    }


def _stats_reference_f64(x2, w):
    """conv1x1_stats' plain version with its sums taken in f64: the same
    function, rounded another way."""
    import torch

    y = torch.matmul(x2, w)
    yd = y.double()
    return y, torch.stack([yd.sum(0), (yd * yd).sum(0)]).float()


def _plain_step(exe, main, feed, fetch, scope, ke, f64_stats=False):
    """One run of ``main`` with every conv-epilogue wrapper on its plain
    version (optionally with f64 statistics); it must launch nothing."""
    dispatch, stats_ref = ke._plain_device, ke.conv1x1_stats_reference
    ke._plain_device = lambda t: True
    if f64_stats:
        ke.conv1x1_stats_reference = _stats_reference_f64
    before = _conv_counts(ke)
    try:
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)
    finally:
        ke._plain_device, ke.conv1x1_stats_reference = dispatch, stats_ref
        assert _conv_counts(ke) == before, "the plain path launched a kernel"


def resnet_inference_phase(records, built, scope):
    """The for_test clone on the trained scope at batch 16: logits with
    the kernels against the plain path, then 2 warm + 10 timed batches."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import conv_epilogue as ke

    c = RESNET
    B = c["infer_batch"]
    test_prog, logits = built[2], built[4]
    exe = pt.Executor(pt.CUDAPlace())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    feed = {"images": torch.randn(B, c["size"], c["size"], 3, device="cuda",
                                  generator=gen)}
    kern, = exe.run(test_prog, feed=feed, fetch_list=[logits], scope=scope,
                    return_numpy=False)
    plain, = _plain_step(exe, test_prog, feed, [logits], scope, ke)
    assert kern.shape == (B, c["classes"]) and torch.isfinite(kern).all()
    err = float((kern - plain).abs().max())
    ref = float(plain.abs().max())
    assert err <= LOGIT_RTOL * ref, (err, ref)
    print(f"resnet inference: logits kernels vs plain max abs err {err:.3e} "
          f"of max |logit| {ref:.3e} (tol {LOGIT_RTOL} of it)")
    for _ in range(2):
        exe.run(test_prog, feed=feed, fetch_list=[logits], scope=scope)
    _reset_conv_counts(ke)
    batch_s = []
    for _ in range(10):
        t1 = time.perf_counter()
        exe.run(test_prog, feed=feed, fetch_list=[logits], scope=scope)
        batch_s.append(time.perf_counter() - t1)
    launches = _conv_counts(ke)
    assert launches == (0, 10 * FUSED_OPS, 0), launches
    med = float(np.median(batch_s))
    by_name = {r["name"]: r for r in records}
    by_name["conv1x1_epilogue"]["launches"] = launches[1] // 10
    print(f"resnet inference: batch {B} median {med * 1e3:.2f} ms over 10 "
          f"batches ({[round(x * 1e3, 2) for x in batch_s]} ms), "
          f"{B / med:.1f} images/s; conv1x1_epilogue launches per batch "
          f"{launches[1] // 10}")
    return {"batch": B, "batch_ms": [x * 1e3 for x in batch_s],
            "batch_ms_median": med * 1e3, "images_per_s": B / med,
            "logits_max_abs_err": err, "logits_max_abs": ref,
            "launches_per_batch": launches[1] // 10}


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device and found none")
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.kernels import build

    # full-f32 matrix products (PyTorch's default, stated); cuDNN's TF32
    # is left at PyTorch's default (on): the port's conv2d turns it off
    # itself, and tf32_phase checks that it does
    torch.backends.cuda.matmul.allow_tf32 = False
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
    torch.cuda.empty_cache()  # the LM phases' models are gone

    import paddle_tpu_torch as pt

    tf32 = tf32_phase()
    t0 = time.perf_counter()
    resnet = _build_resnet(pt, RESNET)
    print(f"resnet: ResNet-50 built in {time.perf_counter() - t0:.2f} s")
    conv = conv_epilogue_kernel_phase(
        gpu, _fused_shapes(resnet[0], RESNET["batch"]),
        _fused_shapes(resnet[2], RESNET["infer_batch"]))
    scope, resnet_training = resnet_training_phase(conv, gpu, resnet)
    resnet_inference = resnet_inference_phase(conv, resnet, scope)
    records = [kern] + bwd + conv

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernels": records, "serving": serving, "training": training,
         "tf32_check": tf32, "resnet_training": resnet_training,
         "resnet_inference": resnet_inference, "build_s": built}, indent=1))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
