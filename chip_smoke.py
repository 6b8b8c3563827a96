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

Prints a ``{"kernels": [...]}`` line and the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
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


def _attention_work(B, H, Tq, Tk, D, causal, lengths):
    """(matmul FLOPs, bytes) the forward needs for these inputs: 4*D per
    visible (query, key) pair; q/k/v read once, o and lse written once."""
    vis = 0
    for b in range(B):
        n = Tk if lengths is None else max(0, min(int(lengths[b]), Tk))
        if causal:
            vis += sum(min(i + 1, n) for i in range(Tq))
        else:
            vis += Tq * n
    flops = 4.0 * D * H * vis
    nbytes = 4.0 * (B * H * (2 * Tq * D + 2 * Tk * D + Tq))
    return flops, nbytes


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
    peak_flops, peak_bw = _peaks(gpu_name)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:229",
        "launches": None, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
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

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernels": [kern], "serving": serving,
         "build_s": built}, indent=1))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
