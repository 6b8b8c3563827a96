#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --forward-only    # phases 1, 2 and 3 only
    python3 chip_smoke.py --backward-only   # phases 1, 2 and 5 only
    python3 chip_smoke.py --conv-only       # phases 1, 2 and 8 only
    python3 chip_smoke.py --paged-only      # phases 1, 2 and 4b only
    python3 chip_smoke.py --amp-only        # phases 1, 2 and 11 only
    python3 chip_smoke.py --per-layer-only  # phases 1, 2 and 12 only

Phases, each fatal on failure (nonzero exit, no result line):

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi). Without CUDA it raises.
2. Build: every CUDA kernel of the port, with nvcc from the repository's
   sources (kernels/build.py), all sources started together.
3. Flash forward: the kernel against its plain PyTorch version on the
   card at the serving shape (B8 H16 T1024 D64 causal), a ragged case
   with a fully masked row, a D=128 case and the LM training shape (B8
   H8 T2048 D128 causal); at head dims the kernels take zero-padded (16,
   32, 96) and at 70400 batch*heads (past a grid's y limit), the forward
   and both backward kernels, each with a fully masked row; head dims
   past 128 (the wide instance: D160 and D256 causal with a fully masked
   row, one D512 case). Two launches at the training shape, and two at
   B2 H4 T1000 D256, must be bitwise equal. Prints the forward's
   registers, spills, shared memory and tensor-core opcodes (SASS), then
   times it at the serving, training and D256 shapes in turns with
   ``F.scaled_dot_product_attention``'s f32 forward (its backend pinned
   and recorded: kernel, library, library, kernel), with profiler device
   time beside event time, the plain version and the roofline bound.
4. Serving: the d1024/L8/H16/V16384 transformer LM (random weights from a
   seed, carried in through ``load_jax_params``) serves requests with
   700-1024-token prompts through ``GenerationEngine(kv_cache="dense")``
   and ``Server``. Checks every result, zero dispatch errors, that the
   prefill went through the flash kernel (launches == layers x
   prefills), and that the served tokens match the plain path on the
   card.
4b. Paged serving: the same LM through the paged engine (the JAX
   package's default; 8 slots, pages of 64, the default prefill chunk,
   prefix sharing) and ``Server``: 16 requests of 700-1024 prompt tokens,
   8 behind one 512-token system prompt, the last a repeat of the first,
   half greedy and half sampled (temperature 0.8, top-k 50, top-p 0.95,
   fixed seeds). Checks every result, zero dispatch errors, prefix hits
   and a copy-on-write copy, every page back in the pool, that every
   decode step was a replay of the captured CUDA graph and that none of
   the six kernels ran, greedy tokens equal to the dense engine's,
   sampled requests served alone equal to themselves, and over 32 ticks
   of a full batch the replayed step equal to the eager step (tokens and
   pools bitwise). Prints tok/s, prefill and decode-step ms (replayed,
   eager), TTFT p50, the KV pool's bytes and the step's byte floor.
5. Backward kernels: the flash dq and dkv kernels against their plain
   versions at the training shape (B8 H8 T2048 D128 causal), the serving
   shape, a ragged case with a fully masked row and the wide-head cases
   of phase 3; two launches of each at the training shape and at B2 H4
   T1000 D256 must be bitwise equal (no atomics). Prints each
   kernel's registers, spills and shared memory, then times them beside
   their plain versions and their bounds, and the pair in turns with the
   backward of ``F.scaled_dot_product_attention`` (its backend pinned
   and recorded): pair, SDPA, SDPA, pair.
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
   at ragged shapes; two launches of each GEMM kernel on the same inputs
   must be bitwise equal. Prints the GEMM kernels' registers, spills and
   shared memory and the tensor-core opcodes (HGMMA, HMMA) beside FFMA in
   their SASS (cuobjdump), then times each kernel at each of the main
   path's shapes beside the plain version, the roofline bound and a
   library yardstick (the GEMM kernels in turns with torch.matmul:
   kernel, library, library, kernel; their device time from a
   torch.profiler trace and their host time per call as well).
9. ResNet-50 training: ``models.resnet_imagenet(depth=50)`` at 224 x 224,
   1000 classes, batch 256, f32, under ``--fused_conv_epilogue``, trained
   through ``MomentumOptimizer(0.1, 0.9).minimize`` from the startup
   program's seeded weights. Checks one step's loss and gradients against
   the plain path (gradients against the plain path's own move when its
   statistics are summed in f64), 33 conv1x1_stats and 33 scale_shift_act
   launches per step, and a finite, falling loss over the timed steps on
   one fixed batch; profiles one step (``chiprun_out/resnet_profile.txt``).
10. ResNet-50 inference, eager and served: the ``clone(for_test=True)``
    program on the trained scope at batch 16 through the eager
    ``Executor`` (logits against the plain path, 33 conv1x1_epilogue
    launches per batch, 10 timed batches); then the JAX package's
    deployment path: ``io.save_inference_model(transpile=True)`` (op
    counts before and after the inference pipeline: 33 conv1x1_bn_act,
    no batch_norm left), ``InferenceEngine(model_dir, CUDAPlace(0))``
    whose ``warmup()`` captures one CUDA graph per batch bucket (1, 2, 4,
    8, 16, 32). The replay at batch 16 is held against the eager run of
    the loaded program (bitwise is the target), its plain path (kernels
    off) and the untranspiled for_test clone; one profiled replay must
    launch the conv1x1_epilogue GEMM 33 times. Times 10 replays after 2
    warm beside the eager executor, then serves a wave through ``Server``:
    64 single-image requests while one 40-row ``run`` chunks into 32 + 8
    (images/s, p50/p99 latency, batches, occupancy).
10b. Attention rewrite: a primitive matmul -> softmax -> matmul program
    (B4 H8 T512 D64, non-causal) through the inference pipeline becomes
    one ``scaled_dot_product_attention`` op, run with and without a
    ``Length`` input: each run launches the flash forward once and
    matches its plain version.

11. Mixed precision (``--use_amp``: bf16 products on f32 master weights,
    the JAX package's training dtype), each part fatal on failure:
    (a) the bf16 instances of conv1x1_stats, conv1x1_epilogue and
    scale_shift_act against their plain versions at every 1x1 shape of
    the ResNet-50 train step (batch 256) and served batch (16) and at
    ragged shapes (outputs within one bf16 ulp, statistics within 1e-5
    of each channel's summed magnitude, two launches bitwise equal),
    timed beside the plain version, the bound (bf16 tensor-core rate or
    bytes) and the library (bf16 torch.matmul, addcmul);
    (b) ResNet-50 trained under AMP at batch 256: step-1 loss against the
    same step in f32 (3e-2) and the AMP plain path (1e-2), 33 bf16
    conv1x1_stats and scale_shift_act launches per step, a falling loss,
    step ms, images/s, the share of the bf16 peak, peak memory;
    (c) its for_test clone saved, loaded and served under AMP (a CUDA
    graph at batch 16): the replay against the eager AMP run and against
    an f32 engine's graph (3e-2 of the largest |logit|, top-1 equal where
    the f32 margin is clear), 33 bf16 GEMM launches in one profiled
    replay, replayed ms, images/s and the graph's device ms;
    (d) the d1024/L8 LM trained under AMP (bf16 projections and head,
    the f32 flash kernels: one launch per layer each of the forward, dq
    and dkv): step-1 loss against f32 (3e-2), falling loss, parameters
    f32, step ms, tokens/s, the share of the bf16 peak, peak memory; then
    a paged wave under AMP whose replayed decode step equals the eager
    AMP step over 32 ticks (tokens and pools bitwise).

12. The per-layer LM (``transformer_lm(pipeline_stack=False)``, the
    model the JAX package's benchmark trains), each part fatal on
    failure: (a) the bf16 instances of the flash forward, dq and dkv
    against their plain versions at both training shapes (B8 H8 and B8
    H16, T2048 D128 causal), B8 H16 T1024 D64, a ragged T = 1000 with
    lengths and a fully masked row, a non-causal case and D 256: each of
    o, dq, dk, dv at most 2x as far from the f32 plain version on the same
    bf16 values as the bf16 plain version is, plus one bf16 ulp of the
    largest |value|, and its error's Frobenius norm at most 1.5x the bf16
    plain version's; a stale K/V stage planted in the plain version at
    the training shape must be refused; lse within 1e-4 of the plain
    version's; two launches at the training shape bitwise equal;
    registers and HMMA counts; timed at B8 H8 T2048 D128 beside the
    plain versions, the bound at the bf16 tensor-core rate and bf16 SDPA
    (forward; backward for the pair);
    (b) bench.py's ``transformer`` (d1024 L8 H8 d_ff 4096 V16384, 8 x 2048
    tokens, Adam 1e-4) in f32: step 1 with the kernels against the plain
    path (loss and every gradient within 1e-4), 8 f32 launches of each
    flash kernel a step, falling losses, step ms; then built under AMP
    with the same names from the same startup state: step-1 loss within
    3e-2 of the f32 build's and 1e-2 of the AMP plain path's, every
    gradient within 1.5e-2 of the AMP plain path's (relative, the worst
    parameter), which a stale K/V stage planted in the plain backward
    must exceed, 8 bf16 launches of each flash kernel a step and no f32
    ones, falling losses, step ms, tokens/s, the share of the bf16 peak,
    peak memory, device time by kernel
    (``chiprun_out/per_layer_*_profile.txt``); (c)
    ``transformer_wide`` (d2048 L8 H16 d_ff 8192) under AMP, the same
    gates (its f32 build runs step 1 only).

Prints a ``{"kernels": [...]}`` line and the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# f32 on both sides. The flash kernels' 3xTF32 products keep f32
# operands, but sum in another order than cuBLAS does for the plain
# version, and the tensor cores' f32 accumulation does not round to
# nearest. The forward (32-key tiles, online rescaling, each tile's P V a
# fresh sum): expect ~1e-6, ~4e-6 at T = 2048; the backward ~1e-5 at
# T = 2048. Allow 5e-5.
ATOL = RTOL = 5e-5
# Published peaks at the full power limit (NVIDIA H100 data sheet, dense):
# (f32 FLOP/s on the CUDA cores, memory bytes/s, f32-accurate FLOP/s of
# matrix products on the tensor cores as 3xTF32, i.e. the TF32 rate / 3,
# bf16 FLOP/s of the tensor cores).
PEAKS = {"sxm": (67e12, 3.35e12, 495e12 / 3, 989e12),
         "pcie": (51e12, 2.0e12, 378e12 / 3, 756e12),
         "nvl": (60e12, 3.9e12, 417.5e12 / 3, 835e12)}


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


def _host_ms(fn, iters=30):
    """Host time per call of ``fn``: the calls enqueued back to back and
    timed on the host's clock, the device's work left to run after."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host


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


def _attention_work(B, H, Tq, Tk, D, causal, lengths, elem=4):
    """(matmul FLOPs, bytes) the forward needs for these inputs: 4*D per
    visible (query, key) pair; q/k/v read once, o and lse written once
    (``elem`` bytes a value of q, k, v and o: 4 in f32, 2 in bf16; lse
    f32)."""
    flops = 4.0 * D * _visible_pairs(B, H, Tq, Tk, causal, lengths)
    nbytes = B * H * (elem * (2 * Tq * D + 2 * Tk * D) + 4.0 * Tq)
    return flops, nbytes


def _backward_work(kernel, B, H, Tq, Tk, D, causal, lengths, elem=4):
    """(matmul FLOPs, bytes) of one backward kernel for these inputs. Per
    visible pair dq does Q.K^T, dO.V^T and dS.K (6*D FLOPs) and dkv also
    P^T.dO and dS^T.Q (8*D). Both read q, dO, k, v, lse and Di once; dq
    writes dq, dkv writes dk and dv (``elem`` bytes a value of those;
    lse and Di f32)."""
    pairs = _visible_pairs(B, H, Tq, Tk, causal, lengths)
    per_pair, writes = (6, Tq * D) if kernel == "dq" else (8, 2 * Tk * D)
    nbytes = B * H * (elem * (2 * Tq * D + 2 * Tk * D + writes)
                      + 4.0 * 2 * Tq)
    return per_pair * D * pairs, nbytes


def _bound(flops, nbytes, gpu_name, products=True, bf16=False):
    """(bound ms, what bounds it, bound ms at the CUDA cores' f32 rate):
    the larger of bytes over the memory rate and FLOPs over the card's
    fastest rate for them: for matrix products (``products``) the tensor
    cores' 3xTF32 (f32 accurate), or their bf16 rate (``bf16``)."""
    peak_simt, peak_bw, peak_tc, peak_bf16 = _peaks(gpu_name)
    t_bytes = nbytes / peak_bw * 1e3
    t_ops = flops / (peak_simt if not products else peak_bf16 if bf16
                     else peak_tc) * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else
            "bytes", max(flops / peak_simt * 1e3, t_bytes))


# (B, H, T, D, causal, lengths): the serving shape first, a ragged case
# with a fully masked row (length 0), a D = 128 case and the LM training
# shape (B8 H8 T2048 D128 causal)
FWD_CASES = [
    (8, 16, 1024, 64, True, None),
    (8, 16, 1000, 64, True, [1000, 999, 700, 513, 64, 1, 0, 1000]),
    (2, 4, 300, 128, False, [300, 17]),
    (8, 8, 2048, 128, True, None),
]
# head dims the kernels take zero-padded to 64 or 128 (16, 32, 96) and
# more batch*heads than a grid's y axis holds (4400 x 16 = 70400 > 65535)
# at a small T: the forward and both backward kernels, each case with a
# fully masked row
PAD_CASES = [
    (4, 4, 300, 16, True, [300, 0, 129, 7]),
    (2, 8, 256, 32, False, [256, 0]),
    (2, 4, 300, 96, True, [300, 0]),
    (4400, 16, 24, 16, True, [24 - b % 25 for b in range(4400)]),
]

# head dims past 128, run by the wide instances (D zero-padded to a
# multiple of 64, outputs in 128-column slices on the grid's z axis):
# causal with a fully masked row at D160 and D256, and one D = 512 case.
# Phase 3 holds the forward, phase 5 dq and dkv against their plain
# versions; both check two launches bitwise equal and time D256 (WIDE_TIMED)
WIDE_CASES = [
    (2, 4, 1000, 160, True, [1000, 0]),
    (2, 4, 1000, 256, True, [1000, 0]),
    (2, 2, 300, 512, False, [300, 0]),
]
WIDE_TIMED = (2, 4, 1000, 256, True, None)
# a head dim of the wide instances, to look up their shared memory (the
# same at every D)
WIDE_D = 256


def _case_text(B, H, T, D, causal, lengths):
    lens = (lengths if lengths is None or len(lengths) <= 8 else
            f"[{len(lengths)} lengths {min(lengths)}..{max(lengths)}]")
    return f"B{B} H{H} T{T} D{D} causal={causal} lengths={lens}"


def kernel_phase(gpu_name):
    """The flash forward against its plain version at the serving and
    training shapes and the cases above, the backward kernels at the
    padded and wide-grid cases, two forward launches bitwise equal, the
    forward's ptxas and SASS counts, and its time at both shapes in turns
    with SDPA's f32 forward."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    errs, bwd_errs = [], []
    for case in FWD_CASES + PAD_CASES + WIDE_CASES:
        B, H, T, D, causal, lengths = case
        q, k, v = (randn(B, H, T, D) for _ in range(3))
        lens = None if lengths is None else torch.tensor(lengths,
                                                         device="cuda")
        o, lse = fa.flash_forward(q, k, v, lens, causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, lens, causal)
        torch.cuda.synchronize()
        err = max(_max_err(o, ro), _max_err(lse, rlse))
        errs.append(err)
        text = f"{_case_text(*case)}: max_abs_err o/lse {err:.3e}"
        masked = [b for b, n in enumerate(lengths or ()) if n == 0]
        assert not o[masked].any(), "a fully masked row got an output"
        if case in PAD_CASES:
            do = randn(B, H, T, D)
            grads = fa.flash_backward(q, k, v, o, lse, do, lens, causal)
            torch.cuda.synchronize()
            want = fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                         lens, causal)
            torch.cuda.synchronize()
            bwd = max(_max_err(a, b) for a, b in zip(grads, want))
            bwd_errs.append(bwd)
            assert masked and not any(g[masked].any() for g in grads), (
                "a fully masked row got a gradient")
            text += f", dq/dk/dv {bwd:.3e}"
            del do, grads, want
        print(f"flash_attention_fwd {text} (tol {ATOL})")
        del q, k, v, o, lse, ro, rlse

    # no atomics: two launches at the training shape agree bitwise
    B, H, T, D, causal, _ = FWD_CASES[3]
    q, k, v = (randn(B, H, T, D) for _ in range(3))
    first, second = (fa.flash_forward(q, k, v, None, True) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second)), (
        "two flash forward launches on the same inputs differ")
    print(f"flash_attention_fwd B{B} H{H} T{T} D{D} causal: two launches "
          f"are bitwise equal")
    del q, k, v, first, second
    B, H, T, D, causal, _ = WIDE_TIMED
    q, k, v = (randn(B, H, T, D) for _ in range(3))
    first, second = (fa.flash_forward(q, k, v, None, True) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second)), (
        "two wide flash forward launches on the same inputs differ")
    print(f"flash_attention_fwd (wide) B{B} H{H} T{T} D{D} causal: two "
          f"launches are bitwise equal")
    del q, k, v, first, second
    usage = _forward_kernel_usage()
    assert not any(u.get("spill_store_bytes") or u.get("spill_load_bytes")
                   for u in usage.values()), f"the forward spills: {usage}"
    sass = _sass_counts("flash_attention_fwd", "flash_fwd")
    for key, counts in sass.items():
        if "wide" in key:  # the wide instance's products are f32 FMA
            assert counts["FFMA"] > 0, f"{key} has no FFMA: {counts}"
            continue
        assert counts["HMMA"] + counts["HGMMA"] > 0, (
            f"{key} runs no product on the tensor cores: {counts}")

    timed = {name: _time_forward(F, fa, randn, gpu_name, *FWD_CASES[i])
             for name, i in (("serving", 0), ("training", 3))}
    timed["wide"] = _time_forward(F, fa, randn, gpu_name, *WIDE_TIMED)
    serve = timed["serving"]
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:229",
        "launches": None, "max_abs_err": max(errs),
        "max_abs_err_backward_padded": max(bwd_errs),
        "ms": serve["ms"], "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "bound_ms_simt": serve["bound_ms_simt"],
        "library_ms": serve["library_ms"], "library": serve["library"],
        "shape": serve["shape"], "gflop": serve["gflop"],
        "mbytes": serve["mbytes"], "training_shape": timed["training"],
        "serving_shape": serve, "wide_shape": timed["wide"],
        "ptxas": usage, "sass": sass,
    }


def _time_forward(F, fa, randn, gpu_name, B, H, T, D, causal, lengths):
    """The forward kernel at one shape in turns with SDPA's f32 forward
    (its backend pinned: kernel, library, library, kernel), each with its
    device time from a profiler trace, beside the plain version and the
    bound."""
    import torch
    from torch.nn.attention import sdpa_kernel

    assert lengths is None and causal
    q, k, v = (randn(B, H, T, D) for _ in range(3))

    def kernel():
        return fa.flash_forward(q, k, v, None, True)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    backend = _sdpa_backend(library)
    with sdpa_kernel(backend):
        turns = [_cuda_ms(kernel, iters=10)]
        turns += [_cuda_ms(library, iters=10) for _ in range(2)]
        turns.append(_cuda_ms(kernel, iters=10))
        lib_device = _device_ms(library)
    device = _device_ms(kernel)
    plain_ms = _cuda_ms(
        lambda: fa.flash_attention_reference(q, k, v, None, True), iters=5)
    flops, nbytes = _attention_work(B, H, T, T, D, True, None)
    bound_ms, bound_by, bound_simt = _bound(flops, nbytes, gpu_name)
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    shape = f"B{B} H{H} T{T} D{D} causal f32"
    print(f"flash_attention_fwd timing {shape}: kernel "
          f"{[round(x, 4) for x in turns[::3]]} ms (device "
          f"{_ms_text(device, '.4f')}), SDPA forward ({backend.name}) "
          f"{[round(x, 4) for x in turns[1:3]]} ms (device "
          f"{_ms_text(lib_device, '.4f')}): kernel / SDPA "
          f"{ms / lib_ms:.3f}; plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}), {flops / ms / 1e9:.1f} TFLOP/s")
    return {"shape": shape, "ms": ms, "turns_ms": turns,
            "device_ms": device, "library_ms": lib_ms,
            "library_device_ms": lib_device,
            "library": f"sdpa forward, {backend.name}", "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_simt": bound_simt, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, "tflop_per_s": flops / ms / 1e9}


def _forward_kernel_usage():
    from paddle_tpu_torch.kernels import build

    lib = build.load("flash_attention_fwd")
    smem = lib.paddle_flash_attention_fwd_smem_bytes
    return _kernel_usage("flash_attention_fwd",
                         lambda name, args: smem(args[0] if args else WIDE_D),
                         match="flash_fwd")


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


# The paged serving configuration: phase 4's LM at full width, 8 slots,
# a context of max_len 2048, pages of 64 tokens, the default
# prefill_chunk (128), prefix sharing on. Traffic: 16 requests of
# 700-1024 prompt tokens, 8 of them behind one shared 512-token system
# prompt (8 pages), the last one a repeat of the first (a full-prefix hit:
# copy-on-write), 32-128 new tokens, half greedy and half sampled with
# fixed seeds.
PAGED = dict(slots=8, page_size=64)
PAGED_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
PAGED_TICKS = 32  # full-batch ticks where the replayed step meets eager


def _drive(engine, requests):
    """Admit into free slots as they open and tick until every request
    is done (any engine; the paged one streams prefill chunks)."""
    pending = list(requests)
    paged = hasattr(engine, "prefill_tick")
    while pending or engine.active or (paged and engine._deferred):
        k = min(len(pending), engine.free_slots)
        if k:
            engine.admit(pending[:k])
            pending = pending[k:]
        if paged:
            engine.prefill_tick()
        engine.decode_tick()
    return [r.future.result(timeout=1) for r in requests]


def _paged_traffic(vocab):
    """(prompts, horizons, per-request sampling meta) of the paged wave;
    request 15 repeats request 0."""
    import numpy as np

    rng = np.random.RandomState(SEED + 7)
    system = rng.randint(0, vocab, 512)
    prompts, metas = [], []
    for i in range(15):
        n = int(rng.randint(700, 1025))
        prompts.append(np.concatenate([system, rng.randint(0, vocab, n - 512)])
                       if i % 2 == 0 else rng.randint(0, vocab, n))
        # sampled: 1, 2, 5, 6, 9, 10, 13, 14; greedy: the rest and 15
        metas.append(dict(PAGED_SAMPLING, seed=1000 + i)
                     if i % 4 in (1, 2) else {})
    prompts = [p.astype(np.int64) for p in prompts] + [prompts[0]]
    horizons = [int(h) for h in rng.randint(32, 129, 15)]
    return prompts, horizons + [horizons[0]], metas + [{}]


def _replay_against_eager(eng, spec, vocab, peak_bw,
                          profile_path="paged_decode_profile.txt"):
    """A full batch decoding for PAGED_TICKS ticks; each tick runs the
    eager step from a saved copy of the pools, then the replayed step from
    the same pools: equal tokens and bitwise-equal pools (every row decodes
    at its own (page, row), so no write order is left to the card).
    Returns the two steps' host times, the replay's device time and the
    step's byte floor."""
    import numpy as np
    import torch

    from paddle_tpu_torch.serving import Request

    rng = np.random.RandomState(SEED + 8)
    reqs = [Request({"prompt": rng.randint(0, vocab, int(rng.randint(
        700, 1025))).astype(np.int64)}, dict(
            {"max_new_tokens": PAGED_TICKS + 8},
            **(dict(PAGED_SAMPLING, seed=2000 + i) if i % 2 else {})), None)
        for i in range(eng.slots)]
    assert eng.admit(reqs) == eng.slots
    while eng.prefilling:
        eng.prefill_tick()
    weights = 4.0 * sum(p.numel() for n, p in eng.model.named_parameters()
                        if n not in ("tok_emb", "pos_emb"))
    kv_token = 2.0 * spec.n_layers * spec.kv_heads * spec.head_dim * 4
    replay_ms, eager_ms, kv_bytes = [], [], []
    for _ in range(PAGED_TICKS):
        decoding = [s for s in range(eng.slots) if eng._slots[s] is not None
                    and eng._slots[s].state == "decode"]
        assert len(decoding) == eng.slots, "the batch is not full"
        eng._cow_guard(decoding)
        feed = eng._decode_feed()
        kv_bytes.append(kv_token * float(sum(feed["pos"] + 1)))
        k0, v0 = eng.cache_k.clone(), eng.cache_v.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = eng._decode_step_eager(feed)
        t1 = time.perf_counter()
        ke, ve = eng.cache_k.clone(), eng.cache_v.clone()
        eng.cache_k.copy_(k0)
        eng.cache_v.copy_(v0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        replayed = eng._decode_step_replay(feed)
        t3 = time.perf_counter()
        eager_ms.append((t1 - t0) * 1e3)
        replay_ms.append((t3 - t2) * 1e3)
        assert np.array_equal(replayed, eager), (replayed, eager)
        assert torch.equal(eng.cache_k, ke) and torch.equal(eng.cache_v, ve), (
            "the replayed step's pools differ from the eager step's")
        for slot in decoding:
            eng._pos[slot] += 1
            eng._tok[slot] = replayed[slot]
            eng._emit(slot, int(replayed[slot]))
        del k0, v0, ke, ve
    # the captured step alone on the card (its inputs unchanged: the
    # replays rewrite the same K/V rows and pick the same tokens), and
    # its kernels by name
    device_ms = _cuda_ms(eng._graph.replay, iters=20)
    profile = _profile_step(
        eng._graph.replay, profile_path,
        # the page gathers (advanced indexing), cuBLAS, the sampler's
        # sorts, torch's other kernels
        groups=("index", "gemm", "gemv", "sort", "softmax", "reduce",
                "elementwise"))
    while eng.active:
        eng.decode_tick()
    for r in reqs:
        assert r.future.result(timeout=1).size > 0
    floor = (weights + float(np.mean(kv_bytes))) / peak_bw * 1e3
    return {"ticks": PAGED_TICKS, "replay_ms": replay_ms,
            "eager_ms": eager_ms,
            "replay_ms_median": float(np.median(replay_ms)),
            "eager_ms_median": float(np.median(eager_ms)),
            "replay_device_ms": device_ms, "replay_profile": profile,
            "weight_bytes": weights,
            "kv_in_flight_bytes_mean": float(np.mean(kv_bytes)),
            "step_floor_ms": floor, "tokens_and_pools_equal": True}


def paged_serving_phase(gpu_name):
    """Phase 4b: the paged engine (the JAX package's default) at full
    width through Server, every check of the issue fatal."""
    import numpy as np
    import torch

    from paddle_tpu_torch import init_params
    from paddle_tpu_torch.decoding import SamplingParams
    from paddle_tpu_torch.kernels import conv_epilogue as ke
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import TransformerLM
    from paddle_tpu_torch.serving import (GenerationEngine, LMSpec,
                                          PagedGenerationEngine, Request,
                                          Server)

    peak_bw = _peaks(gpu_name)[1]
    spec = LMSpec(vocab_size=16384, d_model=1024, n_layers=8, num_heads=16,
                  max_len=2048)
    t0 = time.perf_counter()
    model = TransformerLM(spec, device="cuda")
    model.load_jax_params(init_params(spec, SEED))
    eng = GenerationEngine(spec, model, device="cuda", **PAGED)
    assert isinstance(eng, PagedGenerationEngine), type(eng)
    t1 = time.perf_counter()
    combos = eng.warmup()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    assert eng.cache_stats()["decode_graph_captures"] == 1
    print(f"paged: weights {t1 - t0:.2f} s, warmup {combos} shapes and the "
          f"decode graph's capture {t2 - t1:.2f} s; pool {eng.n_pages} pages "
          f"of {eng.page_size}, table width {eng.pmax}, prefill_chunk "
          f"{eng.prefill_chunk}")

    prompts, horizons, metas = _paged_traffic(spec.vocab_size)
    # the six kernels' counts: the paged path runs none of them
    _reset_launch_counts(fa)
    _reset_conv_counts(ke)
    replays0 = eng.metrics.counter("decode_graph_replays")
    srv = Server([eng]).start()
    try:
        t3 = time.perf_counter()
        futs = [srv.submit({"prompt": p}, max_new_tokens=h, **m)
                for p, h, m in zip(prompts[:15], horizons[:15], metas[:15])]
        first = futs[0].result(timeout=600)  # cached whole, tail included
        futs.append(srv.submit({"prompt": prompts[15]},
                               max_new_tokens=horizons[15], **metas[15]))
        results = [first] + [f.result(timeout=600) for f in futs[1:]]
        t4 = time.perf_counter()
    finally:
        srv.stop()
    launches = _launch_counts(fa) + _conv_counts(ke)
    snap = srv.metrics_snapshot()
    counters = snap["counters"]
    replays = eng.metrics.counter("decode_graph_replays") - replays0
    for p, h, r in zip(prompts, horizons, results):
        assert r.shape == (p.size + h,), (r.shape, p.size, h)
        assert np.array_equal(r[:p.size], p)
        assert ((r >= 0) & (r < spec.vocab_size)).all()
    assert counters.get("dispatch_errors", 0) == 0, counters
    assert counters["completed"] == len(prompts), counters
    assert counters.get("bad_requests", 0) == 0, counters
    assert counters["prefix_hit_tokens"] > 0, counters
    assert counters["kv_cow_copies"] >= 1, counters
    assert np.array_equal(results[15], results[0]), "the repeat differs"
    assert not any(launches), f"the paged path launched a kernel: {launches}"
    assert replays == counters["decode_steps"] > 0, (replays, counters)
    stats = eng.pool.stats()
    assert eng.pool.pages_in_use() == len(eng.prefix_index), stats
    assert stats["shared"] == 0 and stats["reserved"] == 0, stats
    eng.prefix_index.clear()
    assert eng.pool.pages_in_use() == 0, eng.pool.stats()
    print(f"paged: 16 requests served; prefix hits {counters['prefix_hits']} "
          f"({counters['prefix_hit_tokens']} tokens), copy-on-write copies "
          f"{counters['kv_cow_copies']}, every page back in the pool; "
          f"{replays} decode steps, all replayed; the six kernels "
          f"launched {sum(launches)} times")

    lat = snap["latency"]
    gen_tokens = sum(horizons)
    wave = {
        "requests": len(prompts),
        "prompt_tokens": int(sum(p.size for p in prompts)),
        "generated_tokens": gen_tokens, "wall_s": t4 - t3,
        "tokens_per_s": gen_tokens / (t4 - t3),
        "prefills": counters["prefills"],
        "prefill_chunks": counters.get("prefill_chunks", 0),
        # every prompt is longer than a chunk: it streams in chunks, and
        # no group prefill (the "prefill" latency) runs
        "prefill_ms_mean": lat.get("prefill_ms", {}).get("mean"),
        "prefill_chunk_ms_mean": lat["prefill_chunk_ms"]["mean"],
        "prefill_chunk_ms_p50": lat["prefill_chunk_ms"]["p50"],
        "decode_step_ms_mean": lat["decode_step_ms"]["mean"],
        "decode_step_ms_p50": lat["decode_step_ms"]["p50"],
        "decode_steps": counters["decode_steps"],
        "ttft_ms_p50": snap["hist"]["ttft"]["p50_ms"],
        "prefix_hit_tokens": counters["prefix_hit_tokens"],
        "kv_cow_copies": counters["kv_cow_copies"],
        "kv_pool_bytes": 2.0 * eng.cache_k.numel() * 4,
        "warmup_s": t2 - t1,
    }

    # greedy requests against the dense engine on the card
    greedy = [i for i, m in enumerate(metas) if not m]
    dense = GenerationEngine(spec, model, slots=8, kv_cache="dense",
                             device="cuda")
    want = _drive(dense, [Request({"prompt": prompts[i]},
                                  {"max_new_tokens": horizons[i]}, None)
                          for i in greedy])
    for i, w in zip(greedy, want):
        assert np.array_equal(results[i], w), f"greedy request {i} differs"
    del dense
    # each sampled request alone on a fresh engine: the same tokens
    solo = GenerationEngine(spec, model, device="cuda", **PAGED)
    sampled = [i for i, m in enumerate(metas) if m]
    for i in sampled:
        alone = solo.generate_all([prompts[i]], max_new_tokens=horizons[i],
                                  sampling=SamplingParams(**metas[i]))[0]
        assert np.array_equal(alone, results[i]), f"sampled {i} differs alone"
    del solo
    print(f"paged: greedy requests {greedy} equal the dense engine's tokens; "
          f"sampled requests {sampled} served alone give their tokens")

    step = _replay_against_eager(eng, spec, spec.vocab_size, peak_bw)
    torch.cuda.empty_cache()
    wave["decode_step"] = step
    print(f"paged: {wave['requests']} requests, {wave['prompt_tokens']} "
          f"prompt tokens, {gen_tokens} generated in {t4 - t3:.3f} s = "
          f"{wave['tokens_per_s']:.1f} tok/s; prefill chunk mean "
          f"{wave['prefill_chunk_ms_mean']:.2f} ms over "
          f"{wave['prefill_chunks']} chunks; decode step mean "
          f"{wave['decode_step_ms_mean']:.3f} ms (replayed) over "
          f"{wave['decode_steps']} steps; TTFT p50 "
          f"{wave['ttft_ms_p50']:.1f} ms; KV pool "
          f"{wave['kv_pool_bytes'] / 2**30:.2f} GiB")
    print(f"paged: full batch over {PAGED_TICKS} ticks, replayed = eager "
          f"(tokens and pools bitwise): step replayed "
          f"{step['replay_ms_median']:.3f} ms median (device "
          f"{step['replay_device_ms']:.3f}), eager "
          f"{step['eager_ms_median']:.3f} ms median; byte floor "
          f"{step['step_floor_ms']:.3f} ms (weights "
          f"{step['weight_bytes'] / 1e9:.3f} GB + KV in flight "
          f"{step['kv_in_flight_bytes_mean'] / 1e9:.3f} GB)")
    return wave


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
# attention's summation order (tiles and tensor-core chains vs cuBLAS),
# which moves each gradient by ~2e-6 of its norm after 8 layers; allow
# 1e-4 of the norm per parameter and 1e-5 relative on the loss.
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
    for B, H, T, D, causal, lengths in BWD_CASES + WIDE_CASES:
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
    kernels = {"dq": lambda: (fa.flash_dq(q, k, v, lse, di, do, None,
                                          causal),),
               "dkv": lambda: fa.flash_dkv(q, k, v, lse, di, do, None,
                                           causal)}
    # no float atomics: two launches on the same inputs agree bitwise
    for name, fn in kernels.items():
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (
            f"two {name} launches on the same inputs differ")
        del first, second
    print(f"flash_attention_bwd B{B} H{H} T{T} D{D} causal: two launches of "
          f"each kernel are bitwise equal")
    wide = _time_wide_backward(F, fa, randn, gpu_name, *WIDE_TIMED)
    usage = _backward_kernel_usage()
    ms = {name: _cuda_ms(fn, iters=10) for name, fn in kernels.items()}
    plain_ms = {
        "dq": _cuda_ms(lambda: fa.flash_dq_reference(q, k, v, lse, di, do,
                                                     None, causal), iters=5),
        "dkv": _cuda_ms(lambda: fa.flash_dkv_reference(q, k, v, lse, di, do,
                                                       None, causal),
                        iters=5)}
    fwd_ms = _cuda_ms(lambda: fa.flash_forward(q, k, v, None, causal),
                      iters=10)

    # the pair against SDPA's backward in turns: kernels, library,
    # library, kernels
    def pair():
        kernels["dq"]()
        kernels["dkv"]()

    pair_turns, lib_turns = [_cuda_ms(pair, iters=10)], []
    for _ in range(2):
        lib, backend = _sdpa_backward_ms(F, q, k, v, do)
        lib_turns.append(lib)
    pair_turns.append(_cuda_ms(pair, iters=10))
    pair_ms = sum(pair_turns) / 2
    library_ms = sum(lib_turns) / 2
    print(f"flash_attention_bwd timing B{B} H{H} T{T} D{D} causal: dq "
          f"{ms['dq']:.3f} ms (plain {plain_ms['dq']:.3f}), dkv "
          f"{ms['dkv']:.3f} ms (plain {plain_ms['dkv']:.3f}), forward "
          f"{fwd_ms:.3f} ms; in turns, the pair "
          f"{[round(x, 3) for x in pair_turns]} ms and SDPA backward "
          f"({backend}) {[round(x, 3) for x in lib_turns]} ms: pair / SDPA "
          f"{pair_ms / library_ms:.3f}")
    records = []
    for name, line in (("dq", 364), ("dkv", 386)):
        flops, nbytes = _backward_work(name, B, H, T, T, D, causal, None)
        bound_ms, bound_by, bound_simt = _bound(flops, nbytes, gpu_name)
        records.append({
            "name": f"flash_attention_bwd_{name}", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "launches": None, "max_abs_err": max(errs[name]),
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_simt": bound_simt,
            # SDPA's backward computes dq, dk and dv in one call: it is
            # the yardstick for the two kernels together
            "library_ms": library_ms, "library": f"sdpa backward, {backend}",
            "pair_ms": pair_ms, "pair_over_sdpa": pair_ms / library_ms,
            "pair_turns_ms": pair_turns, "library_turns_ms": lib_turns,
            "shape": f"B{B} H{H} T{T} D{D} causal f32",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "fwd_ms_training_shape": fwd_ms, "ptxas": usage,
            "wide_shape": wide[name],
        })
    return records


def _time_wide_backward(F, fa, randn, gpu_name, B, H, T, D, causal, lengths):
    """The wide dq and dkv instances at one shape: two launches of each
    bitwise equal, then each timed beside its plain version and its bound,
    and SDPA's backward (its backend pinned) for the pair."""
    import torch

    assert lengths is None and causal
    q, k, v, do = (randn(B, H, T, D) for _ in range(4))
    o, lse = fa.flash_forward(q, k, v, None, True)
    di = (do * o).sum(-1)
    kernels = {"dq": lambda: (fa.flash_dq(q, k, v, lse, di, do, None,
                                          True),),
               "dkv": lambda: fa.flash_dkv(q, k, v, lse, di, do, None, True)}
    plain = {"dq": lambda: fa.flash_dq_reference(q, k, v, lse, di, do, None,
                                                 True),
             "dkv": lambda: fa.flash_dkv_reference(q, k, v, lse, di, do,
                                                   None, True)}
    for name, fn in kernels.items():
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (
            f"two wide {name} launches on the same inputs differ")
        del first, second
    library_ms, backend = _sdpa_backward_ms(F, q, k, v, do)
    shape = f"B{B} H{H} T{T} D{D} causal f32"
    out = {}
    for name, fn in kernels.items():
        ms = _cuda_ms(fn, iters=10)
        plain_ms = _cuda_ms(plain[name], iters=5)
        flops, nbytes = _backward_work(name, B, H, T, T, D, True, None)
        bound_ms, bound_by, bound_simt = _bound(flops, nbytes, gpu_name)
        out[name] = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_ms_simt": bound_simt,
                     "library_ms": library_ms,
                     "library": f"sdpa backward, {backend}",
                     "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        print(f"flash_attention_bwd_{name} (wide) {shape}: two launches "
              f"bitwise equal; {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {bound_simt:.4f} at the "
              f"CUDA cores' f32 rate)")
    print(f"flash_attention_bwd (wide) {shape}: SDPA backward ({backend}) "
          f"{library_ms:.3f} ms for the pair")
    return out


def _kernel_key(mangled):
    """``name<template args>`` of a mangled kernel name of the port's
    sources (``..._cu_<hash><length><name>I<args>E...``)."""
    import re

    found = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)", mangled)
    if not found:
        return mangled
    n = int(found.group(1))
    name, rest = found.group(2)[:n], found.group(2)[n:]
    args = re.findall(r"L[ib](\d+)", rest.split("EE")[0]) if rest.startswith(
        "I") else []
    return f"{name}<{','.join(args)}>" if args else name


def _kernel_usage(lib_name, dynamic_smem, match):
    """Registers and spills (ptxas, from the build log) and dynamic shared
    memory (``dynamic_smem(name, args)``, None where the kernel takes
    none) of each kernel instantiation of library ``lib_name`` whose name
    contains ``match``."""
    import re

    from paddle_tpu_torch.kernels import build

    usage, current = {}, None
    for line in build.log_path(lib_name).read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            key = _kernel_key(entry.group(1))
            current = None
            if match in key:
                name, _, args = key.partition("<")
                args = [int(a) for a in args.rstrip(">").split(",") if a]
                current = usage.setdefault(key, {
                    "dynamic_smem_bytes": dynamic_smem(name, args)})
            continue
        if current is None:
            continue
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("spill_store_bytes", r"(\d+) bytes spill st"),
                             ("spill_load_bytes", r"(\d+) bytes spill lo")):
            found = re.search(pattern, line)
            if found:
                current[key] = int(found.group(1))
    for name, u in usage.items():
        print(f"ptxas {name}: {u.get('registers')} registers, spills "
              f"{u.get('spill_store_bytes')} bytes stored / "
              f"{u.get('spill_load_bytes')} loaded, "
              f"{u['dynamic_smem_bytes']} bytes of dynamic shared memory")
    return usage


def _backward_kernel_usage():
    from paddle_tpu_torch.kernels import build

    lib = build.load("flash_attention_bwd")
    smem = lib.paddle_flash_attention_bwd_smem_bytes
    return _kernel_usage(
        "flash_attention_bwd",
        lambda name, args: smem("dkv" in name, args[0] if args else WIDE_D),
        match="flash_bwd")


def _sass_counts(lib_name, match):
    """Opcode counts (cuobjdump -sass) of each kernel of library
    ``lib_name`` whose name contains ``match``: HGMMA is wgmma on the
    tensor cores, HMMA mma.sync, FFMA an f32 FMA on the CUDA cores."""
    import re

    from paddle_tpu_torch.kernels import build

    ops = ("HGMMA", "HMMA", "FFMA")
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path(lib_name))],
                          check=True, capture_output=True, text=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            key = _kernel_key(fn.group(1))
            current = (counts.setdefault(key, dict.fromkeys(ops, 0))
                       if match in key else None)
            continue
        op = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                       line)
        if current is not None and op and op.group(1) in current:
            current[op.group(1)] += 1
    for key, c in counts.items():
        print(f"sass {key}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    return counts


def _device_ms(fn, iters=10):
    """Device time per call of ``fn``: the time its kernels ran in a
    torch.profiler trace of ``iters`` calls (CUPTI), without the host's
    gaps between them; None where the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without kernels
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
                total = sum(getattr(e, "self_device_time_total", 0)
                            for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA)
        except Exception as exc:  # noqa: BLE001 - a measurement aid
            print(f"device time: not measured ({type(exc).__name__}: {exc})")
            return None
        if total:
            return total / 1e3 / iters
    print("device time: not measured (three traces held no device time)")
    return None


def _ms_text(ms, spec=".3f"):
    """A measured time as text, or "not measured" where it is None."""
    return "not measured" if ms is None else format(ms, spec)


def _sdpa_backend(run):
    """The first SDPA backend (flash, memory-efficient, cuDNN, math) that
    runs ``run`` on its f32 inputs."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
             "MATH")
    for backend in (getattr(SDPBackend, n) for n in names
                    if hasattr(SDPBackend, n)):
        try:  # a backend that refuses f32 warns, then raises
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                run()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        return backend
    raise RuntimeError("no SDPA backend ran f32 attention")


def _sdpa_backward_ms(F, q, k, v, do):
    """(ms, backend) of the backward of F.scaled_dot_product_attention
    (is_causal) on these inputs: forward + backward minus the forward
    alone, with the backend pinned to the first that takes f32."""
    import torch
    from torch.nn.attention import sdpa_kernel

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, do)

    backend = _sdpa_backend(fwd_bwd)
    with sdpa_kernel(backend):
        total = _cuda_ms(fwd_bwd, iters=10)
        forward = _cuda_ms(fwd, iters=10)
    return total - forward, backend.name


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


def _build_training_program(pt, c, pipeline_stack=True):
    from paddle_tpu_torch import layers, models

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        ids = layers.data("ids", shape=[c["seq"]], dtype="int64")
        tgt = layers.data("tgt", shape=[c["seq"]], dtype="int64")
        logits = models.transformer_lm(
            ids, vocab_size=c["vocab"], d_model=c["d_model"],
            n_layers=c["n_layers"], num_heads=c["num_heads"],
            d_ff=c["d_ff"], max_len=c["max_len"],
            pipeline_stack=pipeline_stack)
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


def _flash_counts(fa):
    """(f32 fwd, dq, dkv launches, bf16 fwd, dq, dkv launches)."""
    return _launch_counts(fa) + (fa.flash_attention.bf16_launches,
                                 fa.flash_backward.dq_bf16_launches,
                                 fa.flash_backward.dkv_bf16_launches)


def _reset_flash_counts(fa):
    _reset_launch_counts(fa)
    fa.flash_attention.bf16_launches = 0
    fa.flash_backward.dq_bf16_launches = 0
    fa.flash_backward.dkv_bf16_launches = 0


def _snapshot(scope):
    import torch

    return {n: scope.get(n).clone() for n in list(scope.keys())
            if isinstance(scope.get(n), torch.Tensor)}


def _restore(scope, state, dtypes=None):
    """The scope's tensors from ``state``, each in ``dtypes[name]`` where
    given (an AMP program's declared dtype)."""
    for n, t in state.items():
        dt = (dtypes or {}).get(n)
        scope.set(n, t.to(dt) if dt is not None else t.clone())


def _stale_stage(t, tile=64):
    """``t`` [B, H, T, D] with the middle 64-key tile holding the tile
    before it: what a kernel whose K/V ring hands a tile a stale stage
    computes. A planted fault for the gates' controls."""
    j = t.shape[2] // tile // 2
    out = t.clone()
    out[:, :, j * tile:(j + 1) * tile] = t[:, :, (j - 1) * tile:j * tile]
    return out


@contextlib.contextmanager
def _plain_flash(fa, planted=False):
    """The flash wrappers run their plain versions on the card (every
    wrapper dispatches through _plain_device, so answering yes for CUDA
    tensors swaps them in); with ``planted`` the plain backward reads a
    stale K/V stage (_stale_stage). No kernel may launch meanwhile."""
    saved = fa._plain_device, fa.flash_attention_backward_reference
    before = _flash_counts(fa)
    fa._plain_device = lambda t: True
    if planted:
        fa.flash_attention_backward_reference = (
            lambda q, k, v, *rest: saved[1](q, _stale_stage(k),
                                            _stale_stage(v), *rest))
    try:
        yield
    finally:
        fa._plain_device, fa.flash_attention_backward_reference = saved
    assert _flash_counts(fa) == before, "the plain path launched a kernel"


def _step_fetches(exe, main, feed, fetch, scope, state, dtypes=None):
    """One step's fetches (tensors) from ``state``; the scope is put back
    to ``state`` after it."""
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                  return_numpy=False)
    _restore(scope, state, dtypes)
    return out


def _grad_gap(names, got, want):
    """(worst |got - want| / |want| over the gradients, its name); every
    gradient of ``got`` finite."""
    worst = (-1.0, "")
    for name, g, w in zip(names, got, want):
        assert g.isfinite().all(), name
        g, w = g.float(), w.float()
        worst = max(worst, (float((g - w).norm() / w.norm().clamp_min(1e-30)),
                            name))
    return worst


def _timed_steps(exe, main, feed, loss, scope, fa, profile_path, groups):
    """The main path: counts to 0, 1 warm + 6 timed steps on one batch,
    counts read (``_flash_counts``), losses finite and falling; then one
    step profiled into ``profile_path`` by kernel ``groups``. Returns
    (losses, step seconds, counts, peak memory, profile)."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts(fa)
    losses, step_s = [], []
    for _ in range(7):
        t1 = time.perf_counter()
        lo, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        step_s.append(time.perf_counter() - t1)
        losses.append(float(lo))
    counts = _flash_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    profile = _profile_step(
        lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope),
        profile_path, groups=groups)
    return losses, step_s, counts, peak, profile


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
    state = _snapshot(scope)

    # parity on the card: one step's loss and every gradient, with the
    # kernels and then with their plain versions, from the same state
    grad_names = [g.name for _, g in params_grads]
    fetch = [loss.name] + grad_names
    kern = _step_fetches(exe, main, feed, fetch, scope, state)
    with _plain_flash(fa):
        plain = _step_fetches(exe, main, feed, fetch, scope, state)
    del state
    lk, lp = float(kern[0]), float(plain[0])
    assert np.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp), (lk, lp)
    worst = _grad_gap(grad_names, kern[1:], plain[1:])
    assert worst[0] <= GRAD_RTOL, worst
    print(f"training: step loss kernels {lk:.6f} plain {lp:.6f}; worst "
          f"gradient |kernel - plain| / |plain| {worst[0]:.3e} ({worst[1]}) "
          f"over {len(grad_names)} parameters (tol {GRAD_RTOL})")
    del kern, plain

    # the main path: 1 warm step, then 6 timed steps on one fixed batch
    losses, step_s, counts, peak_mem, profile = _timed_steps(
        exe, main, feed, loss, scope, fa, "train_profile.txt",
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    assert counts == (7 * L,) * 3 + (0,) * 3, counts
    launches = counts[:3]
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


def _profile_step(run, path="train_profile.txt",
                  groups=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
    """Device time of one step (``run()``) by kernel, from torch.profiler
    (CUPTI), summed per group of kernel names (``groups``: substrings) and
    written to ``chiprun_out/<path>``; a measurement aid, not a check:
    without device times it says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
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
# Phase 10's served path: the JAX InferenceEngine's default buckets, and
# a wave of single-image requests beside one batch that chunks.
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
WAVE_SINGLES, WAVE_RUN = 64, 40
# The transpiled model (BN folded into the 3x3 and 7x7 filters) against
# the untranspiled for_test clone: folding rounds differently. Measured on
# the CPU at ResNet-50's depth (64 x 64 images, batch 2, seeded startup):
# 1.1e-6 of the largest |logit|; allow 1e-4 of it, as for the kernels.
TRANSPILE_RTOL = 1e-4
# A replay against the eager run of the same loaded program: the same
# kernels on the same inputs. Bitwise is the target; allow 1e-6 of the
# largest |logit| (deterministic kernels, cuDNN's choice of algorithm).
REPLAY_RTOL = 1e-6
ATTN = dict(B=4, H=8, T=512, D=64)
# Kernel against plain version, f32 on both sides:
# - GEMM outputs (y of conv1x1_stats, conv1x1_epilogue's out): K <= 2048
#   products as 3xTF32 on the tensor cores (f32-accurate operands), each
#   32-deep stage summed in the tensor cores' f32 accumulation (which
#   truncates) and the stages added in f32, against cuBLAS's order;
#   ~1e-5 at K = 2048, allow 1e-4 absolute and relative.
# - statistics: per-channel sums over up to 802816 rows, in another order
#   (2 rows a thread, a shuffle tree over 8 lanes, 8 warps, 128-row tiles
#   in a fixed order) than torch.sum; rounding grows with the summed mass,
#   so the error of each channel's sum (sum of squares) is held to 1e-5 of
#   sum |y| (sum y^2): a dropped 128-row tile is 1.6e-4 of the mass at the
#   largest R.
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

    # ragged: tiles cut by R and O, a K of 72 (a partial stage) and one
    # of 30 (I % 4 != 0: the kernels' generic copies) with an odd O
    ragged = [(R, I, O, res, act) for R, I, O in ((100, 32, 16),
                                                  (1000, 72, 40),
                                                  (257, 30, 9))
              for res, act in ((False, None), (True, "relu"))]
    errs = {k: 0.0 for k in CONV_KERNELS}
    stats_err = 0.0
    repeat_ok = 0  # cases where two launches agreed bitwise
    for R, I, O, res, act in sorted(set(train_shapes) | set(ragged)):
        x, w, scale, shift, r = inputs(R, I, O, res)
        y, stats = ke.conv1x1_stats(x, w)
        y2, stats2 = ke.conv1x1_stats(x, w)
        torch.cuda.synchronize()
        assert torch.equal(y, y2) and torch.equal(stats, stats2), (
            f"two conv1x1_stats launches differ at {R}x{I}x{O}")
        repeat_ok += 1
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
        del x, w, r, y, y2, ry, out
    for R, I, O, res, act in sorted(set(infer_shapes) | set(ragged)):
        x, w, scale, shift, r = inputs(R, I, O, res)
        out = ke.conv1x1_epilogue(x, w, scale, shift, r, act)
        out2 = ke.conv1x1_epilogue(x, w, scale, shift, r, act)
        torch.cuda.synchronize()
        assert torch.equal(out, out2), (
            f"two conv1x1_epilogue launches differ at {R}x{I}x{O}")
        repeat_ok += 1
        err = _assert_close(
            out, ke.conv1x1_epilogue_reference(x, w, scale, shift, r, act),
            GEMM_TOL, f"conv1x1_epilogue {R}x{I}x{O}")
        errs["conv1x1_epilogue"] = max(errs["conv1x1_epilogue"], err)
        print(f"conv1x1_epilogue R{R} I{I} O{O} residual={res} act={act} "
              f"plan {tuple(ke.tile_plan(R, I, O, split_k=True))}: "
              f"{err:.3e} (tol {GEMM_TOL})")
        del x, w, r, out, out2
    print(f"conv-epilogue GEMM kernels: two launches on the same inputs "
          f"bitwise equal in all {repeat_ok} cases (y, stats, out)")
    usage = _conv_kernel_usage()
    sass = _sass_counts("conv_epilogue", "conv1x1_tf32x3_kernel")

    # timing at every shape the main path runs, weighted by its count; the
    # GEMM kernels in turns with the library (kernel, library, library,
    # kernel), and their device time beside (the wrappers' host work can
    # exceed the kernels' at the inference shapes)
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
            flops, nbytes = _conv_work(kind, R, I, O, res, act)
            bound, by, bound_simt = _bound(
                flops, nbytes, gpu_name, products=kind != "scale_shift_act")
            row = {"bound_ms": bound, "bound_by": by,
                   "bound_ms_simt": bound_simt, "count": shapes.count(shape)}
            if kind == "scale_shift_act":  # the same pass as addcmul's
                row.update(zip(("ms", "plain_ms", "library_ms"), (
                    _cuda_ms(f, iters=10) for f in calls)))
                row["ms_no_residual_no_act"] = _cuda_ms(
                    lambda: ke.scale_shift_act(y, scale, shift), iters=10)
            else:
                turns = [_cuda_ms(calls[i], iters=30) for i in (0, 2, 2, 0)]
                row.update(
                    ms=(turns[0] + turns[3]) / 2,
                    library_ms=(turns[1] + turns[2]) / 2,
                    plain_ms=_cuda_ms(calls[1], iters=10), turns_ms=turns,
                    device_ms=_device_ms(calls[0]),
                    library_device_ms=_device_ms(calls[2]),
                    host_ms=_host_ms(calls[0]),
                    library_host_ms=_host_ms(calls[2]),
                    plan=list(ke.tile_plan(
                        R, I, O, split_k=kind == "conv1x1_epilogue")))
            timed[kind][shape] = row
            dev = ("" if "device_ms" not in row else
                   f" (device {_ms_text(row['device_ms'], '.4f')}, library "
                   f"{_ms_text(row['library_device_ms'], '.4f')}; host "
                   f"{_ms_text(row['host_ms'], '.4f')}, library "
                   f"{_ms_text(row['library_host_ms'], '.4f')})")
            print(f"{kind} R{R} I{I} O{O} residual={res} act={act} "
                  f"x{row['count']}: {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}"
                  f"{dev}, bound {bound:.4f} ({by})")
            del x, w, r, calls
    _reset_conv_counts(ke)  # comparison launches do not count

    library = {"conv1x1_stats": "torch.matmul, product only",
               "conv1x1_epilogue": "torch.matmul, product only",
               "scale_shift_act": "torch.addcmul(shift, y, scale), no "
                                  "residual, no act"}
    records = []
    for kind in CONV_KERNELS:
        rows = timed[kind]
        # the heaviest shape by its CUDA-core bound: the shape earlier
        # runs reported, whichever bound the tensor-core rate leaves on top
        shape, top = max(rows.items(),
                         key=lambda kv: kv[1]["bound_ms_simt"])
        per_step = {k: sum(r[k] * r["count"] for r in rows.values())
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_ms_simt", "device_ms",
                              "library_device_ms", "host_ms",
                              "library_host_ms")
                    if all(r.get(k) is not None for r in rows.values())}
        rec = {
            "name": kind, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/conv_epilogue.cu",
            "replaces": f"paddle_tpu/kernels/conv_epilogue.py:"
                        f"{CONV_REPLACES[kind]}",
            "launches": None, "max_abs_err": errs[kind], "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "bound_ms_simt": top["bound_ms_simt"],
            "library_ms": top["library_ms"],
            "library": library[kind],
            "shape": "R{} I{} O{} residual={} act={}".format(*shape),
            "per_step": per_step,
            "per_shape": [[list(k), v] for k, v in rows.items()],
        }
        if kind == "conv1x1_stats":
            rec["stats_err_of_mass"] = stats_err
        if kind == "scale_shift_act":
            rec["ms_no_residual_no_act"] = top["ms_no_residual_no_act"]
        else:
            rec["ptxas"], rec["sass"] = usage, sass
        dev = ("" if kind == "scale_shift_act" else
               f"; device time {_ms_text(per_step.get('device_ms'))} ms, "
               f"library {_ms_text(per_step.get('library_device_ms'))}; "
               f"host time {_ms_text(per_step.get('host_ms'))} ms, library "
               f"{_ms_text(per_step.get('library_host_ms'))}")
        print(f"{kind}: heaviest shape {rec['shape']} {top['ms']:.4f} ms vs "
              f"bound {top['bound_ms']:.4f} ({top['bound_by']}); per "
              f"{'batch' if kind == 'conv1x1_epilogue' else 'step'} "
              f"{per_step['ms']:.3f} ms (plain {per_step['plain_ms']:.3f}, "
              f"library {per_step['library_ms']:.3f}, bound "
              f"{per_step['bound_ms']:.3f}){dev}")
        records.append(rec)
    return records


def _conv_kernel_usage():
    from paddle_tpu_torch.kernels import build

    smem = build.load("conv_epilogue").paddle_conv1x1_smem_bytes
    return _kernel_usage("conv_epilogue", lambda name, args: smem(args[0]),
                         match="conv1x1_tf32x3_kernel")


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
        lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope),
        "resnet_profile.txt",
        # the port's kernels, cuDNN (its kernels carry "cudnn" or
        # "engine"), cuBLAS ("cublas" or cutlass "sgemm"), torch's own
        groups=("conv1x1_tf32x3_kernel", "split_w_kernel",
                "stats_reduce_kernel", "scale_shift_act_kernel", "cudnn",
                "engine", "cublas", "sgemm", "elementwise", "reduce"))
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
    served = resnet_serving_phase(built, scope, feed, kern)
    return {"batch": B, "batch_ms": [x * 1e3 for x in batch_s],
            "batch_ms_median": med * 1e3, "images_per_s": B / med,
            "logits_max_abs_err": err, "logits_max_abs": ref,
            "launches_per_batch": launches[1] // 10, "served": served}


def _count_kernels(run, names):
    """Launches per kernel-name substring in a torch.profiler trace of
    one ``run()``; None where the trace holds no device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without kernels
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events:
            return {n: sum(e.count for e in events if n in e.key)
                    for n in names}
    return None


def resnet_serving_phase(built, scope, feed, untranspiled):
    """Phase 10's served path: save the for_test program through the
    inference transpiler, load it into InferenceEngine (one CUDA graph
    per bucket), hold the replay against the eager, plain and
    untranspiled runs, count its kernels, time it, and serve a wave."""
    import collections
    import shutil

    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import conv_epilogue as ke

    c = RESNET
    B = c["infer_batch"]
    test_prog, logits = built[2], built[4]
    exe = pt.Executor(pt.CUDAPlace())
    model_dir = ROOT / "build" / "resnet50_inference"
    shutil.rmtree(model_dir, ignore_errors=True)
    before = collections.Counter(
        op.type for op in pt.io.prune_program(
            test_prog, ["images"], [logits.name]).global_block.ops)
    torch.cuda.empty_cache()
    _reset_conv_counts(ke)
    t0 = time.perf_counter()
    pt.flags.FLAGS.fused_conv_epilogue = True
    try:
        pt.io.save_inference_model(str(model_dir), ["images"], [logits], exe,
                                   main_program=test_prog, scope=scope)
    finally:
        pt.flags.FLAGS.fused_conv_epilogue = False
    save_s = time.perf_counter() - t0
    meta = pt.io.read_inference_model_meta(str(model_dir))
    after = collections.Counter(op["type"] for op in
                                meta["program"]["blocks"][0]["ops"])
    print(f"resnet serving: saved in {save_s:.2f} s; ops before the "
          f"inference pipeline {sum(before.values())} {dict(before)}, after "
          f"{sum(after.values())} {dict(after)}")
    assert after["conv1x1_bn_act"] == FUSED_OPS and not after["batch_norm"]

    t0 = time.perf_counter()
    eng = pt.InferenceEngine(str(model_dir), place=pt.CUDAPlace(0),
                             batch_buckets=SERVE_BUCKETS)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warmed = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    path_launches = _conv_counts(ke)
    assert warmed == len(SERVE_BUCKETS), warmed
    assert eng.cache_stats()["graphs"] == len(SERVE_BUCKETS)
    assert path_launches[1] > 0 and path_launches[0] == path_launches[2] == 0
    print(f"resnet serving: loaded in {load_s:.2f} s; warmup captured "
          f"{eng.cache_stats()['graphs']} CUDA graphs (buckets "
          f"{list(SERVE_BUCKETS)}) in {warm_s:.2f} s; conv1x1_epilogue "
          f"wrapper launches while loading and capturing {path_launches[1]}")

    x = feed["images"].cpu().numpy()
    replay = eng.run({"images": x})[0]
    dev_feed = {"images": feed["images"]}
    eager = exe.run(eng.program, feed=dev_feed, fetch_list=eng.fetch_names,
                    scope=eng.scope)[0]
    plain = _plain_step(exe, eng.program, dev_feed, eng.fetch_names,
                        eng.scope, ke)[0].cpu().numpy()
    untr = untranspiled.cpu().numpy()
    assert replay.shape == (B, c["classes"]) and np.isfinite(replay).all()
    ref = float(np.abs(plain).max())
    errs = {"eager": float(np.abs(replay - eager).max()),
            "plain": float(np.abs(replay - plain).max()),
            "untranspiled": float(np.abs(replay - untr).max())}
    bitwise = bool(np.array_equal(replay, eager))
    print(f"resnet serving: replay at batch {B} vs the eager run of the "
          f"loaded program max abs err {errs['eager']:.3e} (bitwise "
          f"{bitwise}; tol {REPLAY_RTOL} of max |logit| {ref:.3e}), vs its "
          f"plain path {errs['plain']:.3e} (tol {LOGIT_RTOL} of it), vs the "
          f"untranspiled for_test clone {errs['untranspiled']:.3e} (tol "
          f"{TRANSPILE_RTOL} of it)")
    assert errs["eager"] <= REPLAY_RTOL * ref, errs
    assert errs["plain"] <= LOGIT_RTOL * ref, errs
    assert errs["untranspiled"] <= TRANSPILE_RTOL * ref, errs

    names = ("conv1x1_tf32x3_kernel", "split_w_kernel",
             "scale_shift_act_kernel")
    counted = _count_kernels(lambda: eng.run({"images": x}), names)
    assert counted is not None, "the replay's trace held no device kernels"
    print(f"resnet serving: one profiled replay launched {counted}")
    assert counted["conv1x1_tf32x3_kernel"] == FUSED_OPS, counted
    assert counted["split_w_kernel"] == FUSED_OPS, counted

    def timed(fn, n=10, warm=2):
        for _ in range(warm):
            fn()
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t1)
        return out

    rep_s = timed(lambda: eng.run({"images": x}))
    eager_s = timed(lambda: exe.run(eng.program, feed={"images": x},
                                    fetch_list=eng.fetch_names,
                                    scope=eng.scope))
    graph, static_in, _ = eng._graphs[eng._signature({"images": x})]
    device_ms = _device_ms(graph.replay)
    profile = _profile_step(
        graph.replay, "resnet_serving_profile.txt",
        # the port's kernels, cuDNN's ("cudnn", "engine", "xmma"),
        # cuBLAS ("gemm"), torch's own
        groups=("conv1x1_tf32x3_kernel", "split_w_kernel",
                "scale_shift_act_kernel", "cudnn", "engine", "xmma", "gemm",
                "elementwise", "reduce", "pool"))
    rep_med, eager_med = float(np.median(rep_s)), float(np.median(eager_s))
    print(f"resnet serving: batch {B} replayed {rep_med * 1e3:.3f} ms median "
          f"({B / rep_med:.1f} images/s; {[round(t * 1e3, 3) for t in rep_s]}"
          f" ms), the graph alone {_ms_text(device_ms)} ms of device time; "
          f"the eager executor on the loaded program {eager_med * 1e3:.3f} ms "
          f"({B / eager_med:.1f} images/s)")

    # the wave: single-image requests through Server while one 40-row run
    # chunks into 32 + 8 on this thread
    gen = torch.Generator().manual_seed(SEED + 7)
    rows = torch.randn(WAVE_SINGLES, c["size"], c["size"], 3,
                       generator=gen).numpy()
    big = torch.randn(WAVE_RUN, c["size"], c["size"], 3,
                      generator=gen).numpy()
    m0 = dict(eng.metrics.snapshot()["counters"])
    srv = pt.Server(eng, max_wait_ms=5.0).start()
    try:
        t0 = time.perf_counter()
        futs = [srv.submit({"images": r}) for r in rows]
        big_out = eng.run({"images": big})[0]
        served = [f.result(timeout=300)[0] for f in futs]
        wave_s = time.perf_counter() - t0
        snap = srv.metrics_snapshot()
    finally:
        srv.stop()
    m1 = snap["counters"]
    assert m1.get("dispatch_errors", 0) == 0, m1
    assert big_out.shape == (WAVE_RUN, c["classes"])
    assert np.isfinite(big_out).all() and np.isfinite(served).all()
    # the rows against runs of the same rows in fixed buckets: the buckets
    # a row rides in differ, so the rounding may (tolerance as transpiled)
    alone = eng.run({"images": rows})[0]
    wave_err = float(np.abs(np.stack(served) - alone).max())
    ref_w = float(np.abs(alone).max())
    assert wave_err <= TRANSPILE_RTOL * ref_w, (wave_err, ref_w)
    np.testing.assert_array_equal(eng.run({"images": big})[0], big_out)
    batches = m1["batches_executed"] - m0.get("batches_executed", 0)
    rows_run = m1["rows_executed"] - m0.get("rows_executed", 0)
    cap = m1["bucket_rows_executed"] - m0.get("bucket_rows_executed", 0)
    lat = snap["latency"]["request_ms"]
    images = WAVE_SINGLES + WAVE_RUN
    print(f"resnet serving: wave of {WAVE_SINGLES} single-image requests + "
          f"one {WAVE_RUN}-row run in {wave_s * 1e3:.1f} ms: "
          f"{images / wave_s:.1f} images/s, request latency mean "
          f"{lat['mean']:.1f} ms p50 {lat['p50']:.1f} ms p99 "
          f"{lat['p99']:.1f} ms, {batches} batches, "
          f"occupancy {rows_run / cap:.3f} ({rows_run} rows in {cap} bucket "
          f"rows); served rows vs a 64-row run max abs err {wave_err:.3e}")
    eng.close()
    del eng, graph, static_in
    torch.cuda.empty_cache()
    return {"ops_before": dict(before), "ops_after": dict(after),
            "save_s": save_s, "load_s": load_s, "warmup_s": warm_s,
            "graphs": len(SERVE_BUCKETS),
            "capture_path_epilogue_launches": path_launches[1],
            "replay_kernels": counted, "errors": errs,
            "replay_bitwise_eager": bitwise, "logits_max_abs": ref,
            "replay_ms": [t * 1e3 for t in rep_s],
            "replay_ms_median": rep_med * 1e3,
            "replay_device_ms": device_ms, "replay_profile": profile,
            "replay_images_per_s": B / rep_med,
            "eager_ms": [t * 1e3 for t in eager_s],
            "eager_ms_median": eager_med * 1e3,
            "eager_images_per_s": B / eager_med,
            "wave": {"images": images, "seconds": wave_s,
                     "images_per_s": images / wave_s,
                     "mean_ms": lat["mean"], "p50_ms": lat["p50"],
                     "p99_ms": lat["p99"],
                     "batches": batches, "rows": rows_run,
                     "bucket_rows": cap, "occupancy": rows_run / cap,
                     "max_abs_err": wave_err}}


def attention_rewrite_phase():
    """Phase 10b: a primitive attention program transpiled onto the
    flash forward, run without and with ``Length``."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import flash_attention as fa

    a = ATTN
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        q, k, v = (pt.layers.data(n, [a["H"], a["T"], a["D"]])
                   for n in ("q", "k", "v"))
        s = pt.layers.matmul(q, k, transpose_y=True,
                             alpha=1.0 / a["D"] ** 0.5)
        o = pt.layers.matmul(pt.layers.softmax(s), v)
    pm = pt.transpiler.inference_pipeline()
    prog = pm.run(main.clone(for_test=True), ["q", "k", "v"], [o.name],
                  scope=pt.Scope())
    (op,) = prog.global_block.ops
    assert op.type == "scaled_dot_product_attention", op.type
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    shape = (a["B"], a["H"], a["T"], a["D"])
    feed = {n: torch.randn(shape, device="cuda", generator=gen)
            for n in ("q", "k", "v")}
    T = a["T"]  # one full row, two ragged, one of a single key
    lengths = torch.tensor([T, T * 3 // 5, T // 7, 1][:a["B"]],
                           dtype=torch.int32, device="cuda")
    exe = pt.Executor(pt.CUDAPlace())
    result = {}
    for tag, lens in (("full", None), ("length", lengths)):
        if lens is not None:  # a padded batch: each row's true length
            prog.global_block.create_var(name="length", shape=[-1],
                                         dtype="int32", is_data=True)
            op.inputs["Length"] = ["length"]
            prog._bump()
        fa.flash_attention.launches = 0
        run_feed = dict(feed, **({"length": lens} if lens is not None
                                 else {}))
        got, = exe.run(prog, feed=run_feed, fetch_list=[o.name],
                       return_numpy=False)
        launches = fa.flash_attention.launches
        want = fa.flash_attention_reference(
            feed["q"], feed["k"], feed["v"], lens, False,
            1.0 / a["D"] ** 0.5)[0]
        err = _max_err(got, want)
        print(f"attention rewrite ({tag}): B{a['B']} H{a['H']} T{a['T']} "
              f"D{a['D']} non-causal, one scaled_dot_product_attention op "
              f"from {pm.results[0].ops_before} ops; flash forward launches "
              f"per run {launches}; max abs err vs plain {err:.3e} (tol "
              f"{ATOL} + {RTOL} rel)")
        assert launches == 1, launches
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        result[tag] = {"launches": launches, "max_abs_err": err}
    return result


# --- mixed precision (AMP): bf16 products on f32 master weights --------------
# The bf16 instances of the conv-epilogue kernels against their plain
# versions (the f32 product of the bf16 operands, rounded once):
# - bf16 outputs (y, out): within one bf16 ulp of the plain version's (two
#   f32 sums in another order round apart at a tie); the ulp is taken at
#   no less than 1/256 of the largest |value|, as a value that cancels to
#   near zero moves by more than its own ulp when its f32 sum is taken in
#   another order (~1e-7 of the summed terms);
# - statistics: each channel's within STATS_TOL of its summed magnitude,
#   as for the f32 instance (the same summation order, from the f32
#   accumulator).
# End to end, against the same step or batch in f32: the JAX package's
# own AMP tolerance (3e-2 relative, tests/tpu_tier.py), for the step-1
# loss and for the served logits (of the largest |logit|); the kernels'
# AMP loss against the plain path's AMP loss within 1e-2 (the bf16
# kernels and cuBLAS's bf16 products round the activations at ties apart,
# and 53 BN layers pass that on).
AMP_RTOL = 3e-2
AMP_PLAIN_RTOL = 1e-2
BF16_KERNELS = tuple(f"{k}_bf16" for k in CONV_KERNELS)


def _amp_counts(ke):
    return tuple(getattr(ke, n).bf16_launches for n in CONV_KERNELS)


def _reset_amp_counts(ke):
    for n in CONV_KERNELS:
        getattr(ke, n).bf16_launches = 0


class _Amp:
    """``--use_amp`` on inside the block (the flag a user sets), off after."""

    def __enter__(self):
        import paddle_tpu_torch as pt

        pt.flags.FLAGS.use_amp = True

    def __exit__(self, *exc):
        import paddle_tpu_torch as pt

        pt.flags.FLAGS.use_amp = False


def _bf16_ulps(got, want):
    """The largest |got - want| in bf16 ulps of the larger of the two
    values, each ulp taken at no less than 1/256 of max |want|."""
    import torch

    g, w = got.float(), want.float()
    floor = max(float(w.abs().max()) / 256, 2.0 ** -126)
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


def _conv_work_bf16(kind, R, I, O, residual, act, res_bytes=2):
    """(FLOPs, bytes) of one bf16-instance call: bf16 x, W, y and out at
    2 bytes a value, f32 scale/shift and statistics at 4, the residual at
    ``res_bytes``; each input read once and each output written once."""
    if kind == "scale_shift_act":
        flops = R * O * (2 + int(residual) + int(act == "relu"))
        return flops, 2.0 * 2 * R * O + res_bytes * R * O * residual + 8 * O
    nbytes = 2.0 * (R * I + I * O + R * O) + 8.0 * O
    if kind == "conv1x1_epilogue" and residual:
        nbytes += res_bytes * R * O
    return 2.0 * R * I * O, nbytes


def amp_kernel_phase(gpu_name, train_shapes, infer_shapes):
    """Phase 11a: the bf16 instances against their plain versions at every
    1x1 conv1x1_bn_act shape of ResNet-50's train step (batch 256; bf16
    residuals, as that program carries them) and served batch (16; f32
    residuals, as the transpiled program's BN-folded shortcuts give them)
    and at ragged shapes (both residual dtypes; widths that TMA cannot
    take as they are); then timed at the main path's shapes beside the
    plain version, the bound and the library (bf16 torch.matmul with f32
    accumulation; torch.addcmul in bf16)."""
    import torch

    from paddle_tpu_torch.kernels import conv_epilogue as ke
    from paddle_tpu_torch.ops.common import f32_accumulation

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)

    def inputs(R, I, O, res_dtype):
        x = torch.randn(R, I, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(I, O, device="cuda", generator=gen)
             * I ** -0.5).bfloat16()
        scale = 1.0 + 0.2 * torch.randn(O, device="cuda", generator=gen)
        shift = 0.1 * torch.randn(O, device="cuda", generator=gen)
        res = (None if res_dtype is None else
               torch.randn(R, O, device="cuda", generator=gen).to(res_dtype))
        return x, w, scale, shift, res

    bf16, f32 = torch.bfloat16, torch.float32
    # ragged: I % 8 and O % 8 != 0 (the wrapper's padded rows), a partial
    # K stage, tiles cut by R and O, both residual dtypes
    ragged = [(R, I, O, rd, act) for R, I, O in ((257, 30, 9), (1000, 72, 40),
                                                 (100, 136, 200))
              for rd, act in ((None, None), (bf16, "relu"), (f32, "relu"))]
    train = sorted({(R, I, O, bf16 if res else None, act)
                    for R, I, O, res, act in train_shapes}, key=str)
    infer = sorted({(R, I, O, f32 if res else None, act)
                    for R, I, O, res, act in infer_shapes}, key=str)
    errs = {k: 0.0 for k in CONV_KERNELS}  # in bf16 ulps
    abs_errs = {k: 0.0 for k in CONV_KERNELS}
    stats_err = 0.0
    repeat_ok = 0
    for R, I, O, rd, act in train + ragged:
        x, w, scale, shift, r = inputs(R, I, O, rd)
        y, stats = ke.conv1x1_stats(x, w)
        y2, stats2 = ke.conv1x1_stats(x, w)
        torch.cuda.synchronize()
        assert y.dtype == bf16 and stats.dtype == f32, (y.dtype, stats.dtype)
        assert torch.equal(y, y2) and torch.equal(stats, stats2), (
            f"two bf16 conv1x1_stats launches differ at {R}x{I}x{O}")
        repeat_ok += 1
        ry, rstats = ke.conv1x1_stats_reference(x, w)
        ulps = _bf16_ulps(y, ry)
        assert ulps <= 1.0, (R, I, O, "y", ulps)
        yf = torch.matmul(x.float(), w.float())
        mass = torch.stack([yf.abs().sum(0), (yf * yf).sum(0)])
        s_err = float(((stats - rstats).abs() / mass.clamp_min(1e-30)).max())
        assert s_err <= STATS_TOL, (R, I, O, s_err)
        out = ke.scale_shift_act(ry, scale, shift, r, act)
        torch.cuda.synchronize()
        want = ke.scale_shift_act_reference(ry, scale, shift, r, act)
        a_ulps = _bf16_ulps(out, want)
        assert out.dtype == bf16 and a_ulps <= 1.0, (R, O, "apply", a_ulps)
        errs["conv1x1_stats"] = max(errs["conv1x1_stats"], ulps)
        errs["scale_shift_act"] = max(errs["scale_shift_act"], a_ulps)
        abs_errs["conv1x1_stats"] = max(abs_errs["conv1x1_stats"], float(
            (y.float() - ry.float()).abs().max()))
        abs_errs["scale_shift_act"] = max(abs_errs["scale_shift_act"], float(
            (out.float() - want.float()).abs().max()))
        stats_err = max(stats_err, s_err)
        print(f"bf16 conv1x1_stats/scale_shift_act R{R} I{I} O{O} residual="
              f"{rd} act={act}: y {ulps:.2f} ulp, stats {s_err:.3e} of the "
              f"summed mass (tol {STATS_TOL}), apply {a_ulps:.2f} ulp "
              f"(tol 1 ulp)")
        del x, w, r, y, y2, ry, out, want, yf
    for R, I, O, rd, act in infer + ragged:
        x, w, scale, shift, r = inputs(R, I, O, rd)
        out = ke.conv1x1_epilogue(x, w, scale, shift, r, act)
        out2 = ke.conv1x1_epilogue(x, w, scale, shift, r, act)
        torch.cuda.synchronize()
        assert out.dtype == bf16 and torch.equal(out, out2), (
            f"two bf16 conv1x1_epilogue launches differ at {R}x{I}x{O}")
        repeat_ok += 1
        want = ke.conv1x1_epilogue_reference(x, w, scale, shift, r, act)
        ulps = _bf16_ulps(out, want)
        assert ulps <= 1.0, (R, I, O, "epilogue", ulps)
        errs["conv1x1_epilogue"] = max(errs["conv1x1_epilogue"], ulps)
        abs_errs["conv1x1_epilogue"] = max(abs_errs["conv1x1_epilogue"], float(
            (out.float() - want.float()).abs().max()))
        print(f"bf16 conv1x1_epilogue R{R} I{I} O{O} residual={rd} act={act}"
              f" plan {tuple(ke.tile_plan(R, I, O, True, ke.K_TILE_BF16))}: "
              f"{ulps:.2f} ulp (tol 1 ulp)")
        del x, w, r, out, out2, want
    print(f"bf16 conv-epilogue GEMM kernels: two launches on the same inputs "
          f"bitwise equal in all {repeat_ok} cases")
    from paddle_tpu_torch.kernels import build

    smem = build.load("conv_epilogue").paddle_conv1x1_smem_bytes_bf16
    usage = _kernel_usage("conv_epilogue", lambda name, args: smem(args[0]),
                          match="conv1x1_bf16_kernel")
    sass = _sass_counts("conv_epilogue", "conv1x1_bf16_kernel")

    def matmul_lib(x, w):
        with f32_accumulation():
            return torch.matmul(x, w)

    timed = {k: {} for k in CONV_KERNELS}
    for kind, shapes, rows in (("conv1x1_stats", train_shapes, train),
                               ("scale_shift_act", train_shapes, train),
                               ("conv1x1_epilogue", infer_shapes, infer)):
        for R, I, O, rd, act in rows:
            x, w, scale, shift, r = inputs(R, I, O, rd)
            count = shapes.count((R, I, O, rd is not None, act))
            if kind == "conv1x1_stats":
                calls = (lambda: ke.conv1x1_stats(x, w),
                         lambda: ke.conv1x1_stats_reference(x, w),
                         lambda: matmul_lib(x, w))
            elif kind == "conv1x1_epilogue":
                calls = (lambda: ke.conv1x1_epilogue(x, w, scale, shift, r,
                                                     act),
                         lambda: ke.conv1x1_epilogue_reference(
                             x, w, scale, shift, r, act),
                         lambda: matmul_lib(x, w))
            else:
                y = torch.randn(R, O, device="cuda", generator=gen).bfloat16()
                sb, hb = scale.bfloat16(), shift.bfloat16()
                calls = (lambda: ke.scale_shift_act(y, scale, shift, r, act),
                         lambda: ke.scale_shift_act_reference(y, scale, shift,
                                                              r, act),
                         lambda: torch.addcmul(hb, y, sb))
            flops, nbytes = _conv_work_bf16(
                kind, R, I, O, rd is not None, act,
                4 if rd == torch.float32 else 2)
            bound, by, bound_simt = _bound(
                flops, nbytes, gpu_name, products=kind != "scale_shift_act",
                bf16=True)
            turns = [_cuda_ms(calls[i], iters=20) for i in (0, 2, 2, 0)]
            row = {"bound_ms": bound, "bound_by": by,
                   "bound_ms_simt": bound_simt, "count": count,
                   "ms": (turns[0] + turns[3]) / 2,
                   "library_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
                   "plain_ms": _cuda_ms(calls[1], iters=10),
                   "residual": None if rd is None else str(rd)}
            if kind != "scale_shift_act":
                row["device_ms"] = _device_ms(calls[0])
            timed[kind][(R, I, O, rd is not None, act)] = row
            print(f"bf16 {kind} R{R} I{I} O{O} residual={rd} act={act} "
                  f"x{count}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
                  f", library {row['library_ms']:.4f}, bound {bound:.4f} "
                  f"({by})")
            del x, w, r, calls
    _reset_amp_counts(ke)  # comparison launches do not count

    library = {"conv1x1_stats": "torch.matmul in bf16 (f32 accumulation), "
                                "product only",
               "conv1x1_epilogue": "torch.matmul in bf16 (f32 "
                                   "accumulation), product only",
               "scale_shift_act": "torch.addcmul in bf16, no residual, "
                                  "no act"}
    records = []
    for kind in CONV_KERNELS:
        rows = timed[kind]
        shape, top = max(rows.items(), key=lambda kv: kv[1]["bound_ms"])
        per_step = {k: sum(r[k] * r["count"] for r in rows.values())
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "device_ms")
                    if all(r.get(k) is not None for r in rows.values())}
        rec = {
            "name": f"{kind}_bf16", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/conv_epilogue.cu",
            "replaces": f"paddle_tpu/kernels/conv_epilogue.py:"
                        f"{CONV_REPLACES[kind]}",
            "launches": None, "max_abs_err": abs_errs[kind],
            "max_err_bf16_ulps": errs[kind], "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "bound_ms_simt": top["bound_ms_simt"],
            "library_ms": top["library_ms"], "library": library[kind],
            "shape": "R{} I{} O{} residual={} act={}".format(*shape),
            "per_step": per_step,
            "per_shape": [[list(k), v] for k, v in rows.items()],
        }
        if kind == "conv1x1_stats":
            rec["stats_err_of_mass"] = stats_err
        if kind != "scale_shift_act":
            rec["ptxas"], rec["sass"] = usage, sass
        print(f"{kind}_bf16: heaviest shape {rec['shape']} {top['ms']:.4f} ms "
              f"vs bound {top['bound_ms']:.4f} ({top['bound_by']}), library "
              f"{top['library_ms']:.4f}; per "
              f"{'batch' if kind == 'conv1x1_epilogue' else 'step'} "
              f"{per_step['ms']:.3f} ms (plain {per_step['plain_ms']:.3f}, "
              f"library {per_step['library_ms']:.3f}, bound "
              f"{per_step['bound_ms']:.3f}; device time "
              f"{_ms_text(per_step.get('device_ms'))})")
        records.append(rec)
    return records


def _resnet_step1(pt, built, feed):
    """(executor, scope, its startup state, step-1 loss) of a ResNet build
    run from its seeded startup on ``feed``."""
    import torch

    main, startup, loss = built[0], built[1], built[3]
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace())
    exe.run(startup, scope=scope)
    state = {n: scope.get(n).clone() for n in list(scope.keys())
             if isinstance(scope.get(n), torch.Tensor)}
    loss1 = float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
    return exe, scope, state, loss1


def resnet_amp_training_phase(records, gpu_name):
    """Phase 11b: ResNet-50 at batch 256 built and trained under AMP and
    --fused_conv_epilogue, as the JAX package's benchmark builds it
    (parameters fed by bf16 activations are declared bf16 and become f32
    at the first update, as in JAX): step-1 loss against an f32 build's
    step 1 on the same batch from the same seeded startup, and against
    the AMP plain path; then 1 warm + 6 timed steps on that batch through
    the bf16 instances."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import conv_epilogue as ke

    c = RESNET
    B = c["batch"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    feed = {"images": torch.randn(B, c["size"], c["size"], 3, device="cuda",
                                  generator=gen),
            "label": torch.randint(0, c["classes"], (B, 1), device="cuda",
                                   generator=gen)}
    l32 = _resnet_step1(pt, _build_resnet(pt, c), feed)[3]
    torch.cuda.empty_cache()
    with _Amp():
        built = _build_resnet(pt, c)
        main, loss = built[0], built[3]
        exe, scope, state, _ = _resnet_step1(pt, built, feed)

        def restore():
            for n, t in state.items():
                scope.set(n, t.clone())

        restore()
        lplain = float(_plain_step(exe, main, feed, [loss], scope, ke)[0])
        restore()
        del state
        _reset_amp_counts(ke)
        _reset_conv_counts(ke)
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        for _ in range(7):
            t1 = time.perf_counter()
            lo, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            step_s.append(time.perf_counter() - t1)
            losses.append(float(lo))
        launches = _amp_counts(ke)
        f32_launches = _conv_counts(ke)
        peak_mem = torch.cuda.max_memory_allocated()
        profile = _profile_step(
            lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope),
            "resnet_amp_profile.txt",
            groups=("conv1x1_bf16_kernel", "stats_reduce_kernel",
                    "scale_shift_act_kernel", "cudnn", "engine", "xmma",
                    "cublas", "gemm", "elementwise", "reduce"))
    l1 = losses[0]
    print(f"resnet AMP: step-1 loss {l1:.6f}, the same step in f32 "
          f"{l32:.6f} (rel {abs(l1 - l32) / abs(l32):.3e}, tol {AMP_RTOL}), "
          f"the AMP plain path {lplain:.6f} (rel "
          f"{abs(l1 - lplain) / abs(lplain):.3e}, tol {AMP_PLAIN_RTOL})")
    assert np.isfinite(l1) and abs(l1 - l32) <= AMP_RTOL * abs(l32), (l1, l32)
    assert abs(l1 - lplain) <= AMP_PLAIN_RTOL * abs(lplain), (l1, lplain)
    assert launches == (7 * FUSED_OPS, 0, 7 * FUSED_OPS), launches
    assert f32_launches == (0, 0, 0), f32_launches
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    med = float(np.median(step_s[1:]))
    flops = _resnet_train_flops(main, B)
    peak_bf16 = _peaks(gpu_name)[3]
    by_name = {r["name"]: r for r in records}
    by_name["conv1x1_stats_bf16"]["launches"] = launches[0] // 7
    by_name["scale_shift_act_bf16"]["launches"] = launches[2] // 7
    print(f"resnet AMP: losses {[round(x, 5) for x in losses]}")
    print(f"resnet AMP: step median {med * 1e3:.1f} ms over 6 steps "
          f"({[round(x * 1e3, 1) for x in step_s]} ms), {B / med:.1f} "
          f"images/s, {flops / 1e12:.2f} TFLOP/step = "
          f"{flops / med / peak_bf16 * 100:.1f}% of the bf16 peak, peak "
          f"memory {peak_mem / 2**30:.2f} GiB; bf16 launches per step "
          f"stats/epilogue/apply {[n // 7 for n in launches]}")
    del feed
    return built, scope, {
        "losses": losses, "loss_f32_step1": l32, "loss_plain_step1": lplain,
        "step_ms": [x * 1e3 for x in step_s], "step_ms_median": med * 1e3,
        "images_per_s": B / med, "tflop_per_step": flops / 1e12,
        "bf16_peak_share": flops / med / peak_bf16,
        "peak_mem_bytes": peak_mem,
        "bf16_launches_per_step": {k: n // 7 for k, n in
                                   zip(CONV_KERNELS, launches)},
        "profile": profile}


def resnet_amp_serving_phase(records, built, scope):
    """Phase 11c: the for_test clone saved through the inference
    transpiler and served by two InferenceEngines on the same directory,
    one with AMP off and one with AMP on (one CUDA graph per bucket each):
    the AMP replay against the eager AMP run (bitwise is the target) and
    against the f32 graph's logits; timed at batch 16."""
    import shutil

    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import conv_epilogue as ke

    c = RESNET
    B = c["infer_batch"]
    test_prog, logits = built[2], built[4]
    exe = pt.Executor(pt.CUDAPlace())
    model_dir = ROOT / "build" / "resnet50_inference_amp"
    shutil.rmtree(model_dir, ignore_errors=True)
    pt.flags.FLAGS.fused_conv_epilogue = True
    try:
        pt.io.save_inference_model(str(model_dir), ["images"], [logits], exe,
                                   main_program=test_prog, scope=scope)
    finally:
        pt.flags.FLAGS.fused_conv_epilogue = False
    torch.cuda.empty_cache()
    buckets = (B,)
    eng32 = pt.InferenceEngine(str(model_dir), place=pt.CUDAPlace(0),
                               batch_buckets=buckets)
    eng32.warmup()
    gen = torch.Generator().manual_seed(SEED + 13)
    x = torch.randn(B, c["size"], c["size"], 3, generator=gen).numpy()
    want32 = eng32.run({"images": x})[0]
    eng32.close()
    del eng32
    with _Amp():
        _reset_amp_counts(ke)
        _reset_conv_counts(ke)
        eng = pt.InferenceEngine(str(model_dir), place=pt.CUDAPlace(0),
                                 batch_buckets=buckets)
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        capture_launches = _amp_counts(ke)
        assert capture_launches[1] > 0 and capture_launches[0] == \
            capture_launches[2] == 0, capture_launches
        assert _conv_counts(ke)[1] == 0, "an f32 epilogue ran under AMP"
        replay = eng.run({"images": x})[0]
        eager = exe.run(eng.program, feed={"images": x},
                        fetch_list=eng.fetch_names, scope=eng.scope)[0]
        counted = _count_kernels(lambda: eng.run({"images": x}),
                                 ("conv1x1_bf16_kernel",
                                  "conv1x1_tf32x3_kernel"))
        graph = eng._graphs[eng._signature({"images": x})][0]
        rep_s = []
        for i in range(12):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.run({"images": x})
            torch.cuda.synchronize()
            if i >= 2:
                rep_s.append(time.perf_counter() - t1)
        device_ms = _device_ms(graph.replay)
        profile = _profile_step(
            graph.replay, "resnet_amp_serving_profile.txt",
            groups=("conv1x1_bf16_kernel", "scale_shift_act_kernel", "cudnn",
                    "engine", "xmma", "gemm", "elementwise", "reduce",
                    "pool"))
    assert replay.shape == (B, c["classes"]) and np.isfinite(replay).all()
    ref = float(np.abs(want32).max())
    e_eager = float(np.abs(replay - eager).max())
    e_f32 = float(np.abs(replay - want32).max())
    bitwise = bool(np.array_equal(replay, eager))
    top32, top16 = want32.argmax(1), replay.argmax(1)
    srt = np.sort(want32, axis=1)
    clear = (srt[:, -1] - srt[:, -2]) > 2 * AMP_RTOL * ref
    agree = int((top32 == top16).sum())
    print(f"resnet AMP serving: graph captured in {warm_s:.2f} s with "
          f"{capture_launches[1]} bf16 conv1x1_epilogue wrapper launches; "
          f"replay vs the eager AMP run max abs err {e_eager:.3e} (bitwise "
          f"{bitwise}; tol {REPLAY_RTOL} of max |logit| {ref:.3e}); vs the "
          f"f32 graph {e_f32:.3e} (tol {AMP_RTOL} of it); top-1 agrees on "
          f"{agree}/{B} rows, on every one of the {int(clear.sum())} rows "
          f"whose f32 margin exceeds twice the tolerance: "
          f"{bool((top32 == top16)[clear].all())}; one profiled replay "
          f"launched {counted}")
    assert e_eager <= REPLAY_RTOL * ref, e_eager
    assert e_f32 <= AMP_RTOL * ref, (e_f32, ref)
    assert (top32 == top16)[clear].all(), (top32, top16)
    assert counted is not None and counted["conv1x1_bf16_kernel"] == \
        FUSED_OPS and counted["conv1x1_tf32x3_kernel"] == 0, counted
    by_name = {r["name"]: r for r in records}
    by_name["conv1x1_epilogue_bf16"]["launches"] = \
        counted["conv1x1_bf16_kernel"]
    med = float(np.median(rep_s))
    print(f"resnet AMP serving: batch {B} replayed {med * 1e3:.3f} ms median "
          f"({B / med:.1f} images/s; {[round(t * 1e3, 3) for t in rep_s]} "
          f"ms), the graph alone {_ms_text(device_ms)} ms of device time")
    eng.close()
    del eng, graph
    torch.cuda.empty_cache()
    return {"replay_ms": [t * 1e3 for t in rep_s], "replay_ms_median":
            med * 1e3, "replay_images_per_s": B / med,
            "replay_device_ms": device_ms, "replay_profile": profile,
            "errors": {"eager": e_eager, "f32_graph": e_f32},
            "replay_bitwise_eager": bitwise, "logits_max_abs_f32": ref,
            "top1_agree": agree, "top1_clear_rows": int(clear.sum()),
            "replay_kernels": counted,
            "capture_bf16_launches": capture_launches}


def lm_amp_phase(gpu_name):
    """Phase 11d: the LM trained under AMP (bf16 projections and head, the
    f32 flash kernels): step-1 loss against the same step in f32, launch
    counts, 1 warm + 6 timed steps; then a paged wave under AMP whose
    replayed decode step gives the eager AMP step's tokens."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import init_params
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import TransformerLM
    from paddle_tpu_torch.serving import GenerationEngine, LMSpec

    c = TRAIN
    L, tokens = c["n_layers"], c["batch"] * c["seq"]
    with _Amp():
        main, startup, loss, params_grads = _build_training_program(pt, c)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    feed = {"ids": rng.randint(0, c["vocab"], size=(c["batch"], c["seq"]))
            .astype("int64"),
            "tgt": rng.randint(0, c["vocab"], size=(c["batch"], c["seq"]))
            .astype("int64")}
    l32 = float(_step_fetches(exe, main, feed, [loss.name], scope,
                              _snapshot(scope))[0])
    with _Amp():
        losses, step_s, counts, peak_mem, profile = _timed_steps(
            exe, main, feed, loss, scope, fa, "train_amp_profile.txt",
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gemm", "cutlass",
             "elementwise", "reduce"))
        dtypes = {p.name: str(scope.get(p.name).dtype)
                  for p, _ in params_grads}
    launches = counts[:3]
    l1 = losses[0]
    print(f"training AMP: step-1 loss {l1:.6f}, the same step in f32 "
          f"{l32:.6f} (rel {abs(l1 - l32) / abs(l32):.3e}, tol {AMP_RTOL})")
    assert np.isfinite(l1) and abs(l1 - l32) <= AMP_RTOL * abs(l32), (l1, l32)
    assert counts == (7 * L,) * 3 + (0,) * 3, counts
    assert set(dtypes.values()) == {"torch.float32"}, dtypes
    med = float(np.median(step_s[1:]))
    flops = transformer_train_flops(c["batch"], c["seq"], c["d_model"], L,
                                    c["vocab"], c["d_ff"])
    peak_bf16 = _peaks(gpu_name)[3]
    print(f"training AMP: losses {[round(x, 5) for x in losses]}")
    print(f"training AMP: step median {med * 1e3:.1f} ms over 6 steps "
          f"({[round(x * 1e3, 1) for x in step_s]} ms), {tokens / med:.0f} "
          f"tokens/s, {flops / 1e12:.2f} TFLOP/step = "
          f"{flops / med / peak_bf16 * 100:.1f}% of the bf16 peak, peak "
          f"memory {peak_mem / 2**30:.2f} GiB; f32 flash launches per step "
          f"fwd/dq/dkv {[n // 7 for n in launches]}; parameters stay f32")
    del exe, scope, main
    torch.cuda.empty_cache()

    spec = LMSpec(vocab_size=16384, d_model=1024, n_layers=8, num_heads=16,
                  max_len=2048)
    model = TransformerLM(spec, device="cuda")
    model.load_jax_params(init_params(spec, SEED))
    with _Amp():
        eng = GenerationEngine(spec, model, device="cuda", **PAGED)
        eng.warmup()
        _reset_launch_counts(fa)
        paged = _replay_against_eager(eng, spec, spec.vocab_size,
                                      _peaks(gpu_name)[1],
                                      "paged_decode_amp_profile.txt")
    print(f"paged AMP: {paged['ticks']} full-batch ticks, replayed decode "
          f"step equal to the eager AMP step (tokens and pools bitwise); "
          f"replayed {paged['replay_ms_median']:.2f} ms, eager "
          f"{paged['eager_ms_median']:.2f} ms, device "
          f"{_ms_text(paged['replay_device_ms'])} ms a step; prefill flash "
          f"launches {fa.flash_attention.launches}")
    assert fa.flash_attention.launches == 0, "the paged plane ran flash"
    del eng, model
    torch.cuda.empty_cache()
    return {"losses": losses, "loss_f32_step1": l32,
            "step_ms": [x * 1e3 for x in step_s], "step_ms_median": med * 1e3,
            "tokens_per_s": tokens / med, "tflop_per_step": flops / 1e12,
            "bf16_peak_share": flops / med / peak_bf16,
            "peak_mem_bytes": peak_mem, "launches_per_step": {
                "fwd": launches[0] // 7, "dq": launches[1] // 7,
                "dkv": launches[2] // 7},
            "profile": profile, "paged": paged}


def amp_phases(gpu_name):
    """Phase 11 (a-d), all under --use_amp: returns (bf16 kernel records,
    the record of each phase)."""
    import torch

    import paddle_tpu_torch as pt

    resnet = _build_resnet(pt, RESNET)
    recs = amp_kernel_phase(gpu_name, _fused_shapes(resnet[0],
                                                    RESNET["batch"]),
                            _fused_shapes(resnet[2], RESNET["infer_batch"]))
    del resnet
    built, scope, training = resnet_amp_training_phase(recs, gpu_name)
    serving = resnet_amp_serving_phase(recs, built, scope)
    del built, scope
    torch.cuda.empty_cache()
    lm = lm_amp_phase(gpu_name)
    return recs, {"resnet_training": training, "resnet_serving": serving,
                  "lm": lm}


# --- Phase 12: the per-layer LM, the JAX package's benchmark model ------------
# bench.py's bench_transformer_step builds transformer_lm(pipeline_stack=
# False) and trains it under pt.set_amp(True): "transformer" d1024 L8 H8
# and "transformer_wide" d2048 L8 H16 (bench.py:2794-2796), d_ff 4 d, bs8
# T2048 V16384, Adam 1e-4. Under AMP the fused qkv product hands bf16
# q/k/v to scaled_dot_product_attention: the flash kernels' bf16
# instances.
PER_LAYER = dict(TRAIN)
PER_LAYER_WIDE = dict(TRAIN, d_model=2048, num_heads=16, d_ff=8192)
# (B, H, T, D, causal, lengths): both training shapes, the serving shape,
# a ragged T = 1000 with lengths (a fully masked row), a non-causal case
# and a head dim past 128 (the wide instances)
BF16_FLASH_CASES = [
    (8, 8, 2048, 128, True, None),
    (8, 16, 2048, 128, True, None),
    (8, 16, 1024, 64, True, None),
    (4, 8, 1000, 128, True, [1000, 999, 513, 0]),
    (2, 4, 300, 128, False, [300, 17]),
    (2, 4, 1000, 256, True, [1000, 0]),
]
BF16_FLASH = ("flash_attention_fwd_bf16", "flash_attention_bwd_dq_bf16",
              "flash_attention_bwd_dkv_bf16")
BF16_FLASH_REPLACES = (229, 364, 386)
# The bf16 gate: truth is the f32 plain version on the same bf16-valued
# inputs. The kernel may lie at most 2x as far from it as the bf16 plain
# version (which rounds as the Pallas kernels do) plus one bf16 ulp of
# the largest |value| (the kernels round P against a running max per
# 64-key tile, the plain version against the row's max); and, since that
# maximum is set by the few largest values of the first rows, its error's
# Frobenius norm at most BF16_FRO_RATIO x the plain version's (their
# rounding errors are of one size: 0.99-1.003 x in a CPU emulation with
# 64-key blocks, where a stale K/V stage gives 48-69 x). lse is f32.
BF16_FRO_RATIO = 1.5
BF16_LSE_ATOL = 1e-4
# The f32 per-layer step 1, kernels against the plain path.
PER_LAYER_RTOL = 1e-4
# The AMP per-layer step 1: every gradient with the bf16 kernels against
# the AMP plain path (|kernels - plain| / |plain| of the worst parameter).
# Two valid bf16 roundings of one step differ by about this much: 6.8e-3
# at d1024 and d2048 on an H100 (the f32 build lies 1.0e-2 from either),
# where a stale K/V stage planted in the plain backward moves 4.7e-2 and
# 5.1e-2; the control must exceed the limit.
AMP_GRAD_RTOL = 1.5e-2
PER_LAYER_GROUPS = ("flash_fwd_bf16", "flash_bwd_dq_bf16",
                    "flash_bwd_dkv_bf16", "flash_", "nvjet", "gemm",
                    "elementwise", "reduce")


def _bf16_errors(got, plain, truth):
    """How far a bf16 output and its bf16 plain version lie from the f32
    truth, over the truth's finite elements: max |error| of each, the
    max-abs limit (2x the plain's + one bf16 ulp of max |truth|), the
    ratio of their errors' Frobenius norms, and median |truth|."""
    import math

    fin = truth.isfinite()
    t = truth[fin]
    dk, dp = got.float()[fin] - t, plain.float()[fin] - t
    top = float(t.abs().max()) if t.numel() else 0.0
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0
    ep = float(dp.abs().max()) if t.numel() else 0.0
    nk, np_ = float(dk.norm()), float(dp.norm())
    return {"kernel": float(dk.abs().max()) if t.numel() else 0.0,
            "plain": ep, "limit": 2 * ep + ulp,
            "fro_ratio": nk / np_ if np_ else (0.0 if nk == 0 else math.inf),
            "median_truth": float(t.abs().median()) if t.numel() else 0.0}


def _bf16_passes(e):
    return e["kernel"] <= e["limit"] and e["fro_ratio"] <= BF16_FRO_RATIO


def _bf16_gate(got, plain, truth, what):
    """_bf16_errors of a bf16 kernel output; raises past either limit."""
    e = _bf16_errors(got, plain, truth)
    if not _bf16_passes(e):
        raise AssertionError(
            f"{what}: kernel {e['kernel']:.3e} from the f32 truth (allowed "
            f"{e['limit']:.3e}), Frobenius {e['fro_ratio']:.3f} x the plain "
            f"version's (allowed {BF16_FRO_RATIO})")
    return e


def _bf16_text(e):
    return (f"{e['kernel']:.3e}/{e['plain']:.3e} (limit {e['limit']:.3e}, "
            f"median |truth| {e['median_truth']:.2e}, Frobenius "
            f"{e['fro_ratio']:.3f}x)")


def _sdpa_fastest(F, q, k, v, do=None):
    """(ms, backend) of the fastest SDPA backend that takes these inputs
    (is_causal): the forward, or with ``do`` its backward (forward and
    backward minus the forward alone)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, do)

    best = None
    for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:  # a backend that refuses the inputs warns, then raises
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                ms = (_cuda_ms(fwd) if do is None else
                      _cuda_ms(fwd_bwd, iters=10) - _cuda_ms(fwd, iters=10))
        except RuntimeError:
            continue
        if best is None or ms < best[0]:
            best = (ms, name)
    if best is None:
        raise RuntimeError("no SDPA backend ran these inputs")
    return best


def bf16_flash_kernel_phase(gpu_name):
    """Phase 12a: the bf16 flash forward, dq and dkv against their plain
    versions (the gate above) at every case, two launches of each bitwise
    equal at the training shape; registers and tensor-core opcodes; then
    timed at B8 H8 T2048 D128 causal beside the plain versions, the bound
    at the bf16 tensor-core rate and bf16 SDPA (forward; backward for the
    pair)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import flash_attention as fa

    lib = build.load("flash_attention_bf16")
    smem = lib.paddle_flash_attention_bf16_smem_bytes
    usage = _kernel_usage(
        "flash_attention_bf16",
        lambda name, args: smem(0 if "fwd" in name else
                                1 if "dq" in name else 2,
                                args[0] if args else WIDE_D),
        match="bf16_kernel")
    sass = _sass_counts("flash_attention_bf16", "bf16_kernel")
    assert sass and all(c["HMMA"] > 0 for c in sass.values()), sass
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    errs = {n: 0.0 for n in BF16_FLASH}
    cases = []
    for B, H, T, D, causal, lengths in BF16_FLASH_CASES:
        q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=gen)
                       .bfloat16() for _ in range(4))
        lens = (None if lengths is None
                else torch.tensor(lengths, device="cuda"))
        sm = 1.0 / D ** 0.5
        o, lse = fa.flash_forward(q, k, v, lens, causal, sm)
        torch.cuda.synchronize()
        po, plse = fa.flash_attention_reference(q, k, v, lens, causal, sm)
        to, _ = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                             lens, causal, sm)
        row = {"case": _case_text(B, H, T, D, causal, lengths)}
        row["o"] = _bf16_gate(o, po, to, "o")
        first = len(cases) == 0
        if first:  # the control: the gate refuses a stale K/V stage
            ks, vs = _stale_stage(k), _stale_stage(v)
            planted = {"o": _bf16_errors(fa.flash_attention_reference(
                q, ks, vs, lens, causal, sm)[0], po, to)}
        if not torch.equal(lse.isinf(), plse.isinf()):
            raise AssertionError("lse: kernel and plain version disagree on "
                                 "which rows are fully masked")
        fin = plse.isfinite()
        row["lse"] = float((lse - plse)[fin].abs().max())
        assert row["lse"] <= BF16_LSE_ATOL, row
        errs[BF16_FLASH[0]] = max(errs[BF16_FLASH[0]],
                                  float((o.float() - po.float()).abs().max()))
        del to
        # the backward on the plain forward's o and lse
        grads = fa.flash_backward(q, k, v, po, plse, do, lens, causal, sm)
        torch.cuda.synchronize()
        pg = fa.flash_attention_backward_reference(q, k, v, po, plse, do,
                                                   lens, causal, sm)
        tg = fa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), po.float(), plse, do.float(),
            lens, causal, sm)
        fg = (fa.flash_attention_backward_reference(
            q, ks, vs, po, plse, do, lens, causal, sm) if first else pg)
        for name, a, b, t, f in zip(("dq", "dk", "dv"), grads, pg, tg, fg):
            assert a.dtype == torch.bfloat16, (name, a.dtype)
            row[name] = _bf16_gate(a, b, t, name)
            key = BF16_FLASH[1] if name == "dq" else BF16_FLASH[2]
            errs[key] = max(errs[key], float((a.float() - b.float())
                                             .abs().max()))
            if first:
                planted[name] = _bf16_errors(f, b, t)
        del pg, tg, fg
        if first:
            del ks, vs
            for name, e in planted.items():
                assert not _bf16_passes(e), (
                    f"the gate let a stale K/V stage through in {name}: {e}")
                by_max = e["kernel"] > e["limit"]
                by_fro = e["fro_ratio"] > BF16_FRO_RATIO
                print(f"bf16 flash control (a stale K/V stage planted in "
                      f"the plain version): {name} {_bf16_text(e)}; refused "
                      f"by max-abs {by_max}, by Frobenius {by_fro}")
            row["planted_stale_stage"] = planted
            # the training shape: no atomics
            o2, _ = fa.flash_forward(q, k, v, lens, causal, sm)
            g2 = fa.flash_backward(q, k, v, po, plse, do, lens, causal, sm)
            assert torch.equal(o2, o) and all(
                torch.equal(a, b) for a, b in zip(g2, grads)), \
                "two launches differ"
            del o2, g2
        print(f"bf16 flash {row['case']}: max error from the f32 truth "
              f"(kernel/plain): " + "; ".join(
                  f"{n} {_bf16_text(row[n])}" for n in ("o", "dq", "dk", "dv"))
              + f"; lse {row['lse']:.2e} from the plain version")
        cases.append(row)
        del q, k, v, do, o, lse, po, plse, grads
        torch.cuda.empty_cache()
    print("bf16 flash kernels: two launches on the same inputs bitwise equal "
          "at the training shape")

    B, H, T, D, causal, _ = BF16_FLASH_CASES[0]
    q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=gen)
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_forward(q, k, v, None, causal)
    di = fa._row_dot(do, o)
    runs = {
        BF16_FLASH[0]: (lambda: fa.flash_forward(q, k, v, None, causal),
                        lambda: fa.flash_attention_reference(q, k, v, None,
                                                             causal)),
        BF16_FLASH[1]: (lambda: fa.flash_dq(q, k, v, lse, di, do, None,
                                            causal),
                        lambda: fa.flash_dq_reference(q, k, v, lse, di, do,
                                                      None, causal)),
        BF16_FLASH[2]: (lambda: fa.flash_dkv(q, k, v, lse, di, do, None,
                                             causal),
                        lambda: fa.flash_dkv_reference(q, k, v, lse, di, do,
                                                       None, causal)),
    }
    sdpa_fwd, backend = _sdpa_fastest(F, q, k, v)
    sdpa_bwd, bwd_backend = _sdpa_fastest(F, q, k, v, do)
    records = []
    for i, name in enumerate(BF16_FLASH):
        kernel, plain = runs[name]
        ms = _cuda_ms(kernel)
        plain_ms = _cuda_ms(plain, iters=3, warmup=1)
        if i == 0:
            flops, nbytes = _attention_work(B, H, T, T, D, causal, None, 2)
        else:
            flops, nbytes = _backward_work("dq" if i == 1 else "dkv", B, H,
                                           T, T, D, causal, None, 2)
        bound, bound_by, bound_simt = _bound(flops, nbytes, gpu_name,
                                             bf16=True)
        library = sdpa_fwd if i == 0 else sdpa_bwd
        lib_text = (f"forward {library:.3f} ({backend})" if i == 0 else
                    f"backward {library:.3f} for the pair ({bwd_backend})")
        print(f"{name}: {ms:.3f} ms at {_case_text(B, H, T, D, causal, None)}"
              f", plain {plain_ms:.3f}, bound {bound:.3f} ({bound_by}, bf16 "
              f"tensor cores), bf16 SDPA {lib_text}")
        records.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention_bf16.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:"
                        f"{BF16_FLASH_REPLACES[i]}",
            "launches": 0, "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "bound_ms_simt": bound_simt, "library_ms": library,
            "library": f"F.scaled_dot_product_attention bf16 {lib_text}",
            "cases": cases, "ptxas": usage, "sass": sass})
    del q, k, v, do, o, lse, di
    torch.cuda.empty_cache()
    return records


def per_layer_lm_phase(gpu_name, c, time_f32):
    """Phase 12b/c: the per-layer LM at configuration ``c``. The f32 build
    first, from the startup program's seeded state: its step 1 with the
    kernels against its plain path (loss and every gradient, 1e-4), and,
    with ``time_f32``, its timed main path (8 f32 launches of each flash
    kernel a step, no bf16 ones). Then the same program built under AMP,
    names equal, from the same startup state (each parameter in its
    declared dtype): step 1 against the f32 build's (3e-2) and the AMP
    plain path (loss 1e-2, every gradient AMP_GRAD_RTOL; a planted stale
    K/V stage must exceed that), and its timed main path (8 bf16 launches
    of each flash kernel a step, no f32 ones), falling losses, step ms,
    tokens/s, the share of the bf16 peak, peak memory, device time by
    kernel."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import program as tprog
    from paddle_tpu_torch.kernels import flash_attention as fa

    L, tokens = c["n_layers"], c["batch"] * c["seq"]
    tag = f"d{c['d_model']} L{L} H{c['num_heads']}"
    rng = np.random.RandomState(SEED)
    feed = {"ids": rng.randint(0, c["vocab"], size=(c["batch"], c["seq"]))
            .astype("int64"),
            "tgt": rng.randint(0, c["vocab"], size=(c["batch"], c["seq"]))
            .astype("int64")}
    flops = transformer_train_flops(c["batch"], c["seq"], c["d_model"], L,
                                    c["vocab"], c["d_ff"])
    peak_f32, peak_bf16 = _peaks(gpu_name)[0], _peaks(gpu_name)[3]
    start = tprog.Program._uid_counter
    t0 = time.perf_counter()
    main, startup, loss, params_grads = _build_training_program(
        pt, c, pipeline_stack=False)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace())
    exe.run(startup, scope=scope)
    state = _snapshot(scope)
    n_params = sum(scope.get(p.name).numel() for p, _ in params_grads)
    print(f"per-layer {tag}: f32 program of {len(main.global_block.ops)} ops, "
          f"{len(params_grads)} parameters ({n_params / 1e6:.1f} M), built "
          f"and initialised in {time.perf_counter() - t0:.2f} s")
    out = {"config": c, "params": n_params}
    fetch = [loss.name] + [g.name for _, g in params_grads]
    kern = _step_fetches(exe, main, feed, fetch, scope, state)
    if time_f32:
        with _plain_flash(fa):
            plain = _step_fetches(exe, main, feed, fetch, scope, state)
        lk, lp = float(kern[0]), float(plain[0])
        worst = _grad_gap(fetch[1:], kern[1:], plain[1:])
        assert abs(lk - lp) <= PER_LAYER_RTOL * abs(lp), (lk, lp)
        assert worst[0] <= PER_LAYER_RTOL, worst
        print(f"per-layer {tag} f32: step-1 loss kernels {lk:.6f} plain "
              f"{lp:.6f}; worst gradient |kernel - plain| / |plain| "
              f"{worst[0]:.3e} ({worst[1]}) (tol {PER_LAYER_RTOL})")
        del plain
        losses, step_s, counts, peak, profile = _timed_steps(
            exe, main, feed, loss, scope, fa, "per_layer_f32_profile.txt",
            PER_LAYER_GROUPS)
        assert counts == (7 * L,) * 3 + (0,) * 3, counts
        med = float(np.median(step_s[1:]))
        print(f"per-layer {tag} f32: losses {[round(x, 5) for x in losses]};"
              f" step median {med * 1e3:.1f} ms, {tokens / med:.0f} tokens/s,"
              f" {flops / med / peak_f32 * 100:.1f}% of the f32 peak, peak "
              f"memory {peak / 2**30:.2f} GiB; f32 flash launches per step "
              f"{[n // 7 for n in counts[:3]]}, bf16 {counts[3:]}")
        out["f32"] = {"loss_kernels": lk, "loss_plain": lp,
                      "worst_grad_rel": worst, "losses": losses,
                      "step_ms": [x * 1e3 for x in step_s],
                      "step_ms_median": med * 1e3,
                      "tokens_per_s": tokens / med,
                      "f32_peak_share": flops / med / peak_f32,
                      "peak_mem_bytes": peak, "profile": profile}
    l32, g32 = float(kern[0]), kern[1:]
    del kern, exe, scope, main, startup, params_grads
    torch.cuda.empty_cache()

    tprog.Program._uid_counter = start  # the AMP build's names are equal
    with _Amp():
        main, _, loss, params_grads = _build_training_program(
            pt, c, pipeline_stack=False)
        block = main.global_block
        dtypes = {n: block.var(n).dtype for n in state if block.has_var(n)}
        scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace())
        _restore(scope, state, dtypes)
        assert [g.name for _, g in params_grads] == fetch[1:]
        ka = _step_fetches(exe, main, feed, fetch, scope, state, dtypes)
        with _plain_flash(fa):
            pa = _step_fetches(exe, main, feed, fetch, scope, state, dtypes)
        with _plain_flash(fa, planted=True):
            fault = _step_fetches(exe, main, feed, fetch, scope, state,
                                  dtypes)
        del state
        la, lp = float(ka[0]), float(pa[0])
        worst = _grad_gap(fetch[1:], ka[1:], pa[1:])
        planted = _grad_gap(fetch[1:], fault[1:], pa[1:])
        vs_f32 = _grad_gap(fetch[1:], ka[1:], g32)
        del ka, pa, fault, g32
        n_bf16 = sum(d == torch.bfloat16 for d in dtypes.values())
        print(f"per-layer {tag} AMP: step-1 loss {la:.6f}, the f32 build "
              f"{l32:.6f} (rel {abs(la - l32) / abs(l32):.3e}, tol "
              f"{AMP_RTOL}), the AMP plain path {lp:.6f} (rel "
              f"{abs(la - lp) / abs(lp):.3e}, tol {AMP_PLAIN_RTOL}); "
              f"{n_bf16} parameters declared bf16")
        print(f"per-layer {tag} AMP: worst gradient |kernels - plain| / "
              f"|plain| {worst[0]:.3e} ({worst[1]}) (tol {AMP_GRAD_RTOL}); "
              f"a stale K/V stage planted in the plain backward moves them "
              f"{planted[0]:.3e} ({planted[1]}), which must exceed the tol; "
              f"the f32 build's gradients lie {vs_f32[0]:.3e} away "
              f"({vs_f32[1]})")
        assert np.isfinite(la) and abs(la - l32) <= AMP_RTOL * abs(l32)
        assert abs(la - lp) <= AMP_PLAIN_RTOL * abs(lp), (la, lp)
        assert worst[0] <= AMP_GRAD_RTOL, worst
        assert planted[0] > AMP_GRAD_RTOL, (
            "the gradient gate let a stale K/V stage through", planted)
        losses, step_s, counts, peak, profile = _timed_steps(
            exe, main, feed, loss, scope, fa,
            f"per_layer_amp_d{c['d_model']}_profile.txt", PER_LAYER_GROUPS)
    assert counts == (0,) * 3 + (7 * L,) * 3, counts
    med = float(np.median(step_s[1:]))
    dev = profile["device_ms"] if profile else None
    trio = (sum(profile["kernels_ms"][g] for g in (
        "flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"))
        if profile else None)
    print(f"per-layer {tag} AMP: losses {[round(x, 5) for x in losses]}; "
          f"step median {med * 1e3:.1f} ms over 6 steps "
          f"({[round(x * 1e3, 1) for x in step_s]} ms), {tokens / med:.0f} "
          f"tokens/s, {flops / 1e12:.2f} TFLOP/step = "
          f"{flops / med / peak_bf16 * 100:.1f}% of the bf16 peak, peak "
          f"memory {peak / 2**30:.2f} GiB; bf16 flash launches per step "
          f"{[n // 7 for n in counts[3:]]}, f32 {counts[:3]}; device "
          f"{_ms_text(dev, '.1f')} ms of the step's {med * 1e3:.1f} ms on the "
          f"host clock, the bf16 flash trio {_ms_text(trio, '.1f')} ms")
    out["amp"] = {"loss_step1": la, "loss_f32_step1": l32,
                  "loss_plain_step1": lp, "params_bf16": n_bf16,
                  "worst_grad_rel": worst, "planted_grad_rel": planted,
                  "f32_grad_rel": vs_f32,
                  "losses": losses, "step_ms": [x * 1e3 for x in step_s],
                  "step_ms_median": med * 1e3, "tokens_per_s": tokens / med,
                  "tflop_per_step": flops / 1e12,
                  "bf16_peak_share": flops / med / peak_bf16,
                  "peak_mem_bytes": peak, "launches_per_step": [
                      n // 7 for n in counts[3:]],
                  "device_ms": dev, "flash_bf16_ms": trio,
                  "profile": profile}
    del exe, scope, main
    torch.cuda.empty_cache()
    return out


def per_layer_phases(gpu_name):
    """Phase 12: the bf16 flash kernels (a), then the per-layer LM at
    bench.py's transformer in f32 and under AMP (b) and at
    transformer_wide under AMP (c). Returns (the bf16 kernel records, the
    record of each part)."""
    recs = bf16_flash_kernel_phase(gpu_name)
    base = per_layer_lm_phase(gpu_name, PER_LAYER, time_f32=True)
    for rec, n in zip(recs, base["amp"]["launches_per_step"]):
        rec["launches"] = n
    wide = per_layer_lm_phase(gpu_name, PER_LAYER_WIDE, time_f32=False)
    return recs, {"transformer": base, "transformer_wide": wide}


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--forward-only", action="store_true",
                        help="build the kernels and run only phase 3 (the "
                             "flash forward kernel); prints no ok line")
    parser.add_argument("--backward-only", action="store_true",
                        help="build the kernels and run only phase 5 (the "
                             "flash backward kernels); prints no ok line")
    parser.add_argument("--paged-only", action="store_true",
                        help="build the kernels and run only phase 4b (paged "
                             "serving); prints no ok line")
    parser.add_argument("--amp-only", action="store_true",
                        help="build the kernels and run only phase 11 "
                             "(mixed precision: the bf16 kernels, ResNet-50 "
                             "training and serving, the LM); prints no ok "
                             "line")
    parser.add_argument("--per-layer-only", action="store_true",
                        help="build the kernels and run only phase 12 (the "
                             "bf16 flash kernels and the per-layer LM in f32 "
                             "and under AMP); prints no ok line")
    parser.add_argument("--conv-only", action="store_true",
                        help="build the kernels and run only phase 8 (the "
                             "conv-epilogue kernels at ResNet-50's shapes); "
                             "prints no ok line")
    args = parser.parse_args()
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
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_ms_simt", "library_ms")
    if args.amp_only:
        recs, amp = amp_phases(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_amp.json").write_text(json.dumps(
            {"gpu": smi, "kernels": recs, "amp": amp}, indent=1))
        print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                      for r in recs]}))
        print(smi)
        return
    if args.per_layer_only:
        recs, per_layer = per_layer_phases(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_per_layer.json").write_text(json.dumps(
            {"gpu": smi, "kernels": recs, "per_layer": per_layer}, indent=1))
        print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                      for r in recs]}))
        print(smi)
        return
    if args.paged_only:
        paged = paged_serving_phase(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_paged.json").write_text(json.dumps(
            {"gpu": smi, "paged_serving": paged}, indent=1))
        print(smi)
        return
    if args.forward_only or args.backward_only or args.conv_only:
        if args.forward_only:
            recs = [kernel_phase(gpu)]
            out = ROOT / "chiprun_out"
            out.mkdir(exist_ok=True)
            (out / "chip_smoke_forward.json").write_text(json.dumps(
                {"gpu": smi, "kernels": recs}, indent=1))
        elif args.backward_only:
            recs = backward_kernel_phase(gpu)
        else:
            import paddle_tpu_torch as pt

            resnet = _build_resnet(pt, RESNET)
            recs = conv_epilogue_kernel_phase(
                gpu, _fused_shapes(resnet[0], RESNET["batch"]),
                _fused_shapes(resnet[2], RESNET["infer_batch"]))
            out = ROOT / "chiprun_out"
            out.mkdir(exist_ok=True)
            (out / "chip_smoke_conv.json").write_text(json.dumps(
                {"gpu": smi, "kernels": recs}, indent=1))
        print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                      for r in recs]}))
        print(smi)
        return

    kern = kernel_phase(gpu)
    serving = serving_phase(kern, gpu)
    paged = paged_serving_phase(gpu)
    torch.cuda.empty_cache()
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
    attention = attention_rewrite_phase()
    del resnet, scope
    torch.cuda.empty_cache()
    amp_recs, amp = amp_phases(gpu)
    torch.cuda.empty_cache()
    per_layer_recs, per_layer = per_layer_phases(gpu)
    records = [kern] + bwd + conv + amp_recs + per_layer_recs

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernels": records, "serving": serving, "paged_serving": paged,
         "training": training,
         "tf32_check": tf32, "resnet_training": resnet_training,
         "resnet_inference": resnet_inference,
         "attention_rewrite": attention, "amp": amp,
         "per_layer": per_layer, "build_s": built},
        indent=1))
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
