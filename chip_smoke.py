#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --forward-only    # phases 1, 2 and 3 only
    python3 chip_smoke.py --backward-only   # phases 1, 2 and 5 only
    python3 chip_smoke.py --conv-only       # phases 1, 2 and 8 only
    python3 chip_smoke.py --paged-only      # phases 1, 2 and 4b only
    python3 chip_smoke.py --stacked-d256-only  # phases 1, 2 and 6b only
    python3 chip_smoke.py --stacked-d512-only  # phases 1, 2 and 6c only
    python3 chip_smoke.py --stacked-d1024-only  # phases 1, 2 and 6d only
    python3 chip_smoke.py --f32-wide-times  # phases 1, 2 and the f32 D256-D1024 times
    python3 chip_smoke.py --amp-only        # phases 1, 2 and 11 only
    python3 chip_smoke.py --bf16-conv-only  # phases 1, 2 and 11a only
    python3 chip_smoke.py --per-layer-only  # phases 1, 2 and 12 only
    python3 chip_smoke.py --bf16-flash-only # phases 1, 2 and 12a only
    python3 chip_smoke.py --per-layer-d512-only  # phases 1, 2 and 12e only
    python3 chip_smoke.py --per-layer-d1024-only  # phases 1, 2 and 12f only
    python3 chip_smoke.py --bf16-wide-times # phases 1, 2 and 12a's wide-head times
    python3 chip_smoke.py --lstm-only       # phases 1, 2 and 13 only
    python3 chip_smoke.py --zoo-only        # phases 1, 2 and 14 only
    python3 chip_smoke.py --trainer-only    # phases 1, 2 and 15 only
    python3 chip_smoke.py --train-memory-only  # phases 1, 2 and 16 only
    python3 chip_smoke.py --demo-ops-only   # phases 1, 2 and 17 only
    python3 chip_smoke.py --book-only       # phases 1, 2 and 18 only
    python3 chip_smoke.py --optim-only      # phases 1, 2 and 19 only
    python3 chip_smoke.py --precision-only  # phases 1, 2 and 20 only
    python3 chip_smoke.py --decode-plane-only  # phases 1, 2 and 21 only
    python3 chip_smoke.py --ctr-only        # phases 1, 2 and 22 only

Phases, each fatal on failure (nonzero exit, no result line):

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi). Without CUDA it raises.
2. Build: every CUDA kernel of the port, with nvcc from the repository's
   sources (kernels/build.py), all sources started together. Then a
   printed line, not a check: how many of 10^6 ``normal`` draws from one
   key (core/prng.py) differ between the card and the CPU.
3. Flash forward: the kernel against its plain PyTorch version on the
   card at the serving shape (B8 H16 T1024 D64 causal), a ragged case
   with a fully masked row, a D=128 case and the LM training shape (B8
   H8 T2048 D128 causal); at head dims the kernels take zero-padded (16,
   32, 96) and at 70400 batch*heads (past a grid's y limit), the forward
   and both backward kernels, each with a fully masked row; head dims
   past 128: D160, D192 and D256 causal with a fully masked row and B8
   H8 T2048 D256 causal (the instances at 192 and 256 on the tensor
   cores), D320 causal with a fully masked row, a non-causal ragged
   D512, B2 H4 T1000 D512 and B8 H4 T2048 D512 causal (the quarter
   instances at 384 and 512 on the tensor cores), and past 512 D576,
   D1024 and D1152, each causal with a fully masked row and non-causal
   ragged (the slice instance: O in 640-column slices on the grid's z
   axis, Q streamed past 1024). Two launches at the training shape, at
   B2 H4 T1000 D256, D512 and D576, at B8 H8 T2048 D256, at B8 H4 T2048
   D512 and at B8 H2 T2048 D1024 must be bitwise equal. Prints the
   forward's registers, spills (none allowed), shared memory and
   tensor-core opcodes (SASS: HGMMA and HMMA in the instances at 192 and
   256, HMMA in those at 384 and 512 and in the slice instances; no wide
   instance left in any flash library), then times it at the serving,
   training, both D256, both D512, the D576 and the D1024 shapes in turns
   with ``F.scaled_dot_product_attention``'s f32 forward (its backend
   pinned and recorded: kernel, library, library, kernel), with profiler
   device time beside event time, the plain version, the roofline bound
   and, past 128, the wide FMA instance's earlier time
   (``--f32-wide-times`` times just the f32 trio at D256 to D1024).
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
   shape, a ragged case with a fully masked row and the head dims past
   128 of phase 3 (both on the tensor cores at 192 and 256 and on their
   quarter instances at 384 and 512; past 512, padded to a multiple of
   128, both on their slice instances, and D1200 with the owned rows
   streamed); two launches
   of each at the training shape, at B2 H4 T1000 D256, D512 and D576, at
   B8 H8 T2048 D256, at B8 H4 T2048 D512 and at B8 H2 T2048 D1024 must be
   bitwise equal (no atomics). Prints each kernel's registers, spills
   (none allowed) and shared memory and the tensor-core opcodes (HMMA) of
   both kernels at 192, 256, 384 and 512 and of their slice instances (no
   f32 wide instance left), then times them
   beside their plain versions and their bounds, and the pair in turns
   with the backward of ``F.scaled_dot_product_attention`` (its backend
   pinned and recorded): pair, SDPA, SDPA, pair; at both D256, both D512,
   the D576 and the D1024 shapes dq, dkv and the pair in turns with SDPA's
   backward, beside the wide FMA instances' earlier times.
6. Training: the d1024/L8/H8/V16384 LM (d_ff 4096, batch 8 x 2048
   tokens, f32, Adam lr 1e-4) built with the port's ``layers`` and
   ``models.transformer_lm(pipeline_stack=True)``, trained through
   ``AdamOptimizer.minimize`` and ``Executor(CUDAPlace())`` from the
   startup program's seeded weights. Checks one step's loss and every
   parameter gradient against the plain path on the card, that each step
   launched the forward, dq and dkv kernels once per layer, and that the
   loss is finite and falls over the timed steps on one fixed batch.
6b. The stacked LM at head dim 256: phase 6's model at d2048 L8 H8 d_ff
   8192 (transformer_wide's width with 8 heads of 256, as 12d), the same
   batch and optimizer. In f32: step 1 with the kernels against the plain
   path (loss and every gradient, as phase 6), 8 launches a step of the
   flash forward, dq and dkv on their D256 tensor-core instances,
   falling losses, step ms,
   tokens/s, the share of the f32 peak, peak memory and device time by
   kernel (``chiprun_out/stacked_d256_f32_profile.txt``). Built again
   under AMP with the same names from the same startup state: step-1 loss
   within 3e-2 of f32's and 1e-2 of the AMP plain path's, every gradient
   within 1.5e-2 of the AMP plain path's, the same f32 launches (the stack
   casts q/k/v to f32), the same prints
   (``stacked_d256_amp_profile.txt``). Then the same width served
   through ``GenerationEngine(kv_cache="dense")`` and ``Server``: 8
   requests of 700-1024 prompt tokens, 32 new tokens each; every result
   checked, the prefill's attention on the forward's D256 instance
   (launches == layers x prefills), request 0's tokens equal to
   the plain path's on the card.
6c. The stacked LM at head dim 512: 6b with 4 heads of 512 (d2048 L8 H4
   d_ff 8192, as 12e), nothing cut, the same gates in f32 and under AMP;
   8 launches a step of the f32 flash forward, dq and dkv on their D512
   quarter instances, the same prints
   (``stacked_d512_{f32,amp}_profile.txt``), then the same width
   served densely as in 6b (the prefill's attention on the forward's
   D512 quarter instance at ragged lengths).
6d. The stacked LM at head dim 1024: 6c with 2 heads of 1024 (d2048 L8
   H2 d_ff 8192), nothing cut, the same gates in f32 and under AMP; 8
   launches a step of the f32 flash forward, dq and dkv on their slice
   instances, the same prints
   (``stacked_d1024_{f32,amp}_profile.txt``), then the same width served
   densely as in 6b (every prefill's attention one launch a layer of the
   forward's slice instance).
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
    ragged shapes, those the persistent GEMM's walk must get right among
    them (outputs within one bf16 ulp, statistics within 1e-5 of each
    channel's summed magnitude, two launches bitwise equal); every
    instance of the GEMM kernel on wgmma (HGMMA), TMA loads and stores
    (UTMALDG, UTMASTG) and unspilled; timed beside the plain version, the
    bound (bf16 tensor-core rate or bytes), the library (bf16
    torch.matmul, addcmul; device time too) and the previous kernel's
    recorded times;
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
    lengths and a fully masked row, a non-causal case, and past D = 128
    (the three kernels' wgmma instances at 192 and 256): D160, D192,
    D256 causal with a fully masked row, a non-causal
    ragged D256, B8 H8 T2048 D256 causal; past 256 D384 causal with a
    fully masked row, a non-causal ragged D512 and B8 H4 T2048 D512
    causal (all three on their split wgmma instances at 384 and 512) and
    phase 3's cases past 512 and D1200 (all three on their slice wgmma
    instances, dq's and dkv's with Q or K resident up to D1024 and
    streamed past it): each of
    o, dq, dk, dv at most 2x as far from the f32 plain version on the same
    bf16 values as the bf16 plain version is, plus one bf16 ulp of the
    largest |value|, and its error's Frobenius norm at most 1.5x the bf16
    plain version's; a stale K/V stage planted in the plain version at
    the training shape must be refused; lse within 1e-4 of the plain
    version's; two launches at the training shape, at B8 H8 T2048
    D256, at B8 H4 T2048 D512, at D384, at B2 H4 T1000 D576 and at B8 H2
    T2048 D1024 bitwise equal; registers,
    spills (none allowed) and shared memory; in SASS every wgmma instance
    (all three at 64, 128, 192, 256, 384 and 512, and their slice
    instances) runs HGMMA fed by UTMALDG (TMA) and no HMMA, and no wide
    instance is left in any flash library; timed at B8 H8
    T2048 D128 beside the plain versions, the bound at the bf16
    tensor-core rate (TFLOP/s and share of it), the times of the mma.sync
    kernels they replaced and bf16 SDPA (forward; backward for the pair,
    beside dq + dkv); at D256 (B2 H4 T1000 and B8 H8 T2048, causal) the
    forward, dq and dkv timed beside their plain versions, their bound,
    bf16 SDPA and the times of the wide f32-FMA instances that they
    ran there before, and the same past 256 (B2 H4 T1000 D384 and D512,
    B8 H4 T2048 D512, causal) beside SDPA's memory-efficient backend, and
    at B2 H4 T1000 D576 and B8 H2 T2048 D1024 (the slice instances)
    beside the times of the wide FMA dq and dkv they replaced
    (``--bf16-wide-times`` times just these), the forward there also in
    turns with bf16 SDPA;
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
    (``chiprun_out/per_layer_*_profile.txt``: one launch a layer of each
    bf16 flash kernel in the profiled step); (c)
    ``transformer_wide`` (d2048 L8 H16 d_ff 8192) under AMP, the same
    gates (its f32 build runs step 1 only); (d) the same width with 8
    heads of 256 (d2048 L8 H8 d_ff 8192), the same gates, its 8
    launches a step of each flash kernel on their D256 wgmma instances,
    printed beside (c), the same FLOPs at
    head dim 128; (e) the same width with 4 heads of 512 (d2048 L8 H4
    d_ff 8192), the same gates, 8 launches a step of each flash kernel
    on its D512 wgmma instance (dkv as two
    halves, dK and dV, on the grid's z axis), its f32 build's step 1
    with the f32 forward, dq and dkv on their D512 quarter instances,
    printed with step ms, tokens/s and a profiled
    step's device time by kernel (``--per-layer-d512-only`` runs just
    (e)); (f) the same width with 2 heads of 1024 (d2048 L8 H2 d_ff
    8192), the same gates and prints, 8 launches a step of each bf16
    flash kernel on its slice instance, its f32 build's step 1 on the
    f32 slice trio (``--per-layer-d1024-only`` runs just (f)); each
    part's wall seconds printed.

13. The reference benchmark's recurrent rows and its decode row, each
    part fatal on failure: bench.py's ``lstm`` (2 x LSTM text
    classification: embedding, fc + ``dynamic_lstm`` twice, a max
    ``sequence_pool``, a 2-way head; bs64, T 100, hidden 512, vocab
    10000, Adam 1e-3) and ``lstm_varlen`` (the same over a ``lod_level=1``
    feed, IMDB-like lengths padded to the batch's longest: T 200), built
    in f32 and, with the same names from the same state, under AMP (the
    ``lstm`` weights declared bf16). Gate 1: step 1's loss and every
    gradient on the card against the port's own CPU run of the same
    program, state and feed, in f32 and under AMP; Gate 2: the AMP step-1
    loss within 3e-2 of f32's; Gate 3: the loss falls over bench.py's
    timed steps (3 warm, 20 dispatches closed by one blocking fetch);
    Gate 4 (lstm_varlen): Hidden exactly 0 at every padded position and
    LastH equal to Hidden at length - 1. Prints lstm ms/batch and
    ``lstm_vs_baseline`` (the reference's 184 ms/batch on one K40m over
    the port's AMP ms/batch), lstm_varlen tokens/s, ms/batch, max_len and
    padded_flop_waste, and for one step of each: the host's dispatch and
    wall ms, the device ms and the kernel launches (torch.profiler,
    ``chiprun_out/lstm*_profile.txt``). A ``dynamic_gru`` twin of the
    lstm program runs step 1 under Gate 1. Then bench.py's ``decode``:
    ``models.transformer_lm_generate`` at bs8, prefill 1024, 128 new
    tokens, d1024 L8 H8, V16384, in f32 (tokens equal to the plain path's
    on the card) and under AMP: tokens/s and the f32 flash forward's
    launches (one a layer a run).

14. The reference benchmark's image-zoo rows, each part fatal on
    failure, at full width and 224 x 224 x 3, weights from the port's
    seeded startup: bench.py's ``zoo_alexnet``, ``zoo_googlenet`` and
    ``zoo_vgg16`` (``bench_image_model``: 1000 classes, mean
    ``softmax_with_cross_entropy``, Momentum(0.01, 0.9), bs128, a
    RandomState(0) batch on the card, 2 warm steps and 8 timed dispatches
    closed by one blocking fetch), built in f32 and, with the same names
    from the same state, under AMP. Gate 1: step 1 at batch 4 on the card
    against the port's CPU run (loss within 1e-5; each gradient within
    1e-3 of its norm or, where the step is as sensitive as GoogLeNet's
    and VGG-16's, a multiple of the CPU's own move when the images are
    nudged one f32 ulp); Gate 2: the AMP step-1 loss within 3e-2 of f32's;
    Gate 3: every timed loss finite. Prints images/s and ``vs_baseline``
    (over the reference's 383.2 / 111.4 / 30.4 images/s) under AMP, f32
    beside, and for one step of each the host's dispatch and wall ms, the
    device ms and the kernel launches (torch.profiler,
    ``chiprun_out/zoo_*_profile.txt``), peak memory and the share of the
    bf16 or f32 peak. Then ``infer_googlenet`` and ``infer_vgg19``
    (``bench_inference``: built with is_test=False, saved through the
    inference transpiler, loaded, ``Executor.run`` at bs16, 3 warm and 30
    timed batches) in f32 and under AMP, images/s and ``vs_baseline``
    (over 600.94 / 96.75), and the same directory served by
    ``InferenceEngine`` (the replayed batch's ms and its graph's device
    ms). Gate 4: the replay against ``Executor.run``, the card against the
    CPU on a batch of 2, the AMP logits against f32's. None of the port's
    kernels runs in these rows (their convs have a bias and no batch
    norm). Then MobileNet v1 (scale 1.0) saved under
    ``--fused_conv_epilogue`` (13 ``conv1x1_bn_act`` ops) and served at
    bs16 in f32 and under AMP: Gate 5: conv1x1_epilogue (its bf16
    instance under AMP) at each of the 13 pointwise shapes against its
    plain version, timed with CUDA events beside the plain version, the
    bound and torch.matmul; one eager batch of the loaded program launches
    it 13 times; the logits against the plain path; the InferenceEngine
    replay (13 GEMM launches in a profiled replay), images/s and the
    graph's device ms.

15. The trainer plane, each part fatal on failure: (a) bench.py's
    ``transformer`` (the per-layer LM, d1024 L8 H8 d_ff 4096 V16384, 8 x
    2048 tokens, Adam 1e-4, f32) through ``trainer.SGD.train`` over a
    batched reader of rows (ids[2048], tgt[2048]) and ``DataFeeder``: a
    pass of 6 batches with ``async_depth=1`` and, from the same start
    state, with ``async_depth=3``: the losses bitwise equal, 8 launches a
    step of the f32 flash forward, dq and dkv by the counters in each pass
    and in a traced trainer step, no bf16 ones; ms a step of each loop and
    of the executor's own loop (a device-resident feed, one blocking read)
    from the same state, the device ms a step and each loop's host gap;
    (b) the same pass with ``CheckpointConfig(every_n_steps=2, keep=2)``,
    synchronous then in the background: the losses unchanged, 3 saves and
    2 kept, the stall ms a save (``ckpt/stall``) and the bytes of a
    checkpoint; then ``FaultPlan().at(step=3, kind="crash")``, and a new
    pass resumes from the latest checkpoint to the end: every final value
    against the uninterrupted run, bitwise when the two uninterrupted runs
    (sync and pipelined) agree bitwise, else within their largest
    difference; (c) bench.py's ``train_pipeline`` (MLP dim 1024, batch
    256, depth 4, 30 steps, 3 rounds), ``checkpoint`` (dim 512, batch 64,
    every 4) and ``transpiler_resnet50`` (ResNet-50 at batch 16, 224 x
    224, raw against ``inference_pipeline(epilogue=True)``: 33
    conv1x1_epilogue launches a batch, the logits within 1e-4) rows, with
    bench.py's keys; the feeds on the card.

16. The training memory and optimizer plane, each part fatal on
    failure: (a) the per-layer LM of 15 (d1024 L8 H8, 8 x 2048 tokens,
    Adam, f32) built with ``transformer_lm(remat=False)`` and
    ``remat=True`` (each block one recompute segment, its flash forward
    run again in the backward) with the same names, each run from one
    state: step-1 loss within 1e-5 and every gradient within 1e-4 of its
    norm of remat=False's (bitwise equality reported), the flash forward,
    dq and dkv launches of a step by the counters and in a traced step
    (8/8/8 and 16/8/8), ms a step, device ms a step and the peak memory
    (``max_memory_allocated`` after a reset) of each, remat=True's peak
    below remat=False's; (b) the stacked LM of phase 2 (d1024 L8 H8)
    with ``remat`` False, True and "dots", the same numbers (16/8/8 for
    both remat modes: lse is not among the four names "dots" keeps);
    (c) (a)'s remat program with ``minimize(accumulate_steps=4)`` on four
    micro-batches of 2 x 2048: every parameter and Adam state bitwise
    unchanged after each of the first three runs, and after the fourth
    the moments within 1e-4 of a norm and each update within 1e-3 of a
    norm of one step of (a)'s program on the 8 x 2048 rows together;
    (d) bench.py's train_pipeline MLP (dim 1024, batch 256) three steps
    under each of the eight other update ops (adamax, adagrad,
    decayed_adagrad, adadelta, rmsprop, ftrl, proximal_gd,
    proximal_adagrad) on the card against the port's CPU run from the
    same start: losses within 1e-4, each parameter within 1e-3 of its
    move or a multiple of the CPU's own move when the inputs are scaled
    by (1 + 1e-6) (a ReLU that close to zero turns on in one run only); (e) ResNet-50 built plain (224 x 224, batch 32, Momentum)
    trained two steps through ``trainer.SGD(transpile=True)`` under
    ``--fused_conv_epilogue`` (``training_pipeline``: 33
    ``conv1x1_bn_act`` ops, forward op counts before and after) and
    untranspiled from the same state: 33 conv1x1_stats and
    scale_shift_act launches a step, the step-1 losses within 1e-4;
    then bench.py's ``goodput_overhead`` row (the MLP through
    ``SGD.train(async_depth=3)``, goodput off and on, 30 steps, 3
    interleaved rounds) with its keys and each round's overhead, not
    gated. Each kernel record of the ``kernels`` line carries its
    launches a step on these paths (``launches_phase16``).
17. The op plane the demos lack, each part fatal on failure: (a) all 76
    ops of the slice (32 activation, 30 tensor, 12 loss ops, ``dot`` and
    ``cos_sim``; ``cross_entropy`` hard and soft) on the card at the
    d1024 LM's activation width, [2048, 1024], in f32 and bf16, with tie
    points mixed in, against the port's own CPU run of the same
    function: the forward and, by ``torch.autograd.grad``, the gradient
    of every float input; the piecewise-linear, comparison, logic, index
    and shape ops bit for bit; the others within 4 f32 or 1 bf16 ulps,
    each output read by element (the transcendental forwards and
    gradients, the forwards of the sigmoid and tanh families, softplus,
    elu and of the losses whose terms share one sign) or in ulps of the
    tensor's largest |value| (row sums and cancelling results: those
    families' gradients, tanh_shrink, log_softmax, the other losses),
    with three f32 outputs that round again after a 4-ulp gap held at 5
    or 6 ulps; (b) ``demos/gan_mnist.py``'s two programs built with the
    port (Z 64, hidden 256, 784 pixels, batch 64, Adam 2e-4 with beta1
    0.5, each ``minimize`` with its ``parameter_list``, one scope)
    trained through its full loop of 5 passes of up to 200 batches (the
    8192 synthetic samples give 128; a new shuffle each pass), two G
    steps a D step, over the port's synthetic MNIST: the final losses
    within the demo's bands (0.05 < d < 3.5, 0.02 < g < 6.0), the D
    parameters bitwise unchanged by the G steps of the first three
    rounds and of each pass's last, Adam only on each program's list,
    the first three rounds' losses within 1e-5 of the port's CPU run
    from the same state and the parameters after them within 4 times the
    CPU's own move under an image nudge of (1 + 1e-6); (c)
    ``demos/vae_mnist.py``'s program (batch 128, Z 16, Adam 1e-3)
    through 5 passes of up to 200 steps (64 a pass): the last loss below
    the first, the ``for_test`` clone's reconstruction in [0, 1], the
    first three losses within 1e-5 of the CPU's (the noise from the RNG
    plane); (d) ms a step of the D, G and VAE steps, and one profiled
    step of each: wall ms beside device ms and kernel launches (the
    steps are host-bound). None of the six kernels runs here (their
    counters are unchanged).
18. The book plane (``--book-only``): (a) each chapter of
    ``tests/test_book.py`` (fit_a_line, word2vec, recommender, the
    sequence_conv and stacked-LSTM sentiment classifiers, the
    sequence_conv + CRF label_semantic_roles with its ChunkEvaluator,
    machine_translation with the fused beam decoder), built as that file
    builds it and trained on the card through DataFeeder + minibatch
    with its epochs, batch sizes and synthetic readers, against that
    file's thresholds; each chapter's first 5 losses within 1e-4 of the
    port's CPU run from the same startup weights; (b) the book's SRL
    model ``db_lstm`` at its widths (word_dim 32, hidden_dim 512, depth
    8, the CRF's transition shared as ``crfw``) over the synthetic
    conll05, 3 epochs from the same weights with SGD at the book's 1e-4
    and with Adam at 2e-3 (reported): the losses and the chunk F1 after
    each epoch, ms a step beside device ms; (c) ``linear_chain_crf`` (NLL and both
    gradients), ``crf_decoding`` and ``chunk_eval`` at db_lstm's
    emission shape (b 32, T 17, 9 tags), ``sequence_conv`` at [32, 128,
    512] with context 5 (forward and both gradients), and
    ``beam_search_decoder`` (GRU and LSTM) at nmt_seq2seq's widths, beam
    4, 12 steps, on the card against the port's CPU run: floats within
    1e-5 of the largest |value|, Viterbi paths exact but where the two
    paths' f64 scores lie within 1e-4 (counted), ids, lengths and counts
    exact, beam scores within 4 f32 ulps of the largest |score| a step;
    (d) ``demos/sequence_tagging_crf.py``'s and ``demos/nmt_seq2seq.py``'s
    programs at their own sizes against their own gates. None of the six
    kernels runs here.
19. The optimizer plane and the chunked fused head (``--optim-only``):
    (a) ``demos/gpt_modern.py``'s program and loop at its own size (the
    per-layer LM d64 L2, 4 heads over 2 K/V heads with RoPE and RMSNorm,
    headless into ``fused_head_cross_entropy`` with chunk 128 over vocab
    211 and label smoothing 0.05, AdamW under ``linear_lr_warmup(
    cosine_decay(...))``, 150 steps of 32 x 64 tokens): the eval clone's
    next-token accuracy over 0.4 as the demo asserts, the learning rate
    a step (the scope's int32 counter read back) within 4 f32 ulps of
    the schedule's peak of the closed form, the first 5 losses within
    1e-4 of the port's CPU run from the same weights, ms a step beside a
    profiled step's device ms and launches, 2 launches a step of each
    f32 flash kernel (head dim 16 on the 64 instance) by the counters and
    in a trace; (b) bench.py's ``bench_transformer_step(fused_head=True)``
    at its size (per-layer d1024 L8 H8, V16384, 8 x 2048 tokens, Adam,
    f32) beside the same row unfused, from the same weights: step 1's
    loss within LOSS_RTOL and every gradient within GRAD_RTOL of a norm
    of the unfused row's, then each row's ms a step, device ms, peak
    memory and flash launches (8 a step each); (c) every ``lr_schedule``
    policy over steps 0-299 and ``lr_warmup``, each clip attr, L1 and L2
    decay (global and a parameter's own), ``accumulate_steps=4`` under a
    schedule, ``ModelAverage.apply`` and the pruning hook on a small MLP
    on the card against the port's CPU run (floats within 1e-5 of the
    largest |value|, schedules within 4 ulps of their peaks). The flash
    records of the ``kernels`` line carry their launches a step here
    (``launches_phase19``).
20. The precision policy, the flags and the v2 facade
    (``--precision-only``). Phases 1-19 run under ``--mxu_precision=
    highest`` (f32-accurate: full f32 library products, the 3xTF32 conv
    GEMM kernels; set and printed after the build), as before the policy
    was ported; phase 20 runs ``default`` (TF32) beside it. (a) ``mul``,
    ``matmul`` and ``conv2d`` (3x3, and the 1x1 dot path) at ResNet-50
    shapes, forward and both gradients, under both policies against the
    CPU in f64: highest within phase 7's TF32_RTOL; default within a
    tolerance derived from TF32's rounding (printed before the run) and
    apart from highest (TF32 engaged). (b) The 1xTF32 instances of
    ``conv1x1_stats`` and ``conv1x1_epilogue`` (``conv1x1_tf32_kernel``,
    ``round_w_kernel``) at every distinct shape of the ResNet-50 step
    (batch 256) and served batch (16) against their TF32 plain versions,
    two launches bitwise equal, ptxas and SASS (HGMMA, no spills), timed
    in turns with ``torch.matmul`` under cuBLAS TF32 beside their bound
    at the TF32 rate: records ``conv1x1_stats_tf32`` and
    ``conv1x1_epilogue_tf32`` in the ``kernels`` line, with
    ``launches_phase20``. (c) Phase 19's unfused LM row (per-layer d1024
    L8 H8, V16384, 8 x 2048 tokens, Adam, f32) under both policies from
    the same weights: step 1's loss and gradients held at a stated TF32
    tolerance, ms a step, device ms and the f32 GEMMs' device ms, 8
    launches a step of each flash kernel under both. (d) ResNet-50 at
    batch 256 with the fused epilogues under both policies from the same
    weights: the loss and gradients within a multiple of highest's own
    move under a half-TF32-ulp nudge of the images, ms a step, the conv
    GEMM's device ms by instance (33 launches a step of the 1xTF32
    kernel under default, of the 3xTF32 one under highest). (e)
    ``parse_flags``/``set_flags`` flip the policy and an explicit
    ``set_mxu_precision`` wins; an ``InferenceEngine`` of ResNet-50's
    for_test clone built under default captures a new graph after a flip
    to highest, each replay equal to the eager run under its policy, each
    on its own instance of the conv GEMM; bf16 and fp8 parameters through
    ``save_params``/``load_params`` on the card bit for bit. (f)
    ``demos/mnist_v2.py``, ``demos/traffic_prediction.py`` and
    ``demos/quick_start.py`` (``cnn``, ``lstm``) through
    ``paddle_tpu_torch.v2``, their loops at their own sizes (but one pass
    of traffic_prediction's eight): the first 5
    losses within 1e-4 of the port's CPU run from the same weights, each
    demo's own closing output, ms a step beside a step's device ms and
    launches.

21. The decode plane (``--decode-plane-only``), under ``highest``. (a)
    The d1024 L8 H16 V16384 LM (random weights from the seed), batch 4 x
    prompt 512, through Executor.run: ``transformer_lm_beam_search``
    (beam 4, 64 new tokens, GNMT penalty 0.6),
    ``transformer_lm_speculative_generate`` (draft_layers 2, gamma 4,
    the draft head a copy of the target's) and ``transformer_lm_generate``;
    the speculative output equals greedy token for token but at a near
    tie (the top two logits within 1e-5, relative; both printed); each
    prefill launches the flash forward 8 times (asserted); wall ms beside
    device ms. (b) ``PagedGenerationEngine(beam_width=4)`` at that width:
    ``generate_beam``'s best beam equals (a)'s op on the same prompt;
    then 4 greedy and 4 beam-4 requests in one continuous batch through
    ``Server`` (forks and shared pages > 0, the captured decode graph
    with its TopV/TopI plane, TPOT). (c) Transformer-base (Vaswani et
    al. 2017, Table 3 base: d512, 6 layers, 8 heads, d_ff 2048, a shared
    vocabulary of 37,000) at 256 source and target positions, batch 32:
    3 Adam steps under AMP and 3 in f32 through
    ``transformer_nmt_teacher`` (6 launches a step of each f32 flash
    kernel, asserted), then the trained scope served by
    ``Seq2SeqGenerationEngine(slots=16, page_size=16, beam_width=4)``:
    ``translate`` of 16 sources of 32-128 tokens, 32 new tokens each and
    no eos (one encode a source; every token the teacher op's argmax
    re-run on its own output, but at a near tie), ``translate_beam``
    (forks > 0), TTFT and TPOT. (d)
    ``demos/transformer_lm.py`` (speculative = greedy) and
    ``demos/nmt_transformer.py`` at their own sizes, the NMT demo's loop
    cut to its FAST mode's 12 steps (its 700 took 47 s on an H100). The
    flash records of the ``kernels`` line
    carry their launches on these paths (``launches_phase21``).

22. The row-sparse gradient plane and Wide&Deep CTR (``--ctr-only``),
    under ``highest``, all f32. (a) bench.py's ``online`` row, part (a):
    an embedding at V 10^6, D 16 over 8 slots, a mean loss, Adagrad 0.05;
    the dense and the sparse step at batch 128 and 32 from one state: the
    untouched rows and moments bit for bit unchanged, the touched rows
    within 1e-6 of the dense step's, the sparse step's peak allocation
    above the resident state below one [V, D] f32 table, the sparse
    update ops (the lookup's row gradient, the dedup, the scatters) under
    ``torch.cuda.set_sync_debug_mode("error")`` (the whole step's result
    printed); wall ms, device ms, launches and peak of each step. (b)
    ``models.wide_deep`` (embed_dim 16, hidden (64, 32)) at V 10^6 on
    ``dataset.ctr``'s 8 slots and 4 dense features, batch 512,
    ``is_sparse``, Adagrad 0.05, 200 steps with ``Auc`` reset before the
    last 50: the first 5 losses within 1e-4 of the port's CPU run from
    the same weights, the loss falling, AUC > 0.65; ms a step (wall,
    device), launches and peak, beside ``is_sparse=False``. (c) The
    program pruned to ids, dense -> prob served by ``InferenceEngine``
    (CUDA graphs at batches 1 and 64): its probabilities within 1e-6 of
    the executor's forward on the card, p50 latency a batch. (d)
    ``demos/quick_start.py lr`` through ``paddle_tpu_torch.v2`` at its
    FAST size (256 samples, one pass, 4 batches of 64): the losses within
    1e-4 of the CPU run's, the demo's closing output, ms a step beside
    device ms. (e) The seven metric ops and ``addto`` on the card against
    the CPU: counts and sums exact, the other floats within 1e-5. None of
    the six kernels runs here (every counter unchanged, asserted;
    ``launches_phase22``).

Prints a ``{"kernels": [...]}`` line and the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import itertools
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

# head dims past 128 (D zero-padded to a multiple of 64, in 257-512 to
# 384 or 512, and past 512 to a multiple of 128). In f32 the forward, dq
# and dkv run their tensor-core instances at 192 and 256 (D160 and D192
# pad to 192) and their quarter instances at 384 and 512; past 512 their
# slice instances on the tensor cores (the forward's O in 640-column
# slices on the grid's z axis, dq's and dkv's outputs in 1024-column
# ones). Causal with a fully masked row at D160, D192, D256
# and D320, the stacked LM's attention at head dims 256 (D256_TRAIN) and
# 512 (D512_TRAIN), a non-causal ragged D512 with a fully masked row,
# WIDE_D512, and past 512 D576, D1024 and D1152 (Q streamed past 1024),
# each causal with a fully masked row and non-causal ragged, and for dq
# and dkv D1200 (their owned rows streamed past 1152). Phase 3 holds
# the forward, phase 5 dq and dkv against their plain versions; both
# check two launches bitwise equal at WIDE_TIMED, D256_TRAIN, WIDE_D512,
# D512_TRAIN, WIDE_D576 and D1024_TRAIN and time them there
WIDE_TIMED = (2, 4, 1000, 256, True, None)
# B8 H8 T2048 D256 causal: the attention of the LMs at d2048 H8 (phase 6b,
# 12d); B8 H4 T2048 D512 causal: the LMs' at d2048 H4 (6c, 12e)
D256_TRAIN = (8, 8, 2048, 256, True, None)
D512_TRAIN = (8, 4, 2048, 512, True, None)
# WIDE_TIMED's shape at head dims 384, 512 and 576
WIDE_D384 = (2, 4, 1000, 384, True, None)
WIDE_D512 = (2, 4, 1000, 512, True, None)
WIDE_D576 = (2, 4, 1000, 576, True, None)
# B8 H2 T2048 D1024 causal: the same work as D512_TRAIN at head dim 1024
# (the stacked LM at d2048 H2, phase 6d)
D1024_TRAIN = (8, 2, 2048, 1024, True, None)
# past 512: the forward's slice instances at Dp 640, 1024 and 1152
SLICE_CASES = [
    (2, 4, 1000, 576, True, [1000, 0]),
    (2, 2, 300, 576, False, [300, 0]),
    (2, 2, 1000, 1024, True, [1000, 0]),
    (2, 2, 300, 1000, False, [300, 117]),
    (2, 2, 600, 1152, True, [600, 0]),
    (2, 2, 300, 1100, False, [300, 77]),
]
# past the backward slice instances' resident owned rows (Dp 1152): Q and
# dO (dq), K and V (dkv) streamed with each step
BWD_STREAMED_CASES = [(2, 2, 300, 1200, True, [300, 0])]
WIDE_CASES = [
    (2, 4, 1000, 160, True, [1000, 0]),
    (2, 4, 1000, 192, True, [1000, 0]),
    (2, 4, 1000, 256, True, [1000, 0]),
    D256_TRAIN,
    (2, 4, 1000, 320, True, [1000, 0]),
    (2, 2, 300, 512, False, [300, 0]),
    WIDE_D512,
    D512_TRAIN,
] + SLICE_CASES + BWD_STREAMED_CASES
# a padded head dim each bf16 dq and dkv slice instance takes (<1>: Q or
# K resident up to Dp 1024, <0>: streamed past it), to look up its shared
# memory
BF16_BWD_SLICE_DP = {1: 1024, 0: 1280}


def _bf16_smem(name, args):
    """Dynamic shared memory of the bf16 flash instance ``name<args>`` at
    a head dim it takes."""
    from paddle_tpu_torch.kernels import build

    lib = build.load("flash_attention_bf16")
    fwd = "fwd" in name
    D = ((SLICE_DP if fwd else BF16_BWD_SLICE_DP)[args[0]]
         if "slice" in name else args[0])
    return lib.paddle_flash_attention_bf16_smem_bytes(
        0 if fwd else 1 if "dq" in name else 2, D)
# the f32 instances at 192 and 256 on the tensor cores: in SASS, HMMA
# (P V, dS K, dS^T Q, P^T dO and the backward's S, dP on mma.sync) and,
# for the forward, HGMMA (S on wgmma)
F32_SPLIT_SASS = tuple(f"flash_{k}_tf32x3_split_kernel<{d}>"
                       for k in ("fwd", "bwd_dq", "bwd_dkv")
                       for d in (192, 256))
# the f32 forward's, dq's and dkv's quarter instances at 384 and 512:
# every product on mma.sync (HMMA)
F32_QUARTER_SASS = tuple(f"flash_{k}_tf32x3_quarter_kernel<{d}>"
                         for k in ("fwd", "bwd_dq", "bwd_dkv")
                         for d in (384, 512))
# the f32 forward's slice instances past 512 (<1>: Q resident up to Dp
# 1024, <0>: streamed past it): every product on mma.sync (HMMA)
F32_SLICE_SASS = ("flash_fwd_tf32x3_slice_kernel<1>",
                  "flash_fwd_tf32x3_slice_kernel<0>")
# the f32 dq's and dkv's slice instances past 512 (<1>: the owned rows
# resident up to Dp 1152, <0>: streamed past it): every product on
# mma.sync (HMMA)
F32_SLICE_BWD_SASS = tuple(f"flash_bwd_{k}_tf32x3_slice_kernel<{r}>"
                           for k in ("dq", "dkv") for r in (1, 0))
# a padded head dim each slice instance takes (<1>, <0>), to look up its
# shared memory: the forward's, and dq's and dkv's
SLICE_DP = {1: 1024, 0: 1152}
BWD_SLICE_DP = {1: 1024, 0: 1280}
# the times, in ms, of the wide f32-FMA instances (flash_wide.cuh) that
# the f32 forward, dq and dkv ran at WIDE_TIMED and D256_TRAIN before
# they took their tensor-core instances there, and at WIDE_D512 and
# D512_TRAIN before their quarter instances, on an NVIDIA H100 80GB HBM3
# at 700 W (``--f32-wide-times`` once on the commit before each: the
# forward's and dq's before their split instances, dkv's before its, the
# forward's and dq's D512 times before their quarter instances, dkv's
# D512 times on that same commit), and the trio's at WIDE_D576 and
# D1024_TRAIN before their slice instances (the mean of two turns on the
# commit before each: the forward's, then dq's and dkv's)
F32_WIDE_PREVIOUS_MS = {WIDE_TIMED: (0.514, 0.833, 0.705),
                        D256_TRAIN: (8.264, 13.977, 19.210),
                        WIDE_D512: (1.288, 2.266, 2.282),
                        D512_TRAIN: (13.480, 25.622, 35.201),
                        WIDE_D576: (1.592, 3.250, 4.108),
                        D1024_TRAIN: (25.506, 48.852, 65.636)}


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

    errs, bwd_errs, errs_d256, errs_d512, errs_slice = [], [], [], [], []
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
        if 128 < D <= 256:  # the tensor-core instances at 192 and 256
            errs_d256.append(err)
        elif 256 < D <= 512:  # the quarter instances at 384 and 512
            errs_d512.append(err)
        elif D > 512:  # the slice instances
            errs_slice.append(err)
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
    for B, H, T, D, causal, _ in (WIDE_TIMED, D256_TRAIN, WIDE_D512,
                                  D512_TRAIN, WIDE_D576, D1024_TRAIN):
        q, k, v = (randn(B, H, T, D) for _ in range(3))
        first, second = (fa.flash_forward(q, k, v, None, True)
                         for _ in range(2))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (
            f"two flash forward launches at D{D} on the same inputs differ")
        print(f"flash_attention_fwd B{B} H{H} T{T} D{D} causal: two "
              f"launches are bitwise equal")
        del q, k, v, first, second
    usage = _forward_kernel_usage()
    assert not any(u.get("spill_store_bytes") or u.get("spill_load_bytes")
                   for u in usage.values()), f"the forward spills: {usage}"
    sass = _sass_counts("flash_attention_fwd", "flash_fwd")
    _assert_no_wide_route()
    for key, counts in sass.items():
        assert counts["HMMA"] + counts["HGMMA"] > 0, (
            f"{key} runs no product on the tensor cores: {counts}")
    for key in F32_SPLIT_SASS[:2]:  # S on wgmma, P V on mma.sync
        assert sass[key]["HGMMA"] > 0 and sass[key]["HMMA"] > 0, (
            key, sass.get(key))
    for key in F32_QUARTER_SASS[:2] + F32_SLICE_SASS:  # all on mma.sync
        assert sass[key]["HMMA"] > 0, (key, sass.get(key))

    timed = {name: _time_forward(F, fa, randn, gpu_name, *FWD_CASES[i])
             for name, i in (("serving", 0), ("training", 3))}
    for name, shape in (("wide", WIDE_TIMED), ("d256_train", D256_TRAIN),
                        ("d512", WIDE_D512), ("d512_train", D512_TRAIN),
                        ("d576", WIDE_D576), ("d1024_train", D1024_TRAIN)):
        timed[name] = _time_forward(F, fa, randn, gpu_name, *shape)
        timed[name]["previous_ms"] = was = F32_WIDE_PREVIOUS_MS[shape][0]
        print(f"flash_attention_fwd at {timed[name]['shape']}: "
              f"{timed[name]['ms']:.3f} ms, "
              f"{timed[name]['bound_ms'] / timed[name]['ms'] * 100:.1f}% of "
              f"the bound; was {_ms_text(was)} on the wide FMA instance"
              + (f" ({was / timed[name]['ms']:.2f}x)" if was else ""))
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
        "d256_train_shape": timed["d256_train"],
        "d512_shape": timed["d512"], "d512_train_shape": timed["d512_train"],
        "d576_shape": timed["d576"],
        "d1024_train_shape": timed["d1024_train"],
        "max_abs_err_d256": max(errs_d256),
        "max_abs_err_d512": max(errs_d512),
        "max_abs_err_slice": max(errs_slice), "ptxas": usage, "sass": sass,
    }


def _assert_no_wide_route():
    """No wide (f32 FMA) instance is left in the flash libraries'
    binaries: past head dim 512 the forward, dq and dkv of either dtype
    have only their slice instances on the tensor cores, so no path can
    launch a wide one."""
    libs = ("flash_attention_fwd", "flash_attention_bwd",
            "flash_attention_bf16")
    for lib in libs:
        left = _sass_counts(lib, "_wide")
        assert not left, f"{lib} still holds a wide instance: {sorted(left)}"
    print(f"flash kernels: no wide instance in {', '.join(libs)} (SASS)")


def slice_record(rec, dtype, launches):
    """The forward's slice instance past head dim 512 (``dtype`` "f32":
    phase 3's record ``rec``, on phase 6d's main path with ``launches``
    a step; "bf16": phase 12a's, on 12f's main path, which sets its
    launches), timed at D1024_TRAIN in turns with SDPA."""
    return {"name": "flash_attention_fwd_slice" + (
                "" if dtype == "f32" else "_bf16"),
            "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/" + (
                "flash_attention_fwd.cu" if dtype == "f32"
                else "flash_attention_bf16.cu"),
            "replaces": "paddle_tpu/kernels/flash_attention.py:229",
            "launches": launches, "max_abs_err": rec["max_abs_err_slice"],
            **rec["d1024_train_shape"], "d576_shape": rec["d576_shape"],
            "ptxas": {k: u for k, u in rec["ptxas"].items() if "slice" in k}}


def _time_forward(F, fa, randn, gpu_name, B, H, T, D, causal, lengths,
                  dtype=None):
    """The forward kernel at one shape in turns with SDPA's forward in
    the same dtype (f32, or ``dtype``; its backend pinned: kernel,
    library, library, kernel), each with its device time from a profiler
    trace, beside the plain version and the bound."""
    import torch
    from torch.nn.attention import sdpa_kernel

    assert lengths is None and causal
    dtype = dtype or torch.float32
    q, k, v = (randn(B, H, T, D).to(dtype) for _ in range(3))

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
    bf16 = dtype == torch.bfloat16
    flops, nbytes = _attention_work(B, H, T, T, D, True, None,
                                    2 if bf16 else 4)
    bound_ms, bound_by, bound_simt = _bound(flops, nbytes, gpu_name,
                                            bf16=bf16)
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    shape = f"B{B} H{H} T{T} D{D} causal {'bf16' if bf16 else 'f32'}"
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
    return _kernel_usage(
        "flash_attention_fwd",
        lambda name, args: smem(SLICE_DP[args[0]] if "slice" in name
                                else args[0]),
        match="flash_fwd")


def serving_phase(record, gpu_name):
    import numpy as np
    import torch

    from paddle_tpu_torch import init_params
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import TransformerLM
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

    # the served tokens against the plain path on the card (greedy, so
    # the tokens must be equal)
    n_check = 8
    ref = _plain_tokens(model, spec, prompts[0], n_check)
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


def _plain_tokens(model, spec, prompt, n):
    """The first ``n`` greedy tokens after ``prompt`` (numpy int64), one
    shot on the card with the flash kernel swapped for its plain
    version."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.ops import pipeline_ops

    def plain(q, k, v, causal=False):
        return fa.flash_attention_reference(q, k, v, causal=causal)[0]

    kernel = pipeline_ops.flash_attention
    pipeline_ops.flash_attention = plain
    try:
        with torch.no_grad():
            ref = pipeline_ops.transformer_stack_generate(
                {"num_heads": spec.num_heads, "max_new_tokens": n},
                dict(model.shared_lm_inputs(),
                     Prompt=[torch.from_numpy(prompt[None]).cuda()]))["Out"][0]
    finally:
        pipeline_ops.flash_attention = kernel
    return ref[0, prompt.size:].cpu().numpy()


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
        eager = eng._decode_step_eager(feed)[0]
        t1 = time.perf_counter()
        ke, ve = eng.cache_k.clone(), eng.cache_v.clone()
        eng.cache_k.copy_(k0)
        eng.cache_v.copy_(v0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        replayed = eng._decode_step_replay(feed)[0]
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
    errs_d256 = {"dq": [], "dkv": []}  # 128 < D <= 256
    errs_d512 = {"dq": [], "dkv": []}  # 256 < D <= 512
    errs_slice = {"dq": [], "dkv": []}  # D > 512: the slice instances
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
            if 128 < D <= 256:
                errs_d256[name].append(err)
            elif 256 < D <= 512:
                errs_d512[name].append(err)
            elif D > 512:
                errs_slice[name].append(err)
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
    wide = {name: _time_wide_backward(F, fa, randn, gpu_name, *shape)
            for name, shape in (("wide", WIDE_TIMED),
                                ("d256_train", D256_TRAIN),
                                ("d512", WIDE_D512),
                                ("d512_train", D512_TRAIN),
                                ("d576", WIDE_D576),
                                ("d1024_train", D1024_TRAIN))}
    usage = _backward_kernel_usage()
    assert not any(u.get("spill_store_bytes") or u.get("spill_load_bytes")
                   for u in usage.values()), f"the backward spills: {usage}"
    sass = _sass_counts("flash_attention_bwd", "flash_bwd")
    for key in (F32_SPLIT_SASS[2:] + F32_QUARTER_SASS[2:]
                + F32_SLICE_BWD_SASS):
        assert sass[key]["HMMA"] > 0, (key, sass.get(key))  # on mma.sync
    assert not any("wide" in key for key in sass), sorted(sass)
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
            "fwd_ms_training_shape": fwd_ms, "ptxas": usage, "sass": sass,
            "wide_shape": wide["wide"][name],
            "d256_train_shape": wide["d256_train"][name],
            "d512_shape": wide["d512"][name],
            "d512_train_shape": wide["d512_train"][name],
            "d576_shape": wide["d576"][name],
            "d1024_train_shape": wide["d1024_train"][name],
            "max_abs_err_d256": max(errs_d256[name]),
            "max_abs_err_d512": max(errs_d512[name]),
            "max_abs_err_d1024": max(errs_slice[name]),
        })
    return records


def _time_wide_backward(F, fa, randn, gpu_name, B, H, T, D, causal, lengths):
    """dq and dkv past head dim 128 at one shape: two launches of each
    bitwise equal; dq, dkv and the pair timed in turns with SDPA's f32
    backward (its backend pinned: kernels, library, library, kernels),
    each kernel beside its plain version, its bound and the wide FMA
    instance's earlier time (F32_WIDE_PREVIOUS_MS)."""
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
            f"two {name} launches at D{D} on the same inputs differ")
        del first, second

    def pair():
        kernels["dq"]()
        kernels["dkv"]()

    runs = dict(kernels, pair=pair)
    turns = {name: [] for name in runs}
    lib_turns = []
    for turn in range(2):
        for name, fn in runs.items():
            turns[name].append(_cuda_ms(fn, iters=10))
        if not turn:
            for _ in range(2):
                lib, backend = _sdpa_backward_ms(F, q, k, v, do)
                lib_turns.append(lib)
    library_ms = sum(lib_turns) / 2
    times = {name: sum(t) / 2 for name, t in turns.items()}
    shape = f"B{B} H{H} T{T} D{D} causal f32"
    out = {}
    for i, name in enumerate(kernels):
        ms = times[name]
        plain_ms = _cuda_ms(plain[name], iters=5)
        flops, nbytes = _backward_work(name, B, H, T, T, D, True, None)
        bound_ms, bound_by, bound_simt = _bound(flops, nbytes, gpu_name)
        was = F32_WIDE_PREVIOUS_MS.get((B, H, T, D, causal, lengths),
                                       (None,) * 3)[1 + i]
        out[name] = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_ms_simt": bound_simt,
                     "library_ms": library_ms,
                     "library": f"sdpa backward, {backend}",
                     "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                     "tflop_per_s": flops / ms / 1e9,
                     "bound_share": bound_ms / ms,
                     "previous_ms": was, "turns_ms": turns[name],
                     "pair_turns_ms": turns["pair"],
                     "library_turns_ms": lib_turns}
        print(f"flash_attention_bwd_{name} (tensor cores) {shape}: two "
              f"launches bitwise equal; {ms:.3f} ms"
              f" (in turns {[round(x, 4) for x in turns[name]]})"
              f", {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{bound_ms / ms * 100:.1f}% of the bound {bound_ms:.4f} ms "
              f"({bound_by}; {bound_simt:.4f} at the CUDA cores' f32 rate); "
              f"plain {plain_ms:.3f} ms"
              + ("" if was is None else f"; was {was:.3f} on the wide FMA "
                 "instance"))
    print(f"flash_attention_bwd {shape}: in turns, dq + dkv "
          f"{[round(x, 4) for x in turns['pair']]} ms and SDPA backward "
          f"({backend}) {[round(x, 4) for x in lib_turns]} ms: pair / SDPA "
          f"{times['pair'] / library_ms:.3f}")
    return out


def _f32_wide_times(gpu_name):
    """The f32 forward, dq and dkv at WIDE_TIMED and D256_TRAIN (the split
    instances), at WIDE_D384, WIDE_D512 and D512_TRAIN (the quarter
    instances), and at WIDE_D576 and D1024_TRAIN (the slice instances),
    each timed with CUDA events beside its plain version, its
    bound (3xTF32 rate) and f32 SDPA's fastest backend (the forward; the backward for dq and dkv
    together); no checks. Only the flash wrappers' public entry points
    run, so the same lines time an earlier commit's instances. Returns
    {shape: [the three kernels' rows]}."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    out = {}
    for B, H, T, D, causal, lengths in (WIDE_TIMED, D256_TRAIN, WIDE_D384,
                                        WIDE_D512, D512_TRAIN, WIDE_D576,
                                        D1024_TRAIN):
        q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=gen)
                       for _ in range(4))
        o, lse = fa.flash_forward(q, k, v, None, causal)
        di = fa._row_dot(do, o)
        sdpa = (_sdpa_fastest(F, q, k, v, required=False),
                _sdpa_fastest(F, q, k, v, do, required=False))
        runs = (("fwd", lambda: fa.flash_forward(q, k, v, None, causal),
                 lambda: fa.flash_attention_reference(q, k, v, None,
                                                      causal)),
                ("dq", lambda: fa.flash_dq(q, k, v, lse, di, do, None,
                                           causal),
                 lambda: fa.flash_dq_reference(q, k, v, lse, di, do, None,
                                               causal)),
                ("dkv", lambda: fa.flash_dkv(q, k, v, lse, di, do, None,
                                             causal),
                 lambda: fa.flash_dkv_reference(q, k, v, lse, di, do, None,
                                                causal)))
        shape = _case_text(B, H, T, D, causal, lengths)
        rows = []
        for name, run, ref in runs:
            ms = _cuda_ms(run, iters=10)
            plain_ms = _cuda_ms(ref, iters=3, warmup=1)
            if name == "fwd":
                flops, nbytes = _attention_work(B, H, T, T, D, causal, None)
            else:
                flops, nbytes = _backward_work(name, B, H, T, T, D, causal,
                                               None)
            bound, bound_by, _ = _bound(flops, nbytes, gpu_name)
            library, backend = sdpa[name != "fwd"]
            lib_text = ("no backend takes these inputs" if library is None
                        else f"{'forward' if name == 'fwd' else 'backward'}"
                        f" {library:.3f} ({backend})")
            print(f"f32 flash {name} at {shape}: {ms:.3f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{bound / ms * 100:.1f}% of the bound {bound:.4f} ms, "
                  f"{bound_by}), plain {plain_ms:.3f} ms; f32 SDPA "
                  f"{lib_text}")
            rows.append({"kernel": name, "shape": shape, "ms": ms,
                         "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": bound_by,
                         "library_ms": library,
                         "library": f"F.scaled_dot_product_attention f32 "
                                    f"{lib_text}"})
        out[shape] = rows
        del q, k, v, do, o, lse, di
        torch.cuda.empty_cache()
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


def _slice_kernel_usage():
    """Registers, spills and shared memory of the slice instances past
    head dim 512: the f32 forward's and the bf16 forward's, dq's and
    dkv's (none on a commit before them)."""
    from paddle_tpu_torch.kernels import build

    fwd = build.load("flash_attention_fwd")
    return {
        **_kernel_usage("flash_attention_fwd", lambda name, args:
                        fwd.paddle_flash_attention_fwd_smem_bytes(
                            SLICE_DP[args[0]]), match="slice"),
        **_kernel_usage("flash_attention_bf16", _bf16_smem, match="slice")}


def _backward_kernel_usage():
    from paddle_tpu_torch.kernels import build

    lib = build.load("flash_attention_bwd")
    smem = lib.paddle_flash_attention_bwd_smem_bytes
    return _kernel_usage(
        "flash_attention_bwd",
        lambda name, args: smem("dkv" in name, BWD_SLICE_DP[args[0]]
                                if "slice" in name else args[0]),
        match="flash_bwd")


def _sass_counts(lib_name, match):
    """Opcode counts (cuobjdump -sass) of each kernel of library
    ``lib_name`` whose name contains ``match``: HGMMA is wgmma on the
    tensor cores, HMMA mma.sync, FFMA an f32 FMA on the CUDA cores,
    UTMALDG a TMA load, UTMASTG a TMA store."""
    import re

    from paddle_tpu_torch.kernels import build

    ops = ("HGMMA", "HMMA", "FFMA", "UTMALDG", "UTMASTG")
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


# A torch.profiler trace late in the full script comes back short of its
# first device records: 17 of the first MobileNet replay in a trace
# (its stem conv, first depthwise conv and first conv1x1 GEMM), 5 of a
# ResNet replay, while the second and third replays in the same trace
# are whole, and waiting before or inside the trace changes nothing.
# So every trace opens with throwaway work, idles PRIMER_GAP_S, and only
# the records after that gap are read (_traced_kernels).
PRIMER_GAP_S = 0.2
PRIMER_FILLS = 64


@contextlib.contextmanager
def _cuda_trace(activities=None, primer=None):
    """A torch.profiler trace of the block (CUDA activity unless
    ``activities`` says otherwise) that opens with PRIMER_FILLS tiny
    kernels and ``primer()``, then idles PRIMER_GAP_S before the block
    runs; synchronised before it closes, warnings silenced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=activities
                     or [ProfilerActivity.CUDA]) as prof:
            scratch = torch.zeros(1, device="cuda")
            for _ in range(PRIMER_FILLS):
                scratch.add_(1)
            if primer is not None:
                primer()
            torch.cuda.synchronize()
            time.sleep(PRIMER_GAP_S)
            yield prof
            torch.cuda.synchronize()


def _traced_kernels(prof):
    """The device records of a _cuda_trace's block as (name, µs), in the
    order they ran: those after the first idle gap of at least half
    PRIMER_GAP_S, the one that ends the primer."""
    from torch.autograd import DeviceType

    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    cut = next((i for i in range(1, len(evs))
                if evs[i][0] - evs[i - 1][1] >= PRIMER_GAP_S / 2 * 1e6), 0)
    return [(name, end - start) for start, end, name in evs[cut:]]


def _device_ms(fn, iters=10):
    """Device time per call of ``fn``: the time its kernels ran in a
    torch.profiler trace of ``iters`` calls (CUPTI), without the host's
    gaps between them; None where the trace holds no device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without kernels
        try:
            with _cuda_trace(primer=fn) as prof:
                for _ in range(iters):
                    fn()
            total = sum(us for _, us in _traced_kernels(prof))
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


def _lm_loss(pt, c, pipeline_stack=True, remat=False):
    """The LM at ``c`` and its mean cross-entropy, built into the current
    programs: (ids, tgt, loss)."""
    from paddle_tpu_torch import layers, models

    ids = layers.data("ids", shape=[c["seq"]], dtype="int64")
    tgt = layers.data("tgt", shape=[c["seq"]], dtype="int64")
    logits = models.transformer_lm(
        ids, vocab_size=c["vocab"], d_model=c["d_model"],
        n_layers=c["n_layers"], num_heads=c["num_heads"],
        d_ff=c["d_ff"], max_len=c["max_len"],
        pipeline_stack=pipeline_stack, remat=remat)
    loss = layers.mean(layers.softmax_with_cross_entropy(
        layers.reshape(logits, shape=[-1, c["vocab"]]),
        layers.reshape(tgt, shape=[-1, 1])))
    return ids, tgt, loss


def _build_training_program(pt, c, pipeline_stack=True):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        _, _, loss = _lm_loss(pt, c, pipeline_stack)
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


# Phase 6b: phase 6's stacked LM at transformer_wide's width with 8 heads
# of 256 (d2048 L8 H8, d_ff 8192, as phase 12d; Gemma 7B's head dim):
# every attention runs the f32 flash forward, dq and dkv on their D256
# tensor-core instances, in f32 and under AMP (the
# stack casts q/k/v back to f32, as the JAX op does). Nothing cut. Then
# the same width served densely: 8 requests of 700-1024 prompt tokens, 32
# new tokens each.
STACKED_D256 = dict(TRAIN, d_model=2048, num_heads=8, d_ff=8192)
STACKED_SERVE = dict(requests=8, new_tokens=32)
STACKED_D256_GROUPS = ("flash_fwd_tf32x3_split", "flash_bwd_dq_tf32x3_split",
                       "flash_bwd_dkv_tf32x3_split", "flash_", "nvjet",
                       "gemm", "elementwise", "reduce")
# Phase 6c: the same width with 4 heads of 512 (d2048 L8 H4, d_ff 8192,
# as phase 12e): the f32 flash forward, dq and dkv on their D512 quarter
# instances, in f32 and under AMP. Nothing cut.
STACKED_D512 = dict(TRAIN, d_model=2048, num_heads=4, d_ff=8192)
STACKED_D512_GROUPS = ("flash_fwd_tf32x3_quarter",
                       "flash_bwd_dq_tf32x3_quarter",
                       "flash_bwd_dkv_tf32x3_quarter",
                       "flash_", "nvjet", "gemm", "elementwise", "reduce")
# Phase 6d: the same width with 2 heads of 1024 (d2048 L8 H2, d_ff 8192),
# trained and served as 6c: the f32 flash forward, dq and dkv on their
# slice instances past head dim 512 (phases 3 and 5's D1024_TRAIN).
# Nothing cut.
STACKED_D1024 = dict(TRAIN, d_model=2048, num_heads=2, d_ff=8192)
STACKED_D1024_GROUPS = ("flash_fwd_tf32x3_slice",
                        "flash_bwd_dq_tf32x3_slice",
                        "flash_bwd_dkv_tf32x3_slice",
                        "flash_", "nvjet", "gemm", "elementwise", "reduce")


def _stacked_tag(c):
    return f"d{c['d_model']} H{c['num_heads']}"


def _stacked_timed(exe, main, feed, loss, scope, fa, tag, c, peak, groups):
    """The main path of phase 6b, 6c or 6d in one precision: 1 warm + 6 timed
    steps (counts to 0 before, read after: 8 launches a step of each f32
    flash kernel, no bf16 launch), falling losses; step
    ms, tokens/s, the share of ``peak``, peak memory and device ms by
    kernel ``groups`` (the trio first;
    ``chiprun_out/stacked_d<head dim>_<tag>_profile.txt``)."""
    import numpy as np

    L, tokens = c["n_layers"], c["batch"] * c["seq"]
    hd = c["d_model"] // c["num_heads"]
    losses, step_s, counts, peak_mem, profile = _timed_steps(
        exe, main, feed, loss, scope, fa, f"stacked_d{hd}_{tag}_profile.txt",
        groups)
    assert counts == (7 * L,) * 3 + (0,) * 3, counts
    med = float(np.median(step_s[1:]))
    flops = transformer_train_flops(c["batch"], c["seq"], c["d_model"], L,
                                    c["vocab"], c["d_ff"])
    launches = [n // 7 for n in counts[:3]]
    print(f"stacked {_stacked_tag(c)} {tag}: losses "
          f"{[round(x, 5) for x in losses]}; "
          f"step median {med * 1e3:.1f} ms over 6 steps "
          f"({[round(x * 1e3, 1) for x in step_s]} ms), {tokens / med:.0f} "
          f"tokens/s, {flops / 1e12:.2f} TFLOP/step = "
          f"{flops / med / peak * 100:.1f}% of the "
          f"{'f32' if tag == 'f32' else 'bf16'} peak, peak memory "
          f"{peak_mem / 2**30:.2f} GiB; f32 flash launches per step "
          f"fwd/dq/dkv {launches}; device "
          + (f"{profile['device_ms']:.1f} ms: " + ", ".join(
              f"{g} {profile['kernels_ms'][g]:.2f} ms "
              f"({profile['launches'][g]} launches)"
              for g in groups[:3]) if profile else
             "not measured"))
    return {"losses": losses, "step_ms": [x * 1e3 for x in step_s],
            "step_ms_median": med * 1e3, "tokens_per_s": tokens / med,
            "tflop_per_step": flops / 1e12, "peak_share": flops / med / peak,
            "peak_mem_bytes": peak_mem, "launches_per_step": launches,
            "profile": profile}


def stacked_d256_phase(gpu_name):
    """Phase 6b: the stacked LM at d2048 L8 H8 (head dim 256), every f32
    flash kernel on its D256 tensor-core instance (stacked_phase)."""
    return stacked_phase(gpu_name, STACKED_D256, STACKED_D256_GROUPS)


def stacked_d512_phase(gpu_name):
    """Phase 6c: the stacked LM at d2048 L8 H4 (head dim 512)
    (stacked_phase): a step in either precision launches the f32 flash
    forward, dq and dkv 8 times each on their D512 quarter instances."""
    return stacked_phase(gpu_name, STACKED_D512, STACKED_D512_GROUPS)


def stacked_d1024_phase(gpu_name):
    """Phase 6d: the stacked LM at d2048 L8 H2 (head dim 1024)
    (stacked_phase): a step in either precision launches the f32 flash
    forward, dq and dkv 8 times each on their slice instances; each
    prefill of its serving half one forward a layer."""
    return stacked_phase(gpu_name, STACKED_D1024, STACKED_D1024_GROUPS)


def stacked_phase(gpu_name, c, groups):
    """Phase 6b, 6c or 6d: the stacked LM at configuration ``c`` trained in
    f32 (step 1 with the kernels against the plain path: loss LOSS_RTOL,
    every gradient GRAD_RTOL) and, built again under AMP with the same
    names from the same startup state, under AMP (step-1 loss within
    AMP_RTOL of f32's and AMP_PLAIN_RTOL of the AMP plain path's, every
    gradient within AMP_GRAD_RTOL of it); each timed (_stacked_timed,
    device time by ``groups``); then the same width served densely
    through ``Server`` (stacked_serving). Returns the phase's record."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import program as tprog
    from paddle_tpu_torch.kernels import flash_attention as fa

    name = f"stacked {_stacked_tag(c)}"
    peaks = _peaks(gpu_name)
    rng = np.random.RandomState(SEED)
    feed = {"ids": rng.randint(0, c["vocab"], size=(c["batch"], c["seq"]))
            .astype("int64"),
            "tgt": rng.randint(0, c["vocab"], size=(c["batch"], c["seq"]))
            .astype("int64")}
    start = tprog.Program._uid_counter
    t0 = time.perf_counter()
    main, startup, loss, params_grads = _build_training_program(pt, c)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace())
    exe.run(startup, scope=scope)
    state = _snapshot(scope)
    n_params = sum(scope.get(p.name).numel() for p, _ in params_grads)
    print(f"{name}: f32 program of {len(main.global_block.ops)} "
          f"ops, {len(params_grads)} parameters ({n_params / 1e6:.1f} M), "
          f"built and initialised in {time.perf_counter() - t0:.2f} s")
    fetch = [loss.name] + [g.name for _, g in params_grads]
    kern = _step_fetches(exe, main, feed, fetch, scope, state)
    with _plain_flash(fa):
        plain = _step_fetches(exe, main, feed, fetch, scope, state)
    lk, lp = float(kern[0]), float(plain[0])
    worst = _grad_gap(fetch[1:], kern[1:], plain[1:])
    print(f"{name} f32: step-1 loss kernels {lk:.6f} plain "
          f"{lp:.6f}; worst gradient |kernel - plain| / |plain| "
          f"{worst[0]:.3e} ({worst[1]}) (tol {GRAD_RTOL})")
    assert np.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp), (lk, lp)
    assert worst[0] <= GRAD_RTOL, worst
    del plain
    out = {"config": c, "params": n_params,
           "f32_step1": {"loss_kernels": lk, "loss_plain": lp,
                         "worst_grad_rel": worst}}
    out["f32"] = _stacked_timed(exe, main, feed, loss, scope, fa, "f32", c,
                                peaks[0], groups)
    l32 = float(kern[0])
    del kern, exe, scope, main, startup, params_grads
    torch.cuda.empty_cache()

    tprog.Program._uid_counter = start  # the AMP build's names are equal
    with _Amp():
        main, _, loss, params_grads = _build_training_program(pt, c)
        block = main.global_block
        dtypes = {n: block.var(n).dtype for n in state if block.has_var(n)}
        scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace())
        _restore(scope, state, dtypes)
        assert [g.name for _, g in params_grads] == fetch[1:]
        ka = _step_fetches(exe, main, feed, fetch, scope, state, dtypes)
        with _plain_flash(fa):
            pa = _step_fetches(exe, main, feed, fetch, scope, state, dtypes)
        del state
        la, lpa = float(ka[0]), float(pa[0])
        worst = _grad_gap(fetch[1:], ka[1:], pa[1:])
        del ka, pa
        print(f"{name} AMP: step-1 loss {la:.6f}, the f32 build "
              f"{l32:.6f} (rel {abs(la - l32) / abs(l32):.3e}, tol "
              f"{AMP_RTOL}), the AMP plain path {lpa:.6f} (rel "
              f"{abs(la - lpa) / abs(lpa):.3e}, tol {AMP_PLAIN_RTOL}); worst "
              f"gradient |kernels - plain| / |plain| {worst[0]:.3e} "
              f"({worst[1]}) (tol {AMP_GRAD_RTOL})")
        assert np.isfinite(la) and abs(la - l32) <= AMP_RTOL * abs(l32)
        assert abs(la - lpa) <= AMP_PLAIN_RTOL * abs(lpa), (la, lpa)
        assert worst[0] <= AMP_GRAD_RTOL, worst
        out["amp_step1"] = {"loss": la, "loss_f32": l32, "loss_plain": lpa,
                            "worst_grad_rel": worst}
        out["amp"] = _stacked_timed(exe, main, feed, loss, scope, fa, "amp",
                                    c, peaks[3], groups)
    del exe, scope, main
    torch.cuda.empty_cache()
    out["serving"] = stacked_serving(c)
    return out


def stacked_records(kern, bwd, stacked, hd):
    """The f32 instances that phase 6b's (``hd`` 256: the split
    instances), 6c's (``hd`` 512: the quarter instances) or 6d's (``hd``
    1024: the slice instances; the forward's row is slice_record's) main
    path runs, all three on the tensor cores, each timed at D256_TRAIN,
    D512_TRAIN or D1024_TRAIN (phases 3 and 5) with its launches a step in
    the phase's f32 run."""
    launches = stacked["f32"]["launches_per_step"]
    shape, err = f"d{hd}_train_shape", f"max_abs_err_d{hd}"
    rows = (("fwd", "flash_attention_fwd", "flash_attention_fwd.cu", 229,
             kern),
            ("dq", "flash_attention_bwd_dq", "flash_attention_bwd.cu", 364,
             bwd[0]),
            ("dkv", "flash_attention_bwd_dkv", "flash_attention_bwd.cu", 386,
             bwd[1]))
    out = []
    for (kind, name, source, line, rec), n in zip(rows, launches):
        if hd > 512 and kind == "fwd":
            continue
        out.append({
            "name": f"{name}_d{hd}", "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{source}",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "launches": n, "max_abs_err": rec[err], **rec[shape]})
    return out


def stacked_serving(c):
    """Phase 6b's, 6c's or 6d's serving half: the stacked LM at configuration
    ``c`` (weights from the seed through ``load_jax_params``) served by
    ``GenerationEngine(kv_cache="dense")`` and ``Server``: every result
    checked, zero dispatch errors, each prefill's attention on the f32
    forward's tensor-core instance at c's head dim (launches == layers x
    prefills), request 0's tokens equal to the plain path's on the
    card."""
    import numpy as np
    import torch

    from paddle_tpu_torch import init_params
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import TransformerLM
    from paddle_tpu_torch.serving import GenerationEngine, LMSpec, Server

    spec = LMSpec(vocab_size=c["vocab"], d_model=c["d_model"],
                  n_layers=c["n_layers"], num_heads=c["num_heads"],
                  d_ff=c["d_ff"], max_len=c["max_len"])
    model = TransformerLM(spec, device="cuda")
    model.load_jax_params(init_params(spec, SEED))
    eng = GenerationEngine(spec, model, slots=8, kv_cache="dense",
                           device="cuda")
    eng.warmup()
    torch.cuda.synchronize()
    rng = np.random.RandomState(SEED + 6)
    n_req, new = STACKED_SERVE["requests"], STACKED_SERVE["new_tokens"]
    prompts = [rng.randint(0, spec.vocab_size, rng.randint(700, 1025))
               .astype(np.int64) for _ in range(n_req)]
    _reset_flash_counts(fa)  # the main path's launches only
    srv = Server([eng]).start()
    try:
        t0 = time.perf_counter()
        futs = [srv.submit({"prompt": p}, max_new_tokens=new)
                for p in prompts]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
    counts = _flash_counts(fa)
    snap = srv.metrics_snapshot()
    counters = snap["counters"]
    prefills = counters["prefills"]
    for p, r in zip(prompts, results):
        assert r.shape == (p.size + new,), (r.shape, p.size, new)
        assert np.array_equal(r[:p.size], p)
        assert ((r >= 0) & (r < spec.vocab_size)).all()
    assert counters.get("dispatch_errors", 0) == 0, counters
    assert counters["completed"] == n_req, counters
    launches = spec.n_layers * prefills
    assert prefills > 0 and counts == (launches,) + (0,) * 5, (counts,
                                                                prefills)

    # request 0 against the plain path (greedy: the tokens must be equal)
    ref = _plain_tokens(model, spec, prompts[0], new)
    served = results[0][prompts[0].size:]
    assert np.array_equal(served, ref), (served, ref)
    lat = snap["latency"]
    print(f"stacked {_stacked_tag(c)} serving: {n_req} requests, "
          f"{sum(p.size for p in prompts)} prompt tokens, {n_req * new} "
          f"generated in {wall:.3f} s = {n_req * new / wall:.1f} tok/s; "
          f"{prefills} prefills (mean {lat['prefill_ms']['mean']:.2f} ms), "
          f"decode step mean {lat['decode_step_ms']['mean']:.2f} ms; f32 "
          f"flash forward launches {counts[0]} on the "
          f"D{spec.d_model // spec.num_heads} tensor-core instance (the "
          f"forward has no wide instance left); request 0's {new} tokens "
          f"equal the plain path's on the card")
    del eng, model
    torch.cuda.empty_cache()
    return {"requests": n_req, "new_tokens": new, "wall_s": wall,
            "tokens_per_s": n_req * new / wall, "prefills": prefills,
            "flash_launches": counts[0],
            "prefill_ms_mean": lat["prefill_ms"]["mean"],
            "decode_step_ms_mean": lat["decode_step_ms"]["mean"]}


def _profile_step(run, path="train_profile.txt",
                  groups=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
    """Device time of one step (``run()``) by kernel, from torch.profiler
    (CUPTI), summed per group of kernel names (``groups``: substrings) and
    written to ``chiprun_out/<path>``; a measurement aid, not a check:
    without device times it says so."""
    from torch.profiler import ProfilerActivity

    try:
        with _cuda_trace([ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as prof:
            run()
        # kernels only: an op's device time repeats its kernels'
        by_key = {}
        for key, us in _traced_kernels(prof):
            ms, n = by_key.get(key, (0.0, 0))
            by_key[key] = (ms + us / 1e3, n + 1)
        rows = [(ms, n, key) for key, (ms, n) in by_key.items() if ms]
    except Exception as exc:  # noqa: BLE001 - report, do not fail the run
        print(f"profile: not measured ({type(exc).__name__}: {exc})")
        return None
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        print("profile: no device time recorded")
        return None
    sums = {g: 0.0 for g in groups}
    launches = dict.fromkeys(groups, 0)
    for ms, n, key in rows:
        for g in groups:  # the first group that matches takes the kernel
            if g in key:
                sums[g] += ms
                launches[g] += n
                break
    print(f"profile: one step, {total:.1f} ms of device time; "
          + ", ".join(f"{g} {ms:.1f} ms" for g, ms in sums.items()))
    for ms, n, key in rows[:12]:
        print(f"profile: {ms:9.2f} ms {n:5d}x {key[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / path).write_text("\n".join(
        f"{ms:.4f}\t{n}\t{key}" for ms, n, key in rows))
    return {"device_ms": total, "kernels_ms": sums, "launches": launches,
            "kernel_launches": sum(n for _, n, _ in rows),
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


def _train_flops(program, batch):
    """Model FLOPs of one train step of a conv/fc program: 2 per MAC of
    every conv (grouped ones included: an HWIO filter holds the input
    channels of one group), fused conv and fc in the forward, times 3 for
    forward plus backward."""
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
    flops = _train_flops(main, B)
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


def _count_kernels(run, names, expect=None):
    """Launches per kernel-name substring in a torch.profiler trace of
    one ``run()``, primed by another (_cuda_trace); None where the trace
    holds no device kernels. A trace now and then comes back without
    kernels; none holds a launch that did not run. So with ``expect``
    ({name: launches the caller checks for}) a trace that shows fewer
    is taken again, three at most, each name keeping its largest count;
    the caller still checks the counts exactly."""
    import torch

    run()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with _cuda_trace(primer=run) as prof:
            run()
        events = _traced_kernels(prof)
        if not events:
            continue
        got = {n: sum(n in key for key, _ in events) for n in names}
        best = got if best is None else {n: max(best[n], got[n])
                                         for n in names}
        if all(best[n] >= want for n, want in (expect or {}).items()):
            break
    return best


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
    counted = _count_kernels(lambda: eng.run({"images": x}), names,
                             expect=dict.fromkeys(names[:2], FUSED_OPS))
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
# The bf16 GEMM kernel before its persistent, warp-specialised rebuild
# (one block a 128 x BN tile; PERF.md §6): ms at the heaviest shape,
# summed over a ResNet-50 AMP step (stats) or served batch of 16
# (epilogue) as called, and as device time.
CONV_BF16_PREVIOUS_MS = {
    "conv1x1_stats": {"ms": 0.308, "per_step_ms": 6.16,
                      "per_step_device_ms": 5.47},
    "conv1x1_epilogue": {"ms": 0.078, "per_step_ms": 1.63,
                         "per_step_device_ms": 0.650},
}
# Shapes the persistent walk must get right, in both epilogues: more
# items than the grid with a partial last row tile; fewer tiles than SMs
# with a ragged K (the epilogue splits it); 64-wide tiles at O = 40 with
# more items than the grid
PERSISTENT_CASES = ((132 * 128 * 3 + 77, 64, 256), (900, 1000, 200),
                    (50000, 128, 40))


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
    # K stage, tiles cut by R and O, both residual dtypes; then the
    # persistent walk's cases
    ragged = [(R, I, O, rd, act) for R, I, O in ((257, 30, 9), (1000, 72, 40),
                                                 (100, 136, 200))
              + PERSISTENT_CASES
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
    # every instance: products on wgmma, operands by TMA loads, outputs by
    # TMA stores, nothing spilled
    assert sass and sorted(sass) == sorted(usage), (sorted(sass),
                                                    sorted(usage))
    for key, c in sass.items():
        u = usage[key]
        assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["UTMASTG"] > 0, (
            key, c)
        assert not u.get("spill_store_bytes") and not u.get(
            "spill_load_bytes"), (key, u)
    serialised = [line.strip() for line in build.log_path("conv_epilogue")
                  .read_text().splitlines() if "C7515" in line]
    print(f"ptxas conv_epilogue: {len(serialised)} wgmma serialisation "
          f"warnings (C7515)" + "".join(f"\n  {x}" for x in serialised))

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
                row["library_device_ms"] = _device_ms(calls[2])
                row["grid"] = ke.tile_plan(
                    R, I, O, kind == "conv1x1_epilogue", ke.K_TILE_BF16).grid
            timed[kind][(R, I, O, rd is not None, act)] = row
            dev = lib_dev = ""
            if kind != "scale_shift_act":
                dev = f" (device {_ms_text(row['device_ms'], '.4f')})"
                lib_dev = (f" (device "
                           f"{_ms_text(row['library_device_ms'], '.4f')})")
            print(f"bf16 {kind} R{R} I{I} O{O} residual={rd} act={act} "
                  f"x{count}: {row['ms']:.4f} ms{dev}, plain "
                  f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}"
                  f"{lib_dev}, bound {bound:.4f} ({by})")
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
                              "device_ms", "library_device_ms")
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
            rec["previous_ms"] = CONV_BF16_PREVIOUS_MS[kind]
        was = rec.get("previous_ms")
        print(f"{kind}_bf16: heaviest shape {rec['shape']} {top['ms']:.4f} ms "
              f"vs bound {top['bound_ms']:.4f} ({top['bound_by']}), library "
              f"{top['library_ms']:.4f}; per "
              f"{'batch' if kind == 'conv1x1_epilogue' else 'step'} "
              f"{per_step['ms']:.3f} ms (plain {per_step['plain_ms']:.3f}, "
              f"library {per_step['library_ms']:.3f}, bound "
              f"{per_step['bound_ms']:.3f}; device time "
              f"{_ms_text(per_step.get('device_ms'))}, library's "
              f"{_ms_text(per_step.get('library_device_ms'))})"
              + ("" if was is None else
                 f"; one block a tile: {was['ms']:.3f} ms, "
                 f"{was['per_step_ms']:.2f} a "
                 f"{'batch' if kind == 'conv1x1_epilogue' else 'step'} "
                 f"(device {was['per_step_device_ms']:.3f})"))
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
    flops = _train_flops(main, B)
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
                                  "conv1x1_tf32x3_kernel"),
                                 expect={"conv1x1_bf16_kernel": FUSED_OPS})
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
# transformer_wide's width with 8 heads of 256 (Gemma 7B's head dim): the
# same FLOPs a step as transformer_wide, at head dim 256 (the three
# kernels' D256 wgmma instances)
PER_LAYER_D256 = dict(TRAIN, d_model=2048, num_heads=8, d_ff=8192)
# transformer_wide's width with 4 heads of 512: head dim 512, past what
# any configuration the reference ships reaches (its Pallas kernel takes
# any head dim): the three kernels' D512 wgmma instances
PER_LAYER_D512 = dict(TRAIN, d_model=2048, num_heads=4, d_ff=8192)
# the same width with 2 heads of 1024: head dim 1024, the three kernels'
# slice instances (the stacked LM's 6d at the same width)
PER_LAYER_D1024 = dict(TRAIN, d_model=2048, num_heads=2, d_ff=8192)
# (B, H, T, D, causal, lengths): both training shapes, the serving shape,
# a ragged T = 1000 with lengths (a fully masked row), a non-causal case;
# past D = 128 phase 3's D160 and D256 cases and D192 (causal, a fully
# masked row), a non-causal ragged D256, the D256 training shape; past
# 256 D384 (causal, a fully masked row), D512 and the D512 training shape
# (all three kernels on their split wgmma instances), and past 512 phase
# 3's SLICE_CASES and phase 5's D1200 (all three on their slice
# instances; dq's and dkv's Q or K resident up to D1024, streamed at
# D1100, D1152 and D1200)
BF16_FLASH_CASES = [
    (8, 8, 2048, 128, True, None),
    (8, 16, 2048, 128, True, None),
    (8, 16, 1024, 64, True, None),
    (4, 8, 1000, 128, True, [1000, 999, 513, 0]),
    (2, 4, 300, 128, False, [300, 17]),
    (2, 4, 1000, 160, True, [1000, 0]),
    (2, 4, 1000, 192, True, [1000, 0]),
    (2, 4, 1000, 256, True, [1000, 0]),
    (2, 4, 300, 256, False, [300, 17]),
    D256_TRAIN,
    (2, 4, 1000, 384, True, [1000, 0]),
    (2, 2, 300, 512, False, [300, 0]),
    D512_TRAIN,
] + SLICE_CASES + BWD_STREAMED_CASES
# the cases whose two launches must agree bitwise: the training shapes at
# D128, D256 and D512 and the D384 case (and at WIDE_D576 and
# D1024_TRAIN, uncut)
BF16_BITWISE_CASES = (BF16_FLASH_CASES[0], D256_TRAIN, D512_TRAIN,
                      BF16_FLASH_CASES[10])
BF16_FLASH = ("flash_attention_fwd_bf16", "flash_attention_bwd_dq_bf16",
              "flash_attention_bwd_dkv_bf16")
BF16_FLASH_REPLACES = (229, 364, 386)
# the bf16 flash kernel instances that run wgmma fed by TMA (all three at
# D 64, 128, 192, 256, 384 and 512, and their slice instances past 512):
# in SASS, HGMMA and UTMALDG and no HMMA (mma.sync); ptxas reports no
# spills
BF16_FLASH_SASS = tuple(f"flash_{k}_bf16_kernel<{d}>"
                        for k in ("fwd", "bwd_dq", "bwd_dkv")
                        for d in (64, 128, 192, 256, 384, 512)) + (
    "flash_fwd_slice_bf16_kernel<1>", "flash_fwd_slice_bf16_kernel<0>") + (
    tuple(f"flash_bwd_{k}_slice_bf16_kernel<{r}>" for k in ("dq", "dkv")
          for r in (1, 0)))
# the shapes the bf16 trio is timed at past D = 128: phase 3's and
# D256_TRAIN on the D256 wgmma instances, the D384 and D512 ones (phase
# 3's shape at head dims 384 and 512, and the attention of the per-layer
# LM at d2048 H4, 12e) on the split instances (only SDPA's
# memory-efficient backend takes these inputs), WIDE_D576 and D1024_TRAIN
# (the attention of the per-layer LM at d2048 H2, 12f) on the slice
# instances
BF16_WIDE_TIMED = (WIDE_TIMED, D256_TRAIN, WIDE_D384, WIDE_D512, D512_TRAIN,
                   WIDE_D576, D1024_TRAIN)
BF16_D512_TIMED = BF16_WIDE_TIMED[2:5]
# the times, in ms, of the wide f32-FMA instances that the bf16 forward,
# dq and dkv ran before their wgmma instances, at BF16_WIDE_TIMED's
# shapes, on an NVIDIA H100 80GB HBM3 at 700 W (``--bf16-wide-times``
# once on the commit before each: the D256 shapes before the forward's
# and dq's, then dkv's, wgmma instances there, the rest before the
# forward's and dq's at 384 and 512, and dkv's there, the forward's at
# WIDE_D576 and D1024_TRAIN before its slice instance, and dq's and dkv's
# there before theirs; past 512 the mean of two turns, dq's and dkv's in
# turns with their slice instances); no FMA instance is kept to time
# again
BF16_WIDE_PREVIOUS_MS = {WIDE_TIMED: (0.509, 0.816, 0.657),
                         D256_TRAIN: (8.634, 13.966, 20.948),
                         WIDE_D384: (0.839, 1.404, 1.648),
                         WIDE_D512: (1.229, 2.209, 2.256),
                         D512_TRAIN: (14.616, 26.316, 38.035),
                         WIDE_D576: (1.620, 3.103, 4.119),
                         D1024_TRAIN: (27.091, 51.198, 76.054)}
# the times of the mma.sync kernels these replaced, at B8 H8 T2048 D128
# causal, in ms, on an NVIDIA H100 80GB HBM3 at 700 W (the forward and
# dkv as last timed beside the mma.sync dq, dq as last timed beside the
# wgmma forward and dkv); no old kernel is kept to time it again
BF16_FLASH_PREVIOUS_MS = (0.384, 0.478, 0.711)
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


def _sdpa_fastest(F, q, k, v, do=None, required=True):
    """(ms, backend) of the fastest SDPA backend that takes these inputs
    (is_causal): the forward, or with ``do`` its backward (forward and
    backward minus the forward alone). Where none takes them, raises, or
    without ``required`` gives (None, None)."""
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
    if best is None and required:
        raise RuntimeError("no SDPA backend ran these inputs")
    return best or (None, None)


def _bf16_wide_times(gpu_name, gen):
    """The bf16 forward, dq and dkv at each of BF16_WIDE_TIMED's shapes
    (D256, D384, D512, D576 and D1024, causal): each timed beside its plain
    version, its bound at the bf16 tensor-core rate and bf16 SDPA (its
    fastest backend: the forward; the backward for dq and dkv together;
    past 256 only the memory-efficient one takes the inputs, and past 512
    perhaps none). Returns {shape: [the three
    kernels' rows]}. Only the flash wrappers' public entry points run, so
    the same lines time an earlier commit's instances."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    out = {}
    for B, H, T, D, causal, lengths in BF16_WIDE_TIMED:
        assert lengths is None
        q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=gen)
                       .bfloat16() for _ in range(4))
        o, lse = fa.flash_forward(q, k, v, None, causal)
        di = fa._row_dot(do, o)
        sdpa_fwd, backend = _sdpa_fastest(F, q, k, v, required=D <= 256)
        sdpa_bwd, bwd_backend = _sdpa_fastest(F, q, k, v, do,
                                              required=D <= 256)
        runs = (lambda: fa.flash_forward(q, k, v, None, causal),
                lambda: fa.flash_dq(q, k, v, lse, di, do, None, causal),
                lambda: fa.flash_dkv(q, k, v, lse, di, do, None, causal))
        plain = (lambda: fa.flash_attention_reference(q, k, v, None, causal),
                 lambda: fa.flash_dq_reference(q, k, v, lse, di, do, None,
                                               causal),
                 lambda: fa.flash_dkv_reference(q, k, v, lse, di, do, None,
                                                causal))
        shape = _case_text(B, H, T, D, causal, None)
        rows = []
        for i, (name, run, ref) in enumerate(zip(BF16_FLASH, runs, plain)):
            ms = _cuda_ms(run, iters=10)
            plain_ms = _cuda_ms(ref, iters=3, warmup=1)
            if i == 0:
                flops, nbytes = _attention_work(B, H, T, T, D, causal, None,
                                                2)
            else:
                flops, nbytes = _backward_work("dq" if i == 1 else "dkv", B,
                                               H, T, T, D, causal, None, 2)
            bound, bound_by, bound_simt = _bound(flops, nbytes, gpu_name,
                                                 bf16=True)
            library = sdpa_fwd if i == 0 else sdpa_bwd
            lib_text = ("no backend takes these inputs" if library is None
                        else f"forward {library:.3f} ({backend})" if i == 0
                        else f"backward {library:.3f} for the pair "
                        f"({bwd_backend})")
            print(f"{name} at {shape}: {ms:.3f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s, {bound / ms * 100:.1f}% of the bound), plain "
                  f"{plain_ms:.3f} ms, bound {bound:.4f} ({bound_by}, bf16 "
                  f"tensor cores), bf16 SDPA {lib_text}")
            rows.append({
                "shape": shape, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "bound_ms_simt": bound_simt, "library_ms": library,
                "library": f"F.scaled_dot_product_attention bf16 {lib_text}",
                "tflop_per_s": flops / ms / 1e9, "bound_share": bound / ms})
        print(f"bf16 flash backward at {shape}: dq + dkv "
              f"{rows[1]['ms'] + rows[2]['ms']:.3f} ms; bf16 SDPA's backward "
              + ("no backend takes these inputs" if sdpa_bwd is None
                 else f"{sdpa_bwd:.3f} ({bwd_backend})"))
        out[(B, H, T, D, causal, lengths)] = rows
        del q, k, v, do, o, lse, di
        torch.cuda.empty_cache()
    return out


def _worst(errs, name, got, plain):
    """errs[name] raised to max |got - plain| where that is larger."""
    errs[name] = max(errs[name],
                     float((got.float() - plain.float()).abs().max()))


def bf16_flash_kernel_phase(gpu_name):
    """Phase 12a: the bf16 flash forward, dq and dkv against their plain
    versions (the gate above) at every case, two launches of each bitwise
    equal at BF16_BITWISE_CASES; registers and tensor-core opcodes; then
    timed at B8 H8 T2048 D128 causal beside the plain versions, the bound
    at the bf16 tensor-core rate and bf16 SDPA (forward; backward for the
    pair), and past D = 128 (_bf16_wide_times) beside the times of the
    FMA instances they replaced there. Returns the three kernels'
    records, then the records of their D256, D512 and slice instances
    (past 512)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    usage = _kernel_usage("flash_attention_bf16", _bf16_smem,
                          match="bf16_kernel")
    sass = _sass_counts("flash_attention_bf16", "bf16_kernel")
    _assert_no_wide_route()
    # every product wgmma, operands by TMA, nothing spilled
    assert sorted(sass) == sorted(BF16_FLASH_SASS), sorted(sass)
    for key in BF16_FLASH_SASS:
        c, u = sass[key], usage[key]
        assert c["HGMMA"] > 0 and c["HMMA"] == 0 and c["UTMALDG"] > 0, (
            key, c)
        assert not u.get("spill_store_bytes") and not u.get(
            "spill_load_bytes"), (key, u)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    # max |kernel - plain| of each kernel, by the instance it ran: up to
    # D128, the wgmma instances at D192 and D256, those at D384 and D512,
    # the slice instances past 512
    errs, errs_d256, errs_d512, errs_slice = (
        dict.fromkeys(BF16_FLASH, 0.0) for _ in range(4))

    def bucket(D):
        kd = fa._kernel_head_dim(D)
        return (errs if kd <= 128 else errs_d256 if kd <= 256
                else errs_d512 if kd <= 512 else errs_slice)

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
        _worst(bucket(D), BF16_FLASH[0], o, po)
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
            i = 1 if name == "dq" else 2
            _worst(bucket(D), BF16_FLASH[i], a, b)
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
        if (B, H, T, D, causal, lengths) in BF16_BITWISE_CASES:
            # no atomics
            o2, _ = fa.flash_forward(q, k, v, lens, causal, sm)
            g2 = fa.flash_backward(q, k, v, po, plse, do, lens, causal, sm)
            assert torch.equal(o2, o) and all(
                torch.equal(a, b) for a, b in zip(g2, grads)), \
                f"two launches differ at {row['case']}"
            del o2, g2
        print(f"bf16 flash {row['case']}: max error from the f32 truth "
              f"(kernel/plain): " + "; ".join(
                  f"{n} {_bf16_text(row[n])}" for n in ("o", "dq", "dk", "dv"))
              + f"; lse {row['lse']:.2e} from the plain version")
        cases.append(row)
        del q, k, v, do, o, lse, po, plse, grads
        torch.cuda.empty_cache()
    print("bf16 flash kernels: two launches on the same inputs bitwise equal "
          "at " + ", ".join(_case_text(*c) for c in BF16_BITWISE_CASES))
    for B, H, T, D, causal, _ in (WIDE_D576, D1024_TRAIN):  # the slices
        q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=gen)
                       .bfloat16() for _ in range(4))
        o, lse = fa.flash_forward(q, k, v, None, True)
        runs = [(*fa.flash_forward(q, k, v, None, True),
                 *fa.flash_backward(q, k, v, o, lse, do, None, True))
                for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs)), (
            f"two bf16 flash launches at D{D} differ")
        print(f"bf16 flash forward, dq and dkv B{B} H{H} T{T} D{D} causal: "
              f"two launches of each are bitwise equal")
        del q, k, v, do, o, lse, runs

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
              f" ({flops / ms / 1e9:.1f} TFLOP/s, {bound / ms * 100:.1f}% "
              f"of the bound; mma.sync: {BF16_FLASH_PREVIOUS_MS[i]:.3f}), "
              f"plain {plain_ms:.3f}, bound {bound:.3f} ({bound_by}, bf16 "
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
            "tflop_per_s": flops / ms / 1e9, "bound_share": bound / ms,
            "previous_ms": BF16_FLASH_PREVIOUS_MS[i],
            "cases": cases, "ptxas": usage, "sass": sass})
    pair = records[1]["ms"] + records[2]["ms"]
    print(f"bf16 flash backward: dq + dkv {pair:.3f} ms against bf16 SDPA's "
          f"backward {sdpa_bwd:.3f} ({bwd_backend}), "
          f"{pair / sdpa_bwd:.2f}x")
    records[1]["pair_ms"] = records[2]["pair_ms"] = pair
    del q, k, v, do, o, lse, di
    torch.cuda.empty_cache()

    # past D = 128: the D256 instances on wgmma, the D384 and D512 ones on
    # their split wgmma instances, past 512 the slice instances, each
    # beside the FMA instances' times (on the commits before each)
    wide = _bf16_wide_times(gpu_name, gen)
    for i, name in enumerate(BF16_FLASH):
        for shape, rows in wide.items():
            was = BF16_WIDE_PREVIOUS_MS[shape][i]
            rows[i]["previous_ms"] = was
            print(f"{name} at {rows[i]['shape']}: {rows[i]['ms']:.3f} ms, "
                  f"was {_ms_text(was)} on the wide FMA instance"
                  + (f" ({was / rows[i]['ms']:.1f}x)" if was else ""))
    d256 = {shape: wide[shape] for shape in BF16_WIDE_TIMED[:2]}
    d512 = {shape: wide[shape] for shape in BF16_D512_TIMED}
    pair = {}
    for shape in (WIDE_D576, D1024_TRAIN):  # the slice dq and dkv
        rows = wide[shape]
        pair[shape] = rows[1]["ms"] + rows[2]["ms"]
        was = sum(BF16_WIDE_PREVIOUS_MS[shape][1:])
        print(f"bf16 flash backward at {rows[1]['shape']}: dq + dkv "
              f"{pair[shape]:.3f} ms on the slice instances, was "
              f"{was:.3f} on the wide FMA ones ({was / pair[shape]:.1f}x); "
              f"bf16 SDPA's backward {_ms_text(rows[1]['library_ms'])}"
              + (f" ({pair[shape] / rows[1]['library_ms']:.2f}x)"
                 if rows[1]["library_ms"] else ""))
        for i in (1, 2):
            rows[i]["pair_ms"] = pair[shape]

    def record(i, suffix, errors, times, keep):
        return {
            "name": f"{BF16_FLASH[i]}_{suffix}", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention_bf16.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:"
                        f"{BF16_FLASH_REPLACES[i]}",
            "launches": 0, "max_abs_err": errors[BF16_FLASH[i]],
            **times[-1][i], "times": [rows[i] for rows in times],
            "ptxas": {k: u for k, u in usage.items() if keep(k)}}

    for i in range(3):  # each timed at D256_TRAIN
        records.append(record(i, "d256", errs_d256, list(d256.values()),
                              lambda k: k.endswith(("<192>", "<256>"))))
    for i in range(3):  # each timed at D512_TRAIN
        records.append(record(i, "d512", errs_d512, list(d512.values()),
                              lambda k: k.endswith(("<384>", "<512>"))))
    for i in (1, 2):  # the slice dq and dkv, each timed at D1024_TRAIN
        records.append(record(
            i, "slice", errs_slice, [wide[WIDE_D576], wide[D1024_TRAIN]],
            lambda k, kind=("dq", "dkv")[i - 1]: k.startswith(
                f"flash_bwd_{kind}_slice")))
    print("bf16 flash past D = 512: max |kernel - plain| of the slice "
          "instances: " + ", ".join(
              f"{name} {errs_slice[name]:.3e}" for name in BF16_FLASH))
    # the forward's slice instance, timed in turns with SDPA
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    slice_times = {}
    for name, shape in (("d576_shape", WIDE_D576),
                        ("d1024_train_shape", D1024_TRAIN)):
        t = _time_forward(F, fa, randn, gpu_name, *shape,
                          dtype=torch.bfloat16)
        t["previous_ms"] = was = BF16_WIDE_PREVIOUS_MS[shape][0]
        print(f"flash_attention_fwd_bf16 at {t['shape']}: {t['ms']:.3f} ms, "
              f"{t['bound_ms'] / t['ms'] * 100:.1f}% of the bound; was "
              f"{_ms_text(was)} on the wide FMA instance"
              + (f" ({was / t['ms']:.1f}x)" if was else ""))
        slice_times[name] = t
    records.append(slice_record(
        dict(slice_times, max_abs_err_slice=errs_slice[BF16_FLASH[0]],
             ptxas=usage), "bf16", 0))
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
    hd = c["d_model"] // c["num_heads"]
    tag = f"d{c['d_model']} L{L} H{c['num_heads']} D{hd}"
    # the profile's bf16 trio, by instance name: past 512 the slice ones
    bf16_groups = (tuple(f"flash_{k}_slice_bf16"
                         for k in ("fwd", "bwd_dq", "bwd_dkv"))
                   if fa._kernel_head_dim(hd) > 512 else PER_LAYER_GROUPS[:3])
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
    _reset_flash_counts(fa)
    kern = _step_fetches(exe, main, feed, fetch, scope, state)
    counts = _flash_counts(fa)  # one f32 launch a layer of each kernel
    assert counts == (L,) * 3 + (0,) * 3, counts
    print(f"per-layer {tag} f32 step 1: f32 flash launches fwd/dq/dkv "
          f"{list(counts[:3])}")
    out["f32_step1_launches"] = list(counts)
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
              f"{[n // 7 for n in counts[:3]]}, bf16 {counts[3:6]}")
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
        path = f"per_layer_amp_d{c['d_model']}_h{c['num_heads']}_profile.txt"
        groups = bf16_groups + PER_LAYER_GROUPS[3:]
        losses, step_s, counts, peak, profile = _timed_steps(
            exe, main, feed, loss, scope, fa, path, groups)
        # the profiled step launched what each timed step did, by the
        # counters; a CUPTI trace now and then loses a kernel's record
        # (seen once: 7 of the forward's 8), so a step whose trace shows
        # fewer is profiled again, twice at most, before the check below
        ran = tuple(a - b for a, b in zip(_flash_counts(fa), counts))
        assert not profile or ran == tuple(n // 7 for n in counts), (
            ran, counts)
        for _ in range(2):
            if not profile or [profile["launches"][g]
                               for g in bf16_groups] == [L] * 3:
                break
            profile = _profile_step(
                lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope), path, groups=groups)
    assert counts == (0,) * 3 + (7 * L,) * 3, counts  # every launch bf16
    med = float(np.median(step_s[1:]))
    dev = profile["device_ms"] if profile else None
    trio = (sum(profile["kernels_ms"][g] for g in bf16_groups)
            if profile else None)
    if profile:  # the profiled step ran each bf16 flash kernel once a layer
        assert [profile["launches"][g] for g in bf16_groups] == [L] * 3, \
            profile["launches"]
        print(f"per-layer {tag} AMP: profiled step, device ms by bf16 flash "
              f"kernel: " + ", ".join(
                  f"{g} {profile['kernels_ms'][g]:.2f} ms "
                  f"({profile['launches'][g]} launches)"
                  for g in bf16_groups))
    print(f"per-layer {tag} AMP: losses {[round(x, 5) for x in losses]}; "
          f"step median {med * 1e3:.1f} ms over 6 steps "
          f"({[round(x * 1e3, 1) for x in step_s]} ms), {tokens / med:.0f} "
          f"tokens/s, {flops / 1e12:.2f} TFLOP/step = "
          f"{flops / med / peak_bf16 * 100:.1f}% of the bf16 peak, peak "
          f"memory {peak / 2**30:.2f} GiB; bf16 flash launches per step "
          f"{[n // 7 for n in counts[3:6]]}, f32 {counts[:3]}; device "
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
                      n // 7 for n in counts[3:6]],
                  "device_ms": dev, "flash_bf16_ms": trio,
                  "profile": profile}
    del exe, scope, main
    torch.cuda.empty_cache()
    return out


def per_layer_phases(gpu_name):
    """Phase 12: the bf16 flash kernels (a), then the per-layer LM at
    bench.py's transformer in f32 and under AMP (b), at transformer_wide
    under AMP (c), at its width with 8 heads of 256 under AMP (d), with 4
    heads of 512 under AMP (e) and with 2 heads of 1024 under AMP (f).
    Returns (the bf16 kernel records, the record of each part)."""
    seconds = [time.perf_counter()]
    recs = bf16_flash_kernel_phase(gpu_name)
    seconds.append(time.perf_counter())
    base = per_layer_lm_phase(gpu_name, PER_LAYER, time_f32=True)
    for rec, n in zip(recs, base["amp"]["launches_per_step"]):
        rec["launches"] = n
    seconds.append(time.perf_counter())
    wide = per_layer_lm_phase(gpu_name, PER_LAYER_WIDE, time_f32=False)
    seconds.append(time.perf_counter())
    d256 = per_layer_lm_phase(gpu_name, PER_LAYER_D256, time_f32=False)
    seconds.append(time.perf_counter())
    d512 = per_layer_head_phase(gpu_name, PER_LAYER_D512, recs)
    seconds.append(time.perf_counter())
    d1024 = per_layer_head_phase(gpu_name, PER_LAYER_D1024, recs)
    seconds.append(time.perf_counter())
    print("phase 12 seconds: " + ", ".join(
        f"{part} {b - a:.1f}" for part, a, b in zip("abcdef", seconds,
                                                    seconds[1:])))
    # the D256 records: each kernel's launches a step in (d)
    for rec, n in zip(recs[3:6], d256["amp"]["launches_per_step"]):
        rec["launches"] = n
    print("per-layer d2048 L8 AMP, the same FLOPs a step: " + "; ".join(
        f"H{h} (D{2048 // h}) step {r['step_ms_median']:.1f} ms, "
        f"{r['tokens_per_s']:.0f} tokens/s, "
        f"{r['bf16_peak_share'] * 100:.1f}% of the bf16 peak, the flash "
        f"trio {_ms_text(r['flash_bf16_ms'], '.1f')} ms of device time, "
        f"peak memory {r['peak_mem_bytes'] / 2**30:.2f} GiB"
        for h, r in ((16, wide["amp"]), (8, d256["amp"]), (4, d512["amp"]),
                     (2, d1024["amp"]))))
    return recs, {"transformer": base, "transformer_wide": wide,
                  "transformer_wide_d256": d256,
                  "transformer_wide_d512": d512,
                  "transformer_wide_d1024": d1024}


# the phase 12a records of the bf16 instances that 12e (head dim 512) and
# 12f (1024) run, in BF16_FLASH's order
PER_LAYER_HEAD_RECORDS = {
    512: tuple(f"{name}_d512" for name in BF16_FLASH),
    1024: ("flash_attention_fwd_slice_bf16",
           "flash_attention_bwd_dq_bf16_slice",
           "flash_attention_bwd_dkv_bf16_slice")}


def per_layer_head_phase(gpu_name, c, recs=None):
    """Phase 12e (``c`` = PER_LAYER_D512) or 12f (PER_LAYER_D1024): the
    per-layer LM at transformer_wide's width with 4 heads of 512 or 2 of
    1024 under AMP (per_layer_lm_phase: 8 launches a step of each bf16
    flash kernel, its f32 build's step 1 one launch a layer of each f32
    one), the bf16 trio on its D512 wgmma instances or its slice ones, as
    the profiled step names them, the f32 trio on its quarter or slice
    instances. With phase 12a's records ``recs``, sets the launches a
    step of the instances the main path ran."""
    out = per_layer_lm_phase(gpu_name, c, time_f32=False)
    amp = out["amp"]
    L, hd = c["n_layers"], c["d_model"] // c["num_heads"]
    tag = f"d{c['d_model']} L{L} H{c['num_heads']} (D{hd})"
    print(f"per-layer {tag} AMP: bf16 flash launches a step "
          f"{amp['launches_per_step']} (all three on their "
          f"{'D512 wgmma' if hd <= 512 else 'slice'} instances), f32 step 1 "
          f"{out['f32_step1_launches'][:3]}")
    prof = amp["profile"]
    print(f"per-layer {tag} AMP: step "
          f"{amp['step_ms_median']:.1f} ms, {amp['tokens_per_s']:.0f} "
          f"tokens/s; one profiled step's device time "
          + (f"{prof['device_ms']:.1f} ms by kernel: " + ", ".join(
              f"{g} {ms:.2f} ms ({prof['launches'][g]} launches)"
              for g, ms in prof["kernels_ms"].items()) if prof
             else "not measured"))
    if recs is not None:
        by_name = {r["name"]: r for r in recs}
        for name, n in zip(PER_LAYER_HEAD_RECORDS[hd],
                           amp["launches_per_step"]):
            by_name[name]["launches"] = n
    return out


# --- 13. The reference benchmark's recurrent rows and its decode row --------
# bench.py's bench_lstm_step and bench_lstm_varlen (2 x LSTM text
# classification, the reference's RNN benchmark: bs64, hidden 512, vocab
# 10000, Adam 1e-3) and bench_decode (greedy KV-cache decoding of the
# stacked LM), built with the port's layers as bench.py builds them with
# the JAX package's.
LSTM_BASELINE_MS = 184.0  # the reference's 2xLSTM bs64 hidden 512, one
#                           K40m, ms/batch (bench.py LSTM_BASELINE_MS)
RECURRENT = dict(batch=64, seqlen=100, hidden=512, vocab=10000, lr=1e-3,
                 mean_len=80, cap=200)
DECODE = dict(batch=8, prefill=1024, new=128, vocab=16384, d_model=1024,
              n_layers=8, num_heads=8)
RNN_WARMUP, RNN_STEPS = 3, 20  # bench.py's _time_train_steps
DECODE_WARMUP, DECODE_STEPS = 1, 3  # bench.py's bench_decode
# Step 1 on the card against the same step on the CPU (Gate 1): the loss
# (relative) and each parameter's gradient (|card - CPU| / |CPU|). f32:
# the products sum in another order on each side (measured on the H100:
# losses 8.6e-8 apart, gradients at most 8.9e-7). Under AMP each side
# rounds its bf16 products, gates and bf16 gradient sums over 100-200
# steps on its own, and a hidden state one bf16 ulp apart can move a
# max-pool's argmax (measured: losses at most 3.9e-6 apart, gradients
# 4.0e-2 lstm_varlen, 4.9e-2 lstm, 5.6e-2 the GRU twin, the same in every
# call; the card's AMP gradients lie 0.11-0.12 from the f32 build's).
RNN_LOSS_RTOL, RNN_GRAD_TOL = 1e-5, 1e-3
RNN_AMP_LOSS_RTOL, RNN_AMP_GRAD_TOL = 1e-4, 1e-1
RNN_GROUPS = ("gemm", "nvjet", "gemv", "elementwise", "reduce", "Cat")


def _recurrent_program(pt, c, ragged, rnn="lstm"):
    """bench.py's bench_lstm_step (``ragged`` False: T fixed) or
    bench_lstm_varlen (True: a ``lod_level=1`` feed and its lengths), with
    the port as ``pt``; ``rnn="gru"`` builds the ``dynamic_gru`` twin (3 x
    hidden projections). Returns (main, startup, loss, params_grads,
    [(Hidden, LastH) of each recurrent op])."""
    from paddle_tpu_torch import layers

    hidden = c["hidden"]
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        if ragged:
            words = layers.data("words", shape=[1], dtype="int64",
                                lod_level=1)
        else:
            words = layers.data("words", shape=[c["seqlen"]], dtype="int64")
        label = layers.data("label", shape=[1], dtype="int64")
        x = layers.embedding(words, size=[c["vocab"], hidden])
        x.seq_len = getattr(words, "seq_len", None)
        for _ in range(2):
            size = (4 if rnn == "lstm" else 3) * hidden
            proj = layers.fc(x, size=size, num_flatten_dims=2,
                             bias_attr=False)
            proj.seq_len = x.seq_len
            if rnn == "lstm":
                x, _ = layers.dynamic_lstm(proj, size)
            else:
                x = layers.dynamic_gru(proj, hidden)
        pooled = layers.sequence_pool(x, "max")
        logits = layers.fc(pooled, size=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        params_grads = pt.optimizer.AdamOptimizer(
            learning_rate=c["lr"]).minimize(loss, startup_program=startup)
    seqs = [(op.outputs["Hidden"][0], op.outputs["LastH"][0])
            for op in main.global_block.ops if op.type == rnn]
    return main, startup, loss, params_grads, seqs


def _recurrent_feed(c, ragged):
    """bench.py's synthetic batch: fixed T, or IMDB-like ragged lengths
    (geometric, mean 80, clipped to [8, 200]) padded to the batch's
    longest."""
    import numpy as np

    rng = np.random.RandomState(0)
    b, vocab = c["batch"], c["vocab"]
    if not ragged:
        return {"words": rng.randint(0, vocab, size=(b, c["seqlen"]))
                .astype("int64"),
                "label": rng.randint(0, 2, size=(b, 1)).astype("int64")}
    lengths = np.clip(rng.geometric(1.0 / c["mean_len"], size=b), 8,
                      c["cap"]).astype(np.int32)
    T = int(lengths.max())
    return {"words": rng.randint(0, vocab, size=(b, T)).astype("int64"),
            "words@len": lengths,
            "label": rng.randint(0, 2, size=(b, 1)).astype("int64")}


def _on_device(feed, device):
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in feed.items()}


def _padding_gate(hidden, last, lengths):
    """Gate 4: Hidden is exactly 0 at every padded position, and LastH is
    Hidden at length - 1 of each row."""
    import torch

    T = hidden.shape[1]
    lengths = lengths.to(hidden.device).long()
    pad = torch.arange(T, device=hidden.device)[None, :] >= lengths[:, None]
    assert int(pad.sum()) > 0 and not hidden[pad].any(), \
        "a padded position of Hidden is not 0"
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    assert torch.equal(last, hidden[rows, lengths - 1]), \
        "LastH is not Hidden at length - 1"


def _card_vs_cpu(pt, built, state, dtypes, feed, f32_grads=None):
    """Gate 1: step 1 of ``built`` on the card and on the CPU from the same
    state (``state`` in ``dtypes``) and feed; under AMP (``f32_grads``,
    the f32 build's step-1 gradients on the card from the same state)
    also how far the card's AMP gradients lie from f32's, the yardstick
    of bf16 rounding. Returns the card's fetches (loss, every gradient,
    each recurrent op's Hidden and LastH) and the record."""
    import torch

    main, _, loss, params_grads, seqs = built
    grads = [g.name for _, g in params_grads]
    fetch = [loss.name] + grads + [n for pair in seqs for n in pair]
    def scope_on(device):
        scope = pt.Scope()
        for n, t in state.items():
            scope.set(n, t.to(device=device, dtype=dtypes.get(n, t.dtype)))
        return scope

    card = pt.Executor(pt.CUDAPlace()).run(
        main, feed=_on_device(feed, "cuda"), fetch_list=fetch,
        scope=scope_on("cuda"), return_numpy=False)
    t0 = time.perf_counter()
    cpu = pt.Executor(pt.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=scope_on("cpu"),
        return_numpy=False)
    cpu_s = time.perf_counter() - t0
    lc, lh = float(card[0]), float(cpu[0])
    n = len(grads)
    card_grads = [g.cpu() for g in card[1:1 + n]]
    worst = _grad_gap(grads, card_grads, cpu[1:1 + n])
    amp = f32_grads is not None
    loss_tol, grad_tol = ((RNN_AMP_LOSS_RTOL, RNN_AMP_GRAD_TOL) if amp
                          else (RNN_LOSS_RTOL, RNN_GRAD_TOL))
    rel = abs(lc - lh) / abs(lh)
    bf16 = sum(g.dtype == torch.bfloat16 for g in card_grads)
    rec = {"loss_card": lc, "loss_cpu": lh, "loss_rel": rel,
           "loss_tol": loss_tol, "worst_grad_rel": worst,
           "grad_tol": grad_tol, "cpu_step_s": cpu_s, "bf16_grads": bf16,
           "grads": n}
    if amp:
        rec["vs_f32_grad_rel"] = _grad_gap(grads, card_grads, f32_grads)
    return card, rec


def _gate1_text(tag, r):
    text = (f"{tag}: step-1 loss card {r['loss_card']:.6f} CPU "
            f"{r['loss_cpu']:.6f} (rel {r['loss_rel']:.3e}, tol "
            f"{r['loss_tol']}); worst gradient |card - CPU| / |CPU| "
            f"{r['worst_grad_rel'][0]:.3e} ({r['worst_grad_rel'][1]}, tol "
            f"{r['grad_tol']}); {r['grads']} gradients, {r['bf16_grads']} "
            f"bf16; the CPU step took {r['cpu_step_s']:.1f} s")
    if "vs_f32_grad_rel" in r:
        gap, name = r["vs_f32_grad_rel"]
        text += (f"; the card's AMP gradients lie {gap:.3e} ({name}) from "
                 f"the f32 build's")
    return text


def _gate1(r):
    assert r["loss_rel"] <= r["loss_tol"], r
    assert r["worst_grad_rel"][0] <= r["grad_tol"], r


def _bench_steps(exe, main, feed, loss, scope, warmup=RNN_WARMUP,
                 steps=RNN_STEPS):
    """bench.py's scaffold: the batch on the card, ``warmup`` steps, then
    ``steps`` dispatches closed by one blocking fetch. Returns (seconds a
    step, the timed steps' losses)."""
    import torch

    dev_feed = _on_device(feed, "cuda")
    for _ in range(warmup):
        exe.run(main, feed=dev_feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    outs = []
    t0 = time.perf_counter()
    for _ in range(steps):
        out, = exe.run(main, feed=dev_feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        outs.append(out)
    float(outs[-1])
    sec = (time.perf_counter() - t0) / steps
    return sec, [float(o) for o in outs]


def _step_anatomy(exe, main, feed, loss, scope, path, groups=RNN_GROUPS):
    """One step's host time (the dispatch, until ``run`` returns; the
    wall, until the card is done; medians of 3), then one step profiled:
    device ms and kernel launches by group (``groups``; the GEMM and
    elementwise sums read RNN_GROUPS' names)."""
    import numpy as np
    import torch

    dev_feed = _on_device(feed, "cuda")
    dispatch, wall = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(main, feed=dev_feed, fetch_list=[loss], scope=scope,
                return_numpy=False)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        dispatch.append(t1 - t0)
        wall.append(time.perf_counter() - t0)
    prof = _profile_step(
        lambda: exe.run(main, feed=dev_feed, fetch_list=[loss], scope=scope,
                        return_numpy=False), path, groups=groups)
    rec = {"host_dispatch_ms": float(np.median(dispatch)) * 1e3,
           "wall_ms": float(np.median(wall)) * 1e3, "profile": prof}
    if prof:
        k = prof["kernels_ms"]
        rec.update(device_ms=prof["device_ms"],
                   launches=prof["kernel_launches"],
                   gemm_ms=sum(k.get(g, 0.0) for g in ("gemm", "nvjet",
                                                        "gemv")),
                   elementwise_ms=k.get("elementwise", 0.0))
    return rec


def _anatomy_text(tag, a):
    dev = a.get("device_ms")
    text = (f"{tag}: one step, host dispatch {a['host_dispatch_ms']:.1f} ms,"
            f" wall {a['wall_ms']:.1f} ms, device {_ms_text(dev, '.1f')} ms")
    if dev is not None:
        text += (f" ({dev / a['wall_ms'] * 100:.1f}% of the wall; GEMM "
                 f"{a['gemm_ms']:.1f} ms, elementwise "
                 f"{a['elementwise_ms']:.1f} ms), {a['launches']} kernel "
                 f"launches")
    return text


def recurrent_row(pt, c, ragged, time_f32):
    """One recurrent row: the f32 program from its startup on the card
    (Gate 1 in f32), then built under AMP with the same
    names from the same state (Gate 1 under AMP, Gate 2: its step-1 loss
    within AMP_RTOL of f32's); Gate 4 on a ragged feed; bench.py's timing
    under AMP (and in f32 with ``time_f32``) with Gate 3 (the loss falls
    over the timed steps) and one step's anatomy."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core import program as tprog

    name = "lstm_varlen" if ragged else "lstm"
    feed = _recurrent_feed(c, ragged)
    T = feed["words"].shape[1]
    true_tokens = int(feed["words@len"].sum()) if ragged else c["batch"] * T
    waste = 1.0 - true_tokens / (c["batch"] * T)
    start = tprog.Program._uid_counter
    t0 = time.perf_counter()
    built = _recurrent_program(pt, c, ragged)
    exe = pt.Executor(pt.CUDAPlace())
    scope = pt.Scope()
    exe.run(built[1], scope=scope)
    state = _snapshot(scope)
    print(f"{name}: T {T}, {true_tokens} true tokens, padded_flop_waste "
          f"{waste:.3f}; f32 program of {len(built[0].global_block.ops)} "
          f"ops built and initialised in {time.perf_counter() - t0:.2f} s")
    rec = {"T": T, "true_tokens": true_tokens, "padded_flop_waste": waste}
    f32_card, rec["gate1_f32"] = _card_vs_cpu(pt, built, state, {}, feed)
    f32_grads = [g.cpu() for g in f32_card[1:1 + len(built[3])]]
    print(_gate1_text(f"{name} f32", rec["gate1_f32"]))
    _gate1(rec["gate1_f32"])
    l32 = rec["gate1_f32"]["loss_card"]
    if ragged:
        for h, last in zip(f32_card[-4::2], f32_card[-3::2]):
            _padding_gate(h, last, torch.from_numpy(feed["words@len"]))
    if time_f32:
        _restore(scope, state)
        sec, losses = _bench_steps(exe, built[0], feed, built[2], scope)
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        rec["f32"] = {"ms_per_batch": sec * 1e3, "losses": losses,
                      "anatomy": _step_anatomy(
                          exe, built[0], feed, built[2], scope,
                          f"{name}_f32_profile.txt")}
        print(f"{name} f32: {sec * 1e3:.1f} ms/batch, losses "
              f"{losses[0]:.5f} -> {losses[-1]:.5f} over {RNN_STEPS} steps")
        print(_anatomy_text(f"{name} f32", rec["f32"]["anatomy"]))
    del f32_card, scope
    torch.cuda.empty_cache()

    tprog.Program._uid_counter = start  # the AMP build's names are equal
    with _Amp():
        built = _recurrent_program(pt, c, ragged)
        block = built[0].global_block
        dtypes = {n: block.var(n).dtype for n in state if block.has_var(n)}
        n_bf16 = sum(d == torch.bfloat16 for d in dtypes.values())
        amp_card, rec["gate1_amp"] = _card_vs_cpu(pt, built, state, dtypes,
                                                  feed, f32_grads)
        print(_gate1_text(f"{name} AMP", rec["gate1_amp"])
              + f"; {n_bf16} parameters declared bf16")
        _gate1(rec["gate1_amp"])
        la = rec["gate1_amp"]["loss_card"]
        print(f"{name} AMP: step-1 loss {la:.6f}, f32 {l32:.6f} (rel "
              f"{abs(la - l32) / abs(l32):.3e}, tol {AMP_RTOL})")
        assert np.isfinite(la) and abs(la - l32) <= AMP_RTOL * abs(l32)
        if ragged:
            for h, last in zip(amp_card[-4::2], amp_card[-3::2]):
                assert h.dtype == torch.bfloat16
                _padding_gate(h, last, torch.from_numpy(feed["words@len"]))
        del amp_card
        scope = pt.Scope()
        _restore(scope, state, dtypes)
        sec, losses = _bench_steps(exe, built[0], feed, built[2], scope)
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        anatomy = _step_anatomy(exe, built[0], feed, built[2], scope,
                                f"{name}_amp_profile.txt")
        kept = {str(scope.get(p.name).dtype) for p, _ in built[3]
                if dtypes[p.name] == torch.bfloat16}
        assert kept == {"torch.bfloat16"}, kept  # Adam keeps them bf16
    rec["amp"] = {"ms_per_batch": sec * 1e3, "losses": losses,
                  "tokens_per_s": true_tokens / sec, "params_bf16": n_bf16,
                  "anatomy": anatomy}
    print(f"{name} AMP: {sec * 1e3:.1f} ms/batch, {true_tokens / sec:.0f} "
          f"tokens/s, losses {losses[0]:.5f} -> {losses[-1]:.5f} over "
          f"{RNN_STEPS} steps")
    print(_anatomy_text(f"{name} AMP", anatomy))
    del scope, exe, state
    torch.cuda.empty_cache()
    return rec


def gru_twin(pt, c):
    """The ``dynamic_gru`` twin of the lstm row: step 1 only, Gate 1 in
    f32 and under AMP from the same state."""
    import torch

    from paddle_tpu_torch.core import program as tprog

    feed = _recurrent_feed(c, ragged=False)
    start = tprog.Program._uid_counter
    built = _recurrent_program(pt, c, ragged=False, rnn="gru")
    scope = pt.Scope()
    pt.Executor(pt.CUDAPlace()).run(built[1], scope=scope)
    state = _snapshot(scope)
    del scope
    rec = {}
    card, rec["gate1_f32"] = _card_vs_cpu(pt, built, state, {}, feed)
    f32_grads = [g.cpu() for g in card[1:1 + len(built[3])]]
    del card
    print(_gate1_text("gru twin f32", rec["gate1_f32"]))
    _gate1(rec["gate1_f32"])
    tprog.Program._uid_counter = start
    with _Amp():
        built = _recurrent_program(pt, c, ragged=False, rnn="gru")
        block = built[0].global_block
        dtypes = {n: block.var(n).dtype for n in state if block.has_var(n)}
        _, rec["gate1_amp"] = _card_vs_cpu(pt, built, state, dtypes, feed,
                                           f32_grads)
    print(_gate1_text("gru twin AMP", rec["gate1_amp"]))
    _gate1(rec["gate1_amp"])
    torch.cuda.empty_cache()
    return rec


def _generate_program(pt, c):
    """bench.py's bench_decode program: the stacked LM's greedy KV-cache
    decoding (``models.transformer_lm_generate``)."""
    from paddle_tpu_torch import layers, models

    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        prompt = layers.data("prompt", shape=[c["prefill"]], dtype="int64")
        out_ids = models.transformer_lm_generate(
            prompt, vocab_size=c["vocab"], d_model=c["d_model"],
            n_layers=c["n_layers"], num_heads=c["num_heads"],
            max_len=c["prefill"] + c["new"], max_new_tokens=c["new"])
    return main, startup, out_ids


def decode_row(pt):
    """bench.py's bench_decode at bs8, prefill 1024, 128 new tokens, d1024
    L8 H8, V16384, from the startup's seeded weights: one f32 run whose
    tokens equal the plain path's on the card, then under AMP (as bench.py
    runs it) tokens/s over DECODE_STEPS runs after DECODE_WARMUP. Each run
    launches the f32 flash forward once a layer (the prefill; the stack
    casts q, k and v to f32) and no other flash kernel."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core import program as tprog
    from paddle_tpu_torch.kernels import flash_attention as fa

    c = DECODE
    b, Tp, N, L = c["batch"], c["prefill"], c["new"], c["n_layers"]
    rng = np.random.RandomState(0)
    feed = _on_device({"prompt": rng.randint(0, c["vocab"], (b, Tp))
                       .astype("int64")}, "cuda")

    def check(toks):
        assert toks.shape == (b, Tp + N)
        assert torch.equal(toks[:, :Tp], feed["prompt"])
        assert bool(((toks >= 0) & (toks < c["vocab"])).all())

    start = tprog.Program._uid_counter
    main, startup, out_ids = _generate_program(pt, c)
    exe, scope = pt.Executor(pt.CUDAPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    state = _snapshot(scope)
    _reset_flash_counts(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f32, = exe.run(main, feed=feed, fetch_list=[out_ids], scope=scope,
                   return_numpy=False)
    check(f32)
    f32_s = time.perf_counter() - t0
    assert _flash_counts(fa) == (L,) + (0,) * 5, _flash_counts(fa)
    with _plain_flash(fa):
        plain, = exe.run(main, feed=feed, fetch_list=[out_ids], scope=scope,
                         return_numpy=False)
    assert torch.equal(plain, f32), "greedy tokens differ from the plain path"
    print(f"decode f32: one run {f32_s * 1e3:.0f} ms ({b * N / f32_s:.0f} "
          f"tokens/s), {L} f32 flash forward launches, tokens equal the "
          f"plain path's")

    tprog.Program._uid_counter = start  # the AMP build's names are equal
    with _Amp():
        main, _, out_ids = _generate_program(pt, c)
        scope = pt.Scope()
        _restore(scope, state)
        for _ in range(DECODE_WARMUP):
            exe.run(main, feed=feed, fetch_list=[out_ids], scope=scope)
        torch.cuda.synchronize()
        _reset_flash_counts(fa)
        t0 = time.perf_counter()
        outs = [exe.run(main, feed=feed, fetch_list=[out_ids], scope=scope,
                        return_numpy=False)[0]
                for _ in range(DECODE_STEPS)]
        toks = outs[-1].cpu()
        sec = (time.perf_counter() - t0) / DECODE_STEPS
    counts = _flash_counts(fa)
    assert counts == (DECODE_STEPS * L,) + (0,) * 5, counts
    check(toks.to(f32.device))
    assert all(torch.equal(o, outs[-1]) for o in outs)
    same = float((toks[:, Tp:] == f32[:, Tp:].cpu()).float().mean())
    print(f"decode AMP: bs{b} prefill {Tp} decode {N} d{c['d_model']} L{L}:"
          f" {b * N / sec:.0f} tokens/s ({sec * 1e3:.0f} ms a run, "
          f"{DECODE_STEPS} runs after {DECODE_WARMUP}); f32 flash forward "
          f"launches {counts[0]} ({L} a run); {same * 100:.1f}% of the new "
          f"tokens equal the f32 run's")
    del exe, scope, outs, state
    torch.cuda.empty_cache()
    return {"tokens_per_s": b * N / sec, "s_per_run": sec,
            "flash_fwd_launches_per_run": counts[0] // DECODE_STEPS,
            "f32_run_s": f32_s, "amp_tokens_equal_f32": same}


def recurrent_phase():
    """Phase 13: the lstm row (f32 and AMP), the lstm_varlen row (AMP),
    the dynamic_gru twin (step 1) and the decode row."""
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    secs = {}

    def part(name, fn, *args, **kw):
        t1 = time.perf_counter()
        result = fn(*args, **kw)
        secs[name] = time.perf_counter() - t1
        return result

    lstm = part("lstm", recurrent_row, pt, RECURRENT, ragged=False,
                time_f32=True)
    ms = lstm["amp"]["ms_per_batch"]
    print(f"lstm: {ms:.1f} ms/batch under AMP, lstm_vs_baseline "
          f"{LSTM_BASELINE_MS / ms:.3f} (the reference's "
          f"{LSTM_BASELINE_MS} ms/batch on one K40m); f32 "
          f"{lstm['f32']['ms_per_batch']:.1f} ms/batch")
    varlen = part("lstm_varlen", recurrent_row, pt, RECURRENT, ragged=True,
                  time_f32=False)
    a = varlen["amp"]
    print(f"lstm_varlen: {a['tokens_per_s']:.0f} tokens/s, "
          f"{a['ms_per_batch']:.1f} ms/batch, max_len {varlen['T']}, "
          f"padded_flop_waste {varlen['padded_flop_waste']:.2f}")
    gru = part("gru_twin", gru_twin, pt, RECURRENT)
    decode = part("decode", decode_row, pt)
    total = time.perf_counter() - t0
    print(f"recurrent rows: phase 13 took {total:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    return {"lstm": dict(lstm, lstm_vs_baseline=LSTM_BASELINE_MS / ms,
                         baseline_ms=LSTM_BASELINE_MS),
            "lstm_varlen": varlen, "gru_twin": gru, "decode": decode,
            "seconds": total, "part_seconds": secs}


# --- Phase 14: the image-zoo rows, and MobileNet served on the epilogue ------
# bench.py's reference numbers: IMAGE_MODEL_BASELINES (images/s of one
# training step at bs128: AlexNet and GoogLeNet on one K40m, VGG-16 on the
# CPU with MKL-DNN) and INFER_BASELINES (images/s at bs16, MKL-DNN).
ZOO_TRAIN_BASELINES = {"alexnet": 128 / 0.334, "googlenet": 128 / 1.149,
                       "vgg16": 30.4}
ZOO_INFER_BASELINES = {"googlenet": 600.94, "vgg19": 96.75}
# bench_image_model: 224x224x3, 1000 classes, Momentum(0.01, 0.9), bs128,
# 2 warm steps and 8 timed dispatches closed by one blocking fetch;
# bench_inference: bs16, 3 warm and 30 timed batches. Gate 1 runs step 1
# at batch 4 on the card and on the CPU; Gate 4 compares the card with
# the CPU at batch 2.
ZOO = dict(size=224, classes=1000, batch=128, gate_batch=4, lr=0.01,
           momentum=0.9, infer_batch=16, cpu_batch=2, warmup=2, steps=8,
           infer_warmup=3, infer_steps=30)
MOBILENET_POINTWISE = 13  # conv1x1_bn_act ops of MobileNet v1, transpiled
ZOO_GROUPS = ("xmma", "cudnn", "conv", "gemm", "nvjet", "gemv",
              "elementwise", "reduce", "pool", "Cat")
# Gate 1 holds the card's f32 step 1 to the CPU's: the loss within
# RNN_LOSS_RTOL; full-f32 products on both sides (cuDNN's TF32 off),
# summed in other orders. GoogLeNet's and VGG-16's step-1 gradients are
# as sensitive to rounding as ResNet's are to its BN statistics: a
# pre-activation a rounding away from zero turns its ReLU on or off and
# can move a max-pool window's gradient to another element. Measured on
# the H100 (batch 4, 224 x 224; median / largest / all together, of the
# gradients' norms): the card lies 7.2e-4 / 4.8e-3 / 1.3e-3 from the CPU
# for GoogLeNet and 2.2e-3 / 7.7e-3 / 1.3e-3 for VGG-16, and the CPU
# alone, its images nudged one f32 ulp, moves 1.8e-3 / 3.6e-3 / 1.1e-3
# and 1.0e-3 / 7.8e-3 / 8.8e-4; AlexNet's lie 1.2e-6 / 1.9e-6 and move
# 8.6e-7 / 1.3e-6. One gradient's own move is a few routing changes, a
# noisy yardstick (VGG-16's conv2d.w_1037 lay 4.3 times its own), so each
# gradient is held within RNN_GRAD_TOL of its norm, SENS_FACTOR times its
# own move under the nudge, or SENS_TOTAL times the largest move of any
# gradient under it (of its norm), whichever is largest, and all of them
# together within RNN_GRAD_TOL or SENS_TOTAL times the nudge's move.
# Gate 4: the card against the CPU on a batch of 2 at LOGIT_RTOL of the
# largest |logit|, the replay against the eager run at REPLAY_RTOL, the
# AMP logits against the f32 ones at AMP_RTOL. Gate 5: MobileNet's logits
# with the kernel against the plain path at LOGIT_RTOL (f32) or
# AMP_PLAIN_RTOL (AMP); each kernel output against its plain version at
# GEMM_TOL (f32) or one bf16 ulp (AMP), as phases 8 and 11a hold them.


def _zoo_model(pt, name, images, is_test=False):
    c = ZOO
    if name == "alexnet":
        return pt.models.alexnet(images, num_classes=c["classes"],
                                 is_test=is_test)
    if name == "googlenet":
        return pt.models.googlenet(images, num_classes=c["classes"],
                                   is_test=is_test)
    if name == "mobilenet":
        return pt.models.mobilenet(images, num_classes=c["classes"],
                                   is_test=is_test)
    depth = int(name[3:])  # vgg16, vgg19
    return pt.models.vgg(images, num_classes=c["classes"], depth=depth,
                         is_test=is_test)


def _zoo_program(pt, name):
    """bench.py's bench_image_model program: (main, startup, loss,
    params_grads, []) (no sequence outputs, for _card_vs_cpu)."""
    c = ZOO
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        images = pt.layers.data("images", shape=[c["size"], c["size"], 3])
        label = pt.layers.data("label", shape=[1], dtype="int64")
        logits = _zoo_model(pt, name, images)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits,
                                                                   label))
        params_grads = pt.optimizer.MomentumOptimizer(
            learning_rate=c["lr"], momentum=c["momentum"]).minimize(
                loss, startup_program=startup)
    return main, startup, loss, params_grads, []


def _zoo_feed():
    """bench_image_model's batch: RandomState(0) images in [0, 1) and
    labels."""
    import numpy as np

    c = ZOO
    rng = np.random.RandomState(0)
    return {"images": rng.rand(c["batch"], c["size"], c["size"], 3)
            .astype("float32"),
            "label": rng.randint(0, c["classes"], size=(c["batch"], 1))
            .astype("int64")}


def _all_kernel_counts():
    """Every launch counter of the port's kernels, f32 and bf16."""
    from paddle_tpu_torch.kernels import conv_epilogue as ke
    from paddle_tpu_torch.kernels import flash_attention as fa

    return _conv_counts(ke) + _amp_counts(ke) + _flash_counts(fa)


def _zoo_timed(exe, built, feed, scope, state, dtypes, tag, gpu_name, bf16):
    """bench_image_model's timing of one build from ``state``: Gate 3 on
    the timed losses, images/s, peak memory, the share of the peak and one
    step's anatomy."""
    import numpy as np
    import torch

    c = ZOO
    _restore(scope, state, dtypes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sec, losses = _bench_steps(exe, built[0], feed, built[2], scope,
                               c["warmup"], c["steps"])
    peak_mem = torch.cuda.max_memory_allocated()
    assert np.isfinite(losses).all(), (tag, losses)  # Gate 3
    anatomy = _step_anatomy(exe, built[0], feed, built[2], scope,
                            f"zoo_{tag}_profile.txt", groups=ZOO_GROUPS)
    flops = _train_flops(built[0], c["batch"])
    peak = _peaks(gpu_name)[3 if bf16 else 0]
    return {"ms_per_batch": sec * 1e3, "images_per_s": c["batch"] / sec,
            "losses": losses, "peak_mem_bytes": peak_mem,
            "tflop_per_step": flops / 1e12,
            "peak_share": flops / sec / peak,
            "peak": "bf16" if bf16 else "f32", "anatomy": anatomy}


def _zoo_timed_text(tag, r):
    return (f"{tag}: {r['ms_per_batch']:.1f} ms/batch, "
            f"{r['images_per_s']:.1f} images/s, {r['tflop_per_step']:.2f} "
            f"TFLOP/step = {r['peak_share'] * 100:.1f}% of the {r['peak']} "
            f"peak, peak memory {r['peak_mem_bytes'] / 2**30:.2f} GiB, "
            f"losses {r['losses'][0]:.5f} .. {r['losses'][-1]:.5f} (all "
            f"finite)\n" + _anatomy_text(tag, r["anatomy"]))


def _zoo_gate1(pt, built, state, feed):
    """Gate 1: step 1 of ``built`` in f32 on the card and on the CPU from
    ``state`` on ``feed``, and on the CPU with the images nudged one f32
    ulp up (the step's own sensitivity); the record."""
    import numpy as np
    import torch

    main, _, loss, params_grads, _ = built
    grads = [g.name for _, g in params_grads]
    fetch = [loss.name] + grads

    def step(device, f):
        scope = pt.Scope()
        for n, t in state.items():
            scope.set(n, t.to(device))
        exe = pt.Executor(pt.CUDAPlace() if device == "cuda" else
                          pt.CPUPlace())
        out = exe.run(main, feed=_on_device(f, device), fetch_list=fetch,
                      scope=scope, return_numpy=False)
        return [o.detach().float().cpu() for o in out]

    card = step("cuda", feed)
    t0 = time.perf_counter()
    cpu = step("cpu", feed)
    cpu_s = time.perf_counter() - t0
    nudged = dict(feed, images=np.nextafter(
        feed["images"], np.float32(np.inf)).astype(np.float32))
    cpu2 = step("cpu", nudged)
    lc, lh = float(card[0]), float(cpu[0])
    d_card, d_cpu, norms = [], [], []
    for name, gc, gh, g2 in zip(grads, card[1:], cpu[1:], cpu2[1:]):
        assert torch.isfinite(gc).all(), name
        d_card.append(float((gc - gh).norm()))
        d_cpu.append(float((g2 - gh).norm()))
        norms.append(float(gh.norm()))
    total = float(np.linalg.norm(d_card) / np.linalg.norm(norms))
    total_nudge = float(np.linalg.norm(d_cpu) / np.linalg.norm(norms))
    rel = np.array(d_card) / np.maximum(norms, 1e-30)
    rel_nudge = np.array(d_cpu) / np.maximum(norms, 1e-30)
    allowed = np.maximum.reduce([
        np.full(len(grads), RNN_GRAD_TOL), SENS_FACTOR * rel_nudge,
        np.full(len(grads), SENS_TOTAL * rel_nudge.max())])
    i = int(np.argmax(rel / allowed))
    worst = (float(rel[i] / allowed[i]), grads[i])
    return {"loss_card": lc, "loss_cpu": lh, "loss_rel": abs(lc - lh) /
            abs(lh), "loss_tol": RNN_LOSS_RTOL, "grads": len(grads),
            "grad_rel_median": float(np.median(rel)),
            "grad_rel_max": float(rel.max()), "grad_rel_total": total,
            "nudge_rel_median": float(np.median(rel_nudge)),
            "nudge_rel_max": float(rel_nudge.max()),
            "nudge_rel_total": total_nudge, "worst_ratio": worst,
            "cpu_step_s": cpu_s}


def _zoo_gate1_text(tag, r):
    return (f"{tag}: step-1 loss card {r['loss_card']:.6f} CPU "
            f"{r['loss_cpu']:.6f} (rel {r['loss_rel']:.3e}, tol "
            f"{r['loss_tol']}); gradients |card - CPU| / |CPU| median "
            f"{r['grad_rel_median']:.3e} max {r['grad_rel_max']:.3e}, all "
            f"together {r['grad_rel_total']:.3e}; the CPU's own move under "
            f"a one-ulp image nudge median {r['nudge_rel_median']:.3e} max "
            f"{r['nudge_rel_max']:.3e}, all together "
            f"{r['nudge_rel_total']:.3e}; worst card-to-allowance ratio "
            f"{r['worst_ratio'][0]:.3f} ({r['worst_ratio'][1]}) over "
            f"{r['grads']} gradients; the CPU step took "
            f"{r['cpu_step_s']:.1f} s")


def _zoo_gate1_check(r):
    assert r["loss_rel"] <= r["loss_tol"], r
    assert r["worst_ratio"][0] <= 1.0, r
    assert r["grad_rel_total"] <= max(SENS_TOTAL * r["nudge_rel_total"],
                                      RNN_GRAD_TOL), r


def zoo_training_row(pt, name, gpu_name):
    """One training row: the f32 program from its startup on the card
    (Gate 1: step 1 at batch 4 against the CPU), then built under AMP with
    the same names from the same state (Gate 2: its step-1 loss within
    AMP_RTOL of f32's); bench_image_model's timing under AMP (the row, as
    bench.py runs it) and in f32, with Gate 3 and one step's anatomy
    each."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core import program as tprog

    c = ZOO
    feed = _zoo_feed()
    gate_feed = {k: v[:c["gate_batch"]] for k, v in feed.items()}
    start = tprog.Program._uid_counter
    t0 = time.perf_counter()
    built = _zoo_program(pt, name)
    exe = pt.Executor(pt.CUDAPlace())
    scope = pt.Scope()
    exe.run(built[1], scope=scope)
    state = _snapshot(scope)
    n_params = sum(scope.get(p.name).numel() for p, _ in built[3])
    print(f"zoo {name}: f32 program of {len(built[0].global_block.ops)} ops, "
          f"{n_params / 1e6:.1f} M parameters, built and initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    rec = {"params": n_params}
    rec["gate1_f32"] = _zoo_gate1(pt, built, state, gate_feed)
    print(_zoo_gate1_text(f"zoo {name} f32 (batch {c['gate_batch']})",
                          rec["gate1_f32"]))
    _zoo_gate1_check(rec["gate1_f32"])
    l32 = rec["gate1_f32"]["loss_card"]
    rec["f32"] = _zoo_timed(exe, built, feed, scope, state, None,
                            f"{name}_f32", gpu_name, bf16=False)
    print(_zoo_timed_text(f"zoo {name} f32", rec["f32"]))
    del scope
    torch.cuda.empty_cache()

    tprog.Program._uid_counter = start  # the AMP build's names are equal
    with _Amp():
        built = _zoo_program(pt, name)
        block = built[0].global_block
        dtypes = {n: block.var(n).dtype for n in state if block.has_var(n)}
        n_bf16 = sum(d == torch.bfloat16 for d in dtypes.values())
        scope = pt.Scope()
        _restore(scope, state, dtypes)
        la = float(exe.run(built[0], feed=_on_device(gate_feed, "cuda"),
                           fetch_list=[built[2]], scope=scope)[0])
        print(f"zoo {name} AMP (batch {c['gate_batch']}): step-1 loss "
              f"{la:.6f}, f32 {l32:.6f} (rel {abs(la - l32) / abs(l32):.3e}, "
              f"tol {AMP_RTOL}); {n_bf16} variables declared bf16")
        assert np.isfinite(la) and abs(la - l32) <= AMP_RTOL * abs(l32)
        rec["gate2"] = {"loss_amp": la, "loss_f32": l32, "tol": AMP_RTOL}
        rec["amp"] = _zoo_timed(exe, built, feed, scope, state, dtypes,
                                f"{name}_amp", gpu_name, bf16=True)
    rec["amp"]["vs_baseline"] = (rec["amp"]["images_per_s"]
                                 / ZOO_TRAIN_BASELINES[name])
    rec["baseline_images_per_s"] = ZOO_TRAIN_BASELINES[name]
    print(_zoo_timed_text(f"zoo {name} AMP", rec["amp"]))
    print(f"zoo_{name}: {rec['amp']['images_per_s']:.1f} images/s under AMP, "
          f"vs_baseline {rec['amp']['vs_baseline']:.3f} (the reference's "
          f"{ZOO_TRAIN_BASELINES[name]:.1f} images/s); f32 "
          f"{rec['f32']['images_per_s']:.1f} images/s")
    del scope, state, exe
    torch.cuda.empty_cache()
    return rec


def _engine_replay(pt, model_dir, x, tag, kernel_names=(), expect=None):
    """InferenceEngine on ``model_dir`` with one CUDA graph at x's batch:
    (the replay's logits, median ms of 10 replays after 2, the graph's
    device ms, its profiled kernel counts; ``expect`` as
    _count_kernels)."""
    import numpy as np
    import torch

    eng = pt.InferenceEngine(str(model_dir), place=pt.CUDAPlace(0),
                             batch_buckets=(x.shape[0],))
    eng.warmup()
    replay = eng.run({"images": x})[0]
    counted = (_count_kernels(lambda: eng.run({"images": x}), kernel_names,
                              expect)
               if kernel_names else None)
    rep_s = []
    for i in range(12):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.run({"images": x})
        torch.cuda.synchronize()
        if i >= 2:
            rep_s.append(time.perf_counter() - t1)
    graph = eng._graphs[eng._signature({"images": x})][0]
    device_ms = _device_ms(graph.replay)
    profile = _profile_step(graph.replay, f"zoo_{tag}_serving_profile.txt",
                            groups=("conv1x1_bf16_kernel",
                                    "conv1x1_tf32x3_kernel") + ZOO_GROUPS)
    eng.close()
    del eng, graph
    torch.cuda.empty_cache()
    return replay, float(np.median(rep_s)) * 1e3, device_ms, counted, profile


def zoo_serving_row(pt, name):
    """One serving row, as bench_inference runs it: the model built with
    is_test=False from its seeded startup on the card, saved through the
    inference transpiler, loaded and run by Executor.run at bs16 (3 warm,
    30 timed) in f32 and under AMP; the same directory served by
    InferenceEngine (the replayed batch). Gate 4: the replay against
    Executor.run, the card against the CPU on a batch of 2 (f32), the AMP
    logits against the f32 ones."""
    import collections
    import shutil

    import numpy as np
    import torch

    c = ZOO
    B = c["infer_batch"]
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        images = pt.layers.data("images", shape=[c["size"], c["size"], 3])
        logits = _zoo_model(pt, name, images)
    exe = pt.Executor(pt.CUDAPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    model_dir = ROOT / "build" / f"zoo_{name}_inference"
    shutil.rmtree(model_dir, ignore_errors=True)
    t0 = time.perf_counter()
    pt.io.save_inference_model(str(model_dir), ["images"], [logits], exe,
                               main_program=main, scope=scope)
    save_s = time.perf_counter() - t0
    del scope
    meta = pt.io.read_inference_model_meta(str(model_dir))
    ops = collections.Counter(op["type"] for op in
                              meta["program"]["blocks"][0]["ops"])
    assert not ops["dropout"], ops
    load_scope = pt.Scope()
    prog, feeds, fetches = pt.io.load_inference_model(str(model_dir), exe,
                                                      scope=load_scope)
    x = np.random.RandomState(0).rand(B, c["size"], c["size"], 3).astype(
        "float32")
    dev = {feeds[0]: torch.from_numpy(x).cuda()}
    rec = {"ops": dict(ops), "save_s": save_s,
           "baseline_images_per_s": ZOO_INFER_BASELINES[name]}
    out = {}
    for amp in (False, True):
        tag = "amp" if amp else "f32"
        with _Amp() if amp else contextlib.nullcontext():
            for _ in range(c["infer_warmup"]):
                exe.run(prog, feed=dev, fetch_list=fetches, scope=load_scope)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(c["infer_steps"]):
                o, = exe.run(prog, feed=dev, fetch_list=fetches,
                             scope=load_scope, return_numpy=False)
            eager = o.float().cpu().numpy()
            sec = (time.perf_counter() - t0) / c["infer_steps"]
            replay, rep_ms, dev_ms, _, profile = _engine_replay(
                pt, model_dir, x, f"{name}_{tag}")
        assert eager.shape == (B, c["classes"]) and np.isfinite(eager).all()
        ref = float(np.abs(eager).max())
        e_rep = float(np.abs(replay - eager).max())
        assert e_rep <= REPLAY_RTOL * ref, (name, tag, e_rep, ref)  # Gate 4
        out[tag] = eager
        rec[tag] = {"ms_per_batch": sec * 1e3, "images_per_s": B / sec,
                    "vs_baseline": B / sec / ZOO_INFER_BASELINES[name],
                    "replay_ms": rep_ms, "replay_images_per_s":
                    B / rep_ms * 1e3, "replay_device_ms": dev_ms,
                    "replay_vs_eager_max_abs": e_rep,
                    "replay_bitwise_eager": bool(np.array_equal(replay,
                                                                eager)),
                    "logits_max_abs": ref, "replay_profile": profile}
        r = rec[tag]
        print(f"infer_{name} {tag}: Executor.run {r['ms_per_batch']:.3f} "
              f"ms/batch, {r['images_per_s']:.1f} images/s, vs_baseline "
              f"{r['vs_baseline']:.3f} (the reference's "
              f"{ZOO_INFER_BASELINES[name]} images/s); InferenceEngine "
              f"replay {rep_ms:.3f} ms ({r['replay_images_per_s']:.1f} "
              f"images/s), the graph {_ms_text(dev_ms)} ms of device time; "
              f"replay vs Executor.run max abs {e_rep:.3e} (bitwise "
              f"{r['replay_bitwise_eager']}; tol {REPLAY_RTOL} of max "
              f"|logit| {ref:.3e})")
    e_amp = float(np.abs(out["amp"] - out["f32"]).max())
    ref = float(np.abs(out["f32"]).max())
    assert e_amp <= AMP_RTOL * ref, (name, e_amp, ref)  # Gate 4
    # the card against the CPU on a batch of 2 (f32)
    n = c["cpu_batch"]
    card2, = exe.run(prog, feed={feeds[0]: dev[feeds[0]][:n]},
                     fetch_list=fetches, scope=load_scope)
    cpu_exe = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    cprog, cfeeds, cfetches = pt.io.load_inference_model(
        str(model_dir), cpu_exe, scope=cpu_scope)
    cpu2, = cpu_exe.run(cprog, feed={cfeeds[0]: x[:n]}, fetch_list=cfetches,
                        scope=cpu_scope)
    ref2 = float(np.abs(cpu2).max())
    e_cpu = float(np.abs(card2 - cpu2).max())
    assert e_cpu <= LOGIT_RTOL * ref2, (name, e_cpu, ref2)  # Gate 4
    rec["gate4"] = {"amp_vs_f32_max_abs": e_amp, "f32_logits_max_abs": ref,
                    "amp_tol": AMP_RTOL, "card_vs_cpu_max_abs": e_cpu,
                    "cpu_logits_max_abs": ref2, "cpu_tol": LOGIT_RTOL}
    print(f"infer_{name}: {sum(ops.values())} ops saved "
          f"({dict(ops)}); AMP logits vs f32 max abs {e_amp:.3e} (tol "
          f"{AMP_RTOL} of {ref:.3e}); the card vs the CPU on {n} images "
          f"{e_cpu:.3e} (tol {LOGIT_RTOL} of {ref2:.3e})")
    del load_scope, cpu_scope, dev
    torch.cuda.empty_cache()
    return rec


def _mobilenet_kernel_rows(shapes, bf16, gpu_name):
    """The conv-epilogue kernel at each of MobileNet's pointwise shapes
    against its plain version (Gate 5), then timed with CUDA events in
    turns with torch.matmul (kernel, library, library, kernel) beside the
    plain version and the bound. Returns (rows, the largest error)."""
    import torch

    from paddle_tpu_torch.kernels import conv_epilogue as ke
    from paddle_tpu_torch.ops.common import f32_accumulation

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    dt = torch.bfloat16 if bf16 else torch.float32
    rows, worst = [], 0.0
    for R, I, O, res, act in shapes:
        assert not res and act == "relu", (R, I, O, res, act)
        x = torch.randn(R, I, device="cuda", generator=gen).to(dt)
        w = (torch.randn(I, O, device="cuda", generator=gen)
             * I ** -0.5).to(dt)
        scale = 1.0 + 0.2 * torch.randn(O, device="cuda", generator=gen)
        shift = 0.1 * torch.randn(O, device="cuda", generator=gen)
        got = ke.conv1x1_epilogue(x, w, scale, shift, None, act)
        want = ke.conv1x1_epilogue_reference(x, w, scale, shift, None, act)
        torch.cuda.synchronize()
        if bf16:
            err = _bf16_ulps(got, want)
            assert got.dtype == dt and err <= 1.0, (R, I, O, err)
        else:
            err = _assert_close(got, want, GEMM_TOL,
                                f"mobilenet conv1x1_epilogue {R}x{I}x{O}")

        def lib():
            with f32_accumulation():
                return torch.matmul(x, w)

        calls = (lambda: ke.conv1x1_epilogue(x, w, scale, shift, None, act),
                 lambda: ke.conv1x1_epilogue_reference(x, w, scale, shift,
                                                       None, act), lib)
        turns = [_cuda_ms(calls[i], iters=20) for i in (0, 2, 2, 0)]
        flops, nbytes = (_conv_work_bf16 if bf16 else _conv_work)(
            "conv1x1_epilogue", R, I, O, False, act)
        bound, by, bound_simt = _bound(flops, nbytes, gpu_name, bf16=bf16)
        # back to back, the wrapper's host work can outlast its kernels:
        # the device time from a profiler trace goes beside
        row = {"shape": [R, I, O], "err": err,
               "ms": (turns[0] + turns[3]) / 2,
               "library_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
               "device_ms": _device_ms(calls[0]),
               "library_device_ms": _device_ms(calls[2]),
               "plain_ms": _cuda_ms(calls[1], iters=10), "bound_ms": bound,
               "bound_by": by, "bound_ms_simt": bound_simt,
               "plan": list(ke.tile_plan(R, I, O, True, ke.K_TILE_BF16)
                            if bf16 else ke.tile_plan(R, I, O,
                                                      split_k=True))}
        rows.append(row)
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        print(f"mobilenet {'bf16 ' if bf16 else ''}conv1x1_epilogue R{R} "
              f"I{I} O{O} relu plan {tuple(row['plan'])}: "
              f"{err:.3e}{' ulp (tol 1)' if bf16 else f' (tol {GEMM_TOL})'}"
              f"; {row['ms']:.4f} ms (device "
              f"{_ms_text(row['device_ms'], '.4f')}), plain "
              f"{row['plain_ms']:.4f}, torch.matmul {row['library_ms']:.4f} "
              f"(device {_ms_text(row['library_device_ms'], '.4f')}), bound "
              f"{bound:.4f} ({by})")
        del x, w, got, want, calls
    _reset_conv_counts(ke)  # comparison launches do not count
    _reset_amp_counts(ke)
    return rows, worst


def mobilenet_serving_phase(gpu_name):
    """MobileNet v1 (scale 1.0) saved under --fused_conv_epilogue (13
    conv1x1_bn_act ops) and served at bs16 in f32 and under AMP: the
    kernel at each pointwise shape (Gate 5, timed), the main path (one
    eager batch of the loaded program: 13 launches of conv1x1_epilogue,
    or of its bf16 instance), the logits against the plain path (Gate 5)
    and the InferenceEngine replay (13 GEMM launches in a profiled
    replay, images/s). Returns (kernel records, the phase's record)."""
    import collections
    import shutil

    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import conv_epilogue as ke

    c = ZOO
    B = c["infer_batch"]
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        images = pt.layers.data("images", shape=[c["size"], c["size"], 3])
        logits = _zoo_model(pt, "mobilenet", images)
    exe = pt.Executor(pt.CUDAPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    model_dir = ROOT / "build" / "zoo_mobilenet_inference"
    shutil.rmtree(model_dir, ignore_errors=True)
    pt.flags.FLAGS.fused_conv_epilogue = True
    try:
        pt.io.save_inference_model(str(model_dir), ["images"], [logits], exe,
                                   main_program=main, scope=scope)
    finally:
        pt.flags.FLAGS.fused_conv_epilogue = False
    del scope
    meta = pt.io.read_inference_model_meta(str(model_dir))
    ops = collections.Counter(op["type"] for op in
                              meta["program"]["blocks"][0]["ops"])
    assert ops["conv1x1_bn_act"] == MOBILENET_POINTWISE, ops
    assert not ops["batch_norm"], ops
    load_scope = pt.Scope()
    prog, feeds, fetches = pt.io.load_inference_model(str(model_dir), exe,
                                                      scope=load_scope)
    shapes = _fused_shapes(prog, B)
    assert len(shapes) == MOBILENET_POINTWISE, shapes
    print(f"mobilenet: saved {sum(ops.values())} ops ({dict(ops)}); the "
          f"pointwise shapes at batch {B}: "
          f"{[(R, I, O) for R, I, O, _, _ in shapes]}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    x = torch.rand(B, c["size"], c["size"], 3, device="cuda", generator=gen)
    feed = {feeds[0]: x}
    records, rec = [], {"ops": dict(ops), "shapes": [list(s[:3])
                                                     for s in shapes]}
    f32_logits = None
    for bf16 in (False, True):
        tag = "amp" if bf16 else "f32"
        name = "conv1x1_epilogue" + ("_bf16" if bf16 else "")
        with _Amp() if bf16 else contextlib.nullcontext():
            rows, worst = _mobilenet_kernel_rows(shapes, bf16, gpu_name)
            # the main path: one eager batch of the loaded program
            _reset_conv_counts(ke)
            _reset_amp_counts(ke)
            kern, = exe.run(prog, feed=feed, fetch_list=fetches,
                            scope=load_scope, return_numpy=False)
            counts = (_amp_counts(ke) if bf16 else _conv_counts(ke))
            other = (_conv_counts(ke) if bf16 else _amp_counts(ke))
            assert counts == (0, MOBILENET_POINTWISE, 0), (tag, counts)
            assert other == (0, 0, 0), (tag, other)
            plain, = _plain_step(exe, prog, feed, fetches, load_scope, ke)
            kern, plain = kern.float().cpu().numpy(), plain.float().cpu(
            ).numpy()
            ref = float(np.abs(plain).max())
            e_plain = float(np.abs(kern - plain).max())
            tol = AMP_PLAIN_RTOL if bf16 else LOGIT_RTOL
            assert kern.shape == (B, c["classes"]) and np.isfinite(kern).all()
            assert e_plain <= tol * ref, (tag, e_plain, ref)  # Gate 5
            kname = "conv1x1_bf16_kernel" if bf16 else "conv1x1_tf32x3_kernel"
            replay, rep_ms, dev_ms, counted, profile = _engine_replay(
                pt, model_dir, x.cpu().numpy(), f"mobilenet_{tag}",
                (kname,), expect={kname: MOBILENET_POINTWISE})
            assert counted is not None and counted[kname] == \
                MOBILENET_POINTWISE, counted
            e_rep = float(np.abs(replay - kern).max())
            assert e_rep <= REPLAY_RTOL * ref, (tag, e_rep, ref)
        if bf16:
            e_f32 = float(np.abs(kern - f32_logits).max())
            assert e_f32 <= AMP_RTOL * float(np.abs(f32_logits).max()), e_f32
        else:
            f32_logits, e_f32 = kern, 0.0
        per = {k: sum(r[k] for r in rows) for k in
               ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ms_simt",
                "device_ms", "library_device_ms")
               if all(r[k] is not None for r in rows)}
        top = max(rows, key=lambda r: r["bound_ms"])
        records.append({
            "name": f"{name}@mobilenet", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/conv_epilogue.cu",
            "replaces": f"paddle_tpu/kernels/conv_epilogue.py:"
                        f"{CONV_REPLACES['conv1x1_epilogue']}",
            "launches": counts[1], "max_abs_err": worst,
            "ms": per["ms"], "plain_ms": per["plain_ms"],
            "bound_ms": per["bound_ms"], "bound_by": top["bound_by"],
            "bound_ms_simt": per["bound_ms_simt"],
            "library_ms": per["library_ms"],
            "library": "torch.matmul" + (" in bf16 (f32 accumulation)"
                                         if bf16 else "") + ", product only",
            "shape": f"MobileNet v1's {MOBILENET_POINTWISE} pointwise convs "
                     f"at batch {B}, summed a batch",
            "per_shape": rows})
        rec[tag] = {"launches_per_batch": counts[1],
                    "logits_vs_plain_max_abs": e_plain,
                    "logits_max_abs": ref, "plain_tol": tol,
                    "replay_vs_eager_max_abs": e_rep,
                    "amp_vs_f32_max_abs": e_f32,
                    "replay_kernels": counted, "replay_ms": rep_ms,
                    "replay_images_per_s": B / rep_ms * 1e3,
                    "replay_device_ms": dev_ms, "replay_profile": profile,
                    "kernel_ms_per_batch": per}
        print(f"mobilenet {tag}: {counts[1]} {name} launches in one eager "
              f"batch; logits vs the plain path max abs {e_plain:.3e} (tol "
              f"{tol} of {ref:.3e}); replay vs eager {e_rep:.3e}; the "
              f"profiled replay launched {counted}; replay {rep_ms:.3f} ms, "
              f"{B / rep_ms * 1e3:.1f} images/s, the graph "
              f"{_ms_text(dev_ms)} ms of device time; the kernel per batch "
              f"{per['ms']:.4f} ms (device "
              f"{_ms_text(per.get('device_ms'), '.4f')}; plain "
              f"{per['plain_ms']:.4f}, torch.matmul {per['library_ms']:.4f}"
              f", device {_ms_text(per.get('library_device_ms'), '.4f')}; "
              f"bound {per['bound_ms']:.4f})")
    del load_scope, feed
    torch.cuda.empty_cache()
    return records, rec


def zoo_phase(gpu_name):
    """Phase 14: bench.py's zoo_alexnet, zoo_googlenet and zoo_vgg16
    training rows, its infer_googlenet and infer_vgg19 serving rows, and
    MobileNet v1 served under --fused_conv_epilogue. Returns (kernel
    records, the phase's record)."""
    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    secs = {}
    before = _all_kernel_counts()
    rec = {}
    for name in ZOO_TRAIN_BASELINES:
        t1 = time.perf_counter()
        rec[f"zoo_{name}"] = zoo_training_row(pt, name, gpu_name)
        secs[f"zoo_{name}"] = time.perf_counter() - t1
    for name in ZOO_INFER_BASELINES:
        t1 = time.perf_counter()
        rec[f"infer_{name}"] = zoo_serving_row(pt, name)
        secs[f"infer_{name}"] = time.perf_counter() - t1
    # the zoo's convs have a bias and no batch norm: none of the port's
    # kernels is on their path
    assert _all_kernel_counts() == before, (before, _all_kernel_counts())
    t1 = time.perf_counter()
    records, rec["mobilenet"] = mobilenet_serving_phase(gpu_name)
    secs["mobilenet"] = time.perf_counter() - t1
    total = time.perf_counter() - t0
    for name in ZOO_TRAIN_BASELINES:
        r = rec[f"zoo_{name}"]
        print(f"zoo_{name}: {r['amp']['images_per_s']:.1f} images/s, "
              f"vs_baseline {r['amp']['vs_baseline']:.3f}")
    for name in ZOO_INFER_BASELINES:
        r = rec[f"infer_{name}"]
        print(f"infer_{name}: {r['amp']['images_per_s']:.1f} images/s, "
              f"vs_baseline {r['amp']['vs_baseline']:.3f} (f32 "
              f"{r['f32']['images_per_s']:.1f}, "
              f"{r['f32']['vs_baseline']:.3f})")
    print(f"zoo: phase 14 took {total:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    rec.update(seconds=total, part_seconds=secs)
    torch.cuda.empty_cache()
    return records, rec


# --- The trainer plane (phase 15) -------------------------------------------
# SGD.train of bench.py's transformer row (bench.py:154-160, TRAIN's
# width: the per-layer LM the JAX benchmark trains) in f32 for a pass of
# TRAINER_STEPS batches, synchronously and with TRAINER_DEPTH steps in
# flight; checkpoints every TRAINER_CKPT_EVERY steps keeping
# TRAINER_CKPT_KEEP, and a crash before step TRAINER_CRASH_STEP resumed
TRAINER_STEPS = 6
TRAINER_DEPTH = 3
TRAINER_CKPT_EVERY = 2
TRAINER_CKPT_KEEP = 2
TRAINER_CRASH_STEP = 3
TRAINER_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# bench.py's rows as it writes them: bench_train_pipeline (:463),
# bench_checkpoint (:635) and bench_transpiler (:332)
TRAIN_PIPELINE = dict(batch=256, dim=1024, depth=4, steps=30, warmup=5,
                      rounds=3)
CKPT_BENCH = dict(batch=64, dim=512, steps=24, every=4, rounds=3)
TRANSPILER = dict(batch=16, hw=224, steps=30)


def _scope_state(scope):
    """Every scope value, tensors cloned (the RNG key is a pair of
    tensors that no op writes into)."""
    import torch

    return {n: (scope.get(n).clone() if isinstance(scope.get(n), torch.Tensor)
                else scope.get(n)) for n in list(scope.keys())}


def _put_state(scope, state):
    import torch

    for n, v in state.items():
        scope.set(n, v.clone() if isinstance(v, torch.Tensor) else v)


def _state_gap(got, want):
    """(max |got - want| over every tensor, the names that differ)."""
    import torch

    worst, names = 0.0, []
    for n, w in want.items():
        g = got[n]
        if not isinstance(w, torch.Tensor):
            if tuple(int(t) for t in g) != tuple(int(t) for t in w):
                names.append(n)
            continue
        if not torch.equal(g, w):
            names.append(n)
            worst = max(worst, float((g.double() - w.double()).abs().max()))
    return worst, names


def _trainer_batches(c, n):
    """``n`` minibatches of rows (ids[seq], tgt[seq]) from a seed."""
    import numpy as np

    rng = np.random.RandomState(SEED + 15)
    out = []
    for _ in range(n):
        ids = rng.randint(0, c["vocab"], size=(c["batch"], c["seq"]))
        tgt = rng.randint(0, c["vocab"], size=(c["batch"], c["seq"]))
        out.append([(ids[i].astype("int64"), tgt[i].astype("int64"))
                    for i in range(c["batch"])])
    return out


def _train_pass(trainer, state, batches, **kw):
    """One ``SGD.train`` pass over ``batches`` from ``state``: (losses,
    batch ids, wall seconds, final state)."""
    import torch

    from paddle_tpu_torch import event

    ends = []
    _put_state(trainer.scope, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(lambda: iter(batches), event_handler=lambda e: ends.append(
        (e.batch_id, e.cost)) if isinstance(e, event.EndIteration) else None,
                  **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([c for _, c in ends], [b for b, _ in ends], wall,
            _scope_state(trainer.scope))


def _ckpt_totals():
    """(ckpt/stall ms, ckpt/saves) so far in the port's global StatSet."""
    from paddle_tpu_torch import profiler

    d = profiler.global_stat.as_dict(prefix="ckpt/")
    return (d.get("ckpt/stall", {}).get("total_ms", 0.0),
            d.get("ckpt/saves", {}).get("total_ms", 0))


def _embedding_grad_times(ids, c):
    """The embedding gradient at the LM's shape, from the ids of one of
    its batches: as ``lookup_table``'s gradient computes it (an
    accumulating ``index_put_``, ops/tensor_ops.py) and as ``index_add_``
    would. ms a call on CUDA events, in alternating rounds, and whether
    five repeats give the first call's bits."""
    import torch

    torch.manual_seed(SEED)
    rows = ids.reshape(-1)
    og = torch.randn(rows.numel(), c["d_model"], device=rows.device)
    table = torch.empty(c["vocab"], c["d_model"], device=rows.device)
    ops = {"index_put_": lambda: torch.zeros_like(table).index_put_(
        (rows,), og, accumulate=True),
        "index_add_": lambda: torch.zeros_like(table).index_add_(0, rows, og)}
    out = {}
    for name, fn in ops.items():
        first = fn()
        out[name] = {"ms": [], "repeat_bitwise": all(
            torch.equal(fn(), first) for _ in range(5))}
    for _ in range(3):
        for name, fn in ops.items():
            out[name]["ms"].append(_cuda_ms(fn, iters=20))
    for v in out.values():
        v["ms"] = sorted(v["ms"])[1]
    return out


def trainer_lm_part(gpu_name, c=None):
    """Phase 15 (a) and (b): the per-layer LM at TRAIN's width through
    ``SGD.train``. Returns its record."""
    import shutil

    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import checkpoint as ckpt_mod
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.resilience import (CheckpointConfig, FaultPlan,
                                             SimulatedCrash)
    from paddle_tpu_torch.trainer import SGD

    c = c or PER_LAYER
    L, n = c["n_layers"], TRAINER_STEPS
    t0 = time.perf_counter()
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        ids, tgt, loss = _lm_loss(pt, c, pipeline_stack=False)
        trainer = SGD(cost=loss, optimizer=pt.optimizer.AdamOptimizer(
            learning_rate=c["lr"]), feed_list=[ids, tgt],
            place=pt.CUDAPlace(0), scope=pt.Scope())
    trainer._init_params()
    start = _scope_state(trainer.scope)
    params = main.all_parameters()
    n_params = sum(trainer.scope.get(p.name).numel() for p in params)
    state_bytes = sum(v.numel() * v.element_size() for v in start.values()
                      if isinstance(v, torch.Tensor))
    batches = _trainer_batches(c, n)
    tag = f"d{c['d_model']} L{L} H{c['num_heads']}"
    print(f"trainer: per-layer LM {tag} f32, {len(params)} parameters "
          f"({n_params} = {n_params / 1e6:.1f} M), scope state "
          f"{state_bytes / 1e9:.3f} GB with Adam's moments, built and "
          f"initialised in {time.perf_counter() - t0:.2f} s")
    out = {"config": c, "params": n_params, "state_bytes": state_bytes,
           "steps": n}

    # (a) sync and pipelined passes from the same start, each warmed by a
    # one-batch pass; the flash counters cover each measured pass alone
    runs = {}
    for depth in (1, TRAINER_DEPTH):
        _train_pass(trainer, start, batches[:1], async_depth=depth)
        _reset_flash_counts(fa)
        losses, order, wall, final = _train_pass(trainer, start, batches,
                                                 async_depth=depth)
        counts = _flash_counts(fa)
        assert counts == (L * n,) * 3 + (0,) * 3, (depth, counts)
        assert order == list(range(n)), order
        assert all(np.isfinite(losses)), losses
        runs[depth] = (losses, wall, final, trainer.goodput.snapshot())
    (l_sync, w_sync, f_sync, m_sync), (l_async, w_async, f_async, meter) = (
        runs[1], runs[TRAINER_DEPTH])
    assert l_sync == l_async, ("sync and pipelined losses differ",
                               l_sync, l_async)
    # the executor's own loop from the same state: a device-resident
    # feed, every step dispatched, one blocking read at the end
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in trainer.feeder.feed(batches[0]).items()}

    def step():
        return trainer.exe.run(main, feed=feed, fetch_list=[loss],
                               scope=trainer.scope, return_numpy=False)

    _put_state(trainer.scope, start)
    step()[0].item()
    t1 = time.perf_counter()
    for _ in range(n):
        last, = step()
    last.item()
    exe_ms = (time.perf_counter() - t1) / n * 1e3
    dev_ms = _device_ms(step, iters=3)
    quiet = lambda e: None  # noqa: E731
    traced = _count_kernels(
        lambda: trainer.train(lambda: iter(batches[:1]), event_handler=quiet,
                              goodput=False),
        TRAINER_FLASH, expect=dict.fromkeys(TRAINER_FLASH, L))
    assert traced is not None, "the trainer step's trace held no kernels"
    assert all(traced[k] == L for k in TRAINER_FLASH), traced
    sync_ms, async_ms = w_sync / n * 1e3, w_async / n * 1e3
    gap = (lambda ms: None if dev_ms is None else ms - dev_ms)
    print(f"trainer (a): losses sync {l_sync}; async_depth={TRAINER_DEPTH} "
          f"{l_async} (bitwise equal)")
    print(f"trainer (a): ms a step sync {sync_ms:.1f}, async_depth="
          f"{TRAINER_DEPTH} {async_ms:.1f}, the executor's loop {exe_ms:.1f};"
          f" device {_ms_text(dev_ms, '.1f')} ms a step; host gap sync "
          f"{_ms_text(gap(sync_ms), '.1f')}, async "
          f"{_ms_text(gap(async_ms), '.1f')}, the executor's loop "
          f"{_ms_text(gap(exe_ms), '.1f')} ms; flash launches a step "
          f"fwd/dq/dkv {[k // n for k in counts[:3]]} by the counters, "
          f"{[traced[k] for k in TRAINER_FLASH]} in a traced trainer step, "
          f"bf16 {list(counts[3:])}")
    print(f"trainer (a): goodput of the sync pass {m_sync['goodput']}, "
          f"of the async pass {meter['goodput']}; async buckets (s) "
          f"{meter['buckets']}")
    emb = _embedding_grad_times(feed["ids"], c)
    print(f"trainer (a): embedding gradient [{c['vocab']}, {c['d_model']}] "
          f"from {feed['ids'].numel()} ids: " + "; ".join(
              f"{k} {v['ms']:.3f} ms, five repeats bitwise "
              f"{'equal' if v['repeat_bitwise'] else 'unequal'}"
              for k, v in emb.items()))
    out["a"] = {"losses_sync": l_sync, "losses_async": l_async,
                "async_depth": TRAINER_DEPTH, "sync_ms_per_step": sync_ms,
                "async_ms_per_step": async_ms, "executor_ms_per_step": exe_ms,
                "device_ms_per_step": dev_ms,
                "host_gap_sync_ms": gap(sync_ms),
                "host_gap_async_ms": gap(async_ms),
                "host_gap_executor_ms": gap(exe_ms),
                "flash_launches_per_step": [k // n for k in counts[:3]],
                "flash_launches_traced_step": [traced[k]
                                               for k in TRAINER_FLASH],
                "goodput_sync": m_sync, "goodput_async": meter,
                "embedding_grad": emb}
    del feed, last

    # (b) checkpoints every TRAINER_CKPT_EVERY steps, sync then background
    root = ROOT / "build" / "trainer_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    free = shutil.disk_usage(ROOT).free
    print(f"trainer (b): {free / 1e9:.1f} GB free where the checkpoints go")
    saves = {}
    for background in (False, True):
        d = root / ("background" if background else "sync")
        cfg = CheckpointConfig(str(d), every_n_steps=TRAINER_CKPT_EVERY,
                               keep=TRAINER_CKPT_KEEP, background=background,
                               resume=False, install_signal_handlers=False)
        stall0, n0 = _ckpt_totals()
        losses, _, wall, _ = _train_pass(trainer, start, batches,
                                         checkpoint=cfg)
        stall1, n1 = _ckpt_totals()
        n0, n1 = int(n0), int(n1)
        kept = sorted(p.name for p in d.glob("ckpt-*.npz"))
        nbytes = (d / f"ckpt-{n}.npz").stat().st_size
        assert losses == l_sync, ("a checkpointed pass trained differently",
                                  losses, l_sync)
        assert n1 - n0 == n // TRAINER_CKPT_EVERY, (n0, n1)
        assert len(kept) == TRAINER_CKPT_KEEP, kept
        saves["background" if background else "sync"] = {
            "stall_ms_per_save": (stall1 - stall0) / (n1 - n0),
            "saves": n1 - n0, "ckpt_bytes": nbytes,
            "ms_per_step": wall / n * 1e3, "kept": kept}
        shutil.rmtree(d)
    print("trainer (b): " + "; ".join(
        f"{k} saves: {v['saves']} of {v['ckpt_bytes']} bytes each, stall "
        f"{v['stall_ms_per_save']:.1f} ms a save, {v['ms_per_step']:.1f} ms "
        f"a step over the pass" for k, v in saves.items()))
    # a crash before step TRAINER_CRASH_STEP, then resume in a new pass
    d = root / "crash"
    cfg = CheckpointConfig(str(d), every_n_steps=TRAINER_CKPT_EVERY,
                           keep=TRAINER_CKPT_KEEP, background=True,
                           install_signal_handlers=False)
    _put_state(trainer.scope, start)
    plan = FaultPlan().at(step=TRAINER_CRASH_STEP, kind="crash")
    with plan.active():
        try:
            trainer.train(lambda: iter(batches), event_handler=quiet,
                          checkpoint=cfg)
        except SimulatedCrash:
            pass  # the planned crash; anything else propagates
    assert plan.pending() == [], plan
    saved = ckpt_mod.latest_step(str(d))
    resumed, order, _, f_resumed = _train_pass(trainer, start, batches,
                                               checkpoint=cfg)
    shutil.rmtree(root)
    assert order == list(range(saved, n)), (saved, order)
    runs_gap, runs_differ = _state_gap(f_async, f_sync)
    gap_r, differ = _state_gap(f_resumed, f_sync)
    if not runs_differ:
        assert not differ and resumed == l_sync[saved:], (
            "resume is not bit-exact", differ, gap_r)
        verdict = "bitwise equal, as the two uninterrupted runs are"
    else:
        assert gap_r <= runs_gap, (gap_r, runs_gap, differ)
        verdict = (f"within {runs_gap:.3e} (the two uninterrupted runs' "
                   f"largest difference, in {runs_differ[:4]})")
    print(f"trainer (b): crash before step {TRAINER_CRASH_STEP}, resumed "
          f"from step {saved}: batches {order}, losses {resumed}; every "
          f"final value against the uninterrupted run: {verdict}")
    out["b"] = {"saves": saves, "crash_step": TRAINER_CRASH_STEP,
                "resumed_from": saved, "resumed_losses": resumed,
                "uninterrupted_runs_differ": runs_differ,
                "uninterrupted_runs_gap": runs_gap,
                "resumed_differ": differ, "resumed_gap": gap_r}
    del trainer, start, f_sync, f_async, f_resumed, runs
    torch.cuda.empty_cache()
    return out


def _mlp_trainer(pt, dim, batch):
    """bench.py's trainer-row model: a 3-layer MLP (dim, dim, 10) under
    SGD 0.1, and a batch of rows from RandomState(0)."""
    import numpy as np

    from paddle_tpu_torch import layers
    from paddle_tpu_torch.trainer import SGD

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data("x", shape=[dim])
        y = layers.data("y", shape=[1], dtype="int64")
        h = layers.fc(x, size=dim, act="relu")
        h = layers.fc(h, size=dim, act="relu")
        logits = layers.fc(h, size=10)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        trainer = SGD(cost=loss,
                      optimizer=pt.optimizer.SGDOptimizer(learning_rate=0.1),
                      feed_list=[x, y], place=pt.CUDAPlace(0),
                      scope=pt.Scope())
    rng = np.random.RandomState(0)
    xs = rng.rand(batch, dim).astype("float32")
    ys = rng.randint(0, 10, size=(batch, 1)).astype("int64")
    return trainer, main, loss, xs, ys, [(xs[i], ys[i]) for i in range(batch)]


def bench_train_pipeline_row(pt, batch, dim, depth, steps, warmup, rounds):
    """bench.py's bench_train_pipeline on the card: the same keys."""
    import torch

    trainer, main, loss, xs, ys, rows = _mlp_trainer(pt, dim, batch)

    def reader():
        for _ in range(steps):
            yield rows

    trainer._init_params()
    quiet = lambda e: None  # noqa: E731

    def measure(async_depth):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(reader, num_passes=1, event_handler=quiet,
                      async_depth=async_depth)
        return (time.perf_counter() - t0) / steps

    # the device's step: a CUDA-resident feed, every step dispatched, one
    # blocking read closing the window
    feed_dev = {"x": torch.from_numpy(xs).cuda(),
                "y": torch.from_numpy(ys).cuda()}
    for _ in range(warmup):
        trainer.exe.run(main, feed=feed_dev, fetch_list=[loss],
                        scope=trainer.scope)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        out, = trainer.exe.run(main, feed=feed_dev, fetch_list=[loss],
                               scope=trainer.scope, return_numpy=False)
    out.item()
    device_s = (time.perf_counter() - t0) / steps
    measure(1)
    measure(depth)
    sync_s, async_s = [], []
    for _ in range(rounds):
        sync_s.append(measure(1))
        async_s.append(measure(depth))
    sync = sorted(sync_s)[rounds // 2]
    asynd = sorted(async_s)[rounds // 2]
    return {
        "sync_ms_per_step": round(sync * 1e3, 3),
        "async_ms_per_step": round(asynd * 1e3, 3),
        "device_ms_per_step": round(device_s * 1e3, 3),
        "host_gap_sync_ms": round((sync - device_s) * 1e3, 3),
        "host_gap_async_ms": round((asynd - device_s) * 1e3, 3),
        "async_depth": depth,
        "speedup_pct": round((sync - asynd) / sync * 100.0, 2),
    }


def bench_checkpoint_row(pt, batch, dim, steps, every, rounds):
    """bench.py's bench_checkpoint on the card: the same keys."""
    import os
    import shutil

    import torch

    from paddle_tpu_torch.resilience import CheckpointConfig

    trainer, _, _, _, _, rows = _mlp_trainer(pt, dim, batch)

    def reader():
        for _ in range(steps):
            yield rows

    trainer._init_params()
    quiet = lambda e: None  # noqa: E731
    workdir = ROOT / "build" / "bench_ckpt"
    shutil.rmtree(workdir, ignore_errors=True)

    def measure(background):
        ckpt = None
        if background is not None:
            ckpt = CheckpointConfig(
                str(workdir / f"bg{int(background)}"), every_n_steps=every,
                keep=2, background=background, resume=False,
                save_final=False, install_signal_handlers=False)
        stall0 = _ckpt_totals()[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(reader, num_passes=1, event_handler=quiet,
                      checkpoint=ckpt)
        wall = (time.perf_counter() - t0) / steps
        return wall, (_ckpt_totals()[0] - stall0) / 1e3 / steps

    try:
        for m in (None, False, True):
            measure(m)
        base_s, sync_s, bg_s = [], [], []
        for _ in range(rounds):
            base_s.append(measure(None))
            sync_s.append(measure(False))
            bg_s.append(measure(True))
        med = lambda xs, i: sorted(x[i] for x in xs)[rounds // 2]  # noqa: E731
        base = med(base_s, 0)
        sync, sync_stall = med(sync_s, 0), med(sync_s, 1)
        bg, bg_stall = med(bg_s, 0), med(bg_s, 1)
        ckpt_bytes = 0
        for dirpath, _, files in os.walk(workdir):
            ckpt_bytes = max([ckpt_bytes] + [
                os.path.getsize(os.path.join(dirpath, f))
                for f in files if f.endswith(".npz")])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {
        "base_ms_per_step": round(base * 1e3, 3),
        "sync_ms_per_step": round(sync * 1e3, 3),
        "background_ms_per_step": round(bg * 1e3, 3),
        "sync_overhead_pct": round((sync - base) / base * 100.0, 2),
        "background_overhead_pct": round((bg - base) / base * 100.0, 2),
        "sync_stall_ms_per_step": round(sync_stall * 1e3, 3),
        "background_stall_ms_per_step": round(bg_stall * 1e3, 3),
        "sync_stall_pct": round(sync_stall / base * 100.0, 2),
        "background_stall_pct": round(bg_stall / base * 100.0, 2),
        "every_n_steps": every,
        "ckpt_bytes": int(ckpt_bytes),
    }


def bench_transpiler_row(pt, batch, hw, steps):
    """bench.py's bench_transpiler on the card (ResNet-50, epilogue on):
    the same keys, plus the conv1x1_epilogue launches a transpiled batch.
    The port compiles nothing: ``*_compile_s`` is the first run's wall."""
    import numpy as np
    import torch

    from paddle_tpu_torch import layers, models
    from paddle_tpu_torch.kernels import conv_epilogue as ke

    main_prog, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main_prog, startup):
        images = layers.data("images", shape=[hw, hw, 3])
        logits = models.resnet_imagenet(images, num_classes=1000, depth=50,
                                        is_test=True)
    scope = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=scope)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(batch, hw, hw, 3).astype("float32")).cuda()
    raw = pt.io.prune_program(main_prog, ["images"], [logits.name])
    opt_scope = pt.Scope(parent=scope)
    pm = pt.transpiler.inference_pipeline(epilogue=True)
    t0 = time.perf_counter()
    opt = pm.run(main_prog.clone(), ["images"], [logits.name],
                 scope=opt_scope)
    transpile_ms = (time.perf_counter() - t0) * 1e3

    def measure(prog, run_scope):
        exe = pt.Executor(pt.CUDAPlace(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(prog, feed={"images": img}, fetch_list=[logits.name],
                scope=run_scope)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(steps):
            o, = exe.run(prog, feed={"images": img},
                         fetch_list=[logits.name], scope=run_scope,
                         return_numpy=False)
        o.cpu()
        return first_s, (time.perf_counter() - t0) / steps, o

    raw_first, raw_step, raw_out = measure(raw, scope)
    _reset_conv_counts(ke)
    opt_first, opt_step, opt_out = measure(opt, opt_scope)
    launches = _conv_counts(ke)[1]
    fused = sum(op.type == "conv1x1_bn_act" for op in opt.global_block.ops)
    assert fused == FUSED_OPS and launches == fused * (steps + 1), (
        fused, launches)
    err = float((opt_out - raw_out).abs().max() / raw_out.abs().max())
    assert err <= TRANSPILE_RTOL, err
    return {
        "raw_ops": len(raw.global_block.ops),
        "transpiled_ops": len(opt.global_block.ops),
        "transpile_ms": round(transpile_ms, 1),
        "raw_compile_s": round(raw_first, 3),
        "transpiled_compile_s": round(opt_first, 3),
        "raw_ms_per_batch": round(raw_step * 1e3, 3),
        "transpiled_ms_per_batch": round(opt_step * 1e3, 3),
        "pass_stats": pm.stats(),
        "conv1x1_epilogue_launches_per_batch": launches // (steps + 1),
        "transpiled_vs_raw_rel_err": err,
    }


def trainer_phase(gpu_name):
    """Phase 15: the trainer plane. (a)-(b) the per-layer LM through
    ``SGD.train``, (c) bench.py's train_pipeline, checkpoint and
    transpiler_resnet50 rows. Returns its record."""
    import paddle_tpu_torch as pt

    seconds = [time.perf_counter()]
    out = {"lm": trainer_lm_part(gpu_name)}
    seconds.append(time.perf_counter())
    rows = {"train_pipeline": bench_train_pipeline_row(pt, **TRAIN_PIPELINE),
            "checkpoint": bench_checkpoint_row(pt, **CKPT_BENCH)}
    seconds.append(time.perf_counter())
    rows["transpiler_resnet50"] = bench_transpiler_row(pt, **TRANSPILER)
    seconds.append(time.perf_counter())
    for name, row in rows.items():
        print(f"trainer (c) {name}: " + json.dumps(
            {k: v for k, v in row.items() if k != "pass_stats"}))
    out["rows"] = rows
    out["seconds"] = [b - a for a, b in zip(seconds, seconds[1:])]
    print("phase 15 seconds: " + ", ".join(
        f"{part} {s:.1f}" for part, s in zip(
            ("lm (a, b)", "trainer rows", "transpiler row"), out["seconds"])))
    return out


# Phase 16: the training memory and optimizer plane. (a) and (c) train
# PER_LAYER's LM, (b) TRAIN's stacked LM; (d) bench.py's train_pipeline
# MLP (:463) under the eight other update ops; (e) ResNet-50 built plain
# through SGD(transpile=True); bench.py's goodput_overhead (:542, :2833)
# at its TPU row's sizes.
MEMORY_TIMED = 3  # timed steps a mode, after its measured first step
ACCUMULATE = 4
# (c): one apply over 4 micro-batches against one step on their rows
# together. Adam's first update is lr * m / (sqrt(v) + eps), smooth in
# the mean gradient for |g| well above eps (and below it too, as g /
# (|g| + eps)): the two sums differ in their order only (~1e-6 of each
# gradient's norm), so the moments are held at GRAD_RTOL of their norm
# and each parameter's update at 1e-3 of its own norm.
ACCUMULATE_UPDATE_RTOL = 1e-3
OPTIMIZER_OPS = ("adamax", "adagrad", "decayed_adagrad", "adadelta",
                 "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad")
OPTIMIZER_MLP = dict(batch=256, dim=1024, steps=3)
# (d): the card against the port's own CPU run of the same 3 steps, the
# losses at 1e-4. The card's and the CPU's f32 products over 1024 terms
# sum in other orders (~1e-6 of a value). A ReLU whose input lies that
# close to zero turns on in one run and off in the other, and the update
# ops that act like a sign at first (adagrad's lr * g / |g|, adadelta's
# sqrt(eps / (1 - rho)) step) move its row by a whole step in one run
# only: the CPU alone, its inputs scaled by (1 + 1e-6), moves adadelta's
# first layer by 5.7e-3 of its 3-step move and adagrad's by 1.1e-3 (the
# port's CPU run of this part), as far as the card lies from the CPU
# (PERF.md §6). So each
# parameter's gap is held within the largest of OPTIMIZER_RTOL of its
# move, SENS_FACTOR times its own move under that nudge, and SENS_TOTAL
# times the largest such move of any parameter (the zoo's Gate 1 rule).
OPTIMIZER_RTOL = 1e-3
OPTIMIZER_LOSS_RTOL = 1e-4
OPTIMIZER_NUDGE = 1e-6
TRANSPILE_TRAIN = dict(RESNET, batch=32, steps=2)
GOODPUT = dict(batch=256, dim=1024, depth=3, steps=30, rounds=3)


def _lm_program(pt, c, start, remat=False, pipeline_stack=False,
                accumulate=1):
    """The LM at ``c`` with Adam, built with the name counter at
    ``start`` (so every build shares its names):
    (main, startup, loss, params_grads)."""
    pt.Program._uid_counter = start
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        _, _, loss = _lm_loss(pt, c, pipeline_stack, remat=remat)
        params_grads = pt.optimizer.AdamOptimizer(
            learning_rate=c["lr"]).minimize(loss, startup_program=startup,
                                            accumulate_steps=accumulate)
    return main, startup, loss, params_grads


def _lm_feed(c, rows=None):
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 16)
    b = rows or c["batch"]
    return {k: torch.from_numpy(rng.randint(0, c["vocab"], size=(b, c["seq"]))
                                .astype("int64")).cuda()
            for k in ("ids", "tgt")}


def _memory_mode(exe, main, loss, scope, state, feed, fa, expect):
    """One remat mode from ``state``: its first step's loss, peak memory
    and flash launches (counters), then MEMORY_TIMED steps' ms, the
    device ms a step and the flash launches in a traced step. The scope
    goes back to ``state``."""
    import numpy as np
    import torch

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)

    _restore(scope, state)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts(fa)
    first = float(step()[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = _flash_counts(fa)
    step_ms = []
    for _ in range(MEMORY_TIMED):
        t0 = time.perf_counter()
        step()[0].item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    dev_ms = _device_ms(step, iters=2)
    traced = _count_kernels(step, TRAINER_FLASH,
                            expect=dict(zip(TRAINER_FLASH, expect)))
    _restore(scope, state)
    assert np.isfinite(first), first
    assert counts == tuple(expect) + (0, 0, 0), (counts, expect)
    assert traced is not None and [traced[k] for k in TRAINER_FLASH] == \
        list(expect), (traced, expect)
    return {"loss": first, "peak_bytes": peak,
            "ms_per_step": float(np.median(step_ms)), "step_ms": step_ms,
            "device_ms_per_step": dev_ms, "flash_launches": list(counts[:3]),
            "flash_launches_traced": [traced[k] for k in TRAINER_FLASH]}


def _grad_compare(exe, builds, scope, state, feed):
    """Step one's loss and every gradient of each build in ``builds``
    ({mode: (main, loss, params_grads)}) from ``state``, held against
    the first mode's: {mode: (loss, worst gap, its name, bitwise)}."""
    import torch

    out, ref = {}, None
    for mode, (main, loss, pgs) in builds.items():
        names = [loss.name] + [g.name for _, g in pgs]
        got = _step_fetches(exe, main, feed, names, scope, state)
        if ref is None:
            ref = got
        worst = _grad_gap(names[1:], got[1:], ref[1:])
        out[mode] = (float(got[0]), worst[0], worst[1],
                     all(torch.equal(g, r) for g, r in zip(got, ref)))
        del got
    return out


def _remat_part(pt, fa, c, tag, modes, pipeline_stack, expect):
    """(a) or (b): the LM at ``c`` under each remat mode, from one state.
    Returns its record and (state, built programs, scope, exe, feed)."""
    import torch

    start = pt.Program._uid_counter
    builds = {}
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace())
    for mode in modes:
        main, startup, loss, pgs = _lm_program(pt, c, start, remat=mode,
                                               pipeline_stack=pipeline_stack)
        builds[mode] = (main, loss, pgs)
        # the same draws under the same names; only the learning rate's
        # name follows the backward's count of names
        exe.run(startup, scope=scope)
    state = _snapshot(scope)
    feed = _lm_feed(c)
    runs = {mode: _memory_mode(exe, main, loss, scope, state, feed, fa,
                               expect[mode])
            for mode, (main, loss, _) in builds.items()}
    grads = _grad_compare(exe, builds, scope, state, feed)
    base = runs[modes[0]]
    for mode, r in runs.items():
        loss, gap, worst, bitwise = grads[mode]
        r.update({"step1_loss": loss, "grad_gap": gap, "grad_gap_name": worst,
                  "bitwise": bitwise})
        assert abs(loss - grads[modes[0]][0]) <= LOSS_RTOL * abs(loss), (
            mode, loss, grads[modes[0]][0])
        assert gap <= GRAD_RTOL, (mode, gap, worst)
        print(f"train memory {tag} remat={mode!r}: step-1 loss {loss:.6f}; "
              f"gradients against remat={modes[0]!r} "
              f"{'bitwise equal' if bitwise else f'within {gap:.3e} of a norm ({worst})'}"
              f"; {r['ms_per_step']:.1f} ms a step, device "
              f"{_ms_text(r['device_ms_per_step'], '.1f')} ms; peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB"
              f" ({r['peak_bytes'] / base['peak_bytes'] * 100:.1f}% of "
              f"remat={modes[0]!r}'s); flash launches a step fwd/dq/dkv "
              f"{r['flash_launches']} by the counters, "
              f"{r['flash_launches_traced']} traced")
    del builds
    torch.cuda.empty_cache()
    return runs, (state, scope, exe, feed, start)


def _accumulation_part(pt, c, setup):
    """(c): accumulate_steps=4 over 4 micro-batches of the remat LM's
    batch, against (a)'s remat program's one step on the whole batch."""
    import torch

    state, scope, exe, feed, start = setup
    k, rows = ACCUMULATE, c["batch"] // ACCUMULATE
    main, startup, loss, pgs = _lm_program(pt, c, start, remat=True,
                                           accumulate=k)
    big_main, _, big_loss, _ = _lm_program(pt, c, start, remat=True)
    acc_scope = pt.Scope()
    exe.run(startup, scope=acc_scope)
    _restore(acc_scope, state)
    watched = [n for n in state
               if any(n == p.name or n.startswith(p.name + "_")
                      for p, _ in pgs) and not n.endswith("_gradsum_acc")]
    off_equal = []
    for i in range(k):
        micro = {n: v[i * rows:(i + 1) * rows] for n, v in feed.items()}
        exe.run(main, feed=micro, fetch_list=[loss], scope=acc_scope,
                return_numpy=False)
        if i < k - 1:
            off_equal.append(all(torch.equal(acc_scope.get(n), state[n])
                                 for n in watched))
    assert all(off_equal), off_equal
    _restore(scope, state)
    exe.run(big_main, feed=feed, fetch_list=[big_loss], scope=scope,
            return_numpy=False)
    worst = {"update": (0.0, ""), "moment": (0.0, "")}
    for n in watched:
        got, want, was = acc_scope.get(n), scope.get(n), state[n]
        kind = "moment" if "_moment" in n else "update"
        if kind == "update":
            got, want = got - was, want - was
        if not want.is_floating_point() or want.numel() <= 1:
            assert torch.equal(got, want), n
            continue
        gap = float((got - want).double().norm()
                    / want.double().norm().clamp_min(1e-30))
        worst[kind] = max(worst[kind], (gap, n))
    _restore(scope, state)
    assert worst["moment"][0] <= GRAD_RTOL, worst
    assert worst["update"][0] <= ACCUMULATE_UPDATE_RTOL, worst
    print(f"train memory (c) accumulate_steps={k} on {k} x {rows} x "
          f"{c['seq']}: {len(watched)} parameters and Adam states bitwise "
          f"unchanged after each of the {k - 1} off-step runs; after the "
          f"applying run against one step on {c['batch']} x {c['seq']}: "
          f"moments within {worst['moment'][0]:.3e} of a norm "
          f"({worst['moment'][1]}), updates within {worst['update'][0]:.3e}"
          f" ({worst['update'][1]})")
    del acc_scope
    torch.cuda.empty_cache()
    return {"k": k, "micro_rows": rows, "watched": len(watched),
            "off_step_bitwise": off_equal,
            "moment_gap": worst["moment"][0], "moment_gap_name":
            worst["moment"][1], "update_gap": worst["update"][0],
            "update_gap_name": worst["update"][1]}


def _update_optimizer(pt, op_type, lr):
    """An optimizer for ``op_type``: the port's class where the JAX
    package has one, else a subclass appending the op (the proximal
    ones); the Ftrl and proximal L2 keep a dead unit's zero gradient
    finite."""
    O = pt.optimizer
    classes = {"adamax": lambda: O.AdamaxOptimizer(lr),
               "adagrad": lambda: O.AdagradOptimizer(lr),
               "decayed_adagrad": lambda: O.DecayedAdagradOptimizer(lr),
               "adadelta": lambda: O.AdadeltaOptimizer(1.0),
               "rmsprop": lambda: O.RMSPropOptimizer(lr, momentum=0.5),
               "ftrl": lambda: O.FtrlOptimizer(lr, l1=1e-4, l2=1e-4)}
    if op_type in classes:
        return classes[op_type]()

    class Proximal(O.Optimizer):
        def _create_accumulators(self, startup, params):
            if op_type == "proximal_adagrad":
                for p in params:
                    self._add_accumulator("moment", p, startup, 0.1)

        def _append_optimize_op(self, block, pg, lr_var):
            p, g = pg
            ins = {"Param": [p.name], "Grad": [g.name],
                   "LearningRate": [lr_var.name]}
            outs = {"ParamOut": [p.name]}
            if op_type == "proximal_adagrad":
                m = self._get_accumulator("moment", p).name
                ins["Moment"], outs["MomentOut"] = [m], [m]
            block.append_op(op_type, inputs=ins, outputs=outs,
                            attrs={"l1": 1e-4, "l2": 1e-4})

    return Proximal(lr)


def _optimizers_part(pt):
    """(d): the train_pipeline MLP 3 steps under each update op on the
    card and in the port's CPU run, from the same start."""
    import numpy as np
    import torch

    from paddle_tpu_torch import layers

    c = OPTIMIZER_MLP
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(c["batch"], c["dim"]).astype("float32"),
            "y": rng.randint(0, 10, size=(c["batch"], 1)).astype("int64")}
    out = {}
    for op_type in OPTIMIZER_OPS:
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = SEED
        with pt.program_guard(main, startup):
            x = layers.data("x", shape=[c["dim"]])
            y = layers.data("y", shape=[1], dtype="int64")
            h = layers.fc(x, size=c["dim"], act="relu")
            h = layers.fc(h, size=c["dim"], act="relu")
            loss = layers.mean(layers.softmax_with_cross_entropy(
                layers.fc(h, size=10), y))
            pgs = _update_optimizer(pt, op_type, 0.01).minimize(
                loss, startup_program=startup)
        assert sum(op.type == op_type for op in main.global_block.ops) == \
            len(pgs)
        cpu_exe, cpu = pt.Executor(pt.CPUPlace()), pt.Scope()
        cpu_exe.run(startup, scope=cpu)
        start = {n: cpu.get(n).clone() for n in cpu.keys()
                 if isinstance(cpu.get(n), torch.Tensor)}
        card_exe, card = pt.Executor(pt.CUDAPlace()), pt.Scope()
        for n, v in start.items():
            card.set(n, v.cuda())
        nudged_scope = pt.Scope()
        for n, v in start.items():
            nudged_scope.set(n, v.clone())
        nudged = dict(feed, x=feed["x"] * np.float32(1 + OPTIMIZER_NUDGE))
        losses = {}
        for tag, exe, scope, f in (("card", card_exe, card, feed),
                                   ("cpu", cpu_exe, cpu, feed),
                                   ("nudged", cpu_exe, nudged_scope, nudged)):
            losses[tag] = [float(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0])
                           for _ in range(c["steps"])]
        gaps, nudges = {}, {}
        for p, _ in pgs:
            got, want = card.get(p.name).cpu(), cpu.get(p.name)
            move = (want - start[p.name]).double().norm()
            assert move > 0 and got.isfinite().all(), (op_type, p.name)
            gaps[p.name] = float((got - want).double().norm() / move)
            nudges[p.name] = float((nudged_scope.get(p.name) - want)
                                   .double().norm() / move)
        floor = SENS_TOTAL * max(nudges.values())
        ratio = {n: g / max(OPTIMIZER_RTOL, SENS_FACTOR * nudges[n], floor)
                 for n, g in gaps.items()}
        worst = max(ratio, key=ratio.get)
        np.testing.assert_allclose(losses["card"], losses["cpu"],
                                   rtol=OPTIMIZER_LOSS_RTOL, err_msg=op_type)
        assert ratio[worst] <= 1.0, (op_type, worst, gaps[worst],
                                     nudges[worst], floor)
        top = max(gaps, key=gaps.get)
        out[op_type] = {"losses_card": losses["card"],
                        "losses_cpu": losses["cpu"],
                        "param_gap": gaps[top], "param_gap_name": top,
                        "nudge_move": nudges[top],
                        "nudge_move_max": max(nudges.values()),
                        "worst_allowance_ratio": ratio[worst]}
    print("train memory (d) the train_pipeline MLP (dim "
          f"{c['dim']}, batch {c['batch']}), {c['steps']} steps, card "
          "against the port's CPU run (the largest parameter gap over its "
          f"move; the CPU's own move under a {OPTIMIZER_NUDGE:g} input "
          "nudge): " + "; ".join(
              f"{k} {v['param_gap']:.2e} ({v['nudge_move']:.2e})"
              for k, v in out.items()))
    return out


def _transpile_part(pt, ke):
    """(e): ResNet-50 built plain, trained 2 steps through
    SGD(transpile=True) under --fused_conv_epilogue and untranspiled,
    from one state."""
    import numpy as np
    import torch

    from paddle_tpu_torch import layers, models
    from paddle_tpu_torch.trainer import SGD

    c = TRANSPILE_TRAIN
    rng = np.random.RandomState(SEED + 16)
    xs = rng.rand(c["steps"] * c["batch"], c["size"], c["size"], 3) \
        .astype("float32")
    ys = rng.randint(0, c["classes"], (len(xs), 1)).astype("int64")
    batches = [[(xs[i], ys[i]) for i in range(s * c["batch"],
                                              (s + 1) * c["batch"])]
               for s in range(c["steps"])]
    start, state, runs = pt.Program._uid_counter, None, {}
    for transpile in (True, False):
        pt.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = SEED
        with pt.program_guard(main, startup):
            images = layers.data("images", [c["size"], c["size"], 3])
            label = layers.data("label", [1], "int64")
            loss = layers.mean(layers.softmax_with_cross_entropy(
                models.resnet_imagenet(images, num_classes=c["classes"],
                                       depth=c["depth"]), label))
            before = len(main.global_block.ops)
            pt.flags.FLAGS.fused_conv_epilogue = transpile
            try:
                trainer = SGD(cost=loss, optimizer=pt.optimizer.
                              MomentumOptimizer(c["lr"], c["momentum"]),
                              feed_list=[images, label],
                              place=pt.CUDAPlace(0), scope=pt.Scope(),
                              transpile=transpile)
            finally:
                pt.flags.FLAGS.fused_conv_epilogue = False
        ops = main.global_block.ops
        # the forward after the pipeline: the ops before the loss
        # gradient's seed, less the backward's @PRE snapshots
        seed = next(i for i, op in enumerate(ops)
                    if op.output_names() == [loss.name + "@GRAD"])
        after = sum(not (op.type == "assign" and "@PRE" in op.output("Out"))
                    for op in ops[:seed])
        trainer._init_params()
        if state is None:
            state = _snapshot(trainer.scope)
        else:
            _restore(trainer.scope, state)
        costs, ends = [], []

        def handler(e):
            if type(e).__name__ == "EndIteration":  # its cost is read
                costs.append(e.cost)
                ends.append(time.perf_counter())

        _reset_conv_counts(ke)
        trainer.train(lambda: iter(batches), event_handler=handler)
        runs[transpile] = {
            "ops_before": before, "ops_after": after,
            "fused_ops": sum(op.type == "conv1x1_bn_act" for op in ops),
            "losses": costs, "step2_ms": (ends[1] - ends[0]) * 1e3,
            "launches": list(_conv_counts(ke))}
        del trainer
    t, u = runs[True], runs[False]
    assert t["fused_ops"] == FUSED_OPS and u["fused_ops"] == 0, runs
    assert t["launches"] == [FUSED_OPS * c["steps"], 0,
                             FUSED_OPS * c["steps"]], t["launches"]
    assert u["launches"] == [0, 0, 0], u["launches"]
    assert all(np.isfinite(t["losses"])), t["losses"]
    assert abs(t["losses"][0] - u["losses"][0]) <= TRANSPILE_RTOL * abs(
        u["losses"][0]), (t["losses"], u["losses"])
    print(f"train memory (e) ResNet-50 built plain, batch {c['batch']}, "
          f"{c['steps']} steps through SGD(transpile=True): forward ops "
          f"{t['ops_before']} -> {t['ops_after']} ({t['fused_ops']} "
          f"conv1x1_bn_act); conv1x1_stats / conv1x1_epilogue / "
          f"scale_shift_act launches a step "
          f"{[n // c['steps'] for n in t['launches']]}; losses "
          f"{t['losses']} against untranspiled {u['losses']}; step 2 "
          f"{t['step2_ms']:.1f} against {u['step2_ms']:.1f} ms (through "
          "SGD.train, the feeder's stack and copy included)")
    torch.cuda.empty_cache()
    return {"transpiled": t, "untranspiled": u}


def _goodput_row(pt, batch, dim, depth, steps, rounds):
    """bench.py's goodput_overhead on the card: the train_pipeline MLP
    through SGD.train(async_depth=3) with the goodput meter off and on
    in interleaved rounds (medians), and the meter's own cost a step in a
    tight loop; the same keys, each round's overhead beside them."""
    from collections import deque

    from paddle_tpu_torch.trace.goodput import GoodputMeter

    trainer, _, _, _, _, rows = _mlp_trainer(pt, dim, batch)

    def reader():
        for _ in range(steps):
            yield rows

    trainer._init_params()
    quiet = lambda e: None  # noqa: E731

    def measure(goodput):
        t0 = time.perf_counter()
        trainer.train(reader, num_passes=1, event_handler=quiet,
                      async_depth=depth, goodput=goodput)
        return (time.perf_counter() - t0) / steps

    measure(False)
    measure(None)
    off_s, on_s = [], []
    for _ in range(rounds):
        off_s.append(measure(False))
        on_s.append(measure(None))
    off = sorted(off_s)[rounds // 2]
    on = sorted(on_s)[rounds // 2]
    snap = trainer.goodput.snapshot() if trainer.goodput else {}
    probe = GoodputMeter()
    probe.set_program_flops(1e9)
    walls = deque(maxlen=32)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        t_d = time.perf_counter()
        probe.account("data_wait", time.perf_counter() - t_d)
        with probe.measure("recovery_rollback"):
            pass
        t_r = time.perf_counter()
        probe.account("fresh_compile", 0.0)
        probe.account("host_dispatch", time.perf_counter() - t_r)
        t_v = time.perf_counter()
        probe.account("device_compute", time.perf_counter() - t_v)
        probe.note_step(1e-3)
        walls.append(1e-3)
    meter_us = (time.perf_counter() - t0) / n * 1e6
    return {
        "off_ms_per_step": round(off * 1e3, 3),
        "on_ms_per_step": round(on * 1e3, 3),
        "overhead_pct": round((on - off) / off * 100.0, 2),
        "overhead_pct_rounds": [round((b - a) / a * 100.0, 2)
                                for a, b in zip(off_s, on_s)],
        "meter_us_per_step": round(meter_us, 2),
        "meter_overhead_pct": round(meter_us / (off * 1e6) * 100.0, 3),
        "async_depth": depth,
        "goodput_fraction": snap.get("goodput"),
        "buckets_attributed": sum(
            1 for v in (snap.get("buckets") or {}).values() if v > 0),
    }


def train_memory_phase(gpu_name):
    """Phase 16: the training memory and optimizer plane, (a)-(e) and
    the goodput row. Returns its record."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import conv_epilogue as ke
    from paddle_tpu_torch.kernels import flash_attention as fa

    seconds = [time.perf_counter()]
    L = PER_LAYER["n_layers"]
    plain, remat = (L, L, L), (2 * L, L, L)
    out = {}
    out["a"], setup = _remat_part(pt, fa, PER_LAYER, "(a) per-layer",
                                  (False, True), False,
                                  {False: plain, True: remat})
    assert out["a"][True]["peak_bytes"] < out["a"][False]["peak_bytes"], \
        out["a"]
    seconds.append(time.perf_counter())
    out["c"] = _accumulation_part(pt, PER_LAYER, setup)
    del setup
    seconds.append(time.perf_counter())
    out["b"], setup = _remat_part(pt, fa, TRAIN, "(b) stacked",
                                  (False, True, "dots"), True,
                                  {False: plain, True: remat,
                                   "dots": remat})
    del setup
    seconds.append(time.perf_counter())
    out["d"] = _optimizers_part(pt)
    seconds.append(time.perf_counter())
    out["e"] = _transpile_part(pt, ke)
    seconds.append(time.perf_counter())
    out["goodput_overhead"] = _goodput_row(pt, **GOODPUT)
    print("train memory goodput_overhead: " + json.dumps(
        out["goodput_overhead"]))
    seconds.append(time.perf_counter())
    out["seconds"] = [b - a for a, b in zip(seconds, seconds[1:])]
    print("phase 16 seconds: " + ", ".join(
        f"{part} {s:.1f}" for part, s in zip(
            ("(a)", "(c)", "(b)", "(d)", "(e)", "goodput"), out["seconds"]))
        + f"; {sum(out['seconds']):.1f} in all")
    # JSON keys: the modes as text
    for part in ("a", "b"):
        out[part] = {str(k): v for k, v in out[part].items()}
    return out


def phase16_launches(records, mem):
    """Each kernel record's launches a step on phase 16's paths, where
    the kernel ran there."""
    paths = {("per_layer", m): r for m, r in mem["a"].items()}
    paths.update({("stacked", m): r for m, r in mem["b"].items()})
    steps = TRANSPILE_TRAIN["steps"]
    for rec in records:
        name = rec["name"]
        if name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv"):
            i = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv").index(name)
            rec["launches_phase16"] = {
                f"{model} remat={mode}": r["flash_launches"][i]
                for (model, mode), r in paths.items()}
        elif name in ("conv1x1_stats", "scale_shift_act"):
            i = 0 if name == "conv1x1_stats" else 2
            rec["launches_phase16"] = {
                "resnet50 SGD(transpile=True)":
                    mem["e"]["transpiled"]["launches"][i] // steps}

# --- phase 17: the op plane the demos lack, and the GAN and VAE demos ------
# (a): every op of the slice on the card against the port's own CPU run
# of the same function, at the d1024 LM's activation width, one sequence
# of 2048 tokens ([2048, 1024]), in f32 and bf16. "exact" ops compare,
# select and take IEEE-rounded +, -, *, /, so the card equals the CPU bit
# for bit. The others are held within DEMO_F32_ULPS / DEMO_BF16_ULPS ulps
# in one of two readings, chosen for each output slot (the forward, then
# the gradients): "elem" slots call exp, log, tanh, sin, pow or a root
# (CUDA's and the CPU's differ in the last bits) and are held in ulps of
# each element's own magnitude (down to the smallest normal); "max"
# slots sum over a row or cancel (1 - tanh^2, sigmoid's ans * (1 - ans)
# and softplus's exp(x - softplus(x)) near saturation, expm1(x) + 1,
# sigmoid(x) - label, log_softmax's g - p * sum(g), a row's sum in
# another order) and are held in ulps of the tensor's largest |value|
# (on an H100, sigmoid's f32 gradient lay 277 ulps of its elements from
# the CPU's, under 1 ulp of its largest value). The forwards of losses
# whose terms share one sign are read by element. Both readings are kept
# for every slot. Three f32 slots round again after a transcendental gap
# of up to 4 ulps and are held at DEMO_F32_SLOT_ULPS: swish's forward
# x * sigmoid(beta x) (one product more), sigmoid's gradient
# g * (ans * (1 - ans)) and elementwise_pow's gradient of Y,
# g * (out * log(x)) (two products after pow's and log's gaps). prelu's
# gradient of Alpha sums 10^6 products of both signs, which the card and
# the CPU add in other orders: it is read in ulps of the sum of their
# magnitudes.
DEMO_OPS = dict(rows=2048, cols=1024)
DEMO_F32_ULPS = 4
DEMO_BF16_ULPS = 1
# (case, slot: 0 the forward, then each float input's gradient) -> ulps
DEMO_F32_SLOT_ULPS = {("swish", 0): 5, ("sigmoid", 1): 6,
                      ("elementwise_pow", 2): 6}
DEMO_TIES = (0.0, 0.5, -0.5, 1.0, -1.0, 1.5, -1.5, 2.0, -2.0, 2.5, -2.5,
             6.0, -6.0, 24.0)
# exp's and elementwise_pow's inputs: bounded, with their own exact points
DEMO_EXP_TIES = (0.0, 0.5, -0.5, 1.0, -1.0)
DEMO_POW_X_TIES = (1.0, 2.0, 0.5, 4.0)
DEMO_POW_Y_TIES = (0.0, 1.0, 2.0, -1.0, 0.5)
# (b): the GAN demo's two programs at its own widths and loop; (c): the
# VAE demo's. A demo's pass stops at ``batches`` or where the reader
# ends: the synthetic MNIST's 8192 samples give 128 batches of 64 and
# 64 of 128, so the loops run 640 and 320 steps of each program. Python's
# RNG is seeded once, so each pass shuffles anew as the demos' does. The
# first DEMO_CHECK_ROUNDS rounds are run again on the CPU
# (losses at DEMO_LOSS_RTOL), and the GAN's parameters after them are
# held within DEMO_NUDGE_MULT times the CPU's own move under an image
# nudge of (1 + DEMO_NUDGE) (Adam's first steps are sign-like: a
# near-zero gradient that flips moves its element by a whole lr).
GAN = dict(z=64, hidden=256, pixels=784, batch=64, lr=2e-4, beta1=0.5,
           passes=5, batches=200, seed=7)
VAE = dict(z=16, hidden=256, pixels=784, batch=128, lr=1e-3, passes=5,
           batches=200, seed=11)
GAN_D_PARAMS = ("d_fc1_w", "d_fc1_b", "d_fc2_w", "d_fc2_b")
GAN_G_PARAMS = ("g_fc1_w", "g_fc1_b", "g_fc2_w", "g_fc2_b")
DEMO_CHECK_ROUNDS = 3
DEMO_LOSS_RTOL = 1e-5
DEMO_NUDGE = 1e-6
DEMO_NUDGE_MULT = 4.0
DEMO_PARAM_FLOOR = 1e-6


def _demo_op_cases(rng):
    """name -> (op, attrs, {slot: [numpy]}, out slot, class): the class
    "exact", or (the forward's, the gradients') of "elem" and "max"."""
    import numpy as np

    R, C = DEMO_OPS["rows"], DEMO_OPS["cols"]

    def randn(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def tied(x, ties=DEMO_TIES):
        flat = x.reshape(-1)
        for i, t in enumerate(ties):
            flat[i::997 * len(ties)] = t
        return x

    def pos(*shape):
        return np.abs(randn(*shape, scale=2.0)) + np.float32(0.05)

    def unit(*shape):
        return rng.uniform(0.02, 0.98, shape).astype(np.float32)

    def dyadic(*shape):
        return (rng.randint(-48, 49, size=shape) / 16.0).astype(np.float32)

    def probs():
        e = np.exp(randn(R, C))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    x = tied(randn(R, C, scale=2.0))
    y_tied = randn(R, C, scale=2.0)
    y_tied.reshape(-1)[::5] = x.reshape(-1)[::5]
    maxout_x = x.copy()
    maxout_x[:, 1::2] = maxout_x[:, 0::2]
    ids = rng.permutation(R).astype(np.int64)
    ids[:8] -= R                # negative ids wrap once
    ids[8:12] = R + np.arange(4)  # out of range: NaN rows, no gradient
    hot = rng.randint(0, C, size=(R, 1)).astype(np.int64)
    hot[:4, 0] = [-1, C, 0, C - 1]
    cases = {}
    MAX = ("max", "max")
    SUM = ("elem", "max")  # a forward of terms of one sign
    elem = {"exp", "log", "sqrt", "rsqrt", "sin", "cos", "pow"}
    # the forward by element, the gradient cancelling
    elem_fwd = {"sigmoid", "logsigmoid", "softplus", "swish", "tanh", "stanh",
                "elu"}
    cancel = {"tanh_shrink", "log_softmax"}
    for op in ("sigmoid", "logsigmoid", "tanh", "exp", "log", "sqrt",
               "rsqrt", "abs", "ceil", "floor", "round", "reciprocal",
               "square", "softplus", "softsign", "sin", "cos",
               "tanh_shrink", "softshrink", "hard_shrink", "brelu", "relu6",
               "leaky_relu", "elu", "pow", "stanh", "hard_sigmoid",
               "thresholded_relu", "swish", "log_softmax"):
        inp = pos(R, C) if op in ("log", "sqrt", "rsqrt", "reciprocal",
                                  "pow") else x
        if op == "exp":
            inp = tied(randn(R, C, scale=2.0).clip(-8, 8), DEMO_EXP_TIES)
        attrs = {"factor": 1.5} if op == "pow" else {}
        kind = ("elem", "elem") if op in elem else \
            ("elem", "max") if op in elem_fwd else \
            ("max", "max") if op in cancel else "exact"
        cases[op] = (op, attrs, {"X": [inp]}, "Out", kind)
    cases["maxout"] = ("maxout", {"groups": 2}, {"X": [maxout_x]}, "Out",
                       "exact")
    cases["prelu"] = ("prelu", {}, {"X": [x], "Alpha": [
        np.float32([0.25])]}, "Out", "exact")
    pair = {"X": [x], "Y": [y_tied]}
    cases.update({
        "elementwise_div": ("elementwise_div", {}, {
            "X": [x], "Y": [pos(R, C)]}, "Out", "exact"),
        "elementwise_max": ("elementwise_max", {}, pair, "Out", "exact"),
        "elementwise_min": ("elementwise_min", {}, pair, "Out", "exact"),
        "elementwise_pow": ("elementwise_pow", {}, {
            "X": [tied(pos(R, C), DEMO_POW_X_TIES)],
            "Y": [tied(randn(R, C).clip(-3, 3), DEMO_POW_Y_TIES)]},
            "Out", ("elem", "elem")),
        "reduce_sum": ("reduce_sum", {"dim": [1]}, {"X": [x]}, "Out",
                       MAX),
        "reduce_mean": ("reduce_mean", {"dim": 1, "keep_dim": True},
                        {"X": [x]}, "Out", MAX),
        "reduce_max": ("reduce_max", {"dim": [1]}, {"X": [maxout_x]}, "Out",
                       "exact"),
        "reduce_min": ("reduce_min", {"dim": [1]}, {"X": [maxout_x]}, "Out",
                       "exact"),
        "reduce_prod": ("reduce_prod", {"dim": [1]}, {
            "X": [1 + randn(R * C // 8, 8, scale=0.1)]}, "Out", MAX),
        "argmax": ("argmax", {"axis": 1}, {"X": [maxout_x]}, "Out",
                   "exact"),
        "squeeze": ("squeeze", {"axes": [1]}, {"X": [x.reshape(R, 1, C)]},
                    "Out", "exact"),
        "unsqueeze": ("unsqueeze", {"axes": [0, -1]}, {"X": [x]}, "Out",
                      "exact"),
        "expand": ("expand", {"expand_times": [1, 2]}, {"X": [x]}, "Out",
                   "exact"),
        "stack": ("stack", {"axis": 1}, {"X": [x, y_tied]}, "Y", "exact"),
        "pad": ("pad", {"paddings": [1, 2, 3, 4], "pad_value": 0.5},
                {"X": [x]}, "Out", "exact"),
        "crop": ("crop", {"offsets": [1, 256], "shape": [-1, 512]},
                 {"X": [x]}, "Out", "exact"),
        "clip": ("clip", {"min": -1.0, "max": 2.0}, {"X": [x]}, "Out",
                 "exact"),
        "assign_value": ("assign_value", {
            "shape": [8, 128], "dtype": "float32",
            "values": [float(v) for v in randn(1024)]}, {}, "Out", "exact"),
        "fill_constant_batch_size_like": (
            "fill_constant_batch_size_like",
            {"shape": [-1, 1], "value": 0.9, "dtype": "float32"},
            {"Input": [x]}, "Out", "exact"),
        "gather": ("gather", {}, {"X": [x], "Index": [ids[:, None]]}, "Out",
                   "exact"),
        "one_hot": ("one_hot", {"depth": C}, {"X": [hot]}, "Out", "exact"),
        "logical_not": ("logical_not", {}, {"X": [x > 0]}, "Out", "exact"),
    })
    for op in ("not_equal", "less_than", "less_equal", "greater_than",
               "greater_equal"):
        cases[op] = (op, {}, pair, "Out", "exact")
    for op in ("logical_and", "logical_or", "logical_xor"):
        cases[op] = (op, {}, {"X": [x > 0], "Y": [y_tied > 0]}, "Out",
                     "exact")
    labels01 = (rng.rand(R, C) > 0.5).astype(np.float32)
    margin_x2 = dyadic(R, C)
    cases.update({
        "cross_entropy": ("cross_entropy", {}, {
            "X": [probs()], "Label": [hot.clip(0, C - 1)]}, "Y", SUM),
        "cross_entropy_soft": ("cross_entropy", {"soft_label": True}, {
            "X": [probs()], "Label": [probs()]}, "Y", SUM),
        "sigmoid_cross_entropy_with_logits": (
            "sigmoid_cross_entropy_with_logits", {},
            {"X": [x], "Label": [unit(R, C)]}, "Out", SUM),
        "bce_loss": ("bce_loss", {}, {"X": [unit(R, C)],
                                      "Label": [unit(R, C)]}, "Out", SUM),
        "square_error_cost": ("square_error_cost", {}, pair, "Out",
                              "exact"),
        "squared_l2_distance": ("squared_l2_distance", {}, pair, "Out",
                                SUM),
        "squared_l2_norm": ("squared_l2_norm", {}, {"X": [x]}, "Out", SUM),
        "hinge_loss": ("hinge_loss", {}, {"Logits": [dyadic(R, C)],
                                          "Labels": [labels01]}, "Loss",
                       "exact"),
        "huber_loss": ("huber_loss", {"delta": 1.0}, {
            "X": [dyadic(R, C)], "Y": [dyadic(R, C)]}, "Out", "exact"),
        "log_loss": ("log_loss", {}, {"Predicted": [unit(R, C)],
                                      "Labels": [labels01]}, "Loss", SUM),
        "rank_loss": ("rank_loss", {}, {"Label": [unit(R, C)],
                                        "Left": [x], "Right": [y_tied]},
                      "Out", MAX),
        "margin_rank_loss": ("margin_rank_loss", {"margin": 0.125}, {
            "Label": [labels01 * 2 - 1], "X1": [margin_x2 + np.float32(
                0.125)], "X2": [margin_x2]}, "Out", "exact"),
        "smooth_l1_loss": ("smooth_l1_loss", {"sigma": 1.0}, {
            "X": [dyadic(R, C)], "Y": [dyadic(R, C)]}, "Out", MAX),
        "dot": ("dot", {}, pair, "Out", MAX),
        "cos_sim": ("cos_sim", {}, pair, "Out", MAX),
    })
    return cases


def _ulps_of(got, want, dtype, at_max, scale=0.0):
    """The largest |got - want| in ulps of ``dtype``: each element's ulp
    at its own magnitude in ``want`` (down to the smallest normal, 2^-126
    in f32 and bf16 alike), or at the tensor's largest (``at_max``), or
    at no less than ``scale``. NaN against NaN and equal infinities count
    as equal."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ok = (np.isnan(got) & np.isnan(want)) | (np.isinf(want) & (got == want))
    mag = np.abs(np.where(ok, 0.0, want))
    mag = np.maximum(mag, max(scale, mag.max(initial=0.0) if at_max
                              else 2.0 ** -126))
    mant = 23 if dtype == "float32" else 7
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - mant)
    return float(np.max(np.where(ok, 0.0, np.abs(got - want)) / ulp,
                        initial=0.0))


def _demo_op_run(op, attrs, ins, slot, dtype, device, g):
    """Out ``slot`` of the port's ``op`` on ``device`` and the gradient
    of each float input (torch.autograd.grad with cotangent ``g``), as
    CPU tensors."""
    import torch

    from paddle_tpu_torch.core.registry import get_op

    tins, leaves = {}, []
    for s, arrs in ins.items():
        tins[s] = []
        for a in arrs:
            t = torch.from_numpy(a).to(device)
            if t.dtype == torch.float32:
                t = t.to(dtype).requires_grad_(True)
                leaves.append(t)
            tins[s].append(t)
    with torch.device(device):  # ops without inputs create on it
        out = get_op(op).fn(attrs, tins)[slot][0]
    grads = []
    if out.requires_grad:
        cot = g[:out.numel()].reshape(out.shape).to(device, out.dtype)
        grads = [torch.zeros_like(t) if d is None else d for t, d in zip(
            leaves, torch.autograd.grad(out, leaves, cot,
                                        allow_unused=True))]
    return out.detach().cpu(), [d.cpu() for d in grads]


def demo_ops_part(gpu_name):
    """(a): every op of the slice on the card against the port's CPU run,
    forward and gradient, f32 and bf16. Returns {case: record}."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 29)
    cases = _demo_op_cases(rng)
    g = torch.from_numpy(rng.randn(3 * DEMO_OPS["rows"] * DEMO_OPS["cols"])
                         .astype(np.float32))
    counts = _all_kernel_counts()
    out, worst = {}, []
    for name, (op, attrs, ins, slot, kind) in sorted(cases.items()):
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            card = _demo_op_run(op, attrs, ins, slot, tdt, "cuda", g)
            cpu = _demo_op_run(op, attrs, ins, slot, tdt, "cpu", g)
            pairs = [card[0], *card[1]], [cpu[0], *cpu[1]]
            assert card[0].dtype == cpu[0].dtype and \
                card[0].shape == cpu[0].shape, (name, dtype)
            rec = {"op": op, "class": kind, "shape": list(card[0].shape),
                   "dtype": str(card[0].dtype).replace("torch.", ""),
                   "grads": len(card[1])}
            if kind == "exact" or not card[0].is_floating_point():
                rec["equal"] = all(torch.equal(a, b) or bool(
                    ((a == b) | (a.isnan() & b.isnan())).all())
                    for a, b in zip(*pairs))
                if name == "prelu":
                    # Alpha's gradient (after X's) sums g * x over x < 0:
                    # read in ulps of the sum of |g * x|
                    rec["equal"] = torch.equal(card[0], cpu[0]) and \
                        torch.equal(card[1][0], cpu[1][0])
                    xs = ins["X"][0]
                    terms = float(np.abs(g[:xs.size].numpy().reshape(
                        xs.shape) * np.minimum(xs, 0)).sum())
                    rec["alpha_terms"] = terms
                    rec["alpha_grad_ulps"] = _ulps_of(
                        card[1][1].float(), cpu[1][1].float(), dtype, True,
                        terms)
                ok = rec["equal"] and rec.get("alpha_grad_ulps", 0) <= (
                    DEMO_F32_ULPS if dtype == "float32" else DEMO_BF16_ULPS)
            else:
                # each slot in both readings; the class's reading is held
                slots = [kind[0]] + [kind[1]] * len(card[1])
                rec["ulps_elem"] = [_ulps_of(a.float(), b.float(), dtype,
                                             False) for a, b in zip(*pairs)]
                rec["ulps_max"] = [_ulps_of(a.float(), b.float(), dtype,
                                            True) for a, b in zip(*pairs)]
                rec["ulps"] = [rec["ulps_" + c][i]
                               for i, c in enumerate(slots)]
                rec["limits"] = [DEMO_BF16_ULPS if dtype == "bfloat16" else
                                 DEMO_F32_SLOT_ULPS.get((name, i),
                                                        DEMO_F32_ULPS)
                                 for i in range(len(slots))]
                ok = all(u <= lim for u, lim in zip(rec["ulps"],
                                                    rec["limits"]))
            rec["ok"] = bool(ok)
            out[f"{name} {dtype}"] = rec
            if not ok:
                worst.append(f"{name} {dtype}: {rec}")
    assert _all_kernel_counts() == counts, "a demo op launched a kernel"
    n_exact = sum(1 for r in out.values() if "equal" in r)

    def worst_of(dtype, reading):
        return max((u for r in out.values() if "ulps" in r
                    and r["dtype"] == dtype
                    for u, c in zip(r["ulps"], [r["class"][0]] + [
                        r["class"][1]] * r["grads"]) if c == reading),
                   default=0.0)

    print(f"demo ops (a): {len(cases)} cases ({len(out)} with both dtypes) "
          f"on the card at [{DEMO_OPS['rows']}, {DEMO_OPS['cols']}] against "
          f"the port's CPU run, forward and gradient; {n_exact} held bit "
          f"for bit, the others within {DEMO_F32_ULPS} f32 (three slots "
          f"{min(DEMO_F32_SLOT_ULPS.values())}-"
          f"{max(DEMO_F32_SLOT_ULPS.values())}) / "
          f"{DEMO_BF16_ULPS} bf16 ulps; worst by element: f32 "
          f"{worst_of('float32', 'elem'):.2f}, bf16 "
          f"{worst_of('bfloat16', 'elem'):.2f}; worst of the largest: f32 "
          f"{worst_of('float32', 'max'):.2f}, bf16 "
          f"{worst_of('bfloat16', 'max'):.2f}; {len(worst)} outside their "
          f"limits")
    for line in worst:
        print("demo ops (a) outside its limit: " + line)
    return out, worst


def _gan_programs(pt, c):
    """demos/gan_mnist.py's two programs sharing parameters by name:
    (d_prog, g_prog, startup, d_loss, g_loss)."""
    L, P = pt.layers, pt.param_attr.ParamAttr

    def generator(z):
        h = L.fc(z, size=c["hidden"], act="relu",
                 param_attr=P(name="g_fc1_w"), bias_attr=P(name="g_fc1_b"))
        return L.fc(h, size=c["pixels"], act="tanh",
                    param_attr=P(name="g_fc2_w"), bias_attr=P(name="g_fc2_b"))

    def discriminator(x):
        h = L.fc(x, size=c["hidden"], param_attr=P(name="d_fc1_w"),
                 bias_attr=P(name="d_fc1_b"))
        h = L.leaky_relu(h, alpha=0.2)
        return L.fc(h, size=1, param_attr=P(name="d_fc2_w"),
                    bias_attr=P(name="d_fc2_b"))

    def bce_mean(logit, value):
        target = L.fill_constant_batch_size_like(
            logit, shape=[-1, 1], value=value, dtype="float32")
        return L.mean(L.sigmoid_cross_entropy_with_logits(logit, target))

    startup, d_prog, g_prog = pt.Program(), pt.Program(), pt.Program()
    startup.random_seed = c["seed"]
    with pt.program_guard(d_prog, startup):
        x_real = L.data("x_real", shape=[c["pixels"]])
        z = L.data("z", shape=[c["z"]])
        d_loss = L.elementwise_add(bce_mean(discriminator(x_real), 0.9),
                                   bce_mean(discriminator(generator(z)),
                                            0.0))
        pt.optimizer.AdamOptimizer(
            learning_rate=c["lr"], beta1=c["beta1"]).minimize(
            d_loss, parameter_list=list(GAN_D_PARAMS),
            startup_program=startup)
    with pt.program_guard(g_prog, startup):
        z = L.data("z", shape=[c["z"]])
        g_loss = bce_mean(discriminator(generator(z)), 1.0)
        pt.optimizer.AdamOptimizer(
            learning_rate=c["lr"], beta1=c["beta1"]).minimize(
            g_loss, parameter_list=list(GAN_G_PARAMS),
            startup_program=startup)
    return d_prog, g_prog, startup, d_loss, g_loss


def _vae_program(pt, c):
    """demos/vae_mnist.py's program: (main, startup, infer, loss, recon)."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = c["seed"]
    with pt.program_guard(main, startup):
        x = L.data("x", shape=[c["pixels"]])
        h = L.fc(x, size=c["hidden"], act="relu")
        mu = L.fc(h, size=c["z"])
        logvar = L.fc(h, size=c["z"])
        eps = L.gaussian_random_batch_size_like(mu, shape=[-1, c["z"]],
                                                mean=0.0, std=1.0)
        z = L.elementwise_add(mu, L.elementwise_mul(
            L.exp(L.scale(logvar, 0.5)), eps))
        x_logits = L.fc(L.fc(z, size=c["hidden"], act="relu"),
                        size=c["pixels"])
        rec = L.reduce_sum(L.sigmoid_cross_entropy_with_logits(x_logits, x),
                           dim=[1])
        kl = L.scale(L.reduce_sum(L.elementwise_sub(
            L.elementwise_add(L.exp(logvar), L.square(mu)),
            L.scale(logvar, 1.0, bias=1.0)), dim=[1]), 0.5)
        loss = L.mean(L.elementwise_add(rec, kl))
        recon = L.sigmoid(x_logits)
        infer = main.clone(for_test=True)
        pt.optimizer.AdamOptimizer(learning_rate=c["lr"]).minimize(
            loss, startup_program=startup)
    return main, startup, infer, loss, recon


def _demo_passes(pt, c):
    """The demos' reader: per pass, the list of its batches (at most
    ``batches``) of the synthetic MNIST shuffled in buffers of 2048.
    Python's RNG is seeded once, so every pass draws a new order."""
    import itertools
    import random

    import numpy as np

    random.seed(SEED)
    reader = pt.reader.batch(pt.reader.decorator.shuffle(
        pt.dataset.mnist.train(), buf_size=2048), c["batch"])
    for _ in range(c["passes"]):
        yield [np.stack([r[0] for r in rows]).reshape(len(rows), -1)
               for rows in itertools.islice(reader(), c["batches"])]


def _host_params(scope, names):
    return {n: scope.get_numpy(n) for n in names}


def _one_step_anatomy(step):
    """One step's wall ms (synchronised), then one profiled step's
    device ms and kernel launches."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    try:
        with _cuda_trace(primer=step) as prof:
            step()
        kernels = _traced_kernels(prof)
        dev = sum(us for _, us in kernels) / 1e3 if kernels else None
    except Exception as exc:  # noqa: BLE001 - a measurement aid
        print(f"demo anatomy: not measured ({type(exc).__name__}: {exc})")
        kernels, dev = [], None
    return {"wall_ms": wall, "device_ms": dev, "launches": len(kernels)}


def gan_part(pt):
    """(b): the GAN demo's full loop on the card, its first rounds
    against the CPU. Returns its record."""
    import numpy as np
    import torch

    c = GAN
    start = pt.Program._uid_counter
    built = _gan_programs(pt, c)
    d_prog, g_prog, startup, d_loss, g_loss = built
    adam = {name: sorted(op.input("Param") for op in p.global_block.ops
                         if op.type == "adam")
            for name, p in (("d", d_prog), ("g", g_prog))}
    assert adam == {"d": sorted(GAN_D_PARAMS), "g": sorted(GAN_G_PARAMS)}, \
        adam
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    init = _host_params(scope, [n for n in scope.keys()
                                if n != "@RNG_STATE@"])
    state_names = sorted(init)
    zrng = np.random.RandomState(0)
    d_hist, g_hist, d_ms, g_ms, checked = [], [], [], [], []
    first = []  # the first rounds' (x, z, z, z) for the CPU
    step = 0
    for batches in _demo_passes(pt, c):
        for batch_id, x in enumerate(batches):
            z = zrng.randn(len(x), c["z"]).astype(np.float32)
            t0 = time.perf_counter()
            dl, = exe.run(d_prog, feed={"x_real": x, "z": z},
                          fetch_list=[d_loss], scope=scope)
            d_ms.append((time.perf_counter() - t0) * 1e3)
            zs = [z]
            check = step < DEMO_CHECK_ROUNDS or batch_id == len(batches) - 1
            for _ in range(2):
                z = zrng.randn(len(x), c["z"]).astype(np.float32)
                zs.append(z)
                before = ([scope.get(n).clone() for n in GAN_D_PARAMS]
                          if check else None)
                t0 = time.perf_counter()
                gl, = exe.run(g_prog, feed={"z": z}, fetch_list=[g_loss],
                              scope=scope)
                g_ms.append((time.perf_counter() - t0) * 1e3)
                if check:
                    checked.append(all(torch.equal(b, scope.get(n)) for b, n
                                       in zip(before, GAN_D_PARAMS)))
                g_hist.append(float(gl))
            d_hist.append(float(dl))
            if step < DEMO_CHECK_ROUNDS:
                first.append((x, zs))
                if step == DEMO_CHECK_ROUNDS - 1:
                    after_rounds = _host_params(scope, state_names)
            step += 1
    anatomy = {"d": _one_step_anatomy(lambda: exe.run(
        d_prog, feed={"x_real": first[0][0], "z": first[0][1][0]},
        fetch_list=[d_loss], scope=scope)),
        "g": _one_step_anatomy(lambda: exe.run(
            g_prog, feed={"z": first[0][1][1]}, fetch_list=[g_loss],
            scope=scope))}

    # the first rounds on the CPU from the same state, and again with
    # the images nudged
    cpu_runs = []
    for nudge in (1.0, 1.0 + DEMO_NUDGE):
        pt.Program._uid_counter = start
        cd, cg, _, cdl, cgl = _gan_programs(pt, c)
        cscope = pt.scope_from_numpy(init, "cpu")
        cexe = pt.Executor(pt.CPUPlace())
        losses = []
        for x, zs in first:
            dl, = cexe.run(cd, feed={"x_real": x * np.float32(nudge),
                                     "z": zs[0]},
                           fetch_list=[cdl], scope=cscope)
            losses.append(float(dl))
            for z in zs[1:]:
                gl, = cexe.run(cg, feed={"z": z}, fetch_list=[cgl],
                               scope=cscope)
                losses.append(float(gl))
        cpu_runs.append((losses, _host_params(cscope, state_names)))
    card_first = []
    for i in range(DEMO_CHECK_ROUNDS):
        card_first += [d_hist[i], g_hist[2 * i], g_hist[2 * i + 1]]
    loss_rel = float(np.max(np.abs(np.array(card_first)
                                   - np.array(cpu_runs[0][0]))
                            / np.abs(np.array(cpu_runs[0][0]))))
    ratios = {}
    for n in GAN_D_PARAMS + GAN_G_PARAMS:
        gap = float(np.linalg.norm(after_rounds[n] - cpu_runs[0][1][n]))
        move = float(np.linalg.norm(cpu_runs[1][1][n] - cpu_runs[0][1][n]))
        allow = max(DEMO_NUDGE_MULT * move,
                    DEMO_PARAM_FLOOR * float(np.linalg.norm(
                        cpu_runs[0][1][n])))
        ratios[n] = {"gap": gap, "nudge_move": move, "allowed": allow}
    rec = {"config": c, "d_loss_first": d_hist[:3], "g_loss_first":
           g_hist[:6], "d_loss_final": d_hist[-1], "g_loss_final": g_hist[-1],
           "d_steps": len(d_hist), "g_steps": len(g_hist),
           "d_ms_per_step": float(np.median(d_ms)),
           "g_ms_per_step": float(np.median(g_ms)),
           "loop_s": float(sum(d_ms) + sum(g_ms)) / 1e3,
           "cpu_loss_first": cpu_runs[0][0], "loss_rel_vs_cpu": loss_rel,
           "params_vs_cpu": ratios, "d_frozen_checked": len(checked),
           "d_frozen": all(checked), "adam_params": adam,
           "anatomy": anatomy}
    print(f"demo GAN (b): {rec['d_steps']} D and {rec['g_steps']} G steps "
          f"at batch {c['batch']} on the card; final d_loss "
          f"{rec['d_loss_final']:.4f} g_loss {rec['g_loss_final']:.4f}; "
          f"D step {rec['d_ms_per_step']:.3f} ms, G step "
          f"{rec['g_ms_per_step']:.3f} ms (median wall with the loss "
          f"fetch); first {3 * DEMO_CHECK_ROUNDS} losses within "
          f"{loss_rel:.2e} of the CPU's; D parameters bitwise unchanged "
          f"over {len(checked)} checked G steps: {rec['d_frozen']}; worst "
          f"parameter gap / nudge allowance "
          f"{max(r['gap'] / r['allowed'] for r in ratios.values()):.3f}")
    for k, a in anatomy.items():
        print(f"demo GAN (d) {k.upper()} step: wall {a['wall_ms']:.3f} ms, "
              f"device {_ms_text(a['device_ms'])} ms, {a['launches']} "
              f"kernel launches (host-bound)")
    assert np.isfinite(d_hist).all() and np.isfinite(g_hist).all()
    assert 0.05 < d_hist[-1] < 3.5, d_hist[-5:]
    assert 0.02 < g_hist[-1] < 6.0, g_hist[-5:]
    assert rec["d_frozen"] and len(checked) == 2 * (
        DEMO_CHECK_ROUNDS + c["passes"]), len(checked)
    assert loss_rel <= DEMO_LOSS_RTOL, (card_first, cpu_runs[0][0])
    assert all(r["gap"] <= r["allowed"] for r in ratios.values()), ratios
    return rec


def vae_part(pt):
    """(c): the VAE demo's full loop on the card, its first steps against
    the CPU. Returns its record."""
    import numpy as np

    c = VAE
    start = pt.Program._uid_counter
    main, startup, infer, loss, recon = _vae_program(pt, c)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    init = {n: scope.get_numpy(n) for n in scope.keys()
            if n != "@RNG_STATE@"}
    rng_state = tuple(t.cpu() for t in scope.get("@RNG_STATE@"))
    hist, ms, first = [], [], []
    for batches in _demo_passes(pt, c):
        for x in batches:
            x = (x + 1.0) / 2.0
            if len(first) < DEMO_CHECK_ROUNDS:
                first.append(x)
            t0 = time.perf_counter()
            lo, = exe.run(main, feed={"x": x}, fetch_list=[loss],
                          scope=scope)
            ms.append((time.perf_counter() - t0) * 1e3)
            hist.append(float(lo))
    rec_np, = exe.run(infer, feed={"x": first[0][:4]}, fetch_list=[recon],
                      scope=scope)
    anatomy = _one_step_anatomy(lambda: exe.run(
        main, feed={"x": first[0]}, fetch_list=[loss], scope=scope))
    pt.Program._uid_counter = start
    cmain, _, _, closs, _ = _vae_program(pt, c)
    cscope = pt.scope_from_numpy(init, "cpu")
    cscope.set("@RNG_STATE@", rng_state)
    cexe = pt.Executor(pt.CPUPlace())
    cpu = [float(cexe.run(cmain, feed={"x": x}, fetch_list=[closs],
                          scope=cscope)[0]) for x in first]
    loss_rel = float(np.max(np.abs(np.array(hist[:len(cpu)]) - cpu)
                            / np.abs(cpu)))
    rec = {"config": c, "loss_first": hist[:3], "loss_final": hist[-1],
           "steps": len(hist), "ms_per_step": float(np.median(ms)),
           "loop_s": float(sum(ms)) / 1e3, "cpu_loss_first": cpu,
           "loss_rel_vs_cpu": loss_rel,
           "recon_min": float(np.min(rec_np)),
           "recon_max": float(np.max(rec_np)), "anatomy": anatomy}
    print(f"demo VAE (c): {len(hist)} steps at batch {c['batch']} on the "
          f"card; loss {hist[0]:.2f} -> {hist[-1]:.2f}; step "
          f"{rec['ms_per_step']:.3f} ms (median wall with the loss fetch); "
          f"first {len(cpu)} losses within {loss_rel:.2e} of the CPU's; "
          f"for_test reconstruction in [{rec['recon_min']:.4f}, "
          f"{rec['recon_max']:.4f}]")
    print(f"demo VAE (d) step: wall {anatomy['wall_ms']:.3f} ms, device "
          f"{_ms_text(anatomy['device_ms'])} ms, {anatomy['launches']} "
          f"kernel launches (host-bound)")
    assert np.isfinite(hist).all() and hist[-1] < hist[0], hist[:3]
    assert 0.0 <= rec["recon_min"] and rec["recon_max"] <= 1.0
    assert loss_rel <= DEMO_LOSS_RTOL, (hist[:3], cpu)
    return rec


def demo_ops_phase(gpu_name):
    """Phase 17: (a) the slice's ops on the card against the CPU, (b)
    the GAN and (c) the VAE demos' full loops, (d) their step times.
    Returns its record."""
    import paddle_tpu_torch as pt

    seconds = [time.perf_counter()]
    counts = _all_kernel_counts()
    ops, worst = demo_ops_part(gpu_name)
    seconds.append(time.perf_counter())
    gan = gan_part(pt)
    seconds.append(time.perf_counter())
    vae = vae_part(pt)
    seconds.append(time.perf_counter())
    assert _all_kernel_counts() == counts, "phase 17 launched a kernel"
    out = {"ops": ops, "gan": gan, "vae": vae, "seconds": [
        b - a for a, b in zip(seconds, seconds[1:])]}
    print("phase 17 seconds: " + ", ".join(
        f"{part} {s:.1f}" for part, s in zip(("(a)", "(b)", "(c)"),
                                             out["seconds"]))
        + f"; {sum(out['seconds']):.1f} in all")
    assert not worst, worst
    return out


# ---------------------------------------------------------------------------
# Phase 18: the book plane (datasets, sequence_conv, the CRF ops,
# beam_search_decoder, the evaluators) driving the Paddle book chapters
# ---------------------------------------------------------------------------
BOOK_CPU_STEPS = 5  # losses a chapter holds against the port's CPU run
BOOK_LOSS_RTOL = 1e-4
# the book's SRL model at its own widths (chapter 07, db_lstm), trained
# from the same weights with SGD at the book's 1e-4, then with Adam at
# 2e-3, the run reported: 3 epochs each, what the phase's time affords
# (a step is host-bound at 0.2-0.4 s on the card)
DB_LSTM = dict(word_dim=32, mark_dim=5, hidden_dim=512, depth=8,
               mix_hidden_lr=1e-3, batch=32, epochs=3,
               optimizers=(("sgd", 1e-4), ("adam", 2e-3)))
BOOK_OPS = dict(batch=32, tags=9, conv=(32, 128, 512), context=5,
                conv_out=512, dict=256, emb=32, hid=64, beam=4, max_len=12)
BOOK_GRAD_TOL = 1e-5  # max |card - CPU| / max |CPU|, f32 products
VITERBI_EPS = 1e-4  # a differing path's f64 score gap to the CPU's best
# a beam's score sums max_len f32 log-probs, each a few ulps off the
# CPU's (cuBLAS and the CPU's BLAS round the cell's products otherwise):
# held at 4 f32 ulps of the largest |score| a step
BEAM_SCORE_ULPS_A_STEP = 4
SEQ_TAG = dict(vocab=200, tags=5, T=12, emb=32, batch=32, steps=80,
               lr=5e-3)
NMT = dict(dict=256, emb=32, hid=64, batch=32, epochs=10, batches=24,
           beam=4, max_len=12, lr=5e-3)


def _book_fit_a_line(pt):
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data("x", shape=[13])
        y = layers.data("y", shape=[1])
        pred = layers.fc(x, size=1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        pt.optimizer.SGDOptimizer(learning_rate=0.01).minimize(
            loss, startup_program=startup)
    return dict(main=main, startup=startup, feeds=[x, y], fetch=[loss],
                reader=pt.dataset.uci_housing.train(), batch=32, epochs=12,
                gate=("loss", 0.5))


def _book_word2vec(pt):
    layers = pt.layers
    word_dict = pt.dataset.imikolov.build_dict()
    V, emb_dim, N = len(word_dict), 16, 5
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ws = [layers.data(f"w{i}", shape=[1], dtype="int64")
              for i in range(N - 1)]
        nxt = layers.data("next", shape=[1], dtype="int64")
        shared = pt.ParamAttr(name="shared_emb")
        embs = [layers.embedding(w, size=[V, emb_dim], param_attr=shared)
                for w in ws]
        hidden = layers.fc(layers.concat(embs, axis=1), size=64, act="relu")
        logits = layers.fc(hidden, size=V)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, nxt))
        pt.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(
            loss, startup_program=startup)
    reader = pt.reader.decorator.firstn(
        pt.dataset.imikolov.train(word_dict, N), 2000)
    return dict(main=main, startup=startup, feeds=ws + [nxt], fetch=[loss],
                reader=reader, batch=64, epochs=4, gate=("loss", 0.7))


def _book_recommender(pt):
    layers = pt.layers
    ml = pt.dataset.movielens
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = [layers.data(n, shape=[1], dtype="int64")
               for n in ("uid", "gender", "age", "job", "mid")]
        uid, gender, age, job, mid = ids
        score = layers.data("score", shape=[1])
        usr = layers.concat([
            layers.embedding(uid, size=[ml.max_user_id() + 1, 16]),
            layers.embedding(gender, size=[2, 4]),
            layers.embedding(age, size=[len(ml.age_table), 4]),
            layers.embedding(job, size=[ml.max_job_id() + 1, 8]),
        ], axis=1)
        mov = layers.embedding(mid, size=[ml.max_movie_id() + 1, 16])
        both = layers.concat([layers.fc(usr, size=32, act="tanh"),
                              layers.fc(mov, size=32, act="tanh")], axis=1)
        pred = layers.fc(both, size=1)
        loss = layers.mean(layers.square_error_cost(pred, score))
        pt.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(
            loss, startup_program=startup)

    def reader():
        for (u, g, a, j, m, _c, _t, s) in ml.train()():
            yield u, g, a, j, m, s

    return dict(main=main, startup=startup, feeds=ids + [score],
                fetch=[loss], reader=reader, batch=64, epochs=2,
                gate=("loss", 0.6))


def _book_sentiment(pt, lstm):
    """understand_sentiment: the sequence_conv classifier, or the stacked
    LSTM (``lstm``), as tests/test_book.py builds them."""
    layers = pt.layers
    word_dict = pt.dataset.imdb.word_dict()
    V, hid = len(word_dict), 32
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        words = layers.data("words", shape=[1], dtype="int64", lod_level=1)
        label = layers.data("label", shape=[1], dtype="int64")
        emb = layers.embedding(words, size=[V, 16])
        emb.seq_len = words.seq_len
        if lstm:
            x1 = layers.fc(emb, size=4 * hid, num_flatten_dims=2,
                           bias_attr=False)
            x1.seq_len = words.seq_len
            h1, _ = layers.dynamic_lstm(x1, 4 * hid)
            x2 = layers.fc(h1, size=4 * hid, num_flatten_dims=2,
                           bias_attr=False)
            x2.seq_len = words.seq_len
            h2, _ = layers.dynamic_lstm(x2, 4 * hid, is_reverse=True)
            feat = layers.concat([layers.sequence_pool(h1, "max"),
                                  layers.sequence_pool(h2, "max")], axis=1)
        else:
            conv3 = layers.sequence_conv(emb, num_filters=16, filter_size=3,
                                         act="tanh")
            feat = layers.sequence_pool(conv3, "max")
        logits = layers.fc(feat, size=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        pt.optimizer.AdamOptimizer(learning_rate=2e-2).minimize(
            loss, startup_program=startup)
    reader = pt.reader.decorator.firstn(pt.dataset.imdb.train(word_dict),
                                        384 if lstm else 512)
    return dict(main=main, startup=startup, feeds=[words, label],
                fetch=[loss, acc], reader=reader, batch=32, epochs=3,
                gate=("acc", 0.8 if lstm else 0.85))


def _book_srl(pt):
    layers = pt.layers
    word_d, _, label_d = pt.dataset.conll05.get_dict()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        word = layers.data("word", shape=[1], dtype="int64", lod_level=1)
        mark = layers.data("mark", shape=[1], dtype="int64", lod_level=1)
        tags = layers.data("tags", shape=[1], dtype="int64", lod_level=1)
        w_emb = layers.embedding(word, size=[len(word_d), 24])
        w_emb.seq_len = word.seq_len
        m_emb = layers.embedding(mark, size=[2, 4])
        m_emb.seq_len = mark.seq_len
        feat = layers.concat([w_emb, m_emb], axis=2)
        feat.seq_len = word.seq_len
        hidden = layers.sequence_conv(feat, num_filters=64, filter_size=5,
                                      act="tanh")
        emission = layers.fc(hidden, size=len(label_d), num_flatten_dims=2)
        crf = layers.linear_chain_crf(emission, tags)
        avg = layers.mean(crf)
        decoded = layers.crf_decoding(emission, transition=crf.transition)
        chunk = pt.evaluator.ChunkEvaluator(decoded, tags,
                                            num_chunk_types=4)
        pt.optimizer.AdamOptimizer(learning_rate=2e-2).minimize(
            avg, startup_program=startup)

    def reader():
        for s in pt.dataset.conll05.test()():
            yield s[0], s[7], s[8]  # words, mark, labels

    return dict(main=main, startup=startup, feeds=[word, mark, tags],
                fetch=[avg], reader=reader, batch=32, epochs=3,
                gate=("loss", 0.5), chunk=chunk, f1_gate=0.6)


def _book_mt(pt, infer=False):
    """machine_translation as tests/test_book.py builds it: the training
    program, or (``infer``) the beam decoder over the trained weights."""
    layers = pt.layers
    dict_size, emb_dim, hid = 64, 16, 32
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        src = layers.data("src", shape=[1], dtype="int64", lod_level=1)
        s_emb = layers.embedding(src, size=[dict_size, emb_dim],
                                 param_attr=pt.ParamAttr(name="src_emb"))
        s_emb.seq_len = src.seq_len
        s_proj = layers.fc(s_emb, size=3 * hid, num_flatten_dims=2,
                           bias_attr=False)
        enc = layers.dynamic_gru(s_proj, size=hid)
        enc_last = layers.sequence_last_step(enc)
        if infer:
            gb = main.global_block
            declare = lambda name, shape: gb.create_var(  # noqa: E731
                name=name, shape=shape, dtype="float32", persistable=True)
            w_half, _ = layers.split(declare("dec_wout",
                                             [2 * hid, dict_size]),
                                     [hid, hid], dim=0)
            outs = layers.beam_search_decoder(
                enc_last, declare("trg_emb", [dict_size, emb_dim]),
                (declare("dec_wx", [emb_dim, 3 * hid]),
                 declare("dec_wh", [hid, 3 * hid]),
                 declare("dec_bx", [3 * hid])), (w_half, None),
                beam_size=3, max_len=12, bos_id=0, eos_id=1, cell="gru")
            return main, startup, src, outs
        trg_in = layers.data("trg_in", shape=[1], dtype="int64", lod_level=1)
        trg_next = layers.data("trg_next", shape=[1], dtype="int64",
                               lod_level=1)
        t_emb = layers.embedding(trg_in, size=[dict_size, emb_dim],
                                 param_attr=pt.ParamAttr(name="trg_emb"))
        t_emb.seq_len = trg_in.seq_len
        t_proj = layers.fc(t_emb, size=3 * hid, num_flatten_dims=2,
                           param_attr=pt.ParamAttr(name="dec_wx"),
                           bias_attr=pt.ParamAttr(name="dec_bx"))
        dec = layers.dynamic_gru(t_proj, size=hid, h0=enc_last,
                                 param_attr=pt.ParamAttr(name="dec_wh"),
                                 bias_attr=False)
        att_w = layers.softmax(layers.matmul(dec, enc, transpose_y=True))
        both = layers.concat([dec, layers.matmul(att_w, enc)], axis=2)
        both.seq_len = trg_in.seq_len
        logits = layers.fc(both, size=dict_size, num_flatten_dims=2,
                           param_attr=pt.ParamAttr(name="dec_wout"),
                           bias_attr=False)
        tok_loss = layers.softmax_with_cross_entropy(logits, trg_next)
        tok_loss.seq_len = trg_next.seq_len
        loss = layers.mean(layers.sequence_pool(tok_loss, "average"))
        pt.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(
            loss, startup_program=startup)
    reader = pt.reader.decorator.firstn(pt.dataset.wmt14.train(dict_size),
                                        768)
    return dict(main=main, startup=startup, feeds=[src, trg_in, trg_next],
                fetch=[loss], reader=reader, batch=32, epochs=8,
                gate=("loss", 0.7))


BOOK_CHAPTERS = (
    ("fit_a_line", _book_fit_a_line),
    ("word2vec", _book_word2vec),
    ("recommender", _book_recommender),
    ("understand_sentiment_conv", lambda pt: _book_sentiment(pt, False)),
    ("understand_sentiment_stacked_lstm",
     lambda pt: _book_sentiment(pt, True)),
    ("label_semantic_roles", _book_srl),
    ("machine_translation", _book_mt),
)


def _state(scope):
    return {n: scope.get_numpy(n) for n in scope.keys()
            if n != "@RNG_STATE@"}


def _book_train(pt, make, place, state=None, steps=None):
    """Train a chapter through DataFeeder + minibatch with its epochs and
    batch size; ``state`` (host arrays) replaces the startup's values.
    Returns (built, scope, exe, fetched means a step, wall ms a step, the
    first feeds, the startup state)."""
    import numpy as np

    b = make(pt)
    scope = pt.Scope()
    exe = pt.Executor(place)
    exe.run(b["startup"], scope=scope)
    if state is not None:
        scope = pt.scope_from_numpy(state, exe.device)
    init = _state(scope)
    feeder = pt.data_feeder.DataFeeder(b["feeds"])
    vals, ms, first = [], [], []
    for _ in range(b["epochs"]):
        if "chunk" in b:
            b["chunk"].reset(exe, scope)
        for rows in pt.reader.minibatch.batch(b["reader"], b["batch"])():
            feed = feeder.feed(rows)
            if len(first) < BOOK_CPU_STEPS:
                first.append(feed)
            t0 = time.perf_counter()
            out = exe.run(b["main"], feed=feed, fetch_list=b["fetch"],
                          scope=scope)
            ms.append((time.perf_counter() - t0) * 1e3)
            vals.append([float(np.asarray(v).mean()) for v in out])
            if steps is not None and len(vals) == steps:
                return b, scope, exe, vals, ms, first, init
    return b, scope, exe, vals, ms, first, init


def book_chapters_part(pt, smi):
    """(a): each chapter of tests/test_book.py trained on the card with
    that file's epochs, batch sizes, readers and thresholds; its first
    losses against the port's CPU run from the same startup weights.
    Returns {chapter: record}."""
    import numpy as np

    out = {}
    for name, make in BOOK_CHAPTERS:
        start = pt.Program._uid_counter
        t0 = time.perf_counter()
        b, scope, exe, vals, ms, first, init = _book_train(
            pt, make, pt.CUDAPlace(0))
        loop_s = time.perf_counter() - t0
        losses = [v[0] for v in vals]
        rec = {"steps": len(vals), "epochs": b["epochs"],
               "batch": b["batch"], "loss_first": losses[0],
               "loss_final": losses[-1],
               "ms_per_step": float(np.median(ms)), "loop_s": loop_s}
        kind, limit = b["gate"]
        if kind == "loss":
            rec["loss_ratio"] = losses[-1] / losses[0]
            passed = rec["loss_ratio"] < limit
        else:
            rec["final_acc"] = float(np.mean([v[1] for v in vals[-5:]]))
            passed = rec["final_acc"] > limit
        if "chunk" in b:
            rec["chunk_f1"] = b["chunk"].eval(exe, scope)[2]
            passed = passed and rec["chunk_f1"] > b["f1_gate"]
        if name == "machine_translation":
            infer, istart, src, outs = _book_mt(pt, infer=True)
            exe.run(istart, scope=scope)
            test_src = [s for s, _, _ in
                        list(pt.dataset.wmt14.test(64)())[:4]]
            feed = pt.data_feeder.DataFeeder([src]).feed(
                [(s,) for s in test_src])
            ids, scores, lens = exe.run(infer, feed=feed,
                                        fetch_list=list(outs), scope=scope)
            rec["beam_shape"] = list(ids.shape)
            rec["beam_sorted"] = bool(np.all(np.diff(scores, axis=1)
                                             <= 1e-5))
            passed = (passed and ids.shape[1:] == (3, 12)
                      and rec["beam_sorted"])
        rec["anatomy"] = _one_step_anatomy(lambda: exe.run(
            b["main"], feed=first[0], fetch_list=b["fetch"], scope=scope))
        # the first steps again on the CPU, from the same startup weights
        pt.Program._uid_counter = start
        cpu = _book_train(pt, make, pt.CPUPlace(), state=init,
                          steps=BOOK_CPU_STEPS)[3]
        card = losses[:BOOK_CPU_STEPS]
        rec["cpu_loss_first"] = [v[0] for v in cpu]
        rec["loss_first_card"] = card
        rec["loss_rel_vs_cpu"] = float(np.max(
            np.abs(np.array(card) - rec["cpu_loss_first"])
            / np.abs(rec["cpu_loss_first"])))
        rec["passed"] = bool(passed)
        out[name] = rec
        gate = (f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (ratio "
                f"{rec['loss_ratio']:.3f} < {limit})" if kind == "loss" else
                f"accuracy of the last 5 batches {rec['final_acc']:.3f} > "
                f"{limit}")
        extra = (f"; chunk F1 {rec['chunk_f1']:.3f} > {b['f1_gate']}"
                 if "chunk" in rec else "")
        if "beam_shape" in rec:
            extra += (f"; beam ids {rec['beam_shape']}, scores sorted: "
                      f"{rec['beam_sorted']}")
        a = rec["anatomy"]
        print(f"book (a) {name}: {rec['steps']} steps ({b['epochs']} "
              f"epochs, batch {b['batch']}) on the card, {gate}{extra}; "
              f"first {BOOK_CPU_STEPS} losses within "
              f"{rec['loss_rel_vs_cpu']:.2e} of the CPU's; step "
              f"{rec['ms_per_step']:.3f} ms (median wall with the fetch), "
              f"one step {a['wall_ms']:.3f} ms wall / "
              f"{_ms_text(a['device_ms'])} ms device / {a['launches']} "
              f"kernel launches [{smi}]")
    bad = {n: r for n, r in out.items() if not r["passed"]
           or r["loss_rel_vs_cpu"] > BOOK_LOSS_RTOL}
    assert not bad, bad
    return out


def db_lstm_program(pt, c, optimizer, lr):
    """The book's SRL model, db_lstm (chapter 07, label_semantic_roles),
    at the widths in ``c``, with its CRF, decoder and chunk evaluator.
    The fc layers take num_flatten_dims=2: a sequence is a padded
    [b, T, d] tensor here, a [sum of T, d] LoD tensor in fluid."""
    import math

    layers = pt.layers
    word_d, verb_d, label_d = pt.dataset.conll05.get_dict()
    hidden_dim, n_labels = c["hidden_dim"], len(label_d)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        seq = lambda name: layers.data(  # noqa: E731
            name, shape=[1], dtype="int64", lod_level=1)
        word = seq("word_data")
        ctx = [seq(n) for n in ("ctx_n2_data", "ctx_n1_data", "ctx_0_data",
                                "ctx_p1_data", "ctx_p2_data")]
        predicate, mark, target = (seq("verb_data"), seq("mark_data"),
                                   seq("target"))
        embs = [layers.embedding(
            x, size=[len(word_d), c["word_dim"]],
            param_attr=pt.ParamAttr(name="emb", trainable=False))
            for x in [word] + ctx]
        embs.append(layers.embedding(
            predicate, size=[len(verb_d), c["word_dim"]], param_attr="vemb"))
        embs.append(layers.embedding(mark, size=[2, c["mark_dim"]]))
        hidden_0 = layers.sums([layers.fc(e, size=hidden_dim,
                                          num_flatten_dims=2) for e in embs])
        lstm_0, _ = layers.dynamic_lstm(
            hidden_0, size=hidden_dim, candidate_activation="relu",
            gate_activation="sigmoid", cell_activation="sigmoid")
        input_tmp = [hidden_0, lstm_0]
        for i in range(1, c["depth"]):
            mix_hidden = layers.sums([
                layers.fc(input_tmp[0], size=hidden_dim, num_flatten_dims=2),
                layers.fc(input_tmp[1], size=hidden_dim, num_flatten_dims=2)])
            lstm, _ = layers.dynamic_lstm(
                mix_hidden, size=hidden_dim, candidate_activation="relu",
                gate_activation="sigmoid", cell_activation="sigmoid",
                is_reverse=(i % 2) == 1)
            input_tmp = [mix_hidden, lstm]
        feature_out = layers.sums([
            layers.fc(input_tmp[0], size=n_labels, act="tanh",
                      num_flatten_dims=2),
            layers.fc(input_tmp[1], size=n_labels, act="tanh",
                      num_flatten_dims=2)])
        crf_cost = layers.linear_chain_crf(
            feature_out, target, param_attr=pt.ParamAttr(
                name="crfw", learning_rate=c["mix_hidden_lr"]))
        avg_cost = layers.mean(crf_cost)
        crf_decode = layers.crf_decoding(
            feature_out, param_attr=pt.ParamAttr(name="crfw"))
        chunk = pt.evaluator.ChunkEvaluator(
            crf_decode, target, chunk_scheme="IOB",
            num_chunk_types=int(math.ceil((n_labels - 1) / 2.0)))
        opt = (pt.optimizer.AdamOptimizer if optimizer == "adam"
               else pt.optimizer.SGDOptimizer)
        opt(learning_rate=lr).minimize(avg_cost, startup_program=startup)
    return dict(main=main, startup=startup,
                feeds=[word] + ctx + [predicate, mark, target],
                fetch=[avg_cost], reader=pt.dataset.conll05.test(),
                batch=c["batch"], epochs=c["epochs"], chunk=chunk,
                emission=feature_out)


def _db_lstm_train(pt, c, optimizer, lr):
    """db_lstm trained on the card for c["epochs"] epochs, the chunk F1
    from ChunkEvaluator after each (reset at its start, as the book's
    loop does). Returns (built, scope, exe, losses, ms a step, F1s, the
    first feed, loop seconds)."""
    import torch

    b = db_lstm_program(pt, c, optimizer, lr)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(b["startup"], scope=scope)
    # the book loads the pretrained word table into "emb"
    scope.set("emb", torch.from_numpy(
        pt.dataset.conll05.get_embedding()).to(exe.device))
    feeder = pt.data_feeder.DataFeeder(b["feeds"])
    vals, ms, f1s, first = [], [], [], None
    t0 = time.perf_counter()
    for _ in range(c["epochs"]):
        b["chunk"].reset(exe, scope)
        for rows in pt.reader.minibatch.batch(b["reader"], c["batch"])():
            feed = feeder.feed(rows)
            first = first or feed
            s0 = time.perf_counter()
            lo, = exe.run(b["main"], feed=feed, fetch_list=b["fetch"],
                          scope=scope)
            ms.append((time.perf_counter() - s0) * 1e3)
            vals.append(float(lo))
        f1s.append(b["chunk"].eval(exe, scope)[2])
    return b, scope, exe, vals, ms, f1s, first, time.perf_counter() - t0


def db_lstm_part(pt, smi):
    """(b): db_lstm at the book's widths trained on the card over the
    synthetic conll05, from the same startup weights with each optimizer
    of DB_LSTM; the last is the one reported. Returns its record."""
    import numpy as np

    c = DB_LSTM
    start = pt.Program._uid_counter
    rec = {"config": c}
    for optimizer, lr in c["optimizers"]:
        pt.Program._uid_counter = start  # the same names, the same draws
        b, scope, exe, vals, ms, f1s, first, loop_s = _db_lstm_train(
            pt, c, optimizer, lr)
        rec[optimizer] = {"lr": lr, "steps": len(vals), "losses": vals,
                          "epoch_f1": f1s,
                          "ms_per_step": float(np.median(ms)),
                          "loop_s": loop_s}
        print(f"book (b) db_lstm with {optimizer} {lr}: {len(vals)} steps "
              f"({c['epochs']} epochs, batch {c['batch']}) on the card in "
              f"{loop_s:.1f} s; loss {vals[0]:.3f} -> {vals[-1]:.3f}; chunk "
              f"F1 by epoch {', '.join(f'{f:.3f}' for f in f1s)}; step "
              f"{rec[optimizer]['ms_per_step']:.3f} ms (median wall with "
              f"the fetch) [{smi}]")
        assert np.isfinite(vals).all() and vals[-1] < vals[0], vals[:3]
    n_params = sum(int(np.prod(p.shape))
                   for p in b["main"].global_block.all_parameters())
    anatomy = _one_step_anatomy(lambda: exe.run(
        b["main"], feed=first, fetch_list=b["fetch"], scope=scope))
    rec.update(optimizer=optimizer, params=n_params, anatomy=anatomy,
               final_chunk_f1=f1s[-1])
    print(f"book (b) db_lstm: word_dim {c['word_dim']}, hidden_dim "
          f"{c['hidden_dim']} (LSTM {c['hidden_dim'] // 4} units), depth "
          f"{c['depth']}, {n_params} parameters, trained with "
          f"{optimizer}: final chunk F1 {f1s[-1]:.4f}; one step "
          f"{anatomy['wall_ms']:.3f} ms wall / "
          f"{_ms_text(anatomy['device_ms'])} ms device / "
          f"{anatomy['launches']} kernel launches [{smi}]")
    return rec


def _path_score(em, trans, path, length):
    """A tag path's CRF score in f64."""
    if length == 0:
        return 0.0
    em = em.astype("float64")
    trans = trans.astype("float64")
    p = path[:length]
    s = trans[0, p[0]] + trans[1, p[-1]] + em[range(length), p].sum()
    return float(s + trans[2 + p[:-1], p[1:]].sum())


def _op_pair(op, attrs, ins, slots, grad_of=(), seed=0):
    """The port's ``op`` on the card and on the CPU over the same numpy
    inputs: ({slot: CPU tensor} card, cpu, [card grads], [cpu grads],
    card ms of the forward). Gradients of the ``grad_of`` inputs under a
    random cotangent on the first slot."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.registry import get_op

    res = []
    for device in ("cuda", "cpu"):
        tins, leaves = {}, []
        for s, arrs in ins.items():
            tins[s] = []
            for a in arrs:
                t = torch.from_numpy(a).to(device)
                if s in grad_of:
                    t.requires_grad_(True)
                    leaves.append(t)
                tins[s].append(t)
        outs = get_op(op).fn(attrs, tins)
        grads = []
        if leaves:
            y = outs[slots[0]][0]
            cot = torch.from_numpy(np.random.RandomState(seed).randn(
                *y.shape).astype(np.float32)).to(device)
            grads = [g.cpu() for g in torch.autograd.grad(y, leaves, cot)]
        ms = None
        if device == "cuda":
            with torch.no_grad():
                ms = _cuda_ms(lambda: get_op(op).fn(attrs, tins), iters=10)
        res.append(({s: outs[s][0].detach().cpu() for s in slots}, grads,
                    ms))
    (card, cg, ms), (cpu, pg, _) = res
    return card, cpu, cg, pg, ms


def _rel(got, want):
    got = got.double()
    want = want.double()
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                  1e-30))


def book_ops_part(smi):
    """(c): the slice's ops at full size on the card against the port's
    CPU run of the same inputs. Returns its record."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt

    c = BOOK_OPS
    rng = np.random.RandomState(SEED + 30)
    rec = {}
    # the CRF ops at db_lstm's emission shape for a batch of conll05
    rows = list(pt.dataset.conll05.test()())
    T = max(len(r[0]) for r in rows)
    batch = rows[:c["batch"]]
    lengths = np.array([len(r[0]) for r in batch], np.int32)
    label = np.zeros((c["batch"], T), np.int64)
    for i, r in enumerate(batch):
        label[i, :len(r[8])] = r[8]
    n = c["tags"]
    em = (rng.randn(c["batch"], T, n) * 2).astype(np.float32)
    trans = (rng.randn(n + 2, n) * 0.5).astype(np.float32)
    ins = {"Emission": [em], "Transition": [trans], "Label": [label],
           "Length": [lengths]}
    card, cpu, cg, pg, crf_ms = _op_pair(
        "linear_chain_crf", {}, ins, ["LogLikelihood", "Alpha"],
        grad_of=("Emission", "Transition"), seed=SEED + 31)
    rec["linear_chain_crf"] = {
        "shape": [c["batch"], T, n], "ms": crf_ms,
        "nll_rel": _rel(card["LogLikelihood"], cpu["LogLikelihood"]),
        "alpha_rel": _rel(card["Alpha"], cpu["Alpha"]),
        "d_emission_rel": _rel(cg[0], pg[0]),
        "d_transition_rel": _rel(cg[1], pg[1])}
    dins = {"Emission": [em], "Transition": [trans], "Length": [lengths]}
    card, cpu, _, _, vit_ms = _op_pair("crf_decoding", {}, dins,
                                       ["ViterbiPath"])
    cp, pp = card["ViterbiPath"].numpy(), cpu["ViterbiPath"].numpy()
    differ = [i for i in range(c["batch"]) if not np.array_equal(cp[i],
                                                                 pp[i])]
    gaps = [abs(_path_score(em[i], trans, cp[i], lengths[i])
                - _path_score(em[i], trans, pp[i], lengths[i]))
            for i in differ]
    dins["Label"] = [label]
    card_m, cpu_m, _, _, _ = _op_pair("crf_decoding", {}, dins,
                                      ["ViterbiPath"])
    same_rows = [i for i in range(c["batch"]) if i not in differ]
    rec["crf_decoding"] = {
        "ms": vit_ms, "paths_differ": len(differ),
        "differ_score_gaps": gaps,
        "mask_equal": bool(np.array_equal(
            card_m["ViterbiPath"].numpy()[same_rows],
            cpu_m["ViterbiPath"].numpy()[same_rows]))}
    # chunk_eval over the CPU's paths against the labels
    cins = {"Inference": [pp], "Label": [label], "Length": [lengths]}
    slots = ["Precision", "Recall", "F1-Score", "NumInferChunks",
             "NumLabelChunks", "NumCorrectChunks"]
    card, cpu, _, _, chunk_ms = _op_pair("chunk_eval",
                                         {"num_chunk_types": 4}, cins, slots)
    rec["chunk_eval"] = {
        "ms": chunk_ms,
        "counts": [int(card[s][0]) for s in slots[3:]],
        "equal": all(torch.equal(card[s], cpu[s]) for s in slots)}
    # sequence_conv at [32, 128, 512], context 5
    b, t, d = c["conv"]
    k = c["context"]
    x = rng.randn(b, t, d).astype(np.float32)
    f = (rng.randn(k * d, c["conv_out"]) / np.sqrt(k * d)).astype(
        np.float32)
    slen = rng.randint(1, t + 1, size=b).astype(np.int32)
    slen[0] = t
    card, cpu, cg, pg, conv_ms = _op_pair(
        "sequence_conv", {"contextLength": k, "contextStart": -(k // 2)},
        {"X": [x], "Filter": [f], "Length": [slen]}, ["Out"],
        grad_of=("X", "Filter"), seed=SEED + 32)
    rec["sequence_conv"] = {
        "shape": [b, t, d, c["conv_out"]], "context": k, "ms": conv_ms,
        "out_rel": _rel(card["Out"], cpu["Out"]),
        "dx_rel": _rel(cg[0], pg[0]), "dfilter_rel": _rel(cg[1], pg[1])}
    # beam_search_decoder at nmt_seq2seq's widths
    V, e, h = c["dict"], c["emb"], c["hid"]
    for cell, G in (("gru", 3), ("lstm", 4)):
        bins = {"InitState": [rng.randn(c["batch"], h).astype(np.float32)],
                "Embedding": [rng.randn(V, e).astype(np.float32)],
                "WeightX": [(rng.randn(e, G * h) * 0.3).astype(np.float32)],
                "WeightH": [(rng.randn(h, G * h) * 0.3).astype(np.float32)],
                "Bias": [(rng.randn(1, G * h) * 0.1).astype(np.float32)],
                "WeightOut": [rng.randn(h, V).astype(np.float32)]}
        if cell == "lstm":
            bins["InitCell"] = [rng.randn(c["batch"], h).astype(np.float32)]
        card, cpu, _, _, beam_ms = _op_pair(
            "beam_search_decoder",
            {"beam_size": c["beam"], "max_len": c["max_len"], "bos_id": 0,
             "eos_id": 1, "cell": cell}, bins, ["Ids", "SeqScores",
                                               "SeqLen"])
        rec[f"beam_search_decoder_{cell}"] = {
            "ms": beam_ms, "ids_equal": torch.equal(card["Ids"], cpu["Ids"]),
            "lens_equal": torch.equal(card["SeqLen"], cpu["SeqLen"]),
            "scores_abs": float((card["SeqScores"] - cpu["SeqScores"])
                                .abs().max()),
            "scores_ulps": _ulps_of(card["SeqScores"], cpu["SeqScores"],
                                    "float32", True),
            "mean_len": float(card["SeqLen"].float().mean())}
    r = rec
    print(f"book (c) ops on the card against the CPU: linear_chain_crf "
          f"[{c['batch']}, {T}, {n}] NLL rel {r['linear_chain_crf']['nll_rel']:.2e}, "
          f"dEmission {r['linear_chain_crf']['d_emission_rel']:.2e}, "
          f"dTransition {r['linear_chain_crf']['d_transition_rel']:.2e} "
          f"(of the largest |value|; limit {BOOK_GRAD_TOL}); crf_decoding: "
          f"{r['crf_decoding']['paths_differ']} of {c['batch']} paths "
          f"differ (f64 score gaps {gaps}, limit {VITERBI_EPS}), mask equal "
          f"{r['crf_decoding']['mask_equal']}; chunk_eval counts "
          f"{r['chunk_eval']['counts']} equal {r['chunk_eval']['equal']}; "
          f"sequence_conv [{b}, {t}, {d}] -> {c['conv_out']} context {k}: "
          f"out {r['sequence_conv']['out_rel']:.2e}, dX "
          f"{r['sequence_conv']['dx_rel']:.2e}, dFilter "
          f"{r['sequence_conv']['dfilter_rel']:.2e}; beam_search_decoder "
          f"(V {V}, e {e}, h {h}, beam {c['beam']}, max_len {c['max_len']}, "
          f"b {c['batch']}): gru ids equal "
          f"{r['beam_search_decoder_gru']['ids_equal']}, lstm ids equal "
          f"{r['beam_search_decoder_lstm']['ids_equal']}, score gaps "
          f"{r['beam_search_decoder_gru']['scores_abs']:.2e} / "
          f"{r['beam_search_decoder_lstm']['scores_abs']:.2e} ("
          f"{r['beam_search_decoder_gru']['scores_ulps']:.2f} / "
          f"{r['beam_search_decoder_lstm']['scores_ulps']:.2f} f32 ulps of "
          f"the largest |score|, limit {BEAM_SCORE_ULPS_A_STEP} a step: "
          f"{BEAM_SCORE_ULPS_A_STEP * c['max_len']}) [{smi}]")
    print(f"book (c) card ms a call: linear_chain_crf {_ms_text(crf_ms)}, "
          f"crf_decoding {_ms_text(vit_ms)}, chunk_eval "
          f"{_ms_text(chunk_ms)}, sequence_conv {_ms_text(conv_ms)}, "
          f"beam_search_decoder gru "
          f"{_ms_text(r['beam_search_decoder_gru']['ms'])} / lstm "
          f"{_ms_text(r['beam_search_decoder_lstm']['ms'])} (CUDA events, "
          f"host-paced eager loops) [{smi}]")
    lc = r["linear_chain_crf"]
    assert max(lc["nll_rel"], lc["alpha_rel"], lc["d_emission_rel"],
               lc["d_transition_rel"]) <= BOOK_GRAD_TOL, lc
    assert all(g <= VITERBI_EPS for g in gaps), gaps
    assert r["crf_decoding"]["mask_equal"] and r["chunk_eval"]["equal"]
    sc = r["sequence_conv"]
    assert max(sc["out_rel"], sc["dx_rel"], sc["dfilter_rel"]) \
        <= BOOK_GRAD_TOL, sc
    for cell in ("gru", "lstm"):
        bd = r[f"beam_search_decoder_{cell}"]
        assert bd["ids_equal"] and bd["lens_equal"], (cell, bd)
        assert bd["scores_ulps"] <= BEAM_SCORE_ULPS_A_STEP * c["max_len"], \
            (cell, bd)
    return rec


def _seq_tag_program(pt, c):
    """demos/sequence_tagging_crf.py's program."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        words = layers.data("words", shape=[1], dtype="int64", lod_level=1)
        tags = layers.data("tags", shape=[1], dtype="int64", lod_level=1)
        emb = layers.embedding(words, size=[c["vocab"], c["emb"]])
        emb.seq_len = words.seq_len
        feat = layers.fc(emb, size=c["tags"], num_flatten_dims=2)
        feat.seq_len = words.seq_len
        crf = layers.linear_chain_crf(feat, tags)
        loss = layers.mean(crf)
        decoded = layers.crf_decoding(feat, transition=crf.transition)
        pt.optimizer.AdamOptimizer(learning_rate=c["lr"]).minimize(
            loss, startup_program=startup)
    return main, startup, loss, decoded


def _seq_tag_batch(rng, n, c):
    """The demo's synthetic_tagging: tags = word % n_tags."""
    import numpy as np

    words = rng.randint(0, c["vocab"], size=(n, c["T"])).astype(np.int64)
    tags = (words % c["tags"]).astype(np.int64)
    lens = rng.randint(max(2, c["T"] // 2), c["T"] + 1,
                       size=n).astype(np.int32)
    return {"words": words[..., None], "words@len": lens,
            "tags": tags[..., None], "tags@len": lens}


def _nmt_programs(pt, c, infer=False):
    """demos/nmt_seq2seq.py's build_train / build_infer."""
    layers = pt.layers
    D, E, H = c["dict"], c["emb"], c["hid"]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        src = layers.data("src", shape=[1], dtype="int64", lod_level=1)
        s_emb = layers.embedding(src, size=[D, E],
                                 param_attr=pt.ParamAttr(name="src_emb"))
        s_emb.seq_len = src.seq_len
        s_proj = layers.fc(s_emb, size=3 * H, num_flatten_dims=2,
                           param_attr=pt.ParamAttr(name="src_proj_w"),
                           bias_attr=False)
        enc = layers.dynamic_gru(s_proj, size=H,
                                 param_attr=pt.ParamAttr(name="enc_wh"),
                                 bias_attr=False)
        enc_last = layers.sequence_last_step(enc)
        if infer:
            gb = main.global_block
            declare = lambda name, shape: gb.create_var(  # noqa: E731
                name=name, shape=shape, dtype="float32", persistable=True)
            w_half, _ = layers.split(declare("dec_wout", [2 * H, D]),
                                     [H, H], dim=0)
            outs = layers.beam_search_decoder(
                enc_last, declare("trg_emb", [D, E]),
                (declare("dec_wx", [E, 3 * H]), declare("dec_wh", [H, 3 * H]),
                 declare("dec_bx", [3 * H])), (w_half, None),
                beam_size=c["beam"], max_len=c["max_len"], bos_id=0,
                eos_id=1, cell="gru")
            return main, outs
        trg_in = layers.data("trg_in", shape=[1], dtype="int64", lod_level=1)
        trg_next = layers.data("trg_next", shape=[1], dtype="int64",
                               lod_level=1)
        t_emb = layers.embedding(trg_in, size=[D, E],
                                 param_attr=pt.ParamAttr(name="trg_emb"))
        t_emb.seq_len = trg_in.seq_len
        t_proj = layers.fc(t_emb, size=3 * H, num_flatten_dims=2,
                           param_attr=pt.ParamAttr(name="dec_wx"),
                           bias_attr=pt.ParamAttr(name="dec_bx"))
        dec = layers.dynamic_gru(t_proj, size=H, h0=enc_last,
                                 param_attr=pt.ParamAttr(name="dec_wh"),
                                 bias_attr=False)
        scores = layers.matmul(dec, enc, transpose_y=True)
        ctx = layers.matmul(layers.softmax(scores), enc)
        both = layers.concat([dec, ctx], axis=2)
        both.seq_len = trg_in.seq_len
        logits = layers.fc(both, size=D, num_flatten_dims=2,
                           param_attr=pt.ParamAttr(name="dec_wout"),
                           bias_attr=False)
        tok_loss = layers.softmax_with_cross_entropy(logits, trg_next)
        tok_loss.seq_len = trg_next.seq_len
        loss = layers.mean(layers.sequence_pool(tok_loss, "average"))
        pt.optimizer.AdamOptimizer(learning_rate=c["lr"]).minimize(
            loss, startup_program=startup)
    startup.random_seed = 5
    return main, startup, loss, [src, trg_in, trg_next]


def book_demos_part(pt, smi):
    """(d): demos/sequence_tagging_crf.py's and demos/nmt_seq2seq.py's
    programs rebuilt against the port, run on the card at their own sizes.
    Returns their record."""
    import numpy as np

    c = SEQ_TAG
    main, startup, loss, decoded = _seq_tag_program(pt, c)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    hist, ms = [], []
    for _ in range(c["steps"]):
        feed = _seq_tag_batch(rng, c["batch"], c)
        t0 = time.perf_counter()
        lo, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        hist.append(float(lo))
    feed = _seq_tag_batch(rng, 16, c)
    dec, = exe.run(main, feed=feed, fetch_list=[decoded], scope=scope)
    dec = np.asarray(dec).reshape(16, c["T"])
    lens = feed["tags@len"]
    mask = np.arange(c["T"])[None, :] < lens[:, None]
    acc = float((dec == feed["tags"][..., 0])[mask].mean())
    tag = {"config": c, "loss_first": hist[0], "loss_final": hist[-1],
           "viterbi_accuracy": acc, "ms_per_step": float(np.median(ms))}
    print(f"book (d) sequence_tagging_crf: {c['steps']} steps at batch "
          f"{c['batch']} on the card, -log-likelihood {hist[0]:.4f} -> "
          f"{hist[-1]:.4f}; viterbi tag accuracy {acc:.3f}; step "
          f"{tag['ms_per_step']:.3f} ms (median wall) [{smi}]")
    assert np.isfinite(hist).all() and hist[-1] < hist[0], hist[:3]

    c = NMT
    main, startup, loss, feeds = _nmt_programs(pt, c)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feeder = pt.data_feeder.DataFeeder(feeds)
    rows = pt.reader.decorator.firstn(pt.dataset.wmt14.train(c["dict"]),
                                      c["batch"] * c["batches"])
    hist, ms = [], []
    for _ in range(c["epochs"]):
        for rws in pt.reader.minibatch.batch(rows, c["batch"])():
            t0 = time.perf_counter()
            lo, = exe.run(main, feed=feeder.feed(rws), fetch_list=[loss],
                          scope=scope)
            ms.append((time.perf_counter() - t0) * 1e3)
            hist.append(float(lo))
    infer, (ids, scores, lens) = _nmt_programs(pt, c, infer=True)
    sample = next(iter(pt.reader.minibatch.batch(rows, 4)()))
    feed = feeder.feed(sample)
    out_ids, out_scores, out_lens = exe.run(
        infer, feed={"src": feed["src"], "src@len": feed["src@len"]},
        fetch_list=[ids, scores, lens], scope=scope)
    nmt = {"config": c, "loss_first": hist[0], "loss_final": hist[-1],
           "steps": len(hist), "ms_per_step": float(np.median(ms)),
           "beam0": [out_ids[i, 0, :int(out_lens[i, 0])].tolist()
                     for i in range(len(sample))],
           "beam0_score": [float(s) for s in out_scores[:, 0]]}
    print(f"book (d) nmt_seq2seq: {len(hist)} steps ({c['epochs']} epochs "
          f"of {c['batches']} batches of {c['batch']}) on the card, loss "
          f"{hist[0]:.3f} -> {hist[-1]:.3f}; step {nmt['ms_per_step']:.3f} "
          f"ms (median wall); beam {c['beam']} ids {list(out_ids.shape)}, "
          f"beam 0 of the first source {nmt['beam0'][0]} score "
          f"{nmt['beam0_score'][0]:.2f} [{smi}]")
    assert np.isfinite(hist).all() and hist[-1] < 0.8 * hist[0], hist[:3]
    assert out_ids.shape == (4, c["beam"], c["max_len"])
    assert np.all(np.diff(out_scores, axis=1) <= 1e-5)
    return {"sequence_tagging_crf": tag, "nmt_seq2seq": nmt}


def book_phase(smi):
    """Phase 18: (a) the book chapters, (b) db_lstm at the book's widths,
    (c) the slice's ops at full size against the CPU, (d) the two demos.
    Returns its record."""
    import paddle_tpu_torch as pt

    seconds = [time.perf_counter()]
    counts = _all_kernel_counts()
    chapters = book_chapters_part(pt, smi)
    seconds.append(time.perf_counter())
    db = db_lstm_part(pt, smi)
    seconds.append(time.perf_counter())
    ops = book_ops_part(smi)
    seconds.append(time.perf_counter())
    demos = book_demos_part(pt, smi)
    seconds.append(time.perf_counter())
    assert _all_kernel_counts() == counts, "phase 18 launched a kernel"
    out = {"chapters": chapters, "db_lstm": db, "ops": ops, "demos": demos,
           "seconds": [b - a for a, b in zip(seconds, seconds[1:])]}
    print("phase 18 seconds: " + ", ".join(
        f"{part} {s:.1f}" for part, s in zip(("(a)", "(b)", "(c)", "(d)"),
                                             out["seconds"]))
        + f"; {sum(out['seconds']):.1f} in all [{smi}]")
    return out


# --- phase 19: the optimizer plane and the chunked fused head ---------------
# (a) demos/gpt_modern.py at its own full size through its own program and
# loop (the demo imports the JAX package, so its program and corpus are
# restated here with the port): the per-layer LM with GQA (4 heads over 2
# K/V heads, head dim 16, padded to the flash kernels' 64), RoPE and
# RMSNorm, headless into the smoothed chunked head (chunk 128 over vocab
# 211), AdamW under warmup + cosine, 150 steps of 32 x 64 tokens, and the
# eval clone's next-token accuracy gate (> 0.4) as the demo asserts it.
# The learning rate a step, read back with the scope's counter, is held
# to the closed form within GPT_LR_ULPS f32 ulps of the schedule's peak
# (CUDA's cos is not the CPU's); the first GPT_CPU_STEPS losses to the
# port's CPU run from the same weights within GPT_LOSS_RTOL (the card's
# and the CPU's sums run in other orders; over 150 steps they drift).
GPT_MODERN = dict(vocab=211, T=64, d_model=64, n_layers=2, heads=4,
                  kv_heads=2, batch=32, steps=150, chunk=128,
                  smoothing=0.05, lr=3e-3, start_lr=3e-4, warmup=10,
                  decay_steps=150, weight_decay=0.01, eval_rows=16)
GPT_CPU_STEPS = 5
GPT_LOSS_RTOL = 1e-4
GPT_LR_ULPS = 4
GPT_ACC_FLOOR = 0.4
# (b) bench.py's bench_transformer_step(fused_head=True) at the row's own
# size (d1024 L8 H8, head dim 128, V16384, 8 x 2048 tokens, Adam 1e-4,
# f32, the per-layer path), beside the same row unfused (fc head +
# softmax_with_cross_entropy), from the same weights: without smoothing
# the two compute one function, so step 1's loss and every gradient are
# held at LOSS_RTOL / GRAD_RTOL (phase 6's). The head's default chunk
# 8192 gives two chunks.
HEAD_ROWS = dict(TRAIN, timed=3)
# (c) the rest of the plane at small sizes, one card run against the
# port's CPU run from the same state: every lr_schedule policy and
# lr_warmup over steps 0-299 (within GPT_LR_ULPS ulps of each
# schedule's peak), each clip attr and L1/L2 decay (global and a
# parameter's own) through one SGD step of an MLP, accumulate_steps=4
# under a schedule (the counter and the learning rate each run),
# ModelAverage.apply after six steps, and a pruned weight that stays
# pruned. Floats within SWEEP_TOL of each tensor's largest |value|.
SWEEP_MLP = dict(batch=64, dim=32, hidden=64, classes=8)
SWEEP_TOL = 1e-5
SWEEP_STEPS = 300
CARD = "cuda"
SWEEP_SCHEDULES = (
    ("exponential", {"learning_rate": 0.1, "decay_steps": 7,
                     "decay_rate": 0.9}),
    ("exponential", {"learning_rate": 0.1, "decay_steps": 7,
                     "decay_rate": 0.5, "staircase": True}),
    ("natural_exp", {"learning_rate": 0.3, "decay_steps": 9,
                     "decay_rate": 0.7}),
    ("inverse_time", {"learning_rate": 0.2, "decay_steps": 3,
                      "decay_rate": 0.37, "staircase": True}),
    ("polynomial", {"learning_rate": 0.1, "decay_steps": 37,
                    "end_learning_rate": 1e-3, "power": 1.7}),
    ("polynomial", {"learning_rate": 0.1, "decay_steps": 13,
                    "end_learning_rate": 1e-3, "power": 0.5,
                    "cycle": True}),
    ("piecewise", {"boundaries": [5.0, 17.0, 40.0],
                   "values": [0.1, 0.03, 0.007, 0.001]}),
    ("noam", {"d_model": 512.0, "warmup_steps": 11}),
    ("cosine", {"learning_rate": 3e-3, "decay_steps": 150, "alpha": 0.0}),
    ("cosine", {"learning_rate": 0.7, "decay_steps": 33, "alpha": 0.13}),
)


def _gpt_corpus(rng, vocab, n, T, mult=5):
    """demos/gpt_modern.py's learnable language: token t+1 = (5*t +
    noise) % vocab (``mult`` 3: demos/transformer_lm.py's)."""
    import numpy as np

    x = np.zeros((n, T + 1), np.int64)
    x[:, 0] = rng.randint(0, vocab, size=n)
    for t in range(T):
        noise = rng.randint(0, 2, size=n)
        x[:, t + 1] = (mult * x[:, t] + noise) % vocab
    return x


def _gpt_program(pt, c):
    """demos/gpt_modern.py's program: (main, startup, eval clone, loss,
    hidden states, learning rate)."""
    from paddle_tpu_torch import layers, models

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = layers.data("ids", shape=[c["T"]], dtype="int64")
        tgt = layers.data("tgt", shape=[c["T"], 1], dtype="int64")
        h = models.transformer_lm(
            ids, vocab_size=c["vocab"], d_model=c["d_model"],
            n_layers=c["n_layers"], num_heads=c["heads"],
            num_kv_heads=c["kv_heads"], use_rope=True,
            norm_type="rms_norm", max_len=2 * c["T"], include_head=False)
        loss = layers.mean(layers.fused_head_cross_entropy(
            h, tgt, num_classes=c["vocab"], chunk=c["chunk"],
            label_smoothing=c["smoothing"],
            param_attr=pt.ParamAttr(name="head.w")))
        eval_prog = main.clone(for_test=True)
        decay = pt.learning_rate_decay
        lr = decay.linear_lr_warmup(
            decay.cosine_decay(c["lr"], decay_steps=c["decay_steps"]),
            warmup_steps=c["warmup"], start_lr=c["start_lr"],
            end_lr=c["lr"])
        pt.optimizer.AdamWOptimizer(
            learning_rate=lr, weight_decay=c["weight_decay"]).minimize(
            loss, startup_program=startup)
    return main, startup, eval_prog, loss, h, lr


def _gpt_lr(c, step):
    """The warmup + cosine schedule's closed form at ``step``, in f64."""
    import math

    if step < c["warmup"]:
        return c["start_lr"] + (c["lr"] - c["start_lr"]) * step / c["warmup"]
    frac = min(step, c["decay_steps"]) / c["decay_steps"]
    return c["lr"] * 0.5 * (1 + math.cos(math.pi * frac))


def _f32_ulp(x):
    import numpy as np

    return float(np.spacing(np.float32(abs(x))))


def gpt_modern_part(pt, fa, smi):
    """(a): the demo's loop on the card. Returns its record."""
    import numpy as np
    import torch

    c = GPT_MODERN
    L = c["n_layers"]
    main, startup, eval_prog, loss, h, lr = _gpt_program(pt, c)
    counter = main._lr_step_counter.name
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    init = {n: scope.get_numpy(n) for n in scope.keys()
            if n != "@RNG_STATE@"}
    rng = np.random.RandomState(0)
    feeds, losses, lrs, lr_gaps, step_ms = [], [], [], [], []
    peak_lr = max(_gpt_lr(c, s) for s in range(1, c["steps"] + 1))
    torch.cuda.synchronize()
    _reset_flash_counts(fa)
    t_loop = time.perf_counter()
    for step in range(c["steps"]):
        seq = _gpt_corpus(rng, c["vocab"], n=c["batch"], T=c["T"])
        feed = {"ids": seq[:, :-1], "tgt": seq[:, 1:, None]}
        if step < GPT_CPU_STEPS:
            feeds.append(feed)
        t0 = time.perf_counter()
        lo, lv = exe.run(main, feed=feed, fetch_list=[loss, lr],
                         scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(lo)))
        count = scope.get(counter)
        assert count.dtype == torch.int32 and count.device.type == CARD, \
            (count.dtype, count.device)
        at = int(count.item())
        assert at == step + 1, (at, step)
        lrs.append(float(np.asarray(lv).reshape(())))
        lr_gaps.append(abs(lrs[-1] - _gpt_lr(c, at)) / _f32_ulp(peak_lr))
    loop_s = time.perf_counter() - t_loop
    counts = _flash_counts(fa)
    # the eval clone up to the hidden states, projected on the host
    # against the trained head weight, as the demo does
    seq = _gpt_corpus(rng, c["vocab"], n=c["eval_rows"], T=c["T"])
    hv, = exe.run(eval_prog, feed={"ids": seq[:, :-1],
                                   "tgt": seq[:, 1:, None]},
                  fetch_list=[h.name], scope=scope)
    pred = (np.asarray(hv, np.float32)
            @ scope.get_numpy("head.w").astype(np.float32)).argmax(-1)
    acc = float((pred[:, :-1] == seq[:, 1:-1]).mean())
    # the first steps on the CPU from the same weights
    cscope = pt.scope_from_numpy(init, "cpu")
    cexe = pt.Executor(pt.CPUPlace())
    cpu = [float(np.asarray(cexe.run(main, feed=f, fetch_list=[loss],
                                     scope=cscope)[0])) for f in feeds]
    loss_rel = float(np.max(np.abs(np.array(losses[:GPT_CPU_STEPS])
                                   - cpu) / np.abs(cpu)))
    state = _snapshot(scope)
    anatomy = _one_step_anatomy(lambda: exe.run(
        main, feed=feeds[0], fetch_list=[loss], scope=scope))
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    traced = _count_kernels(lambda: exe.run(main, feed=feeds[0],
                                            fetch_list=[loss], scope=scope),
                            names, expect={n: L for n in names})
    _restore(scope, state)
    rec = {"config": c, "losses_first": losses[:GPT_CPU_STEPS],
           "loss_final": losses[-1], "cpu_losses_first": cpu,
           "loss_rel_vs_cpu": loss_rel, "accuracy": acc,
           "lr_first": lrs[:12], "lr_final": lrs[-1],
           "lr_worst_ulps_of_peak": float(max(lr_gaps)),
           "ms_per_step": float(np.median(step_ms)), "loop_s": loop_s,
           "flash_launches": list(counts[:3]),
           "flash_launches_traced": (None if traced is None
                                     else [traced[n] for n in names]),
           "anatomy": anatomy}
    print(f"optim (a) gpt_modern: {c['steps']} steps of {c['batch']} x "
          f"{c['T']} tokens on the card (d{c['d_model']} L{L} "
          f"H{c['heads']}/{c['kv_heads']} K/V, vocab {c['vocab']}, chunk "
          f"{c['chunk']}): loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"next-token accuracy {acc:.3f} (gate > {GPT_ACC_FLOOR}); first "
          f"{GPT_CPU_STEPS} losses within {loss_rel:.2e} of the CPU's "
          f"(tol {GPT_LOSS_RTOL}); learning rate from the int32 counter "
          f"within {max(lr_gaps):.2f} ulps of the peak of the closed form "
          f"(tol {GPT_LR_ULPS}); {rec['ms_per_step']:.2f} ms a step "
          f"(median wall with the fetches), loop {loop_s:.1f} s; one step "
          f"{anatomy['wall_ms']:.2f} ms wall, device "
          f"{_ms_text(anatomy['device_ms'])} ms in {anatomy['launches']} "
          f"launches; flash fwd/dq/dkv launches {list(counts[:3])} in "
          f"{c['steps']} steps, {rec['flash_launches_traced']} in a traced "
          f"step [{smi}]")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert acc > GPT_ACC_FLOOR, acc
    assert loss_rel <= GPT_LOSS_RTOL, (losses[:GPT_CPU_STEPS], cpu)
    assert max(lr_gaps) <= GPT_LR_ULPS, max(lr_gaps)
    assert counts == (c["steps"] * L,) * 3 + (0, 0, 0), counts
    assert traced is not None and all(traced[n] == L for n in names), traced
    return rec


def _head_row_program(pt, c, start, fused):
    """bench.py's bench_transformer_step at ``c``, its head fused or
    not, built from the name counter ``start``: (main, startup, loss,
    params_grads)."""
    from paddle_tpu_torch import layers, models

    pt.Program._uid_counter = start
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    T, V = c["seq"], c["vocab"]
    kw = dict(vocab_size=V, d_model=c["d_model"], n_layers=c["n_layers"],
              num_heads=c["num_heads"], d_ff=c["d_ff"], max_len=T)
    with pt.program_guard(main, startup):
        ids = layers.data("ids", shape=[T], dtype="int64")
        tgt = layers.data("tgt", shape=[T], dtype="int64")
        if fused:
            h = models.transformer_lm(ids, include_head=False, **kw)
            loss = layers.mean(layers.fused_head_cross_entropy(
                h, layers.reshape(tgt, shape=[-1, T, 1]), num_classes=V))
        else:
            logits = models.transformer_lm(ids, **kw)
            loss = layers.mean(layers.softmax_with_cross_entropy(
                layers.reshape(logits, shape=[-1, V]),
                layers.reshape(tgt, shape=[-1, 1])))
        pgs = pt.optimizer.AdamOptimizer(learning_rate=c["lr"]).minimize(
            loss, startup_program=startup)
    return main, startup, loss, pgs


def _head_row(pt, fa, c, built, feed, tag):
    """One row: its startup on the card, step 1's loss and gradients
    (host copies), then ``c['timed']`` steps' wall ms and peak memory,
    the device ms a step and the flash launches (counters over the timed
    steps, and a traced step)."""
    import numpy as np
    import torch

    main, startup, loss, pgs = built
    L = c["n_layers"]
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    head = scope.get_numpy(pgs[-1][0].name)
    state = _snapshot(scope)
    fetch = [loss.name] + [g.name for _, g in pgs]
    got = _step_fetches(exe, main, feed, fetch, scope, state)
    first = ([float(got[0])], [g.cpu() for g in got[1:]])
    del got

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)

    step()[0].item()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts(fa)
    ms = []
    for _ in range(c["timed"]):
        t0 = time.perf_counter()
        step()[0].item()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    counts = _flash_counts(fa)
    dev_ms = _device_ms(step, iters=2)
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    traced = _count_kernels(step, names, expect={n: L for n in names})
    rec = {"ms_per_step": float(np.median(ms)), "step_ms": ms,
           "device_ms_per_step": dev_ms, "peak_bytes": peak,
           "flash_launches": [n // c["timed"] for n in counts[:3]],
           "flash_launches_traced": (None if traced is None
                                     else [traced[n] for n in names]),
           "step1_loss": first[0][0]}
    print(f"optim (b) {tag}: {rec['ms_per_step']:.1f} ms a step (median of "
          f"{c['timed']}), device {_ms_text(dev_ms, '.1f')} ms; peak "
          f"{peak / 2**30:.3f} GiB; flash fwd/dq/dkv launches a step "
          f"{rec['flash_launches']} by the counters, "
          f"{rec['flash_launches_traced']} traced")
    assert counts == (c["timed"] * L,) * 3 + (0, 0, 0), counts
    assert traced is not None and all(traced[n] == L for n in names), traced
    del scope, state, exe
    torch.cuda.empty_cache()
    return rec, first, head


def head_rows_part(pt, fa, smi):
    """(b): the fused-head row beside the unfused one. Returns its
    record."""
    import numpy as np
    import torch

    c = HEAD_ROWS
    start = pt.Program._uid_counter
    unfused = _head_row_program(pt, c, start, fused=False)
    fused = _head_row_program(pt, c, start, fused=True)
    rng = np.random.RandomState(SEED)
    feed = {k: torch.from_numpy(rng.randint(0, c["vocab"], size=(
        c["batch"], c["seq"])).astype("int64")).to(CARD)
        for k in ("ids", "tgt")}
    torch.cuda.empty_cache()
    rows, firsts, heads = {}, {}, {}
    for tag, built in (("unfused", unfused), ("fused", fused)):
        rows[tag], firsts[tag], heads[tag] = _head_row(pt, fa, c, built,
                                                       feed, tag)
    # the same weights (the head is the last draw of both startups), the
    # same step 1
    assert np.array_equal(heads["fused"], heads["unfused"])
    lu, lf = firsts["unfused"][0][0], firsts["fused"][0][0]
    pnames = [p.name for p, _ in fused[3]]
    assert [tuple(g.shape) for g in firsts["fused"][1]] == \
        [tuple(g.shape) for g in firsts["unfused"][1]]
    worst = _grad_gap(pnames, firsts["fused"][1], firsts["unfused"][1])
    loss_gap = abs(lf - lu) / abs(lu)
    flops = transformer_train_flops(c["batch"], c["seq"], c["d_model"],
                                    c["n_layers"], c["vocab"], c["d_ff"])
    head_flops = 2 * c["batch"] * c["seq"] * c["d_model"] * c["vocab"]
    rec = {"config": {k: v for k, v in c.items()}, "unfused": rows["unfused"],
           "fused": rows["fused"], "loss_unfused": lu, "loss_fused": lf,
           "loss_gap": loss_gap, "worst_grad_gap": worst[0],
           "worst_grad": worst[1], "tflop_per_step_unfused": flops / 1e12,
           "tflop_per_step_fused": (flops + head_flops) / 1e12,
           "peak_saved_bytes": rows["unfused"]["peak_bytes"]
           - rows["fused"]["peak_bytes"]}
    print(f"optim (b) step 1 from the same weights: loss fused {lf:.6f} "
          f"unfused {lu:.6f} (gap {loss_gap:.2e}, tol {LOSS_RTOL}); worst "
          f"gradient gap {worst[0]:.3e} of a norm ({worst[1]}; tol "
          f"{GRAD_RTOL}) over {len(pnames)} parameters; the fused head "
          f"holds {rec['peak_saved_bytes'] / 2**30:.3f} GiB less at its "
          f"peak and takes {rows['fused']['ms_per_step'] - rows['unfused']['ms_per_step']:+.1f} ms "
          f"a step for {head_flops / 1e12:.3f} TFLOP more [{smi}]")
    assert np.isfinite(lf) and loss_gap <= LOSS_RTOL, (lf, lu)
    assert worst[0] <= GRAD_RTOL, worst
    return rec


def _sweep_mlp(pt, c, clip=None, reg=None, own_reg=None, hook=False,
               lr=None, accumulate=1, average=False):
    """An MLP (dim -> hidden tanh -> classes, softmax CE) under SGD with
    what the sweep case asks for: (main, startup, loss, lr var, model
    average)."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        x = L.data("x", shape=[c["dim"]])
        y = L.data("y", shape=[1], dtype="int64")
        attr = pt.ParamAttr(
            name="sw1", regularizer=own_reg(pt) if own_reg else None,
            update_hooks=pt.param_attr.Hook("pruning", 0.5) if hook
            else None)
        hid = L.fc(x, size=c["hidden"], act="tanh", param_attr=attr)
        logits = L.fc(hid, size=c["classes"],
                      param_attr=pt.ParamAttr(name="sw2"))
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        if clip is not None:
            pt.clip.set_gradient_clip(clip(pt), param_list=["sw1", "sw2"])
        rate = lr(pt.learning_rate_decay) if lr else 0.1
        pt.optimizer.SGDOptimizer(rate, regularization=reg(pt) if reg
                                  else None).minimize(
            loss, accumulate_steps=accumulate)
        ma = (pt.optimizer.ModelAverage(min_average_window=2,
                                        max_average_window=3)
              if average else None)
    return main, startup, loss, (rate if lr else None), ma


def _rel_max(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _sweep_case(pt, c, steps, **kw):
    """One MLP case on the card and on the CPU from the same state:
    (card scope, CPU scope, worst float gap, the lr values a run on the
    card and the CPU, model averages)."""
    import numpy as np

    main, startup, loss, lr, ma = _sweep_mlp(pt, c, **kw)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    cscope = pt.scope_from_numpy({n: scope.get_numpy(n) for n in scope.keys()
                                  if n != "@RNG_STATE@"}, "cpu")
    cexe = pt.Executor(pt.CPUPlace())
    rng = np.random.RandomState(SEED + 19)
    lrs = ([], [])
    fetch = [loss] + ([lr] if lr is not None else [])
    for _ in range(steps):
        feed = {"x": rng.randn(c["batch"], c["dim"]).astype(np.float32),
                "y": rng.randint(0, c["classes"], (c["batch"], 1))
                .astype(np.int64)}
        for i, (e, s) in enumerate(((exe, scope), (cexe, cscope))):
            out = e.run(main, feed=feed, fetch_list=fetch, scope=s)
            if lr is not None:
                lrs[i].append(float(np.asarray(out[1]).reshape(())))
    gap = max(_rel_max(scope.get_numpy(n), cscope.get_numpy(n))
              for n in cscope.keys() if scope.get(n).is_floating_point())
    return scope, cscope, gap, lrs, ma


def sweep_part(pt, smi):
    """(c): the rest of the plane on the card against the CPU. Returns
    its record."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.registry import get_op

    c = SWEEP_MLP
    out = {"schedules": [], "cases": {}}
    steps = torch.arange(SWEEP_STEPS, dtype=torch.int32)
    for policy, attrs in SWEEP_SCHEDULES:
        attrs = dict(attrs, policy=policy)
        op = get_op("lr_schedule").fn
        card = torch.stack([op(attrs, {"GlobalStep": [s.reshape(1)]})["Out"][0]
                            for s in steps.to(CARD)]).cpu().reshape(-1)
        cpu = torch.stack([op(attrs, {"GlobalStep": [s.reshape(1)]})["Out"][0]
                           for s in steps]).reshape(-1)
        peak = float(cpu.abs().max())
        ulps = float((card - cpu).abs().max()) / _f32_ulp(peak)
        out["schedules"].append({"policy": policy, "attrs": attrs,
                                 "ulps_of_peak": ulps,
                                 "bitwise": bool(torch.equal(card, cpu))})
        assert torch.isfinite(card).all() and ulps <= GPT_LR_ULPS, (
            policy, attrs, ulps)
    warm = {"warmup_steps": 17, "start_lr": 1e-4, "end_lr": 0.05}
    base = torch.full((1,), 0.03)
    wcard = torch.stack([get_op("lr_warmup").fn(warm, {
        "LearningRate": [base.to(CARD)], "GlobalStep": [s.reshape(1)]})[
        "Out"][0] for s in steps[:40].to(CARD)]).cpu()
    wcpu = torch.stack([get_op("lr_warmup").fn(warm, {
        "LearningRate": [base], "GlobalStep": [s.reshape(1)]})["Out"][0]
        for s in steps[:40]])
    assert torch.equal(wcard, wcpu)
    cases = {
        "clip_value": dict(clip=lambda p: p.clip.GradientClipByValue(0.02)),
        "clip_norm": dict(clip=lambda p: p.clip.GradientClipByNorm(0.05)),
        "clip_global_norm": dict(
            clip=lambda p: p.clip.GradientClipByGlobalNorm(0.05)),
        "l2": dict(reg=lambda p: p.regularizer.L2Decay(0.1)),
        "l1": dict(reg=lambda p: p.regularizer.L1Decay(0.05)),
        "own_l1_over_global_l2": dict(
            reg=lambda p: p.regularizer.L2Decay(0.1),
            own_reg=lambda p: p.regularizer.L1Decay(0.05)),
    }
    for name, kw in cases.items():
        _, _, gap, _, _ = _sweep_case(pt, c, 1, **kw)
        out["cases"][name] = {"gap": gap}
        assert gap <= SWEEP_TOL, (name, gap)
    # accumulate_steps=4 under a schedule: the learning rate each run
    sched = lambda d: d.exponential_decay(0.1, 1, 0.5,  # noqa: E731
                                          staircase=True)
    scope, cscope, gap, lrs, _ = _sweep_case(pt, c, 8, lr=sched,
                                             accumulate=4)
    counter = [n for n in scope.keys() if "lr_global_step" in n][0]
    want = [float(np.float32(0.05))] * 4 + [float(np.float32(0.025))] * 4
    assert lrs[0] == lrs[1] == want, lrs
    assert scope.get(counter).dtype == torch.int32
    assert int(scope.get(counter).item()) == 2 == int(cscope.get(counter))
    assert gap <= SWEEP_TOL, gap
    out["cases"]["accumulate_4_schedule"] = {"gap": gap, "lr": lrs[0]}
    # ModelAverage.apply after six steps (window 3)
    scope, cscope, gap, _, ma = _sweep_case(pt, c, 6, average=True)
    live = {n: scope.get(n) for n in ("sw1", "sw2")}
    with ma.apply(scope), ma.apply(cscope):
        avg_gap = max(_rel_max(scope.get_numpy(n), cscope.get_numpy(n))
                      for n in live)
        moved = all(not torch.equal(scope.get(n), live[n]) for n in live)
        on_card = all(scope.get(n).device.type == CARD for n in live)
    assert all(scope.get(n) is live[n] for n in live)
    assert moved and on_card and gap <= SWEEP_TOL and avg_gap <= SWEEP_TOL, \
        (moved, on_card, gap, avg_gap)
    out["cases"]["model_average"] = {"gap": gap, "average_gap": avg_gap}
    # the pruning hook: pruned weights stay 0 through three updates
    scope, cscope, gap, _, _ = _sweep_case(pt, c, 3, hook=True)
    mask = scope.get("sw1@PRUNE_MASK")
    w = scope.get("sw1")
    assert torch.equal(mask.cpu(), cscope.get("sw1@PRUNE_MASK"))
    assert int(mask.sum()) == mask.numel() // 2
    assert not w[mask == 0].any() and gap <= SWEEP_TOL, gap
    out["cases"]["pruning"] = {"gap": gap, "kept": int(mask.sum()),
                               "of": mask.numel()}
    worst = max(s["ulps_of_peak"] for s in out["schedules"])
    bitwise = sum(s["bitwise"] for s in out["schedules"])
    print(f"optim (c) sweep on the card against the CPU: {len(SWEEP_SCHEDULES)} "
          f"schedules over steps 0-{SWEEP_STEPS - 1} within {worst:.2f} ulps "
          f"of their peaks ({bitwise} bit for bit), lr_warmup bit for bit; "
          + "; ".join(f"{k} {v['gap']:.2e}" for k, v in out["cases"].items())
          + f" of the largest |value| (tol {SWEEP_TOL}); the accumulated "
          f"schedule's rates {lrs[0][:1]}x4 then {lrs[0][4:5]}x4 equal the "
          f"CPU's; averaged weights within {avg_gap:.2e}; "
          f"{out['cases']['pruning']['kept']} of "
          f"{out['cases']['pruning']['of']} weights kept after 3 updates "
          f"[{smi}]")
    return out


def optim_phase(smi):
    """Phase 19: (a) gpt_modern, (b) the fused-head row beside the
    unfused one, (c) the sweep. Returns its record."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import flash_attention as fa

    seconds = [time.perf_counter()]
    out = {"a": gpt_modern_part(pt, fa, smi)}
    seconds.append(time.perf_counter())
    torch.cuda.empty_cache()
    out["b"] = head_rows_part(pt, fa, smi)
    seconds.append(time.perf_counter())
    out["c"] = sweep_part(pt, smi)
    seconds.append(time.perf_counter())
    out["seconds"] = [b - a for a, b in zip(seconds, seconds[1:])]
    print("phase 19 seconds: " + ", ".join(
        f"{part} {s:.1f}" for part, s in zip(("(a)", "(b)", "(c)"),
                                             out["seconds"]))
        + f"; {sum(out['seconds']):.1f} in all [{smi}]")
    return out


def phase19_launches(records, optim):
    """Each flash record's launches a step on phase 19's paths."""
    paths = {"gpt_modern": [n // GPT_MODERN["steps"]
                            for n in optim["a"]["flash_launches"]],
             "d1024 fused head": optim["b"]["fused"]["flash_launches"],
             "d1024 unfused head": optim["b"]["unfused"]["flash_launches"]}
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    for rec in records:
        if rec["name"] in names:
            i = names.index(rec["name"])
            rec["launches_phase19"] = {k: v[i] for k, v in paths.items()}


# --- phase 20: the precision policy, the flags and the v2 facade ------------
# (a) mul, matmul and conv2d (3x3, and the 1x1 dot path) at ResNet-50
# shapes, forward and both gradients, on the card under default and
# highest against the same op on the CPU in f64. highest: phase 7's gate,
# max |card - f64| <= TF32_RTOL of max |f64|. default: TF32 rounds each f32
# operand to nearest at 10 mantissa bits (unit roundoff 2^-11), so each
# term a_k b_k of a sum carries at most 2^-10 + 2^-22 of |a_k b_k|, and
# elementwise |default - f64| <= PRECISION_TF32_TERM * (|A| |B|) (the same
# op on |A| and |B|, and for a gradient on |g|, in f64) plus
# PRECISION_ORDER_MULT times highest's own largest error (the f32 sums,
# whose order a TF32 kernel need not share). TF32 engaged: default must
# differ from highest by more than PRECISION_ENGAGED times highest's own
# largest error.
PRECISION_TF32_TERM = 2.0 ** -10 + 2.0 ** -22
PRECISION_ORDER_MULT = 4.0
PRECISION_ENGAGED = 10.0
# (op, attrs, {slot: shape}): the fc head at batch 256, a stage-3 1x1 conv
# at batch 16 as a batched matmul, phase 7's 3x3 conv (s2 p1, 64 -> 64
# over stage 1's 56 x 56, batch 8) and stage 1's 256 -> 64 1x1 conv (the
# dot path) at batch 2. TF32_RTOL holds an f32 sum of up to ~6300 terms (phase 7's
# dW: 8 x 28 x 28); the filter gradients here sum 6272 (a 12544-term
# sum erred 1.69e-5 of max |f64| under highest on an H100).
PRECISION_CASES = (
    ("mul", {"x_num_col_dims": 1, "y_num_col_dims": 1},
     {"X": (256, 2048), "Y": (2048, 1000)}),
    ("matmul", {}, {"X": (16, 196, 1024), "Y": (1024, 256)}),
    ("conv2d", {"strides": 2, "paddings": 1, "data_format": "NHWC"},
     {"Input": (8, 56, 56, 64), "Filter": (3, 3, 64, 64)}),
    ("conv2d", {"strides": 1, "paddings": 0, "data_format": "NHWC"},
     {"Input": (2, 56, 56, 256), "Filter": (1, 1, 256, 64)}),
)
# (b) the 1xTF32 conv GEMM instances against their TF32 plain versions
# (operands rounded as the kernels round them, an f32 product): the same
# products, summed in another order: GEMM_TOL and STATS_TOL, as phase 8.
# The bound is at the tensor cores' dense TF32 rate.
TF32_PEAK = {"sxm": 494.7e12, "pcie": 378e12, "nvl": 417.5e12}
# (c) phase 19's unfused row (d1024 L8 H8, V16384, 8 x 2048 tokens, Adam,
# f32) under default and highest from the same weights: step 1's loss
# within PRECISION_LM_LOSS_RTOL and each gradient within
# PRECISION_LM_GRAD_RTOL of its norm. The bound behind them: a TF32
# product's output moves by ~2^-11 sqrt(2) = 7e-4 of its norm (both
# operands rounded, the errors independent); a gradient passes ~64
# products of the 8 blocks forward and back, which adds up to
# sqrt(64) x 7e-4 = 5.5e-3 if the errors are independent and 4.5e-2 if
# they line up; allow 2e-2 of each gradient's norm and 1e-3 of the loss
# (an average over 16384 tokens).
PRECISION_LM_LOSS_RTOL = 1e-3
PRECISION_LM_GRAD_RTOL = 2e-2
# (d) ResNet-50 at batch 256 under default and highest from the same
# weights. The yardstick for its ill-conditioned gradients (ReLUs and BN,
# ROADMAP "Ill-conditioned gradients") is highest's own move when each
# image value moves by half a TF32 ulp (x (1 +- 2^-11), the sign drawn
# per value): the size of the rounding TF32 applies to every operand.
# Each gradient within SENS_FACTOR times that move (or GRAD_RTOL of its
# norm), all together within SENS_TOTAL times, the loss within
# SENS_FACTOR times the loss's move or 2^-10 of it.
PRECISION_NUDGE = 2.0 ** -11
PRECISION_TIMED = 3
PRECISION_LM_GROUPS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "nvjet",
                       "gemm", "cutlass", "elementwise", "reduce")
PRECISION_RESNET_GROUPS = ("conv1x1_tf32_kernel", "conv1x1_tf32x3_kernel",
                           "round_w_kernel", "split_w_kernel",
                           "stats_reduce_kernel", "scale_shift_act_kernel",
                           "cudnn", "engine", "xmma", "nvjet", "gemm",
                           "elementwise", "reduce")
# (f) the v2 demos, their loops copied from demos/*.py: their first
# V2_CPU_STEPS losses under highest within V2_LOSS_RTOL of the port's CPU
# run from the same weights. Passes are the demos' own but
# traffic_prediction's: 1 of its 8 (its 791-op step is host-bound at
# ~214 ms on an H100: 105 s for the 8 passes).
V2_DEMOS = {"mnist_v2": dict(passes=5, batch=64),
            "traffic_prediction": dict(passes=1, batch=128, n_train=8192),
            "quick_start_cnn": dict(passes=4, batch=64),
            "quick_start_lstm": dict(passes=4, batch=64)}
V2_CPU_STEPS = 5
V2_LOSS_RTOL = 1e-4


def _policy(p):
    from paddle_tpu_torch.ops import common

    common.set_mxu_precision(p)


def _abs_bound(op, attrs, ins, out_slot, g):
    """(|out|, |d in| for each input) bounds: the op on |inputs| in f64
    on the CPU, its vjp with |g|."""
    import torch

    from paddle_tpu_torch.core.registry import get_op

    leaves = {s: t.abs().double().requires_grad_() for s, t in ins.items()}
    y = get_op(op).fn(attrs, {s: [t] for s, t in leaves.items()})[
        out_slot][0]
    grads = torch.autograd.grad(y, list(leaves.values()), g.abs().double())
    return [y.detach()] + list(grads)


def _op_with_grads(op, attrs, ins, out_slot, g, device, dtype):
    """(out, d input for each input) of the registered op on ``device``
    in ``dtype``, by autograd, as host f64 tensors."""
    import torch

    from paddle_tpu_torch.core.registry import get_op

    leaves = {s: t.to(device, dtype).requires_grad_()
              for s, t in ins.items()}
    y = get_op(op).fn(attrs, {s: [t] for s, t in leaves.items()})[
        out_slot][0]
    grads = torch.autograd.grad(y, list(leaves.values()), g.to(device, dtype))
    return [t.detach().double().cpu() for t in [y] + list(grads)]


def policy_ops_part(smi):
    """(a): the library products under default and highest."""
    import torch

    from paddle_tpu_torch.core.registry import get_op

    print(f"precision (a) tolerances: highest max |card - f64| <= "
          f"{TF32_RTOL} of max |f64| (phase 7's); default elementwise "
          f"|card - f64| <= {PRECISION_TF32_TERM:.6e} x (|A||B|)_f64 + "
          f"{PRECISION_ORDER_MULT:g} x max |highest - f64|; TF32 engaged: "
          f"max |default - highest| > {PRECISION_ENGAGED:g} x max |highest "
          f"- f64|")
    gen = torch.Generator().manual_seed(SEED + 20)
    rows = []
    for op, attrs, shapes in PRECISION_CASES:
        out_slot = "Out" if op in ("mul", "matmul") else "Output"
        ins = {s: torch.randn(*shape, generator=gen, dtype=torch.float64)
               for s, shape in shapes.items()}
        w_slot = list(ins)[1]
        fan_in = ins[w_slot].shape[0] * (ins[w_slot].shape[1] * ins[
            w_slot].shape[2] if op == "conv2d" else 1)
        ins[w_slot] = ins[w_slot] / fan_in ** 0.5
        ins = {s: t.float().double() for s, t in ins.items()}  # f32 values
        with torch.no_grad():
            yshape = get_op(op).fn(attrs, {s: [t] for s, t in
                                           ins.items()})[out_slot][0].shape
        g = torch.randn(*yshape, generator=gen).double()
        want = _op_with_grads(op, attrs, ins, out_slot, g, "cpu",
                              torch.float64)
        bound = _abs_bound(op, attrs, ins, out_slot, g)
        got = {}
        for policy in ("highest", "default"):
            _policy(policy)
            got[policy] = _op_with_grads(op, attrs, ins, out_slot, g, "cuda",
                                         torch.float32)
        _policy("highest")
        for name, w, b, hi, de in zip(("out",) + tuple(
                f"d{s}" for s in ins), want, bound, got["highest"],
                got["default"]):
            scale = float(w.abs().max())
            e_hi = float((hi - w).abs().max())
            e_de = (de - w).abs()
            allow = PRECISION_TF32_TERM * b + PRECISION_ORDER_MULT * e_hi
            ratio = float((e_de / allow).max())
            gap = float((de - hi).abs().max())
            row = {"op": op, "shapes": {s: list(v) for s, v in
                                        shapes.items()},
                   "attrs": attrs, "what": name,
                   "highest_rel": e_hi / scale,
                   "default_rel": float(e_de.max()) / scale,
                   "default_to_allowance": ratio,
                   "default_vs_highest": gap / scale,
                   "engaged_ratio": gap / max(e_hi, 1e-30)}
            rows.append(row)
            print(f"precision (a) {op} {dict(shapes)} {name}: highest "
                  f"{row['highest_rel']:.3e} of max |f64| (tol {TF32_RTOL}); "
                  f"default {row['default_rel']:.3e} of it, worst "
                  f"{ratio:.3f} of its TF32 allowance; default vs highest "
                  f"{row['default_vs_highest']:.3e} = "
                  f"{row['engaged_ratio']:.1f} x highest's own error")
            assert row["highest_rel"] <= TF32_RTOL, row
            assert ratio <= 1.0, row
            assert gap > PRECISION_ENGAGED * e_hi, row
    return rows


def _tf32_bound(flops, nbytes, gpu_name):
    """(bound ms, what bounds it): FLOPs at the tensor cores' dense TF32
    rate, bytes at the memory rate."""
    low = gpu_name.lower()
    peak = TF32_PEAK["pcie" if "pcie" in low else "nvl" if "nvl" in low
                     else "sxm"]
    t_ops, t_bytes = flops / peak * 1e3, nbytes / _peaks(gpu_name)[1] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tf32_kernel_part(gpu_name, train_shapes, infer_shapes, smi):
    """(b): the 1xTF32 instances of conv1x1_stats and conv1x1_epilogue at
    every distinct shape of the ResNet-50 step and served batch."""
    import torch

    from paddle_tpu_torch.kernels import build, conv_epilogue as ke
    from paddle_tpu_torch.ops import common

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)

    def inputs(R, I, O, residual):
        x = torch.randn(R, I, device="cuda", generator=gen)
        w = torch.randn(I, O, device="cuda", generator=gen) * I ** -0.5
        scale = 1.0 + 0.2 * torch.randn(O, device="cuda", generator=gen)
        shift = 0.1 * torch.randn(O, device="cuda", generator=gen)
        res = (torch.randn(R, O, device="cuda", generator=gen)
               if residual else None)
        return x, w, scale, shift, res

    _policy("default")
    errs = {"conv1x1_stats": 0.0, "conv1x1_epilogue": 0.0}
    stats_err, repeats = 0.0, 0
    for R, I, O, res, act in sorted(set(train_shapes)):
        x, w, _, _, _ = inputs(R, I, O, False)
        y, stats = ke.conv1x1_stats(x, w)
        y2, stats2 = ke.conv1x1_stats(x, w)
        torch.cuda.synchronize()
        assert torch.equal(y, y2) and torch.equal(stats, stats2), (R, I, O)
        repeats += 1
        ry, rstats = ke.conv1x1_stats_tf32_reference(x, w)
        err = _assert_close(y, ry, GEMM_TOL, f"conv1x1_stats tf32 {R}x{I}x{O}")
        mass = torch.stack([ry.abs().sum(0), (ry * ry).sum(0)])
        s_err = float(((stats - rstats).abs() / mass.clamp_min(1e-30)).max())
        assert s_err <= STATS_TOL, (R, I, O, s_err)
        errs["conv1x1_stats"] = max(errs["conv1x1_stats"], err)
        stats_err = max(stats_err, s_err)
        del x, w, y, y2, ry
    for R, I, O, res, act in sorted(set(infer_shapes)):
        x, w, scale, shift, r = inputs(R, I, O, res)
        out = ke.conv1x1_epilogue(x, w, scale, shift, r, act)
        out2 = ke.conv1x1_epilogue(x, w, scale, shift, r, act)
        torch.cuda.synchronize()
        assert torch.equal(out, out2), (R, I, O)
        repeats += 1
        err = _assert_close(out, ke.conv1x1_epilogue_tf32_reference(
            x, w, scale, shift, r, act), GEMM_TOL,
            f"conv1x1_epilogue tf32 {R}x{I}x{O}")
        errs["conv1x1_epilogue"] = max(errs["conv1x1_epilogue"], err)
        del x, w, r, out, out2
    print(f"precision (b) the 1xTF32 instances against their TF32 plain "
          f"versions at {len(set(train_shapes))} step shapes and "
          f"{len(set(infer_shapes))} served shapes: max abs err stats y "
          f"{errs['conv1x1_stats']:.3e}, epilogue out "
          f"{errs['conv1x1_epilogue']:.3e} (tol {GEMM_TOL}), statistics "
          f"{stats_err:.3e} of the summed mass (tol {STATS_TOL}); two "
          f"launches bitwise equal in all {repeats} cases")
    smem = build.load("conv_epilogue").paddle_conv1x1_smem_bytes_tf32
    usage = _kernel_usage("conv_epilogue", lambda name, args: smem(args[0]),
                          match="conv1x1_tf32_kernel")
    sass = _sass_counts("conv_epilogue", "conv1x1_tf32_kernel")
    assert usage and all(not u.get("spill_store_bytes")
                         and not u.get("spill_load_bytes")
                         for u in usage.values()), usage
    assert sass and all(c["HGMMA"] > 0 and c["HMMA"] == 0
                        for c in sass.values()), sass

    def library(x, w):
        with common.library_precision(True):
            return torch.matmul(x, w)

    records = []
    for kind, shapes in (("conv1x1_stats", train_shapes),
                         ("conv1x1_epilogue", infer_shapes)):
        rows = {}
        for shape in sorted(set(shapes)):
            R, I, O, res, act = shape
            x, w, scale, shift, r = inputs(R, I, O, res)
            if kind == "conv1x1_stats":
                calls = (lambda: ke.conv1x1_stats(x, w),
                         lambda: ke.conv1x1_stats_tf32_reference(x, w),
                         lambda: library(x, w))
            else:
                calls = (lambda: ke.conv1x1_epilogue(x, w, scale, shift, r,
                                                     act),
                         lambda: ke.conv1x1_epilogue_tf32_reference(
                             x, w, scale, shift, r, act),
                         lambda: library(x, w))
            flops, nbytes = _conv_work(kind, R, I, O, res, act)
            bound, by = _tf32_bound(flops, nbytes, gpu_name)
            turns = [_cuda_ms(calls[i], iters=20) for i in (0, 2, 2, 0)]
            rows[shape] = {
                "ms": (turns[0] + turns[3]) / 2,
                "library_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
                "plain_ms": _cuda_ms(calls[1], iters=5),
                "bound_ms": bound, "bound_by": by,
                "count": shapes.count(shape)}
            del x, w, r, calls
        shape, top = max(rows.items(), key=lambda kv: kv[1]["bound_ms"])
        per_step = {k: sum(v[k] * v["count"] for v in rows.values())
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        rec = {"name": f"{kind}_tf32", "route": "cuda",
               "source": "paddle_tpu_torch/kernels/csrc/conv_epilogue.cu",
               "replaces": f"paddle_tpu/kernels/conv_epilogue.py:"
                           f"{CONV_REPLACES[kind]}",
               "launches": None, "max_abs_err": errs[kind], "ms": top["ms"],
               "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
               "bound_by": top["bound_by"], "bound_ms_simt": None,
               "library_ms": top["library_ms"],
               "library": "torch.matmul with cuBLAS TF32 allowed, product "
                          "only",
               "shape": "R{} I{} O{} residual={} act={}".format(*shape),
               "per_step": per_step, "ptxas": usage, "sass": sass,
               "per_shape": [[list(k), v] for k, v in rows.items()]}
        if kind == "conv1x1_stats":
            rec["stats_err_of_mass"] = stats_err
        print(f"precision (b) {kind} 1xTF32: heaviest shape {rec['shape']} "
              f"{top['ms']:.4f} ms, cuBLAS TF32 {top['library_ms']:.4f}, "
              f"plain {top['plain_ms']:.4f}, bound {top['bound_ms']:.4f} "
              f"({top['bound_by']}, TF32 rate); per "
              f"{'step' if kind == 'conv1x1_stats' else 'batch'} "
              f"{per_step['ms']:.3f} ms (cuBLAS TF32 "
              f"{per_step['library_ms']:.3f}, plain {per_step['plain_ms']:.3f}"
              f", bound {per_step['bound_ms']:.3f}) [{smi}]")
        records.append(rec)
    ke.conv1x1_stats.tf32_launches = ke.conv1x1_epilogue.tf32_launches = 0
    _policy("highest")
    return records


def lm_policy_part(pt, fa, smi):
    """(c): the per-layer LM (phase 19's unfused row) under default and
    highest from the same weights."""
    import numpy as np
    import torch

    c = HEAD_ROWS
    L = c["n_layers"]
    main, startup, loss, pgs = _head_row_program(
        pt, c, pt.Program._uid_counter, fused=False)
    rng = np.random.RandomState(SEED + 20)
    feed = {k: torch.from_numpy(rng.randint(0, c["vocab"], size=(
        c["batch"], c["seq"])).astype("int64")).to(CARD)
        for k in ("ids", "tgt")}
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    state = _snapshot(scope)
    fetch = [loss.name] + [g.name for _, g in pgs]

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)

    firsts, rows = {}, {}
    for policy in ("highest", "default"):
        _policy(policy)
        got = _step_fetches(exe, main, feed, fetch, scope, state)
        firsts[policy] = (float(got[0]), [g.cpu() for g in got[1:]])
        del got
        step()[0].item()  # warm
        _reset_flash_counts(fa)
        ms = []
        for _ in range(PRECISION_TIMED):
            t0 = time.perf_counter()
            step()[0].item()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = _flash_counts(fa)
        assert counts == (PRECISION_TIMED * L,) * 3 + (0, 0, 0), counts
        prof = _profile_step(step, f"precision_lm_{policy}_profile.txt",
                             groups=PRECISION_LM_GROUPS)
        _restore(scope, state)
        gemm = (None if prof is None else sum(
            prof["kernels_ms"][g] for g in ("nvjet", "gemm", "cutlass")))
        rows[policy] = {
            "ms_per_step": float(np.median(ms)), "step_ms": ms,
            "device_ms_per_step": None if prof is None else prof["device_ms"],
            "f32_gemm_device_ms": gemm,
            "flash_launches": [n // PRECISION_TIMED for n in counts[:3]],
            "profile": prof, "step1_loss": firsts[policy][0]}
        print(f"precision (c) LM d{c['d_model']} L{L} H{c['num_heads']} "
              f"f32 under {policy}: {rows[policy]['ms_per_step']:.1f} ms a "
              f"step (median of {PRECISION_TIMED}), device "
              f"{_ms_text(rows[policy]['device_ms_per_step'], '.1f')} ms, "
              f"f32 GEMMs {_ms_text(gemm, '.1f')} ms of it; flash "
              f"fwd/dq/dkv launches a step {rows[policy]['flash_launches']}")
    _policy("highest")
    names = [p.name for p, _ in pgs]
    worst = _grad_gap(names, firsts["default"][1], firsts["highest"][1])
    lo_d, lo_h = firsts["default"][0], firsts["highest"][0]
    loss_gap = abs(lo_d - lo_h) / abs(lo_h)
    identical = sum(torch.equal(a, b) for a, b in zip(
        firsts["default"][1], firsts["highest"][1]))
    print(f"precision (c) step 1 from the same weights: loss default "
          f"{lo_d:.6f} highest {lo_h:.6f} (gap {loss_gap:.2e}, tol "
          f"{PRECISION_LM_LOSS_RTOL}); worst gradient gap {worst[0]:.3e} of "
          f"a norm ({worst[1]}; tol {PRECISION_LM_GRAD_RTOL}); "
          f"{identical} of {len(names)} gradients bitwise equal [{smi}]")
    assert np.isfinite(lo_d) and loss_gap <= PRECISION_LM_LOSS_RTOL
    assert worst[0] <= PRECISION_LM_GRAD_RTOL, worst
    assert identical < len(names), "default computed what highest did"
    del scope, state, exe, firsts
    torch.cuda.empty_cache()
    return {"config": dict(c), "default": rows["default"],
            "highest": rows["highest"], "loss_gap": loss_gap,
            "worst_grad_gap": worst[0], "worst_grad": worst[1]}


def resnet_policy_part(pt, gpu_name, built, smi):
    """(d): ResNet-50 trained at batch 256 with fused epilogues under
    default and highest from the same weights. Returns (record, scope)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import conv_epilogue as ke

    c = RESNET
    B = c["batch"]
    main, startup, test_prog, loss, logits, params_grads = built
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace())
    exe.run(startup, scope=scope)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    images = torch.randn(B, c["size"], c["size"], 3, device="cuda",
                         generator=gen)
    feed = {"images": images,
            "label": torch.randint(0, c["classes"], (B, 1), device="cuda",
                                   generator=gen)}
    sign = torch.randint(0, 2, images.shape, device="cuda",
                         generator=gen) * 2 - 1
    nudged = dict(feed, images=images * (1 + PRECISION_NUDGE * sign))
    state = _snapshot(scope)
    grad_names = [g.name for _, g in params_grads]
    fetch = [loss.name] + grad_names
    first = {}
    for tag, policy, f in (("highest", "highest", feed),
                           ("nudged", "highest", nudged),
                           ("default", "default", feed)):
        _policy(policy)
        got = _step_fetches(exe, main, f, fetch, scope, state)
        first[tag] = (float(got[0]), [g.float() for g in got[1:]])
        del got
    d_dh, d_nh, norms, worst = [], [], [], (-1.0, "")
    for i, name in enumerate(grad_names):
        gh, gn, gd = (first[t][1][i] for t in ("highest", "nudged",
                                               "default"))
        assert torch.isfinite(gd).all(), name
        dd, dn, n = (float((gd - gh).norm()), float((gn - gh).norm()),
                     float(gh.norm()))
        d_dh.append(dd)
        d_nh.append(dn)
        norms.append(n)
        worst = max(worst, (dd / max(GRAD_RTOL * n, SENS_FACTOR * dn,
                                     1e-30), name))
    total_d = float(np.linalg.norm(d_dh)) / float(np.linalg.norm(norms))
    total_n = float(np.linalg.norm(d_nh)) / float(np.linalg.norm(norms))
    lh, ln, ld = (first[t][0] for t in ("highest", "nudged", "default"))
    loss_allow = max(SENS_FACTOR * abs(ln - lh), 2.0 ** -10 * abs(lh))
    rel_d = np.array(d_dh) / np.maximum(norms, 1e-30)
    rel_n = np.array(d_nh) / np.maximum(norms, 1e-30)
    print(f"precision (d) ResNet-50 step 1 from the same weights: loss "
          f"default {ld:.6f} highest {lh:.6f} (gap {abs(ld - lh):.3e}, "
          f"allowed {loss_allow:.3e}; highest with the images nudged by "
          f"half a TF32 ulp {ln:.6f}); gradients |default - highest| / "
          f"|highest| median {np.median(rel_d):.3e} max {rel_d.max():.3e}, "
          f"all together {total_d:.3e}; the nudge's move median "
          f"{np.median(rel_n):.3e} max {rel_n.max():.3e}, all together "
          f"{total_n:.3e}; worst gap-to-allowance ratio {worst[0]:.3f} "
          f"({worst[1]}) over {len(grad_names)} parameters [{smi}]")
    del first
    assert np.isfinite(ld) and abs(ld - lh) <= loss_allow, (ld, lh, ln)
    assert worst[0] <= 1.0, worst
    assert total_d <= max(SENS_TOTAL * total_n, GRAD_RTOL), (total_d,
                                                              total_n)

    rows = {}
    for policy in ("highest", "default"):
        _policy(policy)
        _restore(scope, state)
        tf32 = policy == "default"
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)  # warm
        _reset_conv_counts(ke)
        ke.conv1x1_stats.tf32_launches = 0
        losses, step_s = [], []
        for _ in range(PRECISION_TIMED):
            t1 = time.perf_counter()
            lo, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            step_s.append(time.perf_counter() - t1)
            losses.append(float(lo))
        counts = {"3xtf32": ke.conv1x1_stats.launches,
                  "1xtf32": ke.conv1x1_stats.tf32_launches,
                  "scale_shift_act": ke.scale_shift_act.launches}
        want = PRECISION_TIMED * FUSED_OPS
        assert counts == {"3xtf32": 0 if tf32 else want,
                          "1xtf32": want if tf32 else 0,
                          "scale_shift_act": want}, counts
        assert all(np.isfinite(losses)), losses
        prof = _profile_step(
            lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope),
            f"precision_resnet_{policy}_profile.txt",
            groups=PRECISION_RESNET_GROUPS)
        med = float(np.median(step_s))
        gemm_key = "conv1x1_tf32_kernel" if tf32 else "conv1x1_tf32x3_kernel"
        rows[policy] = {
            "ms_per_step": med * 1e3, "step_ms": [s * 1e3 for s in step_s],
            "images_per_s": B / med, "losses": losses,
            "launches_per_step": {k: n // PRECISION_TIMED
                                  for k, n in counts.items()},
            "device_ms_per_step": None if prof is None else prof["device_ms"],
            "conv_gemm_device_ms": None if prof is None
            else prof["kernels_ms"][gemm_key],
            "conv_gemm_launches_traced": None if prof is None
            else prof["launches"][gemm_key],
            "profile": prof}
        print(f"precision (d) ResNet-50 batch {B} under {policy}: "
              f"{med * 1e3:.1f} ms a step (median of {PRECISION_TIMED}), "
              f"{B / med:.1f} images/s, device "
              f"{_ms_text(rows[policy]['device_ms_per_step'], '.1f')} ms; "
              f"{gemm_key} {_ms_text(rows[policy]['conv_gemm_device_ms'])} "
              f"ms of device time in "
              f"{rows[policy]['conv_gemm_launches_traced']} traced launches; "
              f"wrapper launches a step {rows[policy]['launches_per_step']}")
        if prof is not None:
            assert prof["launches"][gemm_key] == FUSED_OPS, prof["launches"]
    _policy("highest")
    return {"default": rows["default"], "highest": rows["highest"],
            "loss_default": ld, "loss_highest": lh, "loss_nudged": ln,
            "grad_rel_median": float(np.median(rel_d)),
            "grad_rel_max": float(rel_d.max()), "grad_rel_total": total_d,
            "nudge_rel_median": float(np.median(rel_n)),
            "nudge_rel_max": float(rel_n.max()), "nudge_rel_total": total_n,
            "worst_ratio_to_allowance": worst[0],
            "worst_grad": worst[1]}, scope


def flags_keys_part(pt, built, scope, smi):
    """(e): the flags flip the policy; the engine captures a new graph
    after a flip; fp8 and bf16 parameters round-trip on the card."""
    import shutil

    import numpy as np
    import torch

    from paddle_tpu_torch import flags
    from paddle_tpu_torch.kernels import conv_epilogue as ke
    from paddle_tpu_torch.ops import common

    # the flags, with the policy unset (it follows --mxu_precision)
    common._MXU_PRECISION = common._UNSET
    x = torch.randn(512, 1024, device="cuda")
    w = torch.randn(1024, 512, device="cuda")
    seen = {}
    for argv in (["--mxu_precision=default"], ["--mxu_precision", "highest"]):
        rest = flags.parse_flags(argv + ["--log_period=7", "positional"])
        assert rest == ["positional"] and flags.FLAGS.log_period == 7
        seen[common.mxu_precision()] = common.matmul(x, w)
    assert set(seen) == {None, "highest"}
    flip_gap = float((seen[None] - seen["highest"]).abs().max())
    assert flip_gap > 0, "--mxu_precision changed nothing on the card"
    flags.set_flags({"mxu_precision": "default"})
    assert common.mxu_precision() is None
    common.set_mxu_precision("highest")  # an explicit set wins
    flags.set_flags({"mxu_precision": "default"})
    assert common.mxu_precision() == "highest"
    assert torch.equal(common.matmul(x, w), seen["highest"])
    flags.reset_flags()
    flags.parse_flags(["--mxu_precision=highest"])
    print(f"precision (e) parse_flags/set_flags flip the policy (a 512 x "
          f"1024 x 512 product moves {flip_gap:.3e} between default and "
          f"highest); an explicit set_mxu_precision wins over the flag")

    # the engine: the ResNet-50 for_test clone served at batch 16
    c = RESNET
    B = c["infer_batch"]
    test_prog, logits = built[2], built[4]
    exe = pt.Executor(pt.CUDAPlace())
    model_dir = ROOT / "build" / "resnet50_precision"
    shutil.rmtree(model_dir, ignore_errors=True)
    pt.flags.FLAGS.fused_conv_epilogue = True
    try:
        pt.io.save_inference_model(str(model_dir), ["images"], [logits], exe,
                                   main_program=test_prog, scope=scope)
    finally:
        pt.flags.FLAGS.fused_conv_epilogue = False
    _policy("default")
    eng = pt.InferenceEngine(str(model_dir), place=pt.CUDAPlace(0),
                             batch_buckets=(B,))
    ke.conv1x1_epilogue.tf32_launches = 0
    assert eng.warmup() == 1 and eng.cache_stats()["graphs"] == 1
    epi_launches = ke.conv1x1_epilogue.tf32_launches
    assert epi_launches > 0, "the default engine never ran the 1xTF32 kernel"
    xs = np.random.RandomState(SEED + 23).randn(
        B, c["size"], c["size"], 3).astype("float32")
    outs, counted = {}, {}
    names = ("conv1x1_tf32_kernel", "conv1x1_tf32x3_kernel")
    for policy in ("default", "highest"):
        _policy(policy)
        outs[policy] = eng.run({"images": xs})[0]
        eager = exe.run(eng.program, feed={"images": xs},
                        fetch_list=eng.fetch_names, scope=eng.scope)[0]
        ref = float(np.abs(eager).max())
        err = float(np.abs(outs[policy] - eager).max())
        counted[policy] = _count_kernels(lambda: eng.run({"images": xs}),
                                         names)
        print(f"precision (e) engine at batch {B} under {policy}: "
              f"{eng.cache_stats()['graphs']} CUDA graph(s); the replay vs "
              f"the eager run under the same policy {err:.3e} (tol "
              f"{REPLAY_RTOL} of max |logit| {ref:.3e}); one traced replay "
              f"launched {counted[policy]}")
        assert err <= REPLAY_RTOL * ref, (policy, err, ref)
    assert eng.cache_stats()["graphs"] == 2
    policy_gap = float(np.abs(outs["default"] - outs["highest"]).max())
    assert policy_gap > 0, "the flip replayed the other policy's graph"
    for policy, kname in (("default", names[0]), ("highest", names[1])):
        if counted[policy] is not None:
            other = names[1 - names.index(kname)]
            assert counted[policy][kname] == FUSED_OPS, counted
            assert counted[policy][other] == 0, counted
    eng.close()
    _policy("highest")
    shutil.rmtree(model_dir, ignore_errors=True)

    # fp8 and bf16 parameters through save_params / load_params
    dtypes = ("bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
              "float8_e5m2fnuz")
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        inp = pt.layers.data("x", shape=[64])
        pt.layers.fc(inp, size=64, param_attr=pt.ParamAttr(name="w8"),
                     bias_attr=pt.ParamAttr(name="b8"))
    io_dir = ROOT / "build" / "precision_io"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    for name in dtypes:
        dt = getattr(torch, name)
        view = torch.int16 if dt.itemsize == 2 else torch.uint8
        src = pt.Scope()
        for key, shape in (("w8", (64, 64)), ("b8", (64,))):
            bits = torch.randint(-2**15 if view == torch.int16 else 0,
                                 2**15 if view == torch.int16 else 256,
                                 shape, device="cuda", generator=gen)
            src.set(key, bits.to(view).view(dt))
        shutil.rmtree(io_dir, ignore_errors=True)
        pt.io.save_params(exe, str(io_dir), main_program=main, scope=src)
        dst = pt.Scope()
        pt.io.load_params(exe, str(io_dir), main_program=main, scope=dst)
        for key in ("w8", "b8"):
            got = dst.get(key)
            assert got.is_cuda and got.dtype == dt, (name, got.dtype)
            assert torch.equal(got.view(view), src.get(key).view(view)), name
    shutil.rmtree(io_dir, ignore_errors=True)
    print(f"precision (e) {', '.join(dtypes)} parameters saved from and "
          f"loaded onto the card bit for bit [{smi}]")
    return {"flip_gap": flip_gap, "engine_policy_gap": policy_gap,
            "engine_kernels": counted, "epilogue_1xtf32_launches_at_capture":
            epi_launches, "io_dtypes": list(dtypes)}


# The demos' own loops, through paddle_tpu_torch.v2 (copied from
# demos/mnist_v2.py, demos/traffic_prediction.py and demos/quick_start.py,
# which import the JAX package; the demos stay as they are).
def _v2_mnist_build(paddle):
    images = paddle.layer.data("pixel", paddle.data_type.dense_vector(784))
    label = paddle.layer.data("label", paddle.data_type.integer_value(10))
    h1 = paddle.layer.fc(input=images, size=128,
                         act=paddle.activation.Relu())
    h2 = paddle.layer.fc(input=h1, size=64, act=paddle.activation.Relu())
    logits = paddle.layer.fc(input=h2, size=10)
    cost = paddle.layer.classification_cost(input=logits, label=label)
    return cost, logits, paddle.optimizer.Adam(learning_rate=1e-3)


TRAFFIC_TERMS = TRAFFIC_HORIZONS = 24


def _v2_traffic_series(n_days=30, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(n_days * 288)
    base = 0.5 + 0.35 * np.sin(2 * np.pi * t / 288.0 - 1.2)
    rush = 0.15 * np.exp(-0.5 * ((t % 288 - 102) / 12.0) ** 2)
    return np.clip(base + rush + 0.05 * rng.randn(t.size), 0, 1)


def _v2_quantize(x):
    import numpy as np

    return np.minimum((x * 4).astype(np.int64), 3)


def _v2_windows(series, n, seed=1):
    import numpy as np

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            i = rng.randint(0, series.size - TRAFFIC_TERMS - TRAFFIC_HORIZONS)
            past = series[i:i + TRAFFIC_TERMS].astype(np.float32)
            future = _v2_quantize(series[i + TRAFFIC_TERMS:
                                         i + TRAFFIC_TERMS + TRAFFIC_HORIZONS])
            yield (past, *[np.array([lvl]) for lvl in future])
    return reader


def _v2_traffic_build(paddle):
    link_encode = paddle.layer.data(
        "link_encode", paddle.data_type.dense_vector(TRAFFIC_TERMS))
    shared = paddle.attr.Param(name="_link_vec.w")
    total_cost, scores = None, []
    for i in range(TRAFFIC_HORIZONS):
        link_vec = paddle.layer.fc(input=link_encode, size=16,
                                   act=paddle.activation.Tanh(),
                                   param_attr=shared)
        score = paddle.layer.fc(input=link_vec, size=4,
                                act=paddle.activation.Softmax())
        label = paddle.layer.data(f"label_{(i + 1) * 5}min",
                                  paddle.data_type.integer_value(4))
        cls = paddle.layer.classification_cost(input=score, label=label)
        total_cost = cls if total_cost is None else total_cost + cls
        scores.append(score)
    return total_cost, scores, paddle.optimizer.Adam(learning_rate=1e-2)


def _v2_quick_start_build(paddle, config, word_dim):
    if config == "lr":  # logistic regression over a sparse bag of words
        words = paddle.layer.data(
            "words", paddle.data_type.sparse_binary_vector(word_dim))
        output = paddle.layer.fc(input=words, size=2,
                                 act=paddle.activation.Softmax())
        label = paddle.layer.data("label",
                                  paddle.data_type.integer_value(2))
        cost = paddle.layer.classification_cost(input=output, label=label)
        return cost, output, paddle.optimizer.Adam(learning_rate=2e-3)
    words = paddle.layer.data(
        "words", paddle.data_type.integer_value_sequence(word_dim))
    emb = paddle.layer.embedding(input=words, size=128)
    if config == "cnn":
        hidden = paddle.networks.sequence_conv_pool(
            input=emb, context_len=3, hidden_size=128)
    else:
        lstm = paddle.networks.simple_lstm(input=emb, size=128)
        hidden = paddle.layer.pooling(input=lstm,
                                      pooling_type=paddle.pooling.Max())
    output = paddle.layer.fc(input=hidden, size=2,
                             act=paddle.activation.Softmax())
    label = paddle.layer.data("label", paddle.data_type.integer_value(2))
    cost = paddle.layer.classification_cost(input=output, label=label)
    return cost, output, paddle.optimizer.Adam(learning_rate=2e-3)


def _v2_setup(pt, paddle, demo, use_gpu, start):
    """The demo's program, parameters and trainer, built from the name
    counter ``start`` on the card or the CPU."""
    paddle.init(use_gpu=use_gpu, trainer_count=1, seed=v2_SEEDS[demo])
    pt.Program._uid_counter = start
    with pt.program_guard(pt.Program(), pt.Program()):
        if demo == "mnist_v2":
            cost, out, opt = _v2_mnist_build(paddle)
        elif demo == "traffic_prediction":
            cost, out, opt = _v2_traffic_build(paddle)
        else:
            cost, out, opt = _v2_quick_start_build(
                paddle, demo.rsplit("_", 1)[1],
                len(pt.dataset.imdb.word_dict()))
        params = paddle.parameters.create(cost)
        trainer = paddle.trainer.SGD(cost=cost, parameters=params,
                                     update_equation=opt)
    return cost, out, params, trainer


v2_SEEDS = {"mnist_v2": 42, "traffic_prediction": 11,
            "quick_start_cnn": 7, "quick_start_lstm": 7, "quick_start_lr": 7}


def _v2_bow(reader, dim):
    """quick_start.py's bow_reader: (sorted unique ids, label)."""
    def wrapped():
        for ids, label in reader():
            yield sorted(set(i for i in ids if i < dim)), label
    return wrapped


def _v2_passes(pt, demo, c):
    """Each pass's batches, materialised: the demo's reader (shuffled
    where the demo shuffles, Python's RNG seeded once) cut into batches."""
    import random

    from paddle_tpu_torch.reader import decorator

    random.seed(SEED)
    if demo == "mnist_v2":
        train = pt.dataset.mnist.train()
    elif demo == "traffic_prediction":
        train = _v2_windows(_v2_traffic_series(), c["n_train"])
    elif demo == "quick_start_lr":  # the demo's FAST cut: firstn(256)
        wd = pt.dataset.imdb.word_dict()
        train = decorator.shuffle(decorator.firstn(
            _v2_bow(pt.dataset.imdb.train(wd), len(wd)), c["samples"]), 512)
    else:
        train = decorator.shuffle(pt.dataset.imdb.train(
            pt.dataset.imdb.word_dict()), 512)
    batched = pt.reader.batch(train, c["batch"])
    return [list(batched()) for _ in range(c["passes"])]


def _v2_demo(pt, demo, smi, c=None, label="precision (f)"):
    """One demo's loop on the card through paddle_tpu_torch.v2, its first
    V2_CPU_STEPS losses against the port's CPU run from the same weights,
    its own closing output. Returns its record."""
    import numpy as np
    import torch

    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch.reader import decorator

    c = c or V2_DEMOS[demo]
    passes = _v2_passes(pt, demo, c)
    start = pt.Program._uid_counter
    cpu = _v2_setup(pt, paddle, demo, False, start)
    cost, out, params, trainer = _v2_setup(pt, paddle, demo, True, start)
    params.init()
    cpu[2].init()
    for name, value in list(params.scope._vars.items()):
        if isinstance(value, torch.Tensor):
            cpu[2].scope.set(name, value.detach().cpu().clone())
    cpu_losses = []
    cpu[3].train(lambda: iter(passes[0][:V2_CPU_STEPS]), num_passes=1,
                 event_handler=lambda e: cpu_losses.append(e.cost)
                 if isinstance(e, paddle.event.EndIteration) else None)

    losses, stamps = [], []
    feed_iter = iter(passes)

    def handler(event):
        if isinstance(event, paddle.event.EndIteration):
            losses.append(event.cost)
            stamps.append(time.perf_counter())
        elif isinstance(event, paddle.event.BeginPass):
            stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    trainer.train(lambda: iter(next(feed_iter)), num_passes=c["passes"],
                  event_handler=handler)
    loop_s = time.perf_counter() - t0
    gaps = np.diff(stamps) * 1e3
    first = np.array(losses[:V2_CPU_STEPS])
    loss_rel = float(np.max(np.abs(first - cpu_losses) / np.abs(cpu_losses)))
    rec = {"config": c, "steps": len(losses), "loop_s": loop_s,
           "ms_per_step": float(np.median(gaps)),
           "first_losses": first.tolist(), "cpu_first_losses": cpu_losses,
           "loss_rel_vs_cpu": loss_rel, "final_loss": losses[-1]}

    # the demo's own closing output
    if demo == "mnist_v2":
        result = trainer.test(paddle.batch(decorator.firstn(
            pt.dataset.mnist.test(), 256), 64))
        rows = [(img,) for img, _ in list(pt.dataset.mnist.test()())[:8]]
        probs = paddle.infer(output_layer=out, parameters=params, input=rows)
        rec.update(test_cost=result.cost,
                   predicted=np.argmax(probs, axis=1).tolist())
        said = (f"test cost: {result.cost:.4f}; predicted digits: "
                f"{rec['predicted']}")
    elif demo == "traffic_prediction":
        series = _v2_traffic_series()
        i = series.size - TRAFFIC_TERMS - TRAFFIC_HORIZONS - 1
        past = series[i:i + TRAFFIC_TERMS].astype(np.float32)
        truth = _v2_quantize(series[i + TRAFFIC_TERMS:
                                    i + TRAFFIC_TERMS + TRAFFIC_HORIZONS])
        probs = paddle.infer(output_layer=out, parameters=params,
                             input=[(past,)])
        pred = [int(np.argmax(p, axis=1)[0]) for p in probs]
        rec.update(predicted=pred, truth=truth.tolist(),
                   agreement=float(np.mean(np.array(pred) == truth)))
        said = f"horizon agreement: {rec['agreement']:.2f}"
    else:
        config = demo.rsplit("_", 1)[1]
        wd = pt.dataset.imdb.word_dict()
        test = pt.dataset.imdb.test(wd)
        if config == "lr":
            test = decorator.firstn(_v2_bow(test, len(wd)), c["test"])
        result = trainer.test(paddle.batch(test, 64))
        rows = [(x,) for x, _ in decorator.firstn(test, 8)()]
        probs = paddle.infer(output_layer=out, parameters=params, input=rows)
        prog = params.test_program_for([out])
        feeds = [v.name for v in params.data_vars(program=prog)]
        pm = pt.transpiler.inference_pipeline()
        pm.run(prog, feeds, [out.name], scope=pt.Scope(parent=params.scope))
        rec.update(test_cost=result.cost,
                   predicted=np.argmax(probs, axis=1).tolist())
        said = (f"[{config}] test cost: {result.cost:.4f}; predicted "
                f"labels: {rec['predicted']}; transpiler passes "
                f"{len(pm.format_stats().splitlines())} lines of stats")
    # one more training step, timed, then traced: its device time and
    # kernel launches (after the demo's own output, which it would move)
    batch = trainer._feeder(None).feed(passes[0][0])
    anatomy = rec["anatomy"] = _one_step_anatomy(
        lambda: params.executor.run(params.main_program, feed=batch,
                                    fetch_list=[cost], scope=params.scope))
    print(f"{label} {demo}: {rec['steps']} steps in {loop_s:.1f} s, "
          f"{rec['ms_per_step']:.2f} ms a step (median wall with the cost "
          f"fetch), one step's device {_ms_text(anatomy['device_ms'])} ms "
          f"in {anatomy['launches']} kernel launches; first "
          f"{len(first)} losses {np.round(first, 6).tolist()} within "
          f"{loss_rel:.2e} of the CPU's (tol {V2_LOSS_RTOL}); final loss "
          f"{losses[-1]:.4f}; {said} [{smi}]")
    assert np.isfinite(losses).all(), losses[-5:]
    assert loss_rel <= V2_LOSS_RTOL, (first, cpu_losses)
    assert params.executor.device.type == "cuda"
    del trainer, params, cpu
    return rec


def v2_demos_part(pt, smi):
    """(f): the three v2 demos' loops on the card."""
    import paddle_tpu_torch.v2 as paddle

    _policy("highest")
    try:
        return {demo: _v2_demo(pt, demo, smi) for demo in V2_DEMOS}
    finally:
        paddle.init()


def precision_phase(smi, gpu_name):
    """Phase 20: (a) the policy on the library products, (b) the 1xTF32
    conv GEMM kernels, (c) the f32 LM and (d) ResNet-50 under both
    policies, (e) the flags, the engine's keys and the saved dtypes, (f)
    the v2 demos. Returns (kernel records, its record)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import conv_epilogue as ke
    from paddle_tpu_torch.kernels import flash_attention as fa

    seconds = [time.perf_counter()]
    out = {"a": policy_ops_part(smi)}
    seconds.append(time.perf_counter())
    built = _build_resnet(pt, RESNET)
    recs = tf32_kernel_part(gpu_name, _fused_shapes(built[0], RESNET["batch"]),
                            _fused_shapes(built[2], RESNET["infer_batch"]),
                            smi)
    seconds.append(time.perf_counter())
    torch.cuda.empty_cache()
    out["c"] = lm_policy_part(pt, fa, smi)
    seconds.append(time.perf_counter())
    # the main path's launches of the 1xTF32 kernels: counts to 0 before
    # (d) and (e), read after
    ke.conv1x1_stats.tf32_launches = ke.conv1x1_epilogue.tf32_launches = 0
    out["d"], scope = resnet_policy_part(pt, gpu_name, built, smi)
    seconds.append(time.perf_counter())
    out["e"] = flags_keys_part(pt, built, scope, smi)
    launches = {"conv1x1_stats_tf32": ke.conv1x1_stats.tf32_launches,
                "conv1x1_epilogue_tf32": ke.conv1x1_epilogue.tf32_launches}
    del built, scope
    torch.cuda.empty_cache()
    seconds.append(time.perf_counter())
    out["f"] = v2_demos_part(pt, smi)
    seconds.append(time.perf_counter())
    for rec in recs:
        rec["launches"] = launches[rec["name"]]
        assert rec["launches"] > 0, (rec["name"], launches)
    per_step = out["d"]["default"]["launches_per_step"]["1xtf32"]
    recs[0]["launches_phase20"] = {"ResNet-50 step, default": per_step}
    recs[1]["launches_phase20"] = {
        f"ResNet-50 served batch {RESNET['infer_batch']}, default (one "
        "replay, traced)":
        (out["e"]["engine_kernels"]["default"] or {}).get(
            "conv1x1_tf32_kernel")}
    out["launches"] = launches
    out["seconds"] = [b - a for a, b in zip(seconds, seconds[1:])]
    print("phase 20 seconds: " + ", ".join(
        f"{part} {s:.1f}" for part, s in zip(("(a)", "(b)", "(c)", "(d)",
                                              "(e)", "(f)"), out["seconds"]))
        + f"; {sum(out['seconds']):.1f} in all [{smi}]")
    return recs, out


def phase20_launches(records, precision):
    """The 3xTF32 conv GEMM's and the flash trio's launches a step on
    phase 20's paths (the 1xTF32 records carry their own)."""
    c, d = precision["c"], precision["d"]
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    for rec in records:
        if rec["name"] in names:
            i = names.index(rec["name"])
            rec["launches_phase20"] = {
                f"d1024 LM, {p}": c[p]["flash_launches"][i]
                for p in ("default", "highest")}
        elif rec["name"] == "conv1x1_stats":
            rec["launches_phase20"] = {
                "ResNet-50 step, highest":
                d["highest"]["launches_per_step"]["3xtf32"]}


# --- phase 21: the decode plane ----------------------------------------------
# (a) the stacked LM's one-shot decoders at the serving width (phase 1's
# d1024 L8 H16 V16384, random weights from SEED), batch 4, prompt 512:
# transformer_lm_beam_search (beam 4, 64 new tokens, GNMT 0.6),
# transformer_lm_speculative_generate (draft_layers 2, gamma 4, the draft
# head a copy of the target's, as demos/transformer_lm.py sets it) and
# transformer_lm_generate (greedy), each through Executor.run. (b) the
# paged engine's beam plane at the same width. (c) Transformer-base NMT
# (Vaswani et al. 2017, Table 3 "base") trained with the teacher op in f32
# and under AMP, then served through Seq2SeqGenerationEngine. (d) the two
# demos at their own sizes.
DECODE_LM = dict(vocab=16384, d_model=1024, n_layers=8, num_heads=16,
                 max_len=2048, batch=4, prompt=512, new=64, beam=4,
                 penalty=0.6, draft_layers=2, gamma=4)
PAGED_BEAM = dict(slots=20, page_size=64, greedy=4, beams=4, new=32,
                  prompt=(256, 513))
# d_model 512, 6 layers (encoder and decoder alike), 8 heads (head dim
# 64), d_ff 2048, a shared 37,000-token vocabulary (WMT14 En-De BPE);
# source and target cut to 256 positions; batch 32 x 256 + 256 tokens
NMT_BASE = dict(vocab=37000, d_model=512, n_layers=6, num_heads=8,
                d_ff=2048, max_len=256, batch=32, steps=3, lr=1e-4,
                slots=16, page_size=16, beam=4, sources=16,
                src_len=(32, 129), new=32, penalty=0.6)
NMT_BOS, NMT_EOS, NMT_SHIFT = 0, 1, 2
LM_DEMO = dict(vocab=97, T=64, d_model=64, n_layers=2, heads=4, steps=120,
               batch=32, lr=3e-3, new=8, beam=3, draft_layers=1, gamma=3)
# its 700 steps took 47.0 s on an NVIDIA H100 80GB HBM3 at 700 W (67.1
# ms a step, host-bound), past the ~30 s the phase affords: it runs as
# PADDLE_TPU_DEMO_FAST=1 does, 12 steps, without the full run's loss
# and accuracy gates
NMT_DEMO = dict(src_v=24, tgt_v=24, d_model=32, n_layers=2, heads=2, ts=12,
                tt=16, steps=12, batch=32, lr=4e-3, slots=4, page_size=4)
NEAR_TIE_RTOL = 1e-5  # a decoder may part from greedy only at such a tie


def _lm_decoder_program(pt, c, kind, prompt_len):
    """One of the stacked LM's one-shot decoders over a [b, prompt_len]
    feed "prompt": (program, fetch vars)."""
    from paddle_tpu_torch import layers, models

    main, startup = pt.Program(), pt.Program()
    kw = dict(vocab_size=c["vocab"], d_model=c["d_model"],
              n_layers=c["n_layers"], num_heads=c["num_heads"],
              max_len=c["max_len"], max_new_tokens=c["new"])
    with pt.program_guard(main, startup):
        prompt = layers.data("prompt", shape=[prompt_len], dtype="int64")
        if kind == "greedy":
            fetch = [models.transformer_lm_generate(prompt, **kw)]
        elif kind == "beam":
            fetch = list(models.transformer_lm_beam_search(
                prompt, beam_size=c["beam"], length_penalty=c["penalty"],
                **kw))
        else:
            fetch = list(models.transformer_lm_speculative_generate(
                prompt, draft_layers=c["draft_layers"], gamma=c["gamma"],
                **kw))
    return main, fetch


def _with_draft_head(params):
    """The weights plus a draft head copied from the target's."""
    return dict(params, **{"draft_head.w": params["lm_head.w"],
                           "draft_ln.scale": params["final_ln.scale"],
                           "draft_ln.bias": params["final_ln.bias"]})


def _lm_next_logits(scope, num_heads, ids):
    """The full stack's next-token logits after each row of ``ids`` (a
    [b, t] tensor on the card), by the plain prefill path."""
    from paddle_tpu_torch.ops import pipeline_ops as po

    params = {k: scope.get(f"lm_stack.stack_{k}")
              for k in po._STACK_SLOTS.values()}
    x = po._embed_fn(scope.get("tok_emb"), scope.get("pos_emb"))(ids, 0)
    h, _, _ = po._prefill(params, x, num_heads, ids.shape[0], ids.shape[1])
    return po._logits_fn(scope.get("final_ln.scale"),
                         scope.get("final_ln.bias"),
                         scope.get("lm_head.w"))(h[:, -1])


def _greedy_gate(scope, num_heads, prompts, greedy, other, what):
    """``other`` [b, Tp + N] must equal ``greedy`` token for token, but
    where greedy's step had its top two logits within NEAR_TIE_RTOL of
    each other (relative) and ``other`` took the runner-up: then both
    margins are printed and the rest of the row is not compared.
    Returns the rows that parted so."""
    import numpy as np
    import torch

    Tp = prompts.shape[1]
    ties = []
    for row in range(greedy.shape[0]):
        diff = np.nonzero(greedy[row, Tp:] != other[row, Tp:])[0]
        if not diff.size:
            continue
        j = Tp + int(diff[0])
        ids = torch.from_numpy(greedy[row:row + 1, :j]).cuda()
        with torch.no_grad():
            logits = _lm_next_logits(scope, num_heads, ids)[0].double()
        top = torch.topk(logits, 2)
        rel = float((top.values[0] - top.values[1]) / top.values[0].abs())
        a, b = int(greedy[row, j]), int(other[row, j])
        print(f"decode plane: {what} row {row} parts from greedy at "
              f"position {j}: greedy took {a} (logit "
              f"{float(logits[a]):.7f}), {what} {b} (logit "
              f"{float(logits[b]):.7f}); the top two "
              f"{top.indices.tolist()} are {rel:.3e} apart, relative "
              f"(a near tie passes within {NEAR_TIE_RTOL})")
        assert {a, b} == set(top.indices.tolist()) and rel <= NEAR_TIE_RTOL, (
            what, row, j, a, b, rel)
        ties.append({"row": row, "position": j, "rel_gap": rel})
    return ties


def _traced_run(run):
    """(device ms, kernel launches) of one profiled ``run()``; the trace
    opens with _cuda_trace's fills, not with another run (a decoder's run
    is tens of thousands of launches)."""
    try:
        with _cuda_trace() as prof:
            run()
        kernels = _traced_kernels(prof)
    except Exception as exc:  # noqa: BLE001 - a measurement aid
        print(f"device time: not measured ({type(exc).__name__}: {exc})")
        kernels = []
    return (sum(us for _, us in kernels) / 1e3 if kernels else None,
            len(kernels))


def lm_decoders_part(pt, fa, smi):
    """(a): beam search, speculative and greedy decoding of the d1024 LM
    through Executor.run, each timed on its main-path run (the first)
    and traced once more. Returns its record and the beam output."""
    import numpy as np
    import torch

    from paddle_tpu_torch import init_params
    from paddle_tpu_torch.serving import LMSpec

    c = DECODE_LM
    spec = LMSpec(vocab_size=c["vocab"], d_model=c["d_model"],
                  n_layers=c["n_layers"], num_heads=c["num_heads"],
                  max_len=c["max_len"])
    params = _with_draft_head(init_params(spec, SEED))
    scope = pt.scope_from_numpy(params, "cuda")
    exe = pt.Executor(pt.CUDAPlace(0))
    rng = np.random.RandomState(SEED + 21)
    prompts = rng.randint(0, c["vocab"], (c["batch"], c["prompt"])).astype(
        np.int64)
    rec, outs = {}, {}
    for kind in ("beam", "speculative", "greedy"):
        prog, fetch = _lm_decoder_program(pt, c, kind, c["prompt"])

        def run(prog=prog, fetch=fetch):
            return exe.run(prog, feed={"prompt": prompts},
                           fetch_list=fetch, scope=scope)

        fa.flash_attention.launches = 0  # the main path's launches only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[kind] = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = fa.flash_attention.launches
        dev, n = _traced_run(run)
        rec[kind] = {"flash_launches": launches, "wall_ms": wall,
                     "device_ms": dev, "kernel_launches": n}
        assert launches == c["n_layers"], (kind, launches)
    beams, scores = (np.asarray(x) for x in outs["beam"])
    spec_ids, rounds = (np.asarray(x) for x in outs["speculative"])
    greedy = np.asarray(outs["greedy"][0])
    Tp, N, K = c["prompt"], c["new"], c["beam"]
    assert beams.shape == (c["batch"], K, Tp + N) and scores.shape == (
        c["batch"], K), (beams.shape, scores.shape)
    assert (beams[:, :, :Tp] == prompts[:, None]).all()
    assert ((beams >= 0) & (beams < c["vocab"])).all()
    assert np.isfinite(scores).all() and (np.diff(scores, axis=1) <= 0).all()
    ties = _greedy_gate(scope, c["num_heads"], prompts, greedy, spec_ids,
                        "speculative")
    rounds = int(rounds.reshape(-1)[0])
    assert 0 < rounds <= N - 1, rounds
    rec.update({"config": c, "rounds": rounds, "near_ties": ties,
                "best_scores": scores[:, 0].tolist()})
    for kind in ("beam", "speculative", "greedy"):
        r = rec[kind]
        print(f"decode plane (a) {kind}: batch {c['batch']} x prompt {Tp}, "
              f"{N} new tokens: {r['wall_ms']:.1f} ms wall, device "
              f"{_ms_text(r['device_ms'], '.1f')} ms in "
              f"{r['kernel_launches']} launches; flash forward launches "
              f"{r['flash_launches']} (one prefill of {c['n_layers']} "
              f"layers) [{smi}]")
    print(f"decode plane (a): speculative = greedy token for token "
          f"({len(ties)} near ties) in {rounds} verify rounds against "
          f"{N - 1} decode steps; best beam scores "
          f"{[round(s, 4) for s in rec['best_scores']]}")
    return rec, beams, prompts, params


def paged_beam_part(pt, smi, beams, prompts, params):
    """(b): the paged engine's beam plane at the serving width: one
    generate_beam against (a)'s op, then greedy and beam requests in one
    continuous batch through Server."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.transformer import TransformerLM
    from paddle_tpu_torch.serving import LMSpec, PagedGenerationEngine, Server

    c, b = DECODE_LM, PAGED_BEAM
    spec = LMSpec(vocab_size=c["vocab"], d_model=c["d_model"],
                  n_layers=c["n_layers"], num_heads=c["num_heads"],
                  max_len=c["max_len"])
    model = TransformerLM.from_jax_params(spec, params, "cuda")
    eng = PagedGenerationEngine(spec, model, slots=b["slots"],
                                page_size=b["page_size"],
                                beam_width=c["beam"], device="cuda")
    t0 = time.perf_counter()
    ids, scores = eng.generate_beam(prompts[0], beam_size=c["beam"],
                                    max_new_tokens=c["new"],
                                    length_penalty=c["penalty"])
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    same = bool(np.array_equal(ids[0], beams[0, 0]))
    print(f"decode plane (b): generate_beam (beam {c['beam']}, {c['new']} "
          f"new tokens, prompt {prompts.shape[1]}) in {solo_s:.2f} s: best "
          f"beam {'equals' if same else 'DIFFERS from'} (a)'s op; scores "
          f"{[round(float(s), 4) for s in scores]}")
    assert same, (ids[0, -c["new"]:], beams[0, 0, -c["new"]:])
    forks0 = eng.metrics.counter("beam_forks")
    rng = np.random.RandomState(SEED + 22)
    wave = []
    for i in range(b["greedy"] + b["beams"]):
        p = rng.randint(0, c["vocab"], rng.randint(*b["prompt"])).astype(
            np.int64)
        beam = i % 2 == 1
        wave.append((p, dict(max_new_tokens=b["new"], **(
            {"beam_size": c["beam"], "return_beams": True,
             "length_penalty": c["penalty"]} if beam else {}))))
    steps0 = eng.metrics.counter("decode_steps")
    srv = Server([eng]).start()
    try:
        t0 = time.perf_counter()
        futs = [srv.submit({"prompt": p}, **meta) for p, meta in wave]
        results = [f.result(timeout=600) for f in futs]
        wall_s = time.perf_counter() - t0
    finally:
        srv.stop()
    for (p, meta), r in zip(wave, results):
        if "beam_size" in meta:
            rid, rsc = r
            assert rid.shape == (c["beam"], p.size + b["new"]), rid.shape
            assert (rid[:, :p.size] == p).all() and np.isfinite(rsc).all()
        else:
            assert r.shape == (p.size + b["new"],) and (r[:p.size] == p).all()
    snap = eng.metrics.snapshot()
    counters = snap["counters"]
    forks = counters["beam_forks"] - forks0
    shared = counters["beam_shared_pages"]
    assert forks > 0 and shared > 0, counters
    assert len(eng._static_top) == 2, "the graph has no beam plane"
    assert counters["decode_graph_captures"] == 1, counters
    eng._decode_step_replay(eng._neutral_decode_feed())  # scrap page only
    replay_ms = _cuda_ms(eng._graph.replay, iters=10)
    rec = {"config": b, "best_beam_equals_op": same, "solo_s": solo_s,
           "wave_s": wall_s, "beam_forks": forks,
           "beam_shared_pages": shared,
           "beam_parked": counters.get("beam_parked", 0),
           "decode_steps": counters["decode_steps"] - steps0,
           "decode_step_ms_mean": snap["latency"]["decode_step_ms"]["mean"],
           "decode_step_replay_device_ms": replay_ms,
           "tpot_ms_p50": snap["hist"]["tpot"]["p50_ms"],
           "ttft_ms_p50": snap["hist"]["ttft"]["p50_ms"]}
    print(f"decode plane (b): {b['greedy']} greedy and {b['beams']} beam-"
          f"{c['beam']} requests in one continuous batch ({b['slots']} "
          f"slots, pages of {b['page_size']}) in {wall_s:.2f} s: "
          f"{forks} forks sharing {shared} pages, {rec['beam_parked']} "
          f"parks; decode step {rec['decode_step_ms_mean']:.2f} ms wall "
          f"(mean over {rec['decode_steps']}), one replay "
          f"{replay_ms:.3f} ms on the card; TPOT p50 "
          f"{rec['tpot_ms_p50']:.2f} ms, TTFT p50 {rec['ttft_ms_p50']:.1f} "
          f"ms (greedy rows) [{smi}]")
    return rec


def _nmt_batch(rng, bs, ts, tt, vocab):
    """demos/nmt_transformer.py's synthetic translation at ``vocab``: the
    target is the source reversed and shifted into the target ids, ended
    by EOS; ids 0 and 1 are BOS and EOS."""
    import numpy as np

    n = rng.randint(3, min(ts, tt - 1) + 1, size=bs)
    src = np.zeros((bs, ts), np.int64)
    slen = n.astype(np.int32)
    tgt_in = np.full((bs, tt), NMT_EOS, np.int64)
    tgt_next = np.full((bs, tt), NMT_EOS, np.int64)
    for i in range(bs):
        s = rng.randint(2, vocab, size=n[i])
        t = ((s[::-1] + NMT_SHIFT) % (vocab - 2)) + 2
        src[i, :n[i]] = s
        tgt_in[i, 0] = NMT_BOS
        tgt_in[i, 1:n[i] + 1] = t
        tgt_next[i, :n[i]] = t
        tgt_next[i, n[i]] = NMT_EOS
    return {"src": src, "slen": slen, "tgt_in": tgt_in, "tgt_next": tgt_next}


def _nmt_program(pt, v_src, v_tgt, d, L, H, ts, tt, lr, d_ff=None):
    """The NMT teacher's training program: (main, startup, loss, logits,
    the for_test clone up to the logits)."""
    from paddle_tpu_torch import layers, models

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        src = layers.data("src", shape=[ts], dtype="int64")
        slen = layers.data("slen", shape=[], dtype="int32")
        tgt_in = layers.data("tgt_in", shape=[tt], dtype="int64")
        tgt_next = layers.data("tgt_next", shape=[tt], dtype="int64")
        logits = models.transformer_nmt_teacher(
            src, slen, tgt_in, src_vocab_size=v_src, tgt_vocab_size=v_tgt,
            d_model=d, n_layers=L, num_heads=H, d_ff=d_ff,
            max_src_len=ts, max_tgt_len=tt)
        test = main.clone(for_test=True)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.reshape(logits, shape=[-1, v_tgt]),
            layers.reshape(tgt_next, shape=[-1, 1])))
        pt.optimizer.AdamOptimizer(learning_rate=lr).minimize(
            loss, startup_program=startup)
    return main, startup, loss, logits, test


def _nmt_train(pt, fa, c, amp, smi):
    """c["steps"] timed Transformer-base steps (f32 or under AMP) from a
    fresh startup: (record, scope, test program, logits)."""
    import numpy as np
    import torch

    L, ts = c["n_layers"], c["max_len"]
    with (_Amp() if amp else contextlib.nullcontext()):
        main, startup, loss, logits, test = _nmt_program(
            pt, c["vocab"], c["vocab"], c["d_model"], L, c["num_heads"], ts,
            ts, c["lr"], c["d_ff"])
        startup.random_seed = SEED
        scope = pt.Scope()
        exe = pt.Executor(pt.CUDAPlace(0))
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(SEED + 23)
        feeds = [_nmt_batch(rng, c["batch"], ts, ts, c["vocab"])
                 for _ in range(c["steps"])]
        torch.cuda.reset_peak_memory_stats()
        _reset_flash_counts(fa)
        losses, step_ms = [], []
        for feed in feeds:
            t0 = time.perf_counter()
            lo, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(lo)))
        counts = _flash_counts(fa)
        peak = torch.cuda.max_memory_allocated()
        state = _snapshot(scope)
        anatomy = _one_step_anatomy(lambda: exe.run(
            main, feed=feeds[-1], fetch_list=[loss], scope=scope))
        _restore(scope, state)
    tag = "AMP" if amp else "f32"
    tokens = c["batch"] * ts
    med = float(np.median(step_ms[1:]))
    rec = {"losses": losses, "step_ms": step_ms, "ms_median": med,
           "device_ms": anatomy["device_ms"],
           "kernel_launches": anatomy["launches"],
           "flash_launches": list(counts), "peak_mem_bytes": peak,
           "tgt_tokens_per_s": tokens / med * 1e3,
           "tokens_per_s": 2 * tokens / med * 1e3}
    print(f"decode plane (c) Transformer-base {tag}: {c['steps']} Adam steps "
          f"of {c['batch']} x ({ts} source + {ts} target) tokens, losses "
          f"{[round(x, 4) for x in losses]}; {step_ms[0]:.1f} ms the first, "
          f"{med:.1f} ms median of the rest, one step "
          f"{anatomy['wall_ms']:.1f} ms wall, device "
          f"{_ms_text(anatomy['device_ms'], '.1f')} ms in "
          f"{anatomy['launches']} launches; {rec['tgt_tokens_per_s']:.0f} "
          f"target tokens/s ({rec['tokens_per_s']:.0f} with the source); "
          f"peak {peak / 2 ** 30:.2f} GiB; flash fwd/dq/dkv launches "
          f"{list(counts[:3])} f32, {list(counts[3:])} bf16 [{smi}]")
    assert np.isfinite(losses).all(), losses
    # the decoder's six self-attentions: the teacher op casts q/k/v back
    # to the activations' f32 under AMP too, as the JAX op does, so the
    # f32 instances run in both
    assert counts == (c["steps"] * L,) * 3 + (0, 0, 0), counts
    return rec, scope, test, logits


def _teacher_forced_gate(pt, c, scope, test, logits, srcs, outs):
    """Each served translation against the teacher op re-run on its own
    tokens (one batched forward): every generated token must be the
    teacher's argmax at its position, but at a near tie (the top two
    within NEAR_TIE_RTOL, relative). Returns (positions, near ties)."""
    import numpy as np

    ts = c["max_len"]
    n = len(srcs)
    src = np.zeros((n, ts), np.int64)
    tgt = np.full((n, ts), NMT_EOS, np.int64)
    for i, (s, o) in enumerate(zip(srcs, outs)):
        src[i, :s.size] = s
        tgt[i, :o.size] = o
    lo, = pt.Executor(pt.CUDAPlace(0)).run(
        test, feed={"src": src, "slen": np.asarray([s.size for s in srcs],
                                                   np.int32),
                    "tgt_in": tgt}, fetch_list=[logits], scope=scope)
    lo = np.asarray(lo, np.float64)
    checked, ties = 0, 0
    for i, o in enumerate(outs):
        for j in range(o.size - 1):
            row = lo[i, j]
            top = np.argsort(-row, kind="stable")[:2]
            checked += 1
            if top[0] == o[j + 1]:
                continue
            rel = (row[top[0]] - row[top[1]]) / abs(row[top[0]])
            assert top[1] == o[j + 1] and rel <= NEAR_TIE_RTOL, (
                i, j, o[j + 1], top, rel)
            ties += 1
    return checked, ties


def nmt_base_part(pt, fa, smi):
    """(c): Transformer-base trained in f32 and under AMP, then served."""
    import numpy as np
    import torch

    from paddle_tpu_torch.decoding import Seq2SeqGenerationEngine, Seq2SeqSpec

    c = NMT_BASE
    rec = {"config": c}
    rec["amp"], *_ = _nmt_train(pt, fa, c, True, smi)
    torch.cuda.empty_cache()
    rec["f32"], scope, test, logits = _nmt_train(pt, fa, c, False, smi)
    spec = Seq2SeqSpec(src_vocab_size=c["vocab"], tgt_vocab_size=c["vocab"],
                       d_model=c["d_model"], n_layers=c["n_layers"],
                       num_heads=c["num_heads"], d_ff=c["d_ff"],
                       max_src_len=c["max_len"], max_tgt_len=c["max_len"])
    t0 = time.perf_counter()
    eng = Seq2SeqGenerationEngine(spec, scope, slots=c["slots"],
                                  page_size=c["page_size"],
                                  beam_width=c["beam"], bos_id=NMT_BOS)
    combos = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 24)
    srcs = [rng.randint(2, c["vocab"], rng.randint(*c["src_len"])).astype(
        np.int64) for _ in range(c["sources"])]
    # no eos: three steps teach the model EOS first (the padded targets'
    # most frequent id), so every request decodes its c["new"] tokens
    t0 = time.perf_counter()
    outs = eng.translate(srcs, max_new_tokens=c["new"])
    translate_s = time.perf_counter() - t0
    encodes = eng.metrics.counter("encodes")
    assert encodes == len(srcs), encodes
    for o in outs:
        assert o[0] == NMT_BOS and o.size == c["new"] + 1, o
        assert ((o >= 0) & (o < c["vocab"])).all()
    checked, ties = _teacher_forced_gate(pt, c, scope, test, logits, srcs,
                                         outs)
    snap = eng.metrics.snapshot()
    t0 = time.perf_counter()
    ids, scores = eng.translate_beam(srcs[0], beam_size=c["beam"],
                                     max_new_tokens=c["new"],
                                     length_penalty=c["penalty"])
    beam_s = time.perf_counter() - t0
    forks = eng.metrics.counter("beam_forks")
    assert ids.shape[0] == c["beam"] and np.isfinite(scores).all(), ids.shape
    assert forks > 0 and eng.metrics.counter("encodes") == len(srcs) + 1
    assert int(eng._xrow_ref.sum()) == 0 and eng.pool.pages_in_use() == 0
    rec["serving"] = {
        "warmup_shapes": combos, "warmup_s": warm_s,
        "translate_s": translate_s, "sources": len(srcs),
        "generated_tokens": int(sum(o.size - 1 for o in outs)),
        "encodes": encodes,
        "encode_batches": snap["counters"]["encode_batches"],
        "teacher_checked": checked, "near_ties": ties,
        "ttft_ms_p50": snap["hist"]["ttft"]["p50_ms"],
        "tpot_ms_p50": snap["hist"]["tpot"]["p50_ms"],
        "decode_step_ms_mean": snap["latency"]["decode_step_ms"]["mean"],
        "encode_ms_mean": snap["latency"]["encode_ms"]["mean"],
        "beam_s": beam_s, "beam_forks": forks,
        "beam_shared_pages": eng.metrics.counter("beam_shared_pages"),
        "beam_scores": [float(s) for s in scores]}
    s = rec["serving"]
    print(f"decode plane (c) serving: warmup {combos} shapes {warm_s:.1f} s; "
          f"translate {len(srcs)} sources of {c['src_len'][0]}-"
          f"{c['src_len'][1] - 1} tokens, {s['generated_tokens']} target "
          f"tokens in {translate_s:.2f} s, {encodes} encodes in "
          f"{s['encode_batches']} batches (mean {s['encode_ms_mean']:.1f} "
          f"ms); TTFT p50 {s['ttft_ms_p50']:.1f} ms, TPOT p50 "
          f"{s['tpot_ms_p50']:.2f} ms, decode step {s['decode_step_ms_mean']:.2f}"
          f" ms wall; every token the teacher's argmax re-run on the card "
          f"({checked} positions, {ties} near ties); translate_beam (beam "
          f"{c['beam']}) in {beam_s:.2f} s, {forks} forks sharing "
          f"{s['beam_shared_pages']} pages [{smi}]")
    return rec


def lm_demo_part(pt, fa, smi):
    """(d) demos/transformer_lm.py at its size: its training loop, then
    greedy, beam and speculative decoding of the trained weights (the
    draft head a copy of the target's, as the demo sets it)."""
    import numpy as np

    from paddle_tpu_torch import layers, models

    c = LM_DEMO
    T, V = c["T"], c["vocab"]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = layers.data("ids", shape=[T], dtype="int64")
        tgt = layers.data("tgt", shape=[T], dtype="int64")
        logits = models.transformer_lm(
            ids, vocab_size=V, d_model=c["d_model"], n_layers=c["n_layers"],
            num_heads=c["heads"], max_len=2 * T, pipeline_stack=True)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.reshape(logits, shape=[-1, V]),
            layers.reshape(tgt, shape=[-1, 1])))
        pt.optimizer.AdamOptimizer(learning_rate=c["lr"]).minimize(
            loss, startup_program=startup)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = []
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        seq = _gpt_corpus(rng, V, c["batch"], T, mult=3)
        lo, = exe.run(main, feed={"ids": seq[:, :-1], "tgt": seq[:, 1:]},
                      fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lo)))
    train_s = time.perf_counter() - t0
    dc = dict(vocab=V, d_model=c["d_model"], n_layers=c["n_layers"],
              num_heads=c["heads"], max_len=2 * T, new=c["new"],
              beam=c["beam"], penalty=0.0, draft_layers=c["draft_layers"],
              gamma=c["gamma"])
    for name, src in (("draft_head.w", "lm_head.w"),
                      ("draft_ln.scale", "final_ln.scale"),
                      ("draft_ln.bias", "final_ln.bias")):
        scope.set(name, scope.get(src).clone())
    ctx = _gpt_corpus(rng, V, 1, T, mult=3)[:, :-1]
    got = {}
    for kind in ("greedy", "beam", "speculative"):
        prog, fetch = _lm_decoder_program(pt, dc, kind, T)
        got[kind] = [np.asarray(x) for x in exe.run(
            prog, feed={"prompt": ctx}, fetch_list=fetch, scope=scope)]
    gen = got["greedy"][0]
    sp, rounds = got["speculative"]
    ties = _greedy_gate(scope, c["heads"], ctx, gen, sp, "demo speculative")
    tail = gen[0, -(c["new"] + 1):]
    ok = sum(int(tail[i + 1]) in {(3 * int(tail[i])) % V,
                                  (3 * int(tail[i]) + 1) % V}
             for i in range(c["new"]))
    bm, sc = got["beam"]
    rec = {"losses_first_last": [losses[0], losses[-1]], "train_s": train_s,
           "rule_consistent": ok, "rounds": int(rounds.reshape(-1)[0]),
           "near_ties": ties, "beam_best": bm[0, 0, -c["new"]:].tolist(),
           "beam_scores": sc[0].tolist()}
    print(f"decode plane (d) transformer_lm demo: {c['steps']} steps in "
          f"{train_s:.1f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"greedy {gen[0, -c['new']:].tolist()} ({ok}/{c['new']} "
          f"rule-consistent); beam best {rec['beam_best']} (score "
          f"{sc[0, 0]:.2f}); speculative = greedy ({len(ties)} near ties) "
          f"in {rec['rounds']} verify rounds against {c['new']} [{smi}]")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    return rec


def nmt_demo_part(pt, fa, smi):
    """(d) demos/nmt_transformer.py at its size, cut as its FAST mode
    (NMT_DEMO): its training steps, then greedy and beam translation
    through Seq2SeqGenerationEngine."""
    import numpy as np

    from paddle_tpu_torch.decoding import Seq2SeqGenerationEngine, Seq2SeqSpec

    c = NMT_DEMO
    ts, tt, V = c["ts"], c["tt"], c["tgt_v"]
    main, startup, loss, _, _ = _nmt_program(
        pt, c["src_v"], V, c["d_model"], c["n_layers"], c["heads"], ts, tt,
        c["lr"])
    startup.random_seed = 9
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    hist = []
    _reset_flash_counts(fa)
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        feed = _nmt_batch(rng, c["batch"], ts, tt, V)
        lo, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        hist.append(float(np.asarray(lo)))
    train_s = time.perf_counter() - t0
    counts = _flash_counts(fa)
    spec = Seq2SeqSpec(src_vocab_size=c["src_v"], tgt_vocab_size=V,
                       d_model=c["d_model"], n_layers=c["n_layers"],
                       num_heads=c["heads"], max_src_len=ts, max_tgt_len=tt)
    eng = Seq2SeqGenerationEngine(spec, scope, slots=c["slots"],
                                  page_size=c["page_size"], bos_id=NMT_BOS,
                                  beam_width=4, default_max_new_tokens=tt - 1)
    srcs = [rng.randint(2, c["src_v"], size=rng.randint(3, 9)).astype(
        np.int64) for _ in range(4)]
    greedy = eng.translate(srcs, eos_id=NMT_EOS)
    ids, scores = eng.translate_beam(srcs[0], beam_size=4, eos_id=NMT_EOS,
                                     length_penalty=0.6)
    rec = {"steps": c["steps"], "train_s": train_s,
           "ms_per_step": train_s / c["steps"] * 1e3,
           "loss_first_last": [hist[0], hist[-1]],
           "flash_launches": list(counts[:3]),
           "beam_forks": eng.metrics.counter("beam_forks"),
           "encodes": eng.metrics.counter("encodes")}
    for s, g in zip(srcs, greedy):
        print(f"decode plane (d) nmt_transformer demo: src={s.tolist()} -> "
              f"greedy={g[1:].tolist()}")
    print(f"decode plane (d) nmt_transformer demo: {c['steps']} steps in "
          f"{train_s:.1f} s ({rec['ms_per_step']:.1f} ms a step), loss "
          f"{hist[0]:.3f} -> {hist[-1]:.3f}; beam0 {ids[0, 1:].tolist()} "
          f"score {scores[0]:.3f}, {rec['beam_forks']} forks, "
          f"{rec['encodes']} encodes; flash fwd/dq/dkv {list(counts[:3])} "
          f"[{smi}]")
    assert np.isfinite(hist).all(), hist
    assert ids.shape[0] == 4
    assert counts == (c["steps"] * c["n_layers"],) * 3 + (0, 0, 0), counts
    return rec


def decode_plane_phase(smi):
    """Phase 21 (a)-(d) under the precision policy highest. Returns its
    record; "launches" holds the flash kernels' counts on its paths."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.kernels import flash_attention as fa

    flags.parse_flags(["--mxu_precision=highest"])
    seconds = [time.perf_counter()]
    out = {}
    out["a"], beams, prompts, params = lm_decoders_part(pt, fa, smi)
    seconds.append(time.perf_counter())
    out["b"] = paged_beam_part(pt, smi, beams, prompts, params)
    del beams, params
    torch.cuda.empty_cache()
    seconds.append(time.perf_counter())
    out["c"] = nmt_base_part(pt, fa, smi)
    torch.cuda.empty_cache()
    seconds.append(time.perf_counter())
    out["d"] = {"transformer_lm": lm_demo_part(pt, fa, smi),
                "nmt_transformer": nmt_demo_part(pt, fa, smi)}
    seconds.append(time.perf_counter())
    out["seconds"] = [b - a for a, b in zip(seconds, seconds[1:])]
    print("phase 21 seconds: " + ", ".join(
        f"{part} {s:.1f}" for part, s in zip(("(a)", "(b)", "(c)", "(d)"),
                                              out["seconds"]))
        + f"; {sum(out['seconds']):.1f} in all [{smi}]")
    return out


def phase21_launches(records, plane):
    """The flash records' launches on phase 21's paths: each one-shot
    decoder's prefill (a), a Transformer-base step in f32 and under AMP
    (c); the bf16 instances none (the teacher op's q/k/v stay f32 under
    AMP, as in the JAX op)."""
    steps = NMT_BASE["steps"]
    per_step = {p: [n // steps for n in plane["c"][k]["flash_launches"]]
                for p, k in (("f32", "f32"), ("AMP", "amp"))}
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    names = names + tuple(n + "_bf16" for n in names)
    for rec in records:
        if rec["name"] not in names:
            continue
        i = names.index(rec["name"])
        paths = {f"Transformer-base step, {p}": v[i]
                 for p, v in per_step.items()}
        if i == 0:
            paths.update({f"d1024 LM {k} prefill":
                          plane["a"][k]["flash_launches"]
                          for k in ("beam", "speculative", "greedy")})
        rec["launches_phase21"] = paths


# --- phase 22: the row-sparse gradient plane and Wide&Deep CTR --------------
# (a) bench.py's online row, part (a) (bench_online): one embedding at
# V 10^6, D 16 over 8 slots, a mean loss, Adagrad at lr 0.05, its dense
# and its sparse step at batch 128 and 32 from one state. (b) Wide&Deep
# CTR (BASELINE.json configs[5]; models/wide_deep.py's defaults, embed_dim
# 16 and hidden (64, 32)) at V 10^6 over dataset.ctr's 8 slots and 4
# dense features, batch 512, is_sparse, Adagrad 0.05, random weights from
# SEED. (c) its program pruned to ids, dense -> prob (demos/online_ctr.py)
# served by InferenceEngine. (d) demos/quick_start.py lr through the v2
# facade at its FAST size (256 samples, one pass: 4 batches of 64). (e)
# the seven metric ops and addto at Wide&Deep's batch.
ONLINE = dict(vocab=10 ** 6, dim=16, slots=8, lr=0.05, batches=(128, 32),
              timed=20)
WIDE_DEEP = dict(vocab=10 ** 6, embed=16, hidden=(64, 32), batch=512,
                 lr=0.05, steps=200, auc_steps=50, dense_steps=10)
CTR_SERVE = dict(batches=(1, 64), timed=200)
QS_LR = dict(passes=1, batch=64, samples=256, test=64)
CTR_CPU_STEPS = 5
CTR_LOSS_RTOL = 1e-4   # the card's first losses against the port's CPU run
ONLINE_ROW_RTOL = 1e-6  # sparse-step touched rows against the dense step's
CTR_AUC_FLOOR = 0.65   # tests/test_sparse_embedding.py's bar
SERVE_ATOL = 1e-6      # served probabilities against the executor's forward
METRIC_RTOL = 1e-5     # float metric outputs against the CPU's (counts exact)


def _kernel_counters():
    """Every launch counter of the six kernels' wrappers, by name."""
    from paddle_tpu_torch.kernels import conv_epilogue as ke
    from paddle_tpu_torch.kernels import flash_attention as fa

    out = {"flash_attention." + k: getattr(fa.flash_attention, k)
           for k in ("launches", "bf16_launches")}
    out.update({"flash_backward." + k: getattr(fa.flash_backward, k)
                for k in ("dq_launches", "dkv_launches", "dq_bf16_launches",
                          "dkv_bf16_launches")})
    for n in CONV_KERNELS:
        for k in ("launches", "bf16_launches", "tf32_launches"):
            if hasattr(getattr(ke, n), k):
                out[f"{n}.{k}"] = getattr(getattr(ke, n), k)
    return out


def _scope_copy(pt, scope, device):
    """A new scope holding copies of ``scope``'s tensors on ``device``
    (the programs copied run no op that draws)."""
    new = pt.Scope()
    for n, v in _snapshot(scope).items():
        new.set(n, v.to(device))
    return new


def _peak_bytes(step):
    """One step's peak allocation above what was allocated before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _loop_ms(step, n):
    """Wall ms a step over ``n`` steps enqueued back to back, synchronised
    at the end."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _online_program(pt, c, is_sparse):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[c["slots"]], dtype="int64")
        emb = pt.layers.embedding(ids, size=[c["vocab"], c["dim"]],
                                  is_sparse=is_sparse,
                                  param_attr=pt.ParamAttr(name="online.emb"))
        loss = pt.layers.mean(emb)
        pt.optimizer.AdagradOptimizer(learning_rate=c["lr"]).minimize(
            loss, startup_program=startup)
    return main, startup, loss


def online_row_part(pt, smi):
    """(a): the dense against the sparse Adagrad step at V 10^6."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.registry import get_op

    c = ONLINE
    start = pt.Program._uid_counter
    built = {}
    for sparse in (False, True):
        pt.Program._uid_counter = start
        built[sparse] = _online_program(pt, c, sparse)
    assert [op.type for op in built[True][0].global_block.ops].count(
        "sparse_adagrad") == 1
    exe = pt.Executor(pt.CUDAPlace(0))
    scope0 = pt.Scope()
    exe.run(built[True][1], scope=scope0)
    state = _snapshot(scope0)
    table = "online.emb"
    moment = next(n for n in state if n != table
                  and tuple(state[n].shape) == (c["vocab"], c["dim"]))
    resident = sum(t.numel() * t.element_size() for t in state.values())
    vd_bytes = c["vocab"] * c["dim"] * 4
    rng = np.random.RandomState(SEED)
    rec = {"config": c, "resident_bytes": resident, "table_bytes": vd_bytes,
           "rows": {}}
    for b in c["batches"]:
        ids = rng.randint(0, c["vocab"], size=(b, c["slots"])).astype(
            np.int64)
        feed = {"ids": ids}
        row = {}
        scopes = {s: _scope_copy(pt, scope0, "cuda") for s in (False, True)}
        for sparse in (False, True):
            main = built[sparse][0]
            peak = _peak_bytes(lambda: exe.run(
                main, feed=feed, scope=scopes[sparse]))
            row["sparse" if sparse else "dense"] = {"peak_bytes": peak}
        # the gates: one step each from the same state and batch
        touched = torch.zeros(c["vocab"], dtype=torch.bool, device="cuda")
        touched[torch.from_numpy(ids.ravel()).cuda()] = True
        gaps = {}
        for name in (table, moment):
            d, s = scopes[False].get(name), scopes[True].get(name)
            s0 = state[name]
            assert torch.equal(s[~touched], s0[~touched]), (
                f"online (a) b{b}: {name}'s untouched rows moved")
            assert torch.equal(d[~touched], s0[~touched])
            dt, st = d[touched].double(), s[touched].double()
            gaps[name] = float((st - dt).abs().max()
                               / max(float(dt.abs().max()), 1e-30))
            assert gaps[name] <= ONLINE_ROW_RTOL, (name, gaps[name])
        row["touched_rows"] = int(touched.sum())
        row["touched_rel_gap"] = gaps
        assert row["sparse"]["peak_bytes"] < vd_bytes, row
        # the sparse update ops (the lookup's row gradient, the dedup and
        # the scatters) under the sync debugger: a host sync raises
        w, mom = scopes[True].get(table), scopes[True].get(moment)
        og = torch.full((b, c["slots"], c["dim"]), 1.0, device="cuda")
        ids_dev = torch.from_numpy(ids).cuda()
        lr = torch.full((1,), c["lr"], device="cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            g = get_op("lookup_table").grad_fn(
                {"is_sparse": True}, {"W": [w], "Ids": [ids_dev]}, {},
                {"Out": [og]})["W"][0]
            get_op("sparse_adagrad").fn(
                {"epsilon": 1e-6}, {"Param": [w], "Grad": [g],
                                    "Moment": [mom], "LearningRate": [lr]})
            try:  # the whole sparse step, feed on the card, no fetch
                exe.run(built[True][0], feed={"ids": ids_dev},
                        scope=scopes[True])
                row["whole_step_sync_free"] = True
            except RuntimeError as exc:
                row["whole_step_sync_free"] = f"{type(exc).__name__}: {exc}"
        finally:
            torch.cuda.set_sync_debug_mode("default")
        row["update_ops_sync_free"] = True
        # times: wall over back-to-back steps, device and launches of one
        for sparse in (False, True):
            main = built[sparse][0]

            def step(main=main, sparse=sparse):
                exe.run(main, feed=feed, scope=scopes[sparse])

            r = row["sparse" if sparse else "dense"]
            r["wall_ms"] = _loop_ms(step, c["timed"])
            r.update({k: v for k, v in _one_step_anatomy(step).items()
                      if k != "wall_ms"})
            r["device_ms"] = _device_ms(step)
        del scopes
        torch.cuda.empty_cache()
        rec["rows"][b] = row
        d, s = row["dense"], row["sparse"]
        print(f"ctr (a) online row, batch {b} ({row['touched_rows']} of "
              f"{c['vocab']} rows touched): dense step {d['wall_ms']:.3f} "
              f"ms wall, {_ms_text(d['device_ms'])} ms device, "
              f"{d['launches']} launches, peak {d['peak_bytes'] / 2**20:.1f}"
              f" MiB above the resident state; sparse step "
              f"{s['wall_ms']:.3f} ms wall, {_ms_text(s['device_ms'])} ms "
              f"device, {s['launches']} launches, peak "
              f"{s['peak_bytes'] / 2**20:.2f} MiB (< one [V, D] table, "
              f"{vd_bytes / 2**20:.0f} MiB); untouched rows and moments "
              f"bit for bit, touched within {max(gaps.values()):.1e} of "
              f"the dense step's (tol {ONLINE_ROW_RTOL}); update ops "
              f"sync-free, whole step sync-free: "
              f"{row['whole_step_sync_free']} [{smi}]")
    del scope0, state
    torch.cuda.empty_cache()
    return rec


def _wide_deep_program(pt, c, is_sparse=True):
    ctr = pt.dataset.ctr
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = SEED
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[ctr.SLOTS], dtype="int64")
        dense = pt.layers.data("dense", shape=[ctr.DENSE_DIM])
        label = pt.layers.data("label", shape=[1])
        logit = pt.models.wide_deep(ids, dense, vocab_size=c["vocab"],
                                    embed_dim=c["embed"],
                                    hidden_sizes=c["hidden"],
                                    is_sparse=is_sparse)
        loss, prob = pt.models.wide_deep_loss(logit, label)
        auc = pt.evaluator.Auc(prob, label, main_program=main,
                               startup_program=startup)
        pt.optimizer.AdagradOptimizer(learning_rate=c["lr"]).minimize(
            loss, startup_program=startup)
    return dict(main=main, startup=startup, loss=loss, prob=prob, auc=auc)


def _ctr_batches(pt, n, batch, vocab, seed="ctr-train"):
    ctr = pt.dataset.ctr
    rows = list(ctr.train(n * batch, vocab=vocab, seed=seed)())
    return [ctr.make_batch(rows[i * batch:(i + 1) * batch])
            for i in range(n)]


def wide_deep_part(pt, smi):
    """(b): Wide&Deep trained on the card; returns (its record, the
    program, the trained scope)."""
    import numpy as np
    import torch

    c = WIDE_DEEP
    t0 = time.perf_counter()
    batches = _ctr_batches(pt, c["steps"], c["batch"], c["vocab"])
    data_s = time.perf_counter() - t0
    start = pt.Program._uid_counter
    w = _wide_deep_program(pt, c)
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(w["startup"], scope=scope)
    cpu_scope = _scope_copy(pt, scope, "cpu")
    cpu_exe = pt.Executor(pt.CPUPlace())
    cpu_losses = [float(cpu_exe.run(w["main"], feed=f, fetch_list=[w["loss"]],
                                    scope=cpu_scope)[0])
                  for f in batches[:CTR_CPU_STEPS]]
    del cpu_scope
    resident = sum(t.numel() * t.element_size()
                   for t in _snapshot(scope).values())
    losses, stamps = [], []
    t0 = time.perf_counter()
    for step, feed in enumerate(batches):
        if step == c["steps"] - c["auc_steps"]:
            w["auc"].reset(exe, scope)
        losses.append(float(exe.run(w["main"], feed=feed,
                                    fetch_list=[w["loss"]], scope=scope)[0]))
        stamps.append(time.perf_counter())
    loop_s = time.perf_counter() - t0
    auc = w["auc"].eval(exe, scope)
    first = np.array(losses[:CTR_CPU_STEPS])
    loss_rel = float(np.max(np.abs(first - cpu_losses) / np.abs(cpu_losses)))
    head, tail = np.mean(losses[:20]), np.mean(losses[-20:])
    feed = batches[-1]

    def step(main=w["main"], scope=scope):
        exe.run(main, feed=feed, scope=scope)

    peak = _peak_bytes(step)
    anatomy = _one_step_anatomy(step)
    rec = {"config": c, "data_s": data_s, "loop_s": loop_s,
           "ms_per_step": float(np.median(np.diff(stamps)) * 1e3),
           "first_losses": first.tolist(), "cpu_first_losses": cpu_losses,
           "loss_rel_vs_cpu": loss_rel, "loss_head": float(head),
           "loss_tail": float(tail), "auc_last": auc,
           "resident_bytes": resident, "peak_bytes": peak,
           "anatomy": anatomy, "device_ms": _device_ms(step)}
    # the same model with dense embedding gradients, from the same weights
    # (built under the same names)
    pt.Program._uid_counter = start
    d = _wide_deep_program(pt, c, is_sparse=False)
    dscope = _scope_copy(pt, scope, "cuda")
    dfeeds = itertools.cycle(batches[:c["dense_steps"]])

    def dstep(main=d["main"]):
        exe.run(main, feed=next(dfeeds), scope=dscope)

    dpeak = _peak_bytes(dstep)
    rec["dense_grad"] = {"ms_per_step": _loop_ms(dstep, c["dense_steps"]),
                         "peak_bytes": dpeak,
                         "anatomy": _one_step_anatomy(dstep),
                         "device_ms": _device_ms(dstep, iters=3)}
    del dscope, d
    torch.cuda.empty_cache()
    dr = rec["dense_grad"]
    print(f"ctr (b) Wide&Deep V {c['vocab']} d{c['embed']} {c['hidden']} "
          f"batch {c['batch']}: {c['steps']} steps in {loop_s:.1f} s, "
          f"{rec['ms_per_step']:.3f} ms a step (median wall with the loss "
          f"fetch), one step {anatomy['wall_ms']:.3f} ms wall, "
          f"{_ms_text(rec['device_ms'])} ms device in "
          f"{anatomy['launches']} launches, peak "
          f"{peak / 2**20:.1f} MiB above the resident "
          f"{resident / 2**20:.0f} MiB; first {CTR_CPU_STEPS} losses "
          f"{np.round(first, 6).tolist()} within {loss_rel:.2e} of the "
          f"CPU's (tol {CTR_LOSS_RTOL}); loss {head:.4f} -> {tail:.4f} "
          f"(first and last 20 steps); AUC over the last {c['auc_steps']} "
          f"steps {auc:.4f} (floor {CTR_AUC_FLOOR}); is_sparse=False: "
          f"{dr['ms_per_step']:.3f} ms a step wall, "
          f"{_ms_text(dr['device_ms'])} ms device in "
          f"{dr['anatomy']['launches']} launches, peak "
          f"{dpeak / 2**20:.1f} MiB [{smi}]")
    assert np.isfinite(losses).all(), losses[-5:]
    assert loss_rel <= CTR_LOSS_RTOL, (first, cpu_losses)
    assert tail < head, (head, tail)
    assert auc > CTR_AUC_FLOOR, auc
    return rec, w, scope


def ctr_serving_part(pt, w, scope, smi):
    """(c): the pruned program served through InferenceEngine."""
    import numpy as np

    c = CTR_SERVE
    prob = w["prob"].name
    serve = pt.io.prune_program(w["main"], ["ids", "dense"], [prob])
    assert not any(op.type.startswith(("sparse_", "adagrad", "auc"))
                   for op in serve.global_block.ops)
    eng = pt.InferenceEngine(program=serve, feed_names=["ids", "dense"],
                             fetch_names=[prob], scope=scope,
                             batch_buckets=c["batches"],
                             place=pt.CUDAPlace(0))
    eng.warmup()
    exe = pt.Executor(pt.CUDAPlace(0))
    held = _ctr_batches(pt, 1, max(c["batches"]), WIDE_DEEP["vocab"],
                        seed="ctr-serve")[0]
    rec = {"config": c, "p50_ms": {}}
    gap = 0.0
    for b in c["batches"]:
        feed = {k: held[k][:b] for k in ("ids", "dense")}
        got = eng.run(feed)[0]
        want = exe.run(serve, feed=feed, fetch_list=[prob], scope=scope)[0]
        gap = max(gap, float(np.abs(got - want).max()))
        lat = []
        for _ in range(c["timed"]):
            t0 = time.perf_counter()
            eng.run(feed)
            lat.append((time.perf_counter() - t0) * 1e3)
        rec["p50_ms"][b] = float(np.median(lat))
    rec["max_abs_gap"] = gap
    probs = eng.run({k: held[k] for k in ("ids", "dense")})[0].ravel()
    labels = held["label"].ravel() > 0.5
    order = np.argsort(probs)
    ranks = np.empty(len(probs))
    ranks[order] = np.arange(1, len(probs) + 1)
    n_pos, n_neg = labels.sum(), (~labels).sum()
    rec["held_out_auc"] = float((ranks[labels].sum() - n_pos * (n_pos + 1)
                                 / 2) / max(n_pos * n_neg, 1))
    eng.close()
    print(f"ctr (c) serving ids, dense -> prob through InferenceEngine "
          f"(CUDA graphs, buckets {c['batches']}): p50 "
          + ", ".join(f"{rec['p50_ms'][b]:.3f} ms at batch {b}"
                      for b in c["batches"])
          + f" over {c['timed']} requests; served probabilities within "
          f"{gap:.1e} of the executor's forward (tol {SERVE_ATOL}); "
          f"held-out AUC of {max(c['batches'])} rows "
          f"{rec['held_out_auc']:.4f} [{smi}]")
    assert gap <= SERVE_ATOL, gap
    return rec


def _metric_cases(rng):
    """(op, attrs, ins, out slots, exact) at Wide&Deep's batch."""
    import numpy as np

    b = WIDE_DEEP["batch"]
    prob = rng.rand(b, 1).astype(np.float32)
    label = (rng.rand(b, 1) < 0.3).astype(np.float32)
    scores = rng.rand(b, 2).astype(np.float32)
    cls = rng.randint(0, 2, (b, 1)).astype(np.int64)
    q, L = 64, 32
    qscore = (rng.randint(0, 16, (q, L)) / 15.0).astype(np.float32)
    qlen = rng.randint(1, L + 1, q).astype(np.int64)
    x = [rng.randn(b, 64).astype(np.float32) for _ in range(3)]
    return [
        ("confusion_counts", {"num_classes": 2},
         {"Pred": [scores], "Label": [cls]}, ("TP", "FP", "FN"), True),
        ("auc_histogram", {"num_thresholds": 200},
         {"Score": [prob], "Label": [label]}, ("Pos", "Neg"), True),
        ("rank_auc", {}, {"Score": [qscore], "Click": [
            rng.randint(0, 2, (q, L)).astype(np.float32)], "Length": [qlen]},
         ("AucSum", "QueryCount"), False),
        ("pnpair_counts", {}, {"Score": [qscore], "Label": [
            rng.randint(0, 3, (q, L)).astype(np.float32)],
            "Weight": [rng.rand(q, L).astype(np.float32)],
            "Length": [qlen]}, ("Pos", "Neg", "Spe"), False),
        ("precision_recall", {"num_classes": 2},
         {"Pred": [scores], "Label": [cls]},
         ("BatchMetrics", "ClassPrecision", "ClassRecall"), False),
        ("auc", {"num_thresholds": 200}, {"Out": [prob], "Label": [label]},
         ("AUC",), False),
        ("positive_negative_pair", {}, {
            "Score": [prob.ravel()], "Label": [label.ravel()],
            "QueryID": [rng.randint(0, 16, b).astype(np.int64)]},
         ("PositivePair", "NegativePair", "NeutralPair"), True),
        ("addto", {}, {"X": x}, ("Out",), True),
    ]


def metric_ops_part(smi):
    """(e): the seven metric ops and addto on the card against the CPU."""
    import numpy as np
    import torch

    rec = {}
    for op, attrs, ins, slots, exact in _metric_cases(
            np.random.RandomState(SEED)):
        card, cpu, _, _, ms = _op_pair(op, attrs, ins, slots)
        gap = max(_rel(card[s].double(), cpu[s].double()) for s in slots)
        same = all(torch.equal(card[s], cpu[s]) for s in slots)
        rec[op] = {"rel_gap": gap, "bitwise": same, "ms": ms}
        assert (same if exact else gap <= METRIC_RTOL), (op, gap)
    said = {op: "exact" if r["bitwise"] else format(r["rel_gap"], ".1e")
            for op, r in rec.items()}
    print("ctr (e) metric ops and addto on the card against the CPU: "
          + ", ".join(f"{op} {v}" for op, v in said.items())
          + f" (counts exact, floats within {METRIC_RTOL}) [{smi}]")
    return rec


def ctr_phase(smi):
    """Phase 22 (a)-(e) under the precision policy highest. Returns its
    record; "kernel_launches" is the six kernels' launches over it (0)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import flags

    flags.parse_flags(["--mxu_precision=highest"])
    before = _kernel_counters()
    seconds = [time.perf_counter()]
    out = {"a": online_row_part(pt, smi)}
    seconds.append(time.perf_counter())
    out["b"], w, scope = wide_deep_part(pt, smi)
    seconds.append(time.perf_counter())
    out["c"] = ctr_serving_part(pt, w, scope, smi)
    del w, scope
    torch.cuda.empty_cache()
    seconds.append(time.perf_counter())
    import paddle_tpu_torch.v2 as paddle

    try:
        out["d"] = _v2_demo(pt, "quick_start_lr", smi, c=QS_LR,
                            label="ctr (d)")
    finally:
        paddle.init()
    seconds.append(time.perf_counter())
    out["e"] = metric_ops_part(smi)
    seconds.append(time.perf_counter())
    after = _kernel_counters()
    out["kernel_launches"] = {k: after[k] - before[k] for k in after}
    assert not any(out["kernel_launches"].values()), out["kernel_launches"]
    out["seconds"] = [b - a for a, b in zip(seconds, seconds[1:])]
    print("phase 22 seconds: " + ", ".join(
        f"{part} {s:.1f}" for part, s in zip(("(a)", "(b)", "(c)", "(d)",
                                              "(e)"), out["seconds"]))
        + f"; {sum(out['seconds']):.1f} in all; the six kernels launched "
        f"0 times [{smi}]")
    return out


def phase22_launches(records, plane):
    """Every kernel record's launches on phase 22's paths: none of the
    six kernels lies on them (asserted in ctr_phase)."""
    total = sum(plane["kernel_launches"].values())
    for rec in records:
        rec["launches_phase22"] = {"phase 22, all paths": total}


def rng_line():
    """Not a check: how many of 10^6 ``normal`` draws from one key differ
    between the card and the CPU (core/prng.py; the CPU's equal
    jax.random.normal's bit for bit)."""
    import torch

    from paddle_tpu_torch.core import prng

    n = 10 ** 6
    cpu = prng.normal(prng.prng_key(SEED), (n,))
    card = prng.normal(prng.prng_key(SEED, "cuda"), (n,)).cpu()
    differ = int((card != cpu).sum())
    gap = float((card - cpu).abs().max())
    print(f"rng: {differ} of {n} normal draws from one key (seed {SEED}) "
          f"differ between the card and the CPU (max |difference| "
          f"{gap:.3e})")
    return {"draws": n, "differ": differ, "max_abs_diff": gap}


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
    parser.add_argument("--bf16-conv-only", action="store_true",
                        help="build the kernels and run only phase 11a (the "
                             "bf16 conv-epilogue kernels against their plain "
                             "versions at ResNet-50's shapes, timed); prints "
                             "no ok line")
    parser.add_argument("--per-layer-only", action="store_true",
                        help="build the kernels and run only phase 12 (the "
                             "bf16 flash kernels and the per-layer LM in f32 "
                             "and under AMP); prints no ok line")
    parser.add_argument("--bf16-flash-only", action="store_true",
                        help="build the kernels and run only phase 12a (the "
                             "bf16 flash kernels against their plain "
                             "versions, timed); prints no ok line")
    parser.add_argument("--per-layer-d512-only", action="store_true",
                        help="build the kernels and run only phase 12e (the "
                             "per-layer LM at d2048 H4, head dim 512, under "
                             "AMP); prints no ok line")
    parser.add_argument("--per-layer-d1024-only", action="store_true",
                        help="build the kernels and run only phase 12f (the "
                             "per-layer LM at d2048 H2, head dim 1024, under "
                             "AMP); prints no ok line")
    parser.add_argument("--bf16-wide-times", action="store_true",
                        help="build the kernels and only time the bf16 "
                             "flash forward, dq and dkv past head dim 128 "
                             "(phase 12a's times at D256, D384, D512, D576 "
                             "and D1024, no checks; it runs an earlier "
                             "commit's instances too); prints no ok line")
    parser.add_argument("--stacked-d256-only", action="store_true",
                        help="build the kernels and run only phase 6b (the "
                             "stacked LM at head dim 256 trained in f32 and "
                             "under AMP, and served); prints no ok line")
    parser.add_argument("--stacked-d512-only", action="store_true",
                        help="build the kernels and run only phase 6c (the "
                             "stacked LM at head dim 512 trained in f32 and "
                             "under AMP, and served); prints no ok line")
    parser.add_argument("--stacked-d1024-only", action="store_true",
                        help="build the kernels and run only phase 6d (the "
                             "stacked LM at head dim 1024 trained in f32 and "
                             "under AMP, and served); prints no ok line")
    parser.add_argument("--f32-wide-times", action="store_true",
                        help="build the kernels and only time the f32 "
                             "flash forward, dq and dkv at head dims 256, "
                             "384, 512, 576 and 1024 beside f32 SDPA (no "
                             "checks; "
                             "it runs an earlier commit's instances too); "
                             "prints no ok line")
    parser.add_argument("--lstm-only", action="store_true",
                        help="build the kernels and run only phase 13 (the "
                             "recurrent rows lstm and lstm_varlen, the "
                             "dynamic_gru twin and the decode row); prints "
                             "no ok line")
    parser.add_argument("--zoo-only", action="store_true",
                        help="build the kernels and run only phase 14 (the "
                             "image-zoo rows and MobileNet served on the "
                             "conv epilogue); prints no ok line")
    parser.add_argument("--trainer-only", action="store_true",
                        help="build the kernels and run only phase 15 (the "
                             "trainer plane: SGD.train of the per-layer LM, "
                             "checkpoints and resume, bench.py's trainer and "
                             "transpiler rows); prints no ok line")
    parser.add_argument("--train-memory-only", action="store_true",
                        help="build the kernels and run only phase 16 (the "
                             "training memory and optimizer plane: remat "
                             "in the per-layer and stacked LMs, gradient "
                             "accumulation, the other optimizers, "
                             "SGD(transpile=True), goodput_overhead); "
                             "prints no ok line")
    parser.add_argument("--demo-ops-only", action="store_true",
                        help="build the kernels and run only phase 17 (the "
                             "slice's ops on the card against the CPU, the "
                             "GAN and VAE demos' full loops); prints no ok "
                             "line")
    parser.add_argument("--book-only", action="store_true",
                        help="build the kernels and run only phase 18 (the "
                             "book plane: the Paddle book chapters, db_lstm "
                             "at the book's widths, the CRF, sequence_conv "
                             "and beam ops against the CPU, the CRF and NMT "
                             "demos); prints no ok line")
    parser.add_argument("--optim-only", action="store_true",
                        help="build the kernels and run only phase 19 (the "
                             "optimizer plane and the chunked fused head: "
                             "gpt_modern's loop, the d1024 fused-head row "
                             "beside the unfused one, the schedule, clip, "
                             "decay, averaging and pruning sweep); prints "
                             "no ok line")
    parser.add_argument("--precision-only", action="store_true",
                        help="build the kernels and run only phase 20 (the "
                             "precision policy: the library products and "
                             "the 1xTF32 conv GEMM kernels, the f32 LM and "
                             "ResNet-50 under default and highest, the "
                             "flags, the engine's keys, the saved dtypes, "
                             "the v2 demos); prints no ok line")
    parser.add_argument("--decode-plane-only", action="store_true",
                        help="build the kernels and run only phase 21 (the "
                             "decode plane: the d1024 LM's beam, "
                             "speculative and greedy decoders, the paged "
                             "beam plane, Transformer-base NMT trained and "
                             "served, the two demos); prints no ok line")
    parser.add_argument("--ctr-only", action="store_true",
                        help="build the kernels and run only phase 22 (the "
                             "row-sparse gradient plane: bench.py's online "
                             "row, Wide&Deep CTR at V 10^6 trained and "
                             "served, quick_start lr, the metric ops); "
                             "prints no ok line")
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
    # phases 1-19 run under the precision policy highest (f32-accurate:
    # full f32 library products, the 3xTF32 conv GEMM kernels), as they
    # ran before the policy was ported; phase 20 runs default and highest
    from paddle_tpu_torch import flags

    flags.parse_flags(["--mxu_precision=highest"])
    print(f"precision: --mxu_precision={flags.FLAGS.mxu_precision} for "
          f"phases 1-19; torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
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
    rng = rng_line()
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_ms_simt", "library_ms")
    if args.bf16_flash_only:
        recs = bf16_flash_kernel_phase(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_bf16_flash.json").write_text(json.dumps(
            {"gpu": smi, "rng": rng, "kernels": recs}, indent=1))
        print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                      for r in recs]}))
        print(smi)
        return
    if args.per_layer_d512_only or args.per_layer_d1024_only:
        hd = 512 if args.per_layer_d512_only else 1024
        part = per_layer_head_phase(
            gpu, PER_LAYER_D512 if hd == 512 else PER_LAYER_D1024)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / f"chip_smoke_per_layer_d{hd}.json").write_text(json.dumps(
            {"gpu": smi, f"per_layer_d{hd}": part}, indent=1))
        print(smi)
        return
    if args.bf16_wide_times:
        wide = _bf16_wide_times(
            gpu, torch.Generator(device="cuda").manual_seed(SEED + 10))
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_bf16_wide_times.json").write_text(json.dumps(
            {"gpu": smi, "times": {rows[0]["shape"]: rows
                                   for rows in wide.values()},
             "ptxas": _slice_kernel_usage()}, indent=1))
        print(smi)
        return
    if args.f32_wide_times:
        times = _f32_wide_times(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_f32_wide_times.json").write_text(json.dumps(
            {"gpu": smi, "times": times, "ptxas": _slice_kernel_usage()},
            indent=1))
        print(smi)
        return
    if args.stacked_d256_only:
        stacked = stacked_d256_phase(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_stacked_d256.json").write_text(json.dumps(
            {"gpu": smi, "stacked_d256": stacked}, indent=1))
        print(smi)
        return
    if args.stacked_d1024_only:
        stacked = stacked_d1024_phase(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_stacked_d1024.json").write_text(json.dumps(
            {"gpu": smi, "stacked_d1024": stacked}, indent=1))
        print(smi)
        return
    if args.stacked_d512_only:
        stacked = stacked_d512_phase(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_stacked_d512.json").write_text(json.dumps(
            {"gpu": smi, "stacked_d512": stacked}, indent=1))
        print(smi)
        return
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
    if args.bf16_conv_only:
        import paddle_tpu_torch as pt

        resnet = _build_resnet(pt, RESNET)
        recs = amp_kernel_phase(gpu, _fused_shapes(resnet[0], RESNET["batch"]),
                                _fused_shapes(resnet[2], RESNET["infer_batch"]))
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_bf16_conv.json").write_text(json.dumps(
            {"gpu": smi, "kernels": recs}, indent=1))
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
    if args.lstm_only:
        recurrent = recurrent_phase()
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_recurrent.json").write_text(json.dumps(
            {"gpu": smi, "recurrent": recurrent}, indent=1))
        print(smi)
        return
    if args.zoo_only:
        recs, zoo = zoo_phase(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_zoo.json").write_text(json.dumps(
            {"gpu": smi, "kernels": recs, "zoo": zoo}, indent=1))
        print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                      for r in recs]}))
        print(smi)
        return
    if args.trainer_only:
        trainer = trainer_phase(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_trainer.json").write_text(json.dumps(
            {"gpu": smi, "trainer": trainer}, indent=1))
        print(smi)
        return
    if args.train_memory_only:
        mem = train_memory_phase(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_train_memory.json").write_text(json.dumps(
            {"gpu": smi, "train_memory": mem}, indent=1))
        print(smi)
        return
    if args.demo_ops_only:
        demo = demo_ops_phase(gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_demo_ops.json").write_text(json.dumps(
            {"gpu": smi, "demo_ops": demo}, indent=1))
        print(smi)
        return
    if args.book_only:
        book = book_phase(smi)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_book.json").write_text(json.dumps(
            {"gpu": smi, "book": book}, indent=1))
        print(smi)
        return
    if args.optim_only:
        optim = optim_phase(smi)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_optim.json").write_text(json.dumps(
            {"gpu": smi, "optim": optim}, indent=1))
        print(smi)
        return
    if args.precision_only:
        recs, precision = precision_phase(smi, gpu)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_precision.json").write_text(json.dumps(
            {"gpu": smi, "kernels": recs, "precision": precision},
            indent=1, default=str))
        print(json.dumps({"kernels": [
            {**{k: r[k] for k in keys}, "launches_phase20":
             r["launches_phase20"]} for r in recs]}))
        print(smi)
        return
    if args.decode_plane_only:
        plane = decode_plane_phase(smi)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_decode_plane.json").write_text(json.dumps(
            {"gpu": smi, "decode_plane": plane}, indent=1, default=str))
        print(smi)
        return
    if args.ctr_only:
        ctr = ctr_phase(smi)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_ctr.json").write_text(json.dumps(
            {"gpu": smi, "ctr": ctr}, indent=1, default=str))
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
    stacked_d256 = stacked_d256_phase(gpu)
    torch.cuda.empty_cache()
    stacked_d512 = stacked_d512_phase(gpu)
    torch.cuda.empty_cache()
    stacked_d1024 = stacked_d1024_phase(gpu)
    torch.cuda.empty_cache()

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
    torch.cuda.empty_cache()
    recurrent = recurrent_phase()
    torch.cuda.empty_cache()
    zoo_recs, zoo = zoo_phase(gpu)
    torch.cuda.empty_cache()
    trainer = trainer_phase(gpu)
    torch.cuda.empty_cache()
    train_memory = train_memory_phase(gpu)
    torch.cuda.empty_cache()
    demo_ops = demo_ops_phase(gpu)
    torch.cuda.empty_cache()
    book = book_phase(smi)
    torch.cuda.empty_cache()
    optim = optim_phase(smi)
    torch.cuda.empty_cache()
    precision_recs, precision = precision_phase(smi, gpu)
    torch.cuda.empty_cache()
    plane = decode_plane_phase(smi)
    torch.cuda.empty_cache()
    ctr = ctr_phase(smi)
    records = ([kern, slice_record(
                   kern, "f32", stacked_d1024["f32"]["launches_per_step"][0])]
               + bwd + stacked_records(kern, bwd, stacked_d256, 256)
               + stacked_records(kern, bwd, stacked_d512, 512)
               + stacked_records(kern, bwd, stacked_d1024, 1024)
               + conv + precision_recs
               + amp_recs + per_layer_recs + zoo_recs)
    phase16_launches(records, train_memory)
    phase19_launches(records, optim)
    phase20_launches(records, precision)
    phase21_launches(records, plane)
    phase22_launches(records, ctr)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernels": records, "serving": serving, "paged_serving": paged,
         "training": training, "stacked_d256": stacked_d256,
         "stacked_d512": stacked_d512, "stacked_d1024": stacked_d1024,
         "tf32_check": tf32, "resnet_training": resnet_training,
         "resnet_inference": resnet_inference,
         "attention_rewrite": attention, "amp": amp,
         "per_layer": per_layer, "recurrent": recurrent, "zoo": zoo,
         "trainer": trainer, "train_memory": train_memory,
         "demo_ops": demo_ops, "book": book, "optim": optim,
         "precision": precision, "decode_plane": plane, "ctr": ctr,
         "build_s": built,
         "rng": rng},
        indent=1, default=str))
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **{k: r[k] for k in ("launches_phase16", "launches_phase19",
                              "launches_phase20", "launches_phase21",
                              "launches_phase22")
            if k in r}} for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
