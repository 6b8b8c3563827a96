"""Continuous batching for autoregressive generation (Orca-style).

Counterpart of ``paddle_tpu/serving/generation.py``. Two KV layouts serve
one API, and ``GenerationEngine(...)`` picks between them as the JAX
package does: ``kv_cache="paged"`` (the default) builds a
:class:`PagedGenerationEngine`, ``kv_cache="dense"`` the contiguous slot
table.

Dense layout: each request claims a slot of the slot table ``[L,
slots+1, Hkv, Tmax, dh]``, a prefill writes its prompt K/V, and ONE decode
step advances every occupied slot each tick: finished sequences vacate
between ticks and queued requests join mid-flight. The extra slot (index
``slots``) is a scrap slot: padding rows of a partially filled prefill
bucket scatter their K/V there, so every prefill shape is a (batch
bucket, prompt bucket) pair whatever the number of requests. Its prefill
attention runs the sm_90a flash kernel on a CUDA device.

Paged layout: see :class:`PagedGenerationEngine`.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import prng
from ..decoding.beam import BeamJob
from ..decoding.params import BeamParams, SamplingParams
from ..decoding.stops import StopMatcher
from ..models.transformer import TransformerLM
from ..ops.common import policy_key
from ..ops.pipeline_ops import (kv_cache_page_copy,
                                transformer_stack_paged_decode,
                                transformer_stack_paged_prefill,
                                transformer_stack_slot_decode,
                                transformer_stack_slot_prefill)
from .batcher import Request
from .errors import BadRequestError, CacheExhaustedError, RequestTimeoutError
from .metrics import MetricsRegistry
from .paging import PagePool, PrefixIndex

_PAD_ID = 0  # token id of prefill padding (masked, never attended)
# the paged ops' sampling-plane slots and their keys in a host feed
_PLANE = (("Temperature", "temp"), ("TopK", "topk"), ("TopP", "topp"),
          ("Seed", "seed"), ("Step", "step"), ("Mask", "mask"))
_LATER = ("a later slice of the port (ROADMAP.md, Queue 1): the JAX "
          "package's {} is not ported yet")


@dataclasses.dataclass
class LMSpec:
    """Hyperparameters of a stacked transformer LM
    (``transformer_lm(pipeline_stack=True)`` contract)."""
    vocab_size: int
    d_model: int
    n_layers: int
    num_heads: int
    num_kv_heads: Optional[int] = None
    use_rope: bool = False
    max_len: int = 2048
    d_ff: Optional[int] = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def _default_prompt_buckets(tmax: int) -> List[int]:
    buckets, b = [], 8
    while b < tmax:
        buckets.append(b)
        b *= 2
    buckets.append(tmax)
    return sorted(set(buckets))


class RequestTimeline:
    """Per-request decode timeline: admission and the first- and
    last-token timestamps — the raw record behind the TTFT / TPOT
    histograms. Timestamps are ``time.monotonic`` seconds (the request
    deadline clock)."""

    __slots__ = ("enqueue_t", "admitted_t", "first_token_t", "last_token_t",
                 "n_tokens")

    def __init__(self, enqueue_t: float):
        self.enqueue_t = enqueue_t
        self.admitted_t = time.monotonic()
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.n_tokens = 0

    @property
    def queue_wait_s(self) -> float:
        return max(0.0, self.admitted_t - self.enqueue_t)

    def mark_token(self, now: float) -> Optional[float]:
        """Record one emitted token; returns the inter-token delta (None
        for the first token — that one is the TTFT sample)."""
        self.n_tokens += 1
        if self.first_token_t is None:
            self.first_token_t = self.last_token_t = now
            return None
        delta = now - self.last_token_t
        self.last_token_t = now
        return delta

    @property
    def ttft_s(self) -> Optional[float]:
        return (None if self.first_token_t is None
                else self.first_token_t - self.enqueue_t)


class _Slot:
    __slots__ = ("request", "generated", "max_new", "eos_id", "prompt",
                 "timeline", "truncate_to")

    def __init__(self, request: Request, prompt: np.ndarray,
                 max_new: int, eos_id: Optional[int]):
        self.request = request
        self.prompt = prompt
        self.generated: List[int] = []
        self.max_new = max_new
        self.eos_id = eos_id
        self.timeline = RequestTimeline(request.enqueue_t)
        # set by a stop-sequence match: keep only this many generated
        # tokens in the returned ids (the stop itself is dropped)
        self.truncate_to: Optional[int] = None


class GenerationEngine:
    """Continuous batcher over the stacked-LM decode ops.

    ``kv_cache="paged"`` (the default) constructs a
    :class:`PagedGenerationEngine`; ``kv_cache="dense"`` keeps the
    contiguous slot table. Both serve the same API.

    ``model`` is a :class:`TransformerLM` on ``device``, or a dict of the
    JAX package's parameters (numpy arrays under the JAX names) to load
    onto it. ``device`` defaults to ``cuda`` and raises without CUDA;
    pass ``device="cpu"`` to run the plain versions of the kernels.
    ``temperature``/``top_k`` are the default decode policy. The dense
    engine applies it engine-wide as the JAX engine does: a threefry key
    ``prng_key(seed)`` (``FLAGS.seed`` when ``seed`` is None) split once
    per prefill or decode run that samples, so its sampled tokens equal
    the JAX dense engine's; the paged engine takes a policy per request,
    merged over this default.
    """

    def __new__(cls, *args, **kw):
        if cls is GenerationEngine and \
                (kw.get("kv_cache") or "paged") == "paged":
            cls = PagedGenerationEngine
        return object.__new__(cls)

    def __init__(self, spec: LMSpec,
                 model: Union[TransformerLM, Dict[str, np.ndarray]], *,
                 slots: int = 8,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 default_max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 kv_cache: Optional[str] = None, device=None,
                 seed: Optional[int] = None):
        from .. import resolve_device

        if kv_cache not in (None, "dense", "paged"):
            raise ValueError(f"kv_cache must be 'paged' or 'dense', "
                             f"got {kv_cache!r}")
        if slots < 1:
            raise ValueError("need at least one decode slot")
        self.device = resolve_device(device)
        self.spec = spec
        self.slots = int(slots)
        self.tmax = int(spec.max_len)
        self.default_sampling = SamplingParams(
            temperature=float(temperature), top_k=int(top_k))
        self.default_sampling.validate(spec.vocab_size)
        self.temperature = float(self.default_sampling.temperature)
        self.top_k = int(self.default_sampling.top_k)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.eos_id = eos_id
        self.metrics = MetricsRegistry()
        if isinstance(model, TransformerLM):
            if model.device != self.device:
                raise ValueError(f"model lives on {model.device}, engine "
                                 f"on {self.device}")
            self.model = model
        else:
            self.model = TransformerLM.from_jax_params(spec, model,
                                                       self.device)
        self._lm_ins = self.model.shared_lm_inputs()
        if seed is None:
            from ..flags import FLAGS

            seed = FLAGS.seed
        self._rng_key = prng.prng_key(int(seed), device=self.device)
        self.prompt_buckets = sorted(set(
            min(int(b), self.tmax) for b in
            (prompt_buckets or _default_prompt_buckets(self.tmax))))
        nb, b = [], 1
        while b < self.slots:
            nb.append(b)
            b *= 2
        self.prefill_batch_buckets = nb + [self.slots]
        # kill() flips this: in-flight futures fail retryable and
        # serve_step drains the queue the same way until revive()
        self._killed = False
        # slot table: index `slots` is the scrap slot (prefill padding)
        self._nslots = self.slots + 1
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._tok = np.zeros(self._nslots, np.int64)
        self._pos = np.zeros(self._nslots, np.int32)
        self._init_cache()

    def _init_cache(self):
        s = self.spec
        shape = (s.n_layers, self._nslots, s.kv_heads, self.tmax,
                 s.head_dim)
        self.cache_k = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        self.cache_v = torch.zeros_like(self.cache_k)

    def _decode_attrs(self):
        return {"num_heads": self.spec.num_heads,
                "num_kv_heads": self.spec.num_kv_heads,
                "use_rope": self.spec.use_rope,
                "temperature": self.temperature, "top_k": self.top_k}

    def _gauges(self):
        self.metrics.set_gauge("active_slots", self.active)

    # -- bucket helpers -------------------------------------------------
    def prompt_bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise BadRequestError(
            f"prompt length {n} exceeds the largest prompt bucket "
            f"{self.prompt_buckets[-1]}")

    def _batch_bucket_for(self, n: int) -> int:
        for b in self.prefill_batch_buckets:
            if n <= b:
                return b
        return self.prefill_batch_buckets[-1]

    # -- slot accounting ------------------------------------------------
    @property
    def active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def free_slots(self) -> int:
        return self.slots - self.active

    # -- device steps ---------------------------------------------------
    def _split_rng(self):
        """The key a sampled prefill or decode run draws from: the JAX
        executor's ``rng, sub = split(rng)`` for the run's one sampling
        op. A greedy run draws nothing and leaves the key alone."""
        if self.temperature <= 0:
            return None
        self._rng_key, sub = prng.split(self._rng_key)
        return sub

    @torch.no_grad()
    def _run_prefill(self, prompt: np.ndarray, slot_ids: np.ndarray,
                     lengths: np.ndarray) -> np.ndarray:
        dev = self.device
        ins = {"Prompt": [torch.from_numpy(prompt).to(dev)],
               "SlotIds": [torch.from_numpy(slot_ids).to(dev)],
               "Lengths": [torch.from_numpy(lengths).to(dev)],
               "CacheK": [self.cache_k], "CacheV": [self.cache_v],
               **self._lm_ins}
        res = transformer_stack_slot_prefill(self._decode_attrs(), ins,
                                             self._split_rng())
        return res["NextTok"][0].cpu().numpy()

    @torch.no_grad()
    def _run_decode(self) -> np.ndarray:
        dev = self.device
        ins = {"Tok": [torch.from_numpy(self._tok).to(dev)],
               "Pos": [torch.from_numpy(self._pos).to(dev)],
               "CacheK": [self.cache_k], "CacheV": [self.cache_v],
               **self._lm_ins}
        res = transformer_stack_slot_decode(self._decode_attrs(), ins,
                                            self._split_rng())
        return res["NextTok"][0].cpu().numpy()

    # -- serving ---------------------------------------------------------
    def warmup(self) -> int:
        """Run every prefill (batch bucket x prompt bucket) pair and the
        decode step once before traffic arrives: builds the CUDA kernels
        (so no request waits on nvcc) and warms the matmul libraries. All
        warmup rows target the scrap slot, so live slots are never
        touched. Returns the number of shapes run."""
        combos = 0
        for tp in self.prompt_buckets:
            for b in self.prefill_batch_buckets:
                self._run_prefill(np.full((b, tp), _PAD_ID, np.int64),
                                  np.full(b, self.slots, np.int32),
                                  np.ones(b, np.int32))
                combos += 1
        self._run_decode()
        combos += 1
        self.metrics.inc("warmup_compiles", combos)
        return combos

    def _validate(self, req: Request):
        try:
            raw = (req.payload["prompt"] if isinstance(req.payload, dict)
                   else req.payload)
            prompt = np.asarray(raw, dtype=np.int64).reshape(-1)
        except (KeyError, TypeError, ValueError) as exc:
            raise BadRequestError(f"bad prompt payload: {exc}")
        if prompt.size < 1:
            raise BadRequestError("empty prompt")
        max_new = int(req.meta.get("max_new_tokens")
                      or self.default_max_new_tokens)
        if max_new < 1:
            raise BadRequestError("max_new_tokens must be >= 1")
        if prompt.size + max_new > self.tmax:
            raise BadRequestError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds the serving context ({self.tmax})")
        self._check_prompt_fits(prompt)
        eos = req.meta.get("eos_id")
        return prompt, max_new, self.eos_id if eos is None else eos

    def _check_prompt_fits(self, prompt: np.ndarray) -> None:
        """Layout-specific admission bound: the dense table serves a
        prompt only if a single prefill bucket covers it; the paged
        engine's chunked prefill takes any length the context allows."""
        self.prompt_bucket_for(prompt.size)  # raises when over-long

    def admit(self, requests: List[Request]) -> int:
        """Prefill a group of requests into free slots (one bucketed
        batch). Returns the number admitted; invalid requests fail their
        future and consume no slot."""
        todo = []
        for req in requests:
            try:
                todo.append((req, *self._validate(req)))
            except BadRequestError as exc:
                self.metrics.inc("bad_requests")
                req.future.set_exception(exc)
        if not todo:
            return 0
        free = [i for i in range(self.slots) if self._slots[i] is None]
        if len(todo) > len(free):
            raise RuntimeError(f"admit() got {len(todo)} requests for "
                               f"{len(free)} free slots")
        tp = self.prompt_bucket_for(max(p.size for _, p, _, _ in todo))
        bucket = self._batch_bucket_for(len(todo))
        prompt = np.full((bucket, tp), _PAD_ID, np.int64)
        slot_ids = np.full(bucket, self.slots, np.int32)  # scrap default
        lengths = np.ones(bucket, np.int32)
        for row, (req, p, max_new, eos) in enumerate(todo):
            prompt[row, :p.size] = p
            slot_ids[row] = free[row]
            lengths[row] = p.size
        t0 = time.perf_counter()
        first = self._run_prefill(prompt, slot_ids, lengths)
        t1 = time.perf_counter()
        self.metrics.observe_latency(t1 - t0, name="prefill")
        self.metrics.inc("prefills")
        self.metrics.set_gauge("prefill_occupancy", len(todo) / bucket)
        for row, (req, p, max_new, eos) in enumerate(todo):
            slot = free[row]
            st = _Slot(req, p, max_new, eos)
            self.metrics.observe_hist("queue_wait",
                                      st.timeline.queue_wait_s)
            self._slots[slot] = st
            self._tok[slot] = first[row]
            self._pos[slot] = p.size
            self._emit(slot, int(first[row]))
        self.metrics.set_gauge("active_slots", self.active)
        return len(todo)

    def _emit(self, slot: int, token: int) -> None:
        st = self._slots[slot]
        delta = st.timeline.mark_token(time.monotonic())
        if delta is None:  # first token: the TTFT sample
            self.metrics.observe_hist("ttft", st.timeline.ttft_s)
        else:              # every later token: one TPOT sample
            self.metrics.observe_hist("tpot", delta)
        st.generated.append(token)
        stop = getattr(st, "stop_matcher", None)
        if stop:
            keep = stop.match(st.generated)
            if keep is not None:
                # the stop sequence ends here (anywhere, mid-page too):
                # truncate before the match and finish
                st.truncate_to = keep
                self.metrics.inc("stop_sequence_hits")
                self._finish(slot)
                return
        if (len(st.generated) >= st.max_new
                or (st.eos_id is not None and token == st.eos_id)):
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        self._slots[slot] = None
        gen = (st.generated if st.truncate_to is None
               else st.generated[:st.truncate_to])
        ids = np.concatenate([st.prompt, np.asarray(gen, np.int64)])
        latency = time.monotonic() - st.request.enqueue_t
        st.request.future.set_result(ids)
        self.metrics.inc("completed")
        self.metrics.observe_latency(latency)

    def decode_tick(self) -> bool:
        """Advance every occupied slot one token (one decode step).
        Returns True when any slot was active."""
        if self.active == 0:
            return False
        t0 = time.perf_counter()
        nxt = self._run_decode()
        self.metrics.observe_latency(time.perf_counter() - t0,
                                     name="decode_step")
        self.metrics.inc("decode_steps")
        self.metrics.inc("decode_tokens", self.active)
        self.metrics.set_gauge("batch_occupancy", self.active / self.slots)
        for slot in range(self.slots):
            if self._slots[slot] is None:
                continue
            self._pos[slot] += 1
            self._tok[slot] = nxt[slot]
            self._emit(slot, int(nxt[slot]))
        self.metrics.set_gauge("active_slots", self.active)
        return True

    # -- hard engine death --------------------------------------------------
    def kill(self, reason: str = "chaos") -> int:
        """Hard-kill the engine mid-stream: every in-flight generation
        fails with ``ConnectionError`` (retryable), slots are released,
        and the engine refuses traffic until :meth:`revive`. Returns the
        number of futures failed."""
        exc = ConnectionError(f"replica killed mid-stream ({reason})")
        failed = 0
        for slot in range(self.slots):
            st = self._slots[slot]
            if st is None:
                continue
            self._slots[slot] = None
            if not st.request.future.done():
                st.request.future.set_exception(exc)
                failed += 1
        self._killed = True
        self.metrics.inc("replica_kills")
        self.metrics.inc("killed_in_flight", failed)
        self.metrics.set_gauge("active_slots", self.active)
        return failed

    def revive(self) -> None:
        """Bring a killed engine back (its slots are empty)."""
        self._killed = False

    def _drain_killed(self, batcher) -> bool:
        """A killed engine's serve loop: fail everything the batcher
        hands it, retryable."""
        reqs = batcher.next_batch(max_n=max(self.slots, 1), wait_s=0)
        if not reqs:
            return False
        exc = ConnectionError("replica is down (killed mid-stream)")
        for req in reqs:
            if not req.future.done():
                req.future.set_exception(exc)
        return True

    # -- server-driver interface -----------------------------------------
    def serve_step(self, batcher, idle_wait_s: Optional[float] = None) -> bool:
        """One engine tick: admit queued requests into free slots (a
        non-blocking grab while decoding, a coalescing wait when idle),
        then advance the decode loop one step."""
        if self._killed:
            return self._drain_killed(batcher)
        did = False
        free = self.free_slots
        if free:
            wait = 0 if self.active else idle_wait_s
            reqs = batcher.next_batch(max_n=free, wait_s=wait)
            if reqs:
                did = self.admit(reqs) > 0
        did = self.decode_tick() or did
        return did

    # -- synchronous convenience ------------------------------------------
    def generate_all(self, prompts: Sequence[Sequence[int]],
                     max_new_tokens: Optional[int] = None,
                     eos_id: Optional[int] = None) -> List[np.ndarray]:
        """Drive the continuous batcher to completion over a request list
        (no server thread): requests stream into slots as they free up."""
        max_new = max_new_tokens or self.default_max_new_tokens
        reqs = [Request({"prompt": p},
                        {"max_new_tokens": max_new, "eos_id": eos_id}, None)
                for p in prompts]
        pending = list(reqs)
        while pending or self.active:
            if pending and self.free_slots:
                k = min(len(pending), self.free_slots)
                self.admit(pending[:k])
                pending = pending[k:]
            self.decode_tick()
        return [r.future.result(timeout=0.1) for r in reqs]


# ---------------------------------------------------------------------------
# Paged KV cache: block-table slots over a shared page pool
# ---------------------------------------------------------------------------
class _PagedSlot(_Slot):
    __slots__ = ("pages", "shared_tokens", "cow_reserve", "prefill_done",
                 "state", "sampling", "stop_matcher", "mask_proc",
                 "beam_job", "role", "xrow")

    def __init__(self, request, prompt, max_new, eos_id,
                 sampling: Optional[SamplingParams] = None):
        super().__init__(request, prompt, max_new, eos_id)
        self.pages: List[int] = []       # physical page per table entry
        self.shared_tokens = 0           # prefix-cache hit length
        self.cow_reserve = 0             # pages held for copy-on-write
        self.prefill_done = 0            # prompt tokens whose K/V is cached
        self.state = "decode"            # "prefill" while chunks stream in
                                         # ("hold"/"beam_wait" for beams)
        self.sampling = sampling or SamplingParams()
        self.stop_matcher = StopMatcher(self.sampling.stop)
        self.mask_proc = self.sampling.logits_processor
        self.beam_job = None             # set for beam-owned slots
        self.role = "normal"             # beam_parent | beam | hold
        self.xrow = None                 # seq2seq: cross-KV cache row


class PagedGenerationEngine(GenerationEngine):
    """Continuous batcher over a PAGED KV cache with prefix sharing and
    chunked prefill: the port of the JAX package's default engine.

    The cache is a page pool ``[L, n_pages, Hkv, page_size, dh]`` per K/V
    on the device, updated in place, plus a host-side per-slot block
    table: a sequence holds ``ceil(len/page_size)`` physical pages, so
    device memory holds TOKENS IN FLIGHT, not slots x Tmax. Three levers
    ride on the allocator (``paging.py``):

    - **Prefix sharing** (``prefix_sharing=True``): page-aligned prompt
      prefixes map to refcounted pages stored once; a request whose
      prefix is cached skips that prefill (``prefix_hit_tokens``). A
      shared page about to be written (a full-prompt hit diverging into
      generation) is copied first: copy-on-write via
      ``kv_cache_page_copy``, one page reserved at admission.
    - **Chunked prefill**: a prompt longer than ``prefill_chunk`` tokens
      streams in one chunk per engine tick, interleaved with decode.
    - **Typed backpressure**: a request whose prompt + max_new_tokens can
      never fit the pool fails with
      :class:`~paddle_tpu_torch.serving.errors.CacheExhaustedError`;
      transient pressure defers admission.

    Every request carries its own :class:`SamplingParams` (request meta
    merged over the engine's default): greedy, temperature, top-k, top-p, stop
    sequences and per-step token masks mix in one decode step, and a
    sampled row's tokens are a function of (request, seed) alone, equal
    to the JAX engine's (``core/prng.py``).

    **Beam search as paged forks** (``beam_width`` > 0): the prefill and
    decode steps also return each row's top-``beam_width`` log-probs
    (TopV/TopI), and a request with ``beam_size`` in its meta (or
    :meth:`generate_beam`) claims ``beam_size`` slots whose hypotheses
    (:class:`~paddle_tpu_torch.decoding.BeamJob`) fork by refcount: the
    written prefix is shared, the boundary page copied on write. Beam
    rows ride the same decode step as every other request.

    The decode step is one fixed shape: every slot, a ``[slots, pmax]``
    block table. On a CUDA device the engine captures it (the paged
    decode op plus the sampler) once into a ``torch.cuda.CUDAGraph`` and
    each tick copies the host feed into its static inputs, replays it and
    reads NextTok (and the beam plane's TopV/TopI) back: one launch of
    the whole step instead of hundreds of small ones. Copy-on-write
    copies (a beam fork's boundary page's too) run eagerly before the
    replay. A capture or replay that
    fails raises; nothing decodes eagerly on the card in its place. On
    the CPU the step runs eagerly.

    Not ported yet (each raises, naming ROADMAP.md): a pool shared with
    another engine (``share_cache_with``) and KV handoff
    (``export_slot``/``adopt_slot``), resume-from-token recovery, warmup
    manifests and ``swap_params``.
    """

    def __init__(self, spec: LMSpec,
                 model: Union[TransformerLM, Dict[str, np.ndarray]], *,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_sharing: bool = True,
                 beam_width: int = 0,
                 share_cache_with: Optional["PagedGenerationEngine"] = None,
                 kv_cache: Optional[str] = None, **kw):
        if kv_cache not in (None, "paged"):
            raise ValueError(
                f"PagedGenerationEngine is kv_cache='paged' (got "
                f"{kv_cache!r}); use GenerationEngine(kv_cache='dense') "
                "for the dense slot table")
        if page_size is not None and page_size < 1:
            raise ValueError("page_size must be >= 1")
        if beam_width < 0:
            raise ValueError("beam_width must be >= 0")
        if share_cache_with is not None:
            raise NotImplementedError(_LATER.format(
                "shared page pool (share_cache_with, disaggregation)"))
        self._page_size_arg = page_size
        self._n_pages_arg = n_pages
        self._prefill_chunk_arg = prefill_chunk
        self._prefix_sharing = bool(prefix_sharing)
        # beam_width > 0 puts the TopV/TopI (emit_topk) plane into the
        # prefill and decode steps; beam requests up to this width ride it
        self.beam_width = int(beam_width)
        super().__init__(spec, model, **kw)

    # -- cache construction ---------------------------------------------------
    def _init_cache(self):
        s = self.spec
        self.page_size = int(self._page_size_arg or min(64, self.tmax))
        # table width: enough entries for a full-context sequence
        self.pmax = -(-self.tmax // self.page_size)
        # beam engines default to a bigger pool: K fully diverged
        # hypotheses can each hold a full table plus a copy-on-write spare
        beam_extra = self.slots + 2 * self.beam_width if self.beam_width \
            else 0
        self.n_pages = int(self._n_pages_arg
                           or self.slots * self.pmax + 1 + beam_extra)
        if self.n_pages < 2:
            raise ValueError("need at least 2 pages (one is scrap)")
        chunk = self._prefill_chunk_arg
        if chunk is None:
            chunk = min(self.prompt_buckets[-1],
                        max(2 * self.page_size, 128))
        self.prefill_chunk = max(1, min(int(chunk), self.tmax))
        self._chunk_widths = sorted(
            {b for b in self.prompt_buckets if b <= self.prefill_chunk}
            | {self.prefill_chunk})
        self.pool = PagePool(self.n_pages, self.page_size)
        self.prefix_index = (PrefixIndex(self.pool)
                             if self._prefix_sharing else None)
        # no scrap SLOT here: padding/vacant rows write the scrap PAGE,
        # so the decode batch is exactly the slot count
        self._nslots = self.slots
        self._tok = np.zeros(self._nslots, np.int64)
        self._pos = np.zeros(self._nslots, np.int32)
        self._deferred = deque()  # pool-blocked validated admissions
        self._pf_cursor = 0       # round-robin over prefilling slots
        self._beam_jobs: List[BeamJob] = []
        self._seed_counter = 0    # default per-request seeds
        shape = (s.n_layers, self.n_pages, s.kv_heads, self.page_size,
                 s.head_dim)
        self.cache_k = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        self.cache_v = torch.zeros_like(self.cache_k)
        self._graph = None        # the captured decode step (CUDA)
        self._graph_key = None    # the policies and beam width of it
        self._static: Dict[str, torch.Tensor] = {}
        self._static_next: Optional[torch.Tensor] = None
        self._static_top: tuple = ()  # the beam plane's TopV, TopI
        self._mask_open = True    # the static mask is all ones
        self.metrics.set_gauge("mem/kv_cache_bytes",
                               2.0 * float(np.prod(shape)) * 4)
        self.metrics.set_gauge("mem/kv_block_table_bytes",
                               float(self.slots * self.pmax * 4))
        self._gauges()

    def _decode_attrs(self):
        # per-request sampling rides the input plane, never the attrs
        attrs = super()._decode_attrs()
        attrs["temperature"] = 0.0
        attrs["top_k"] = 0
        attrs["page_size"] = self.page_size
        if self.beam_width:
            attrs["emit_topk"] = self.beam_width
        return attrs

    def _step_outs(self, res) -> tuple:
        """(NextTok, TopV, TopI) of a paged step's outputs, on the host;
        the beam plane's two are None without it."""
        if not self.beam_width:
            return res["NextTok"][0].cpu().numpy(), None, None
        return tuple(res[k][0].cpu().numpy()
                     for k in ("NextTok", "TopV", "TopI"))

    def _check_prompt_fits(self, prompt: np.ndarray) -> None:
        # chunked prefill serves ANY prompt the context admits: the
        # prompt + max_new_tokens <= tmax check already ran
        pass

    def _chunk_bucket_for(self, n: int) -> int:
        for b in self._chunk_widths:
            if n <= b:
                return b
        return self._chunk_widths[-1]

    def _entries_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    # -- sampling plane -------------------------------------------------------
    def _neutral_sampling_feed(self, rows: int) -> Dict[str, np.ndarray]:
        """The sampling plane for rows with no live policy (warmup,
        vacant slots, padding): greedy, mask wide open."""
        feed = {"temp": np.zeros(rows, np.float32),
                "topk": np.zeros(rows, np.int32),
                "topp": np.ones(rows, np.float32),
                "seed": np.zeros(rows, np.int32),
                "step": np.zeros(rows, np.int32),
                "mask": np.ones((rows, self.spec.vocab_size), np.float32)}
        return feed

    def _slot_sampling_feed(self, row: int, st, feed: dict,
                            step: int) -> None:
        """Write one slot's policy into row ``row`` of a sampling feed."""
        sp = st.sampling
        feed["temp"][row] = sp.temperature
        feed["topk"][row] = sp.top_k
        feed["topp"][row] = sp.top_p
        feed["seed"][row] = (sp.seed or 0) & 0x7FFFFFFF
        feed["step"][row] = step
        if st.mask_proc is not None:
            mask = np.asarray(st.mask_proc.mask(step, st.generated),
                              np.float32)
            if mask.shape != (self.spec.vocab_size,):
                raise BadRequestError(
                    f"logits processor returned shape {mask.shape}, "
                    f"want ({self.spec.vocab_size},)")
            if mask.max() <= 0:  # dead end: fail open, count it
                self.metrics.inc("mask_dead_ends")
            else:
                feed["mask"][row] = mask

    # the per-row plane of the steps' feeds (op slot, feed key) and the
    # ops of the two steps: a subclass extends the plane and swaps the ops
    _plane = _PLANE
    _prefill_op = staticmethod(transformer_stack_paged_prefill)
    _decode_op = staticmethod(transformer_stack_paged_decode)

    def _sampling_ins(self, feed) -> Dict[str, list]:
        """The per-row plane's op inputs from a host feed."""
        return {slot: [torch.from_numpy(feed[key]).to(self.device)]
                for slot, key in self._plane}

    def _state_ins(self) -> Dict[str, list]:
        """The steps' device state: the page pools and the weights."""
        return {"CacheK": [self.cache_k], "CacheV": [self.cache_v],
                **self._lm_ins}

    # -- device steps ---------------------------------------------------------
    @torch.no_grad()
    def _run_prefill_chunk(self, feed) -> tuple:
        """One prefill call: (NextTok, TopV, TopI) on the host."""
        dev = self.device
        ins = {"Chunk": [torch.from_numpy(feed["chunk"]).to(dev)],
               "StartPos": [torch.from_numpy(feed["start"]).to(dev)],
               "Lengths": [torch.from_numpy(feed["chunk_len"]).to(dev)],
               "BlockTable": [torch.from_numpy(feed["block_table"]).to(dev)],
               **self._sampling_ins(feed), **self._state_ins()}
        res = self._prefill_op(self._decode_attrs(), ins)
        return self._step_outs(res)

    @torch.no_grad()
    def _run_page_copy(self, src: int, dst: int) -> None:
        dev = self.device
        kv_cache_page_copy({}, {
            "Src": [torch.tensor([src], dtype=torch.int32, device=dev)],
            "Dst": [torch.tensor([dst], dtype=torch.int32, device=dev)],
            "CacheK": [self.cache_k], "CacheV": [self.cache_v]})

    def _decode_ins(self, feed) -> Dict[str, list]:
        """The paged decode op's inputs from device tensors ``feed``."""
        return {"Tok": [feed["tok"]], "Pos": [feed["pos"]],
                "BlockTable": [feed["block_table"]],
                **{slot: [feed[key]] for slot, key in self._plane},
                **self._state_ins()}

    @torch.no_grad()
    def _decode_step_eager(self, feed) -> tuple:
        """One decode step run op by op (the CPU's step; on the card only
        the reference the replayed step is checked against)."""
        dev = self.device
        tensors = {k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
        res = self._decode_op(self._decode_attrs(), self._decode_ins(tensors))
        return self._step_outs(res)

    def _capture_decode(self) -> None:
        """Capture the decode step into a CUDA graph over static input
        buffers. Warmup and capture feed the neutral plane (vacant rows,
        an all-zero table), whose writes land in the scrap page."""
        feed = self._neutral_decode_feed()
        self._static = {k: torch.from_numpy(v).to(self.device)
                        for k, v in feed.items()}
        self._mask_open = True
        attrs = self._decode_attrs()
        ins = self._decode_ins(self._static)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(2):  # library handles and workspaces first
                self._decode_op(attrs, ins)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread-local: another engine's thread may run CUDA work meanwhile
        with torch.no_grad(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            res = self._decode_op(attrs, ins)
        self._static_next = res["NextTok"][0]
        self._static_top = tuple(res[k][0] for k in ("TopV", "TopI")
                                 if k in res)
        self._graph = graph
        self.metrics.inc("decode_graph_captures")

    def _decode_step_replay(self, feed) -> tuple:
        """One decode step as a replay of the captured graph: the host
        feed goes into the static inputs (the mask only when a row is
        masked now or was last time), then NextTok (and TopV/TopI) come
        back. A graph captured under another AMP or precision policy, or
        another beam width, is captured anew."""
        key = (policy_key(), self.beam_width)
        if self._graph is None or self._graph_key != key:
            self._capture_decode()
            self._graph_key = key
        static = self._static
        for key, arr in feed.items():
            if key == "mask":
                open_now = not (arr <= 0).any()
                if open_now and self._mask_open:
                    continue
                self._mask_open = open_now
            static[key].copy_(torch.from_numpy(arr), non_blocking=False)
        self._graph.replay()
        self.metrics.inc("decode_graph_replays")
        nxt = self._static_next.cpu().numpy()
        if not self.beam_width:
            return nxt, None, None
        return (nxt, *(t.cpu().numpy() for t in self._static_top))

    def _decode_step(self, feed) -> tuple:
        if self.device.type == "cuda":
            return self._decode_step_replay(feed)
        return self._decode_step_eager(feed)

    def _neutral_decode_feed(self) -> Dict[str, np.ndarray]:
        feed = {"tok": np.zeros(self._nslots, np.int64),
                "pos": np.zeros(self._nslots, np.int32),
                "block_table": np.zeros((self._nslots, self.pmax),
                                        np.int32)}
        feed.update(self._neutral_sampling_feed(self._nslots))
        return feed

    def _decode_feed(self) -> Dict[str, np.ndarray]:
        """The decode step's host feed: every decoding slot's token,
        position, block table and policy; vacant and prefilling rows
        neutral (scrap-page writes, greedy)."""
        feed = self._neutral_decode_feed()
        for s in range(self.slots):
            st = self._slots[s]
            if st is not None and st.state == "decode":
                feed["tok"][s] = self._tok[s]
                feed["pos"][s] = self._pos[s]
                feed["block_table"][s, :len(st.pages)] = st.pages
                # step = tokens this request has sampled so far: a pure
                # function of the request, never of the batch around it
                self._slot_sampling_feed(s, st, feed, step=len(st.generated))
        return feed

    # -- warmup ---------------------------------------------------------------
    def _prefill_feed(self, bucket: int, tc: int) -> Dict[str, np.ndarray]:
        feed = {"chunk": np.full((bucket, tc), _PAD_ID, np.int64),
                "start": np.zeros(bucket, np.int32),
                "chunk_len": np.zeros(bucket, np.int32),
                "block_table": np.zeros((bucket, self.pmax), np.int32)}
        feed.update(self._neutral_sampling_feed(bucket))
        return feed

    def warmup(self) -> int:
        """Run every (chunk width x batch bucket) prefill shape, the decode
        step (captured as a CUDA graph on the card) and the copy-on-write
        page copy once before traffic arrives. Every warmup row writes the
        scrap page, so live pages are never touched. Returns the number of
        shapes run."""
        combos = 0
        for tc in self._chunk_widths:
            for b in self.prefill_batch_buckets:
                feed = self._prefill_feed(b, tc)
                feed["chunk_len"][:] = 1
                self._run_prefill_chunk(feed)
                combos += 1
        self._decode_step(self._neutral_decode_feed())
        combos += 1
        self._run_page_copy(0, 0)  # scrap onto itself: harmless
        combos += 1
        self.metrics.inc("warmup_compiles", combos)
        return combos

    # -- page bookkeeping -----------------------------------------------------
    def _cow_guard(self, decoding) -> None:
        """Before a decode tick writes position ``pos`` for each slot, any
        target page still shared (refcount > 1: a prefix-cache page this
        sequence is diverging from) is copied to a fresh page from the
        slot's admission-time reserve and the block table redirected."""
        for slot in decoding:
            st = self._slots[slot]
            entry = int(self._pos[slot]) // self.page_size
            pid = st.pages[entry]
            if self.pool.refcount(pid) <= 1:
                continue
            if st.cow_reserve > 0:
                st.cow_reserve -= 1
                new = self.pool.alloc(reserved=True)
            else:  # defensive: never expected, but never corrupt a share
                if self.pool.available() < 1 and self.prefix_index:
                    self.prefix_index.evict_until(1)
                new = self.pool.alloc()
            self._run_page_copy(pid, new)
            self.pool.decref(pid)
            st.pages[entry] = new
            self.metrics.inc("kv_cow_copies")

    def _register_prefix(self, st: _PagedSlot,
                         include_tail: bool = False) -> None:
        """Publish the slot's fully-written prompt pages into the prefix
        index (idempotent). Full pages register once prefilled; the
        partial tail page only at finish."""
        if self.prefix_index is None or st.prefill_done < st.prompt.size:
            return
        ps = self.page_size
        prompt = st.prompt
        n_full = prompt.size // ps
        key = b""
        for i in range(n_full):
            key = self.prefix_index.insert(
                key, prompt[i * ps:(i + 1) * ps], st.pages[i])
        tail = prompt[n_full * ps:]
        if include_tail and tail.size:
            self.prefix_index.insert(key, tail, st.pages[n_full])

    def _release_pages(self, st: _PagedSlot) -> None:
        if self._prefix_sharing:
            self._register_prefix(st, include_tail=True)
        for pid in st.pages:
            self.pool.decref(pid)
        st.pages = []
        if st.cow_reserve:
            self.pool.release_reservation(st.cow_reserve)
            st.cow_reserve = 0

    def _finish(self, slot: int) -> None:
        self._release_pages(self._slots[slot])
        super()._finish(slot)

    # -- admission ------------------------------------------------------------
    def _validate(self, req: Request):
        """Base validation plus the request's decode policy: a
        SamplingParams merged request over engine default, field by
        field (a sampled request without a seed gets the engine's next
        default seed), and BeamParams when the request asks for beam
        search."""
        prompt, max_new, eos = super()._validate(req)
        meta = req.meta or {}
        if meta.get("resume_tokens"):
            raise BadRequestError(_LATER.format("resume-from-token recovery"))
        sp = meta.get("sampling_params")
        try:
            sampling = (sp if isinstance(sp, SamplingParams)
                        else SamplingParams.from_meta(
                            meta, self.default_sampling))
            sampling.validate(self.spec.vocab_size)
            beam = BeamParams.from_meta(meta)
            if beam is not None:
                if beam.eos_id is None and eos is not None:
                    beam = dataclasses.replace(beam, eos_id=eos)
                beam.validate(self.spec.vocab_size)
        except (ValueError, TypeError) as exc:
            raise BadRequestError(str(exc))
        if beam is not None:
            if not self.beam_width:
                raise BadRequestError(
                    "beam request on an engine built without the beam "
                    "plane — construct with beam_width >= beam_size")
            if beam.beam_size > self.beam_width:
                raise BadRequestError(
                    f"beam_size {beam.beam_size} exceeds the engine's "
                    f"beam_width ({self.beam_width})")
            if beam.beam_size > self.slots:
                raise BadRequestError(
                    f"beam_size {beam.beam_size} exceeds the slot count "
                    f"({self.slots}) — a hypothesis occupies one slot")
        if sampling.sampled and sampling.seed is None:
            sampling = sampling.with_seed(self._seed_counter)
            self._seed_counter = (self._seed_counter + 1) & 0x7FFFFFFF
        if sampling.max_tokens is not None \
                and meta.get("max_new_tokens") is None:
            max_new = int(sampling.max_tokens)
            if prompt.size + max_new > self.tmax:
                raise BadRequestError(
                    f"prompt ({prompt.size}) + max_tokens ({max_new}) "
                    f"exceeds the serving context ({self.tmax})")
        return prompt, max_new, eos, sampling, beam

    def admit(self, requests: List[Request]) -> int:
        """Admit a group of requests: prefix-cache lookup + page
        allocation per request, then ONE bucketed prefill over everyone
        whose unshared prompt remainder fits ``prefill_chunk``; longer
        prompts claim their slot and stream in via :meth:`prefill_tick`.
        Requests the pool cannot hold right now are DEFERRED (retried as
        pages free); only a request that can never fit fails, typed. A
        beam request claims ``beam_size`` slots (its parent plus holds its
        hypotheses fork into). Returns the number admitted to a slot."""
        todo = []
        for req in requests:
            try:
                todo.append((req, *self._validate(req)))
            except BadRequestError as exc:
                self.metrics.inc("bad_requests")
                req.future.set_exception(exc)
        if not todo:
            return 0
        group: list = []
        admitted = 0
        for item in todo:
            if self._deferred:  # keep FIFO order behind blocked work
                self._deferred.append(item)
                continue
            r = self._admit_one(*item, group=group)
            if r == "ok":
                admitted += 1
            elif r == "defer":
                self._deferred.append(item)
        if group:
            self._run_prefill_group(group)
        self._gauges()
        return admitted

    def _admit_one(self, req, prompt, max_new, eos, sampling, beam,
                   group) -> str:
        """Claim a slot + pages for one validated request. Returns "ok"
        (slot taken; short prefills appended to ``group``), "defer"
        (transient pool/slot pressure), or "failed" (future completed
        with CacheExhaustedError: the request can NEVER fit)."""
        if self.free_slots < (beam.beam_size if beam is not None else 1):
            self.metrics.inc("admission_deferred")
            return "defer"
        plen = int(prompt.size)
        entries_total = self._entries_for(plen + max_new)
        # a shared prefix trades >= 1 allocated page for <= 1
        # copy-on-write spare, so entries_total > capacity can NEVER fit
        if entries_total > self.pool.capacity:
            self.metrics.inc("cache_exhausted")
            req.future.set_exception(CacheExhaustedError(
                f"prompt ({plen}) + max_new_tokens ({max_new}) needs "
                f"{entries_total} pages but the pool holds only "
                f"{self.pool.capacity} allocatable pages of "
                f"{self.page_size} tokens: shrink the request or grow "
                f"n_pages", pages_needed=entries_total,
                pages_free=self.pool.capacity))
            return "failed"
        shared, spages = 0, []
        if self.prefix_index is not None:
            shared, spages, _ = self.prefix_index.lookup(prompt)
        own = entries_total - len(spages)
        cow = 1 if shared == plen else 0  # generation writes a shared page
        need = own + cow
        for pid in spages:  # hold the prefix before any eviction runs
            self.pool.incref(pid)
        if self.pool.available() < need:
            if self.prefix_index is not None:
                self.prefix_index.evict_until(need)
            if self.pool.available() < need:
                for pid in spages:
                    self.pool.decref(pid)
                self.metrics.inc("admission_deferred")
                return "defer"
        owned = [self.pool.alloc() for _ in range(own)]
        if cow:
            self.pool.reserve(cow)
        slot = self._slots.index(None)
        st = _PagedSlot(req, prompt, max_new, eos, sampling)
        st.pages = list(spages) + owned
        st.shared_tokens = shared
        st.cow_reserve = cow
        st.prefill_done = shared
        self.metrics.observe_hist("queue_wait", st.timeline.queue_wait_s)
        self._slots[slot] = st
        if beam is not None:
            # parent + (K-1) parked hold slots the hypotheses fork into;
            # holds occupy the slot table now, so later admissions cannot
            # starve the expansion
            holds = []
            for _ in range(beam.beam_size - 1):
                h = self._slots.index(None)
                hs = _PagedSlot(req, prompt, max_new, eos, sampling)
                hs.state = hs.role = "hold"
                self._slots[h] = hs
                holds.append(h)
            job = BeamJob(self, req, prompt, max_new, beam,
                          parent_slot=slot, hold_slots=holds)
            st.beam_job = job
            st.role = "beam_parent"
            for h in holds:
                self._slots[h].beam_job = job
            self._beam_jobs.append(job)
            self.metrics.inc("beam_jobs")
        if shared:
            self.metrics.inc("prefix_hits")
            self.metrics.inc("prefix_hit_tokens", shared)
        remaining = plen - shared
        if remaining == 0:
            # full prefix hit: skip prefill and enter the decode loop one
            # step behind; re-feeding the last prompt token at its own
            # position re-derives the K/V the shared page holds (through
            # the copy-on-write guard) and yields the first token
            st.state = "decode"
            self._tok[slot] = prompt[-1]
            self._pos[slot] = plen - 1
        elif remaining <= self.prefill_chunk:
            st.state = "prefill"
            group.append((req, st, slot))
        else:
            st.state = "prefill"  # streams via prefill_tick
        return "ok"

    def _run_prefill_group(self, group) -> None:
        """One bucketed prefill call over freshly admitted requests whose
        unshared remainder fits a single chunk (mixed prefix offsets ride
        the per-row StartPos plane). A group beyond the largest batch
        bucket splits into bucket-sized calls."""
        cap = self.prefill_batch_buckets[-1]
        if len(group) > cap:
            for i in range(0, len(group), cap):
                self._run_prefill_group(group[i:i + cap])
            return
        rem = [st.prompt.size - st.prefill_done for _, st, _ in group]
        tc = self._chunk_bucket_for(max(rem))
        bucket = self._batch_bucket_for(len(group))
        feed = self._prefill_feed(bucket, tc)
        for row, (req, st, slot) in enumerate(group):
            r = rem[row]
            feed["chunk"][row, :r] = st.prompt[st.prefill_done:]
            feed["start"][row] = st.prefill_done
            feed["chunk_len"][row] = r
            feed["block_table"][row, :len(st.pages)] = st.pages
            self._slot_sampling_feed(row, st, feed, step=len(st.generated))
        t0 = time.perf_counter()
        first, topv, topi = self._run_prefill_chunk(feed)
        self.metrics.observe_latency(time.perf_counter() - t0,
                                     name="prefill")
        self.metrics.inc("prefills")
        self.metrics.set_gauge("prefill_occupancy", len(group) / bucket)
        for row, (req, st, slot) in enumerate(group):
            st.prefill_done = st.prompt.size
            self._register_prefix(st)
            st.state = "decode"
            if st.role == "beam_parent":
                # the parent's top-K row expands the hypothesis set; the
                # job takes the slot bookkeeping over from here
                st.role = "beam"
                st.beam_job.on_parent_row(topv[row], topi[row])
                continue
            self._tok[slot] = first[row]
            self._pos[slot] = st.prompt.size
            self._emit(slot, int(first[row]))

    def _admit_deferred(self) -> int:
        """Retry pool-blocked admissions in arrival order. Expired ones
        time out; when the engine is COMPLETELY idle and the head still
        cannot fit, nothing will ever free its pages: it fails typed."""
        admitted = 0
        while self._deferred:
            req, prompt, max_new, eos, sampling, beam = self._deferred[0]
            if req.expired():
                self._deferred.popleft()
                self.metrics.inc("timeouts")
                req.future.set_exception(RequestTimeoutError(
                    "request deadline expired while deferred on the KV "
                    "page pool"))
                continue
            if self.free_slots == 0:
                break
            group: list = []
            r = self._admit_one(req, prompt, max_new, eos, sampling, beam,
                                group=group)
            if r == "defer":
                if self.active == 0 and admitted == 0:
                    self._deferred.popleft()
                    need = self._entries_for(prompt.size + max_new)
                    self.metrics.inc("cache_exhausted")
                    req.future.set_exception(CacheExhaustedError(
                        f"KV page pool cannot free the {need} pages this "
                        f"request needs ({self.pool.available()} "
                        "available and no requests in flight)",
                        pages_needed=need,
                        pages_free=self.pool.available()))
                    continue
                break
            self._deferred.popleft()
            if group:
                self._run_prefill_group(group)
            if r == "ok":
                admitted += 1
        if admitted:
            self._gauges()
        return admitted

    # -- the tick loop --------------------------------------------------------
    @property
    def prefilling(self) -> int:
        return sum(1 for s in self._slots
                   if s is not None and s.state == "prefill")

    def prefill_tick(self) -> bool:
        """Advance ONE prefilling slot by one chunk (<= prefill_chunk
        tokens), round-robin across prefilling slots; returns True when a
        chunk ran."""
        order = [(self._pf_cursor + i) % self.slots
                 for i in range(self.slots)]
        slot = next((i for i in order if self._slots[i] is not None
                     and self._slots[i].state == "prefill"), None)
        if slot is None:
            return False
        self._pf_cursor = (slot + 1) % self.slots
        st = self._slots[slot]
        plen = int(st.prompt.size)
        start0 = st.prefill_done
        k = min(self.prefill_chunk, plen - start0)
        feed = self._prefill_feed(self._batch_bucket_for(1),
                                  self._chunk_bucket_for(k))
        feed["chunk"][0, :k] = st.prompt[start0:start0 + k]
        feed["start"][0] = start0
        feed["chunk_len"][0] = k
        feed["block_table"][0, :len(st.pages)] = st.pages
        self._slot_sampling_feed(0, st, feed, step=len(st.generated))
        t0 = time.perf_counter()
        first, topv, topi = self._run_prefill_chunk(feed)
        self.metrics.observe_latency(time.perf_counter() - t0,
                                     name="prefill_chunk")
        self.metrics.inc("prefill_chunks")
        st.prefill_done = start0 + k
        if st.prefill_done >= plen:
            self.metrics.inc("prefills")
            self._register_prefix(st)
            st.state = "decode"
            if st.role == "beam_parent":
                st.role = "beam"
                st.beam_job.on_parent_row(topv[0], topi[0])
            else:
                self._tok[slot] = first[0]
                self._pos[slot] = plen
                self._emit(slot, int(first[0]))
            self._gauges()
        return True

    def decode_tick(self) -> bool:
        """Advance every DECODING slot one token (prefilling slots sit
        out: their block tables are mid-write; a pool-parked beam job's
        slots wait in ``beam_wait``). One step, the same shape whatever
        the occupancy or policy mix."""
        decoding = [s for s in range(self.slots)
                    if self._slots[s] is not None
                    and self._slots[s].state == "decode"]
        if not decoding:
            return False
        self._cow_guard(decoding)
        t0 = time.perf_counter()
        nxt, topv, topi = self._decode_step(self._decode_feed())
        self.metrics.observe_latency(time.perf_counter() - t0,
                                     name="decode_step")
        self.metrics.inc("decode_steps")
        self.metrics.inc("decode_tokens", len(decoding))
        self.metrics.set_gauge("batch_occupancy",
                               len(decoding) / self.slots)
        beam_rows: Dict[BeamJob, dict] = {}
        parent_rows = []  # (job, slot): full-prefix-hit first rows
        for slot in decoding:
            st = self._slots[slot]
            if st is None:
                continue
            if st.beam_job is not None:
                if st.role == "beam_parent":
                    st.role = "beam"
                    parent_rows.append((st.beam_job, slot))
                else:
                    beam_rows.setdefault(st.beam_job, {})[slot] = (
                        topv[slot], topi[slot])
                continue
            self._pos[slot] += 1
            self._tok[slot] = nxt[slot]
            self._emit(slot, int(nxt[slot]))
        for job, slot in parent_rows:
            job.on_parent_row(topv[slot], topi[slot])
        for job, rows in beam_rows.items():
            job.on_decode_rows(rows)
        self._gauges()
        return True

    # -- beam search as paged forks -------------------------------------------
    def _fork_layout(self, pages: List[int], n_written: int):
        """How a fork views the source's table after ``n_written``
        positions: (pages shared as they are, fresh pages to allocate,
        whether the boundary falls inside a page). Fully written pages
        are shared by refcount; the partially written boundary page is
        shared with one copy-on-write spare; entries not yet written get
        fresh pages."""
        ps = self.page_size
        n_share = min(len(pages),
                      n_written // ps + (1 if n_written % ps else 0))
        return n_share, len(pages) - n_share, bool(n_written % ps)

    def _beam_can_fork(self, job, n_forks: int, n_written: int) -> bool:
        """Pool feasibility of ``n_forks`` forks of ``job``'s cache view,
        checked before any state changes, so a rerank applies whole or
        parks whole."""
        if n_forks <= 0:
            return True
        slot = (job.parent_slot if not job.expanded
                else job.live_slots()[0])
        _, own_n, partial = self._fork_layout(self._slots[slot].pages,
                                              n_written)
        need = n_forks * (own_n + (2 if partial else 0))  # COW + top-up
        if need and self.pool.available() < need \
                and self.prefix_index is not None:
            self.prefix_index.evict_until(need)
        return self.pool.available() >= need

    def _beam_fork(self, src_slot: int, hold_slot: int,
                   n_written: int) -> int:
        """Fork ``src_slot``'s hypothesis into a parked hold slot: the
        written prefix is shared (refcounts on an int32 table copy; no
        cache bytes move), the boundary page gets a copy-on-write spare,
        and future entries allocate fresh. ``_beam_can_fork`` checked the
        pool."""
        st_src = self._slots[src_slot]
        n_share, own_n, partial = self._fork_layout(st_src.pages,
                                                    n_written)
        shared = st_src.pages[:n_share]
        for pid in shared:
            self.pool.incref(pid)
        owned = [self.pool.alloc() for _ in range(own_n)]
        st = self._slots[hold_slot]
        st.pages = list(shared) + owned
        if partial:
            self.pool.reserve(1)
            st.cow_reserve = 1
            if st_src.cow_reserve == 0:
                # the source's boundary page is shared now too: whichever
                # sibling writes first copies, so both hold a spare
                self.pool.reserve(1)
                st_src.cow_reserve = 1
        st.state = "decode"
        st.role = "beam"
        st.prefill_done = int(st.prompt.size)
        self.metrics.inc("beam_forks")
        self.metrics.inc("beam_shared_pages", n_share)
        return hold_slot

    def _beam_release(self, slot: int, job) -> None:
        """A hypothesis died (or froze): its pages go back to the pool and
        the slot parks as a hold for later forks of this job."""
        st = self._slots[slot]
        self._release_pages(st)
        st.state = st.role = "hold"
        job.holds.append(slot)

    def _beam_park(self, job) -> None:
        """Pool-parked: the job's slots sit out decode ticks until a
        retry (``_beam_maintenance``) finds pages."""
        for slot in self._beam_live(job):
            self._slots[slot].state = "beam_wait"
        self.metrics.inc("beam_parked")

    def _beam_unpark(self, job) -> None:
        for slot in self._beam_live(job):
            self._slots[slot].state = "decode"

    @staticmethod
    def _beam_live(job) -> List[int]:
        """The job's slots that decode: its live hypotheses, or its
        parent before the expansion."""
        return job.live_slots() if job.expanded else [job.parent_slot]

    def _beam_free_slots(self, job) -> None:
        slots = set(job.holds) | set(job.live_slots())
        if not job.expanded:
            slots.add(job.parent_slot)
        for slot in slots:
            st = self._slots[slot]
            if st is not None:
                if st.pages:
                    self._release_pages(st)
                self._slots[slot] = None
        job.holds = []

    def _beam_finish(self, job, ids: np.ndarray,
                     scores: np.ndarray) -> None:
        """Every hypothesis frozen or at the horizon: free the job's slots
        and complete the request with ``(ids [K, Tp+N], scores [K])`` when
        it asked for all beams, else the best beam's ids cut after its
        eos."""
        self._beam_free_slots(job)
        if job in self._beam_jobs:
            self._beam_jobs.remove(job)
        if job.params.return_all:
            result = (ids, scores)
        else:
            result = ids[0]
            plen = int(job.prompt.size)
            if job.eos_id >= 0:
                hits = np.nonzero(result[plen:] == job.eos_id)[0]
                if hits.size:
                    result = result[:plen + int(hits[0]) + 1]
        latency = time.monotonic() - job.request.enqueue_t
        job.request.future.set_result(result)
        self.metrics.inc("completed")
        self.metrics.observe_latency(latency)

    def _beam_abort(self, job, exc) -> None:
        self._beam_free_slots(job)
        if job in self._beam_jobs:
            self._beam_jobs.remove(job)
        job.done = True
        self.metrics.inc("cache_exhausted")
        job.request.future.set_exception(exc)

    def _beam_maintenance(self) -> bool:
        """Retry pool-parked beam jobs; a job that can never get its pages
        (nothing else runs and eviction already failed) aborts typed
        instead of parking forever."""
        did = False
        for job in list(self._beam_jobs):
            if not job.waiting:
                continue
            if job.retry():
                did = True
                continue
            others = any(st is not None and st.beam_job is not job
                         for st in self._slots)
            if not others and not self._deferred:
                self._beam_abort(job, CacheExhaustedError(
                    f"beam_size {job.K} cannot get its fork pages "
                    f"({self.pool.available()} available and nothing "
                    "else in flight) — shrink the beam or grow n_pages",
                    pages_needed=job.K, pages_free=self.pool.available()))
        return did

    def generate_beam(self, prompt, beam_size: int = 4,
                      max_new_tokens: Optional[int] = None,
                      eos_id: Optional[int] = None,
                      length_penalty: float = 0.0,
                      return_all: bool = True):
        """Synchronous beam search through the engine loop. Returns
        ``(ids [K, Tp+N] best-first, scores [K])`` (``return_all=False``:
        the best beam's ids). Token-exact against
        ``transformer_stack_beam_search`` over the same weights."""
        req = Request({"prompt": prompt},
                      {"max_new_tokens": (max_new_tokens
                                          or self.default_max_new_tokens),
                       "eos_id": eos_id, "beam_size": int(beam_size),
                       "length_penalty": float(length_penalty),
                       "return_beams": bool(return_all)}, None)
        self._drive([req])
        return req.future.result(timeout=0.1)

    # -- state ----------------------------------------------------------------
    def _gauges(self):
        super()._gauges()
        self.metrics.set_gauge("mem/kv_pages_in_use",
                               self.pool.pages_in_use())
        self.metrics.set_gauge("mem/kv_pages_free", self.pool.available())
        self.metrics.set_gauge("beam_active_jobs", len(self._beam_jobs))
        if self.prefix_index is not None:
            self.metrics.set_gauge("kv_prefix_entries",
                                   len(self.prefix_index))

    def cache_stats(self) -> dict:
        """The page pool and prefix index, flattened to numbers, and the
        decode graph's captures and replays."""
        stats = {f"kv_pages_{k}": v for k, v in self.pool.stats().items()}
        if self.prefix_index is not None:
            for k, v in self.prefix_index.stats().items():
                stats[f"kv_prefix_{k}"] = v
        for name in ("decode_graph_captures", "decode_graph_replays"):
            stats[name] = self.metrics.counter(name)
        return stats

    # -- hard engine death ----------------------------------------------------
    def kill(self, reason: str = "chaos") -> int:
        """Paged kill: beam jobs and the deferred queue die with the slots
        (every future fails retryable) and pages go back to the pool."""
        exc = ConnectionError(f"replica killed mid-stream ({reason})")
        failed = 0
        for job in list(self._beam_jobs):
            self._beam_free_slots(job)
            self._beam_jobs.remove(job)
            job.done = True
            if not job.request.future.done():
                job.request.future.set_exception(exc)
                failed += 1
        for st in self._slots:
            if st is not None and st.pages:
                self._release_pages(st)
        failed += super().kill(reason)
        while self._deferred:
            req = self._deferred.popleft()[0]
            if not req.future.done():
                req.future.set_exception(exc)
                failed += 1
        self._gauges()
        return failed

    # -- later slices ---------------------------------------------------------
    def export_slot(self, slot: int):
        raise NotImplementedError(_LATER.format("KV handoff (export_slot)"))

    def adopt_slot(self, handoff):
        raise NotImplementedError(_LATER.format("KV handoff (adopt_slot)"))

    def swap_params(self, source, *, strict: bool = True):
        raise NotImplementedError(_LATER.format("rolling weight update "
                                                "(swap_params)"))

    def warm_from_manifest(self, *args, **kw):
        raise NotImplementedError(_LATER.format("warmup manifests"))

    def save_manifest(self, *args, **kw):
        raise NotImplementedError(_LATER.format("warmup manifests"))

    # -- server-driver interface ----------------------------------------------
    def serve_step(self, batcher,
                   idle_wait_s: Optional[float] = None) -> bool:
        """One engine tick: retry pool-parked beam jobs and deferred
        admissions, admit queued requests into free slots, advance one
        prefill chunk, then one decode step."""
        if self._killed:
            return self._drain_killed(batcher)
        did = self._beam_maintenance()
        did = self._admit_deferred() > 0 or did
        free = self.free_slots
        if free and not self._deferred:
            wait = 0 if (self.active or did) else idle_wait_s
            reqs = batcher.next_batch(max_n=free, wait_s=wait)
            if reqs:
                did = self.admit(reqs) > 0 or did
        did = self.prefill_tick() or did
        did = self.decode_tick() or did
        return did

    def _drive(self, reqs: List[Request]) -> None:
        """Run the engine loop until every given request completes, beam
        jobs included."""
        pending = list(reqs)
        while pending or self.active or self._deferred or self._beam_jobs:
            if pending and self.free_slots and not self._deferred:
                k = min(len(pending), self.free_slots)
                self.admit(pending[:k])
                pending = pending[k:]
            self._beam_maintenance()
            self._admit_deferred()
            self.prefill_tick()
            self.decode_tick()

    def generate_all(self, prompts: Sequence[Sequence[int]],
                     max_new_tokens: Optional[int] = None,
                     eos_id: Optional[int] = None,
                     sampling=None) -> List[np.ndarray]:
        """``sampling``: one SamplingParams for every prompt, or a list
        (one per prompt): mixed policies ride one continuous batch."""
        prompts = list(prompts)
        max_new = max_new_tokens or self.default_max_new_tokens
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling] * len(prompts)
        reqs = [Request({"prompt": p},
                        {"max_new_tokens": max_new, "eos_id": eos_id,
                         "sampling_params": sp}, None)
                for p, sp in zip(prompts, sampling)]
        self._drive(reqs)
        return [r.future.result(timeout=0.1) for r in reqs]
