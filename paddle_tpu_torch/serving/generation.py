"""Continuous batching for autoregressive generation (Orca-style).

Counterpart of ``paddle_tpu/serving/generation.py``, dense KV layout:
each request claims a slot of the slot table ``[L, slots+1, Hkv, Tmax,
dh]``, a prefill writes its prompt K/V, and ONE decode step advances
every occupied slot each tick — finished sequences vacate between ticks
and queued requests join mid-flight. The extra slot (index ``slots``) is
a scrap slot: padding rows of a partially filled prefill bucket scatter
their K/V there, so every prefill shape is a (batch bucket, prompt
bucket) pair whatever the number of requests.

Prefill attention runs the sm_90a flash kernel on a CUDA device. The
paged layout (the JAX package's default engine) is a later slice of the
port, so ``kv_cache`` must be ``"dense"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..decoding.params import SamplingParams
from ..models.transformer import TransformerLM
from ..ops.pipeline_ops import (transformer_stack_slot_decode,
                                transformer_stack_slot_prefill)
from .batcher import Request
from .errors import BadRequestError
from .metrics import MetricsRegistry

_PAD_ID = 0  # token id of prefill padding (masked, never attended)


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
                 "timeline")

    def __init__(self, request: Request, prompt: np.ndarray,
                 max_new: int, eos_id: Optional[int]):
        self.request = request
        self.prompt = prompt
        self.generated: List[int] = []
        self.max_new = max_new
        self.eos_id = eos_id
        self.timeline = RequestTimeline(request.enqueue_t)


class GenerationEngine:
    """Continuous batcher over the dense slot cache.

    ``model`` is a :class:`TransformerLM` on ``device``, or a dict of the
    JAX package's parameters (numpy arrays under the JAX names) to load
    onto it. ``device`` defaults to ``cuda`` and raises without CUDA;
    pass ``device="cpu"`` to run the plain versions of the kernels.
    Engine-wide temperature / top-k sampling draws from a
    ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, spec: LMSpec,
                 model: Union[TransformerLM, Dict[str, np.ndarray]], *,
                 slots: int = 8,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 default_max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 kv_cache: Optional[str] = None, device=None,
                 seed: int = 0):
        from .. import resolve_device

        if kv_cache in (None, "paged"):
            raise NotImplementedError(
                "the paged KV cache (the JAX package's default engine) "
                "lands in the paged-serving slice of the port; pass "
                "kv_cache='dense'")
        if kv_cache != "dense":
            raise ValueError(f"kv_cache must be 'dense', got {kv_cache!r}")
        if slots < 1:
            raise ValueError("need at least one decode slot")
        self.device = resolve_device(device)
        self.spec = spec
        self.slots = int(slots)
        self.tmax = int(spec.max_len)
        SamplingParams(temperature=float(temperature),
                       top_k=int(top_k)).validate(spec.vocab_size)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
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
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
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
                                             self.generator)
        return res["NextTok"][0].cpu().numpy()

    @torch.no_grad()
    def _run_decode(self) -> np.ndarray:
        dev = self.device
        ins = {"Tok": [torch.from_numpy(self._tok).to(dev)],
               "Pos": [torch.from_numpy(self._pos).to(dev)],
               "CacheK": [self.cache_k], "CacheV": [self.cache_v],
               **self._lm_ins}
        res = transformer_stack_slot_decode(self._decode_attrs(), ins,
                                            self.generator)
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
        self.prompt_bucket_for(prompt.size)  # raises when over-long
        eos = req.meta.get("eos_id")
        return prompt, max_new, self.eos_id if eos is None else eos

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
        if (len(st.generated) >= st.max_new
                or (st.eos_id is not None and token == st.eos_id)):
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        self._slots[slot] = None
        ids = np.concatenate([st.prompt, np.asarray(st.generated, np.int64)])
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
