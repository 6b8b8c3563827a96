"""Seq2seq (NMT) serving: the encoder-decoder configuration of the paged
engine.

Counterpart of ``paddle_tpu/decoding/seq2seq.py``.
:class:`Seq2SeqGenerationEngine` extends the paged continuous batcher
with the encoder-decoder split:

- **Admission runs the encoder once, pooled.** A request carries a
  source sentence; admission takes a cross-KV row for it and queues the
  encoder pass, and the queue flushes as bucket-padded batches (one
  ``transformer_encdec_encode`` call per source bucket per admission
  round, padded to ``encode_batch_buckets``) before anything attends the
  rows. The per-layer cross-attention K/V parks in a slot-resident cache
  ``[L, slots+1, Hkv, Ts, dh]`` (row ``slots`` is scrap) beside the
  self-attention page pool, written in place: the captured decode graph
  reads it at a fixed address.
- **Decode is the paged loop plus one cross read a layer**
  (``transformer_stack_cross_decode``), the request's parked rows
  addressed by a per-slot ``XSlot`` index in the step's feed.
- **Beam forks share the source.** The cross cache is read only after
  admission, so a hypothesis fork bumps a refcount on its parent's cross
  row instead of copying it: K beams of one translation carry one copy
  of the source K/V.

Prefix sharing is off: decoder K/V depend on the source through
cross-attention, so pages are not reusable across requests with
different sources. The JAX engine's trace spans around the encoder pass
are not ported (the port's engines carry no spans yet); the
``serving/encode`` profiler timer is.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import profiler
from ..core.scope import Scope
from ..ops.pipeline_ops import _STACK_SLOTS
from ..ops.seq2seq_ops import (transformer_encdec_encode,
                               transformer_stack_cross_decode,
                               transformer_stack_cross_prefill)
from ..serving.batcher import Request
from ..serving.errors import BadRequestError
from ..serving.generation import _PLANE, LMSpec, PagedGenerationEngine
from .params import SamplingParams

# the cross weights each decode step reads, and the encoder's weights
_CROSS_WEIGHTS = {"XLnS": "xattn.stack_ln_s", "XLnB": "xattn.stack_ln_b",
                  "XQW": "xattn.stack_q_w", "XOutW": "xattn.stack_out_w"}
_ENCODER_WEIGHTS = {"SrcTokEmb": "src_emb", "SrcPosEmb": "src_pos_emb",
                    "EncLnS": "enc_ln.scale", "EncLnB": "enc_ln.bias",
                    "XKvW": "xattn.stack_kv_w",
                    **{f"Enc{slot}": f"enc_stack.stack_{key}"
                       for slot, key in _STACK_SLOTS.items()}}


@dataclasses.dataclass
class Seq2SeqSpec:
    """Hyperparameters of the transformer NMT model (the
    ``models.shared_nmt_params`` weight contract)."""

    src_vocab_size: int
    tgt_vocab_size: int
    d_model: int
    n_layers: int
    num_heads: int
    num_kv_heads: Optional[int] = None
    max_src_len: int = 64
    max_tgt_len: int = 64
    d_ff: Optional[int] = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def lm_spec(self) -> LMSpec:
        """The decoder viewed as a stacked LM (what the base engine sizes
        its steps and pools by)."""
        return LMSpec(vocab_size=self.tgt_vocab_size, d_model=self.d_model,
                      n_layers=self.n_layers, num_heads=self.num_heads,
                      num_kv_heads=self.num_kv_heads,
                      max_len=self.max_tgt_len, d_ff=self.d_ff)


def _default_src_buckets(tsmax: int) -> List[int]:
    buckets, b = [], 8
    while b < tsmax:
        buckets.append(b)
        b *= 2
    buckets.append(tsmax)
    return sorted(set(buckets))


def _numpy_weights(weights) -> Dict[str, np.ndarray]:
    """A Scope's tensors (a trained program's scope, or one made by
    ``scope_from_numpy``; its RNG state and other non-tensor entries
    are skipped) or a dict of arrays, as host arrays."""
    if isinstance(weights, Scope):
        weights = {n: weights.get(n) for n in weights.keys()
                   if isinstance(weights.get(n), torch.Tensor)}
    def host(v):
        if not isinstance(v, torch.Tensor):
            return np.asarray(v)
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() else v).numpy()

    return {n: host(v) for n, v in weights.items()}


class Seq2SeqGenerationEngine(PagedGenerationEngine):
    """Continuous batching for encoder-decoder generation; see the module
    docstring. ``weights``: a :class:`~paddle_tpu_torch.Scope` holding the
    ``shared_nmt_params`` names (a trained scope) or a dict of numpy
    arrays under them. Payloads are ``{"src": [ids]}`` with an optional
    ``"prompt"`` target prefix (default ``[bos_id]``); per-request
    sampling, stop sequences, token masks and beam requests are the
    paged engine's."""

    _plane = _PLANE + (("XSlot", "xslot"), ("SrcLen", "src_len"))
    _prefill_op = staticmethod(transformer_stack_cross_prefill)
    _decode_op = staticmethod(transformer_stack_cross_decode)

    def __init__(self, spec: Seq2SeqSpec, weights, *, bos_id: int = 0,
                 src_buckets: Optional[Sequence[int]] = None,
                 encode_batch_buckets: Optional[Sequence[int]] = None,
                 beam_width: int = 4, **kw):
        self.seq2seq = spec
        self.bos_id = int(bos_id)
        self.src_buckets = sorted(set(
            min(int(b), spec.max_src_len)
            for b in (src_buckets or _default_src_buckets(spec.max_src_len))))
        kw.pop("prefix_sharing", None)  # unsound across sources
        weights = _numpy_weights(weights)
        self._host_weights = weights  # read once by _init_cache
        super().__init__(spec.lm_spec(), weights, beam_width=beam_width,
                         prefix_sharing=False, **kw)
        del self._host_weights
        # sources admitted in one round encode together, padded to these
        # batch buckets; (1,) encodes each request alone, token-exactly
        self.encode_batch_buckets = sorted(set(
            max(1, min(int(b), self.slots))
            for b in (encode_batch_buckets or (1, 2, 4, 8))))

    # -- cross-KV cache ---------------------------------------------------
    def _init_cache(self):
        super()._init_cache()
        s = self.seq2seq
        dev = self.device

        def on_device(names):
            return {slot: [torch.tensor(self._host_weights[n],
                                        dtype=torch.float32, device=dev)]
                    for slot, n in names.items()}

        self._cross_w = on_device(_CROSS_WEIGHTS)
        self._encoder_w = on_device(_ENCODER_WEIGHTS)
        # row `slots` is the scrap row (vacant decode slots attend it)
        shape = (s.n_layers, self.slots + 1, s.kv_heads, s.max_src_len,
                 s.head_dim)
        self.cross_k = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.cross_v = torch.zeros_like(self.cross_k)
        # host-side cross-row accounting: a request takes one row at
        # admission; beam forks share it by refcount
        self._xrow_free = list(range(self.slots - 1, -1, -1))
        self._xrow_ref = np.zeros(self.slots, np.int32)
        self._xrow_len = np.ones(self.slots, np.int32)
        self._pending_encodes: List[tuple] = []  # (xrow, src) queue
        self.metrics.set_gauge("mem/cross_kv_bytes",
                               2.0 * float(np.prod(shape)) * 4)

    def _state_ins(self) -> Dict[str, list]:
        return {**super()._state_ins(), "CrossK": [self.cross_k],
                "CrossV": [self.cross_v], **self._cross_w}

    # -- the per-row plane ------------------------------------------------
    def _neutral_sampling_feed(self, rows: int):
        feed = super()._neutral_sampling_feed(rows)
        # vacant rows attend the scrap cross row, one position deep
        feed["xslot"] = np.full(rows, self.slots, np.int32)
        feed["src_len"] = np.ones(rows, np.int32)
        return feed

    def _slot_sampling_feed(self, row, st, feed, step):
        super()._slot_sampling_feed(row, st, feed, step)
        if st.xrow is not None:
            feed["xslot"][row] = st.xrow
            feed["src_len"][row] = self._xrow_len[st.xrow]

    def _src_bucket_for(self, n: int) -> int:
        for b in self.src_buckets:
            if n <= b:
                return b
        raise BadRequestError(
            f"source length {n} exceeds the largest source bucket "
            f"{self.src_buckets[-1]}")

    # -- admission --------------------------------------------------------
    def _validate(self, req: Request):
        payload = req.payload
        if not isinstance(payload, dict) or payload.get("src") is None:
            raise BadRequestError(
                "seq2seq request needs {'src': [ids]} (+ optional "
                "'prompt' target prefix)")
        try:
            src = np.asarray(payload["src"], np.int64).reshape(-1)
        except (TypeError, ValueError) as exc:
            raise BadRequestError(f"bad src payload: {exc}")
        if src.size < 1:
            raise BadRequestError("empty src")
        self._src_bucket_for(src.size)  # raises when over-long
        if payload.get("prompt") is None:
            req.payload = dict(payload,
                               prompt=np.asarray([self.bos_id], np.int64))
        parsed = super()._validate(req)
        req.meta["_src"] = src
        return parsed

    def _take_xrow(self, src: np.ndarray) -> int:
        if not self._xrow_free:  # slots >= requests, so rows suffice
            raise RuntimeError("cross-KV rows exhausted (engine bug)")
        row = self._xrow_free.pop()
        self._xrow_ref[row] = 1
        self._xrow_len[row] = src.size
        return row

    def _release_pages(self, st) -> None:
        super()._release_pages(st)
        if st.xrow is not None:
            row, st.xrow = st.xrow, None
            self._xrow_ref[row] -= 1
            if self._xrow_ref[row] == 0:
                self._xrow_free.append(row)

    def _admit_one(self, req, prompt, max_new, eos, sampling, beam,
                   group) -> str:
        r = super()._admit_one(req, prompt, max_new, eos, sampling, beam,
                               group=group)
        if r != "ok":
            return r
        slot = next(i for i, st in enumerate(self._slots)
                    if st is not None and st.request is req
                    and st.role in ("normal", "beam_parent"))
        src = req.meta["_src"]
        row = self._take_xrow(src)
        self._slots[slot].xrow = row
        self._pending_encodes.append((row, src))
        return r

    # -- the encoder pass -------------------------------------------------
    def _enc_bucket_for(self, n: int) -> int:
        for b in self.encode_batch_buckets:
            if n <= b:
                return b
        return self.encode_batch_buckets[-1]

    @torch.no_grad()
    def _run_encode(self, src: np.ndarray, src_n: np.ndarray,
                    rows: np.ndarray) -> None:
        dev = self.device
        s = self.seq2seq
        transformer_encdec_encode(
            {"num_heads": s.num_heads, "num_kv_heads": s.num_kv_heads},
            {"SrcIds": [torch.from_numpy(src).to(dev)],
             "SrcLen": [torch.from_numpy(src_n).to(dev)],
             "SlotIds": [torch.from_numpy(rows).to(dev)],
             "CrossK": [self.cross_k], "CrossV": [self.cross_v],
             **self._encoder_w})

    def _encode_batch(self, ts: int, items) -> None:
        """One encoder pass for up to a batch bucket of admitted sources:
        each source's cross K/V goes into its row; padding rows target the
        scrap row."""
        nb = self._enc_bucket_for(len(items))
        src = np.zeros((nb, ts), np.int64)
        src_n = np.ones(nb, np.int32)
        rows = np.full(nb, self.slots, np.int32)
        for i, (row, s) in enumerate(items):
            src[i, :s.size] = s
            src_n[i] = s.size
            rows[i] = row
        t0 = time.perf_counter()
        with profiler.timer("serving/encode"):
            self._run_encode(src, src_n, rows)
        self.metrics.observe_latency(time.perf_counter() - t0,
                                     name="encode")
        self.metrics.inc("encodes", len(items))
        self.metrics.inc("encode_batches")

    def _flush_encodes(self) -> None:
        """Run every queued encoder pass, grouped by source bucket and
        padded to ``encode_batch_buckets``. Runs before any prefill or
        decode step attends the new cross rows."""
        if not self._pending_encodes:
            return
        pending, self._pending_encodes = self._pending_encodes, []
        # a request cancelled between admission and the flush released
        # its row (perhaps taken again in the same round): keep only the
        # newest pending write per still-referenced row
        live: Dict[int, np.ndarray] = {}
        for row, src in pending:
            if self._xrow_ref[row] > 0:
                live[row] = src
        by_ts: Dict[int, list] = {}
        for row, src in live.items():
            by_ts.setdefault(self._src_bucket_for(src.size),
                             []).append((row, src))
        cap = self.encode_batch_buckets[-1]
        for ts in sorted(by_ts):
            group = by_ts[ts]
            for i in range(0, len(group), cap):
                self._encode_batch(ts, group[i:i + cap])

    # every path into the device that attends cross rows flushes first
    def _run_prefill_group(self, group) -> None:
        self._flush_encodes()
        super()._run_prefill_group(group)

    def prefill_tick(self) -> bool:
        self._flush_encodes()
        return super().prefill_tick()

    def decode_tick(self) -> bool:
        self._flush_encodes()
        return super().decode_tick()

    # -- beam forks share the cross row ----------------------------------
    def _beam_fork(self, src_slot: int, hold_slot: int,
                   n_written: int) -> int:
        slot = super()._beam_fork(src_slot, hold_slot, n_written)
        row = self._slots[src_slot].xrow
        self._slots[slot].xrow = row
        self._xrow_ref[row] += 1
        return slot

    # -- warmup ------------------------------------------------------------
    def warmup(self) -> int:
        """The paged engine's warmup, then every (source bucket x encode
        batch bucket) encoder pass into the scrap row."""
        combos = super().warmup()
        for ts in self.src_buckets:
            for nb in self.encode_batch_buckets:
                self._run_encode(np.zeros((nb, ts), np.int64),
                                 np.ones(nb, np.int32),
                                 np.full(nb, self.slots, np.int32))
                combos += 1
        self.metrics.inc("warmup_compiles",
                         len(self.src_buckets) * len(self.encode_batch_buckets))
        return combos

    # -- convenience -------------------------------------------------------
    def translate(self, sources: Sequence[Sequence[int]],
                  max_new_tokens: Optional[int] = None,
                  eos_id: Optional[int] = None,
                  sampling=None) -> List[np.ndarray]:
        """Greedy or sampled translation of a source batch; returns
        [bos + generated target ids] per source."""
        sources = list(sources)
        max_new = max_new_tokens or self.default_max_new_tokens
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling] * len(sources)
        reqs = [Request({"src": s},
                        {"max_new_tokens": max_new, "eos_id": eos_id,
                         "sampling_params": sp}, None)
                for s, sp in zip(sources, sampling)]
        self._drive(reqs)
        return [r.future.result(timeout=0.1) for r in reqs]

    def translate_beam(self, src: Sequence[int], beam_size: int = 4,
                       max_new_tokens: Optional[int] = None,
                       eos_id: Optional[int] = None,
                       length_penalty: float = 0.0,
                       return_all: bool = True):
        """Beam-search translation of one source sentence: the encoder at
        admission, beams as paged forks sharing the source's cross-KV
        row."""
        req = Request({"src": src},
                      {"max_new_tokens": (max_new_tokens
                                          or self.default_max_new_tokens),
                       "eos_id": eos_id, "beam_size": int(beam_size),
                       "length_penalty": float(length_penalty),
                       "return_beams": bool(return_all)}, None)
        self._drive([req])
        return req.future.result(timeout=0.1)
