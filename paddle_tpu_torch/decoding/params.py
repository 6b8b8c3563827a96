"""Per-request decode policy: the one object a request carries.

The port's copy of ``paddle_tpu/decoding/params.py``'s
:class:`SamplingParams`: temperature, top-k, top-p, a per-request seed,
max_tokens, stop sequences and a logits processor, merged request over
engine default field by field (:meth:`SamplingParams.from_meta`). The
paged engine feeds each row's policy into its one decode step; a sampled
request's tokens are a function of (request, ``seed``) alone, drawn from
``fold_in(PRNGKey(seed), step)`` (``core/prng.py``) exactly as the JAX
package draws them. :class:`BeamParams` is a beam request's policy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _freeze_stop(stop) -> Tuple[Tuple[int, ...], ...]:
    """Normalize stop input (one sequence or a list of sequences of token
    ids) to a tuple of non-empty int tuples."""
    if stop is None:
        return ()
    seqs = list(stop)
    if seqs and isinstance(seqs[0], int):  # a single flat sequence
        seqs = [seqs]
    out = []
    for s in seqs:
        ids = tuple(int(t) for t in s)
        if not ids:
            raise ValueError("empty stop sequence")
        out.append(ids)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """One request's decode policy.

    temperature: 0.0 = greedy argmax; > 0 samples the scaled distribution.
    top_k:       keep only the k most likely tokens (0 = off).
    top_p:       nucleus sampling — smallest token set covering this
                 probability mass (1.0 = off).
    seed:        per-request RNG seed. Sampled tokens are reproducible as
                 a function of (request, seed) regardless of batch
                 composition; None lets the engine assign one.
    max_tokens:  generation horizon (None = the engine default).
    stop:        token-id sequences that end generation; the matched
                 sequence is NOT included in the returned ids.
    logits_processor: a per-step token-mask hook
                 (:class:`~.masks.LogitsProcessor`): grammar/JSON-schema
                 constrained decoding rides here.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    max_tokens: Optional[int] = None
    stop: Tuple[Tuple[int, ...], ...] = ()
    logits_processor: object = None

    # meta keys a request may carry (the /v1/generate request schema)
    _META_KEYS = ("temperature", "top_k", "top_p", "seed", "stop")

    def __post_init__(self):
        object.__setattr__(self, "stop", _freeze_stop(self.stop))

    def validate(self, vocab_size: Optional[int] = None) -> None:
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if vocab_size is not None and self.top_k > vocab_size:
            raise ValueError(f"top_k {self.top_k} exceeds the vocab "
                             f"({vocab_size})")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.seed is not None and not (0 <= int(self.seed) < 2 ** 32):
            raise ValueError(f"seed must fit uint32, got {self.seed}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if vocab_size is not None:
            for s in self.stop:
                for t in s:
                    if not 0 <= t < vocab_size:
                        raise ValueError(
                            f"stop token {t} outside the vocab "
                            f"({vocab_size})")

    @property
    def sampled(self) -> bool:
        return self.temperature > 0

    @classmethod
    def from_meta(cls, meta: dict,
                  default: Optional["SamplingParams"] = None
                  ) -> "SamplingParams":
        """Merge request meta over the engine default: any field the
        request carries wins; absent fields inherit the default."""
        default = default or cls()
        meta = meta or {}
        kw = {}
        for key in cls._META_KEYS:
            if meta.get(key) is not None:
                kw[key] = meta[key]
        if meta.get("logits_processor") is not None:
            kw["logits_processor"] = meta["logits_processor"]
        if not kw:
            return default
        return dataclasses.replace(default, **kw)

    def with_seed(self, seed: int) -> "SamplingParams":
        return dataclasses.replace(self, seed=int(seed))


@dataclasses.dataclass(frozen=True)
class BeamParams:
    """Beam-search policy for a request (``beam_size`` in the request
    meta / /v1/generate body). Beam decode is deterministic: sampling
    fields are ignored for beam requests."""

    beam_size: int = 4
    length_penalty: float = 0.0  # GNMT ((5+len)/6)^alpha normalization
    eos_id: Optional[int] = None
    return_all: bool = False     # future result = (ids [K, T], scores [K])

    def validate(self, vocab_size: Optional[int] = None) -> None:
        if self.beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got "
                             f"{self.beam_size}")
        if vocab_size is not None and self.beam_size > vocab_size:
            raise ValueError(f"beam_size {self.beam_size} exceeds the "
                             f"vocab ({vocab_size})")

    @classmethod
    def from_meta(cls, meta: dict) -> Optional["BeamParams"]:
        k = (meta or {}).get("beam_size")
        if not k or int(k) <= 1:
            return None
        return cls(beam_size=int(k),
                   length_penalty=float(meta.get("length_penalty") or 0.0),
                   eos_id=meta.get("eos_id"),
                   return_all=bool(meta.get("return_beams", False)))
