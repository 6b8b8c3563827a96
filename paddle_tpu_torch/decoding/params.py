"""Decode policy: the port's copy of ``paddle_tpu/decoding/params.py``'s
:class:`SamplingParams` and its validation.

The dense engine applies one engine-wide policy (temperature, top-k);
per-request policies ride the paged engine, a later slice of the port.
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
    """One decode policy.

    temperature: 0.0 = greedy argmax; > 0 samples the scaled distribution.
    top_k:       keep only the k most likely tokens (0 = off).
    top_p:       nucleus sampling mass (1.0 = off).
    seed:        RNG seed (None lets the engine choose).
    max_tokens:  generation horizon (None = the engine default).
    stop:        token-id sequences that end generation.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    max_tokens: Optional[int] = None
    stop: Tuple[Tuple[int, ...], ...] = ()

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
