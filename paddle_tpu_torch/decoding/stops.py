"""Stop-sequence matching: host-side truncation of the decode stream.

The port's copy of ``paddle_tpu/decoding/stops.py``.

A request may carry token-id stop sequences (``SamplingParams.stop``).
After every emitted token the engine asks the matcher whether the
generated tail now ends with any stop sequence; on a match the request
finishes and the returned ids are truncated BEFORE the match (the stop
sequence itself is not returned — the OpenAI-style contract). Matching
is pure host bookkeeping over the generated list, so a stop can land
anywhere — including mid-page on the paged cache, where the already-
written K/V rows past the truncation point are simply released with the
request's pages.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


class StopMatcher:
    """Incremental matcher over one request's generated tokens."""

    __slots__ = ("sequences", "_max_len")

    def __init__(self, sequences: Sequence[Tuple[int, ...]]):
        self.sequences = tuple(tuple(int(t) for t in s)
                               for s in (sequences or ()))
        self._max_len = max((len(s) for s in self.sequences), default=0)

    def __bool__(self) -> bool:
        return bool(self.sequences)

    def match(self, generated: Sequence[int]) -> Optional[int]:
        """If ``generated`` now ENDS with a stop sequence, return the
        truncation length (tokens to keep, i.e. the match start);
        otherwise None. Longest match wins when several end here."""
        if not self.sequences:
            return None
        n = len(generated)
        best = None
        for seq in self.sequences:
            m = len(seq)
            if m <= n and tuple(generated[n - m:]) == seq:
                keep = n - m
                if best is None or keep < best:
                    best = keep
        return best
