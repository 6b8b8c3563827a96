"""Per-step logits-processor hook: host-side token masks fed per tick.

The port's copy of ``paddle_tpu/decoding/masks.py`` (numpy only).

A :class:`LogitsProcessor` computes, for each decode step, the set of
token ids the request may emit next. The engine gathers every masked
request's row into ONE [slots, vocab] mask tensor fed into the compiled
decode step — the mask is data, not program, so constrained and
unconstrained requests share the same compile-cache entry and the
steady state stays at zero fresh compiles.

:class:`JsonSchemaMask` is the shipped exemplar: grammar-constrained
decoding of a (restricted) JSON value over a character-level token
mapping. It demonstrates the full pattern — incremental state from the
tokens emitted so far, viable-prefix computation per candidate token —
in a form small enough to read; a production grammar engine plugs into
the same two-method protocol.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np


class LogitsProcessor:
    """The per-step token-mask protocol.

    ``mask(step, generated)`` returns a [vocab] float32 vector — 1.0
    where the token is allowed, 0.0 where banned — given the tokens this
    request has emitted so far. Called on the host once per decode tick
    per masked request; the engine feeds the stacked rows into the
    decode computation. A processor must never ban EVERY token (the
    engine substitutes an all-ones row and counts
    ``mask_dead_ends`` if one does).
    """

    vocab_size: int = 0

    def mask(self, step: int, generated: Sequence[int]) -> np.ndarray:
        raise NotImplementedError


class TokenBanMask(LogitsProcessor):
    """Statically ban a token set (the minimal processor — e.g. keep a
    chat model from emitting reserved control ids)."""

    def __init__(self, vocab_size: int, banned: Sequence[int]):
        self.vocab_size = int(vocab_size)
        self._row = np.ones(self.vocab_size, np.float32)
        for t in banned:
            self._row[int(t)] = 0.0

    def mask(self, step: int, generated: Sequence[int]) -> np.ndarray:
        return self._row


class JsonSchemaMask(LogitsProcessor):
    """Constrain generation to JSON matching a (restricted) schema, over
    a character-level vocab map ``{token_id: char}``.

    Supported schemas (enough to demo the hook end to end):
      {"type": "object", "properties": {name: {"type": "integer"|
      "string"}, ...}}  — all properties required, emitted in the
      declared order — plus bare {"type": "integer"} / {"type":
      "string"} / {"type": "array", "items": {"type": "integer"}}.

    Each step recomputes the viable next-character set by checking, for
    every vocab char, whether prefix+char can still extend to a document
    matching the schema; the emitted text therefore parses as valid JSON
    of the right shape BY CONSTRUCTION (pinned by test). Pair with a
    ``stop`` sequence or eos once the document closes.
    """

    def __init__(self, token_chars: Dict[int, str], schema: dict,
                 vocab_size: Optional[int] = None):
        self.token_chars = {int(k): v for k, v in token_chars.items()}
        for tid, ch in self.token_chars.items():
            if len(ch) != 1:
                raise ValueError(
                    f"JsonSchemaMask is character-level: token {tid} maps "
                    f"to {ch!r} (len {len(ch)})")
        self.vocab_size = int(vocab_size if vocab_size is not None
                              else max(self.token_chars) + 1)
        self.schema = schema
        self._grammar = _schema_strings(schema)

    def text_of(self, generated: Sequence[int]) -> str:
        return "".join(self.token_chars.get(int(t), "") for t in generated)

    def complete(self, generated: Sequence[int]) -> bool:
        """Does the emitted text already form a COMPLETE document
        matching the schema? (The engine's stop hook asks this when the
        processor is also the stopping rule.)"""
        return _matches(self._grammar, self.text_of(generated))

    def mask(self, step: int, generated: Sequence[int]) -> np.ndarray:
        prefix = self.text_of(generated)
        row = np.zeros(self.vocab_size, np.float32)
        for tid, ch in self.token_chars.items():
            if _viable(self._grammar, prefix + ch):
                row[tid] = 1.0
        return row


# --------------------------------------------------------------------------
# viable-prefix machinery: the schema compiles to a set of sketch strings
# with digit/char wildcards; a prefix is viable iff it prefixes some
# concrete expansion. Restricted value domains keep this exact and tiny:
# integers are 1-3 digits, strings are 0-4 chars of [a-z].
# --------------------------------------------------------------------------
_DIGITS = "0123456789"
_ALPHA = "abcdefghijklmnopqrstuvwxyz"
_MAX_INT_DIGITS = 3
_MAX_STR_CHARS = 4


def _int_skeletons():
    return ["#" * n for n in range(1, _MAX_INT_DIGITS + 1)]


def _str_skeletons():
    return ['"' + "@" * n + '"' for n in range(_MAX_STR_CHARS + 1)]


def _value_skeletons(schema: dict):
    t = schema.get("type")
    if t == "integer":
        return _int_skeletons()
    if t == "string":
        return _str_skeletons()
    if t == "array":
        item = schema.get("items") or {"type": "integer"}
        inner = _value_skeletons(item)
        outs = ["[]"]
        for n in (1, 2):
            for combo in _combos(inner, n):
                outs.append("[" + ",".join(combo) + "]")
        return outs
    if t == "object":
        props = schema.get("properties") or {}
        parts_per_key = []
        for name, sub in props.items():
            vals = _value_skeletons(sub)
            parts_per_key.append([f'"{name}":{v}' for v in vals])
        outs = []

        def rec(i, acc):
            if i == len(parts_per_key):
                outs.append("{" + ",".join(acc) + "}")
                return
            for p in parts_per_key[i]:
                rec(i + 1, acc + [p])

        rec(0, [])
        return outs or ["{}"]
    raise ValueError(f"unsupported schema {schema!r}")


def _combos(options, n):
    if n == 1:
        return [[o] for o in options]
    return [[o] + rest for o in options for rest in _combos(options, n - 1)]


def _schema_strings(schema: dict):
    return _value_skeletons(schema)


def _char_fits(sk_ch: str, ch: str) -> bool:
    if sk_ch == "#":
        return ch in _DIGITS
    if sk_ch == "@":
        return ch in _ALPHA
    return sk_ch == ch


def _prefix_of(skeleton: str, text: str) -> bool:
    if len(text) > len(skeleton):
        return False
    return all(_char_fits(s, c) for s, c in zip(skeleton, text))


def _viable(skeletons, text: str) -> bool:
    return any(_prefix_of(sk, text) for sk in skeletons)


def _matches(skeletons, text: str) -> bool:
    ok = any(len(sk) == len(text) and _prefix_of(sk, text)
             for sk in skeletons)
    if not ok:
        return False
    try:  # defense in depth: the emitted document must really parse
        json.loads(text)
        return True
    except ValueError:
        return False
