"""Decode policies of the port: per-request sampling, stop sequences and
per-step token masks (``paddle_tpu/decoding`` without beam search and
seq2seq, which are later slices)."""
from .masks import JsonSchemaMask, LogitsProcessor, TokenBanMask
from .params import SamplingParams
from .stops import StopMatcher

__all__ = ["JsonSchemaMask", "LogitsProcessor", "SamplingParams",
           "StopMatcher", "TokenBanMask"]
