"""Decode policies of the port: per-request sampling, stop sequences,
per-step token masks, beam search as paged forks (:class:`BeamJob`,
``PagedGenerationEngine.generate_beam``) and the encoder-decoder engine
(:class:`Seq2SeqGenerationEngine`)."""
from .beam import BeamJob
from .masks import JsonSchemaMask, LogitsProcessor, TokenBanMask
from .params import BeamParams, SamplingParams
from .stops import StopMatcher

__all__ = ["BeamJob", "BeamParams", "JsonSchemaMask", "LogitsProcessor",
           "SamplingParams", "Seq2SeqGenerationEngine", "Seq2SeqSpec",
           "StopMatcher", "TokenBanMask"]


def __getattr__(name):  # lazy: seq2seq imports serving, which imports us
    if name in ("Seq2SeqSpec", "Seq2SeqGenerationEngine"):
        from . import seq2seq

        return getattr(seq2seq, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
