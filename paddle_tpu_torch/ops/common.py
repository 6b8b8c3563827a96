"""Shared helpers for the port's op functions.

Counterpart of ``paddle_tpu/ops/common.py``, cut to what the serving
path uses. An op takes ``ins``, a dict of slot name -> [tensor], and
returns the same shape of dict, so it is called exactly like its JAX
twin.

Precision: the JAX package's default (``--use_amp`` off, default MXU
precision) is f32 compute, and so is the port's. Matrix products run in
full f32: PyTorch leaves ``torch.backends.cuda.matmul.allow_tf32`` off
unless a caller turns it on. bf16 serving is a later slice.
"""
from __future__ import annotations


def single(ins, slot):
    """The single tensor bound to ``slot`` (KeyError if absent)."""
    return ins[slot][0]


def maybe(ins, slot):
    vals = ins.get(slot)
    return vals[0] if vals else None


def out(**kw):
    """Build an output dict: out(Out=x) -> {"Out": [x]}; lists pass
    through."""
    return {k: (v if isinstance(v, list) else [v]) for k, v in kw.items()}
