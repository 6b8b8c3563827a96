"""Structured errors of the op plane.

Counterpart of ``paddle_tpu/core/enforce.py``, cut to what the executor
uses: ``EnforceError`` and ``op_error``, which wraps a kernel failure
with the op's type, position, input shapes and the user's call site.
"""
from __future__ import annotations


class EnforceError(RuntimeError):
    """EnforceNotMet analogue."""


def format_input_sigs(ins) -> dict:
    """{slot: ['dtype[shape]', ...]} for tensors."""
    return {
        slot: [f"{getattr(a, 'dtype', type(a).__name__)}"
               f"{list(getattr(a, 'shape', ()))}" for a in arrs]
        for slot, arrs in ins.items()
    }


def op_error(op, index: int, ins, exc: BaseException) -> EnforceError:
    """Wrap a kernel failure with the op-level context: op type and
    position, input shapes and dtypes, and the call site if recorded."""
    shapes = format_input_sigs(ins)
    where = op.attrs.get("_callsite") or "<unknown call site>"
    msg = (f"op {op.type!r} (#{index} of the block) failed\n"
           f"  inputs: {shapes}\n  defined at: {where}\n"
           f"  cause: {type(exc).__name__}: {exc}")
    err = EnforceError(msg)
    err.__cause__ = exc
    return err
