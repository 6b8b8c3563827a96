"""Op registry: op type name -> torch function + metadata.

Counterpart of ``paddle_tpu/core/registry.py``. Every op is a torch
function ``fn(attrs, ins) -> outs`` over ``{slot: [tensor]}`` dicts, the
same signature as its JAX twin. Shape inference (``infer_outputs``)
evaluates the function itself on ``meta`` tensors, which carry shape and
dtype and compute nothing: the torch counterpart of ``jax.eval_shape``,
so the kernels stay the one source of truth for output shapes.

Gradients: ops normally register no grad function; the backward pass
(``core/backward.py``) emits generic ``grad`` ops whose kernel is the vjp
of the registered forward. Ops register a ``grad_fn`` where that vjp is
wrong or wasteful (integer inputs, sparse grads, fused loss grads).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

Tensors = Dict[str, List[torch.Tensor]]  # slot -> list of tensors


@dataclasses.dataclass
class OpDef:
    type: str
    fn: Callable  # fn(attrs, ins, [rng]) -> outs
    # True, False, or a predicate over the op's attrs. When not False the
    # fn takes an ``rng`` keyword: a threefry key (``core/prng.py``), the
    # executor's split of its scope key.
    needs_rng: object = False
    # Custom vjp: grad_fn(attrs, ins, outs, out_grads) -> {slot: grads}
    grad_fn: Optional[Callable] = None
    # Input slots that may legally be absent or empty.
    optional_inputs: tuple = ()
    # The grad_fn only computes faster what the vjp of ``fn`` computes,
    # so a recompute segment may differentiate ``fn`` itself.
    grad_fn_is_optimization: bool = False
    # Ops the executor runs itself, with the run's state (``seg_fwd``,
    # ``grad_seg``), rather than through ``fn`` alone.
    special: bool = False


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, fn: Callable = None, *, needs_rng=False,
                grad_fn: Callable = None, optional_inputs=(),
                grad_fn_is_optimization: bool = False,
                special: bool = False):
    """Register an op function. Usable as decorator or direct call."""

    def _do(f):
        if type in _REGISTRY:
            raise ValueError(f"op {type!r} already registered")
        _REGISTRY[type] = OpDef(type=type, fn=f, needs_rng=needs_rng,
                                grad_fn=grad_fn,
                                optional_inputs=tuple(optional_inputs),
                                grad_fn_is_optimization=(
                                    grad_fn_is_optimization),
                                special=special)
        return f

    if fn is None:
        return _do
    return _do(fn)


def get_op(type: str) -> OpDef:
    opdef = _REGISTRY.get(type)
    if opdef is None:
        import difflib

        known = sorted(_REGISTRY)
        close = difflib.get_close_matches(type, known, n=3, cutoff=0.6)
        hint = ("; did you mean " + " / ".join(repr(c) for c in close) + "?"
                if close else "")
        raise KeyError(f"op {type!r} is not registered in paddle_tpu_torch"
                       f"{hint} ({len(known)} ops ported so far: "
                       f"{', '.join(known)})")
    return opdef


def has_op(type: str) -> bool:
    return type in _REGISTRY


def op_uses_rng(opdef: OpDef, attrs) -> bool:
    """Does THIS op instance consume randomness?"""
    nr = opdef.needs_rng
    return bool(nr(attrs or {})) if callable(nr) else bool(nr)


# ---------------------------------------------------------------------------
# infer_outputs memoization, as in the reference: the same (op type, attrs,
# input signature) triples recur (every layer of a model stamps the same
# signatures), and evaluation on meta tensors is pure in them.
# ---------------------------------------------------------------------------
_INFER_CACHE: Dict[tuple, Tensors] = {}
_INFER_CACHE_MAX = 8192


class _Unfreezable(Exception):
    """Attr value with no stable hashable form; skip memoization."""


def _freeze(x):
    """Stable hashable digest of an attr value. Keys starting with '_'
    are metadata no kernel reads."""
    if isinstance(x, dict):
        return tuple(sorted(
            (k, _freeze(v)) for k, v in x.items()
            if not (isinstance(k, str) and k.startswith("_"))))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, (str, int, float, bool, bytes, type(None))):
        return x
    raise _Unfreezable(repr(type(x)))


def _signature_key(op_type: str, attrs, in_shapes) -> Optional[tuple]:
    try:
        frozen_attrs = _freeze(attrs or {})
    except _Unfreezable:
        return None
    sig = tuple(sorted(
        (slot, tuple((tuple(a.shape), str(a.dtype)) for a in arrs))
        for slot, arrs in in_shapes.items()))
    from ..ops import common as ops_common

    return (op_type, frozen_attrs, sig, ops_common.amp_enabled())


def infer_outputs(op_type: str, attrs, in_shapes) -> Tensors:
    """Evaluate an op on meta tensors to get its outputs' shapes and
    dtypes. ``in_shapes`` maps slot -> list of anything with ``shape`` and
    ``dtype`` (meta tensors, real tensors); the result maps slot -> list
    of meta tensors. Memoized on (op type, attrs, input signature, AMP
    policy): under AMP a product's outputs are bf16."""
    key = _signature_key(op_type, attrs, in_shapes)
    if key is not None and key in _INFER_CACHE:
        return {k: list(v) for k, v in _INFER_CACHE[key].items()}
    result = _infer_outputs_uncached(op_type, attrs, in_shapes)
    if key is not None:
        if len(_INFER_CACHE) >= _INFER_CACHE_MAX:
            _INFER_CACHE.clear()  # whole-table reset beats LRU bookkeeping
        _INFER_CACHE[key] = {k: list(v) for k, v in result.items()}
    return result


def _infer_outputs_uncached(op_type: str, attrs, in_shapes) -> Tensors:
    opdef = get_op(op_type)
    ins = {slot: [torch.empty(tuple(a.shape), dtype=a.dtype, device="meta")
                  for a in arrs]
           for slot, arrs in in_shapes.items()}
    # ops without inputs (fill_constant, uniform_random) create their
    # outputs on the default device: meta here
    with torch.no_grad(), torch.device("meta"):
        if op_uses_rng(opdef, attrs):
            # a meta key: drawing from it computes shapes only
            key = torch.zeros((), dtype=torch.int64)
            outs = opdef.fn(attrs, ins, rng=(key, key))
        elif callable(opdef.needs_rng):
            outs = opdef.fn(attrs, ins, rng=None)
        else:
            outs = opdef.fn(attrs, ins)
    return {slot: [t for t in vals if t is not None]
            for slot, vals in (outs or {}).items()}
