"""Scope: run-time name -> tensor store.

Counterpart of ``paddle_tpu/core/scope.py``, holding torch tensors. The
executor reads persistable state (parameters, optimizer accumulators)
from the scope before a run and writes the updated state back after it.
``scope_from_numpy`` carries state across from numpy arrays, for example
a JAX ``Scope``'s values after its startup run.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .types import to_numpy


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, object] = {}
        self.parent = parent

    def set(self, name: str, value) -> None:
        self._vars[name] = value

    def get(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        raise KeyError(f"variable {name!r} not found in scope")

    def has(self, name: str) -> bool:
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def keys(self) -> Iterator[str]:
        return iter(self._vars.keys())

    def get_numpy(self, name: str) -> np.ndarray:
        return to_numpy(self.get(name))

    def __contains__(self, name: str) -> bool:
        return self.has(name)

    def __repr__(self):
        return f"Scope({sorted(self._vars)})"


def scope_from_numpy(values: Dict[str, np.ndarray], device) -> Scope:
    """A Scope holding ``values`` as tensors on ``device``, each with the
    dtype its array has (copies: later writes to the arrays do not reach
    the scope)."""
    scope = Scope()
    dev = torch.device(device)
    for name, arr in values.items():
        scope.set(name, torch.tensor(np.asarray(arr), device=dev))
    return scope


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope
