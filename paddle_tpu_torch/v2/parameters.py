"""v2 Parameters facade. Counterpart of ``paddle_tpu/v2/parameters.py``
(reference python/paddle/v2/parameters.py:44 Parameters: numpy in/out
access to model weights by name, created from a topology). Here the
topology is the cost Variable's program; create() runs the startup
program into a private scope and hands back name-keyed access, plus the
program/scope/executor plumbing the v2 trainer and infer() use. The
executor runs on the card (``CUDAPlace``), or on the CPU after
``v2.init(use_gpu=False)``."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.executor import CPUPlace, CUDAPlace, Executor
from ..core.program import Program, default_startup_program
from ..core.scope import Scope

# the place v2.init chose: True (the card, the default) or False (CPU)
_USE_GPU = True


def _place():
    return CUDAPlace(0) if _USE_GPU else CPUPlace()


class Parameters:
    def __init__(self, main_program: Program, startup_program: Program):
        self.main_program = main_program
        self.startup_program = startup_program
        self.scope = Scope()
        self.executor = Executor(_place())
        self._init_done = False
        # inference clone BEFORE optimizer ops are appended; for_test
        # flips is_test so dropout/batch_norm run in inference mode
        self._test_program = main_program.clone(for_test=True)

    # -- lifecycle ----------------------------------------------------
    def init(self):
        if not self._init_done:
            self.executor.run(self.startup_program, scope=self.scope)
            self._init_done = True
        return self

    # -- v2 surface ---------------------------------------------------
    def names(self) -> List[str]:
        return [p.name for p in self.main_program.global_block
                .all_parameters()]

    def keys(self):
        return self.names()

    def __contains__(self, name: str) -> bool:
        return name in self.names()

    def get(self, name: str) -> np.ndarray:
        self.init()
        return np.asarray(self.scope.get_numpy(name))

    __getitem__ = get

    def set(self, name: str, value: np.ndarray) -> None:
        """Set a parameter from numpy, on the executor's device in the
        parameter's dtype."""
        self.init()
        old = self.scope.get(name)
        self.scope.set(name, torch.from_numpy(np.array(value)).to(
            device=self.executor.device, dtype=old.dtype))

    __setitem__ = set

    def to_tar(self, f) -> None:
        """Serialize all parameters (reference to_tar): an npz stream."""
        self.init()
        np.savez(f, **{n: self.get(n) for n in self.names()})

    @staticmethod
    def from_tar(f) -> Dict[str, np.ndarray]:
        data = np.load(f)
        return {k: data[k] for k in data.files}

    def load(self, mapping: Dict[str, np.ndarray]) -> None:
        for k, v in mapping.items():
            self.set(k, v)

    # -- plumbing for trainer/infer -----------------------------------
    def test_program_for(self, output_vars) -> Program:
        """Inference clone pruned to the output variable(s) (reference
        inference_optimize): drops the label branch so infer() only needs
        the actual input columns."""
        from ..io import prune_program

        if not isinstance(output_vars, (list, tuple)):
            output_vars = [output_vars]
        feeds = [v.name for v in self.data_vars()]
        return prune_program(self._test_program, feeds,
                             [v.name for v in output_vars])

    def data_vars(self, feeding: Optional[Dict[str, int]] = None,
                  program: Optional[Program] = None):
        block = (program or self.main_program).global_block
        data_vars = [v for v in block.vars.values()
                     if v.is_data and not getattr(v, "is_companion", False)]
        if feeding:
            order = sorted(feeding, key=feeding.get)
            by_name = {v.name: v for v in data_vars}
            return [by_name[n] for n in order if n in by_name]
        return data_vars


def create(cost) -> Parameters:
    """paddle.parameters.create(cost): capture the cost's program pair."""
    return Parameters(cost.block.program, default_startup_program())
