"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for NVIDIA Hopper.

Module paths and public names mirror ``paddle_tpu``; the kernels the JAX
package wrote in Pallas are hand-written sm_90a CUDA here, built with
nvcc on first use (``kernels/build.py``). The port serves the stacked
transformer LM through the dense-KV continuous-batching engine, and
trains it and ResNet through the Program IR: ``layers`` and ``models``
build a program, ``optimizer.*Optimizer(...).minimize`` appends the
backward pass and the updates, and ``Executor`` runs it (ResNet's fused
conv epilogue under ``flags.FLAGS.fused_conv_epilogue``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
or ``CPUPlace()`` (where every kernel runs its plain PyTorch version);
without CUDA they raise rather than fall back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, raising
    when CUDA is absent; any explicit device as given. A CUDA device
    comes back with its index (``cuda:0``), as tensors report it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "versions of the kernels")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


from . import core, ops  # noqa: E402,F401  (ops register on import)
from .core import backward  # noqa: E402,F401  (registers grad ops)
from .core.executor import CPUPlace, CUDAPlace, Executor  # noqa: E402
from .core.program import (Program, default_main_program,  # noqa: E402
                           default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_from_numpy  # noqa: E402
from . import flags, layers, models, optimizer  # noqa: E402
from .serving import (BadRequestError, DynamicBatcher,  # noqa: E402
                      EngineClosedError, Future, GenerationEngine, LMSpec,
                      MetricsRegistry, QueueFullError, Request,
                      RequestTimeoutError, Server, ServingError)
from .models.transformer import TransformerLM, init_params  # noqa: E402

__all__ = [
    "CPUPlace", "CUDAPlace", "Executor", "Program", "Scope",
    "default_main_program", "default_startup_program", "flags",
    "global_scope",
    "layers", "models", "optimizer", "program_guard", "scope_from_numpy",
    "BadRequestError", "DynamicBatcher", "EngineClosedError", "Future",
    "GenerationEngine", "LMSpec", "MetricsRegistry", "QueueFullError",
    "Request", "RequestTimeoutError", "Server", "ServingError",
    "TransformerLM", "init_params", "resolve_device",
]
