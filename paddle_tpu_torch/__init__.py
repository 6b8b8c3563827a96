"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for NVIDIA Hopper.

Module paths and public names mirror ``paddle_tpu``; the kernels the JAX
package wrote in Pallas are hand-written sm_90a CUDA here, built with
nvcc on first use (``kernels/build.py``). This slice serves the stacked
transformer LM through the dense-KV continuous-batching engine.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(where every kernel runs its plain PyTorch version); without CUDA and
without ``device="cpu"`` they raise rather than fall back.
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


from .serving import (BadRequestError, DynamicBatcher,  # noqa: E402
                      EngineClosedError, Future, GenerationEngine, LMSpec,
                      MetricsRegistry, QueueFullError, Request,
                      RequestTimeoutError, Server, ServingError)
from .models.transformer import TransformerLM, init_params  # noqa: E402

__all__ = [
    "BadRequestError", "DynamicBatcher", "EngineClosedError", "Future",
    "GenerationEngine", "LMSpec", "MetricsRegistry", "QueueFullError",
    "Request", "RequestTimeoutError", "Server", "ServingError",
    "TransformerLM", "init_params", "resolve_device",
]
