"""paddle_tpu_torch.serving: dynamic batching and continuous decode over
the dense KV slot cache, on PyTorch and CUDA."""
from .batcher import DynamicBatcher, Future, Request
from .errors import (BadRequestError, EngineClosedError, QueueFullError,
                     RequestTimeoutError, ServingError)
from .generation import GenerationEngine, LMSpec, RequestTimeline
from .metrics import MetricsRegistry
from .server import Server

__all__ = [
    "BadRequestError", "DynamicBatcher", "EngineClosedError", "Future",
    "GenerationEngine", "LMSpec", "MetricsRegistry", "QueueFullError",
    "Request", "RequestTimeline", "RequestTimeoutError", "Server",
    "ServingError",
]
