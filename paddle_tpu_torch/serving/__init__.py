"""paddle_tpu_torch.serving: dynamic batching and continuous decode over
the paged KV cache (the default) or the dense slot cache, on PyTorch and
CUDA."""
from .batcher import DynamicBatcher, Future, Request
from .errors import (BadRequestError, CacheExhaustedError, EngineClosedError,
                     QueueFullError, RequestTimeoutError, ServingError)
from .generation import (GenerationEngine, LMSpec, PagedGenerationEngine,
                         RequestTimeline)
from .metrics import MetricsRegistry
from .paging import PagePool, PrefixIndex
from .server import Server

__all__ = [
    "BadRequestError", "CacheExhaustedError", "DynamicBatcher",
    "EngineClosedError", "Future", "GenerationEngine", "LMSpec",
    "MetricsRegistry", "PagePool", "PagedGenerationEngine", "PrefixIndex",
    "QueueFullError", "Request", "RequestTimeline", "RequestTimeoutError",
    "Server", "ServingError",
]
