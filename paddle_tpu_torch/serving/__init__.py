"""paddle_tpu_torch.serving: dynamic batching and continuous decode over
the paged KV cache (the default) or the dense slot cache, and bucketed
one-shot inference over saved models (one CUDA graph per bucket), on
PyTorch and CUDA."""
from .batcher import DynamicBatcher, Future, Request
from .engine import DEFAULT_BATCH_BUCKETS, InferenceEngine, PendingInference
from .errors import (BadRequestError, CacheExhaustedError, EngineClosedError,
                     QueueFullError, RequestTimeoutError, ServingError)
from .generation import (GenerationEngine, LMSpec, PagedGenerationEngine,
                         RequestTimeline)
from .metrics import MetricsRegistry
from .paging import PagePool, PrefixIndex
from .server import Server

__all__ = [
    "BadRequestError", "CacheExhaustedError", "DEFAULT_BATCH_BUCKETS",
    "DynamicBatcher", "EngineClosedError", "Future", "GenerationEngine",
    "InferenceEngine", "LMSpec",
    "MetricsRegistry", "PagePool", "PagedGenerationEngine",
    "PendingInference", "PrefixIndex",
    "QueueFullError", "Request", "RequestTimeline", "RequestTimeoutError",
    "Server", "ServingError",
]
