"""Reader creators and decorators. Counterpart of ``paddle_tpu/reader``."""
from .decorator import (PipeReader, background_stage, bucket_by_length,
                        buffered, cache, chain, compose, device_prefetch,
                        firstn, map_readers, shuffle, xmap_readers)
from .minibatch import batch
