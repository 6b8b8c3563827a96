"""Observability for the training plane. Counterpart of
``paddle_tpu/trace``, cut to the goodput meter; spans, the flight
recorder, run logs and SLOs land with ROADMAP.md Queue 1 item 9."""
from .goodput import BUCKETS, GoodputMeter

__all__ = ["BUCKETS", "GoodputMeter"]
