"""Online serving of the port: bucket ladder, micro-batcher, engine, CLI."""

from .batching import (DrainingError, MicroBatcher, QueueFullError,
                       RequestExpired, ShutdownError)
from .bucketing import DEFAULT_BUCKETS, pad_rows_to_bucket, pick_bucket
from .engine import InferenceEngine, ServeResult
from .stats import ServeStats

__all__ = ["DEFAULT_BUCKETS", "DrainingError", "InferenceEngine",
           "MicroBatcher", "QueueFullError", "RequestExpired", "ServeResult",
           "ServeStats", "ShutdownError", "pad_rows_to_bucket",
           "pick_bucket"]
