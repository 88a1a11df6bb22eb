"""Overload-robust serving plane (port of ``repro.serve``, DESIGN.md
§12): bounded admission, deadline-aware micro-batching, graceful
degradation."""
from .buckets import BucketLadder
from .degrade import (FULL, INT8_SCAN, PROBE_SHRINK, ROUTE_ONLY, SHED,
                      DegradeConfig, DegradeLadder, RUNG_NAMES)
from .executor import ServeConfig, ServeExecutor, requests_from_trace
from .queue import (AdmissionQueue, Overloaded, Request, Response,
                    REJECT_QUEUE_FULL)

__all__ = ["BucketLadder", "DegradeConfig", "DegradeLadder", "RUNG_NAMES",
           "FULL", "INT8_SCAN", "PROBE_SHRINK", "ROUTE_ONLY", "SHED",
           "ServeConfig", "ServeExecutor", "requests_from_trace",
           "AdmissionQueue", "Overloaded", "Request", "Response",
           "REJECT_QUEUE_FULL"]
