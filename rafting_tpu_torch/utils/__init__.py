"""Utilities: metrics/observability for the node runtime."""

from .metrics import (
    Histogram, Metrics, escape_label_value, validate_exposition,
)
from .tracelog import TraceLog

__all__ = ["Metrics", "Histogram", "TraceLog", "escape_label_value",
           "validate_exposition"]
