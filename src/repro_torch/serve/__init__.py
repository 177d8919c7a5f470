"""Serving: the LM decode engine (continuous batching over the model
bundles of :mod:`repro_torch.models`) and the multi-tenant transform
service."""

from .engine import Request, ServeEngine
from .metrics import ServiceMetrics
from .scheduler import (CoalescingScheduler, DeadlineExceeded, QueueFull,
                        ServeError, ServiceStopped, TransformHandle,
                        TransformRequest, compat_key)
from .transform_service import TransformService

__all__ = [
    "Request", "ServeEngine",
    "TransformService", "TransformRequest", "TransformHandle",
    "CoalescingScheduler", "ServiceMetrics", "compat_key",
    "ServeError", "DeadlineExceeded", "QueueFull", "ServiceStopped",
]
