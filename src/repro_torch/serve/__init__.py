"""Serving: the multi-tenant transform service.

(The reference package's LM decode engine, ``serve/engine.py``, belongs
to the LM stack and is not ported yet.)
"""

from .metrics import ServiceMetrics
from .scheduler import (CoalescingScheduler, DeadlineExceeded, QueueFull,
                        ServeError, ServiceStopped, TransformHandle,
                        TransformRequest, compat_key)
from .transform_service import TransformService

__all__ = [
    "TransformService", "TransformRequest", "TransformHandle",
    "CoalescingScheduler", "ServiceMetrics", "compat_key",
    "ServeError", "DeadlineExceeded", "QueueFull", "ServiceStopped",
]
