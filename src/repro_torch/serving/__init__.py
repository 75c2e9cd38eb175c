"""Serving stack of the port: scheduler, block allocator, paged engine,
degradation policy and fault injection."""

from .engine import DegradationPolicy, ServeConfig, ServingEngine, ServingMetrics
from .faults import POOL_HOG_OWNER, FaultInjector
from .scheduler import (
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
    BlockAllocator,
    Request,
    RequestState,
    Scheduler,
)

__all__ = [
    "BlockAllocator",
    "DegradationPolicy",
    "FaultInjector",
    "POOL_HOG_OWNER",
    "PRIORITY_BATCH",
    "PRIORITY_INTERACTIVE",
    "Request",
    "RequestState",
    "Scheduler",
    "ServeConfig",
    "ServingEngine",
    "ServingMetrics",
]
