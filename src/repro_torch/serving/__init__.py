"""Serving stack of the port: scheduler, block allocator, paged engine."""

from .engine import ServeConfig, ServingEngine, ServingMetrics
from .scheduler import BlockAllocator, Request, RequestState, Scheduler

__all__ = [
    "BlockAllocator",
    "Request",
    "RequestState",
    "Scheduler",
    "ServeConfig",
    "ServingEngine",
    "ServingMetrics",
]
