"""The routing service of the port (counterpart of ``repro.serving``):
the pending-duels ring, event-time batch forming and ``RouterService``
(tick-batch and streaming surfaces)."""
from .feedback_queue import (PendingDuels, ResolvedDuels, enqueue,
                             enqueue_stream, expire, init_pending,
                             pending_count, resolve, resolve_stream)
from .router_service import PoolEntry, RouterService, RouterServiceConfig

__all__ = ["PendingDuels", "ResolvedDuels", "enqueue", "enqueue_stream",
           "expire", "init_pending", "pending_count", "resolve",
           "resolve_stream", "PoolEntry", "RouterService",
           "RouterServiceConfig"]
