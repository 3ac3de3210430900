"""The routing service of the port (counterpart of ``repro.serving``):
the pending-duels ring and ``RouterService``'s tick-batch path."""
from .feedback_queue import (PendingDuels, ResolvedDuels, enqueue, expire,
                             init_pending, pending_count, resolve)
from .router_service import PoolEntry, RouterService, RouterServiceConfig

__all__ = ["PendingDuels", "ResolvedDuels", "enqueue", "expire",
           "init_pending", "pending_count", "resolve", "PoolEntry",
           "RouterService", "RouterServiceConfig"]
