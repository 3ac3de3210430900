"""Seeded serving-host-sync and live-view violations + clean twins.

Lives under a ``serving/`` path on purpose: every function in a serving
module is held to the dispatch-async rule, captured or not. Parsed by
tests/test_torch_analysis.py, never executed.
"""
import numpy as np
import torch


class FakeService:
    def route(self, x):
        stats = self.counts.sum()
        return int(stats.item())  # PLANT: trace-hazard/serving-host-sync

    def fold(self, res):
        keep = torch.nonzero(res.ok)[:, 0]  # PLANT: trace-hazard/serving-host-sync
        hist = torch.bincount(res.a1)  # PLANT: trace-hazard/serving-host-sync
        return self.update(res.x[keep], hist)

    def drain(self, res):
        ok = np.asarray(res.ok)  # PLANT: trace-hazard/serving-host-sync
        return ok

    def spend_total(self, arms):
        return float(self.costs[arms].sum())  # PLANT: trace-hazard/serving-host-sync

    def pending_view(self):
        return self.pending.valid.cpu()  # PLANT: trace-hazard/serving-host-sync trace-hazard/live-view

    def stats(self):
        counts = self.counts.to("cpu")  # PLANT: trace-hazard/serving-host-sync
        return {"counts": counts.numpy(), "tick": self.tick}  # PLANT: trace-hazard/serving-host-sync trace-hazard/live-view

    def mask(self):
        return self.active.to(device="cpu"), self.tick  # PLANT: trace-hazard/serving-host-sync trace-hazard/live-view

    # ------------------------- clean twins ---------------------------------

    def stats_copy(self):
        # a copy, not the live tensor: the sync is flagged, the view is not
        counts = self.counts.to("cpu", copy=True)  # PLANT: trace-hazard/serving-host-sync
        return {"counts": counts.numpy(), "tick": self.tick}  # PLANT: trace-hazard/serving-host-sync

    def fold_ok(self, res):
        # the folded count stays a 0-d device tensor: no sync
        n_ok = torch.sum(res.ok, dtype=torch.int32)
        return self.update(res.x, n_ok)

    def batch_size(self, x):
        return int(x.shape[0])    # shape read: no device sync

    def tick_label(self, n):
        return int(n)             # plain name, nothing computed per call
