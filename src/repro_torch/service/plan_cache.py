"""Plan cache: planner search once per scan family, not per request.

Port of `repro/service/plan_cache.py`. `plan_from_spec(g, "auto")` is the
expensive admission step — a full enumerate/prune/rank sweep of the plan
space (planner/). A serving loop seeing thousands of same-geometry scans
must pay it once per FAMILY (geometry, mesh, pins — see
requests.ScanFamily), which is exactly what a counted LRU keyed by the
family gives us. The `searches` counter is the acceptance proof: after two
same-family submits it reads 1 (second request did zero planner-search
work), and the service surfaces it in stats().
"""
from __future__ import annotations

from typing import Optional

from ..core.cache import CountingLRU
from ..obs import metrics as _metrics

from .requests import ScanFamily


class PlanCache:
    """(geometry, mesh, pins) -> validated ReconstructionPlan, bounded LRU.

    spec   : the plan spec every family resolves through — "auto" (default)
             runs planner search with the family's pins; a concrete spec
             string (e.g. "schedule=pipelined,n_steps=4") skips search and
             just builds + validates the plan (still cached: validate and
             the kernel's launch-shape resolution are not free either).
    device : where the resolved plans run (the service's device).
    """

    def __init__(self, capacity: int = 32, spec: str = "auto",
                 device="cuda"):
        self._lru = CountingLRU(capacity, name="service.plan_cache")
        self.spec = spec
        self.device = device
        self.searches = 0    # planner-search (cold resolve) count
        self._searches_total = _metrics.counter("service.plan_cache.searches")

    def resolve(self, family: ScanFamily):
        def build():
            from ..core.plan import plan_from_spec
            self.searches += 1
            self._searches_total.inc()
            plan = plan_from_spec(family.geometry, self.spec,
                                  mesh=family.mesh, device=self.device,
                                  **family.pins_dict())
            plan.validate()
            return plan
        return self._lru.get_or_build(family, build)

    def peek(self, family: ScanFamily) -> Optional[object]:
        """Cached plan without resolving (does count as hit/miss)."""
        return self._lru.get(family)

    def stats(self) -> dict:
        s = self._lru.stats()
        s["searches"] = self.searches
        return s

    def clear(self) -> None:
        self._lru.clear()
        self.searches = 0
