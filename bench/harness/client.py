"""The benchmark's client of the program's `ReconstructionService`: the
scans of a run's pool, and the calls a traffic loop makes with them.

A traffic loop (bench/traffic/loops/<loop>.py) drives a run's window
through a `Client`:

  drive(client, mix, t_start, seconds, seed) -> list of Scan
      required: every scan due in the window, in the order they were due,
      each submitted (`client.submit`) and received (`client.receive`)
  make_pool(config, seed, mix, device) -> list of PoolScan
      optional: the scans the loop sends (default: `default_pool`)
  warm(client, mix, stamp)
      optional: serve once every shape the window will use, before it,
      and start the service's background loop if the window uses it
      (default: `warm_buckets`)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from bench.harness import check
from bench.reference import phantom
from bench.reference.geometry import Geometry


@dataclasses.dataclass
class PoolScan:
    """One scan of the pool: its geometry and projections (on the card, or
    in pageable host memory, as the mix places them)."""

    geometry: Geometry
    projections: torch.Tensor


@dataclasses.dataclass
class Scan:
    """One scan due in the window, as the client saw it."""

    due: float
    pool: int
    late: float = 0.0
    seen: Optional[float] = None
    error: Optional[str] = None
    kept: Optional[torch.Tensor] = None
    ticket: object = None


def default_pool(config: dict, seed: int, mix: dict, device) -> List[PoolScan]:
    """`mix["pool"]` seeded phantoms in the configuration's geometry, each
    projected on `device` and copied down to host memory where the mix
    places scans on the host."""
    g = Geometry.from_dict(config["geometry"])
    pool = []
    for p in range(int(mix["pool"])):
        proj = phantom.project(g, phantom.ellipsoids(seed, p), device)
        pool.append(PoolScan(g, proj.cpu() if mix["placement"] == "host"
                             else proj))
        del proj
    return pool


class Client:
    """Submits the pool's scans and keeps, of each volume received, its
    values at the run's sampled voxels (the same voxels for every scan of
    one geometry, drawn from the seed)."""

    def __init__(self, svc, pool: List[PoolScan], seed: int, device,
                 admission_error):
        from repro_torch.core.geometry import CBCTGeometry
        self.svc, self.pool, self.seed = svc, pool, seed
        self.admission_error = admission_error
        self.give_up = float("inf")       # when receive() stops waiting
        self.spans: List[tuple] = []      # (name, t0_ns, t1_ns)
        self._program_geometry = {}
        self._idx: Dict[Geometry, torch.Tensor] = {}
        for s in pool:
            if s.geometry not in self._idx:
                self._program_geometry[s.geometry] = CBCTGeometry(
                    **s.geometry.as_dict())
                self._idx[s.geometry] = check.sample_indices(
                    s.geometry.n_voxels, seed, device)

    def sample(self, geometry: Geometry) -> torch.Tensor:
        """The flat voxel indices kept of a volume of `geometry`."""
        return self._idx[geometry]

    def program_geometry(self, pool: int):
        return self._program_geometry[self.pool[pool].geometry]

    def submit(self, scan: Scan) -> None:
        t0 = time.perf_counter_ns()
        try:
            scan.ticket = self.svc.submit(
                projections=self.pool[scan.pool].projections,
                geometry=self.program_geometry(scan.pool))
        except self.admission_error as e:
            scan.error = f"rejected: {e}"
        self.spans.append(("bench.submit", t0, time.perf_counter_ns()))

    def receive(self, scan: Scan) -> None:
        t0 = time.perf_counter_ns()
        ticket, scan.ticket = scan.ticket, None
        if ticket is not None:
            landed = ticket.wait(
                timeout=max(0.0, self.give_up - time.perf_counter()))
            if landed and ticket.done:
                scan.seen = time.perf_counter()
                scan.kept = ticket.volume.reshape(-1).index_select(
                    0, self.sample(self.pool[scan.pool].geometry))
            else:
                scan.error = (repr(ticket.error) if landed
                              else "never landed")
        self.spans.append(("bench.wait", t0, time.perf_counter_ns()))


def warm_buckets(client: Client, mix: dict, stamp) -> None:
    """Serve each of the mix's `warm_buckets` sizes once (synchronously),
    then one scan through the background loop the window uses. The buckets
    take a copy of pool scan 0 on the service's device (what differs
    between bucket sizes is on the card: the stack, the pad lanes, the
    batched engine); the looped scan comes as the mix places it, so a
    host-placed mix also warms the host to card copy."""
    svc, buckets = client.svc, mix["warm_buckets"]
    pg = client.program_geometry(0)
    on_card = torch.as_tensor(client.pool[0].projections, device=svc.device)
    for b in buckets:
        tickets = [svc.submit(projections=on_card, geometry=pg)
                   for _ in range(b)]
        if b == buckets[0]:
            stamp("first scan admitted (its plan resolved)")
        svc.drain()
        for t in tickets:
            t.result()
        stamp(f"warm-up bucket of {b} served")
    del on_card, tickets
    svc.serve()
    t = svc.submit(projections=client.pool[0].projections, geometry=pg)
    if not t.wait(timeout=600) or not t.done:
        raise RuntimeError(f"warm-up scan did not land: {t.error!r}")
    stamp("warm-up scan served through the background loop")
