"""The stream loop: C-arm rooms streaming each spin's frames to the
service, which folds every delta as it lands (`ReconstructionService`'s
`open_stream` and `push`).

Each of the mix's `rooms` runs spins back to back. A spin of N_p frames
at `frames_per_s` arrives as `deltas` deltas of N_p / deltas projections
each; a delta lands with its last frame, one every period
T = (N_p / deltas) / frames_per_s, and `gap_deltas` periods of
repositioning separate a room's spins, so a room's cycle is
C = (deltas + gap_deltas) T. The room in phase slot s starts its first
spin at s C / rooms. Since gcd(deltas + gap_deltas, rooms) = 1, each
room's deltas land at a phase of T of their own, T / rooms from any other
room's. The seed draws the phantoms and which room takes which slot; the
schedule's times are the same for every seed.

A generator thread opens a spin's stream as the spin starts and pushes
each delta (a slice of the room's pool scan, already on the card) at its
landing, with that landing as its `arrived_at`; a receiver thread waits
for the volumes in the order they are due, on each ticket from its open.
A scan is due at its last delta's scheduled landing, so a late pusher
counts against the service. The window holds the spins whose last delta
is due inside it; the rooms do not stop for its end, so the deltas of
spins that end after it are pushed too, and those streams fail when the
service closes.
"""
import dataclasses
import math
import queue
import threading
import time
from typing import List, Tuple

import numpy as np

from bench.harness.client import Scan, default_pool


@dataclasses.dataclass(frozen=True)
class Spin:
    """One spin of one room: when its stream opens and when each of its
    deltas lands (seconds from the window's start), the angles of each,
    and the pool scan it streams."""

    room: int
    index: int
    pool: int
    opens: float
    lands: Tuple[float, ...]
    slices: Tuple[Tuple[int, int], ...]

    @property
    def due(self) -> float:
        return self.lands[-1]


def delta_slices(mix: dict, n_proj: int) -> List[Tuple[int, int]]:
    """The [lo, hi) angles of each of a spin's deltas."""
    d = int(mix["deltas"])
    if n_proj % d:
        raise ValueError(f"{n_proj} projections do not split into {d} "
                         "equal deltas")
    step = n_proj // d
    return [(lo, lo + step) for lo in range(0, n_proj, step)]


def period(mix: dict, n_proj: int) -> float:
    """T: the seconds between two deltas of one spin."""
    return n_proj / int(mix["deltas"]) / float(mix["frames_per_s"])


def schedule(mix: dict, n_proj: int, seconds: float, seed: int
             ) -> List[Spin]:
    """Every spin whose stream opens inside a window of `seconds`, by
    opening time."""
    rooms, d = int(mix["rooms"]), int(mix["deltas"])
    cycle = d + int(mix["gap_deltas"])
    if math.gcd(cycle, rooms) != 1:
        raise ValueError(f"a cycle of {cycle} periods shares a factor with "
                         f"{rooms} rooms: their deltas would land together")
    t = period(mix, n_proj)
    slices = tuple(delta_slices(mix, n_proj))
    slot = np.random.default_rng([seed % 2**64, 4]).permutation(rooms)
    spins = []
    for room in range(rooms):
        k = 0
        while (opens := (int(slot[room]) / rooms + k) * cycle * t) < seconds:
            spins.append(Spin(room=room, index=k,
                              pool=(room + k) % int(mix["pool"]),
                              opens=opens,
                              lands=tuple(opens + (j + 1) * t
                                          for j in range(d)),
                              slices=slices))
            k += 1
    return sorted(spins, key=lambda s: s.opens)


def _check_program(svc_class) -> None:
    if not hasattr(svc_class, "open_stream"):
        raise RuntimeError(
            "this program's ReconstructionService has no open_stream(): it "
            "cannot serve a streamed scan")


def make_pool(config, seed, mix, device):
    from repro_torch.service import ReconstructionService
    _check_program(ReconstructionService)
    return default_pool(config, seed, mix, device)


def warm(client, mix, stamp):
    """One stream folded on this thread (the plan resolved, the delta's
    shapes built), then every room's stream open at once and served
    through the background loop the window uses, one after another."""
    svc = client.svc
    _check_program(type(svc))
    pg = client.program_geometry(0)
    proj = client.pool[0].projections
    slices = delta_slices(mix, pg.n_proj)

    def stream(ticket):
        for lo, hi in slices:
            svc.push(ticket, proj[lo:hi], (lo, hi))

    ticket = svc.open_stream(geometry=pg)
    stamp("first stream admitted (its plan resolved)")
    stream(ticket)
    svc.drain()
    ticket.result()
    stamp("first stream folded")
    svc.serve()
    tickets = [svc.open_stream(geometry=pg) for _ in range(int(mix["rooms"]))]
    while tickets:
        ticket = tickets.pop(0)
        stream(ticket)
        if not ticket.wait(timeout=600) or not ticket.done:
            raise RuntimeError(f"warm-up stream did not land: "
                               f"{ticket.error!r}")
    stamp(f"{mix['rooms']} streams open at once, served through the "
          "background loop")


# The generator sleeps until this close to an event (at most a tenth of
# the spacing of two rooms' deltas) and spins for the rest, so that its own
# wake-up from a sleep does not count against the service: at RabbitCT's
# 129 ms spacing the spin keeps neither the serving nor the receiving
# thread from the interpreter, whose work for the previous event has ended.
SPIN_S = 0.002


def _wait_until(at: float, spin: float) -> None:
    delay = at - spin - time.perf_counter()
    if delay > 0:
        time.sleep(delay)
    while time.perf_counter() < at:
        pass


def drive(client, mix, t_start, seconds, seed):
    from repro_torch.service.requests import AdmissionError
    svc = client.svc
    pg = client.program_geometry(0)
    spins = schedule(mix, pg.n_proj, seconds, seed)
    events = sorted([(sp.opens, 0, i, -1) for i, sp in enumerate(spins)]
                    + [(t, 1, i, j) for i, sp in enumerate(spins)
                       for j, t in enumerate(sp.lands) if t < seconds])
    scans = {i: Scan(due=t_start + sp.due, pool=sp.pool)
             for i, sp in enumerate(spins) if sp.due < seconds}
    tickets = {}
    sent = queue.Queue()
    out = []
    spin = min(SPIN_S, period(mix, pg.n_proj) / int(mix["rooms"]) / 10)

    def generate():
        for t, kind, i, j in events:
            at = t_start + t
            _wait_until(at, spin)
            sp, scan = spins[i], scans.get(i)
            t0 = time.perf_counter_ns()
            try:
                if kind == 0:
                    tickets[i] = svc.open_stream(
                        geometry=pg, scan_id=f"room{sp.room}-spin{sp.index}")
                    if scan is not None:
                        scan.ticket = tickets[i]
                elif i in tickets:
                    lo, hi = sp.slices[j]
                    if scan is not None and j == len(sp.lands) - 1:
                        scan.late = time.perf_counter() - at
                    svc.push(tickets[i],
                             client.pool[sp.pool].projections[lo:hi],
                             (lo, hi), arrived_at=at)
            except AdmissionError as e:
                tickets.pop(i, None)
                if scan is not None:
                    scan.error = f"rejected: {e}"
            client.spans.append(("bench.open" if kind == 0 else "bench.push",
                                 t0, time.perf_counter_ns()))
            if scan is not None and kind == 0:
                # to the receiver as its spin starts, so that it waits on
                # the ticket before the spin ends: its own wake-up then
                # comes at the volume, not beside the last delta's fold
                sent.put(scan)
            elif kind == 1 and j == len(sp.lands) - 1:
                tickets.pop(i, None)
        sent.put(None)

    def receive():
        while (scan := sent.get()) is not None:
            client.receive(scan)
            out.append(scan)

    threads = [threading.Thread(target=generate, name="bench-generate"),
               threading.Thread(target=receive, name="bench-receive")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out
