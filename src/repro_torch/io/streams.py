"""Projection/volume endpoints of the reconstruction pipeline (paper Fig. 3).

Port of `repro/io/streams.py`. The paper's rank does not receive
projections from the caller — it *loads* its N_p/(R*C) slice from the
parallel filesystem — and it does not return its slab — it *stores* it.
These endpoints wrap the shard store (shard_store.py) in pipeline terms:

  ProjectionSource  a projection shard store feeding the plan engine:
                    `load(mesh, device)` reads exactly the rows that
                    `local_projections(proj, mesh)` gives this rank (the
                    whole array without a mesh) and places them on
                    `device`. With `codec=` at write time the store holds
                    the stream codec's WIRE format — quantized shards plus,
                    for scaled codecs, a per-projection f32 scale sidecar
                    store at `<path>/scales` — and `load` decodes to f32
                    after the read; `load_encoded` returns the wire pair
                    verbatim.
  VolumeSink        the volume store: `write(volume)` streams the volume,
                    or on a mesh each rank's own part, shard per file.

Both are wired as optional `source=` / `sink=` stages on
`ReconstructionPlan.build()` (core/plan.py):

    src = ProjectionSource.write(dir_in, projections, chunks=(n_ranks, 1, 1))
    fdk = plan.build(source=src, sink=VolumeSink(dir_out))
    volume = fdk()          # load -> filter -> gather -> BP -> reduce -> store

The streaming half — `StreamingProjectionWriter` appends deltas to a
growing store, `ProjectionSource.poll`/`iter_deltas` discover them — feeds
`IncrementalSession.poll`. `SourcePrefetcher` and `AsyncWriteback` move a
serving loop's reads and writes off the compute thread.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from ..core.distributed import mesh_index
from ..core.precision import Precision, resolve_precision
from ..device import resolve_device
from ..obs import metrics as _metrics
from ..obs.trace import get_tracer
from . import shard_store

# Sub-store holding the per-projection f32 scale sidecar of an encoded
# projection store (sibling of the data store's `shards/` directory).
SCALES_DIR = "scales"


def rank_rows(lo: int, hi: int, mesh) -> Tuple[int, int]:
    """The rows of [lo, hi) that `local_projections` of that range gives
    this rank: [lo, hi) cut into as many equal parts as the mesh has ranks,
    part `mesh_index(mesh)`; all of it without a mesh."""
    if mesh is None:
        return lo, hi
    n = mesh.size()
    if (hi - lo) % n:
        raise ValueError(
            f"angle range [{lo}, {hi}) of {hi - lo} projections must divide "
            f"over the {n} ranks of the mesh")
    nl = (hi - lo) // n
    i = mesh_index(mesh)
    return lo + i * nl, lo + (i + 1) * nl


class ProjectionSource:
    """Projections stored shard-per-file (raw f32, or a stream codec's wire
    format + scale sidecar)."""

    def __init__(self, path: str):
        self.path = path
        self._consumed: set = set()   # shard files already folded (poll API)

    @classmethod
    def write(cls, path: str, projections,
              chunks: Optional[Sequence[int]] = None,
              codec: "Precision | str | None" = None) -> "ProjectionSource":
        """Lay projections (a tensor or an array) down as a shard store;
        pass e.g. ``chunks=(n_ranks, 1, 1)`` for the paper's slice-per-rank
        layout.

        `codec` (a storage-precision name, e.g. "fp8_e4m3") stores the
        stream codec's wire format instead of the input dtype: the data
        store holds the quantized shards (its manifest records the codec),
        and scaled codecs add a `<path>/scales` sidecar store with one f32
        scale per projection. Encoding runs on the projections' device.
        """
        if codec is None:
            shard_store.save_array(path, projections, chunks=chunks)
            return cls(path)
        prec = resolve_precision(codec)
        data, scales = prec.codec.encode(torch.as_tensor(projections))
        shard_store.save_array(path, data, chunks=chunks,
                               extra_manifest={"codec": prec.storage})
        if scales is not None:
            shard_store.save_array(os.path.join(path, SCALES_DIR), scales,
                                   chunks=None if chunks is None
                                   else chunks[:1])
        return cls(path)

    @property
    def shape(self) -> tuple:
        return tuple(shard_store.read_manifest(self.path)["shape"])

    @property
    def dtype(self) -> torch.dtype:
        return shard_store.dtype_from_name(
            shard_store.read_manifest(self.path)["dtype"])

    @property
    def codec_name(self) -> Optional[str]:
        """Storage codec the store was encoded with (None = raw store)."""
        return shard_store.read_manifest(self.path).get("codec")

    def _has_scales(self) -> bool:
        return os.path.exists(os.path.join(self.path, SCALES_DIR,
                                           shard_store.MANIFEST))

    def load_encoded(self):
        """The stored wire-format pair (data, scales) as CPU tensors —
        verbatim bytes, no decode. scales is None for raw/scale-free
        stores."""
        data = shard_store.load_array(self.path)
        scales = (shard_store.load_array(os.path.join(self.path, SCALES_DIR))
                  if self._has_scales() else None)
        return data, scales

    def _read_rows(self, lo: int, hi: int, device) -> torch.Tensor:
        """Rows [lo, hi) on `device`, decoded to f32 for an encoded store
        (the wire bytes cross to the device, the decode runs there)."""
        dev = resolve_device(device)
        shape = self.shape
        region = ((lo, hi),) + tuple((0, d) for d in shape[1:])
        data = shard_store.read_region(self.path, region).to(dev)
        codec_name = self.codec_name
        if codec_name is None:
            return data
        scales = None
        if self._has_scales():
            scales = shard_store.read_region(
                os.path.join(self.path, SCALES_DIR), ((lo, hi),)).to(dev)
        return Precision(codec_name).codec.decode(data, scales)

    def load(self, mesh=None, device="cuda") -> torch.Tensor:
        """This rank's projections on `device`: the rows
        `local_projections(projections, mesh)` would give it (the whole
        array without a mesh). Only the shard files (and sidecar shards)
        that hold those rows are opened; an encoded store is decoded to
        f32 after the read."""
        return self._read_rows(*rank_rows(0, self.shape[0], mesh), device)

    # -- streaming discovery (the instant-CT source side) -------------------

    def _committed(self) -> list:
        """(lo, hi, shard file) of every committed, not yet consumed range,
        sorted by lo, from ONE read of the manifest: a range the scanner
        commits meanwhile waits for the next call."""
        try:
            m = shard_store.read_manifest(self.path)
        except shard_store.StoreError:
            return []
        dtype = shard_store.dtype_from_name(m["dtype"])
        ready = []
        for entry in m["shards"]:
            if entry["file"] in self._consumed:
                continue
            fpath = os.path.join(self.path, shard_store.SHARD_DIR,
                                 entry["file"])
            # The manifest entry is the writer's commit point
            # (shard_store.append_region); the size check just refuses to
            # hand out a range whose bytes a non-protocol writer truncated.
            if (not os.path.exists(fpath) or os.path.getsize(fpath)
                    != shard_store.entry_nbytes(entry, dtype)):
                continue
            lo, hi = entry["index"][0]
            ready.append((lo, hi, entry["file"]))
        return sorted(ready)

    def poll(self) -> list:
        """Diff the store's (growing) manifest against what this source has
        already handed out: the contiguous [lo, hi) angle ranges of newly
        COMMITTED shards, sorted by lo. Read-only — ranges are marked
        consumed by `iter_deltas`, so repeated polls keep reporting a range
        until it is actually loaded. A store whose manifest does not exist
        yet (scanner not started) reports no deltas."""
        return [(lo, hi) for lo, hi, _ in self._committed()]

    def load_slice(self, lo: int, hi: int, mesh=None,
                   device="cuda") -> torch.Tensor:
        """Load + decode this rank's share of the angle range [lo, hi):
        the rows `local_projections` of that range gives it (all of them
        without a mesh) — ready for `IncrementalSession.update(delta,
        (lo, hi))`. Only the shard files intersecting them are opened."""
        return self._read_rows(*rank_rows(lo, hi, mesh), device)

    def iter_deltas(self, mesh=None, device="cuda"
                    ) -> Iterator[Tuple[int, int, torch.Tensor]]:
        """Consume newly committed deltas: yields (lo, hi, projections) for
        each range `poll()` discovers — this rank's share, decoded, on
        `device` — and marks it consumed. Yields nothing when the scanner
        has not committed anything new."""
        for lo, hi, fname in self._committed():
            delta = self.load_slice(lo, hi, mesh, device)
            # Mark consumed BEFORE yielding: the delta is fully loaded by
            # now, and a consumer that breaks (or errors) after receiving
            # it closes this generator — marking after the yield would
            # never run, so the already-folded range would be re-reported
            # by the next poll() and trip the session's overlap rejection.
            # A load_slice failure still leaves the range unconsumed
            # (retryable).
            self._consumed.add(fname)
            yield lo, hi, delta


class StreamingProjectionWriter:
    """The scanner side of the streaming protocol: append projection deltas
    to a growing store that `ProjectionSource.poll()` discovers.

    Commit ordering (see shard_store.append_region): for scaled codecs the
    scale sidecar lands and commits FIRST, then the data shard — whose
    manifest entry is the overall commit point. A reader that sees a
    committed data range is therefore guaranteed its scales are readable;
    a crash between the two leaves only an orphaned sidecar entry, which no
    reader ever addresses.

        writer = StreamingProjectionWriter(path, (N_p, N_v, N_u),
                                           codec="fp8_e4m3")
        writer.append(frames, lo)            # one scanner burst
        ...
        src = ProjectionSource(path)         # reader, possibly another host
        for lo, hi, delta in src.iter_deltas(mesh): session.update(...)
    """

    def __init__(self, path: str, shape: Sequence[int],
                 codec: "Precision | str | None" = None):
        if len(shape) != 3:
            raise ValueError(f"projection stream shape must be "
                             f"(N_p, N_v, N_u), got {tuple(shape)}")
        self.path = path
        self.shape = tuple(shape)
        self._prec = None if codec is None else resolve_precision(codec)
        extra = ({"codec": self._prec.storage}
                 if self._prec is not None else None)
        dtype = (torch.float32 if self._prec is None
                 else self._prec.storage_dtype)
        shard_store.init_store(path, self.shape, dtype, extra_manifest=extra)
        if self._prec is not None and self._prec.codec.has_scales:
            shard_store.init_store(os.path.join(path, SCALES_DIR),
                                   self.shape[:1], torch.float32)

    def append(self, projections, lo: int) -> Tuple[int, int]:
        """Commit the contiguous angle range [lo, lo + n) (encoding it
        first, on the projections' device, when the store carries a
        codec). Returns (lo, hi)."""
        projections = torch.as_tensor(projections)
        n, n_v, n_u = projections.shape
        hi = lo + n
        if (n_v, n_u) != self.shape[1:] or hi > self.shape[0]:
            raise ValueError(
                f"delta [{lo}, {hi}) x ({n_v}, {n_u}) does not fit the "
                f"declared stream shape {self.shape}")
        region = ((lo, hi), (0, n_v), (0, n_u))
        if self._prec is None:
            shard_store.append_region(self.path, region, projections)
            return lo, hi
        data, scales = self._prec.codec.encode(projections)
        if scales is not None:   # sidecar first — see commit ordering above
            shard_store.append_region(os.path.join(self.path, SCALES_DIR),
                                      ((lo, hi),), scales)
        shard_store.append_region(self.path, region, data)
        return lo, hi


# Manifest key recording a non-canonical stored volume layout (VolumeSink).
LAYOUT_KEY = "layout"


class VolumeSink:
    """Slice-per-rank volume store: each rank's part of the reconstructed
    volume goes straight to its own file — no gather, no root writer."""

    def __init__(self, path: str):
        self.path = path

    def write(self, volume, layout: Optional[dict] = None, mesh=None,
              spec: Optional[Sequence] = None) -> str:
        """Write the volume; returns the store directory.

        `volume` is a tensor (host-copied here), or a `snapshot` taken
        earlier. On a mesh every rank calls this with its own part of the
        engine's output and `spec`, the mesh axes each dimension is cut
        over (`ReconstructionPlan.output_spec()`); each rank writes only
        its own shard (see shard_store.snapshot).

        `layout` records a NON-canonical engine layout in the manifest so
        `read()` can restore the canonical (N_x, N_y, N_z) volume — the
        chunked+scatter engine emits its 4-D (N_x, y_chunks,
        N_y/y_chunks, N_z) accumulator layout, recorded as
        ``{"kind": "y_chunk_major", "y_chunks": int}``."""
        extra = None if layout is None else {LAYOUT_KEY: layout}
        if mesh is not None:
            volume = shard_store.snapshot(volume, mesh, spec)
        return shard_store.save_array(self.path, volume,
                                      extra_manifest=extra)

    def layout(self) -> Optional[dict]:
        """The recorded engine layout, or None for a canonical store."""
        return shard_store.read_manifest(self.path).get(LAYOUT_KEY)

    def read(self) -> torch.Tensor:
        """The stored volume as a CPU tensor, in the canonical
        (N_x, N_y, N_z) axis order when the manifest records a
        non-canonical engine layout."""
        arr = shard_store.load_array(self.path)
        layout = self.layout()
        if layout is None:
            return arr
        kind = layout.get("kind")
        if kind != "y_chunk_major":
            raise shard_store.StoreError(
                f"volume store {self.path!r} records unknown layout "
                f"{kind!r}; cannot canonicalize")
        # (N_x, y_chunks, yc, N_z) -> (N_x, N_y, N_z): chunk-major y is
        # contiguous, a reshape restores the volume.
        n_x, y_chunks, yc, n_z = arr.shape
        return arr.reshape(n_x, y_chunks * yc, n_z)

    def nbytes(self) -> int:
        """Stored payload size (shard files only, not the manifest)."""
        sdir = os.path.join(self.path, shard_store.SHARD_DIR)
        return sum(os.path.getsize(os.path.join(sdir, f))
                   for f in os.listdir(sdir))


# ---------------------------------------------------------------------------
# Inter-scan I/O overlap: scan k+1's reads and scan k-1's writes run on
# background threads while scan k computes. Device work stays on the
# caller's thread; these helpers only move the host-side I/O off it.
# ---------------------------------------------------------------------------

class PrefetchError(RuntimeError):
    """A background load failed; raised on the consumer thread by
    `SourcePrefetcher.get` with the original exception as __cause__."""


class SourcePrefetcher:
    """Double-buffered background loader for a sequence of projection reads.

    jobs  : sequence of zero-arg callables, each returning one scan's
            projections (typically `lambda: source.load(mesh)`). Jobs run
            IN ORDER on one worker thread.
    depth : how many loaded scans may sit ready ahead of the consumer
            (default 2 = double buffering; memory stays bounded at `depth`
            scans).
    persistent : keep the worker alive after the initial jobs drain so
            `extend(jobs)` can feed it more work; a persistent prefetcher
            only reaches DONE via `finish()` or `close()`. A one-shot one
            (the default) is finished at construction.

    State machine:

        IDLE --start()--> FILLING --queue full--> BLOCKED(producer)
        FILLING/BLOCKED --get()--> FILLING        consumer frees a slot
        persistent + jobs drained --> IDLE(worker) --extend()--> FILLING
        last job done after finish()/one-shot ctor --> DRAINING
            --get() x k--> DONE (StopIteration, LATCHED: every later
            get() raises StopIteration again instead of blocking on the
            empty queue forever)
        close() --> DONE (worker unblocked + joined; pending jobs
            abandoned; later get() raises StopIteration)
        job raises --> the error is queued in-order and re-raised by the
                       MATCHING get(); later jobs still run, so one bad
                       load fails only its own scan and the queue stays
                       positionally aligned (job k <-> get() k).

    Also iterable: ``for proj in SourcePrefetcher(jobs): ...``.
    """

    _DONE = object()

    def __init__(self, jobs: Sequence[Callable[[], object]] = (),
                 depth: int = 2, persistent: bool = False):
        if depth < 1:
            raise ValueError(f"prefetch depth={depth} must be >= 1")
        self._pending: "deque[Callable[[], object]]" = deque(jobs)
        self._jobs_cv = threading.Condition()
        self._no_more_jobs = not persistent   # one-shot: finished at ctor
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._started = False
        self._finished = False    # consumer-side latch: DONE was observed
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)

    def extend(self, jobs: Sequence[Callable[[], object]]) -> None:
        """Queue more load jobs on a `persistent` prefetcher. Raises on a
        finished/closed one — its worker is (or is about to be) gone."""
        with self._jobs_cv:
            if self._no_more_jobs or self._stop.is_set():
                raise RuntimeError(
                    "cannot extend a finished prefetcher (one-shot, "
                    "finish()ed, or closed)")
            self._pending.extend(jobs)
            self._jobs_cv.notify()

    def finish(self) -> None:
        """No more jobs are coming: after the pending ones drain, the
        worker queues DONE and exits (persistent mode's graceful end)."""
        with self._jobs_cv:
            self._no_more_jobs = True
            self._jobs_cv.notify()

    def _next_job(self):
        """Worker-side: the next job, or None when the prefetcher is done
        (stopped, or finished with nothing pending)."""
        with self._jobs_cv:
            while True:
                if self._stop.is_set():
                    return None
                if self._pending:
                    return self._pending.popleft()
                if self._no_more_jobs:
                    return None
                # persistent + idle: wait for extend()/finish()/close().
                # The timeout is a safety net against a lost notify.
                self._jobs_cv.wait(timeout=0.1)

    def _worker(self) -> None:
        # Metrics are re-fetched per job (not cached at start) so a
        # registry reset between drains cannot orphan the instruments.
        tracer = get_tracer()
        while True:
            job = self._next_job()
            if job is None:
                break
            try:
                with tracer.span("io.prefetch.load", timed=True) as sp:
                    item = (True, job())
                _metrics.counter("io.prefetch.loads").inc()
                _metrics.histogram("io.prefetch.load_seconds").observe(
                    sp.duration_s)
            except BaseException as e:  # re-raised on the consumer side
                item = (False, e)
                _metrics.counter("io.prefetch.errors").inc()
            if not self._put(item):
                break
        self._put((True, self._DONE))

    def _put(self, item) -> bool:
        """Blocking put that gives up when the consumer called close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                _metrics.gauge("io.prefetch.queue_depth").set(
                    self._q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def start(self) -> "SourcePrefetcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def get(self):
        """Next loaded scan, blocking until the worker has it. Raises
        PrefetchError when that scan's load failed, StopIteration when all
        jobs are consumed — idempotently (exhaustion is latched). get()
        after close() likewise raises StopIteration once the (abandoned)
        queue is drained."""
        self.start()
        if self._finished:
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            try:
                ok, item = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                # A closed prefetcher's worker may have died without
                # queueing DONE (close() makes _put give up); don't hang.
                if self._stop.is_set() and not self._thread.is_alive():
                    self._finished = True
                    raise StopIteration from None
        _metrics.gauge("io.prefetch.queue_depth").set(self._q.qsize())
        if item is not self._DONE:   # blocked-on-worker time, real items only
            _metrics.histogram("io.prefetch.wait_seconds").observe(
                time.perf_counter() - t0)
        if not ok:
            raise PrefetchError(
                f"background projection load failed: {item}") from item
        if item is self._DONE:
            self._finished = True
            raise StopIteration
        return item

    def __iter__(self):
        self.start()
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    def close(self) -> None:
        """Stop loading; pending jobs are abandoned (no partial results are
        handed out — even already-loaded ones still sitting in the queue)
        and later get() calls raise StopIteration."""
        self._stop.set()
        with self._jobs_cv:
            self._jobs_cv.notify()
        if self._started:
            self._thread.join(timeout=5.0)
        self._finished = True


class AsyncWriteback:
    """Write-behind executor for VolumeSink stores.

    `submit(sink, volume)` copies the volume to host memory on the calling
    thread (for a CUDA tensor that waits for the card to finish it), then
    hands the host copy to a single-worker executor that writes the store,
    so the caller may overwrite or free `volume` as soon as submit returns,
    and the file writes overlap the next scan's compute. Writes run in
    submission order (one worker). `pending` is bounded: submit blocks once
    `max_pending` writes are in flight, so host memory stays bounded under
    a fast producer. `drain()` joins and re-raises the FIRST failed write.
    """

    def __init__(self, max_pending: int = 2):
        if max_pending < 1:
            raise ValueError(f"max_pending={max_pending} must be >= 1")
        self._max_pending = max_pending
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="volume-writeback")
        self._futures: List[Future] = []
        self._lock = threading.Lock()

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(not f.done() for f in self._futures)

    def submit(self, sink: VolumeSink, volume,
               layout: Optional[dict] = None) -> Future:
        """Queue `sink.write(host copy of volume, layout=)`; blocks only
        when the write-behind queue is full (backpressure)."""
        while self.pending >= self._max_pending:
            # Wait on the oldest unfinished write (ordered single worker).
            with self._lock:
                oldest = next((f for f in self._futures if not f.done()),
                              None)
            if oldest is None:
                break
            try:
                oldest.result()
            except BaseException:
                pass  # surfaced by drain(); keep the queue moving
        host = shard_store.snapshot(volume)

        def _counted_write():
            # Runs on the writeback worker thread: the span lands on its
            # own tid in the trace, visualizing store/compute overlap.
            t0 = time.perf_counter()
            try:
                with get_tracer().span("io.writeback.write"):
                    out = sink.write(host, layout=layout)
            except BaseException:
                _metrics.counter("io.writeback.errors").inc()
                raise
            finally:
                _metrics.gauge("io.writeback.pending").set(self.pending)
            _metrics.counter("io.writeback.writes").inc()
            _metrics.histogram("io.writeback.write_seconds").observe(
                time.perf_counter() - t0)
            return out

        fut = self._pool.submit(_counted_write)
        with self._lock:
            # Prune completed-OK writes here, not only in drain(): callers
            # that result() the returned future directly would otherwise
            # grow the list forever. Failed futures are kept so drain()
            # can still re-raise them.
            self._futures = [f for f in self._futures
                             if not f.done() or f.exception() is not None]
            self._futures.append(fut)
        _metrics.gauge("io.writeback.pending").set(self.pending)
        return fut

    def drain(self) -> int:
        """Wait for every queued write; returns how many completed OK and
        re-raises the first failure (subsequent writes still ran — the
        single worker never cancels queued work)."""
        with self._lock:
            futures, self._futures = self._futures, []
        first_err = None
        done = 0
        for f in futures:
            try:
                f.result()
                done += 1
            except BaseException as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return done

    def close(self) -> None:
        self._pool.shutdown(wait=True)
