"""Trace-calibrated cost constants: close the predicted->measured loop.

Port of `repro/planner/calibrate.py`. The port's samples live under a key
tag of their own ("cal-torch"), so one store file shared with the JAX
package never fits one package's timings into the other's overlay.

`planner/cost.py` prices plans with hand-set ABCI-era constants (per-impl
GUPS factors, step overhead, FFT/collective throughputs), so on any other
host the ranking can be wrong. `obs.attribution.compare` measures
per-stage model error on traced runs; this module feeds it back:

  CalibrationStore      a persistent sample store (repro_torch/filecache.py,
                        env ``REPRO_CALIB_CACHE``) accumulating
                        (predicted, measured) stage samples from every
                        traced run — `build_traced` engines, traced
                        `IncrementalSession`s, and the planner's own
                        measured refinement
                        (planner/measure.py deposits its engine timings).
                        Keys: (system, stage, impl, schedule, reduce,
                        precision, problem-size bucket).
  MachineCalibration    the robust least-squares fit of those samples: a
                        per-stage time-scale overlay on a `MachineSpec`
                        (filter/AllGather/reduce throughputs, PFS
                        read/write), per-impl back-projection scales (the
                        measured replacement for `IMPL_GUPS_FACTOR`), and
                        a per-step dispatch overhead fitted from
                        fused-vs-pipelined engine pairs. Outliers are
                        MAD-rejected on log-ratios and every constant is
                        min-sample gated, so one noisy span cannot skew
                        rankings; unfitted constants fall back to stock.

`auto_plan(..., calibration="auto")` (the `plan_from_spec(g, "auto")`
default) resolves the overlay from the default store when enough samples
exist and ranks with it — including admitting `impl="kernel"` into the
searched space off the card once its FITTED factor beats reference's
(the measured retirement of the hard CPU-only guard).

``REPRO_CALIB_CACHE`` names the store file ("off"/"0"/""/"none" disables
both accumulation and the auto overlay; unset falls back to
~/.cache/repro/calibration_store.json — the REPRO_TUNE_CACHE convention).
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.perf_model import ABCI, MachineSpec
from ..filecache import JsonFileCache
from ..obs.attribution import STAGE_FIELDS

from .cost import IMPL_GUPS_FACTOR, STEP_OVERHEAD_S, PlanPoint, \
    point_from_plan, predict_point

__all__ = [
    "MIN_SAMPLES", "MachineCalibration", "CalibrationStore",
    "default_store", "set_default_store", "default_calibration",
    "resolve_calibration", "record_traced_run", "record_engine_measurement",
    "robust_scale", "size_bucket",
]

# A constant is only trusted once this many samples survive outlier
# rejection — below the gate the stock value stands.
MIN_SAMPLES = 3
# Per-key ring: newest samples win (drift tracks the machine, not history).
MAX_SAMPLES_PER_KEY = 64
# MachineSpec throughput/bandwidth overlays, keyed by PerfBreakdown field.
# t_bp is NOT here: back-projection calibrates per impl (bp_scales).
_FIELD_OVERLAY_KW = {
    "t_flt": "flt_scale",
    "t_allgather": "allgather_scale",
    "t_reduce": "reduce_scale",
    "t_read": "read_scale",
    "t_write": "write_scale",
}


def size_bucket(g, grid) -> int:
    """Coarse problem-size key: log2 of back-projection updates per rank.
    Buckets bound per-key sample counts; the fit pools across them
    (time-weighted, so big runs dominate anyway)."""
    updates = g.n_x * g.n_y * g.n_z * g.n_proj / max(1, grid.n_ranks)
    return int(round(math.log2(max(2.0, updates))))


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def robust_scale(samples: Sequence[Tuple[float, float]],
                 min_samples: int = MIN_SAMPLES
                 ) -> Tuple[Optional[float], int, int]:
    """(scale, n_used, n_rejected): time-weighted least squares through the
    origin for measured ~ scale * predicted, after MAD outlier rejection
    on log-ratios.

    Rejection: a sample whose log(m/p) sits more than 3 MAD + 0.2 from the
    median ratio is dropped (the floor keeps a zero-spread cluster from
    rejecting everything but exact duplicates). Weights are the measured
    seconds, so a 2 s run outvotes twenty 1 ms dispatch-noise runs.
    Returns (None, 0, n_rejected) when fewer than `min_samples` survive —
    the caller falls back to the stock constant.
    """
    pts = [(float(p), float(m)) for p, m in samples if p > 0 and m > 0]
    if len(pts) < min_samples:
        return None, 0, 0
    logr = [math.log(m / p) for p, m in pts]
    med = _median(logr)
    mad = _median([abs(l - med) for l in logr])
    tol = 3.0 * mad + 0.2
    keep = [pt for pt, l in zip(pts, logr) if abs(l - med) <= tol]
    rejected = len(pts) - len(keep)
    if len(keep) < min_samples:
        return None, 0, rejected
    num = sum(m * p * m for p, m in keep)
    den = sum(m * p * p for p, m in keep)
    if den <= 0:
        return None, 0, rejected
    return num / den, len(keep), rejected


@dataclasses.dataclass(frozen=True)
class MachineCalibration:
    """The fitted overlay: measured/predicted TIME scales per constant.

    `stage_scales` maps PerfBreakdown fields (t_flt, t_allgather, t_reduce,
    t_read, t_write) to their fitted scale; `bp_scales` maps impls to the
    scale of the whole Eq. 12 back-projection term (the measured view of
    `IMPL_GUPS_FACTOR`: fitted factor = stock factor / bp_scale);
    `step_overhead_s` replaces STEP_OVERHEAD_S when fitted. Absent keys
    mean "not enough samples — stock constant stands".
    """

    base: str                               # MachineSpec.name fitted against
    stage_scales: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    bp_scales: Mapping[str, float] = dataclasses.field(default_factory=dict)
    step_overhead_s: Optional[float] = None
    n_samples: int = 0
    n_rejected: int = 0

    @property
    def is_empty(self) -> bool:
        return (not self.stage_scales and not self.bp_scales
                and self.step_overhead_s is None)

    def scale(self, field: str) -> float:
        return float(self.stage_scales.get(field, 1.0))

    def bp_scale(self, impl: str) -> Optional[float]:
        s = self.bp_scales.get(impl)
        return None if s is None else float(s)

    def step_overhead(self) -> float:
        return (STEP_OVERHEAD_S if self.step_overhead_s is None
                else self.step_overhead_s)

    def apply(self, system: MachineSpec) -> MachineSpec:
        """`system` with every fitted stage scale folded into its
        throughput/bandwidth constants (MachineSpec.with_overlay)."""
        kw = {_FIELD_OVERLAY_KW[f]: s for f, s in self.stage_scales.items()
              if f in _FIELD_OVERLAY_KW}
        return system.with_overlay(**kw) if kw else system

    def impl_gups_factor(self, impl: str) -> Optional[float]:
        """The measured counterpart of IMPL_GUPS_FACTOR[impl]: the stock
        factor corrected by the fitted back-projection scale. None when
        the impl has no fitted evidence."""
        s = self.bp_scale(impl)
        if s is None or s <= 0:
            return None
        return IMPL_GUPS_FACTOR.get(impl, 1.0) / s

    def admits_impl(self, impl: str) -> bool:
        """Measured-evidence gate for the search space: `impl` competes
        once its fitted factor exists and beats reference's (fitted when
        available, stock otherwise). This is what retires the hard
        CPU-only kernel guard in auto_plan."""
        f = self.impl_gups_factor(impl)
        if f is None:
            return False
        ref = self.impl_gups_factor("reference")
        if ref is None:
            ref = IMPL_GUPS_FACTOR["reference"]
        return f > ref

    def to_dict(self) -> dict:
        return {
            "base": self.base,
            "stage_scales": dict(self.stage_scales),
            "bp_scales": dict(self.bp_scales),
            "step_overhead_s": self.step_overhead_s,
            "n_samples": self.n_samples,
            "n_rejected": self.n_rejected,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MachineCalibration":
        return cls(
            base=str(d.get("base", "")),
            stage_scales={str(k): float(v)
                          for k, v in (d.get("stage_scales") or {}).items()},
            bp_scales={str(k): float(v)
                       for k, v in (d.get("bp_scales") or {}).items()},
            step_overhead_s=(None if d.get("step_overhead_s") is None
                             else float(d["step_overhead_s"])),
            n_samples=int(d.get("n_samples", 0)),
            n_rejected=int(d.get("n_rejected", 0)),
        )

    def summary(self) -> str:
        parts = [f"base={self.base}", f"samples={self.n_samples}",
                 f"rejected={self.n_rejected}"]
        for f in sorted(self.stage_scales):
            parts.append(f"{f}x{self.stage_scales[f]:.3g}")
        for impl in sorted(self.bp_scales):
            parts.append(f"bp[{impl}]x{self.bp_scales[impl]:.3g}")
        if self.step_overhead_s is not None:
            parts.append(f"step_overhead={self.step_overhead_s * 1e6:.0f}us")
        return " ".join(parts)


class CalibrationStore:
    """Accumulates (predicted, measured) samples and fits the overlay.

    Persistence rides `repro_torch.filecache.JsonFileCache` (read-modify-write
    with atomic replace, best-effort on read-only filesystems), so traced
    runs in different processes — CI steps, bench CLIs, test subprocesses
    — accumulate into one file and any of them can fit. With persistence
    disabled (env "off" or a path-less cache) the store still works
    in-memory for the lifetime of the process.
    """

    _KEY_TAG = "cal-torch"

    def __init__(self, cache: Optional[JsonFileCache] = None):
        self._cache = cache if cache is not None else JsonFileCache(
            "REPRO_CALIB_CACHE", "calibration_store.json")
        self._mem: Dict[tuple, List[dict]] = {}
        self._lock = threading.Lock()

    @property
    def persistent(self) -> bool:
        return self._cache.path() is not None

    def path(self) -> Optional[str]:
        return self._cache.path()

    # -- recording -----------------------------------------------------------

    def _key(self, system: str, stage: str, impl: str, schedule: str,
             reduce: str, precision: str, bucket: int) -> tuple:
        return (self._KEY_TAG, system, stage, impl, schedule, reduce,
                precision, int(bucket))

    def record(self, *, system: str, stage: str, impl: str, schedule: str,
               reduce: str, precision: str, bucket: int,
               predicted_s: float, measured_s: float,
               n_steps: Optional[int] = None,
               updates: Optional[float] = None) -> None:
        """Append one (predicted, measured) sample. Zero/negative sides are
        dropped (nothing to fit against)."""
        if measured_s <= 0 or predicted_s <= 0:
            return
        sample: dict = {"p": float(predicted_s), "m": float(measured_s)}
        if n_steps is not None:
            sample["k"] = int(n_steps)
        if updates is not None:
            sample["sz"] = float(updates)
        key = self._key(system, stage, impl, schedule, reduce, precision,
                        bucket)
        with self._lock:
            if self.persistent:
                cur = self._cache.get(key)
                cur = list(cur) if isinstance(cur, list) else []
                cur.append(sample)
                self._cache.put(key, cur[-MAX_SAMPLES_PER_KEY:])
            else:
                cur = self._mem.setdefault(key, [])
                cur.append(sample)
                del cur[:-MAX_SAMPLES_PER_KEY]

    def record_traced_run(self, plan, stage_seconds: Mapping[str, float],
                          system: MachineSpec = ABCI) -> None:
        """Deposit one traced run's per-stage wall times, predicted against
        what the traced engine actually EXECUTED: `build_traced` always
        runs the fused stage decomposition regardless of the plan's
        schedule, so batch plans record against their fused projection;
        a traced `IncrementalSession` records against the incremental
        point itself (whose cost already carries the per-delta terms)."""
        point = point_from_plan(plan)
        if point.schedule != "incremental":
            point = dataclasses.replace(point, schedule="fused", n_steps=1,
                                        y_chunks=None)
        g = plan.geometry
        bd = predict_point(g, point, system)
        bucket = size_bucket(g, point.grid)
        for stage, field in STAGE_FIELDS.items():
            measured = float(stage_seconds.get(stage, 0.0))
            if measured <= 0.0:
                continue
            predicted = float(getattr(bd, field))
            if stage == "stage.backproject":
                # The fitted bp scale multiplies ONLY the update-rate part
                # of Eq. 12 (`predict_point` rescales t_bp - t_h2d; the H2D
                # term is traffic, priced by bw_load) — record against the
                # same basis or the fit and its application disagree by
                # t_bp / (t_bp - t_h2d).
                predicted -= float(bd.t_h2d)
            self.record(
                system=system.name, stage=stage, impl=point.impl,
                schedule=point.schedule, reduce=point.reduce,
                precision=point.precision, bucket=bucket,
                predicted_s=predicted, measured_s=measured)

    def record_engine(self, g, point: PlanPoint, measured_s: float,
                      system: MachineSpec = ABCI) -> None:
        """Deposit one whole-engine measurement (planner/measure.py's
        refinement timings — one measurement path, two consumers). Engine
        rows feed the per-step dispatch-overhead fit: a pipelined run at
        n_steps=k against a fused run of the SAME problem isolates
        k * overhead."""
        bd = predict_point(g, point, system)
        self.record(
            system=system.name, stage="engine", impl=point.impl,
            schedule=point.schedule, reduce=point.reduce,
            precision=point.precision,
            bucket=size_bucket(g, point.grid),
            predicted_s=float(bd.t_runtime), measured_s=float(measured_s),
            n_steps=point.n_steps,
            updates=float(g.n_x) * g.n_y * g.n_z * g.n_proj)

    # -- reading / fitting ---------------------------------------------------

    def samples(self) -> Dict[tuple, List[dict]]:
        """All samples, file entries merged under in-memory ones."""
        out: Dict[tuple, List[dict]] = {}
        for key_str, entry in self._cache.entries().items():
            if not isinstance(entry, list):
                continue
            try:
                key = tuple(json.loads(key_str))
            except ValueError:
                continue
            if len(key) == 8 and key[0] == self._KEY_TAG:
                out[key] = [s for s in entry if isinstance(s, dict)]
        with self._lock:
            for key, entry in self._mem.items():
                out.setdefault(key, []).extend(entry)
        return out

    def n_samples(self, system: Optional[str] = None) -> int:
        return sum(len(v) for k, v in self.samples().items()
                   if system is None or k[1] == system)

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            path = self._cache.path()
        if path is not None:
            import os
            try:
                os.remove(path)
            except OSError:
                pass

    def fit(self, system: MachineSpec = ABCI,
            min_samples: int = MIN_SAMPLES) -> MachineCalibration:
        """Fit the overlay from every sample recorded against `system`'s
        constants. Stage constants pool across impl/schedule/precision
        keys (time-weighted); back-projection fits PER IMPL (that is the
        fitted GUPS factor); step overhead fits from fused-vs-stepped
        engine pairs on identical problems. Every constant is
        independently gated at `min_samples` survivors."""
        stage_pts: Dict[str, List[Tuple[float, float]]] = {}
        bp_pts: Dict[str, List[Tuple[float, float]]] = {}
        eng: Dict[tuple, Dict[str, list]] = {}
        for key, samples in self.samples().items():
            _, sysname, stage, impl, schedule, reduce, precision, _b = key
            if sysname != system.name:
                continue
            if stage == "engine":
                for s in samples:
                    sz = s.get("sz")
                    if sz is None:
                        continue
                    grp = eng.setdefault((impl, precision, reduce, sz),
                                         {"fused": [], "stepped": []})
                    k = int(s.get("k", 1))
                    if schedule == "fused" or k <= 1:
                        grp["fused"].append(s["m"])
                    else:
                        grp["stepped"].append((s["m"], k))
            elif stage == "stage.backproject":
                bp_pts.setdefault(impl, []).extend(
                    (s["p"], s["m"]) for s in samples)
            elif stage in STAGE_FIELDS:
                stage_pts.setdefault(STAGE_FIELDS[stage], []).extend(
                    (s["p"], s["m"]) for s in samples)

        stage_scales: Dict[str, float] = {}
        bp_scales: Dict[str, float] = {}
        n_used = n_rej = 0
        for field, pts in stage_pts.items():
            scale, used, rej = robust_scale(pts, min_samples)
            n_rej += rej
            if scale is not None:
                stage_scales[field] = scale
                n_used += used
        for impl, pts in bp_pts.items():
            scale, used, rej = robust_scale(pts, min_samples)
            n_rej += rej
            if scale is not None:
                bp_scales[impl] = scale
                n_used += used

        # per-step dispatch overhead: (stepped - fused) / k on the same
        # (impl, precision, reduce, problem) — the model term the analytic
        # STEP_OVERHEAD_S stands in for. Median over pairs, clipped >= 0.
        ests: List[float] = []
        for grp in eng.values():
            if not grp["fused"] or not grp["stepped"]:
                continue
            base = _median(grp["fused"])
            for m, k in grp["stepped"]:
                ests.append(max(0.0, (m - base) / k))
        step = _median(ests) if len(ests) >= min_samples else None

        return MachineCalibration(
            base=system.name, stage_scales=stage_scales,
            bp_scales=bp_scales, step_overhead_s=step,
            n_samples=n_used, n_rejected=n_rej)


# ---------------------------------------------------------------------------
# Process-default store: traced engines, sessions and the measured
# refinement record through this so one env var governs the whole loop.
# ---------------------------------------------------------------------------

_DEFAULT: Optional[CalibrationStore] = None
_EXPLICIT = False
_DEFAULT_LOCK = threading.Lock()


def default_store() -> CalibrationStore:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = CalibrationStore()
        return _DEFAULT


def set_default_store(store: Optional[CalibrationStore]
                      ) -> Optional[CalibrationStore]:
    """Swap the process-default store (tests install a fresh one); returns
    the previous store. None resets to a lazily re-created default. An
    explicitly installed store records even without persistence (in-memory
    only) — the env off-switch governs only the implicit default."""
    global _DEFAULT, _EXPLICIT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, store
        _EXPLICIT = store is not None
        return prev


def _recording_enabled() -> bool:
    # An explicitly installed store (tests, CLIs) always records; the
    # lazily created default records only when REPRO_CALIB_CACHE gives it
    # a file (the env off-switch).
    return _EXPLICIT or default_store().persistent


def record_traced_run(plan, stage_seconds: Mapping[str, float],
                      system: MachineSpec = ABCI) -> None:
    """Default-store hook `build_traced` / traced sessions call after a
    run. No-op when REPRO_CALIB_CACHE disables the store."""
    if _recording_enabled():
        default_store().record_traced_run(plan, stage_seconds, system)


def record_engine_measurement(g, point: PlanPoint, measured_s: float,
                              system: MachineSpec = ABCI) -> None:
    """Default-store hook for planner/measure.py engine timings."""
    if _recording_enabled():
        default_store().record_engine(g, point, measured_s, system)


def default_calibration(system: MachineSpec = ABCI,
                        min_samples: int = MIN_SAMPLES
                        ) -> Optional[MachineCalibration]:
    """The default store's fitted overlay, or None when the store is
    disabled or no constant passed the sample gate (stock constants
    stand)."""
    store = default_store()
    if not store.persistent and not store._mem:
        return None
    cal = store.fit(system, min_samples)
    return None if cal.is_empty else cal


def resolve_calibration(calibration, system: MachineSpec
                        ) -> Tuple[Optional[MachineCalibration], MachineSpec]:
    """Normalize `auto_plan`'s calibration argument to (overlay, system).

    None         -> stock constants.
    "auto"       -> the default store's fit when enough samples exist.
    MachineCalibration -> used as given.
    MachineSpec  -> the caller already fitted constants: use them AS the
                    system, no overlay.
    """
    if calibration is None:
        return None, system
    if isinstance(calibration, MachineCalibration):
        return calibration, system
    if isinstance(calibration, MachineSpec):
        return None, calibration
    if calibration == "auto":
        return default_calibration(system), system
    raise ValueError(
        f"calibration must be None, 'auto', a MachineCalibration or a "
        f"MachineSpec; got {calibration!r}")
