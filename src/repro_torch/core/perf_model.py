"""iFDK performance model (paper §4.2, Eqs. 8-19).

T_compute = max(T_load, T_flt, T_AllGather, T_bp)            (Eq. 17)
T_post    = T_trans + T_D2H + T_reduce + T_store             (Eq. 18)
T_runtime = T_compute + T_post                               (Eq. 19)

Port of `repro/core/perf_model.py`, verbatim but for the machines.
Constants are per-system micro-benchmark values (§4.2.1). `ABCI`
reproduces the paper's projections (V100 nodes, GPFS, EDR IB); the parity
tests price plans on it in both packages. `H100` is one NVIDIA H100 node of
this port: its single-card terms measured by `chip_smoke.py`
([machine-spec]). The reference's `TPU_V5E` is left out: it holds a TPU's
constants, and nothing outside the reference's perf_model.py reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .distributed import IFDKGrid
from .geometry import CBCTGeometry


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Per-system micro-benchmark constants (§4.2.1), including the
    parallel-filesystem bandwidths the I/O terms (Eq. 8/16 — the planner's
    T_read/T_write) are priced from."""

    name: str
    bw_load: float          # PFS aggregate read bandwidth, B/s
    bw_store: float         # PFS aggregate write bandwidth, B/s
    th_flt: float           # filtering throughput, projections/s per node
    th_allgather: float     # AllGather throughput, projections/s per rank-group
    gups_bp: float          # back-projection kernel throughput, GUPS/device
    th_reduce: float        # volume reduction throughput, B/s per rank
    bw_hd: float            # host<->device (PCIe) bandwidth per connector, B/s
    n_hd_links: int         # PCIe connectors per node (paper N_PCIe)
    devices_per_node: int
    # Per-rank PFS link bandwidth, B/s. The slice-per-rank store (repro/io)
    # reads/writes one file per rank, so aggregate I/O bandwidth is
    # min(PFS aggregate, n_concurrent_ranks * bw_rank_io): few writers are
    # link-bound, many writers saturate the filesystem. None = uncapped
    # (the paper's Eq. 8/16, which assume full aggregate bandwidth).
    bw_rank_io: Optional[float] = None

    def with_pfs(self, read: Optional[float] = None,
                 write: Optional[float] = None,
                 rank_io: Optional[float] = None) -> "MachineSpec":
        """This machine with its PFS re-benchmarked (or throttled): the knob
        the planner's with-I/O ranking is regression-tested against."""
        updates = {}
        if read is not None:
            updates["bw_load"] = read
        if write is not None:
            updates["bw_store"] = write
        if rank_io is not None:
            updates["bw_rank_io"] = rank_io
        return dataclasses.replace(self, **updates)

    def with_overlay(self, *, flt_scale: float = 1.0,
                     allgather_scale: float = 1.0,
                     reduce_scale: float = 1.0,
                     read_scale: float = 1.0,
                     write_scale: float = 1.0) -> "MachineSpec":
        """This machine re-anchored by measured/predicted TIME scales (the
        calibration fit's overlay, planner/calibrate.py): a stage that ran
        `s`x slower than modeled gets its throughput/bandwidth divided by
        `s`, so the model predicts the measured time going forward. Scales
        of 1.0 (unfitted constants) leave the stock value untouched."""
        def div(v: float, s: float) -> float:
            return v / s if s > 0 else v

        updates = {}
        if flt_scale != 1.0:
            updates["th_flt"] = div(self.th_flt, flt_scale)
        if allgather_scale != 1.0:
            updates["th_allgather"] = div(self.th_allgather, allgather_scale)
        if reduce_scale != 1.0:
            updates["th_reduce"] = div(self.th_reduce, reduce_scale)
        if read_scale != 1.0:
            updates["bw_load"] = div(self.bw_load, read_scale)
        if write_scale != 1.0:
            updates["bw_store"] = div(self.bw_store, write_scale)
        if not updates:
            return self
        updates["name"] = f"{self.name}+calibrated"
        return dataclasses.replace(self, **updates)

    def agg_read_bw(self, n_readers: int) -> float:
        """Aggregate PFS read bandwidth `n_readers` concurrent ranks see."""
        if self.bw_rank_io is None:
            return self.bw_load
        return min(self.bw_load, n_readers * self.bw_rank_io)

    def agg_write_bw(self, n_writers: int) -> float:
        """Aggregate PFS write bandwidth `n_writers` concurrent ranks see."""
        if self.bw_rank_io is None:
            return self.bw_store
        return min(self.bw_store, n_writers * self.bw_rank_io)


# Backwards-compatible alias (pre-I/O name).
SystemConstants = MachineSpec


# Paper §5.1/§5.3.3 measured constants (ABCI: 4xV100 + 2xEDR per node, GPFS).
ABCI = MachineSpec(
    name="abci-v100",
    bw_load=50e9, bw_store=28.5e9,
    th_flt=100.0, th_allgather=55.0,
    gups_bp=200.0,                      # Table 4: L1-Tran ~200 GUPS
    th_reduce=3.0e9,                    # ~8GB in ~2.7s (dual EDR)
    bw_hd=11.9e9, n_hd_links=2, devices_per_node=4,
)

# One H100 per node, one PCIe link per card. The single-card terms were
# measured by chip_smoke.py's [machine-spec] phase on an H100 80GB HBM3 at
# a 700.00 W power limit (PERF.md §6): gups_bp the factorized
# path's GUPS, 32 RabbitCT projections into 512^3 (IMPL_GUPS_FACTOR is
# relative to it); th_flt RabbitCT's 496 projections over the mean
# stage.filter span of three traced fp32 runs; bw_hd a pinned
# host-to-device copy of 1 GiB; bw_load/bw_store the [io] phase's store
# read and write on the machine's local disk (not a parallel
# filesystem). The inter-card terms are not measured on one card:
# th_allgather and th_reduce are ABCI's, the paper's V100/EDR figures,
# until a multi-card run measures them.
H100 = MachineSpec(
    name="h100",
    bw_load=1.4257e9, bw_store=1.2946e9,
    th_flt=13575.3,
    th_allgather=ABCI.th_allgather,     # not measured on this card
    gups_bp=3.0931,
    th_reduce=ABCI.th_reduce,           # not measured on this card
    bw_hd=5.5036e10, n_hd_links=1, devices_per_node=1,
)


@dataclasses.dataclass(frozen=True)
class PerfBreakdown:
    t_load: float
    t_flt: float
    t_allgather: float
    t_h2d: float
    t_bp: float
    t_d2h: float
    t_reduce: float
    t_store: float
    # Eq. 17 assumes the paper's software pipeline: load/filter/AllGather/BP
    # overlap, so T_compute is the max of the stage times. A non-pipelined
    # (fused) schedule serializes the stages instead — overlap=False makes
    # t_compute their sum (the planner's schedule-aware cost, planner/cost.py).
    overlap: bool = True

    # Planner-visible I/O terms: Eq. 8 is the PFS read of the raw
    # projections, Eq. 16 the PFS write of the volume (the shard store's
    # slice-per-rank files, repro/io). Named aliases so I/O is first-class
    # in breakdown tables — t_read rides inside T_compute (the paper
    # overlaps the load with the pipeline), t_write inside T_post.
    @property
    def t_read(self) -> float:                         # Eq. 8 alias
        return self.t_load

    @property
    def t_write(self) -> float:                        # Eq. 16 alias
        return self.t_store

    @property
    def t_io(self) -> float:
        return self.t_read + self.t_write

    @property
    def t_compute(self) -> float:                      # Eq. 17
        stages = (self.t_load, self.t_flt, self.t_allgather, self.t_bp)
        return max(stages) if self.overlap else sum(stages)

    @property
    def t_post(self) -> float:                         # Eq. 18 (T_trans ~ 0)
        return self.t_d2h + self.t_reduce + self.t_store

    @property
    def t_runtime(self) -> float:                      # Eq. 19
        return self.t_compute + self.t_post

    @property
    def delta(self) -> float:
        """Paper Table 5 overlap factor: serial/overlapped compute time."""
        return (self.t_flt + self.t_allgather + self.t_bp) / max(
            self.t_compute, 1e-12
        )


def predict(g: CBCTGeometry, grid: IFDKGrid,
            sys: MachineSpec = ABCI,
            storage_bytes: float = 4.0,
            sidecar_bytes: float = 0.0,
            reduce_bytes: float = 4.0) -> PerfBreakdown:
    """Eqs. 8-16 (float32 volume; projection-stream width `storage_bytes`).

    `storage_bytes` is the wire itemsize of the projection stream — the
    stream codec's `wire_bytes_per_sample` (core/precision.py): it scales
    the load, AllGather and H2D terms — the paper's FP16-texture halving
    (or the fp8 codec's quartering) of the dominant communication time.
    `sidecar_bytes` is the codec's total per-projection scale sidecar
    (fp8: 4 B x N_p) riding on the same wire; it is amortized into the
    per-sample width so every projection-stream byte term prices it.
    `reduce_bytes` is the itemsize the volume Reduce moves (4.0 = f32 psum/
    psum_scatter, 2.0 = the plan layer's bf16 compensated scatter); D2H and
    the PFS store stay f32 — the accumulator and the stored volume are
    always f32. The defaults reproduce the paper's numbers verbatim.

    I/O terms (T_read = Eq. 8, T_write = Eq. 16) price the slice-per-rank
    shard store (repro/io): all R*C ranks read concurrently, R slab owners
    write. With `bw_rank_io` set on the MachineSpec the effective bandwidth
    is capped at n_concurrent * bw_rank_io (per-rank PFS links), otherwise
    the paper's aggregate-bandwidth assumption holds verbatim.
    """
    szf = 4.0
    # Effective wire bytes per projection sample: quantized data plus the
    # scale sidecar spread over the N_u*N_v samples of each projection.
    sp = float(storage_bytes) + float(sidecar_bytes) / (
        g.n_u * g.n_v * g.n_proj or 1)
    r, c = grid.r, grid.c
    n_ranks = grid.n_ranks
    n_nodes = max(1, n_ranks // sys.devices_per_node)
    proj_bytes = sp * g.n_u * g.n_v * g.n_proj
    vol_bytes = szf * g.n_x * g.n_y * g.n_z

    t_load = proj_bytes / sys.agg_read_bw(n_ranks)                      # Eq. 8
    t_flt = g.n_proj / (n_nodes * sys.th_flt)                           # Eq. 9
    t_allgather = (g.n_proj * (sp / szf)
                   / (c * r * sys.th_allgather))                        # Eq.10
    t_h2d = (sp * sys.devices_per_node * g.n_u * g.n_v * g.n_proj
             / (c * sys.bw_hd * sys.n_hd_links))                        # Eq.11
    updates = g.n_x * g.n_y * g.n_z / r * (g.n_proj / c)
    t_bp = t_h2d + updates / (sys.gups_bp * 2**30)                      # Eq.12
    t_d2h = (szf * sys.devices_per_node * g.n_x * g.n_y * g.n_z
             / (r * sys.bw_hd * sys.n_hd_links))                        # Eq.14
    t_reduce = (float(reduce_bytes) * g.n_x * g.n_y * g.n_z
                / (r * sys.th_reduce))                                  # Eq.15
    if c == 1:
        t_reduce = 0.0  # paper: no inter-rank reduction when C == 1
    t_store = vol_bytes / sys.agg_write_bw(r)                           # Eq.16
    return PerfBreakdown(t_load, t_flt, t_allgather, t_h2d, t_bp,
                         t_d2h, t_reduce, t_store)


def gups_end_to_end(g: CBCTGeometry, b: PerfBreakdown) -> float:
    updates = g.n_x * g.n_y * g.n_z * float(g.n_proj)
    return updates / (b.t_runtime * 2**30)
