"""Port parity for the performance model (`repro_torch.core.perf_model`,
paper Eqs. 8-19) against `repro.core.perf_model`: the same geometry, grid
and machine give the same `PerfBreakdown` fields, to 1e-12 relative.
Plus the port's own `H100` spec."""
import dataclasses

import pytest

from repro.core import distributed as jdist
from repro.core import geometry as jgeo
from repro.core import perf_model as jpm
from repro_torch.core import distributed as tdist
from repro_torch.core import geometry as tgeo
from repro_torch.core import perf_model as tpm

REL = 1e-12
FIELDS = tuple(f.name for f in dataclasses.fields(jpm.PerfBreakdown))
PROPS = ("t_read", "t_write", "t_io", "t_compute", "t_post", "t_runtime",
         "delta")
GEOMETRIES = {"paper": jgeo.paper_geometry(),
              "paper-2k": jgeo.paper_geometry(2048, 2048, 1024),
              "small": jgeo.default_geometry(64)}
GRIDS = [(1, 1), (32, 8), (4, 16), (256, 1)]
OPTIONS = [{}, {"storage_bytes": 2.0}, {"storage_bytes": 1.0,
                                        "sidecar_bytes": 4.0 * 4096},
           {"reduce_bytes": 2.0}]


def _pair(name):
    g = GEOMETRIES[name]
    return g, tgeo.CBCTGeometry(**dataclasses.asdict(g))


def _machines(jm, tm):
    """(reference, port) versions of a machine: stock, PFS-throttled,
    per-rank capped, calibration-overlaid."""
    yield jm, tm
    yield jm.with_pfs(read=1e9, write=2e9), tm.with_pfs(read=1e9, write=2e9)
    yield (jm.with_pfs(rank_io=1e8), tm.with_pfs(rank_io=1e8))
    kw = dict(flt_scale=2.0, allgather_scale=0.5, reduce_scale=3.0,
              read_scale=1.5, write_scale=0.25)
    yield jm.with_overlay(**kw), tm.with_overlay(**kw)


def _close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: ",".join(o) or "f32")
@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_predict_matches_reference_under_abci(geom, rc, opts):
    jg, tg = _pair(geom)
    for jm, tm in _machines(jpm.ABCI, tpm.ABCI):
        assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
        want = jpm.predict(jg, jdist.IFDKGrid(*rc), jm, **opts)
        got = tpm.predict(tg, tdist.IFDKGrid(*rc), tm, **opts)
        for f in FIELDS + PROPS:
            assert _close(getattr(got, f), getattr(want, f)), f
        assert _close(tpm.gups_end_to_end(tg, got),
                      jpm.gups_end_to_end(jg, want))


def test_breakdown_overlap_switch_matches():
    jg, tg = _pair("paper")
    want = dataclasses.replace(
        jpm.predict(jg, jdist.IFDKGrid(32, 8)), overlap=False)
    got = dataclasses.replace(
        tpm.predict(tg, tdist.IFDKGrid(32, 8)), overlap=False)
    assert _close(got.t_compute, want.t_compute)
    assert _close(got.t_compute, got.t_load + got.t_flt + got.t_allgather
                  + got.t_bp)


def test_machines():
    """ABCI is the reference's; H100 is the port's own (single-card terms
    measured on the card, inter-card terms ABCI's until a multi-card run);
    the reference's TPU constants are not carried over."""
    assert tpm.SystemConstants is tpm.MachineSpec
    assert not hasattr(tpm, "TPU_V5E")
    h = tpm.H100
    assert h.name == "h100" and h.name != tpm.ABCI.name
    assert (h.th_allgather, h.th_reduce) == (tpm.ABCI.th_allgather,
                                            tpm.ABCI.th_reduce)
    assert (h.devices_per_node, h.n_hd_links) == (1, 1)
    for f in ("bw_load", "bw_store", "th_flt", "gups_bp", "bw_hd"):
        assert getattr(h, f) > 0
    g = tgeo.paper_geometry()
    b = tpm.predict(g, tdist.IFDKGrid(32, 8), h)
    assert b.t_runtime > 0 and b.t_reduce > 0
