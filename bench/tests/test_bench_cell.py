"""Whole runs of the cells at test sizes, on the CPU (the program's CPU
paths, the kernel's plain version): sound runs come out correct; the
control and every fault planted underneath the timed path come out not
correct. The control and a sound run are run on the card too where there
is one (skipped here otherwise)."""
import pytest
import torch

from bench_tiny import make_tree, quiet

from bench.harness import cell, client, faults
from bench.harness.registry import Registry

SEED = 2**31 + 17
CLOSED, OPEN = "rct512-device-closed", "rct512-host-open"
# The open loop at test sizes: far above what the CPU serves, so that its
# buckets fill, and short, so that the backlog stays inside the queue.
CROWDED = {"rate_per_s": 150.0}


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return Registry(make_tree(tmp_path_factory.mktemp("bench")))


@pytest.fixture(autouse=True)
def no_tune_file(monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", "off")


DEVICES = ("cpu", "cuda")


def run(reg, name, seconds=0.4, trace=False, device="cpu", **kw):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return cell.run(reg, name, SEED, seconds, trace, device=device,
                    log_fn=quiet, **kw)


@pytest.mark.parametrize("device", DEVICES)
def test_sound_closed_run_is_correct(reg, device):
    res = run(reg, CLOSED, device=device)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    m = res["metrics"]
    assert set(m) == {"ttv_p90_s", "ttv_p50_s", "gups", "setup_s"}
    assert 0 < m["ttv_p50_s"]["value"] <= m["ttv_p90_s"]["value"]
    assert m["gups"]["value"] > 0 and m["setup_s"]["value"] > 0


def test_sound_open_run_fills_buckets_and_is_correct(reg):
    res = run(reg, OPEN, trace=True, mix_overrides=CROWDED)
    assert res["correct"], res["checks"]
    assert res["attempted"] == int(150.0 * 0.4) and res["failed"] == 0
    m = res["metrics"]
    # no device trace on the CPU: only the service's own counters read
    assert set(m) == {"service.assembly_ms.host", "service.pad_share"}
    assert m["service.assembly_ms.host"]["value"] > 0
    assert res["window_s"] > 0 and res["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("device", DEVICES)
def test_control_is_not_correct(reg, device):
    """The configuration's fp32 stream through the program's own bf16
    codec (the control for a float32 configuration) fails the
    comparison."""
    spec = reg.config("rabbitct-512")["plan"].replace("precision=fp32",
                                                      "precision=bf16")
    res = run(reg, CLOSED, spec=spec, device=device)
    assert not res["correct"]
    assert res["checks"]["rel_rmse"]["value"] > \
        res["checks"]["rel_rmse"]["limit"]


@pytest.mark.parametrize("device", DEVICES)
def test_fp16_wire_is_not_correct(reg, device):
    """The program's fp16 codec, which lies between the stated fp32 and
    the bf16 control, fails the comparison too."""
    spec = reg.config("rabbitct-512")["plan"].replace("precision=fp32",
                                                      "precision=fp16")
    res = run(reg, CLOSED, spec=spec, device=device)
    assert not res["correct"]
    assert res["checks"]["rel_rmse"]["value"] > \
        res["checks"]["rel_rmse"]["limit"]


@pytest.mark.parametrize("fault,name", [
    ("answer_altered", CLOSED), ("half_projections", CLOSED),
    ("state_unchanged", CLOSED), ("half_lanes", OPEN),
    ("answer_altered", OPEN)])
def test_a_broken_timed_path_is_not_correct(reg, fault, name):
    with faults.FAULTS[fault]():
        res = run(reg, name, mix_overrides=CROWDED if name == OPEN else None)
    assert res["failed"] == 0
    assert not res["correct"], res["checks"]
    # the fault is gone once its context is left
    assert run(reg, CLOSED, seconds=0.2)["correct"]


def test_a_scan_that_never_lands_is_not_correct(reg, monkeypatch):
    monkeypatch.setattr(cell, "GRACE_S", 0.0)

    class Lost:
        done = False
        error = None

        def wait(self, timeout=None):
            return False

    real = client.Client.submit

    def submit(self, scan):
        real(self, scan)
        if scan.pool == 1:
            scan.ticket = Lost()
    monkeypatch.setattr(client.Client, "submit", submit)
    res = run(reg, CLOSED)
    assert res["failed"] >= 1 and not res["correct"]
    assert res["checks"]["missing"]["value"] == res["failed"]
