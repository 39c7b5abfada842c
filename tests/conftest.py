import os
import tempfile

import jax
import pytest

# NOTE: no XLA_FLAGS here — smoke tests must see the real (1-device) CPU.
# Distributed tests spawn subprocesses that set
# --xla_force_host_platform_device_count themselves.

# Hermetic autotuner persistence: keep the file-backed tuning cache out of
# ~/.cache during test runs (subprocess tests inherit this env, so
# cross-process persistence still works within one session).
os.environ.setdefault(
    "REPRO_TUNE_CACHE",
    os.path.join(tempfile.mkdtemp(prefix="repro-tune-"),
                 "bp_tune_cache.json"),
)
# Same hermeticity for the planner's measured-refinement cache.
os.environ.setdefault(
    "REPRO_PLAN_CACHE",
    os.path.join(tempfile.mkdtemp(prefix="repro-plan-"),
                 "plan_measure_cache.json"),
)
# The calibration store stays OFF by default in tests: traced runs and
# measured refinements would otherwise accumulate host-specific timings
# into ~/.cache and make auto_plan's "auto" calibration nondeterministic
# across the suite. Tests that want a store install one explicitly
# (planner.calibrate.set_default_store / CalibrationStore(path=...)).
os.environ.setdefault("REPRO_CALIB_CACHE", "off")

jax.config.update("jax_enable_x64", False)

# The fast tier is compile-bound (hundreds of small jitted engines), not
# compute-bound: XLA's persistent compilation cache cuts repeat runs on the
# same machine by roughly a third. Keyed by HLO, so it can never change
# results — only skip recompiles. REPRO_COMPILE_CACHE=off disables it;
# any other value overrides the cache directory.
_cc = os.environ.get("REPRO_COMPILE_CACHE", "")
if _cc.lower() not in ("off", "0"):
    jax.config.update(
        "jax_compilation_cache_dir",
        _cc or os.path.join(os.path.expanduser("~"), ".cache", "repro",
                            "xla_cache"))
    # Only persist compiles that cost real time — writing every trivial
    # executable to disk costs more on the cold run than it saves warm.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)


def pytest_configure(config):
    # Fast tier: `pytest -m "not slow"` (~80 s warm on this container, vs
    # ~7 min full — see DESIGN.md §Test tiers) skips the multi-minute
    # subprocess/distributed runs and the heavyweight LM smoke configs;
    # the full suite runs everything (nightly CI).
    config.addinivalue_line(
        "markers",
        "slow: multi-minute subprocess/distributed or heavyweight smoke "
        "tests; deselect with -m 'not slow' for the fast tier",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the PyTorch port's kernels); skips "
        "without one",
    )


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)
