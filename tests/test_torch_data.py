"""Port parity for `repro_torch.data`: the reference's tests/test_data.py
on the port, and `batch_specs` against `repro.data.batch_specs` (names,
shapes and dtypes) for the port's archs and for a vision and an audio
config built from the port's own FrontendConfig."""
import time

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import batch_specs as j_batch_specs
from repro.models import config as jconfig
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.data import (ProjectionSource, SyntheticTokens, TensorSpec,
                              batch_specs, synthetic_batch)
from repro_torch.data.pipeline import step_seed
from repro_torch.models.config import FrontendConfig

torch.set_num_threads(1)

CPU = "cpu"
FRONTENDS = {
    "vision": FrontendConfig(modality="vision", d_frontend=48,
                             num_positions=6),
    "audio": FrontendConfig(modality="audio", num_positions=4),
}


def _pair(arch, frontend=None):
    """The port's smoke config and the reference's, equally given
    `frontend` (by name)."""
    tc = get_smoke_config(arch)
    jc = jconfigs.get_smoke_config(arch)
    if frontend is not None:
        f = FRONTENDS[frontend]
        tc = tc.scaled(frontend=f)
        jc = jc.scaled(frontend=jconfig.FrontendConfig(
            modality=f.modality, d_frontend=f.d_frontend,
            num_positions=f.num_positions))
    return jc, tc


@pytest.mark.parametrize("frontend", [None, "vision", "audio"])
@pytest.mark.parametrize("arch", list_archs())
def test_batch_specs_match_the_reference(arch, frontend):
    jc, tc = _pair(arch, frontend)
    want = j_batch_specs(jc, 3, 16)
    got = batch_specs(tc, 3, 16)
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        assert isinstance(spec, TensorSpec)
        assert spec.shape == tuple(want[name].shape), name
        assert str(spec.dtype).removeprefix("torch.") == str(
            want[name].dtype), name


@pytest.mark.parametrize("frontend", [None, "vision", "audio"])
@pytest.mark.parametrize("arch", list_archs())
def test_synthetic_matches_specs(arch, frontend):
    _, cfg = _pair(arch, frontend)
    specs = batch_specs(cfg, 2, 16)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(0)
    batch = synthetic_batch(cfg, 2, 16, gen)
    assert set(batch) == set(specs)
    for k, spec in specs.items():
        assert tuple(batch[k].shape) == spec.shape, (arch, k)
        assert batch[k].dtype == spec.dtype, (arch, k)
        assert batch[k].device.type == CPU
        if spec.dtype == torch.int32:
            assert 0 <= int(batch[k].min()) and \
                int(batch[k].max()) < cfg.vocab_size


def test_stream_restartable_determinism():
    """batch(step) is a pure function of (seed, step): a resumed job sees
    the identical stream."""
    cfg = get_smoke_config("qwen2_1_5b")
    s1 = SyntheticTokens(cfg, 2, 8, seed=3, device=CPU)
    s2 = SyntheticTokens(cfg, 2, 8, seed=3, device=CPU)
    a, b = s1(5), s2(5)
    for k in a:
        assert torch.equal(a[k], b[k])
    c = s1(6)
    assert not torch.equal(a["tokens"], c["tokens"])
    other = SyntheticTokens(cfg, 2, 8, seed=4, device=CPU)(5)
    assert not torch.equal(a["tokens"], other["tokens"])
    # A stream resumed at step 5 does not depend on the steps drawn before.
    s3 = SyntheticTokens(cfg, 2, 8, seed=3, device=CPU)
    assert torch.equal(s3(5)["labels"], a["labels"])


def test_step_seed_mixes_seed_and_step():
    seeds = {step_seed(seed, step) for seed in range(4) for step in range(64)}
    assert len(seeds) == 4 * 64
    assert all(0 <= s < 2 ** 64 for s in seeds)


def test_stream_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is satisfiable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SyntheticTokens(get_smoke_config("qwen2_1_5b"), 2, 8)


def test_projection_source_slicing():
    proj = np.arange(4 * 2 * 3, dtype=np.float32).reshape(4, 2, 3)
    src = ProjectionSource(proj, micro_batch=2)
    assert src.n_batches == 2
    np.testing.assert_array_equal(src.batch(1), proj[2:4])
    batches = list(src)
    np.testing.assert_array_equal(np.concatenate(batches), proj)


def test_projection_source_latency_hook():
    src = ProjectionSource(np.zeros((4, 2, 2), np.float32), micro_batch=2,
                           latency_s=0.01)
    t0 = time.perf_counter()
    assert len(list(src)) == 2
    assert time.perf_counter() - t0 >= 0.02


def test_projection_source_rejects_ragged():
    with pytest.raises(ValueError):
        ProjectionSource(np.zeros((5, 2, 2), np.float32), micro_batch=2)
