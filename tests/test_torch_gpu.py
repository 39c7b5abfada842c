"""Card-only tests of the port: the hand-written CUDA kernel against its
plain torch version on the card, and the main path through it.

Marked `gpu`; each test skips unless a CUDA device is present (decided
inside the test, never at import). This file imports neither JAX nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core.filtering import make_filter
from repro_torch.core.geometry import CBCTGeometry, projection_matrices
from repro_torch.core.phantom import forward_project
from repro_torch.core.plan import ReconstructionPlan
from repro_torch.core.precision import CODECS
from repro_torch.kernels.backproject import kernel as bpk
from repro_torch.kernels.backproject.ops import kernel_operands

pytestmark = pytest.mark.gpu

REL = 1e-5  # see chip_smoke.py: identical wire bytes, pinned coordinates
# Non-square detector, odd projection count, a volume that is not a cube
# and a k extent that is not a multiple of the 32-wide warp.
G = CBCTGeometry(n_proj=7, n_u=40, n_v=28, d_u=4.8 / 40, d_v=4.8 / 40,
                 d=4.0, dsd=8.0, n_x=20, n_y=12, n_z=36,
                 d_x=0.1, d_y=2 / 12, d_z=2 / 36)
SHAPE = (G.n_x, G.n_y, G.n_z)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_kernel_matches_plain_version(cuda, codec):
    q = make_filter(G, device=cuda)(forward_project(G, device=cuda))
    data, scales = CODECS[codec].encode(q)
    params, qt = kernel_operands(projection_matrices(G), data, scales)
    before = bpk.launches
    got = bpk.backproject_dual(params, qt, *SHAPE)
    assert bpk.launches == before + 1
    want = bpk.backproject_dual_torch(params, qt, *SHAPE)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (G.n_x, G.n_y, 2, G.n_z // 2)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= REL


def test_main_path_runs_the_kernel_and_matches_the_cpu(cuda):
    proj = forward_project(G, device="cpu")
    before = bpk.launches
    vol = ReconstructionPlan(geometry=G, impl="kernel").build()(proj)
    torch.cuda.synchronize()
    assert bpk.launches == before + 1
    assert vol.device.type == "cuda"
    ref = ReconstructionPlan(geometry=G, impl="kernel",
                             device="cpu").build()(proj)
    # cuFFT and the CPU FFT differ at f32 round-off before the kernel
    rel = float((vol.cpu() - ref).abs().max() / ref.abs().max())
    assert rel <= REL


def test_wrapper_rejects_mixed_devices(cuda):
    params = torch.zeros((3, 13), device=cuda)
    qt = torch.zeros((3, 8, 6))
    with pytest.raises(ValueError, match="params13 on"):
        bpk.backproject_dual(params, qt, 4, 4, 4)
