"""Port parity for the whole slice, impl="kernel": kernel x codec x
{fused, pipelined, chunked}, both packages built from the same plain
fields (`check_slice` in test_torch_plan.py). On the CPU the port's
wrapper runs the hand kernel's plain version; the reference runs its
Pallas kernel in interpret mode."""
import pytest

from test_torch_plan import CODECS, SCHEDULES, check_slice


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("codec", CODECS)
def test_kernel_slice_matches_reference(codec, schedule):
    check_slice("kernel", codec, schedule)
