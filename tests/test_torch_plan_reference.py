"""Port parity for the whole slice, impl="reference": reference x codec x
{fused, pipelined, chunked}, both packages built from the same plain
fields (`check_slice` in test_torch_plan.py)."""
import pytest

from test_torch_plan import CODECS, SCHEDULES, check_slice


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("codec", CODECS)
def test_reference_slice_matches_reference(codec, schedule):
    check_slice("reference", codec, schedule)
