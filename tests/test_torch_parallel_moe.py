"""Port parity for the sharded MoE: Qwen2-MoE's f32 smoke config on 4 gloo
ranks of a (data 2, model 2) CPU mesh against the reference on 4 virtual
CPU devices, as test_torch_parallel_lm.py holds the dense and SSM
configs (its `mesh_runs`: the same outputs, the same MODEL_TOL 2e-5).

Under the rules the MoE runs the grouped dispatch, G = tp = 2 groups of
8 tokens each with its own capacity: at the smoke capacity factor (8:
nothing drops) and at 0.25, where the capacity drops choices; equal
logits, caches, loss, gradients and train step there mean equal drops, and the
ranks count the drops to show the case has them.
"""
import json

import pytest

from test_torch_parallel_lm import (
    LOGITS, WRONG, check_caches, check_grads, check_logits, check_loss,
    check_rows, check_train_step, mesh_runs, wrong_step)

ARCHS = ["qwen2_moe_a2_7b", "qwen2_moe_a2_7b@0.25"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("moe_mesh"), ARCHS,
                     [[arch] for arch in ARCHS])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", LOGITS)
def test_logits_match_the_reference(runs, arch, what):
    check_logits(runs, arch, what)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_the_reference(runs, arch):
    check_caches(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference(runs, arch):
    check_loss(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_the_reference(runs, arch):
    check_grads(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(runs, arch):
    check_train_step(runs, arch)


def test_each_rank_is_fed_only_its_dp_rows(runs):
    check_rows(runs, ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("wrong", WRONG)
def test_checks_reject_a_wrong_step(runs, arch, wrong):
    with pytest.raises(AssertionError):
        wrong_step(runs, arch, wrong)()


def test_capacity_drops_only_at_the_low_factor(runs):
    """The (token, choice) pairs the capacity dropped in the sharded
    prefill, summed over the ranks' token groups."""
    report = json.loads((runs / "lm_0.json").read_text())
    assert report["qwen2_moe_a2_7b"]["dropped"] == 0
    assert report["qwen2_moe_a2_7b@0.25"]["dropped"] > 0
