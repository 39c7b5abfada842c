"""Port parity for replicated KV heads: Qwen2-1.5B's f32 smoke config (4
query heads over 2 KV heads) on 4 gloo ranks of a (data 1, model 4) CPU
mesh against the reference on a (data 1, model 4) mesh of 4 virtual CPU
devices, as test_torch_parallel_lm.py holds the (data 2, model 2) runs
(its `mesh_runs`: the same outputs, the same tolerances).

The 2 KV heads do not divide the model axis of 4, so `spec_for_shape`
replicates K and V: each rank holds 1 query head and narrows the
replicated K and V to that head's KV group (`layers._local_kv`), whose
gradient is a partial sum over the model axis. Prefill, the caches,
decode, loss_fn, its gradients and a train step take that branch.
"""
import pytest

from test_torch_parallel_lm import (
    LOGITS, WRONG, check_caches, check_grads, check_logits, check_loss,
    check_train_step, mesh_runs, wrong_step)

ARCHS = ["qwen2_1_5b"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("kv_mesh"), ARCHS, [ARCHS],
                     mesh=(1, 4))


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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("wrong", WRONG)
def test_checks_reject_a_wrong_step(runs, arch, wrong):
    with pytest.raises(AssertionError):
        wrong_step(runs, arch, wrong)()
