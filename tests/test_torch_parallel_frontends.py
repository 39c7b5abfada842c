"""Port parity for the modality frontends on a mesh: MusicGen's and
InternVL2's f32 smoke configs on 4 gloo ranks of a (data 2, model 2) CPU
mesh against the reference on 4 virtual CPU devices, as
test_torch_parallel_lm.py holds the dense and SSM configs (its
`mesh_runs`: the same outputs, the same MODEL_TOL 2e-5).

Each rank is fed only its dp rows: MusicGen's (B, K, S) codes and
InternVL2's patch_embeds (B, S_img, d_frontend) with its text, which
`embed_inputs` looks up (audio: K codebooks summed) and projects on the
rank's rows, the image positions first. Decode is held against the
reference's full prefill of the prompt and the ids decoded so far, never
its decode, which for a vision prompt takes s0 from the text and writes
over image positions (ROADMAP.md Queue 3).
"""
import pytest

from test_torch_parallel_lm import (
    LOGITS, WRONG, check_caches, check_grads, check_logits, check_loss,
    check_greedy, check_rows, check_train_step, mesh_runs, wrong_step)

ARCHS = ["musicgen_large", "internvl2_26b"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("frontends_mesh"), ARCHS,
                     [[arch] for arch in ARCHS])


def test_each_rank_is_fed_only_its_dp_rows(runs):
    check_rows(runs, ARCHS)


def test_greedy_ids_on_dp_rows_equal_the_unsharded(runs):
    check_greedy(runs, ARCHS)


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
