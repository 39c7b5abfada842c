"""Port parity for the modality frontends: MusicGen-Large's audio codebooks
and InternVL2-26B's vision projector (`embed_inputs`, `_logits`,
`loss_fn` and its gradients, `prefill`, decode, `params_from_reference`),
against `repro` on the CPU.

Both packages get the reference's weights (block weights rescaled to
1 / sqrt(fan_in), see tests/test_torch_window.py) and the same numpy
tokens and patch embeddings; the reference runs under jax.jit. In f32
they differ by summation order only: activations and logits within 2e-5
of the largest |value| (`MODEL_TOL`), gradients within 1e-4 of each
leaf's max (`GRAD_REL`, tests/test_torch_training.py's bound).

Decode is held against the reference's full prefill of the same
sequence, never its `greedy_generate`, which for a vision prompt decodes
from s0 = the text length, so it writes its first steps over image
positions (ROADMAP.md Queue 3);
`test_reference_vision_decode_overwrites_image_positions` records that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as tengine
from test_torch_models import _flat_defs, as_np, cfgs, close
from test_torch_training import (GRAD_ABS, GRAD_REL, LOSS_REL, _flat,
                                 _port_value_and_grad, _ref_value_and_grad)
from test_torch_window import (MODEL_TOL, _params, _recorded_decode,
                               fan_in_params, ref_decode_step, ref_prefill)

torch.set_num_threads(1)

FRONTENDS = ["musicgen_large", "internvl2_26b"]
B, S = 2, 10


def _batch(cfg, s=S, seed=0, labels=True):
    """tokens (B, S), or (B, K, S) codes for audio; a vision batch's
    patch_embeds (B, n_img, d_frontend); labels shaped as the tokens."""
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    shape = (B, fe.num_positions, s) if fe.modality == "audio" else (B, s)
    batch = {k: rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
             for k in (("tokens", "labels") if labels else ("tokens",))}
    if fe.modality == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (B, fe.num_positions, fe.d_frontend), dtype=np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.mark.parametrize("arch", FRONTENDS)
def test_embed_inputs_match_the_reference(arch):
    """Audio: the K codebook embeddings summed; vision: the projector's
    image tokens first, then the text."""
    jc, jp, tc, tp = _params(arch)
    batch = _batch(jc)
    want = jax.jit(JT.embed_inputs, static_argnums=(1, 3))(
        jp, jc, _jax(batch), None)
    got = TT.embed_inputs(tp, tc, _torch(batch))
    n_img = jc.frontend.num_positions if arch == "internvl2_26b" else 0
    assert tuple(got.shape) == (B, n_img + S, jc.d_model)
    close(as_np(got), want, MODEL_TOL)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_logits_match_the_reference(arch):
    """Audio's K heads give (B, S, K, V)."""
    jc, jp, tc, tp = _params(arch)
    x = np.random.default_rng(1).standard_normal((B, S, jc.d_model),
                                                 dtype=np.float32)
    want = JT._logits(jp, jc, jnp.asarray(x))
    got = TT._logits(tp, tc, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    close(as_np(got), want, MODEL_TOL)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_loss_and_grads_match_the_reference(arch):
    """Vision leaves its n_img positions out of the loss; audio's labels
    are one per codebook. The projector's and the 3-D embed and head's
    gradients included."""
    jc, jp, tc, tp = _params(arch)
    batch = _batch(jc, seed=2)
    want_loss, want_g = _ref_value_and_grad(jc, True)(jp, _jax(batch))
    loss, aux, grads = _port_value_and_grad(tc, tp, _torch(batch), True)
    assert torch.equal(aux["ce"], loss) and float(aux["aux"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_REL)
    want = _flat(jax.tree.map(np.asarray, want_g))
    assert set(grads) == set(want)
    for path, g in grads.items():
        err = np.abs(as_np(g) - want[path]).max()
        bound = GRAD_REL * np.abs(want[path]).max() + GRAD_ABS
        assert err <= bound, (path, err, bound)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_prefill_matches_the_reference(arch):
    jc, jp, tc, tp = _params(arch)
    batch = _batch(jc, seed=3, labels=False)
    jl, jcache = ref_prefill(jp, jc, _jax(batch))
    tl, tcache = TT.prefill(tp, tc, _torch(batch))
    assert tuple(tl.shape) == jl.shape
    close(as_np(tl), jl, MODEL_TOL)
    for field in ("attn_k", "attn_v"):
        want = getattr(jcache, field)["sub_0"]
        got = getattr(tcache, field)["sub_0"]
        assert tuple(got.shape) == want.shape
        close(as_np(got), want, MODEL_TOL)


def _longer(batch, ids, t):
    """The prompt and the first t + 1 generated ids (codes for audio)."""
    out = dict(batch)
    out["tokens"] = np.concatenate([batch["tokens"], ids[..., :t + 1]],
                                   axis=-1).astype(np.int32)
    return out


# Vision decodes from n_img + s0 = 8 + 10 = 18 up to s_max = 24.
@pytest.mark.parametrize("arch", FRONTENDS)
def test_decode_matches_a_full_prefill(arch, monkeypatch):
    jc, jp, tc, tp = _params(arch)
    batch = _batch(tc, seed=4, labels=False)
    n_pos = S + (tc.frontend.num_positions
                 if tc.frontend.modality == "vision" else 0)
    steps = 6
    logits = _recorded_decode(TT, monkeypatch)
    ids = tengine.greedy_generate(tc, tp, _torch(batch), steps=steps,
                                  s_max=n_pos + steps).numpy()
    audio = tc.frontend.modality == "audio"
    assert ids.shape == ((B, tc.frontend.num_positions, steps + 1) if audio
                         else (B, steps + 1))
    assert len(logits) == steps
    for t, got in enumerate(logits):
        want, _ = ref_prefill(jp, jc, _jax(_longer(batch, ids, t)))
        close(got, np.asarray(want), MODEL_TOL)
        np.testing.assert_array_equal(got.argmax(-1), ids[..., t + 1])


def test_reference_vision_decode_overwrites_image_positions(monkeypatch):
    """The reference's greedy_generate after 8 image and 10 text tokens
    decodes at position 10 + t, into a slot that holds an image token (its
    cache keeps the prefill's 18 slots). Its decode logits sit far from a
    full prefill of the same sequence (measured 0.60-1.04 of the max over
    the 4 steps); the port's, above, within 7e-7 of the reference's
    prefill. If the reference is ever fixed, this fails: then let the
    port's test hold it as an oracle."""
    monkeypatch.setattr(JT, "prefill", ref_prefill)
    jc, jp, _, _ = _params("internvl2_26b")
    batch = _batch(jc, seed=4, labels=False)
    logits = _recorded_decode(JT, monkeypatch, ref_decode_step)
    ids = np.asarray(jengine.greedy_generate(jc, jp, _jax(batch), steps=4,
                                             s_max=24))
    gaps = []
    for t, got in enumerate(logits):
        want, _ = ref_prefill(jp, jc, _jax(_longer(batch, ids, t)))
        want = np.asarray(want)
        gaps.append(float(np.abs(got - want).max())
                    / max(1.0, float(np.abs(want).max())))
    assert min(gaps) > 0.05, gaps


@pytest.mark.parametrize("arch", FRONTENDS)
def test_params_from_reference_carries_frontend_trees(arch):
    """The 3-D embed and head (audio) and the projector (vision) carry
    across: every leaf equal, under the same keys as model_defs."""
    _, tc = cfgs(arch)
    tree = fan_in_params(arch)
    got = TT.params_from_reference(tree, tc, device="cpu")
    want = _flat(tree)
    have = _flat(got)
    assert set(have) == set(want) == set(_flat_defs(TT.model_defs(tc)))
    for path, leaf in have.items():
        np.testing.assert_array_equal(as_np(leaf), want[path])
    key = "embed" if arch == "musicgen_large" else "projector"
    assert key in got and (arch != "musicgen_large"
                           or got["embed"].dim() == 3)
