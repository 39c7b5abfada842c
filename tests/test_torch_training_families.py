"""Port parity for the training path of the MoE, SSM and hybrid families:
`repro_torch`'s loss_fn (ce and the MoE router loss aux) for the
qwen2_moe_a2_7b, mamba2_130m and jamba_1_5_large smoke configs, and one
micro-batched train step for the MoE and the SSM ones, against `repro`'s
on the CPU; and loss_fn with its gradients for the deepseek_coder_33b,
internlm2_20b and mixtral_8x7b smoke configs (the frontends' are in
test_torch_frontends.py).

The state, batches, bounds and helpers are test_torch_training.py's: the
reference's init with block weights rescaled to 1 / sqrt(fan_in), batches
from numpy, the reference under jax.jit. A file of its own so that each
stays under ~15 s (the reference's init and train step compile per
config).
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.training import train_step as JTS
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamWConfig
from repro_torch.training import make_train_step, train_state_from_reference
from test_torch_training import (CPU, GRAD_ABS, GRAD_REL, LOSS_REL, STEP_REL,
                                 TOTAL, WARMUP, _batch, _flat,
                                 _port_value_and_grad, _ref_state,
                                 _ref_state_jax, _ref_value_and_grad,
                                 _to_jax, _to_torch, as_np, cfgs)

torch.set_num_threads(1)

FAMILIES = ["qwen2_moe_a2_7b", "mamba2_130m", "jamba_1_5_large"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_ce_and_aux_match_the_reference_every_family(arch):
    """loss_fn's (ce + aux, {ce, aux}) for the MoE, SSM and hybrid smoke
    configs: aux is the MoE layers' summed router loss (0 for Mamba-2)."""
    jc, tc = cfgs(arch=arch)
    state = _ref_state(arch)
    batch = _batch(jc.vocab_size, seed=6)
    want, want_aux = jax.jit(JT.loss_fn, static_argnums=1)(
        _ref_state_jax(state).params, jc, _to_jax(batch))
    params = TT.params_from_reference(state.params, tc, device=CPU)
    got, aux = TT.loss_fn(params, tc, _to_torch(batch), remat=False)
    for g, w in ((got, want), (aux["ce"], want_aux["ce"]),
                 (aux["aux"], want_aux["aux"])):
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_REL)
    assert (float(aux["aux"]) > 0) == (tc.moe is not None)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "mamba2_130m"])
def test_train_step_matches_the_reference_moe_and_ssm(arch):
    """One make_train_step step (2 micro-batches) from the same state,
    held as the dense three-step test holds its steps."""
    jc, tc = cfgs(arch=arch)
    opt = AdamWConfig()
    np_state = _ref_state(arch)
    batch = _batch(jc.vocab_size, seed=7)
    state = train_state_from_reference(np_state, tc, device=CPU)
    new, metrics = make_train_step(tc, opt, microbatches=2, warmup=WARMUP,
                                   total_steps=TOTAL)(state, _to_torch(batch))
    jnew, jmetrics = jax.jit(JTS.make_train_step(
        jc, microbatches=2, warmup=WARMUP, total_steps=TOTAL))(
        _ref_state_jax(np_state), _to_jax(batch))
    for key in ("loss", "grad_norm", "lr_scale"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=STEP_REL, err_msg=key)
    move = 2 * opt.lr * float(jmetrics["lr_scale"])
    want = _flat(jax.tree.map(np.asarray, jnew.params))
    for path, p in _flat(new.params).items():
        err = np.abs(as_np(p) - want[path]).max()
        assert err <= move, (path, err, move)
    assert int(new.opt.step) == 1


@pytest.mark.parametrize("arch", ["deepseek_coder_33b", "internlm2_20b",
                                  "mixtral_8x7b"])
def test_loss_and_grads_match_the_reference_remaining_configs(arch):
    """GQA groups 4 and 2, and Mixtral's window (32 of the 16 tokens: the
    mask is causal here; the window's own parity is in
    test_torch_window.py) with its top-2 MoE, whose router loss is in the
    loss."""
    jc, tc = cfgs(arch=arch)
    state = _ref_state(arch)
    batch = _batch(jc.vocab_size, seed=8)
    want_loss, want_g = _ref_value_and_grad(jc, True)(
        _ref_state_jax(state).params, _to_jax(batch))
    params = TT.params_from_reference(state.params, tc, device=CPU)
    loss, aux, grads = _port_value_and_grad(tc, params, _to_torch(batch),
                                            True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_REL)
    assert (float(aux["aux"].detach()) > 0) == (tc.moe is not None)
    want = _flat(jax.tree.map(np.asarray, want_g))
    assert set(grads) == set(want)
    for path, g in grads.items():
        err = np.abs(as_np(g) - want[path]).max()
        bound = GRAD_REL * np.abs(want[path]).max() + GRAD_ABS
        assert err <= bound, (path, err, bound)
