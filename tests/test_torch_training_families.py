"""Port parity for the training path of the MoE, SSM and hybrid families:
`repro_torch`'s loss_fn (ce and the MoE router loss aux) for the
qwen2_moe_a2_7b, mamba2_130m and jamba_1_5_large smoke configs, and one
micro-batched train step for the MoE and the SSM ones, against `repro`'s
on the CPU.

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
from test_torch_training import (CPU, LOSS_REL, STEP_REL, TOTAL, WARMUP,
                                 _batch, _flat, _ref_state, _ref_state_jax,
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
