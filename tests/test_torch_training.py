"""Port parity for the training path: `repro_torch.models.transformer.
loss_fn`, the trainable flash attention, `repro_torch.training` and the
train state's checkpoints, against `repro`'s on the CPU.

Both packages start from one state: the reference draws it with
jax.random and the port takes it with `train_state_from_reference`; the
batches come from numpy. The reference's functions run under jax.jit. On
the CPU the port's attention step is the reference's own code, so in f32
the packages differ by summation order only.

The state is the reference's `init_train_state` with each stacked block
weight rescaled to the std its unstacked def would draw,
1 / sqrt(fan_in). The stacked defs keep no fan_in (ROADMAP.md Queue 3), so
at the smoke config the reference's own init draws them with std
1 / sqrt(2): scores in the hundreds and a one-hot softmax, whose
gradients turn f32 summation order into 2-9e-4 of each leaf's max (the
reference's f32 gradients sit 1-4e-4 from its own x64 run there). With
the rescaled weights the packages' gradients agree within ~1.5e-6.
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.training import train_step as JTS
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.checkpoint.io import _flatten
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.attention import (attention_ref,
                                           flash_attention_trainable)
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamWConfig
from repro_torch.training import (TrainState, init_train_state,
                                  make_train_step, train_state_from_reference)

torch.set_num_threads(1)

CPU = "cpu"
ARCH = "qwen2_1_5b"
B, S = 4, 16
LOSS_REL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-7
STEP_REL = 1e-5
WARMUP, TOTAL = 2, 16


def cfgs(dtype="float32", arch=ARCH):
    return (jconfigs.get_smoke_config(arch).scaled(dtype=dtype),
            tconfigs.get_smoke_config(arch).scaled(dtype=dtype))


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts (either package's)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def as_np(t):
    return t.detach().to(torch.float32).numpy()


def _batch(vocab, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, S)).astype(np.int32)
            for k in ("labels", "tokens")}


def _to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref_state():
    """The reference's initial TrainState for the smoke config, as numpy,
    block weights at std 1 / sqrt(fan_in) (see the module's docstring)."""
    return _ref_state(ARCH)


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    jc, _ = cfgs(arch=arch)
    state = jax.tree.map(np.asarray, jax.jit(
        JTS.init_train_state, static_argnums=0)(jc, jax.random.PRNGKey(0)))
    for i, sub in enumerate(jc.pattern):
        block = state.params["blocks"][f"sub_{i}"]
        for path, d in _flat(JT._sublayer_defs(jc, sub)).items():
            *keys, name = path
            leaf = functools.reduce(dict.__getitem__, keys, block)
            fan_in = d.fan_in or d.shape[0]
            leaf[name] = (leaf[name] * np.sqrt(jc.repeats / fan_in)
                          ).astype(np.float32)
    return state


def _ref_state_jax(np_state):
    return jax.tree.map(jnp.asarray, np_state)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(jc, remat):
    return jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jc, b, None, remat)[0]))


def _port_value_and_grad(tc, params, batch, remat):
    leaves = {k: v.detach().requires_grad_() for k, v in _flat(params).items()}

    def tree(flat):
        out = {}
        for path, v in flat.items():
            d = out
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = v
        return out
    loss, aux = TT.loss_fn(tree(leaves), tc, batch, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, aux, dict(zip(leaves, grads))


# -- loss_fn -----------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_the_reference_f32(ref_state, remat):
    jc, tc = cfgs()
    batch = _batch(jc.vocab_size)
    want_loss, want_g = _ref_value_and_grad(jc, remat)(
        _ref_state_jax(ref_state).params, _to_jax(batch))
    params = TT.params_from_reference(ref_state.params, tc, device=CPU)
    loss, aux, grads = _port_value_and_grad(tc, params, _to_torch(batch),
                                            remat)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert float(aux["aux"]) == 0.0 and aux["aux"].dtype == torch.float32
    assert torch.equal(aux["ce"], loss)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_REL)
    want = _flat(jax.tree.map(np.asarray, want_g))
    assert set(grads) == set(want)
    for path, g in grads.items():
        err = np.abs(as_np(g) - want[path]).max()
        bound = GRAD_REL * np.abs(want[path]).max() + GRAD_ABS
        assert err <= bound, (path, err, bound)


def test_bf16_loss_within_the_reference_bf16_distance(ref_state):
    """XLA and torch round to bf16 at different points (fused casts, sum
    orders), so the port's bf16 loss is held to its distance from the
    reference's f32 loss: at most twice the reference bf16 loss's own
    distance from it."""
    jc32, _ = cfgs()
    jc, tc = cfgs("bfloat16")
    batch = _batch(jc.vocab_size, seed=1)
    p = _ref_state_jax(ref_state).params
    f32 = float(jax.jit(lambda p, b: JT.loss_fn(p, jc32, b)[0])(
        p, _to_jax(batch)))
    bf16 = float(jax.jit(lambda p, b: JT.loss_fn(p, jc, b)[0])(
        p, _to_jax(batch)))
    params = TT.params_from_reference(ref_state.params, tc, device=CPU)
    got, _ = TT.loss_fn(params, tc, _to_torch(batch))
    assert got.dtype == torch.float32
    assert abs(float(got) - f32) <= 2 * abs(bf16 - f32) + 1e-6, (
        float(got), bf16, f32)


def test_remat_changes_nothing(ref_state):
    """The rematerialised backward recomputes the same block: bit-equal."""
    _, tc = cfgs()
    batch = _to_torch(_batch(tc.vocab_size, seed=2))
    params = TT.params_from_reference(ref_state.params, tc, device=CPU)
    a = _port_value_and_grad(tc, params, batch, remat=True)
    b = _port_value_and_grad(tc, params, batch, remat=False)
    assert torch.equal(a[0], b[0])
    for path in a[2]:
        assert torch.equal(a[2][path], b[2][path]), path


def test_gradients_land_in_the_stacked_leaves(ref_state):
    """Each repeat's block gradient lands in its slice of the stacked
    (repeats, ...) leaf: a loss that reads one repeat's weights only moves
    that slice."""
    _, tc = cfgs()
    params = TT.params_from_reference(ref_state.params, tc, device=CPU)
    w = params["blocks"]["sub_0"]["mlp"]["w_up"].requires_grad_()
    views = TT._unstack(params["blocks"])
    (g,) = torch.autograd.grad(views[1]["sub_0"]["mlp"]["w_up"].sum(), [w])
    assert torch.equal(g[0], torch.zeros_like(g[0]))
    assert torch.equal(g[1], torch.ones_like(g[1]))


# -- the trainable flash attention on the CPU --------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trainable_attention_gradients_are_the_plain_steps(dtype):
    """On the CPU the Function's forward is the kernel's blocked plain
    version; its dq, dk, dv are bit-equal to autograd through the layer's
    plain step with the same dO."""
    _, tc = cfgs()
    h, kh, hd = tc.num_heads, tc.num_kv_heads, tc.resolved_head_dim
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dtype)
    q, k, v, d_out = t(2, 40, h, hd), t(2, 40, kh, hd), t(2, 40, kh, hd), \
        t(2, 40, h, hd)
    pos = torch.arange(40, dtype=torch.int32).expand(2, 40)

    def plain(q, k, v):
        return TL.prefill_attention_plain(tc, q, k, v, pos)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention_trainable(*leaves, causal=True, plain=plain)
    got = torch.autograd.grad(out, leaves, d_out)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref_out = plain(*ref_leaves)
    want = torch.autograd.grad(ref_out, ref_leaves, d_out)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
    tol = 2e-5 if dtype == torch.float32 else 0.02
    assert float((out.detach().float() - ref_out.detach().float())
                 .abs().max()) < tol


def test_trainable_attention_defaults_to_the_dense_oracle():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 12, n, 8),
                                                    dtype=np.float32))
               .requires_grad_() for n in (4, 2, 2))
    out = flash_attention_trainable(q, k, v)
    got = torch.autograd.grad(out.sum(), (q, k, v))
    want = torch.autograd.grad(attention_ref(q, k, v).sum(), (q, k, v))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_loss_through_the_trainable_attention_on_the_cpu(ref_state,
                                                         monkeypatch):
    """The card's route (the Function, forward by the kernel's plain
    version) pointed at explicitly: loss and gradients within the f32
    parity bounds of the plain step's."""
    _, tc = cfgs()
    batch = _to_torch(_batch(tc.vocab_size, seed=5))
    params = TT.params_from_reference(ref_state.params, tc, device=CPU)
    want = _port_value_and_grad(tc, params, batch, remat=True)

    def step(cfg, q, k, v, positions, check_positions=True):
        return flash_attention_trainable(
            q, k, v, plain=lambda q, k, v: TL.prefill_attention_plain(
                cfg, q, k, v, positions))
    monkeypatch.setattr(TL, "prefill_attention", step)
    got = _port_value_and_grad(tc, params, batch, remat=True)
    np.testing.assert_allclose(float(got[0].detach()), float(want[0].detach()),
                               rtol=LOSS_REL)
    for path, g in got[2].items():
        w = as_np(want[2][path])
        err = np.abs(as_np(g) - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + GRAD_ABS, path


# -- the train step ----------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference(ref_state, microbatches):
    """Three steps, each from the reference's state before it. Params move
    by at most 2 lr lr_scale an element apart: on the first steps
    m_hat / sqrt(v_hat) is close to sign(g), so a near-zero gradient whose
    sign the summation order flips moves an element by up to 2 lr."""
    jc, tc = cfgs()
    opt = AdamWConfig()
    jstep = jax.jit(JTS.make_train_step(jc, microbatches=microbatches,
                                        warmup=WARMUP, total_steps=TOTAL))
    tstep = make_train_step(tc, opt, microbatches=microbatches,
                            warmup=WARMUP, total_steps=TOTAL)
    np_state = ref_state
    for i in range(3):
        batch = _batch(jc.vocab_size, seed=10 + i)
        state = train_state_from_reference(np_state, tc, device=CPU)
        new, metrics = tstep(state, _to_torch(batch))
        jnew, jmetrics = jstep(_ref_state_jax(np_state), _to_jax(batch))
        np_state = jax.tree.map(np.asarray, jnew)
        for key in ("loss", "grad_norm", "lr_scale"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(jmetrics[key]), rtol=STEP_REL,
                                       err_msg=key)
        assert new.params is state.params          # updated in place
        assert int(new.opt.step) == int(np_state.opt.step) == i + 1
        assert new.opt.step.dtype == torch.int32
        move = 2 * opt.lr * float(jmetrics["lr_scale"])
        for path, p in _flat(new.params).items():
            err = np.abs(as_np(p) - _flat(np_state.params)[path]).max()
            assert err <= move, (path, err, move)
        for name in ("mu", "nu"):
            want = _flat(getattr(np_state.opt, name))
            for path, m in _flat(getattr(new.opt, name)).items():
                assert m.dtype == torch.float32
                err = np.abs(as_np(m) - want[path]).max()
                assert err <= 2 * GRAD_REL * np.abs(want[path]).max() + \
                    GRAD_ABS, (name, path, err)


def test_train_step_leaves_nothing_for_the_collector(ref_state):
    """With the garbage collector off, a step frees everything it made but
    the state: no reference cycle holds its gradients. (One did, through
    a self-calling closure in `_like`: on the card two f32 copies of
    Qwen2-1.5B's weights, 11.6 GiB, stayed allocated after training.)"""
    _, tc = cfgs()
    state = train_state_from_reference(ref_state, tc, device=CPU)
    step = make_train_step(tc, microbatches=2, warmup=WARMUP,
                           total_steps=TOTAL)
    batch = _to_torch(_batch(tc.vocab_size, seed=8))
    state, _ = step(state, batch)

    def live():
        return sum(o.numel() for o in gc.get_objects()
                   if type(o) is torch.Tensor)
    gc.collect()
    gc.disable()
    try:
        before = live()
        state, _ = step(state, batch)
        assert live() == before
    finally:
        gc.enable()


def test_train_state_from_reference_checks_and_converts(ref_state):
    _, tc = cfgs()
    state = train_state_from_reference(ref_state, tc, device=CPU)
    assert isinstance(state, TrainState)
    assert state.opt.step.shape == () and state.opt.step.dtype == torch.int32
    for p in _flat(state.params).values():
        assert p.requires_grad and p.dtype == torch.float32
    bad = ref_state._replace(opt=ref_state.opt._replace(
        mu=jax.tree.map(lambda a: a.astype(np.float16), ref_state.opt.mu)))
    with pytest.raises(ValueError, match="f32"):
        train_state_from_reference(bad, tc, device=CPU)


def test_init_train_state():
    _, tc = cfgs()
    state = init_train_state(tc, seed=0, device=CPU)
    assert int(state.opt.step) == 0
    for path, p in _flat(state.params).items():
        assert p.requires_grad and p.dtype == torch.float32
        m = _flat(state.opt.mu)[path]
        assert m.shape == p.shape and m.dtype == torch.float32
        assert not m.any() and m is not _flat(state.opt.nu)[path]


# -- checkpoints of the train state ------------------------------------------

def _assert_bit_equal(port_state, np_tree):
    got = _flatten(port_state)[0]
    want = jax.tree_util.tree_flatten_with_path(np_tree)[0]
    assert [k for k, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (key, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.from_numpy(w.copy()).dtype, key
        np.testing.assert_array_equal(g.detach().numpy(), w, err_msg=key)


def test_port_train_state_checkpoint_loads_in_the_reference(ref_state,
                                                            tmp_path):
    jc, tc = cfgs()
    state = train_state_from_reference(ref_state, tc, device=CPU)
    state, _ = make_train_step(tc, warmup=WARMUP, total_steps=TOTAL)(
        state, _to_torch(_batch(tc.vocab_size)))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, state)
    mgr.wait()
    like = _ref_state_jax(ref_state)
    got = jax.tree.map(np.asarray,
                       jckpt.load_checkpoint(str(tmp_path), 1, like))
    assert type(got).__name__ == "TrainState"
    _assert_bit_equal(state, got)
    assert got.opt.step.dtype == np.int32 and int(got.opt.step) == 1


def test_reference_train_state_checkpoint_loads_in_the_port(ref_state,
                                                            tmp_path):
    jc, tc = cfgs()
    jstate, _ = jax.jit(JTS.make_train_step(jc))(
        _ref_state_jax(ref_state), _to_jax(_batch(jc.vocab_size)))
    jckpt.save_checkpoint(str(tmp_path), 1, jstate)
    like = init_train_state(tc, seed=0, device=CPU)
    got = load_checkpoint(str(tmp_path), 1, like, device=CPU)
    assert isinstance(got, TrainState)
    _assert_bit_equal(got, jax.tree.map(np.asarray, jstate))


def test_resumed_run_continues_bit_equal(ref_state, tmp_path):
    """The examples/train_lm.py loop: save every 2 steps, restart from the
    latest checkpoint with the stream at the restored step."""
    _, tc = cfgs()
    step = make_train_step(tc, microbatches=2, warmup=WARMUP,
                           total_steps=TOTAL)
    data = SyntheticTokens(tc, B, S, seed=0, device=CPU)
    state = train_state_from_reference(ref_state, tc, device=CPU)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for i in range(4):
        state, _ = step(state, data(i))
        if (i + 1) % 2 == 0 and i < 3:
            mgr.save(i + 1, state)
    mgr.wait()

    restored_at, resumed = CheckpointManager(str(tmp_path)).restore_latest(
        init_train_state(tc, seed=1, device=CPU), device=CPU)
    assert restored_at == 2 and int(resumed.opt.step) == 2
    for i in range(restored_at, 4):
        resumed, _ = step(resumed, data(i))
    for (key, a), (_, b) in zip(_flatten(state)[0], _flatten(resumed)[0]):
        assert torch.equal(a, b), key
