"""Port parity for the MoE layer: `repro_torch.models.moe` against
`repro.models.moe` on the CPU, on the same numpy inputs and the reference's
weights.

Two layers: Qwen2-MoE's smoke MoE (8 experts, top-4, 2 shared experts)
and Jamba's (4 experts, top-2, no shared experts), each at its smoke
capacity factor (8.0: nothing drops) and at 0.25, where capacity drops
most choices. Routing is compared first: the same top-k experts in the
same order, and the same (token, choice) pairs dropped. The grouped
dispatch (G = 2 groups of S/2 tokens, each with its own capacity: the
GShard one-hot einsum the reference runs on a mesh) is held against the
reference's in one process, both given a rules stand-in whose tp_size()
is 2 and whose constraints are identities (`GROUPS`). Where the picks
or their order differ, the test says whether two of the k + 1 largest
probabilities sit within 1e-6 of each other, so that a tie shows as a tie
and a fault as a fault (both fail: these inputs have no tie). Then `out` and `aux` in f32 within 1e-5 of the largest |value|
(`close`): the packages differ only by summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.models import moe as TM
from test_torch_models import as_np, cfgs, close

torch.set_num_threads(1)

ARCHS = ["qwen2_moe_a2_7b", "jamba_1_5_large"]
TOL = 1e-5
TIE = 1e-6
B, S = 2, 24


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _layer(arch, capacity_factor=None, dtype="float32", seed=0):
    jc, tc = cfgs(arch, dtype=dtype)
    if capacity_factor is not None:
        jc, tc = (c.scaled(moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jc, tc))
    defs = JM.moe_defs(jc)
    jp = jax.jit(lambda key: JL.init_tree(key, defs))(
        jax.random.PRNGKey(seed))
    return jc, jp, tc, _to_torch(jax.tree.map(np.asarray, jp))


class _Groups:
    """Sharding rules stand-in: two token groups, no mesh (identity
    constraints, no axes), accepted by both packages' `moe`."""

    def tp_size(self):
        return 2

    def axes(self, logical):
        return None

    def constrain(self, x, *logical):
        return x

    def constrain_p(self, x, spec):
        return x


GROUPS = _Groups()


def _x(d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d), dtype=np.float32)


@jax.jit
def _ref_probs(x, router):
    return jax.nn.softmax(x.astype(jnp.float32) @ router.astype(jnp.float32),
                          axis=-1)


def _ref_routing(jc, jp, x):
    """The reference's probabilities, top-k experts and kept choices (its
    lines for the single-group path, evaluated with numpy on its top-k)."""
    probs = _ref_probs(jnp.asarray(x), jp["router"])
    _, idx = jax.lax.top_k(probs, jc.moe.top_k)
    probs, idx = np.asarray(probs), np.asarray(idx)
    flat = idx.reshape(B, -1)
    onehot = np.eye(jc.moe.num_experts, dtype=np.int64)[flat]
    pos_in_e = np.sum(np.cumsum(onehot, axis=1) * onehot, axis=-1) - 1
    return probs, idx, pos_in_e < JM.capacity(jc, S)


def _check_routing(jc, jp, tc, tp, x):
    """Returns the reference's keep mask after holding the port's routing
    to it."""
    probs, want_idx, want_keep = _ref_routing(jc, jp, x)
    r = TM.route(tp, tc, torch.from_numpy(x))
    got_idx = r.gate_idx.numpy()
    k = jc.moe.top_k
    for bi, si in zip(*np.nonzero((got_idx != want_idx).any(-1))):
        # The picks or their order differ: a tie if two of the k + 1
        # largest probabilities sit within TIE of each other.
        ranked = np.sort(probs[bi, si])[::-1][:k + 1]
        gap = float(np.min(ranked[:-1] - ranked[1:]))
        where = (f"token ({bi}, {si}): port {got_idx[bi, si]}, reference "
                 f"{want_idx[bi, si]}, smallest gap {gap:.3e}")
        if gap < TIE:
            pytest.fail(f"a tie in the router's probabilities, not a fault "
                        f"of the port; choose other inputs: {where}")
        raise AssertionError(f"routing differs without a tie: {where}")
    close(r.probs.numpy(), probs, TOL)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    return want_keep


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 0.25])
def test_moe_matches_the_reference(arch, capacity_factor):
    jc, jp, tc, tp = _layer(arch, capacity_factor)
    x = _x(jc.d_model)
    keep = _check_routing(jc, jp, tc, tp, x)
    if capacity_factor is None:
        assert keep.all()
    else:
        assert 0 < keep.sum() < keep.size
    want_out, want_aux = jax.jit(JM.moe, static_argnums=1)(
        jp, jc, jnp.asarray(x))
    out, aux = TM.moe(tp, tc, torch.from_numpy(x))
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    assert aux.shape == ()
    close(as_np(out), want_out, TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_choices_add_nothing(arch):
    """At capacity factor 0.25 the output is the sum over the kept choices
    only (plus the shared experts): each kept choice, recomputed token by
    token as its expert's swiglu, weighted by its renormalised gate."""
    jc, jp, tc, tp = _layer(arch, 0.25)
    x = torch.from_numpy(_x(jc.d_model, seed=2))
    r = TM.route(tp, tc, x)
    out, _ = TM.moe(tp, tc, x)
    k = tc.moe.top_k
    keep = r.keep.reshape(B, S, k)
    want = torch.zeros_like(x)
    for bi in range(B):
        for si in range(S):
            for j in range(k):
                if not keep[bi, si, j]:
                    continue
                e = int(r.gate_idx[bi, si, j])
                v = x[bi, si]
                h = torch.nn.functional.silu(v @ tp["w_gate"][e]) \
                    * (v @ tp["w_up"][e])
                want[bi, si] += r.gate_vals[bi, si, j] * (h @ tp["w_down"][e])
    if "shared" in tp:
        sh = tp["shared"]
        want += (torch.nn.functional.silu(x @ sh["w_gate"])
                 * (x @ sh["w_up"])) @ sh["w_down"]
    close(as_np(out), as_np(want), TOL)


def test_moe_bf16_within_the_reference_bf16_distance():
    """bf16 activations: the port's output is no farther from the f32
    reference than twice the reference's own bf16 output is."""
    jc32, jp, tc32, tp = _layer("qwen2_moe_a2_7b")
    jc, tc = jc32.scaled(dtype="bfloat16"), tc32.scaled(dtype="bfloat16")
    x = _x(jc.d_model, seed=3)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    f32, _ = JM.moe(jp, jc32, jnp.asarray(xb))
    ref, _ = JM.moe(jp, jc, jnp.asarray(xb, jnp.bfloat16))
    got, _ = TM.moe(tp, tc, torch.from_numpy(xb.copy()).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    f32 = np.asarray(f32)
    ref_err = np.abs(np.asarray(ref, np.float32) - f32).max()
    got_err = np.abs(as_np(got) - f32).max()
    assert got_err <= 2 * ref_err, (got_err, ref_err)


def test_capacity_and_rules():
    """Capacities agree; with rules the layer runs the grouped dispatch
    (S = 4 in 2 groups of 2), and falls back to one group where the
    groups do not divide S (S = 3), as the reference does."""
    jc, jp, tc, tp = _layer("qwen2_moe_a2_7b")
    for n in (1, 7, 24, 2048):
        assert TM.capacity(tc, n) == JM.capacity(jc, n)
    for s in (4, 3):
        x = np.random.default_rng(s).standard_normal(
            (1, s, tc.d_model), dtype=np.float32)
        want, want_aux = jax.jit(lambda p, xx: JM.moe(p, jc, xx, GROUPS))(
            jp, jnp.asarray(x))
        got, aux = TM.moe(tp, tc, torch.from_numpy(x), rules=GROUPS)
        close(as_np(got), want, TOL)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL)


def _grouped_keep(jc, idx, g):
    """The reference's kept choices with G groups (its lines, in numpy on
    its top-k): the capacity count runs inside each group of S/G tokens."""
    b, s, k = idx.shape
    flat = idx.reshape(b, g, (s // g) * k)
    onehot = np.eye(jc.moe.num_experts, dtype=np.int64)[flat]
    pos_in_e = np.sum(np.cumsum(onehot, axis=2) * onehot, axis=-1) - 1
    return (pos_in_e < JM.capacity(jc, s // g)).reshape(b * g, -1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 0.25])
def test_grouped_dispatch_matches_the_reference(arch, capacity_factor):
    """G = 2: the dropped choices first (the port's router as `moe` calls
    it, against the reference's top-k counted per group), then out and
    aux against the reference's `moe` under the same stand-in rules. At
    capacity factor 0.25 the drops differ from one group's."""
    jc, jp, tc, tp = _layer(arch, capacity_factor)
    x = _x(jc.d_model, seed=4)
    probs = np.asarray(_ref_probs(jnp.asarray(x), jp["router"]))
    idx = np.asarray(jax.lax.top_k(jnp.asarray(probs), jc.moe.top_k)[1])
    calls, inner = [], TM.route

    def recording(params, cfg, xx):
        calls.append(inner(params, cfg, xx))
        return calls[-1]

    TM.route = recording
    try:
        out, aux = TM.moe(tp, tc, torch.from_numpy(x), rules=GROUPS)
    finally:
        TM.route = inner
    (r,) = calls
    want_keep = _grouped_keep(jc, idx, 2)
    np.testing.assert_array_equal(r.gate_idx.reshape(B, S, -1).numpy(),
                                  idx)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    if capacity_factor is None:
        assert want_keep.all()
    else:
        one_group = _grouped_keep(jc, idx, 1).reshape(B, 2, -1)
        assert (one_group != want_keep.reshape(B, 2, -1)).any()
    want_out, want_aux = jax.jit(
        lambda p, xx: JM.moe(p, jc, xx, GROUPS))(jp, jnp.asarray(x))
    close(as_np(out), want_out, TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_defs_match_the_reference(arch):
    jc, tc = cfgs(arch)

    def flat(defs, prefix=()):
        if isinstance(defs, dict):
            return {k: v for key in defs
                    for k, v in flat(defs[key], prefix + (key,)).items()}
        return {prefix: (defs.shape, defs.spec, defs.scale, defs.dtype,
                         defs.fan_in)}
    assert flat(TM.moe_defs(tc)) == flat(JM.moe_defs(jc))
