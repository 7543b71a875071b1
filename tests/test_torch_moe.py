"""The port's MoE slice against the JAX package on the CPU.

``core.moe_dispatch`` (routing with ties, the sort-based capacity plan,
overflow to the fallback, the gather round trip, gradients, load stats and
``CapacityController``), ``models.moe.moe_ffn`` with its aux values, and
whole ``moe`` models (qwen3-moe-30b-a3b and grok-1-314b ``smoke()``)
carried across with ``model_params_from_jax``.  Inputs come from numpy
seeds and go to both packages; tolerances are those of
``tests/test_moe_dispatch.py`` (1e-5) for the dispatch and of the model
tests (2e-4) for layers and models.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import moe_dispatch as jmd  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core import moe_dispatch as md  # noqa: E402
from repro_torch.models import make_model, moe, transformer  # noqa: E402

DISPATCH_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
MOE_ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]


def rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_route_and_plan(logits, k, capacity):
    jr = jmd.route_topk(logits, k)
    return jr, jmd.make_dispatch_plan(jr.expert_ids, jr.expert_probs, logits.shape[1], capacity)


def both_plans(logits, k, capacity):
    """The port's and the reference's routing and plan for the same logits
    (the reference's in one jitted call)."""
    e = logits.shape[1]
    r = md.route_topk(torch.from_numpy(logits), k)
    plan = md.make_dispatch_plan(r.expert_ids, r.expert_probs, e, capacity)
    jr, jplan = _jax_route_and_plan(jnp.asarray(logits), k, capacity)
    return r, jr, plan, jplan._replace(num_experts=e, capacity=capacity)


def assert_same_plan(plan, jplan):
    for field in ("slot_token", "slot_valid", "slot_index", "expert_ids", "overflow"):
        np.testing.assert_array_equal(getattr(plan, field).numpy(),
                                      np.asarray(getattr(jplan, field)), err_msg=field)
    np.testing.assert_allclose(plan.gate.numpy(), np.asarray(jplan.gate), **DISPATCH_TOL)
    assert (plan.num_experts, plan.capacity) == (jplan.num_experts, jplan.capacity)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def test_topk_shapes_normalization_and_losses_match():
    logits = rnd(16, 8, seed=1)
    r, jr, _, _ = both_plans(logits, 3, 4)
    assert r.expert_ids.shape == (16, 3)
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(jr.expert_ids))
    np.testing.assert_allclose(r.expert_probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    for got, want in ((r.expert_probs, jr.expert_probs), (r.aux_loss, jr.aux_loss),
                      (r.router_z_loss, jr.router_z_loss)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DISPATCH_TOL)


def test_aux_loss_minimal_when_balanced():
    # uniform logits: every expert ties, so top-1 is expert 0 in both packages
    logits = np.zeros((1024, 4), np.float32)
    r, jr, _, _ = both_plans(logits, 1, 8)
    assert float(r.aux_loss) == pytest.approx(1.0, abs=0.05)
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(jr.expert_ids))
    assert int(r.expert_ids.max()) == 0


@pytest.mark.parametrize("k", [1, 2, 3])
def test_ties_go_to_the_lower_expert_as_in_jax(k):
    # rows with repeated values in every position of the order
    logits = np.array([[0.5, 1.0, 1.0, 0.5, 1.0, -2.0],
                       [3.0, 3.0, 3.0, 3.0, 3.0, 3.0],
                       [-1.0, 2.0, -1.0, 2.0, -1.0, 2.0],
                       [0.0, 0.0, 1.0, 1.0, 0.0, 0.0]], np.float32)
    r, jr, plan, jplan = both_plans(np.repeat(logits, 3, axis=0), k, 4)
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(jr.expert_ids))
    assert r.expert_ids[0].tolist() == [1, 2, 4][:k]
    assert_same_plan(plan, jplan)


def test_router_noise_is_added_before_the_softmax():
    logits, noise = rnd(32, 8, seed=2), rnd(32, 8, seed=3, scale=0.3)
    r = md.route_topk(torch.from_numpy(logits), 2, router_noise=torch.from_numpy(noise))
    jr = jmd.route_topk(jnp.asarray(logits), 2, router_noise=jnp.asarray(noise))
    np.testing.assert_array_equal(r.expert_ids.numpy(), np.asarray(jr.expert_ids))
    np.testing.assert_allclose(r.router_z_loss.numpy(), np.asarray(jr.router_z_loss),
                               **DISPATCH_TOL)


# ---------------------------------------------------------------------------
# the capacity plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t,e,k,c,seed", [
    (1, 1, 1, 1, 0), (7, 3, 2, 1, 1), (32, 4, 2, 8, 2), (64, 8, 3, 5, 3),
    (50, 5, 1, 32, 4), (16, 2, 2, 3, 5), (64, 8, 2, 16, 6), (33, 6, 3, 2, 7),
])
def test_plan_matches_jax_and_keeps_its_invariants(t, e, k, c, seed):
    _, _, plan, jplan = both_plans(rnd(t, e, seed=seed), k, c)
    assert_same_plan(plan, jplan)
    slot = plan.slot_index.numpy()
    overflow = plan.overflow.numpy().reshape(-1)
    live = slot[slot >= 0]
    assert len(np.unique(live)) == len(live) and (live < e * c).all()
    np.testing.assert_array_equal(slot == -1, overflow)
    assert all(cnt <= c for cnt in np.unique(live // c, return_counts=True)[1])
    valid = plan.slot_valid.numpy()
    assert (plan.slot_token.numpy()[valid] < t).all() and int(valid.sum()) == len(live)


def test_first_come_first_served_within_expert():
    ids, probs = torch.zeros((3, 1), dtype=torch.int64), torch.ones((3, 1))
    plan = md.make_dispatch_plan(ids, probs, num_experts=2, capacity=2)
    assert plan.overflow[:, 0].tolist() == [False, False, True]
    jplan = jmd.make_dispatch_plan(jnp.zeros((3, 1), jnp.int32), jnp.ones((3, 1)), 2, 2)
    assert_same_plan(plan, jplan)


def test_roundtrip_no_overflow():
    t, e, k, c, d = 16, 4, 2, 16, 8
    _, _, plan, jplan = both_plans(rnd(t, e, seed=0), k, c)
    x = rnd(t, d, seed=1)
    xe = md.dispatch(torch.from_numpy(x), plan)
    np.testing.assert_allclose(xe.numpy(), np.asarray(jmd.dispatch(jnp.asarray(x), jplan)),
                               **DISPATCH_TOL)
    # identity experts + zero fallback: out = sum_k gate * token = token
    out = md.combine(xe, torch.zeros(t, d), plan)
    np.testing.assert_allclose(out.numpy(), x, rtol=1e-5)


def test_overflow_goes_to_fallback():
    t, d = 4, 4
    plan = md.make_dispatch_plan(torch.zeros((t, 1), dtype=torch.int64), torch.ones((t, 1)),
                                 num_experts=1, capacity=1)
    x = torch.arange(t * d, dtype=torch.float32).reshape(t, d)
    out = md.combine(md.dispatch(x, plan) * 0.0, -torch.ones(t, d), plan)
    np.testing.assert_allclose(out[0].numpy(), 0.0)
    np.testing.assert_allclose(out[1:].numpy(), -1.0)


def test_combine_matches_jax_under_overflow():
    t, e, k, c, d = 40, 4, 2, 6, 8
    _, _, plan, jplan = both_plans(rnd(t, e, seed=8), k, c)
    assert bool(plan.overflow.any())
    ye, yf = rnd(e, c, d, seed=9), rnd(t, d, seed=10)
    np.testing.assert_allclose(
        md.combine(torch.from_numpy(ye), torch.from_numpy(yf), plan).numpy(),
        np.asarray(jmd.combine(jnp.asarray(ye), jnp.asarray(yf), jplan)), **DISPATCH_TOL)


def test_gradients_flow_through_both_paths_as_in_jax():
    t, e, k, c, d = 8, 2, 1, 2, 4   # tight capacity forces overflow
    _, _, plan, jplan = both_plans(rnd(t, e, seed=11), k, c)
    xn = rnd(t, d, seed=2)
    x = torch.from_numpy(xn).requires_grad_(True)
    w = torch.eye(d).requires_grad_(True)
    md.combine(md.dispatch(x, plan) * 2.0, x @ w, plan).sum().backward()
    assert float(x.grad.abs().sum()) > 0 and float(w.grad.abs().sum()) > 0

    def f(x_, w_):
        return jnp.sum(jmd.combine(jmd.dispatch(x_, jplan) * 2.0, x_ @ w_, jplan))

    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(xn), jnp.eye(d))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **DISPATCH_TOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), **DISPATCH_TOL)


def test_expert_load_stats_match():
    _, _, plan, jplan = both_plans(rnd(48, 6, seed=12), 2, 10)
    (load, ov), (jload, jov) = md.expert_load_stats(plan), jmd.expert_load_stats(jplan)
    np.testing.assert_allclose(load.numpy(), np.asarray(jload), **DISPATCH_TOL)
    np.testing.assert_allclose(float(ov), float(jov), **DISPATCH_TOL)


# ---------------------------------------------------------------------------
# CapacityController
# ---------------------------------------------------------------------------
def test_capacity_controller_grows_shrinks_and_holds():
    c = md.CapacityController(capacity_factor=1.0)
    assert c.update(overflow_frac=0.3, mean_load=0.9) and c.capacity_factor > 1.0
    c = md.CapacityController(capacity_factor=2.0)
    assert c.update(overflow_frac=0.0, mean_load=0.2) and c.capacity_factor < 2.0
    c = md.CapacityController(capacity_factor=1.25, quantum=0.25)
    assert not c.update(overflow_frac=0.021, mean_load=0.8)  # tiny breach: hysteresis


def test_capacity_controller_follows_the_reference():
    rng = np.random.default_rng(13)
    ours, ref = md.CapacityController(), jmd.CapacityController()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for _ in range(40):
        ov, load = float(rng.choice([0.0, 0.01, 0.03, 0.3, 0.7])), float(rng.random())
        assert ours.update(ov, load) == ref.update(ov, load)
        assert ours.capacity_factor == ref.capacity_factor
        assert ours.capacity(1000, 8, 128) == ref.capacity(1000, 8, 128)


# ---------------------------------------------------------------------------
# the MoE layer and models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    """(cfg, JAX model, JAX params, port params) for one MoE smoke config."""
    jcfg = jax_get_config(request.param).smoke()
    cfg = get_config(request.param).smoke()
    jm = jax_make_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, jm, jparams, params


def test_moe_capacity_matches_reference():
    for name in MOE_ARCHS:
        for cfg, jcfg in ((get_config(name), jax_get_config(name)),
                          (get_config(name).smoke(), jax_get_config(name).smoke())):
            for tokens in (1, 4, 13, 891, 2048, 32768):
                assert moe.moe_capacity(cfg, tokens) == jmoe.moe_capacity(jcfg, tokens)


@pytest.mark.parametrize("capacity_factor,fallback", [(1.25, True), (0.5, True), (0.5, False)])
def test_moe_ffn_and_aux_match(moe_pair, capacity_factor, fallback):
    cfg, jm, jparams, params = moe_pair
    par = dict(capacity_factor=capacity_factor, moe_fallback=fallback)
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, **par))
    jcfg = jm.cfg.replace(parallel=dataclasses.replace(jm.cfg.parallel, **par))
    p = params["layers"][0]["moe"]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["moe"])
    x = rnd(2, 11, cfg.d_model, seed=14)
    out, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MODEL_TOL)
    assert set(aux) == set(jaux) == set(transformer.AUX_KEYS)
    for key in aux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), **MODEL_TOL)
    if capacity_factor < 1:
        assert float(aux["moe_overflow_frac"]) > 0  # the fallback path is exercised


def test_moe_params_carry_across(moe_pair):
    cfg, _, jparams, params = moe_pair
    assert set(params["layers"][0]["moe"]) == {"router", "w1", "w3", "w2", "fallback"}
    for name in ("router", "w1", "w3", "w2"):
        np.testing.assert_array_equal(params["layers"][1]["moe"][name].numpy(),
                                      np.asarray(jparams["blocks"][0]["moe"][name][1]))
    np.testing.assert_array_equal(params["layers"][1]["moe"]["fallback"]["w2"].numpy(),
                                  np.asarray(jparams["blocks"][0]["moe"]["fallback"]["w2"][1]))
    fresh = make_model(cfg, device="cpu").init(0)
    assert jax.tree_util.tree_structure(
        jax.tree.map(lambda a: 0, fresh)) == jax.tree_util.tree_structure(
        jax.tree.map(lambda a: 0, params))
    for got, want in zip(jax.tree.leaves(fresh), jax.tree.leaves(params)):
        assert got.shape == want.shape and got.dtype == want.dtype


def test_moe_model_forward_aux_matches(moe_pair):
    cfg, jm, jparams, params = moe_pair
    tokens = np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    jhidden, _, jaux = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    aux = {}
    model = make_model(cfg, device="cpu")
    hidden, _ = model.forward(params, torch.from_numpy(tokens), aux=aux)
    np.testing.assert_allclose(model.logits(params, hidden).numpy(),
                               np.asarray(jm.logits(jparams, jhidden)), **MODEL_TOL)
    for key in transformer.AUX_KEYS:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), **MODEL_TOL)


def test_moe_model_prefill_and_decode_logits(moe_pair):
    cfg, jm, jparams, params = moe_pair
    model = make_model(cfg, device="cpu")
    tokens = np.random.default_rng(16).integers(0, cfg.vocab_size, (1, 13)).astype(np.int32)
    jlogits, jcaches = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, 32)
    logits, caches = model.prefill(params, torch.from_numpy(tokens), 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    tok = tokens[:, -1:]
    for step in range(4):
        pos = np.array([[13 + step]], np.int32)
        jlogits, jcaches = jm.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), jcaches)
        logits, caches = model.decode_step(params, torch.from_numpy(tok), torch.from_numpy(pos),
                                           caches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
        tok = np.array(jnp.argmax(jlogits, axis=-1), np.int32)[:, None]


def test_dense_model_aux_is_zero():
    cfg = get_config("tinyllama-1.1b").smoke()
    model = make_model(cfg, device="cpu")
    aux = {}
    model.forward(model.init(0), torch.zeros((1, 5), dtype=torch.int64), aux=aux)
    assert sorted(aux) == sorted(transformer.AUX_KEYS)
    assert all(float(v) == 0.0 for v in aux.values())


def test_parallel_config_matches_reference():
    # the port's fields, with the reference's defaults and each config's values
    fields = [f.name for f in dataclasses.fields(ParallelConfig)]
    for name in ("qwen3-moe-30b-a3b", "grok-1-314b", "llama-3.2-vision-90b", "tinyllama-1.1b"):
        for cfg, jcfg in ((get_config(name), jax_get_config(name)),
                          (get_config(name).smoke(), jax_get_config(name).smoke())):
            assert {f: getattr(cfg.parallel, f) for f in fields} == \
                {f: getattr(jcfg.parallel, f) for f in fields}, name
