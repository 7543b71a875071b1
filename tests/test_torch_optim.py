"""The port's optimizer against the JAX package's, on the CPU.

``AdamW.update`` for three steps from a state carried across with
``adamw_state_from_jax``, with float32 and bfloat16 moments, over the
smoke trees of tinyllama-1.1b, recurrentgemma-9b cut to 5 layers (one
stacked pattern of 3 and a remainder of 2), whisper-large-v3,
mamba2-130m, qwen3-moe-30b-a3b and llama-3.2-vision-90b; the decay
decision of every leaf, which must be the reference's on its stacked
layout; ``global_norm``, ``clip_by_global_norm`` and the three
schedules.  Gradients come from numpy seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

# float32 arithmetic on both sides, the same IEEE operations in the same
# order; bfloat16 moments are those values rounded once, the same way
TOL = dict(rtol=1e-6, atol=1e-7)
SMOKE = {
    "tinyllama-1.1b": {},
    "recurrentgemma-9b": {"num_layers": 5},   # a remainder of 2 unstacked layers
    "whisper-large-v3": {},
    "mamba2-130m": {},
    "qwen3-moe-30b-a3b": {},
    "llama-3.2-vision-90b": {},
}


def configs(arch):
    kw = SMOKE[arch]
    return jax_get_config(arch).smoke().replace(**kw), get_config(arch).smoke().replace(**kw)


@pytest.fixture(scope="module", params=list(SMOKE))
def trees(request):
    """(arch, jcfg, cfg, JAX params, numpy grads for 3 steps in the reference layout)."""
    jcfg, cfg = configs(request.param)
    jparams = jax_make_model(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda p: (0.05 * rng.standard_normal(p.shape)).astype(np.float32),
                          jparams) for _ in range(3)]
    return request.param, jcfg, cfg, jparams, grads


def to_port(tree, cfg):
    return convert.model_params_from_jax(jax.tree.map(np.asarray, tree), cfg, "cpu")


def assert_trees_close(got, want_jax, cfg):
    want = to_port(want_jax, cfg)
    for (path, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
        assert a.dtype == b.dtype, path
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **TOL, err_msg=str(path))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_for_three_steps(trees, state_dtype):
    arch, jcfg, cfg, jparams, grads = trees
    jopt = joptim.AdamW(state_dtype=getattr(jnp, state_dtype))
    opt = optim.AdamW(state_dtype=getattr(torch, state_dtype), cfg=cfg)
    jstate = jopt.init(jparams)
    state = convert.adamw_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    params = to_port(jparams, cfg)
    for i, g in enumerate(grads):
        lr = 1e-3 * (i + 1)
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams,
                                   jnp.asarray(lr, jnp.float32))
        jparams = joptim.AdamW.apply_updates(jparams, jupd)
        upd, state = opt.update(to_port(g, cfg), state, params, lr)
        params = optim.AdamW.apply_updates(params, upd)
        assert int(state.step) == int(jstate.step) == i + 1
        assert_trees_close(upd, jupd, cfg)
        assert_trees_close(state.mu, jstate.mu, cfg)
        assert_trees_close(state.nu, jstate.nu, cfg)
        assert_trees_close(params, jparams, cfg)


def test_decay_decisions_are_the_reference_s(trees):
    arch, jcfg, cfg, jparams, _ = trees
    jopt = joptim.AdamW()
    # each reference leaf filled with its decision (1.0 decayed), carried to
    # the port's layout: every port leaf must then hold its own decision
    decided = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape, float(jopt.decay_mask(path, x)), np.float32), jparams)
    want = to_port(decided, cfg)
    got = optim.AdamW(cfg=cfg).decays(to_port(jparams, cfg))
    leaves = list(tree_leaves_with_path(want))
    assert len(got) == len(leaves)
    for path, w in leaves:
        assert got[path] == bool(w.reshape(-1)[0]), path
    # the stacked per-layer vectors are decayed, as in the reference
    if cfg.family == "encdec":
        assert got[("dec_blocks", 0, "ln_attn", "w")] and not got[("dec_ln_out", "w")]
    else:
        norm = "ln" if cfg.family == "ssm" else "ln_mlp"
        assert got[("layers", 0, norm)] and not got[("final_norm",)]
    if cfg.family == "hybrid":  # layers 3-4 are the remainder: their vectors are not
        assert len(jparams["remainder"]) == 2
        assert not got[("layers", 3, "ln_rec")] and not got[("layers", 4, "rec", "lam")]
        assert got[("layers", 3, "rec", "w_x")] and got[("layers", 0, "rec", "lam")]
        assert got[("layers", 2, "ln_attn")]


def test_global_norm_and_clipping():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": [rng.standard_normal(3).astype(np.float32),
                  rng.standard_normal((2, 2)).astype(np.float32)]}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(x) for x in tree["b"]]}
    norm = float(joptim.global_norm(jtree))
    np.testing.assert_allclose(float(optim.global_norm(ttree)), norm, rtol=1e-6)
    for max_norm in (0.5 * norm, 2.0 * norm):   # clipping, and a norm below the limit
        jclipped, jn = joptim.clip_by_global_norm(jtree, max_norm)
        clipped, n = optim.clip_by_global_norm(ttree, max_norm)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        for a, b in zip(tree_leaves(clipped), jax.tree.leaves(jclipped)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    bf = {"x": torch.ones(4, dtype=torch.bfloat16)}
    assert optim.clip_by_global_norm(bf, 1.0)[0]["x"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear_decay", "constant"])
def test_schedules(name):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = getattr(optim, name)(step, **kw)
        want = getattr(joptim, name)(step, **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0, err_msg=str(step))
