"""The port's training path against the JAX package's, on the CPU.

``cross_entropy_loss``; ``Model.loss_fn`` (chunked and not) and its
gradients for the ``smoke()`` config of one model of each family
(tinyllama-1.1b, mamba2-130m, qwen3-moe-30b-a3b, recurrentgemma-9b,
whisper-large-v3, llama-3.2-vision-90b with its cross gates at 0.5);
remat on and off; ``make_train_step`` with 1 and 2 microbatches against
the reference's on a mesh with Auto axes (the reference's own
``run_training`` builds a mesh that jax 0.9 rejects, ROADMAP.md queue
3); ``run_training``; and the gradients of K4's and K5's ``Function``s
against autograd of their plain versions.  Parameters are carried across
with ``convert``; inputs come from numpy seeds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import InputShape as JaxInputShape  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import make_model as jax_make_model  # noqa: E402
from repro.parallel.mesh_rules import MeshRules  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain,
)
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.launch.steps import default_microbatches, make_train_step  # noqa: E402
from repro_torch.launch.train import TrainLoopConfig, run_training  # noqa: E402
from repro_torch.models import layers, make_model, transformer  # noqa: E402
from repro_torch.parallel import mesh_rules  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

MODEL_TOL = dict(rtol=2e-4, atol=2e-4)     # the port's model tolerance
# gradients: atol of this share of the tree's largest |g|, not per leaf, since
# some true gradients are zero and their computed values only rounding: q·bk
# shifts all of a query's scores equally and softmax ignores it, so whisper's
# bk gradients are ~1e-10 and differ by ~100 % of their own size
GRAD_REL = 1e-4
ARCHS = ["tinyllama-1.1b", "mamba2-130m", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
         "whisper-large-v3", "llama-3.2-vision-90b"]
B, S, CHUNK = 2, 16, 8


def one_device(cfg):
    """The rules of the one-device (1, 1) mesh, no process group."""
    return mesh_rules.MeshRules(mesh_rules.MeshShape((1, 1), ("data", "model")), cfg.parallel)


def with_open_gates(jparams):
    """The reference's parameters with every cross gate at 0.5 (at 0,
    tanh(0) multiplies the cross path away)."""
    blocks = [dict(blk, gate_attn=jnp.full_like(blk["gate_attn"], 0.5),
                   gate_mlp=jnp.full_like(blk["gate_mlp"], 0.5)) if "gate_attn" in blk else blk
              for blk in jparams["blocks"]]
    return dict(jparams, blocks=blocks)


def numpy_batch(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:],
                 mask=(rng.random((b, s)) > 0.2).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_port(tree, cfg):
    return convert.model_params_from_jax(jax.tree.map(np.asarray, tree), cfg, "cpu")


def assert_grads_close(got, want):
    """Every leaf within GRAD_REL × the largest |g| of ``want``."""
    gmax = max(float(g.abs().max()) for g in tree_leaves(want))
    pairs = list(zip(tree_leaves_with_path(got), tree_leaves_with_path(want)))
    assert len(pairs) == len(tree_leaves(want)) == len(tree_leaves(got))
    for (path, a), (wpath, b) in pairs:
        assert path == wpath and a.shape == b.shape, (path, wpath)
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=0,
                                   atol=GRAD_REL * gmax, err_msg=str(path))


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(cfg, port model, port params, numpy batch, JAX losses {chunk: loss}, JAX grads
    at the chunked loss, carried to the port's layout)."""
    jcfg, cfg = jax_get_config(request.param).smoke(), get_config(request.param).smoke()
    jm = jax_make_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    if cfg.family == "vlm":
        jparams = with_open_gates(jparams)
    batch = numpy_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jbatch, loss_chunk=CHUNK), has_aux=True)(jparams)
    losses = {CHUNK: float(jloss), 0: float(jm.loss_fn(jparams, jbatch, loss_chunk=0)[0])}
    return (cfg, make_model(cfg, device="cpu"), to_port(jparams, cfg), batch, losses,
            to_port(jgrads, cfg))


def port_grads(model, params, batch, loss_chunk=CHUNK):
    step = make_train_step(model, optim.AdamW(cfg=model.cfg), one_device(model.cfg),
                           InputShape("t", S, B, "train"), loss_chunk=loss_chunk, microbatches=1)
    return step.grads(params, torch_batch(batch))


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss(masked, z_loss):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32) if masked else None
    loss, denom = layers.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), z_loss=z_loss)
    jloss, jdenom = jlayers.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), None if mask is None else jnp.asarray(mask),
        z_loss=z_loss)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(denom), float(jdenom), rtol=1e-6)


@pytest.mark.parametrize("loss_chunk", [0, CHUNK])
def test_loss_fn_matches_reference(family, loss_chunk):
    cfg, model, params, batch, losses, _ = family
    loss, metrics = model.loss_fn(params, torch_batch(batch), loss_chunk=loss_chunk)
    assert set(metrics) >= {"loss", "ce_loss"} | set(transformer.AUX_KEYS)
    np.testing.assert_allclose(float(loss), losses[loss_chunk], **MODEL_TOL)
    if cfg.family != "moe":
        assert float(metrics["ce_loss"]) == float(loss)


def test_gradients_match_jax_grad(family):
    cfg, model, params, batch, losses, jgrads = family
    grads, metrics = port_grads(model, params, batch)
    np.testing.assert_allclose(float(metrics["loss"]), losses[CHUNK], **MODEL_TOL)
    assert_grads_close(grads, jgrads)


def test_remat_does_not_change_gradients(family, monkeypatch):
    cfg, model, params, batch, _, _ = family
    from repro_torch.models import encdec
    units = []
    for module in (transformer, encdec):
        real = module.checkpoint
        monkeypatch.setattr(module, "checkpoint",
                            lambda fn, *a, _real=real, **kw: units.append(fn) or _real(fn, *a, **kw))
    with_remat, _ = port_grads(model, params, batch)
    pat, repeats, _ = transformer.pattern_of(cfg) if cfg.family != "encdec" else ((), 0, ())
    want_units = (cfg.encoder_layers + cfg.num_layers if cfg.family == "encdec" else repeats)
    assert len(units) == want_units > 0
    plain_cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, remat="none"))
    without, _ = port_grads(make_model(plain_cfg, device="cpu"), params, batch)
    assert len(units) == want_units
    for (path, a), (_, b) in zip(tree_leaves_with_path(with_remat), tree_leaves_with_path(without)):
        assert torch.equal(a, b), path


@pytest.fixture(scope="module")
def auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_train_step_matches_reference(auto_mesh, arch, mb):
    """Step 1 from the initial state, then step 2 from the reference's state
    after step 1 (``adamw_state_from_jax``).  The parameters are compared
    after step 2: at step 1 AdamW moves each parameter by lr · g/(|g| +
    eps), so a gradient within a few eps of zero turns float32 rounding of
    g into a visible change; at step 2 the moments carry step 1's g²."""
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jm = jax_make_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    batches = [numpy_batch(cfg, b=4, s=S, seed=seed) for seed in (2, 3)]
    lr = 1e-3
    jopt = joptim.AdamW()
    fn = jax_make_train_step(jm, jopt, MeshRules(auto_mesh, jcfg.parallel),
                             JaxInputShape("t", S, 4, "train"), lr=lr, loss_chunk=CHUNK,
                             microbatches=mb).jit()
    opt = optim.AdamW(cfg=cfg)
    step = make_train_step(make_model(cfg, device="cpu"), opt, one_device(cfg),
                           InputShape("t", S, 4, "train"),
                           lr=lr, loss_chunk=CHUNK, microbatches=mb)
    assert step.microbatches == mb
    params = to_port(jparams, cfg)
    state = opt.init(params)
    for batch in batches:
        with auto_mesh:  # the step donates its params and state: hand it copies
            jp, js, jmetrics = fn(jax.tree.map(jnp.copy, jparams),
                                  jax.tree.map(jnp.copy, jopt.init(jparams) if state.step == 0
                                               else jstate),
                                  {k: jnp.asarray(v) for k, v in batch.items()})
        p2, state2, metrics = step(params, state, torch_batch(batch))
        for key in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5,
                                       err_msg=key)
        assert int(state2.step) == int(js.step)
        # both continue from the reference's state
        jparams, jstate = jp, js
        params = to_port(jp, cfg)
        state = convert.adamw_state_from_jax(jax.tree.map(np.asarray, js), cfg, "cpu")
    assert int(state2.step) == 2
    for (path, a), (_, b) in zip(tree_leaves_with_path(p2), tree_leaves_with_path(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6, err_msg=str(path))
    # the moments carry the gradients: held as they are
    assert_grads_close(state2.mu, state.mu)
    assert_grads_close(state2.nu, state.nu)


def test_default_microbatches():
    cfg = get_config("tinyllama-1.1b")
    rules = one_device(cfg)
    assert default_microbatches(cfg, InputShape("t", 2048, 8, "train"), rules) == 2
    assert default_microbatches(cfg, InputShape("t", 2048, 3, "train"), rules) == 1
    assert default_microbatches(cfg, InputShape("t", 64, 8, "train"), rules) == 1
    for shape, dp in (((2, 1), 2), ((2, 2, 1), 4)):     # dp from the mesh: pod x data
        names = ("pod", "data", "model")[-len(shape):]
        rules = mesh_rules.MeshRules(mesh_rules.MeshShape(shape, names), cfg.parallel)
        assert default_microbatches(cfg, InputShape("t", 2048, 8, "train"), rules) == {
            2: 1, 4: 1}[dp]
        assert default_microbatches(cfg, InputShape("t", 2048, 32, "train"), rules) == {
            2: 4, 4: 2}[dp]
    mb4 = cfg.replace(parallel=dataclasses.replace(cfg.parallel, microbatches=4))
    assert default_microbatches(mb4, InputShape("t", 64, 8, "train"), rules) == 4


def test_training_loss_decreases(tmp_path):
    out = run_training(TrainLoopConfig(
        arch="tinyllama-1.1b", steps=40, global_batch=8, seq_len=64, lr=3e-3,
        ckpt_dir=str(tmp_path), ckpt_every=20, device="cpu"))
    assert out["steps"] == len(out["losses"]) == len(out["step_seconds"]) == 40
    assert out["losses"][0] == out["first_loss"] and out["losses"][-1] == out["final_loss"]
    assert out["final_loss"] < out["first_loss"]


def test_checkpoint_restart_resumes(tmp_path):
    first = run_training(TrainLoopConfig(
        arch="tinyllama-1.1b", steps=10, global_batch=4, seq_len=32,
        ckpt_dir=str(tmp_path), ckpt_every=10, device="cpu"))
    out = run_training(TrainLoopConfig(
        arch="tinyllama-1.1b", steps=14, global_batch=4, seq_len=32,
        ckpt_dir=str(tmp_path), ckpt_every=100, resume=True, device="cpu"))
    assert first["steps"] == 10
    assert out["steps"] == 4  # resumed from step 10


def test_resumed_run_continues_the_uninterrupted_one(tmp_path):
    """Steps 5-9 after a restore from step 5 are the uninterrupted run's."""
    whole = run_training(TrainLoopConfig(
        arch="mamba2-130m", steps=10, global_batch=4, seq_len=32, lr=3e-3,
        ckpt_dir=str(tmp_path / "a"), ckpt_every=5, device="cpu"))
    run_training(TrainLoopConfig(
        arch="mamba2-130m", steps=5, global_batch=4, seq_len=32, lr=3e-3,
        ckpt_dir=str(tmp_path / "b"), ckpt_every=5, device="cpu"))
    rest = run_training(TrainLoopConfig(
        arch="mamba2-130m", steps=10, global_batch=4, seq_len=32, lr=3e-3,
        ckpt_dir=str(tmp_path / "b"), ckpt_every=100, resume=True, device="cpu"))
    assert rest["steps"] == len(rest["losses"]) == len(rest["step_seconds"]) == 5
    np.testing.assert_allclose(rest["losses"], whole["losses"][5:], rtol=1e-6)


def test_microbatched_step_matches_monolithic():
    """Grad accumulation is numerically equivalent to one big batch (every
    position counted: each microbatch's loss is its own masked mean)."""
    cfg = get_config("tinyllama-1.1b").smoke()
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    batch = torch_batch(numpy_batch(cfg, b=8, s=32, seed=3))
    batch["mask"] = torch.ones_like(batch["mask"])
    shape = InputShape("t", 32, 8, "train")
    outs = {}
    for mb in (1, 4):
        opt = optim.AdamW(cfg=cfg)
        step = make_train_step(model, opt, one_device(cfg), shape, microbatches=mb,
                               loss_chunk=0)
        grads, _ = step.grads(params, batch)
        outs[mb] = (grads,) + step(params, opt.init(params), batch)
    assert_grads_close(outs[4][0], outs[1][0])
    for key in ("loss", "ce_loss", "grad_norm"):
        np.testing.assert_allclose(float(outs[4][3][key]), float(outs[1][3][key]), rtol=1e-5)
    # one AdamW step moves each parameter by about ±lr, whatever |g| is
    for (path, a), (_, b) in zip(tree_leaves_with_path(outs[4][1]),
                                 tree_leaves_with_path(outs[1][1])):
        assert float((a - b).abs().max()) < 5e-2, path


def test_train_cli_on_the_cpu(capsys):
    from repro_torch.launch import train
    train.main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--steps", "2",
                "--global-batch", "2", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "step     0" in out and "'steps': 2" in out


# -- K4 and K5 carry gradients ------------------------------------------------
def rnd(*shape, seed, scale=1.0):
    return torch.from_numpy(
        (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32))


def grads_of(fn, inputs, weights):
    leaves = [x.clone().requires_grad_(need) if x is not None else None for x, need in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.requires_grad for o in outs)
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights) if w is not None)
    loss.backward()
    return [o.detach() for o in outs], [x.grad if x is not None and need else None
                                        for x, (_, need) in zip(leaves, inputs)]


@pytest.mark.parametrize("sq,sk,h,kvh,d,causal,window,need,dtype", [
    (12, 12, 4, 2, 8, True, 0, (True, True, True), torch.float32),
    (12, 12, 4, 1, 16, True, 5, (True, True, True), torch.float32),
    (5, 9, 4, 4, 8, False, 0, (True, True, True), torch.float32),
    (12, 12, 4, 2, 8, True, 0, (False, True, False), torch.float32),
    (12, 12, 4, 2, 8, True, 0, (True, True, True), torch.bfloat16),
])
def test_k4_function_gradients_equal_autograd_of_plain(sq, sk, h, kvh, d, causal, window, need,
                                                       dtype):
    q, k, v = (rnd(2, sq, h, d, seed=1).to(dtype), rnd(2, sk, kvh, d, seed=2).to(dtype),
               rnd(2, sk, kvh, d, seed=3).to(dtype))
    w = [rnd(2, sq, h, d, seed=4)]
    mask = dict(causal=causal, window=window, scale=d**-0.5)
    inputs = list(zip((q, k, v), need))
    out, grads = grads_of(lambda *x: flash_attention(*x, **mask), inputs, w)
    want_out, want = grads_of(lambda *x: flash_attention_plain(*x, **mask), inputs, w)
    assert torch.equal(out[0], want_out[0])
    for g, gw, n in zip(grads, want, need):
        assert (g is None) == (not n)
        if n:
            assert g.dtype == dtype
            torch.testing.assert_close(g, gw, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("through", ["y", "state", "both"])
def test_k5_function_gradients_equal_autograd_of_plain(with_h0, through):
    b, s, h, p, n, chunk = 2, 21, 3, 4, 5, 8   # a partial last chunk
    x, bm, cm = rnd(b, s, h, p, seed=1), rnd(b, s, n, seed=2), rnd(b, s, n, seed=3)
    log_a = -0.3 * rnd(b, s, h, seed=4).abs()
    h0 = rnd(b, h, p, n, seed=5, scale=0.5) if with_h0 else None
    w = [rnd(b, s, h, p, seed=6) if through != "state" else None,
         rnd(b, h, p, n, seed=7) if through != "y" else None]
    inputs = [(x, True), (log_a, True), (bm, True), (cm, True), (h0, with_h0)]
    outs, grads = grads_of(lambda *a: ssd_scan(*a[:4], chunk=chunk, h0=a[4]), inputs, w)
    want_outs, want = grads_of(lambda *a: ssd_scan_plain(*a[:4], chunk=chunk, h0=a[4]),
                               inputs, w)
    for o, wo in zip(outs, want_outs):
        assert torch.equal(o, wo)
    for g, gw, (_, need) in zip(grads, want, inputs):
        if need and gw is not None:
            torch.testing.assert_close(g, gw, rtol=1e-6, atol=1e-7)
        else:  # not asked for, or C through the final state alone
            assert g is None and gw is None


def test_k5_gradients_stay_finite_where_a_masked_decay_overflows():
    """At a full-width chunk (256) a strong decay makes cs_i - cs_j pass 88
    above the diagonal, where exp() overflows float32: the masked
    exponential keeps the gradient finite, and float32 agrees with float64
    (where nothing overflows) at K5's tolerance."""
    b, s, h, p, n, chunk = 1, 256, 2, 4, 8, 256
    x, bm, cm = rnd(b, s, h, p, seed=1), rnd(b, s, n, seed=2), rnd(b, s, n, seed=3)
    log_a = -1.0 - rnd(b, s, h, seed=4).abs()      # cs falls by > 256 over the chunk
    w = [rnd(b, s, h, p, seed=6), rnd(b, h, p, n, seed=7)]
    inputs = [(x, True), (log_a, True), (bm, True), (cm, True), (None, False)]
    _, grads = grads_of(lambda *a: ssd_scan(*a[:4], chunk=chunk, h0=a[4]), inputs, w)
    inputs64 = [(t.double() if t is not None else None, need) for t, need in inputs]
    _, want = grads_of(lambda *a: ssd_scan_plain(*a[:4], chunk=chunk, h0=a[4]), inputs64,
                       [t.double() for t in w])
    for name, g, gw in zip(("x", "log_a", "B", "C"), grads, want):
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g, gw.float(), rtol=2e-4, atol=2e-4, msg=name)


def test_mamba2_flat_losses_are_the_reference_s(tmp_path):
    """mamba2-130m's losses on fresh batches stay flat at lr 3e-4 (the card
    shows it at full width, ``chip_smoke.py`` phase 7), and the reference's
    do the same: both ``run_training`` loops, 10 steps of the smoke config
    on the same ``SyntheticTokens`` stream (batch 8 × 128) from the same
    initial parameters (the reference's ``init``, carried across as a
    step-0 checkpoint that the port's loop resumes from), the reference on
    an Auto (1, 1) mesh.  The reference prints each loss to 4 decimals,
    so the curves are held at 1e-4: 5e-5 of rounding and as much again of
    float32 arithmetic over 10 steps.  Both curves stay within 1e-2 of
    their first loss, which lies at ln(256), chance on the smoke vocabulary."""
    import contextlib
    import io
    import re

    from jax.sharding import Mesh

    from repro.launch.train import TrainLoopConfig as RefLoop
    from repro.launch.train import run_training as ref_run_training
    from repro_torch.checkpoint import Checkpointer

    steps, lr, gb, seq = 10, 3e-4, 8, 128
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ref_run_training(RefLoop(arch="mamba2-130m", steps=steps, global_batch=gb,
                                 seq_len=seq, lr=lr, log_every=1), mesh=mesh)
    want = [float(x) for x in re.findall(r"loss (\S+)", printed.getvalue())]
    cfg = get_config("mamba2-130m").smoke()
    params = to_port(jax_make_model(jax_get_config("mamba2-130m").smoke()).init(
        jax.random.PRNGKey(0)), cfg)
    Checkpointer(tmp_path).save(0, (params, tuple(optim.AdamW(cfg=cfg).init(params))),
                                blocking=True)
    got = run_training(TrainLoopConfig(
        arch="mamba2-130m", steps=steps, global_batch=gb, seq_len=seq, lr=lr, log_every=100,
        ckpt_dir=str(tmp_path), ckpt_every=1000, resume=True, device="cpu"))["losses"]
    assert len(want) == len(got) == steps
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert abs(want[0] - np.log(cfg.vocab_size)) < 1e-2
    for curve in (want, got):
        assert max(abs(x - curve[0]) for x in curve) < 1e-2
