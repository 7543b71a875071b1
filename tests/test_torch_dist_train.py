"""The port's data-parallel training (slice F1) against the JAX package's.

Two gloo ranks (spawned processes, one spawn for every check) run the
sharded train step on a (2, 1) ``("data", "model")`` mesh from the
reference's parameters (carried across with ``convert``), on
tinyllama-1.1b's smoke() config with 2 microbatches and mamba2-130m's
with 1, and are held to the reference's ``make_train_step`` on a (2, 1)
mesh of 2 forced host devices (a subprocess that pickles its numbers), at
``test_torch_train.py``'s tolerances: ``loss``, ``ce_loss`` and
``grad_norm`` at rtol 1e-5, the parameters after the second step (taken
from the reference's state after the first) at atol 1e-6, the moments at
1e-4 of their largest value.  The batches' masks are random, so the
loss's weighting by each rank's mask sum is held too.

The same spawn restores a checkpoint written by one rank onto the two
(each rank's shards equal their slices of the saved arrays, bitwise),
writes it back from them (bitwise the same checkpoint), and resumes
``run_training`` on the mesh: its losses equal the one-rank run's, every
rank returns the same result, and one rank resumes from the checkpoint
the two wrote.  In-process: the (1, 1) mesh's step is the one-card step
written out, bitwise; ``elastic_restore_summary`` is the reference's; a
mesh of several ranks without a process group, and a batch that does not
split over the data ranks, raise (``test_torch_dist_train_tp*.py`` hold
the model axis and the moe family on a mesh).
"""

import os
import pickle
import shutil
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import convert, optim  # noqa: E402
from repro_torch.checkpoint import Checkpointer, elastic_restore_summary, reshard_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core.elastic import ElasticMeshManager  # noqa: E402
from repro_torch.launch.steps import GRAD_CLIP, make_train_step  # noqa: E402
from repro_torch.launch.train import TrainLoopConfig, run_training  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.parallel.mesh_rules import MeshRules, MeshShape, axes_leaves  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CASES = {"tinyllama-1.1b": 2, "mamba2-130m": 1}     # arch: microbatches
S, ROWS, CHUNK, LR = 16, 4, 8, 1e-3
RUN = dict(arch="mamba2-130m", global_batch=4, seq_len=32, lr=3e-3, ckpt_every=2, device="cpu")


def numpy_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (ROWS, S + 1)).astype(np.int32)
    return dict(tokens=toks[:, :-1], labels=toks[:, 1:],
                mask=(rng.random((ROWS, S)) > 0.2).astype(np.float32))


REFERENCE = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, %r)
    sys.path.insert(0, %r)
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro import optim
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.launch.steps import make_train_step
    from repro.models import make_model
    from repro.parallel.mesh_rules import MeshRules
    from test_torch_dist_train import CASES, CHUNK, LR, ROWS, S, numpy_batch

    mesh = jax.make_mesh((2, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    host = lambda t: jax.tree.map(np.asarray, t)
    out = {}
    for arch, mb in CASES.items():
        cfg = get_config(arch).smoke()
        model = make_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        opt = optim.AdamW()
        state = opt.init(params)
        fn = make_train_step(model, opt, MeshRules(mesh, cfg.parallel),
                             InputShape("t", S, ROWS, "train"), lr=LR, loss_chunk=CHUNK,
                             microbatches=mb).jit()
        steps = []
        first = host(params)
        for seed in (2, 3):
            batch = {k: jnp.asarray(v) for k, v in numpy_batch(cfg, seed).items()}
            with mesh:  # the step donates its params and state: hand it copies
                params, state, metrics = fn(jax.tree.map(jnp.copy, params),
                                            jax.tree.map(jnp.copy, state), batch)
            steps.append(dict(params=host(params), step=int(state.step), mu=host(state.mu),
                              nu=host(state.nu), metrics={k: float(v) for k, v in metrics.items()}))
        out[arch] = dict(params0=first, steps=steps)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""") % (str(SRC), str(Path(__file__).resolve().parent))


def reference_state(ref_step, cfg):
    return convert.adamw_state_from_jax(types.SimpleNamespace(**ref_step), cfg, "cpu")


def _sharded_steps(ref, mesh):
    """Per arch: each step's metrics, and the gathered parameters and moments
    after the second (taken from the reference's state after the first)."""
    out = {}
    for arch, mb in CASES.items():
        cfg = get_config(arch).smoke()
        opt = optim.AdamW(cfg=cfg)
        step = make_train_step(make_model(cfg, device="cpu"), opt, MeshRules(mesh, cfg.parallel),
                               InputShape("t", S, ROWS, "train"), lr=LR, loss_chunk=CHUNK,
                               microbatches=mb)
        params = step.shard(convert.model_params_from_jax(ref[arch]["params0"], cfg, "cpu"))
        state = opt.init(params)
        metrics = []
        for k, seed in enumerate((2, 3)):
            batch = {k2: torch.from_numpy(v) for k2, v in numpy_batch(cfg, seed).items()}
            new_params, new_state, m = step(params, state, batch)
            metrics.append({key: float(v) for key, v in m.items()})
            # both continue from the reference's state
            full = reference_state(ref[arch]["steps"][k], cfg)
            params = step.shard(convert.model_params_from_jax(ref[arch]["steps"][k]["params"],
                                                              cfg, "cpu"))
            state = optim.AdamWState(full.step, step.shard(full.mu), step.shard(full.nu))
        out[arch] = dict(metrics=metrics, microbatches=step.microbatches,
                         params=step.gather(new_params), mu=step.gather(new_state.mu),
                         nu=step.gather(new_state.nu), step=int(new_state.step),
                         shard_numel=sum(t.numel() for t in tree_leaves(new_params)))
    return out


def _checkpoints(tmp: Path, mesh, rank: int):
    """The one-rank checkpoint of step 2 restored onto the mesh, written back
    from it, and run_training resumed on the mesh."""
    cfg = get_config(RUN["arch"]).smoke()
    model = make_model(cfg, device="cpu")
    rules = MeshRules(mesh, cfg.parallel)
    params = model.init(0)
    opt = optim.AdamW(cfg=cfg)
    like = (params, tuple(opt.init(params)))
    (host_p, (step_t, host_mu, host_nu)), step = Checkpointer(tmp / "one").restore(2, like)
    specs = model.param_specs()
    shards = [reshard_tree(tree, specs, rules, device="cpu") for tree in (host_p, host_mu, host_nu)]
    coords = rules.coordinate()
    for tree, shard in zip((host_p, host_mu, host_nu), shards):
        for axes, full, part in zip(axes_leaves(specs), tree_leaves(tree), tree_leaves(shard)):
            index = rules.local_slice(rules.spec(axes, tuple(full.shape)), tuple(full.shape), coords)
            assert torch.equal(part, full[index]) and part.is_contiguous()
    train_step = make_train_step(model, opt, rules, InputShape("t", RUN["seq_len"],
                                 RUN["global_batch"], "train"), loss_chunk=0, microbatches=1)
    back = [train_step.gather(s) for s in shards]
    if rank == 0:
        Checkpointer(tmp / "back").save(step, (back[0], (step_t, back[1], back[2])), blocking=True)
    return run_training(TrainLoopConfig(steps=4, ckpt_dir=str(tmp / "two"), resume=True, **RUN),
                        mesh=mesh)


def _rank(rank: int, world: int, tmp: str) -> None:
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
        with open(tmp / "ref.pkl", "rb") as f:
            ref = pickle.load(f)
        out = dict(steps=_sharded_steps(ref, mesh), run=_checkpoints(tmp, mesh, rank))
        with open(tmp / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp / "ref.pkl")],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr
    whole = run_training(TrainLoopConfig(steps=4, ckpt_dir=str(tmp / "one"), **RUN))
    (tmp / "two").mkdir()
    shutil.copytree(tmp / "one" / "step_00000002", tmp / "two" / "step_00000002")
    mp.spawn(_rank, args=(2, str(tmp)), nprocs=2)
    ranks = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(tmp / "ref.pkl", "rb") as f:
        return tmp, pickle.load(f), whole, ranks


def pairs(got, want):
    """(path, leaf of got, leaf of want), by path: the trees' dicts may hold
    their keys in different orders."""
    want = dict(tree_leaves_with_path(want))
    leaves = list(tree_leaves_with_path(got))
    assert sorted(p for p, _ in leaves) == sorted(want)
    return [(path, a, want[path]) for path, a in leaves]


def assert_scaled_close(got, want, rel):
    """Every leaf within ``rel`` × the largest |value| of ``want``."""
    top = max(float(w.abs().max()) for w in tree_leaves(want))
    for path, a, b in pairs(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=rel * top, err_msg=str(path))


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_step_matches_reference(runs, arch):
    _, ref, _, ranks = runs
    cfg = get_config(arch).smoke()
    for out in ranks:
        got = out["steps"][arch]
        assert got["microbatches"] == CASES[arch]
        full_numel = sum(t.numel() for t in tree_leaves(got["params"]))
        assert got["shard_numel"] < full_numel     # the ranks hold shards
        for mine, want in zip(got["metrics"], ref[arch]["steps"]):
            for key in ("loss", "ce_loss", "grad_norm"):
                np.testing.assert_allclose(mine[key], want["metrics"][key], rtol=1e-5, err_msg=key)
        last = ref[arch]["steps"][1]
        assert got["step"] == last["step"] == 2
        want = convert.model_params_from_jax(last["params"], cfg, "cpu")
        for path, a, b in pairs(got["params"], want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6, err_msg=str(path))
        state = reference_state(last, cfg)
        assert_scaled_close(got["mu"], state.mu, 1e-4)
        assert_scaled_close(got["nu"], state.nu, 1e-4)


def test_checkpoint_onto_two_ranks_and_back(runs):
    tmp, _, whole, ranks = runs
    cfg = get_config(RUN["arch"]).smoke()
    params = make_model(cfg, device="cpu").init(0)
    like = (params, tuple(optim.AdamW(cfg=cfg).init(params)))
    one, step = Checkpointer(tmp / "one").restore(2, like)
    back, back_step = Checkpointer(tmp / "back").restore(2, like)
    assert step == back_step == 2
    for a, b in zip(tree_leaves(one), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # run_training on the mesh resumes at step 2 and runs the one-rank run's steps
    run0, run1 = ranks[0]["run"], ranks[1]["run"]
    assert run0 == run1 and run0["steps"] == 2      # every rank returns the same result
    np.testing.assert_allclose(run0["losses"], whole["losses"][2:], rtol=1e-5)
    # and one rank resumes from the checkpoint the two wrote (step 4)
    rest = run_training(TrainLoopConfig(steps=5, ckpt_dir=str(tmp / "two"), resume=True,
                                        **dict(RUN, ckpt_every=100)))
    assert rest["steps"] == 1 and np.isfinite(rest["final_loss"])


def one_card_step(model, opt, params, state, batch, mb):
    """The one-card step, written out: the mean of the
    microbatches' gradients, clipped, then AdamW."""
    rows = batch["tokens"].shape[0] // mb
    gacc, macc = None, None
    for i in range(mb):
        piece = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(live)
        loss, metrics = model.loss_fn(tree_map(lambda _: next(it), params), piece, loss_chunk=CHUNK)
        grads = torch.autograd.grad(loss, live)
        if mb == 1:
            gacc = grads
            macc = {k: metrics[k].detach() for k in ("loss", "ce_loss")}
            break
        gacc = [torch.zeros_like(g) for g in grads] if gacc is None else gacc
        gacc = [a.add_(g / mb) for a, g in zip(gacc, grads)]
        macc = {k: (macc[k] if macc else 0.0) + metrics[k].detach() / mb for k in ("loss", "ce_loss")}
    it = iter(gacc)
    grads, gnorm = optim.clip_by_global_norm(tree_map(lambda _: next(it), params), GRAD_CLIP)
    updates, state = opt.update(grads, state, params, LR)
    return optim.AdamW.apply_updates(params, updates), state, dict(macc, grad_norm=gnorm)


@pytest.mark.parametrize("mb", [1, 2])
def test_one_device_mesh_is_the_one_card_step(mb):
    cfg = get_config("tinyllama-1.1b").smoke()
    model = make_model(cfg, device="cpu")
    params = model.init(0)
    opt = optim.AdamW(cfg=cfg)
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(cfg, 2).items()}
    step = make_train_step(model, opt, MeshRules(MeshShape((1, 1), ("data", "model")),
                                                 cfg.parallel),
                           InputShape("t", S, ROWS, "train"), lr=LR, loss_chunk=CHUNK,
                           microbatches=mb)
    assert step.dp == 1 and not hasattr(step, "group")      # no collective on one device
    assert step.shard(params) is params and step.gather(params) is params
    got = step(params, opt.init(params), batch)
    want = one_card_step(model, opt, params, opt.init(params), batch, mb)
    for a, b in zip(tree_leaves((got[0], got[1].mu, got[1].nu)),
                    tree_leaves((want[0], want[1].mu, want[1].nu))):
        assert torch.equal(a, b)
    assert all(torch.equal(got[2][k], want[2][k]) for k in ("loss", "ce_loss", "grad_norm"))


def test_elastic_restore_summary_matches_reference():
    from repro.checkpoint.elastic_restore import elastic_restore_summary as jax_summary
    from repro.core.elastic import ElasticMeshManager as JaxManager

    plans = []
    for manager in (ElasticMeshManager((4, 4), ("data", "model"), host_size=4),
                    JaxManager((4, 4), ("data", "model"), host_size=4)):
        manager.mark_failed(5)
        plans.append(manager.plan())
    got = elastic_restore_summary(plans[0], old_lr=3e-4)
    assert got == jax_summary(plans[1], old_lr=3e-4)
    assert got["new_mesh_shape"] == (3, 4) and got["needs_reshard"]


def test_unsupported_meshes_raise():
    shape = InputShape("t", S, ROWS, "train")
    for arch, mesh, error in (("tinyllama-1.1b", MeshShape((2, 1), ("data", "model")),
                               ValueError),):
        cfg = get_config(arch).smoke()
        with pytest.raises(error, match="DeviceMesh"):
            make_train_step(make_model(cfg, device="cpu"), optim.AdamW(cfg=cfg),
                            MeshRules(mesh, cfg.parallel), shape)
    cfg = get_config("tinyllama-1.1b").smoke()
    with pytest.raises(ValueError, match="does not split"):
        make_train_step(make_model(cfg, device="cpu"), optim.AdamW(cfg=cfg),
                        MeshRules(MeshShape((2, 1), ("data", "model")), cfg.parallel),
                        InputShape("t", S, 3, "train"))
