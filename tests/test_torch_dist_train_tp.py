"""The port's tensor and sequence parallelism (slice F2) against the JAX package's.

Four gloo ranks (spawned processes, one spawn for the file) run the
sharded train step on a (2, 2) ``("data", "model")`` mesh from the
reference's parameters (carried across with ``convert``), and are held
to the reference's ``make_train_step`` on a (2, 2) mesh of 4 forced host
devices with ``AxisType.Auto`` axes (a subprocess that pickles its
numbers), at ``test_torch_dist_train.py``'s tolerances: ``loss``,
``ce_loss`` and ``grad_norm`` of three steps at rtol 1e-5, the
parameters after the third step (taken from the reference's state after
the second) at atol 1e-6, the moments at 1e-4 of their largest value
(``ROUNDED`` and ``ZERO_GRADIENT`` below say where rounding alone
decides a value).  The batches' masks are random.  Every rank holds only its block of each leaf, and K4 runs on the
rank's heads (the counts of every call are recorded).

This file holds the dense and SSM cases (tinyllama-1.1b with 2
microbatches, with ``sequence_parallel``, with ``replicate_kv``: the keys
and values computed whole on every rank give the same numbers,
mamba2-130m), RG-LRU's gathered form on three threads, the checkpoint
round trip (one rank → (2, 2) → one rank, bitwise, ``run_training``
resuming on the mesh) and the collectives that carry gradients, with the
vocab-parallel cross-entropy, on the model axis's groups of two ranks
against the one-process math.  ``test_torch_dist_train_tp_moe.py`` and
``test_torch_dist_train_tp_families.py`` hold the other families, with
this file's helpers.
"""

import dataclasses
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
from repro_torch.checkpoint import Checkpointer, reshard_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import TrainLoopConfig, run_training  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models.layers import cross_entropy_loss  # noqa: E402
from repro_torch.parallel.mesh_rules import MeshRules, axes_leaves  # noqa: E402
from repro_torch.parallel.tensor_parallel import TensorParallel  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
MESH = (2, 2)
S, ROWS, CHUNK, LR = 16, 4, 8, 1e-3
# one batch a step; the parameters and moments are compared after the last
# step, taken from the reference's state after the one before
SEEDS = (2, 3, 4)
# name: (arch, overrides of the smoke config and its parallel config, microbatches
# (None: the config's, cut to what the batch splits into))
CASES = {
    "tinyllama-1.1b": ("tinyllama-1.1b", {}, 2),
    "tinyllama-1.1b sp": ("tinyllama-1.1b", {"sequence_parallel": True}, 1),
    "tinyllama-1.1b replicate_kv": ("tinyllama-1.1b", {"replicate_kv": True}, 1),
    "mamba2-130m": ("mamba2-130m", {}, 1),
    "qwen3-moe-30b-a3b local": ("qwen3-moe-30b-a3b", {}, 1),
    "qwen3-moe-30b-a3b gspmd": ("qwen3-moe-30b-a3b", {"moe_dispatch": "gspmd"}, 1),
    "qwen3-moe-30b-a3b 3 experts": ("qwen3-moe-30b-a3b", {"num_experts": 3}, 1),
    "grok-1-314b": ("grok-1-314b", {"grad_accum_dtype": "float32"}, None),
    "grok-1-314b bf16 accumulation": ("grok-1-314b", {}, None),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}, 1),
    "whisper-large-v3": ("whisper-large-v3", {}, 1),
    "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {}, None),
}
# grok-1-314b's own config sums its microbatches' gradients in bfloat16:
# each piece's float32 sum is rounded to 8 bits, so a 1e-7 difference
# between the two programs' sums moves an element across a rounding
# boundary now and then (0.4 % of it), which the moments and AdamW pass
# on.  That case is held on its losses and grad_norm (a few flipped
# elements move the norm by far less than 1e-5); its parameters and
# moments are held with the sum in float32 (the case above), where the
# rest of grok's config is the same
ROUNDED = ("grok-1-314b bf16 accumulation",)
# a key bias's true gradient is zero (softmax ignores a shift common to
# every key), so its computed value is rounding, different in the two
# programs, and AdamW's step normalises it: these leaves are held through
# their moments only
ZERO_GRADIENT = ("bk",)
HERE = ("tinyllama-1.1b", "tinyllama-1.1b sp", "tinyllama-1.1b replicate_kv", "mamba2-130m")
RUN = dict(arch="tinyllama-1.1b", global_batch=4, seq_len=32, lr=3e-3, ckpt_every=2,
           device="cpu")


def configure(cfg, over):
    """``cfg`` (either package's) with ``over``'s fields set on it or on its
    parallel config."""
    par = {k: v for k, v in over.items() if hasattr(cfg.parallel, k)}
    return cfg.replace(parallel=dataclasses.replace(cfg.parallel, **par),
                       **{k: v for k, v in over.items() if k not in par})


def case_config(name):
    arch, over, _ = CASES[name]
    return configure(get_config(arch).smoke(), over)


def numpy_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (ROWS, S + 1)).astype(np.int32)
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:],
                 mask=(rng.random((ROWS, S)) > 0.2).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((ROWS, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (ROWS, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


REFERENCE = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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
    from test_torch_dist_train_tp import (CASES, CHUNK, LR, MESH, ROWS, S, SEEDS, configure,
                                          numpy_batch)

    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    host = lambda t: jax.tree.map(np.asarray, t)
    out = {}
    for name in sys.argv[2:]:
        arch, over, mb = CASES[name]
        cfg = configure(get_config(arch).smoke(), over)
        model = make_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        if cfg.family == "vlm":   # the cross gates start at 0, which hides the cross path
            params = dict(params, blocks=[
                dict(b, gate_attn=jnp.full_like(b["gate_attn"], 0.5),
                     gate_mlp=jnp.full_like(b["gate_mlp"], 0.5)) if "gate_attn" in b else b
                for b in params["blocks"]])
        opt = optim.AdamW()
        state = opt.init(params)
        fn = make_train_step(model, opt, MeshRules(mesh, cfg.parallel),
                             InputShape("t", S, ROWS, "train"), lr=LR, loss_chunk=CHUNK,
                             microbatches=mb).jit()
        steps = []
        first = host(params)
        for seed in SEEDS:
            batch = {k: jnp.asarray(v) for k, v in numpy_batch(cfg, seed).items()}
            with mesh:  # the step donates its params and state: hand it copies
                params, state, metrics = fn(jax.tree.map(jnp.copy, params),
                                            jax.tree.map(jnp.copy, state), batch)
            steps.append(dict(params=host(params), step=int(state.step), mu=host(state.mu),
                              nu=host(state.nu), metrics={k: float(v) for k, v in metrics.items()}))
        out[name] = dict(params0=first, steps=steps)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""") % (str(SRC), str(TESTS))


def reference(tmp: Path, names) -> dict:
    """The reference's steps of each case on its (2, 2) mesh."""
    out = tmp / "ref.pkl"
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(out), *names],
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


def reference_state(ref_step, cfg):
    return convert.adamw_state_from_jax(types.SimpleNamespace(**ref_step), cfg, "cpu")


def sharded_steps(ref, mesh, names):
    """Per case: each step's metrics, the gathered parameters and moments
    after the last (taken from the reference's state after the one before),
    each leaf's block shape against its full shape and the slice the rules
    give, and the (query heads, kv heads) of every K4 call."""
    import repro_torch.models.attention as attention

    calls = []
    kernel = attention.flash_attention

    def recorded(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2]))
        return kernel(q, k, v, **kw)

    attention.flash_attention = recorded
    out = {}
    try:
        for name in names:
            cfg = case_config(name)
            opt = optim.AdamW(cfg=cfg)
            model = make_model(cfg, device="cpu")
            rules = MeshRules(mesh, cfg.parallel)
            step = make_train_step(model, opt, rules, InputShape("t", S, ROWS, "train"), lr=LR,
                                   loss_chunk=CHUNK, microbatches=CASES[name][2])
            full0 = convert.model_params_from_jax(ref[name]["params0"], cfg, "cpu")
            params = step.shard(full0)
            axes = dict(zip((p for p, _ in tree_leaves_with_path(model.abstract_params())),
                            axes_leaves(model.param_specs())))
            fulls = dict(tree_leaves_with_path(full0))
            blocks = {}
            for path, part in tree_leaves_with_path(params):     # by path: trees' orders differ
                shape = tuple(fulls[path].shape)
                spec = rules.spec(axes[path], shape)
                blocks[path] = (tuple(part.shape), shape,
                                tuple(fulls[path][rules.local_slice(spec, shape)].shape),
                                "model" in str(spec))
            state = opt.init(params)
            metrics = []
            calls.clear()
            for k, seed in enumerate(SEEDS):
                batch = {key: torch.from_numpy(v) for key, v in numpy_batch(cfg, seed).items()}
                new_params, new_state, m = step(params, state, batch)
                metrics.append({key: float(v) for key, v in m.items()})
                # both continue from the reference's state
                full = reference_state(ref[name]["steps"][k], cfg)
                params = step.shard(convert.model_params_from_jax(
                    ref[name]["steps"][k]["params"], cfg, "cpu"))
                state = optim.AdamWState(full.step, step.shard(full.mu), step.shard(full.nu))
            out[name] = dict(metrics=metrics, microbatches=step.microbatches,
                             params=step.gather(new_params), mu=step.gather(new_state.mu),
                             nu=step.gather(new_state.nu), step=int(new_state.step),
                             blocks=blocks, k4_calls=sorted(set(calls)))
    finally:
        attention.flash_attention = kernel
    return out


def spawn(rank_fn, tmp: Path):
    """Run ``rank_fn(rank, world, tmp)`` on the mesh's ranks; their pickles."""
    world = MESH[0] * MESH[1]
    mp.spawn(rank_fn, args=(world, str(tmp)), nprocs=world)
    ranks = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def init_rank(rank: int, world: int, tmp: Path):
    """This rank's process group and (2, 2) mesh (its file rendezvous)."""
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    return make_mesh(MESH, ("data", "model"), device_type="cpu")


def pairs(got, want):
    """(path, leaf of got, leaf of want), by path."""
    want = dict(tree_leaves_with_path(want))
    leaves = list(tree_leaves_with_path(got))
    assert sorted(p for p, _ in leaves) == sorted(want)
    return [(path, a, want[path]) for path, a in leaves]


def assert_scaled_close(got, want, rel):
    """Every leaf within ``rel`` × the largest |value| of ``want``."""
    top = max(float(w.abs().max()) for w in tree_leaves(want))
    for path, a, b in pairs(got, want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=0, atol=rel * top,
                                   err_msg=str(path))


def check_case(name, ref, ranks):
    """One case's ranks against the reference's steps."""
    cfg = case_config(name)
    for out in ranks:
        got = out["steps"][name]
        if CASES[name][2] is not None:
            assert got["microbatches"] == CASES[name][2]
        split = 0
        for path, (part, full, want, model_split) in got["blocks"].items():
            assert part == want, path                 # the rank's block of the mesh
            if model_split:
                split += 1
                assert np.prod(part) * MESH[1] <= np.prod(full), path
        assert split > 0
        for mine, want in zip(got["metrics"], ref[name]["steps"]):
            for key in ("loss", "ce_loss", "grad_norm"):
                np.testing.assert_allclose(mine[key], want["metrics"][key], rtol=1e-5,
                                           err_msg=f"{name} {key}")
        last = ref[name]["steps"][-1]
        assert got["step"] == last["step"] == len(SEEDS)
        want = convert.model_params_from_jax(last["params"], cfg, "cpu")
        for path, a, b in pairs(got["params"], want):
            if name not in ROUNDED and path[-1] not in ZERO_GRADIENT:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                           err_msg=f"{name} {path}")
        if name not in ROUNDED:
            state = reference_state(last, cfg)
            assert_scaled_close(got["mu"], state.mu, 1e-4)
            assert_scaled_close(got["nu"], state.nu, 1e-4)
    assert all(r["steps"][name]["k4_calls"] == ranks[0]["steps"][name]["k4_calls"]
               for r in ranks)
    return ranks[0]["steps"][name]


def k4_heads(cfg):
    """(query heads, kv heads) of every K4 call a rank of the model axis
    makes: its half of the query heads, with the kv heads they read (the
    GQA ratio kept)."""
    q = cfg.num_heads // MESH[1]
    return (q, max(1, q * cfg.num_kv_heads // cfg.num_heads))


# ---------------------------------------------------------------------------
# the collectives that carry gradients, on the model axis's two ranks
# ---------------------------------------------------------------------------
def weights(rank, shape, seed=7):
    """Rank ``rank``'s cotangent of a shape, from a numpy seed."""
    return torch.from_numpy(np.random.default_rng(seed + rank).standard_normal(shape)
                            .astype(np.float32))


def collectives_on(group, x):
    """Each Function's output and input gradient of ``x`` (this rank's
    (2, 4, 3) input), with the bytes the group counted in its backward."""
    from repro_torch.parallel.collectives import (copy_to, gather_seq, pmean, reduce_from,
                                                  scatter_seq)

    out = {}
    for name, fn in (("copy_to", copy_to), ("reduce_from", reduce_from),
                     ("gather_seq", gather_seq), ("scatter_seq", scatter_seq),
                     ("pmean", pmean)):
        live = x.clone().requires_grad_(True)
        y = fn(live, group)
        before = group.sent_bytes
        (y * weights(group.rank, tuple(y.shape))).sum().backward()
        out[name] = (y.detach(), live.grad, group.sent_bytes - before)
    return out


VOCAB, D = 64, 8


def vocab_problem():
    rng = np.random.default_rng(5)
    hidden = torch.from_numpy(rng.standard_normal((2, 6, D)).astype(np.float32))
    head = torch.from_numpy(rng.standard_normal((D, VOCAB)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, VOCAB, (2, 6)))
    mask = torch.from_numpy((rng.random((2, 6)) > 0.3).astype(np.float32))
    return hidden, head, labels, mask


def vocab_parallel_on(tp):
    """The vocab-parallel loss of this rank's half of the head, and the
    gradients of the hidden state and of that half."""
    from repro_torch.models.model_factory import _vocab_parallel_loss

    hidden, head, labels, mask = vocab_problem()
    h = hidden.clone().requires_grad_(True)
    w = head[:, tp.block(VOCAB)].clone().requires_grad_(True)
    loss = _vocab_parallel_loss(tp.enter(h), w, labels, mask, tp, chunk=3)
    loss.backward()
    return float(loss), h.grad, w.grad


def rank_main(rank: int, world: int, tmp: str, names, more=None) -> None:
    """One rank: the cases ``names`` against the reference's pickle, and
    ``more(tmp, mesh, rank)``'s readings; written to ``rank<r>.pkl``."""
    tmp = Path(tmp)
    mesh = init_rank(rank, world, tmp)
    try:
        with open(tmp / "ref.pkl", "rb") as f:
            ref = pickle.load(f)
        out = dict(rank=rank, steps=sharded_steps(ref, mesh, names))
        if more is not None:
            out.update(more(tmp, mesh, rank))
        with open(tmp / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _more(tmp: Path, mesh, rank: int) -> dict:
    from repro_torch.launch.mesh import make_mesh

    parallel = get_config("tinyllama-1.1b").smoke().parallel
    tp = TensorParallel(MeshRules(mesh, parallel))
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal((2, 4, 3))
                         .astype(np.float32))
    # the data group of a (pod, data, model) mesh: pod × data
    pods = MeshRules(make_mesh((2, 1, 2), ("pod", "data", "model"), device_type="cpu"),
                     parallel).data_group
    return dict(run=_checkpoints(tmp, mesh, rank), model_rank=tp.rank,
                collectives=collectives_on(tp.group, x), vocab=vocab_parallel_on(tp),
                pod_data_group=(dist.get_process_group_ranks(pods.pg),
                                float(pods.all_reduce(torch.tensor([float(rank)]))[0])))


def _rank(rank: int, world: int, tmp: str) -> None:
    rank_main(rank, world, tmp, HERE, _more)


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
    model_split = 0
    for tree, shard in zip((host_p, host_mu, host_nu), shards):
        for axes, full, part in zip(axes_leaves(specs), tree_leaves(tree), tree_leaves(shard)):
            spec = rules.spec(axes, tuple(full.shape))
            index = rules.local_slice(spec, tuple(full.shape))
            assert torch.equal(part, full[index]) and part.is_contiguous()
            model_split += "model" in str(spec)
    assert model_split > 0
    train_step = make_train_step(model, opt, rules, InputShape("t", RUN["seq_len"],
                                 RUN["global_batch"], "train"), loss_chunk=0, microbatches=1)
    back = [train_step.gather(s) for s in shards]
    if rank == 0:
        Checkpointer(tmp / "back").save(step, (back[0], (step_t, back[1], back[2])), blocking=True)
    return run_training(TrainLoopConfig(steps=4, ckpt_dir=str(tmp / "two"), resume=True, **RUN),
                        mesh=mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train_tp")
    ref = reference(tmp, HERE)
    whole = run_training(TrainLoopConfig(steps=4, ckpt_dir=str(tmp / "one"), **RUN))
    (tmp / "two").mkdir()
    shutil.copytree(tmp / "one" / "step_00000002", tmp / "two" / "step_00000002")
    return tmp, ref, whole, spawn(_rank, tmp)


@pytest.mark.parametrize("name", HERE)
def test_sharded_step_matches_reference(runs, name):
    _, ref, _, ranks = runs
    got = check_case(name, ref, ranks)
    assert got["k4_calls"] == ([] if name == "mamba2-130m" else [k4_heads(case_config(name))])


def test_checkpoint_onto_the_mesh_and_back(runs):
    tmp, _, whole, ranks = runs
    cfg = get_config(RUN["arch"]).smoke()
    params = make_model(cfg, device="cpu").init(0)
    like = (params, tuple(optim.AdamW(cfg=cfg).init(params)))
    one, step = Checkpointer(tmp / "one").restore(2, like)
    back, back_step = Checkpointer(tmp / "back").restore(2, like)
    assert step == back_step == 2
    for a, b in zip(tree_leaves(one), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    runs_ = [r["run"] for r in ranks]
    assert all(r == runs_[0] for r in runs_) and runs_[0]["steps"] == 2
    np.testing.assert_allclose(runs_[0]["losses"], whole["losses"][2:], rtol=1e-5)
    # one rank resumes from the checkpoint the four wrote (step 4)
    rest = run_training(TrainLoopConfig(steps=5, ckpt_dir=str(tmp / "two"), resume=True,
                                        **dict(RUN, ckpt_every=100)))
    assert rest["steps"] == 1 and np.isfinite(rest["final_loss"])


def test_groups_of_the_mesh_axes(runs):
    """Each rank's model group is the ranks of its data coordinate, and on a
    (2, 1, 2) ("pod", "data", "model") mesh its data group is the ranks of
    its model coordinate (pod × data)."""
    for r in runs[3]:
        m = r["rank"] % MESH[1]
        assert r["model_rank"] == m
        assert r["pod_data_group"] == ([m, m + 2], float(2 * m + 2))


def _group_pairs(ranks):
    """The ranks' outputs in pairs of one model group, by model rank."""
    groups = {}
    for k, r in enumerate(ranks):
        groups.setdefault(k // MESH[1], {})[r["model_rank"]] = r
    return [(g[0], g[1]) for g in groups.values()]


@pytest.mark.parametrize("name", ["copy_to", "reduce_from", "gather_seq", "scatter_seq",
                                  "pmean"])
def test_collective_carries_its_gradient(runs, name):
    ranks = runs[3]
    for pair in _group_pairs(ranks):
        x = [torch.from_numpy(np.random.default_rng(r["rank"]).standard_normal((2, 4, 3))
                              .astype(np.float32)) for r in pair]
        ys = [r["collectives"][name][0] for r in pair]
        gs = [r["collectives"][name][1] for r in pair]
        sent = [r["collectives"][name][2] for r in pair]
        w = [weights(k, tuple(ys[k].shape)) for k in range(2)]
        want_y = {"copy_to": x, "reduce_from": [x[0] + x[1]] * 2,
                  "gather_seq": [torch.cat(x, dim=1)] * 2,
                  "scatter_seq": list((x[0] + x[1]).chunk(2, dim=1)),
                  "pmean": [(x[0] + x[1]) / 2] * 2}[name]
        # the gradient of the sum of the ranks' losses, each rank's input's
        want_g = {"copy_to": [w[0] + w[1]] * 2, "reduce_from": w,
                  "gather_seq": list((w[0] + w[1]).chunk(2, dim=1)),
                  "scatter_seq": [torch.cat(w, dim=1)] * 2,
                  "pmean": [(w[0] + w[1]) / 2] * 2}[name]
        for k in range(2):
            torch.testing.assert_close(ys[k], want_y[k], rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(gs[k], want_g[k], rtol=1e-6, atol=1e-6)
            # the backward's collective is counted, in bytes (x is 96)
            assert sent[k] == {"copy_to": 96, "reduce_from": 0, "gather_seq": 192,
                               "scatter_seq": 48, "pmean": 96}[name]


def test_vocab_parallel_cross_entropy(runs):
    ranks = runs[3]
    hidden, head, labels, mask = vocab_problem()
    h = hidden.clone().requires_grad_(True)
    w = head.clone().requires_grad_(True)
    loss, _ = cross_entropy_loss(h @ w, labels, mask)
    loss.backward()
    for pair in _group_pairs(ranks):
        for k, r in enumerate(pair):
            got_loss, got_h, got_w = r["vocab"]
            np.testing.assert_allclose(got_loss, float(loss.detach()), rtol=1e-6)
            torch.testing.assert_close(got_h, h.grad, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(got_w, w.grad[:, k * VOCAB // 2:(k + 1) * VOCAB // 2],
                                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# RG-LRU's gathered form: a model axis of 3 does not divide its 8 gate blocks
# ---------------------------------------------------------------------------
class ThreadGroup:
    """Threads of one process standing in for the ranks of a group: each
    collective meets the others at a barrier and sums in rank order."""

    def __init__(self, rank, size, shared):
        self.rank, self.size, self.shared, self.sent_bytes = rank, size, shared, 0

    def _meet(self, t):
        slots, barrier = self.shared
        slots[self.rank] = t.detach().clone()
        barrier.wait()
        out = list(slots)
        barrier.wait()
        return out

    def all_reduce(self, t, op="sum"):
        parts = self._meet(t)
        total = parts[0]
        for part in parts[1:]:
            total = torch.maximum(total, part) if op == "max" else total + part
        return t.copy_(total)

    def all_gather(self, t):
        return torch.stack(self._meet(t))

    def reduce_scatter(self, t):
        parts = self._meet(t)
        return sum(part[self.rank] for part in parts[1:]) + parts[0][self.rank]


def test_rglru_gathered_over_a_model_axis_of_three():
    """With 3 model ranks each rank's ``lru`` features are not whole gate
    blocks, so the block gathers its ``lru`` leaves and runs the recurrence
    whole: three threads' outputs and gradients (each rank's block of a
    split leaf, the gathered input's) equal the one-process block's."""
    import threading
    import types

    from repro_torch.models import rglru
    from repro_torch.models.layers import param_layout
    from repro_torch.parallel.mesh_rules import MeshShape

    cfg = get_config("recurrentgemma-9b").smoke().replace(d_model=24)
    rules = MeshRules(MeshShape((1, 3), ("data", "model")), cfg.parallel)
    params = make_model(cfg, device="cpu").init(0)["layers"][0]["rec"]
    layout = param_layout(rglru.rglru_params, cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, 24)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 12, 24)).astype(np.float32))
    live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xs = x.clone().requires_grad_(True)
    want, _ = rglru.rglru_block(live, xs, cfg)
    (want * w).sum().backward()

    shared = ([None] * 3, threading.Barrier(3))
    out = [None] * 3

    def rank(r):
        from repro_torch.parallel.collectives import copy_to

        group = ThreadGroup(r, 3, shared)
        tp = TensorParallel.__new__(TensorParallel)
        tp.rules, tp.group, tp.size, tp.rank, tp.sp = rules, group, 3, r, False
        tp.layouts = {}
        coords = {"data": 0, "model": r}
        mine = {k: v[rules.local_slice(rules.spec(*layout[k]), layout[k][1], coords)]
                .clone().requires_grad_(True) for k, v in params.items()}
        xr = x.clone().requires_grad_(True)
        y, _ = rglru.rglru_block(mine, xr, cfg, tp=tp)
        (y * w).sum().backward()
        out[r] = (y.detach(), {k: v.grad for k, v in mine.items()}, xr.grad)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in range(3):
        y, grads, gx = out[r]
        torch.testing.assert_close(y, want.detach(), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gx, xs.grad, rtol=1e-5, atol=1e-6)
        coords = {"data": 0, "model": r}
        for k, g in grads.items():
            index = rules.local_slice(rules.spec(*layout[k]), layout[k][1], coords)
            torch.testing.assert_close(g, live[k].grad[index], rtol=1e-5, atol=1e-6,
                                       msg=lambda m, k=k: f"{k}: {m}")
