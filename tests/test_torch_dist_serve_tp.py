"""The port's prefill and decode steps on a (2, 2) mesh (slice F3a) against the JAX package's.

Four gloo ranks (spawned processes, one spawn for the file) run
``make_prefill_step`` and then ``make_decode_step`` on a (2, 2)
``("data", "model")`` mesh from the reference's parameters (carried
across with ``convert``), and are held to the reference's own steps,
jitted with their shardings on a (2, 2) mesh of 4 forced host devices
with ``AxisType.Auto`` axes (a subprocess that pickles its numbers).
Every case of ``test_torch_dist_train_tp.CASES`` (every family,
sequence parallelism and ``replicate_kv`` included) runs at its smoke
config with a batch of 4 rows (2 a data shard), an 8-token prompt and
caches of 16 rows, and one more case runs a 7-token prompt under
sequence parallelism, which the model size does not divide.  Each
holds, at the model tests' 2e-4:

* the prefill's logits: each rank's block (its rows, its half of the
  vocabulary) against the reference's;
* the caches after the prefill and after the last decode step, each
  rank's placed at its rows and at the columns its model rank keeps
  (``attention.head_layout``'s kv heads, ``rglru.state_features``),
  against the reference's through ``convert.caches_from_jax``;
* 4 greedy decode steps: each side feeds its own greedy tokens, which
  must be equal, and the logits;
* K4's and K5's calls a rank: one K4 call a self- or cross-attention
  layer in the prefill, on the rank's heads, and a cross layer's at
  each decode step; one K5 call an SSD layer in the prefill.
"""

import copy
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models.attention import KVCache, head_layout  # noqa: E402
from repro_torch.models.model_factory import greedy_tokens  # noqa: E402
from repro_torch.models.rglru import RGLRUState, state_features  # noqa: E402
from repro_torch.models.ssm import SSMState  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402
from repro_torch.parallel.mesh_rules import MeshRules  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402
from test_torch_dist_train_tp import CASES, MESH, configure, init_rank, k4_heads, spawn  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
ROWS, PROMPT, MAX_LEN, STEPS = 4, 8, 16, 4
TOL = dict(rtol=2e-4, atol=2e-4)
# name: (arch, overrides of the smoke config and its parallel config, prompt length)
SERVE_CASES = {name: (arch, over, PROMPT) for name, (arch, over, _) in CASES.items()}
SERVE_CASES["tinyllama-1.1b sp 7-token prompt"] = ("tinyllama-1.1b",
                                                   {"sequence_parallel": True}, 7)


def serve_config(name):
    arch, over, _ = SERVE_CASES[name]
    return configure(get_config(arch).smoke(), over)


def numpy_inputs(cfg, prompt):
    """The prompt batch (and the source of the encdec and vlm families)."""
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, prompt)).astype(np.int32)}
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
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.launch.steps import make_decode_step, make_prefill_step
    from repro.models import make_model
    from repro.parallel.mesh_rules import MeshRules
    from test_torch_dist_serve_tp import (MAX_LEN, MESH, ROWS, SERVE_CASES, STEPS, configure,
                                          numpy_inputs)

    def plain(t):
        # the caches' NamedTuples as dicts of numpy arrays: the ranks import no jax
        if hasattr(t, "_asdict"):
            return {k: plain(v) for k, v in t._asdict().items()}
        if isinstance(t, dict):
            return {k: plain(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [plain(v) for v in t]
        return np.asarray(t)

    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for name in sys.argv[2:]:
        arch, over, prompt = SERVE_CASES[name]
        cfg = configure(get_config(arch).smoke(), over)
        model = make_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        if cfg.family == "vlm":   # the cross gates start at 0, which hides the cross path
            params = dict(params, blocks=[
                dict(b, gate_attn=jnp.full_like(b["gate_attn"], 0.5),
                     gate_mlp=jnp.full_like(b["gate_mlp"], 0.5)) if "gate_attn" in b else b
                for b in params["blocks"]])
        rules = MeshRules(mesh, cfg.parallel)
        prefill = make_prefill_step(model, rules, InputShape("p", MAX_LEN, ROWS, "prefill")).jit()
        decode = make_decode_step(model, rules, InputShape("d", MAX_LEN, ROWS, "decode")).jit()
        batch = {k: jnp.asarray(v) for k, v in numpy_inputs(cfg, prompt).items()}
        with mesh:
            logits, caches = prefill(params, batch)
            rec = dict(params0=plain(params), logits=[np.asarray(logits)], tokens=[],
                       caches=[plain(caches)])
            for i in range(STEPS):
                tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
                rec["tokens"].append(tok)
                pos = np.full((ROWS, 1), prompt + i, np.int32)
                # the step donates its caches (read above, before the first step)
                logits, caches = decode(params, jnp.asarray(tok[:, None]), jnp.asarray(pos),
                                        caches)
                rec["logits"].append(np.asarray(logits))
            rec["caches"].append(plain(caches))
        out[name] = rec
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""") % (str(SRC), str(TESTS))


def reference(tmp: Path, names) -> dict:
    """The reference's prefill and decode steps of each case on its (2, 2) mesh."""
    out = tmp / "ref.pkl"
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(out), *names],
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


def served(ref, mesh, name) -> dict:
    """One case on this rank: the logits blocks of the prefill and of each
    decode step, the greedy tokens (every row), this rank's caches after
    the prefill and after the last step with the columns its model rank
    keeps of them, and the kernel calls of each call of the steps."""
    import repro_torch.models.attention as attention
    import repro_torch.models.ssm as ssm

    calls = []
    k4, k5 = attention.flash_attention, ssm.ssd_scan

    def k4_recorded(q, k, v, **kw):
        calls.append(("k4", q.shape[2], k.shape[2]))
        return k4(q, k, v, **kw)

    def k5_recorded(*args, **kw):
        calls.append(("k5",))
        return k5(*args, **kw)

    attention.flash_attention, ssm.ssd_scan = k4_recorded, k5_recorded
    try:
        cfg = serve_config(name)
        prompt = SERVE_CASES[name][2]
        model = make_model(cfg, device="cpu")
        rules = MeshRules(mesh, cfg.parallel)
        prefill = make_prefill_step(model, rules, InputShape("p", MAX_LEN, ROWS, "prefill"))
        decode = make_decode_step(model, rules, InputShape("d", MAX_LEN, ROWS, "decode"))
        shards = prefill.shard(convert.model_params_from_jax(ref[name]["params0"], cfg, "cpu"))
        batch = {k: torch.from_numpy(v) for k, v in numpy_inputs(cfg, prompt).items()}
        groups = (prefill.tp.group, prefill.group)

        def sent():
            return [g.sent_bytes for g in groups]

        before = sent()
        logits, caches = prefill(shards, batch)
        sent_bytes = [[b - a for a, b in zip(before, sent())]]     # (model, data) a call
        tp, hd = prefill.tp, cfg.head_dim
        lru = state_features(cfg, tp)
        # the decode step updates the caches in place: keep the prefill's
        out = dict(logits=[logits], tokens=[], caches=[copy.deepcopy(caches)],
                   calls=[list(calls)], columns=dict(
                       kv=[h * hd + i for h in head_layout(cfg, tp).kv for i in range(hd)],
                       lru=list(range(lru.start, lru.stop))))
        for i in range(STEPS):
            calls.clear()
            mine = greedy_tokens(logits, prefill.tp)                    # this data shard's rows
            tok = torch.cat(prefill.group.all_gather(mine).unbind(0))   # every row
            out["tokens"].append(tok)
            pos = torch.full((ROWS, 1), prompt + i, dtype=torch.int32)
            before = sent()
            logits, caches = decode(shards, tok[:, None].int(), pos, caches)
            sent_bytes.append([b - a for a, b in zip(before, sent())])
            out["logits"].append(logits)
            out["calls"].append(list(calls))
        out["caches"].append(caches)
        out["sent_bytes"] = sent_bytes
        return out
    finally:
        attention.flash_attention, ssm.ssd_scan = k4, k5


def _rank(rank: int, world: int, tmp: str) -> None:
    tmp = Path(tmp)
    mesh = init_rank(rank, world, tmp)
    try:
        with open(tmp / "ref.pkl", "rb") as f:
            ref = pickle.load(f)
        out = dict(rank=rank, coordinate=list(mesh.get_coordinate()),
                   cases={name: served(ref, mesh, name) for name in SERVE_CASES})
        with open(tmp / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_serve_tp")
    ref = reference(tmp, list(SERVE_CASES))
    return ref, spawn(_rank, tmp)


def block(full: np.ndarray, coordinate) -> np.ndarray:
    """A rank's block of (ROWS, V) logits: its data shard's rows, its model
    rank's columns."""
    d, m = coordinate
    rows, cols = full.shape[0] // MESH[0], full.shape[1] // MESH[1]
    return full[d * rows:(d + 1) * rows, m * cols:(m + 1) * cols]


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_prefill_logits_match_reference(runs, name):
    ref, ranks = runs
    for r in ranks:
        got = r["cases"][name]["logits"][0]
        assert got.shape == (ROWS // MESH[0], serve_config(name).padded_vocab // MESH[1])
        np.testing.assert_allclose(got.numpy(), block(ref[name]["logits"][0], r["coordinate"]),
                                   **TOL, err_msg=name)


def gathered(ranks, name, when):
    """The one-rank caches of the ranks' caches of case ``name`` (``when``
    0 after the prefill, 1 after the last decode step): each rank's
    placed at its data shard's rows, and a KV cache's or an RG-LRU
    state's columns at those its model rank keeps (the SSD state is
    whole on every model rank)."""
    cfg = serve_config(name)
    parts = []      # (rank's caches, its rows, its columns)
    for r in ranks:
        per = ROWS // MESH[0]
        d = r["coordinate"][0]
        case = r["cases"][name]
        parts.append((case["caches"][when], slice(d * per, (d + 1) * per), case["columns"]))

    def one(leaves, width=None, kind=None):
        """Every rank's leaf placed at its rows (and its ``kind`` columns of
        a last dim of ``width``)."""
        t = leaves[0][0]
        shape = [ROWS, *t.shape[1:]]
        if width is not None:
            shape[-1] = width
        full = torch.empty(shape, dtype=t.dtype)
        for leaf, rows, columns in leaves:
            if width is None:
                full[rows] = leaf
            else:
                full[rows].index_copy_(-1, torch.tensor(columns[kind]), leaf)
        return full

    def cache(cs):
        c = cs[0][0]
        field = lambda f: [(getattr(x, f), rows, cols) for x, rows, cols in cs]  # noqa: E731
        if isinstance(c, dict):
            return {k: cache([(x[k], rows, cols) for x, rows, cols in cs]) for k in c}
        if isinstance(c, RGLRUState):
            lw = cfg.lru_width or cfg.d_model
            return RGLRUState(conv=one(field("conv"), lw, "lru"), h=one(field("h"), lw, "lru"))
        if isinstance(c, KVCache):
            return KVCache(k=one(field("k"), cfg.kv_dim, "kv"), v=one(field("v"), cfg.kv_dim, "kv"),
                           length=one(field("length")))
        assert isinstance(c, SSMState)
        return SSMState(conv=one(field("conv")), h=one(field("h")))

    return [cache([(caches[i], rows, cols) for caches, rows, cols in parts])
            for i in range(len(parts[0][0]))]


def _cache_leaves(caches):
    return list(tree_leaves_with_path(
        [dataclasses.asdict(c) if dataclasses.is_dataclass(c) else
         {k: dataclasses.asdict(v) for k, v in c.items()} for c in caches]))


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_gathered_caches_match_reference(runs, name):
    ref, ranks = runs
    cfg = serve_config(name)
    for when in (0, 1):        # after the prefill, after the last decode step
        want = dict(_cache_leaves(convert.caches_from_jax(ref[name]["caches"][when], cfg, "cpu")))
        leaves = _cache_leaves(gathered(ranks, name, when))
        assert sorted(p for p, _ in leaves) == sorted(want)
        for path, a in leaves:
            b = want[path]
            assert a.shape == b.shape and a.dtype == b.dtype, (name, path)
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL,
                                       err_msg=f"{name} {when} {path}")


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_greedy_decode_matches_reference(runs, name):
    ref, ranks = runs
    for r in ranks:
        got = r["cases"][name]
        for i in range(STEPS):
            np.testing.assert_array_equal(got["tokens"][i].numpy(), ref[name]["tokens"][i],
                                          err_msg=f"{name} step {i}")
            np.testing.assert_allclose(got["logits"][i + 1].numpy(),
                                       block(ref[name]["logits"][i + 1], r["coordinate"]),
                                       **TOL, err_msg=f"{name} step {i}")


def kernel_calls(cfg):
    """(K4 calls, K5 calls) of a prefill and of a decode step on one rank."""
    if cfg.family == "encdec":
        return (cfg.encoder_layers + 2 * cfg.num_layers, 0), (cfg.num_layers, 0)
    kinds = layer_kinds(cfg)
    attn = sum(kind in ("attn", "moe") for kind in kinds)
    cross = kinds.count("cross")
    return (attn + 2 * cross, kinds.count("ssd")), (cross, 0)


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_kernel_calls_a_rank(runs, name):
    _, ranks = runs
    cfg = serve_config(name)
    (k4_prefill, k5_prefill), (k4_decode, _) = kernel_calls(cfg)
    for r in ranks:
        calls = r["cases"][name]["calls"]
        for i, each in enumerate(calls):
            k4 = [c[1:] for c in each if c[0] == "k4"]
            k5 = [c for c in each if c[0] == "k5"]
            assert len(k4) == (k4_prefill if i == 0 else k4_decode), (name, i)
            assert len(k5) == (k5_prefill if i == 0 else 0), (name, i)
            assert set(k4) <= {k4_heads(cfg)}, (name, i, set(k4))


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_shape_groups_count_what_the_ranks_sent(runs, name):
    """The dry-run's one rank on meta tensors over shape-only groups hands
    each group, a prefill and a decode step, the bytes that each gloo rank's
    groups counted in the same calls (``Group.sent_bytes``), to the byte."""
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.launch.mesh import make_test_mesh

    _, ranks = runs
    cfg = serve_config(name)
    prompt = SERVE_CASES[name][2]
    mesh = make_test_mesh(MESH, ("data", "model"))
    want = [r["cases"][name]["sent_bytes"] for r in ranks]
    prefill = dry_run(cfg, InputShape("p", MAX_LEN, ROWS, "prefill"), mesh, prompt=prompt)
    decode = dry_run(cfg, InputShape("d", MAX_LEN, ROWS, "decode"), mesh)
    got = [[prefill["collective_bytes_by_group"][g] for g in ("model", "data")],
           [decode["collective_bytes_by_group"][g] for g in ("model", "data")]]
    for each in want:
        assert each[:2] == got, (name, each[:2], got)
        assert all(step == each[1] for step in each[1:]), name   # every decode step alike
