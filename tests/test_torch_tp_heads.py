"""A split that cuts a query head, on a model axis of four (threads of one process).

The smoke tinyllama with 6 query heads and 2 kv heads of 4 columns
each: four model ranks split ``wq``'s 24 columns into blocks of 6, each
a head and a half.  Each rank then gathers ``wq``, ``wo`` and the kv
leaves, computes every head, and hands on a quarter of the whole
product.  Four threads (``ThreadGroup``, a group that meets at a
barrier) hold, with and without sequence parallelism: the training loss
(the vocab-parallel cross-entropy) and every leaf's gradient on each
rank's block; and a prefill and 3 greedy decode steps, whose logits are
each rank's block of the vocabulary and whose caches hold every kv
head.  They are held against the one-process model at 1e-5, and, from
the reference's parameters (carried across with ``convert``), against
the JAX package's GSPMD at the model tests' 2e-4: its loss and
gradients jitted with the rules' shardings, and its
``make_prefill_step`` / ``make_decode_step``, on a (1, 4) mesh of 4
forced host devices with ``AxisType.Auto`` axes (a subprocess that
pickles its numbers).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models.attention import head_layout  # noqa: E402
from repro_torch.models.model_factory import greedy_tokens  # noqa: E402
from repro_torch.parallel.mesh_rules import MeshRules, MeshShape, axes_leaves  # noqa: E402
from repro_torch.parallel.tensor_parallel import TensorParallel  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402
from test_torch_dist_train_tp import ThreadGroup  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
RANKS, ROWS, S, MAX_LEN, STEPS = 4, 2, 8, 16, 3
TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-4)


def config(sp=False, get=get_config):
    """The cut-head config (of the package whose ``get_config`` is ``get``)."""
    cfg = get("tinyllama-1.1b").smoke().replace(num_heads=6, num_kv_heads=2, head_dim=4)
    return cfg.replace(parallel=dataclasses.replace(cfg.parallel, sequence_parallel=sp))


def thread_tp(rules, rank, shared) -> TensorParallel:
    tp = TensorParallel.__new__(TensorParallel)
    tp.rules, tp.group, tp.size, tp.rank = rules, ThreadGroup(rank, RANKS, shared), RANKS, rank
    tp.sp = "model" in rules.rules["act_seq"]
    tp.data, tp.layouts = None, {}
    return tp


def on_threads(cfg, work, params=None):
    """``work(tp, this rank's parameter blocks, the block index of each
    leaf)`` on four threads, each a rank of a (1, 4) mesh, from ``params``
    (else the seed's); their results."""
    rules = MeshRules(MeshShape((1, RANKS), ("data", "model")), cfg.parallel)
    model = make_model(cfg, device="cpu")
    if params is None:
        params = model.init(0)
    shared = ([None] * RANKS, threading.Barrier(RANKS))
    out, errors = [None] * RANKS, []

    def rank(r):
        try:
            tp = thread_tp(rules, r, shared)
            at = {path: rules.local_slice(rules.spec(axes, tuple(p.shape)), tuple(p.shape),
                                          {"data": 0, "model": r})
                  for axes, (path, p) in zip(axes_leaves(model.param_specs()),
                                             tree_leaves_with_path(params))}
            mine = tree_map(lambda p: p, params)
            for path, _ in tree_leaves_with_path(params):
                node = mine
                for key in path[:-1]:
                    node = node[key]
                node[path[-1]] = node[path[-1]][at[path]].clone()
            out[r] = work(model, tp, mine, at)
        except BaseException as e:     # a thread's failure fails the test
            errors.append(e)
            shared[1].abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(RANKS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return model, params, out


def numpy_batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (ROWS, S + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": (rng.random((ROWS, S)) > 0.2).astype(np.float32)}


def batch_of(cfg):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in numpy_batch(cfg).items()}


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
    from repro.launch.steps import batch_shardings, make_decode_step, make_prefill_step
    from repro.models import make_model
    from repro.parallel.mesh_rules import MeshRules, use_rules
    from test_torch_tp_heads import MAX_LEN, RANKS, ROWS, S, STEPS, config, numpy_batch

    def plain(t):
        # the caches' NamedTuples as dicts of numpy arrays
        if hasattr(t, "_asdict"):
            return {k: plain(v) for k, v in t._asdict().items()}
        if isinstance(t, dict):
            return {k: plain(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [plain(v) for v in t]
        return np.asarray(t)

    mesh = jax.make_mesh((1, RANKS), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for sp in (False, True):
        cfg = config(sp, get_config)
        model = make_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        rules = MeshRules(mesh, cfg.parallel)
        p_sh = rules.tree_shardings(model.param_specs(), model.abstract_params())
        b_sh = batch_shardings(model, InputShape("t", S, ROWS, "train"), rules)

        def loss_and_grads(params, batch):
            with use_rules(rules):
                return jax.value_and_grad(
                    lambda p: model.loss_fn(p, batch, loss_chunk=0)[0])(params)

        fn = jax.jit(loss_and_grads, in_shardings=(p_sh, b_sh), out_shardings=(None, p_sh))
        batch = {k: jnp.asarray(v.astype(np.float32 if k == "mask" else np.int32))
                 for k, v in numpy_batch(cfg).items()}
        prefill = make_prefill_step(model, rules, InputShape("p", MAX_LEN, ROWS, "prefill")).jit()
        decode = make_decode_step(model, rules, InputShape("d", MAX_LEN, ROWS, "decode")).jit()
        with mesh:
            loss, grads = fn(params, batch)
            logits, caches = prefill(params, {"tokens": batch["tokens"]})
            rec = dict(params0=plain(params), loss=float(loss), grads=plain(grads),
                       logits=[np.asarray(logits)], tokens=[])
            for i in range(STEPS):
                tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
                rec["tokens"].append(tok)
                pos = np.full((ROWS, 1), S + i, np.int32)
                logits, caches = decode(params, jnp.asarray(tok[:, None]), jnp.asarray(pos),
                                        caches)
                rec["logits"].append(np.asarray(logits))
            rec["caches"] = plain(caches)
        out[sp] = rec
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""") % (str(SRC), str(TESTS))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's loss, gradients, prefill and decode of the cut-head
    config on its (1, 4) mesh, without and with sequence parallelism."""
    out = tmp_path_factory.mktemp("tp_heads") / "ref.pkl"
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(out)], capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


def test_heads_of_a_cut_split_are_every_head():
    cfg = config()
    tp = thread_tp(MeshRules(MeshShape((1, RANKS), ("data", "model")), cfg.parallel), 1,
                   ([None] * RANKS, threading.Barrier(RANKS)))
    assert tp.heads(6) == (0, 6) and tp.heads(8) == (2, 2)
    layout = head_layout(cfg, tp)
    assert layout.q_whole and layout.kv_whole and layout.kv == (0, 1)


def train_on_threads(cfg, params=None):
    """(model, params, each rank's (loss, {path: gradient block}, {path:
    block index})) of one loss and backward on the threads."""
    batch = batch_of(cfg)

    def work(model, tp, mine, at):
        live = tree_map(lambda p: p.detach().requires_grad_(True), mine)
        loss, _ = model.loss_fn(live, batch, loss_chunk=0, tp=tp)
        loss.backward()
        return float(loss.detach()), {path: p.grad for path, p in tree_leaves_with_path(live)}, at

    return on_threads(cfg, work, params)


def hold_training(out, loss, full, sp, tol):
    """Each rank's loss and gradient blocks against the whole ``loss`` and
    gradients ``full`` ({path: gradient})."""
    for got_loss, _, _ in out:
        np.testing.assert_allclose(got_loss, loss, rtol=tol["rtol"])
    for path, g in full.items():
        blocks = [(grads[path], at[path]) for _, grads, at in out]
        if sp and blocks[0][0].shape == g.shape:     # partial over the sequence shards: summed by the step
            torch.testing.assert_close(sum(b for b, _ in blocks), g, **tol, msg=str(path))
            continue
        for b, sl in blocks:
            torch.testing.assert_close(b, g[sl], **tol, msg=str(path))


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_cut_query_head_forward_and_gradients_match_one_rank(sp):
    cfg = config(sp)
    model, params, out = train_on_threads(cfg)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss_fn(live, batch_of(cfg), loss_chunk=0)
    loss.backward()
    hold_training(out, float(loss.detach()),
                  {path: p.grad for path, p in tree_leaves_with_path(live)}, sp, TOL)


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_cut_query_head_forward_and_gradients_match_reference(reference, sp):
    cfg, rec = config(sp), reference[sp]
    _, _, out = train_on_threads(cfg, convert.model_params_from_jax(rec["params0"], cfg, "cpu"))
    grads = convert.model_params_from_jax(rec["grads"], cfg, "cpu")
    hold_training(out, rec["loss"], dict(tree_leaves_with_path(grads)), sp, REF_TOL)


def serve(model, params, prompt, tp=None):
    """A prefill of ``prompt`` and ``STEPS`` greedy decode steps: the
    logits of each call, the tokens fed and the caches after the last."""
    logits, caches = model.prefill(params, prompt, MAX_LEN, tp=tp)
    got = dict(logits=[logits], tokens=[])
    for i in range(STEPS):
        tok = greedy_tokens(logits, tp)
        got["tokens"].append(tok)
        pos = torch.full((ROWS, 1), S + i, dtype=torch.int32)
        logits, caches = model.decode_step(params, tok[:, None], pos, caches, tp=tp)
        got["logits"].append(logits)
    got["caches"] = [dataclasses.asdict(c) for c in caches]
    return got


def hold_serving(out, want, tol):
    """Each rank's logits blocks, tokens and (whole) caches against the
    whole run's ``want`` (numpy or torch leaves)."""
    cols = want["logits"][0].shape[1] // RANKS
    for r, got in enumerate(out):
        for a, b in zip(got["logits"], want["logits"]):
            torch.testing.assert_close(a, torch.as_tensor(b)[:, r * cols:(r + 1) * cols], **tol)
        for a, b in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        got_leaves, want_leaves = tree_leaves(got["caches"]), tree_leaves(want["caches"])
        assert len(got_leaves) == len(want_leaves)
        for a, b in zip(got_leaves, want_leaves):
            torch.testing.assert_close(a, torch.as_tensor(b), **tol)    # every kv head on every rank


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_cut_query_head_prefill_and_decode_match_one_rank(sp):
    cfg = config(sp)
    prompt = batch_of(cfg)["tokens"]
    model, params, out = on_threads(cfg, lambda model, tp, mine, at: serve(model, mine, prompt,
                                                                           tp))
    hold_serving(out, serve(model, params, prompt), TOL)


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_cut_query_head_prefill_and_decode_match_reference(reference, sp):
    cfg, rec = config(sp), reference[sp]
    prompt = batch_of(cfg)["tokens"]
    _, _, out = on_threads(cfg, lambda model, tp, mine, at: serve(model, mine, prompt, tp),
                           convert.model_params_from_jax(rec["params0"], cfg, "cpu"))
    caches = convert.caches_from_jax(rec["caches"], cfg, "cpu")
    hold_serving(out, dict(rec, caches=[dataclasses.asdict(c) for c in caches]), REF_TOL)
