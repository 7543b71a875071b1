"""The port's collectives and gradient compression against the JAX package's.

``compressed_psum`` over 4 gloo ranks (spawned processes) against the
reference's over 4 forced host devices (a subprocess that writes its
output as ``.npy``): equal to 1e-6 relative, and each within 0.02 of the
exact sum (the reference test's bound).  The same spawn checks every
collective of ``Group`` against its definition on CPU tensors (where
nothing is staged) and counts the bytes handed to them.
``ef_compress_tree`` over 3 steps of residuals equals the reference's at
1e-7.
"""

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
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.optim import compression  # noqa: E402
from repro_torch.parallel.collectives import Group, compressed_psum  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
RANKS = 4


def rank_blocks():
    """Each rank's (64, 32) block, from a numpy seed."""
    return (0.01 * np.random.default_rng(0).standard_normal((RANKS, 64, 32))).astype(np.float32)


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
    sys.path.insert(0, %r)
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.parallel.collectives import compressed_psum
    from repro.parallel.compat import shard_map

    x = jnp.asarray(np.load(sys.argv[1]))
    mesh = jax.make_mesh((x.shape[0],), ("data",))
    f = lambda xb: compressed_psum(xb[0], "data")[None]
    with mesh:
        out = shard_map(f, mesh=mesh, in_specs=P("data"), out_specs=P("data"), check_vma=False)(x)
    np.save(sys.argv[2], np.asarray(out))
""") % (RANKS, str(SRC))


def _rank(rank: int, world: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        g = Group()
        x = torch.from_numpy(rank_blocks()[rank])
        out = {"compressed": compressed_psum(x, g),
               "exact": g.all_reduce(x.clone()),
               "sent_after_psums": g.sent_bytes}
        v = torch.arange(6, dtype=torch.float32) + 10 * rank
        out["all_gather"] = g.all_gather(v.reshape(2, 3))
        out["reduce_scatter"] = g.reduce_scatter(torch.stack([v + k for k in range(world)]))
        out["broadcast"] = g.broadcast(v.clone(), world - 1)
        out["max"] = g.all_reduce_float(float(rank), "max")
        if rank % 2 == 0:
            g.send(v, rank + 1)
        else:
            out["recv"] = g.recv(torch.empty(6), rank - 1)
        out["staged_bytes"] = g.staged_bytes
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    np.save(tmp / "x.npy", rank_blocks())
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp / "x.npy"), str(tmp / "ref.npy")],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr
    mp.spawn(_rank, args=(RANKS, f"file://{tmp}/rendezvous", str(tmp)), nprocs=RANKS)
    outs = []
    for r in range(RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return np.load(tmp / "ref.npy"), outs


def test_compressed_psum_matches_reference(runs):
    ref, outs = runs
    exact = rank_blocks().sum(axis=0)
    for r, out in enumerate(outs):
        got = out["compressed"].numpy()
        np.testing.assert_allclose(got, ref[r], rtol=1e-6, atol=1e-6 * np.abs(ref[r]).max())
        np.testing.assert_allclose(out["exact"].numpy(), exact, rtol=1e-5, atol=1e-7)
        rel = np.abs(got - exact).max() / max(np.abs(exact).max(), 1e-9)
        assert rel < 0.02, rel
        # the reference's int32 sum: as many bytes as the float32 one, plus a scale
        assert out["sent_after_psums"] == 4 + 2 * 64 * 32 * 4


def test_group_collectives(runs):
    _, outs = runs
    v = [torch.arange(6, dtype=torch.float32) + 10 * r for r in range(RANKS)]
    for r, out in enumerate(outs):
        assert torch.equal(out["all_gather"], torch.stack(v).reshape(RANKS, 2, 3))
        assert torch.equal(out["reduce_scatter"], sum(v) + RANKS * r)
        assert torch.equal(out["broadcast"], v[-1])
        assert out["max"] == RANKS - 1
        if r % 2:
            assert torch.equal(out["recv"], v[r - 1])
        assert out["staged_bytes"] == 0      # CPU tensors are never staged


def test_one_rank_group_is_the_identity():
    g = Group()
    x = torch.randn(3, 4)
    assert g.size == 1 and g.all_reduce(x) is x and torch.equal(g.all_gather(x)[0], x)
    assert torch.equal(g.reduce_scatter(x[None]), x) and g.sent_bytes == 0
    assert torch.equal(compressed_psum(x, g), compression.decompress(*compression.compress(x)))


def test_ef_compress_tree_matches_reference():
    import jax
    import jax.numpy as jnp

    from repro.optim import compression as jcompression

    rng = np.random.default_rng(5)
    shapes = {"a": (6, 5), "b": [(7,), (3, 2, 2)]}

    def draw():
        return {"a": rng.standard_normal(shapes["a"]).astype(np.float32) * 0.1,
                "b": [rng.standard_normal(s).astype(np.float32) for s in shapes["b"]]}

    grads = [draw() for _ in range(3)]
    as_torch = lambda t: {"a": torch.from_numpy(t["a"]), "b": [torch.from_numpy(x) for x in t["b"]]}
    state = compression.init_state(as_torch(grads[0]))
    jstate = jcompression.init_state(jax.tree.map(jnp.asarray, grads[0]))
    for g in grads:
        deq, state = compression.ef_compress_tree(as_torch(g), state)
        jdeq, jstate = jcompression.ef_compress_tree(jax.tree.map(jnp.asarray, g), jstate)
        for got, want in zip(jax.tree.leaves((deq, state.residual), is_leaf=torch.is_tensor),
                             jax.tree.leaves((jdeq, jstate.residual))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7, atol=1e-7)
