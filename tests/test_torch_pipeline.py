"""The port's GPipe schedule against the JAX package's.

``stage_partition`` equals the reference's; ``pipeline_apply`` over 4
gloo ranks (spawned processes), with the reference test's tanh layers (L
8, d 16, 6 microbatches of 4), equals the sequential oracle and the
reference's ``pipeline_apply`` over 4 pipeline stages of 8 forced host
devices (a subprocess), at 1e-5, on every rank.
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

from repro_torch.parallel.collectives import Group  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_apply, stage_partition  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
L, D, N_MICRO, B, STAGES = 8, 16, 6, 4, 4


def inputs():
    rng = np.random.default_rng(0)
    return {"w": (0.3 * rng.standard_normal((L, D, D))).astype(np.float32),
            "b": (0.1 * rng.standard_normal((L, D))).astype(np.float32),
            "x": rng.standard_normal((N_MICRO, B, D)).astype(np.float32)}


def layer_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, %r)
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.parallel.pipeline import pipeline_apply

    data = np.load(sys.argv[1])
    params = {"w": jnp.asarray(data["w"]), "b": jnp.asarray(data["b"])}
    mesh = jax.make_mesh((%d, 2), ("pod", "model"))
    layer_fn = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])
    with mesh:
        out = pipeline_apply(params, jnp.asarray(data["x"]), layer_fn, mesh, axis="pod")
    np.save(sys.argv[2], np.asarray(out))
""") % (str(SRC), STAGES)


def _rank(rank: int, world: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        data = {k: torch.from_numpy(v) for k, v in inputs().items()}
        lo, hi = stage_partition(L, world)[rank]
        mine = [{"w": data["w"][i], "b": data["b"][i]} for i in range(lo, hi)]
        group = Group()
        out = pipeline_apply(mine, data["x"], layer_fn, group)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump({"out": out, "sent_bytes": group.sent_bytes}, f)
    finally:
        dist.destroy_process_group()


def test_stage_partition_matches_reference():
    from repro.parallel.pipeline import stage_partition as jax_stage_partition

    for n, s in ((8, 4), (7, 2), (22, 2), (5, 5), (3, 4), (100, 7)):
        assert stage_partition(n, s) == jax_stage_partition(n, s)


def test_pipeline_apply_matches_oracle_and_reference(tmp_path):
    np.savez(tmp_path / "inputs.npz", **inputs())
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp_path / "inputs.npz"),
                          str(tmp_path / "ref.npy")], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr
    mp.spawn(_rank, args=(STAGES, f"file://{tmp_path}/rendezvous", str(tmp_path)),
             nprocs=STAGES)
    data = {k: torch.from_numpy(v) for k, v in inputs().items()}
    oracle = []
    for m in range(N_MICRO):
        y = data["x"][m]
        for i in range(L):
            y = layer_fn({"w": data["w"][i], "b": data["b"][i]}, y)
        oracle.append(y)
    oracle = torch.stack(oracle).numpy()
    want = np.load(tmp_path / "ref.npy")
    for r in range(STAGES):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        np.testing.assert_allclose(got["out"].numpy(), oracle, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["out"].numpy(), want, rtol=1e-5, atol=1e-5)
        # stages 0-2 hand one (B, D) float32 block a microbatch to the next; the
        # last stage broadcasts the (N_MICRO, B, D) outputs
        assert got["sent_bytes"] == N_MICRO * B * D * 4
