"""The port's checkpointing against ``repro.checkpoint``, on the CPU.

Both packages write the same files for the same tree (manifest, leaf
paths, hashes, ``.npy`` bytes, bfloat16 as its bit patterns), so each
restores the other's checkpoints; a bfloat16 leaf round-trips bitwise in
the port; ``checkpointed_parallel_for`` under a ``SimulatedClock`` gives
the same ``CheckpointedRun`` in both packages, fresh and resumed after a
crash, and resumes across packages.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jax_core  # noqa: E402
from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.checkpoint import checkpointed_parallel_for as jax_checkpointed_parallel_for  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    Checkpointer,
    CoverageMap,
    checkpointed_parallel_for,
    load_coverage,
    save_coverage,
)

RUN_FIELDS = ("num_items", "items_run", "resumed_from_step", "resumed_items_done", "rounds",
              "last_step")
REPORT_FIELDS = ("items", "chunks", "coverage", "per_worker_items", "per_worker_busy",
                 "wall_time")


def numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    done = rng.random(97) < 0.4
    return {
        "coverage_done": done,
        "layers": [rng.standard_normal((3, 5)).astype(np.float32),
                   (rng.integers(-9, 9, 7).astype(np.int64), np.full(2, 2.5, np.float32))],
        "meta": {"step": np.array(12, np.int32), "skip": None},
    }


def bf16_bits(seed=1, n=64):
    bits = np.random.default_rng(seed).integers(0, 1 << 16, n, dtype=np.uint16)
    bits[:5] = [0x7FC0, 0x7F80, 0xFF80, 0x8000, 0x0001]  # nan, inf, -inf, -0, subnormal
    return bits


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_torch(v) for v in tree)
    return None if tree is None else torch.from_numpy(np.array(tree))


def leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    elif tree is not None:
        yield tree


def assert_same_leaves(got, want):
    got, want = list(leaves(got)), list(leaves(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w)


def step_files(directory, step):
    path = directory / f"step_{step:08d}"
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


def test_both_packages_write_the_same_files(tmp_path):
    bits = bf16_bits()
    jax_tree = dict(numpy_tree(), half=jnp.asarray(bits.view(jnp.bfloat16)))
    port_tree = as_torch(numpy_tree())
    port_tree["half"] = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    JaxCheckpointer(tmp_path / "jax").save(5, jax_tree, blocking=True)
    Checkpointer(tmp_path / "port").save(5, port_tree, blocking=True)
    assert step_files(tmp_path / "port", 5) == step_files(tmp_path / "jax", 5)


def test_jax_checkpoint_restores_in_port(tmp_path):
    tree = numpy_tree(3)
    bits = bf16_bits(4)
    JaxCheckpointer(tmp_path).save(7, dict(tree, half=jnp.asarray(bits.view(jnp.bfloat16))),
                                   blocking=True)
    like = dict(tree, half=np.zeros(bits.shape, np.float32))
    got, step = Checkpointer(tmp_path).restore(None, like)
    assert step == 7
    assert got["half"].dtype == torch.bfloat16
    assert np.array_equal(got.pop("half").view(torch.int16).numpy().view(np.uint16), bits)
    assert_same_leaves(got, tree)
    assert isinstance(got["layers"][1], tuple) and got["meta"]["skip"] is None
    got, _ = Checkpointer(tmp_path).restore(7, as_torch(like))
    assert isinstance(got["coverage_done"], torch.Tensor)
    assert_same_leaves({k: v for k, v in got.items() if k != "half"}, tree)


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = numpy_tree(5)
    Checkpointer(tmp_path).save(9, as_torch(tree), blocking=True)
    got, step = JaxCheckpointer(tmp_path).restore(None, tree)
    assert step == 9
    assert_same_leaves(got, tree)


def test_bf16_leaf_round_trips_bitwise(tmp_path):
    bits = bf16_bits(6, n=4096).reshape(64, 64)
    leaf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    ckpt = Checkpointer(tmp_path)
    info = ckpt.save(1, {"w": leaf[:, ::2]}, blocking=True).wait()  # a strided view
    got, _ = ckpt.restore(1, {"w": leaf[:, ::2]})
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (64, 32)
    assert torch.equal(got["w"].view(torch.int16), leaf[:, ::2].contiguous().view(torch.int16))
    data = info.path / "arr_00000.npy"
    raw = bytearray(data.read_bytes())
    raw[-1] ^= 1
    data.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum mismatch"):
        ckpt.restore(1, {"w": leaf[:, ::2]})


def test_save_snapshots_before_the_caller_writes(tmp_path):
    x = torch.zeros(1000)
    ckpt = Checkpointer(tmp_path)
    done = ckpt.save(1, {"x": x})
    x += 1.0  # after save() returned; the checkpoint holds the zeros
    done.wait()
    got, _ = ckpt.restore(1, {"x": x})
    assert not got["x"].any()


def test_coverage_bitmap_crosses_packages(tmp_path):
    cov = CoverageMap(300)
    cov.mark(0, 120)
    cov.mark(200, 250)
    save_coverage(Checkpointer(tmp_path), cov.items_done, cov, blocking=True)
    from repro.checkpoint import load_coverage as jax_load_coverage

    jax_cov, step = jax_load_coverage(JaxCheckpointer(tmp_path), 300)
    assert step == 170 and np.array_equal(jax_cov.done, cov.done)
    got, _ = load_coverage(Checkpointer(tmp_path), 300)
    assert got.remaining_spans() == [(120, 200), (250, 300)]
    with pytest.raises(ValueError):
        load_coverage(Checkpointer(tmp_path), 301)


class Ledger:
    def __init__(self, crash_at=None):
        self.lock = threading.Lock()
        self.ids = []
        self.crash_at = crash_at

    def __call__(self, chunk):
        if self.crash_at is not None and chunk.start >= self.crash_at:
            raise RuntimeError("crash")
        with self.lock:
            self.ids.extend(chunk.indices())


def sim_runtime(pkg):
    rt = pkg.HeteroRuntime(clock=pkg.SimulatedClock())
    for i, speed in enumerate((1.0, 0.7, 1.3)):
        rt.register_unit(f"cc{i}", pkg.WorkerKind.CC, speed=speed)
    rt.register_unit("acc0", pkg.WorkerKind.ACC, speed=4.0)
    return rt


def costs(n):
    return list(np.random.default_rng(0).zipf(1.5, n).clip(max=20.0).astype(float))


def crash_then_resume(pkg, run_fn, ckpt_cls, directory, n=1000):
    kw = dict(policy="multidynamic", acc_chunk=16, item_cost=costs(n))
    fresh = run_fn(sim_runtime(pkg), Ledger(), n, checkpointer=ckpt_cls(directory / "fresh"),
                   **kw)
    crashing = ckpt_cls(directory / "crash")
    with pytest.raises(RuntimeError, match="crash"):
        run_fn(sim_runtime(pkg), Ledger(crash_at=500), n, checkpointer=crashing, **kw)
    crashing.wait_all()
    return fresh, directory / "crash"


def resume(pkg, run_fn, ckpt_cls, directory, n=1000):
    led = Ledger()
    run = run_fn(sim_runtime(pkg), led, n, checkpointer=ckpt_cls(directory),
                 policy="multidynamic", acc_chunk=16, item_cost=costs(n))
    return run, sorted(led.ids)


def assert_same_run(got, want):
    for field in RUN_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert len(got.reports) == len(want.reports)
    for a, b in zip(got.reports, want.reports):
        for field in REPORT_FIELDS:
            assert getattr(a, field) == getattr(b, field), field


def test_checkpointed_parallel_for_equals_reference(tmp_path):
    fresh, crash_dir = crash_then_resume(core, checkpointed_parallel_for, Checkpointer,
                                         tmp_path / "port")
    ref_fresh, ref_crash_dir = crash_then_resume(jax_core, jax_checkpointed_parallel_for,
                                                 JaxCheckpointer, tmp_path / "jax")
    assert_same_run(fresh, ref_fresh)
    assert fresh.rounds == 4 and fresh.items_run == 1000 and not fresh.resumed
    assert step_files(crash_dir, 500) == step_files(ref_crash_dir, 500)

    run, ids = resume(core, checkpointed_parallel_for, Checkpointer, crash_dir)
    ref_run, ref_ids = resume(jax_core, jax_checkpointed_parallel_for, JaxCheckpointer,
                              ref_crash_dir)
    assert_same_run(run, ref_run)
    assert run.resumed_from_step == 500 and run.items_run == 500
    assert ids == ref_ids == list(range(500, 1000))


def test_port_resumes_a_reference_run(tmp_path):
    _, ref_crash_dir = crash_then_resume(jax_core, jax_checkpointed_parallel_for,
                                         JaxCheckpointer, tmp_path)
    run, ids = resume(core, checkpointed_parallel_for, Checkpointer, ref_crash_dir)
    assert run.resumed_from_step == 500 and ids == list(range(500, 1000))
