"""Training driver: ENEAC microbatching + fault tolerance, on a mesh.

The port's copy of ``repro.launch.train``.  It wires together:
  * mesh + rule-derived shardings              (parallel/)
  * the train step w/ grad accumulation        (launch/steps.py)
  * async data prefetch                        (data/prefetch.py)
  * async checkpointing + restart              (checkpoint/)
  * straggler detection and throughput tracking (core/straggler.py, core/hetero.py)

It runs on the card unless the caller asks for the CPU (``device``).
Without a mesh it trains on one device, on the (1, 1) ``("data",
"model")`` mesh the reference builds there, with no process group.  With
a mesh (``launch.mesh.make_mesh``, every rank calling ``run_training``
alike; any (data, model) shape) it runs the sharded step: every rank
builds the whole parameter tree from the seed and keeps its blocks (a
fresh run's AdamW moments are made on the blocks alone), draws the same
global batch and takes its rows of it; checkpoints are the reference's
full arrays, gathered and written by rank 0, and restored onto any mesh;
only rank 0 prints, and every rank returns the same losses and seconds (a
step's seconds are the slowest rank's).  ``warmup`` is kept as the reference keeps it: set,
and read by nothing.  The ``encdec`` and ``vlm`` families need frames or
image embeddings in their batches, which the token source does not make,
so they do not train here, as in the reference.

CLI (on the card unless ``--device cpu``):
  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 50 \\
      --global-batch 8 --seq-len 128
  python -m repro_torch.launch.train --arch tinyllama-1.1b --full
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..configs.base import InputShape
from ..core.hetero import ThroughputTracker
from ..core.straggler import StragglerDetector
from ..data import Prefetcher, SyntheticTokens
from ..models import make_model
from ..optim import AdamW, AdamWState
from ..parallel.mesh_rules import MeshRules, MeshShape
from ..tree import tree_leaves, tree_map
from .steps import make_train_step

__all__ = ["TrainLoopConfig", "run_training", "main"]


@dataclasses.dataclass
class TrainLoopConfig:
    arch: str
    steps: int = 50
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    warmup: int = 10
    smoke: bool = True                  # reduced model dims (CPU-runnable)
    layers: int = 0                     # cut the depth to this many layers (0: the config's)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    resume: bool = False
    microbatches: int = 1
    log_every: int = 10
    seed: int = 0
    device: str = "cuda"


def run_training(cfg: TrainLoopConfig, *, mesh=None) -> Dict[str, Any]:
    """The reference's result (``first_loss``, ``final_loss``,
    ``mean_tok_per_s``, ``steps``), and each step's loss and seconds
    (``losses``, ``step_seconds``) of the steps this call ran, with the
    bytes this rank handed to the collectives of each of its groups in
    each of them (``collective_bytes``: ``model``, ``data`` and ``mesh``;
    empty dicts on one rank), and the bytes of the parameter and AdamW
    state blocks this rank held at the end (``held_bytes``)."""
    model_cfg = get_config(cfg.arch)
    if cfg.smoke:
        model_cfg = model_cfg.smoke()
    if cfg.layers:
        model_cfg = model_cfg.replace(num_layers=cfg.layers)
    model = make_model(model_cfg, device=cfg.device)
    shape = InputShape("custom", cfg.seq_len, cfg.global_batch, "train")
    device = torch.device(cfg.device)

    if mesh is None:
        mesh = MeshShape((1, 1), ("data", "model"))
    rules = MeshRules(mesh, model_cfg.parallel)

    optimizer = AdamW(
        state_dtype=torch.bfloat16
        if model_cfg.parallel.opt_state_dtype == "bfloat16"
        else torch.float32,
        cfg=model_cfg,
    )
    step_fn = make_train_step(model, optimizer, rules, shape, lr=cfg.lr,
                              microbatches=cfg.microbatches, loss_chunk=0)
    spread = step_fn.tp is not None        # a mesh of more than one rank
    lead = not spread or step_fn.world.rank == 0

    params = model.init(cfg.seed)
    start_step = 0

    ckpt = Checkpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None
    if ckpt and cfg.resume and ckpt.latest_step() is not None:
        opt_state = optimizer.init(params)
        (restored_p, restored_o), start_step = ckpt.restore(None, (params, tuple(opt_state)))

        def back(like, restored):
            return restored.to(device=like.device, dtype=like.dtype)

        params = tree_map(back, params, restored_p)
        opt_state = AdamWState(*tree_map(back, tuple(opt_state), restored_o))
        # each rank keeps its blocks (on one rank, the trees themselves)
        params = step_fn.shard(params)
        opt_state = AdamWState(opt_state.step, step_fn.shard(opt_state.mu),
                               step_fn.shard(opt_state.nu))
    else:   # fresh moments are zeros: made on the blocks alone
        params = step_fn.shard(params)
        opt_state = optimizer.init(params)

    source = SyntheticTokens(model_cfg.padded_vocab, cfg.seq_len, seed=cfg.seed)

    def make_batch(step: int):
        b = source.batch(step, shard=0, num_shards=1, per_shard=cfg.global_batch)
        return {
            "tokens": torch.from_numpy(b.tokens).to(device),
            "labels": torch.from_numpy(b.labels).to(device),
            "mask": torch.from_numpy(b.mask).to(device),
        }

    prefetch = Prefetcher(make_batch, depth=2, start_step=start_step)
    detector = StragglerDetector()
    tracker = ThroughputTracker()

    losses, step_seconds, step_bytes = [], [], []
    groups = ({"model": step_fn.tp.group, "data": step_fn.group, "mesh": step_fn.world}
              if spread else {})
    t_start = time.perf_counter()
    try:
        for step in range(start_step, cfg.steps):
            _, batch = prefetch.get()
            sent = {k: g.sent_bytes for k, g in groups.items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)  # the step's update too, not only its loss
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            step_bytes.append({k: g.sent_bytes - sent[k] for k, g in groups.items()})
            if spread:  # the slowest rank's
                dt = step_fn.world.all_reduce_float(dt, "max")
            tracker.update("pod0", cfg.global_batch * cfg.seq_len, dt)
            detector.observe({"pod0": dt})
            losses.append(loss)
            step_seconds.append(dt)
            if lead and (step % cfg.log_every == 0 or step == cfg.steps - 1):
                print(
                    f"step {step:5d}  loss {loss:.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.3f}  "
                    f"{cfg.global_batch * cfg.seq_len / dt:,.0f} tok/s"
                )
            if ckpt and (step + 1) % cfg.ckpt_every == 0:
                full = (step_fn.gather(params), (opt_state.step, step_fn.gather(opt_state.mu),
                                                 step_fn.gather(opt_state.nu)))
                if lead:
                    ckpt.save(step + 1, full)
                del full
    finally:
        prefetch.close()
        if ckpt:
            ckpt.wait_all()

    wall = time.perf_counter() - t_start
    if spread:
        wall = step_fn.world.all_reduce_float(wall, "max")
    held = {"params": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
            "opt_state": sum(t.numel() * t.element_size() for t in tree_leaves(tuple(opt_state)))}
    return {
        "first_loss": losses[0],
        "final_loss": losses[-1],
        "mean_tok_per_s": cfg.steps * cfg.global_batch * cfg.seq_len / wall,
        "steps": len(losses),
        "losses": losses,
        "step_seconds": step_seconds,
        "collective_bytes": step_bytes,
        "held_bytes": held,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = run_training(TrainLoopConfig(
        arch=args.arch, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, lr=args.lr, smoke=args.smoke,
        ckpt_dir=args.ckpt_dir, resume=args.resume,
        microbatches=args.microbatches, device=args.device,
    ))
    print({k: round(v, 4) if isinstance(v, float) else v for k, v in out.items()
           if k not in ("losses", "step_seconds")})


if __name__ == "__main__":
    main()
