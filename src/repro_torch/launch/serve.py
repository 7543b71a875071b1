"""Serving CLI: batched requests through the continuous-batching engine.

CLI (on the card unless ``--device cpu``):
  python -m repro_torch.launch.serve --arch tinyllama-1.1b --requests 16 --slots 4
  python -m repro_torch.launch.serve --arch tinyllama-1.1b --full

Flags as in ``python -m repro.launch.serve``, plus ``--device``.  Weights
are random, drawn from a seeded generator on the device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import make_model
from ..serving import Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--mode", choices=("continuous", "static"), default="continuous")
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke()
    model = make_model(cfg, device=args.device)
    params = model.init(0)
    rng = np.random.default_rng(0)

    engine = ServingEngine(model, params, slots=args.slots, max_len=args.max_len,
                           mode=args.mode)
    for i in range(args.requests):
        plen = int(rng.integers(4, 16))
        engine.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(4, args.max_new)),
        ))
    t0 = time.perf_counter()
    results = engine.run()
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = engine.throughput_report()
    print(f"{len(results)} requests, {rep['tokens']} tokens, "
          f"{rep['steps']} decode steps, {rep['tokens_per_step']:.2f} tok/step, "
          f"{rep['tokens'] / wall:.1f} tok/s wall ({args.mode}, {args.device})")


if __name__ == "__main__":
    main()
