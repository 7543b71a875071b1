"""Serving on the PyTorch port: continuous batching vs the static baseline
on one request set — the serving face of the paper's interrupt-vs-polling
result.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import make_model
from repro_torch.serving import Request, ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--requests", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config("llama3.2-3b").smoke()
    model = make_model(cfg, device=args.device)
    params = model.init(0)

    rng = np.random.default_rng(0)
    protos = [
        (rng.integers(0, cfg.vocab_size, int(rng.integers(3, 12))).astype(np.int32),
         int(rng.integers(3, 28)))
        for _ in range(args.requests)
    ]

    reports = {}
    for mode in ("static", "continuous"):
        engine = ServingEngine(model, params, slots=4, max_len=96, mode=mode)
        for i, (prompt, mx) in enumerate(protos):
            engine.submit(Request(rid=i, prompt=prompt, max_new_tokens=mx))
        engine.run()
        rep = reports[mode] = engine.throughput_report()
        print(f"{mode:11s}: {rep['tokens']} tokens / {rep['steps']} decode steps "
              f"= {rep['tokens_per_step']:.2f} tok/step "
              f"(mean latency {rep['mean_latency'] * 1e3:.0f} ms)")
    return reports


if __name__ == "__main__":
    main()
