"""End-to-end training on the PyTorch port: a llama-family model (smoke
dims) for a few hundred steps on the synthetic corpus, with checkpoints.

    PYTHONPATH=src python examples/torch_train_small.py [--steps 300] [--device cpu]
"""

import argparse
import tempfile

from repro_torch.launch.train import TrainLoopConfig, run_training


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary one)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="repro_torch_train_small_") as tmp:
        out = run_training(TrainLoopConfig(
            arch="tinyllama-1.1b",      # llama wiring; smoke-reduced dims
            steps=args.steps,
            global_batch=8,
            seq_len=128,
            lr=1e-3,
            ckpt_dir=args.ckpt_dir or tmp,
            ckpt_every=100,
            log_every=25,
            device=args.device,
        ))
    print(f"\nfinal: loss {out['first_loss']:.4f} → {out['final_loss']:.4f} "
          f"({out['mean_tok_per_s']:,.0f} tok/s)")
    assert out["final_loss"] < out["first_loss"], "loss must decrease"
    return out


if __name__ == "__main__":
    main()
