"""The paper's SPMM experiment in miniature, on the PyTorch port:
MultiDynamic hybrid execution of an irregular sparse matmul across K3, the
block-ELL kernel on the card (the ACC path), and row gathers on the host
cores (the CC path).

    PYTHONPATH=src python examples/torch_hetero_spmm_demo.py [--device cpu]

On the CPU the dense path runs K3's plain version.
"""

import argparse

import numpy as np

from repro_torch.kernels.spmm.ops import make_hybrid_executor
from repro_torch.kernels.spmm.ref import make_problem, spmm_dense_ref


def run(device: str = "cuda", rows: int = 512) -> dict:
    """The demo on ``device``: the split it converges to and the hybrid
    result's max |err| against the dense oracle (asserted below 1e-3)."""
    # Irregular rows (lognormal nnz) — the workload ENEAC targets.
    problem = make_problem(rows=rows, cols=1024, n_dense=64,
                           nnz_mean=12.0, nnz_sigma=1.2, seed=7)
    print(f"SPMM {problem.rows}×{problem.n_cols} · {problem.n_cols}×64, "
          f"nnz/row: min={problem.nnz.min()} median={int(np.median(problem.nnz))} "
          f"max={problem.nnz.max()}")

    executor, order = make_hybrid_executor(problem, device=device)
    decision = executor.converge(rounds=5)
    print(f"MultiDynamic split after adaptation: dense(ACC)={decision.n_dense} "
          f"rows, sparse(CC)={decision.n_sparse} rows "
          f"({decision.dense_fraction:.0%} on the dense path)")

    result, _ = executor.run(decision)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    err = float(np.abs(result.cpu().numpy()[inv] - spmm_dense_ref(problem)).max())
    print(f"hybrid result max|err| vs dense oracle: {err:.2e}")
    assert err < 1e-3
    return {"max_abs_err": err, "n_dense": decision.n_dense, "n_sparse": decision.n_sparse}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--rows", type=int, default=512)
    args = ap.parse_args(argv)
    return run(args.device, args.rows)


if __name__ == "__main__":
    main()
