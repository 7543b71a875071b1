"""Device times of K4's f32 forward and backward in one tree, for same-card comparisons.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit, once for each tree to compare (this one, and a variant or an earlier
commit unpacked under ``build/``), in turns within one call:

    python3 tools/k4_f32_times.py . && python3 tools/k4_f32_times.py build/variant \\
        && python3 tools/k4_f32_times.py . && python3 tools/k4_f32_times.py build/variant

The given tree's ``src`` is imported, so its kernels are built from its own
sources into its own build directory.  For each shape (the f32 rows of
``chip_smoke.K4_SHAPES`` and ``K4_BACKWARD_SHAPES`` that its design study
varied, and two ragged D 136 / D 192 cases) it prints one line: the forward's
and the backward's device ms (``chip_smoke.time_ms(hold=True)``, twice each),
and whether the backward stays within K4's f32 tolerance of its plain version
and gives the same bits on two calls.
"""

from __future__ import annotations

import sys
from pathlib import Path

TREE = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
sys.path.insert(0, str(TREE))
sys.path.insert(0, str(TREE / "src"))

# (B, H, KVH, D, causal, window, Sq = Sk)
SHAPES = (
    (4, 32, 4, 64, True, 0, 2048),      # tinyllama's training microbatch
    (2, 16, 2, 128, True, 0, 2048),     # a phase-9 rank's heads at D 128
    (1, 64, 8, 128, True, 0, 891),      # the vision model's self-attention
    (1, 16, 1, 128, True, 2048, 4096),  # a window at D 128
    (1, 32, 8, 160, True, 0, 2048),     # stablelm-12b
    (1, 16, 1, 256, True, 2048, 2048),  # recurrentgemma-9b
    (2, 8, 2, 192, True, 0, 150),
    (1, 4, 4, 136, False, 50, 500),
)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attention.flash_attention import (
        _launch, flash_attention_backward, flash_attention_backward_plain,
    )

    rng = np.random.default_rng(0)
    for nb, h, kvh, d, causal, window, s in SHAPES:
        q, k, v, g = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
                      for shape in ((nb, s, h, d), (nb, s, kvh, d), (nb, s, kvh, d), (nb, s, h, d)))
        mask = dict(causal=causal, window=window, scale=d**-0.5)
        _, stats = _launch(q, k, v, causal, window, mask["scale"], stats=True)

        def backward():
            return flash_attention_backward(q, k, v, stats, g, **mask)

        got = backward()
        want = flash_attention_backward_plain(q, k, v, stats[0], stats[1], g, **mask)
        within = all(chip_smoke.within(a, b, chip_smoke.ATTN_TOL["float32"])
                     for a, b in zip(got, want))
        repeatable = all(torch.equal(a, b) for a, b in zip(got, backward()))
        fwd = [chip_smoke.time_ms(lambda: _launch(q, k, v, causal, window, mask["scale"]),
                                  hold=True) for _ in range(2)]
        bwd = [chip_smoke.time_ms(backward, hold=True) for _ in range(2)]
        print(f"k4_f32_times {TREE} B={nb} H={h} KVH={kvh} D={d} S={s} causal={causal} "
              f"window={window} forward_device_ms={[round(t, 4) for t in fwd]} "
              f"backward_device_ms={[round(t, 4) for t in bwd]} within={within} "
              f"repeatable={repeatable}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
