"""K4's forward against an earlier commit's, in one process on one card.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit, with an unpacked earlier tree (``git archive <commit> | tar -x -C
build/parent``):

    python3 tools/k4_forward_vs_parent.py build/parent

Both trees' ``csrc/flash_attention.cu`` (and this tree's
``flash_attention_wide.cu``) are built, each into its own tree's build
directory, and loaded side by side.  For each of ``chip_smoke.K4_SHAPES``'
forms, and for windowed shapes at D 64, 128, 160 and 256 with and without
rows that see no key (Sq > Sk), in bf16 and f32, it prints one JSON line:
whether this tree's output and (m, l) statistics equal the earlier tree's
bit for bit (``torch.equal``), and the device time of each
(``chip_smoke.time_ms(hold=True)``, median of 10, taken in turns:
earlier, this, this, earlier).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

# (use, B, H, KVH, D, causal, window, Sq, Sk) beyond K4_SHAPES: windows at
# the narrow widths, and a window past every key of the last rows
EXTRA = (
    ("window at D 128", 1, 16, 1, 128, True, 2048, 4096, 4096),
    ("window at D 64", 1, 32, 4, 64, True, 1024, 4096, 4096),
    ("rows past every key, D 256", 1, 16, 2, 256, True, 300, 1200, 700),
    ("rows past every key, D 64", 2, 8, 2, 64, True, 200, 900, 500),
    ("window, no causality, D 160", 1, 32, 8, 160, False, 700, 2048, 2048),
)


def parent_launch(parent: Path):
    """The earlier tree's ``flash_attention_launch``, built from its sources."""
    from repro_torch.kernels.flash_attention.flash_attention import _ARGS

    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "src" / "repro_torch" / "_build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    return build, build.function("flash_attention", "flash_attention_launch", _ARGS)


def cases():
    for use, nb, h, kvh, d, causal, window, lengths in chip_smoke.K4_SHAPES:
        for sq, sk in lengths:
            yield use, nb, h, kvh, d, causal, window, sq, sk
    yield from EXTRA


def main() -> int:
    import numpy as np
    import torch

    from repro_torch import _build
    from repro_torch.kernels.flash_attention.flash_attention import _DTYPE_CODE, _launch

    parent = Path(sys.argv[1]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    with ThreadPoolExecutor(1) as pool:  # this tree's libraries beside the earlier one's
        built = pool.submit(_build.build, ["flash_attention", "flash_attention_wide"])
        build, old_launch = parent_launch(parent)
        built.result()
    rng = np.random.default_rng(0)
    for use, nb, h, kvh, d, causal, window, sq, sk in cases():
        f32 = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
               for shape in ((nb, sq, h, d), (nb, sk, kvh, d), (nb, sk, kvh, d))]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in f32)
            scale = d**-0.5

            def new():
                return _launch(q, k, v, causal, window, scale, stats=True)

            def old():
                out = torch.empty_like(q)
                st = torch.empty((2, nb, h, sq), dtype=torch.float32, device="cuda")
                err = old_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), nb,
                                 sq, sk, h, kvh, d, _DTYPE_CODE[dtype], int(causal), int(window),
                                 float(scale), st.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
                build.check("flash_attention", err, "earlier flash_attention launch")
                return out, st

            (o_new, st_new), (o_old, st_old) = new(), old()
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                times[who].append(chip_smoke.time_ms(new if who == "new" else old, hold=True))
            print("k4_forward_vs_parent " + json.dumps({
                "use": use, "shape": f"B={nb} H={h} KVH={kvh} D={d} Sq={sq} Sk={sk} "
                f"causal={causal} window={window} {str(dtype)[6:]}",
                "o_bitwise": torch.equal(o_new, o_old),
                "stats_bitwise": torch.equal(st_new, st_old),
                "o_max_abs_diff": float((o_new.float() - o_old.float()).abs().max()),
                "earlier_device_ms": times["old"], "device_ms": times["new"],
                "ratio": sum(times["new"]) / sum(times["old"]), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
