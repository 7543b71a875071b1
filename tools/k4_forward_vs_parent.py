"""K4's forward and backward against an earlier commit's, in one process on one card.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit, with an unpacked earlier tree (``git archive <commit> | tar -x -C
build/parent``):

    python3 tools/k4_forward_vs_parent.py build/parent

Both trees' K4 sources are built, each into its own tree's build directory,
and loaded side by side: this tree through its wrappers, the earlier one
through its C entry points (``flash_attention_launch`` with a dtype
argument, ``flash_attention_wide_launch``, ``flash_attention_backward_launch``
with a dtype argument, as the commits before the f32 kernels' own sources
had them).  For each of ``chip_smoke.K4_SHAPES``' forms, and for windowed
shapes at D 64, 128, 160 and 256 with and without rows that see no key
(Sq > Sk), in bf16 and f32, it prints one ``k4_forward_vs_parent`` JSON
line; for each of ``chip_smoke.K4_BACKWARD_SHAPES`` in both dtypes one
``k4_backward_vs_parent`` line.  bf16 lines say whether this tree's
output, (m, l) statistics and (dq, dk, dv) equal the earlier tree's bit
for bit (``torch.equal``); f32 lines give both trees' errors against the
float64 function (``chip_smoke.float64_attention``, as the largest share
of the f32 tolerance an element takes) and whether this tree's is at most
the larger of 0.1 and twice the earlier tree's.  Every line carries the
device time of each tree (``chip_smoke.time_ms(hold=True)``, median of 10,
taken in turns: earlier, this, this, earlier) and the card.  The backward
of both trees runs on this tree's forward statistics.
"""

from __future__ import annotations

import ctypes
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
_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier tree's entry points: a dtype argument (0 f32, 1 bf16) after D
PARENT_FWD_ARGS = (_P,) * 4 + (_I,) * 9 + (ctypes.c_float, _P, _P)
PARENT_WIDE_ARGS = (_P,) * 4 + (_I,) * 8 + (ctypes.c_float, _P, _P)
PARENT_BWD_ARGS = (_P,) * 10 + (_I,) * 10 + (ctypes.c_float, _P)


class Parent:
    """The earlier tree's K4 libraries, built from its sources."""

    def __init__(self, parent: Path):
        spec = importlib.util.spec_from_file_location(
            "parent_build", parent / "src" / "repro_torch" / "_build.py")
        self.build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(self.build)
        self.build.build(["flash_attention", "flash_attention_wide", "flash_attention_bwd"])
        self.fwd = self.build.function("flash_attention", "flash_attention_launch",
                                       PARENT_FWD_ARGS)
        self.wide = self.build.function("flash_attention_wide", "flash_attention_wide_launch",
                                        PARENT_WIDE_ARGS)
        self.bwd = self.build.function("flash_attention_bwd", "flash_attention_backward_launch",
                                       PARENT_BWD_ARGS)

    def forward(self, q, k, v, causal, window, scale):
        import torch

        b, sq, h, d = q.shape
        bf16 = q.dtype == torch.bfloat16
        out = torch.empty_like(q)
        st = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, k.shape[1], h,
                k.shape[2], d)
        tail = (int(causal), int(window), float(scale), st.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if bf16 and d > 128:
            err, lib = self.wide(*args, *tail), "flash_attention_wide"
        else:
            err, lib = self.fwd(*args, int(bf16), *tail), "flash_attention"
        self.build.check(lib, err, "earlier forward launch")
        return out, st

    def backward(self, q, k, v, stats, gy, causal, window, scale):
        import torch

        b, sq, h, d = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        bf16 = q.dtype == torch.bfloat16
        # the earlier walk_splits: bf16 past D 128 on a grid short of a wave
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        ctas = b * kvh * -(-sk // 64)
        splits = 1 if not bf16 or d <= 128 or ctas >= sms else \
            max(1, min(-(-sms // ctas), -(-sq * (h // kvh) // 64)))
        part = torch.empty((splits, 2, b, sk, kvh, 192 if d <= 192 else 256),
                           dtype=torch.float32, device=q.device) if splits > 1 else None
        aux = torch.empty((3, b, h, sq), dtype=torch.float32, device=q.device)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        err = self.bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), gy.data_ptr(), stats.data_ptr(),
                       aux.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       part.data_ptr() if part is not None else None, b, sq, sk, h, kvh, d,
                       int(bf16), int(causal), int(window), splits, float(scale),
                       torch.cuda.current_stream().cuda_stream)
        self.build.check("flash_attention_bwd", err, "earlier backward launch")
        return dq, dk, dv


def cases():
    for use, nb, h, kvh, d, causal, window, lengths in chip_smoke.K4_SHAPES:
        for sq, sk in lengths:
            yield use, nb, h, kvh, d, causal, window, sq, sk
    yield from EXTRA


def in_turns(old, new) -> dict:
    """Device ms of each, taken earlier, this, this, earlier."""
    times = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        times[who].append(chip_smoke.time_ms(new if who == "new" else old, hold=True))
    return dict(earlier_device_ms=times["old"], device_ms=times["new"],
                ratio=sum(times["new"]) / sum(times["old"]))


def f32_errors(got_new, got_old, refs, names) -> dict:
    """Both trees' float64 errors, and whether this tree's holds the
    measure: at most the larger of 0.1 and twice the earlier tree's."""
    out = {}
    for name, new, old, ref in zip(names, got_new, got_old, refs):
        e_new, e_old = chip_smoke.f32_error_ratio(new, ref), chip_smoke.f32_error_ratio(old, ref)
        out[name] = dict(float64_error_ratio=e_new, earlier_float64_error_ratio=e_old,
                         holds=e_new <= max(0.1, 2 * e_old))
    return out


def main() -> int:
    import numpy as np
    import torch

    from repro_torch import _build
    from repro_torch.kernels.flash_attention.flash_attention import (
        _launch, flash_attention_backward,
    )

    parent = Path(sys.argv[1]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    with ThreadPoolExecutor(1) as pool:  # this tree's libraries beside the earlier one's
        built = pool.submit(_build.build, ["flash_attention", "flash_attention_wide",
                                           "flash_attention_bwd", "flash_attention_f32",
                                           "flash_attention_f32_bwd"])
        old = Parent(parent)
        built.result()
    rng = np.random.default_rng(0)
    ok = True
    for use, nb, h, kvh, d, causal, window, sq, sk in cases():
        f32 = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
               for shape in ((nb, sq, h, d), (nb, sk, kvh, d), (nb, sk, kvh, d))]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in f32)
            scale = d**-0.5
            (o_new, st_new) = _launch(q, k, v, causal, window, scale, stats=True)
            (o_old, st_old) = old.forward(q, k, v, causal, window, scale)
            line = {"use": use, "shape": f"B={nb} H={h} KVH={kvh} D={d} Sq={sq} Sk={sk} "
                    f"causal={causal} window={window} {str(dtype)[6:]}"}
            if dtype == torch.bfloat16:
                line.update(o_bitwise=torch.equal(o_new, o_old),
                            stats_bitwise=torch.equal(st_new, st_old))
                ok &= line["o_bitwise"] and line["stats_bitwise"]
            else:
                ref = chip_smoke.float64_attention(q, k, v, None, causal, window, scale)
                line.update(f32_errors((o_new,), (o_old,), ref, ("o",)))
                ok &= line["o"]["holds"]
                del ref
            line.update(in_turns(lambda: old.forward(q, k, v, causal, window, scale),
                                 lambda: _launch(q, k, v, causal, window, scale, stats=True)),
                        card=card)
            print("k4_forward_vs_parent " + json.dumps(line))
    for use, nb, h, kvh, d, causal, window, sq, sk in chip_smoke.K4_BACKWARD_SHAPES:
        f32 = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
               for shape in ((nb, sq, h, d), (nb, sk, kvh, d), (nb, sk, kvh, d), (nb, sq, h, d))]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, gy = (x.to(dtype) for x in f32)
            mask = dict(causal=causal, window=window, scale=d**-0.5)
            _, stats = _launch(q, k, v, causal, window, mask["scale"], stats=True)
            new = flash_attention_backward(q, k, v, stats, gy, **mask)
            prev = old.backward(q, k, v, stats, gy, causal, window, mask["scale"])
            line = {"use": use, "shape": f"B={nb} H={h} KVH={kvh} D={d} Sq={sq} Sk={sk} "
                    f"causal={causal} window={window} {str(dtype)[6:]}"}
            if dtype == torch.bfloat16:
                line["grads_bitwise"] = all(torch.equal(a, b) for a, b in zip(new, prev))
                ok &= line["grads_bitwise"]
            else:
                ref = chip_smoke.float64_attention(q, k, v, gy, causal, window,
                                                   mask["scale"])[1:]
                line.update(f32_errors(new, prev, ref, ("dq", "dk", "dv")))
                ok &= all(line[x]["holds"] for x in ("dq", "dk", "dv"))
                del ref
            del new, prev
            line.update(in_turns(
                lambda: old.backward(q, k, v, stats, gy, causal, window, mask["scale"]),
                lambda: flash_attention_backward(q, k, v, stats, gy, **mask)), card=card)
            print("k4_backward_vs_parent " + json.dumps(line))
    print(f"k4_vs_parent all_hold={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
