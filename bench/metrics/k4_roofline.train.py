"""k4_roofline.train: K4's least time over its device time.  The least
time of each call is the larger of its least FLOPs over the bf16 peak and
its least bytes over the HBM bandwidth (``flops.k4_forward`` /
``k4_backward`` at the cell's microbatch); the calls are the program's
``flash_attention.launches`` (forward, remat's recomputation included)
and ``.backward_launches`` over the traced window; the device time is
every ``flash_fwd*`` / ``flash_bwd*`` kernel's."""

from bench.flops import k4_backward, k4_calls, k4_forward, least_seconds


COUNTERS = ("flash_attention.launches", "flash_attention.backward_launches")


def read(view):
    ops = view.matching(r"\bflash_(fwd|bwd)")
    if not ops:
        return None
    m, t = view.cell["model"], view.cell["traffic"]
    shape = k4_calls(m, t["global_batch"] // t["microbatches"], t["seq_len"])
    least = (view.counters["flash_attention.launches"] * least_seconds(*k4_forward(*shape))
             + view.counters["flash_attention.backward_launches"]
             * least_seconds(*k4_backward(*shape)))
    return 100.0 * least / view.seconds(ops)
