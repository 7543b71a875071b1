"""k5_roofline.train: K5's least time over its device time, as
``k4_roofline.train`` (``flops.k5_forward`` / ``k5_backward`` at the
cell's microbatch; ``ssd_scan.launches`` and ``.backward_launches``; every
``ssd_*_kernel``)."""

from bench.flops import k5_backward, k5_calls, k5_forward, least_seconds


COUNTERS = ("ssd_scan.launches", "ssd_scan.backward_launches")


def read(view):
    ops = view.matching(r"\bssd_\w+_kernel")
    if not ops:
        return None
    m, t = view.cell["model"], view.cell["traffic"]
    shape = k5_calls(m, t["global_batch"] // t["microbatches"], t["seq_len"])
    least = (view.counters["ssd_scan.launches"] * least_seconds(*k5_forward(*shape))
             + view.counters["ssd_scan.backward_launches"] * least_seconds(*k5_backward(*shape)))
    return 100.0 * least / view.seconds(ops)
