"""causal_conv_roofline.train: the depthwise causal conv's least time over
its device time, as ``k4_roofline.train`` (``flops.conv_forward`` /
``conv_backward`` at the shape of the cell's family's ``conv_calls``, the
SSD block's conv of the cell's microbatch; ``causal_conv.launches``, the
forward with remat's re-run, and ``.backward_launches``; every
``causal_conv_*`` kernel, the backward's partial sums included)."""

from bench import families
from bench.flops import conv_backward, conv_forward, least_seconds

COUNTERS = ("causal_conv.launches", "causal_conv.backward_launches")


def read(view):
    ops = view.matching(r"\bcausal_conv_\w*kernel")
    if not ops:
        return None
    m, t = view.cell["model"], view.cell["traffic"]
    rows = t["global_batch"] // t["microbatches"]
    shape = families.load(m["family"]).conv_calls(m, rows, t["seq_len"])
    least = (view.counters["causal_conv.launches"] * least_seconds(*conv_forward(*shape))
             + view.counters["causal_conv.backward_launches"]
             * least_seconds(*conv_backward(*shape)))
    return 100.0 * least / view.seconds(ops)
