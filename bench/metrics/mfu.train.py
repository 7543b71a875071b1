"""mfu.train: the step's model FLOPs (``flops.model_flops``: no
recomputation) over the traced window's seconds, as a share of the card's
bf16 peak."""

from bench.flops import H100, model_flops


def read(view):
    t = view.cell["traffic"]
    work = view.steps * model_flops(view.cell["model"], t["global_batch"], t["seq_len"])
    return 100.0 * work / view.window_s / H100["bf16_flops"]
