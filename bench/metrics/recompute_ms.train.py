"""recompute_ms.train: device ms a step of remat's re-run of the blocks:
every operation launched inside a ``repro.block.<kind>`` span that lies
inside a ``repro.backward`` span (``decoder_forward``'s checkpointed units,
run again by the backward)."""

from bench.spans import is_rerun


def read(view):
    spans = getattr(view, "spans", None)
    reruns = {s for s in spans or () if is_rerun(view, s)}
    if not reruns:
        return None
    ops = [op for op in view.ops if op.span in reruns]
    return 1e3 * view.seconds(ops) / view.steps
