"""loss_ms.train: device ms a step of every operation launched inside the
program's ``repro.loss`` span (``Model.loss_fn``: the head, the
log-sum-exp and the pick, in f32 chunks) or its ``repro.loss.backward``
span (from the loss's gradient to the final hidden state's)."""

NAMES = ("repro.loss", "repro.loss.backward")


def read(view):
    spans = getattr(view, "spans", None)
    if not spans or not any(s.name in NAMES for s in spans):
        return None
    ops = [op for op in view.ops if op.span is not None and op.span.name in NAMES]
    return 1e3 * view.seconds(ops) / view.steps
