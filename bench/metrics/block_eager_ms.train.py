"""block_eager_ms.train: device ms a step of PyTorch's own kernels (names
under ``at::native``) launched inside any ``repro.block.*`` span: a
block's forward, its re-run or its backward (norms, rotary, gating, the
SSD block's conv, dt and gated norm, and their gradients)."""


def read(view):
    spans = getattr(view, "spans", None)
    if not spans or not any(s.name.startswith("repro.block.") for s in spans):
        return None
    ops = [op for op in view.matching(r"at::native::")
           if op.span is not None and op.span.name.startswith("repro.block.")]
    return 1e3 * view.seconds(ops) / view.steps
