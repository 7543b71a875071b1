"""eager_ops_ms.train: device ms a step of PyTorch's own elementwise, copy
and reduce kernels (kernel names under ``at::native``) launched outside the
``bench.update`` range: norms, rotary, gating, casts, the loss's softmax,
the gradient's accumulation.  What ``TrainStep.update`` launches (clipping
and AdamW) is ``optimizer_ms.train``'s."""


def read(view):
    ops = [op for op in view.matching(r"at::native::") if op.range != "bench.update"]
    if not ops:
        return None
    return 1e3 * view.seconds(ops) / view.steps
