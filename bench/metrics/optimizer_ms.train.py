"""optimizer_ms.train: device ms a step of every operation launched inside
the ``bench.update`` range, which the harness puts around
``TrainStep.update`` (global-norm clipping, AdamW, the update's apply)."""


def read(view):
    ops = [op for op in view.ops if op.range == "bench.update"]
    if not ops:
        return None
    return 1e3 * view.seconds(ops) / view.steps
