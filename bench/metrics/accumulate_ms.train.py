"""accumulate_ms.train: device ms a step of every operation launched inside
the program's ``repro.accumulate`` span (``TrainStep._accumulate``: each
microbatch's gradients added into the f32 sum, and its metrics).  A step
of one microbatch keeps no sum and has no such span."""


def read(view):
    spans = getattr(view, "spans", None)
    if not spans or not any(s.name == "repro.accumulate" for s in spans):
        return None
    ops = [op for op in view.ops if op.span is not None and op.span.name == "repro.accumulate"]
    return 1e3 * view.seconds(ops) / view.steps
