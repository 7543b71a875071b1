"""update_host_ms.train: host ms a step that the program's ``repro.update``
spans last (``TrainStep.update``: the time the host takes to dispatch
clipping, AdamW and the apply), to set beside ``optimizer_ms.train``'s
device ms."""


def read(view):
    spans = [s for s in getattr(view, "spans", None) or () if s.name == "repro.update"]
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / 1e3 / view.steps
