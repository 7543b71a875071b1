"""device_idle_share.train: the share of the traced window in which no
operation runs on the device (the union of their intervals)."""

from bench.trace import busy_intervals


def read(view):
    if not view.ops:
        return None
    busy = sum(b - a for a, b in busy_intervals(view.ops)) / 1e6
    return 100.0 * (1.0 - busy / view.window_s)
