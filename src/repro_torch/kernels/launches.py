"""The kernel wrappers' launch counts, as work a unit can run.

Each wrapper counts the launches of its kernel in ``wrapper.launches``, in
the process that launches it.  :class:`LaunchCounts` is picklable work:
submitted through a :class:`~repro_torch.core.transport.RemoteUnit`, it
reads the counts of the worker process that runs it, and sets them to 0.
"""

from __future__ import annotations

from typing import Dict

from .. import _build
from .causal_conv.causal_conv import causal_conv
from .flash_attention.flash_attention import flash_attention
from .hotspot.hotspot import hotspot_hp_step, hotspot_hpc
from .spmm.spmm import spmm_block_ell
from .ssd_scan.ssd_scan import ssd_scan

__all__ = ["LaunchCounts"]

WRAPPERS = (hotspot_hpc, hotspot_hp_step, spmm_block_ell, flash_attention, ssd_scan, causal_conv)


class LaunchCounts:
    """Work that returns ``{wrapper name: launches}`` of the process that
    runs it and sets every count to 0, so a second call counts what ran
    between the two."""

    def __call__(self, chunk=None) -> Dict[str, int]:
        counts = {}
        with _build._count_lock:  # the lock count_launch takes
            for wrapper in WRAPPERS:
                counts[wrapper.__name__] = wrapper.launches
                wrapper.launches = 0
        return counts
