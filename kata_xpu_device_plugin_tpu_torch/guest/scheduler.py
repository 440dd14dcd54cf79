"""Admission order (the ``fifo_batch`` policy of
``kata_xpu_device_plugin_tpu/guest/scheduler.py``, copied).

Every admission pass admits the FIFO prefix of the queue that fits the free
slots, grouped by padded prompt length — the smallest prefill bucket that
holds the prompt, or its exact length when none does — so one prefill
forward serves each group. Grouping reorders requests only within the
admitted prefix, so fairness is unchanged. The chunked ``slo_chunked``
policy is not ported yet.
"""
from __future__ import annotations

from collections import deque

POLICY_FIFO = "fifo_batch"


def fifo_batch(queue: deque, n_free: int, buckets: tuple,
               reserve=None) -> dict[int, list]:
    """Pop the FIFO prefix of ``queue`` that fits ``n_free`` slots and group
    it by padded length (insertion-ordered: groups stay FIFO). ``reserve``
    (the paged pool's block reservation) is asked for each request before
    it is popped; the first one it refuses stays at the head of the queue
    and ends the pass, so nothing admits past it."""
    groups: dict[int, list] = {}
    while queue and n_free > 0:
        if reserve is not None and not reserve(queue[0]):
            break
        req = queue.popleft()
        n = len(req.prompt)
        bucket = next((k for k in buckets if k >= n), None)
        groups.setdefault(bucket or n, []).append(req)
        n_free -= 1
    return groups
