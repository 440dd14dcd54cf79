"""Locality-aware preferred allocation for GPUs (counterpart of
``kata_xpu_device_plugin_tpu/topology/preferred.py``).

The reference stubs ``GetPreferredAllocation`` (``generic_device_plugin.go:
378-386`` returns ``nil, nil``). GPUs, unlike TPU chips, form no grid a
request must fit: any set is a valid allocation. What a choice still
decides is locality: GPUs on one NUMA node share a socket's memory, and
GPUs behind one PCI switch talk without crossing the root complex. So the
policy fills from one NUMA node (the one the must-include GPUs are on, then
the one that can hold most of the request), the way
``VfioAllocator.preferred`` groups IOMMU groups, and inside a node prefers
GPUs that share the deepest upstream PCI path with those already picked.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence


@dataclass(frozen=True)
class Placement:
    """A chosen GPU set; ``contiguous``: every GPU on one NUMA node (or none
    reports its node)."""

    chips: tuple[int, ...]
    contiguous: bool


def _shared_depth(a: tuple[str, ...], b: tuple[str, ...]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def choose_chips(
    chips: Sequence,
    available: Sequence[int],
    count: int,
    must_include: Sequence[int] = (),
) -> Placement:
    """Pick ``count`` GPUs from ``available`` (device ids), keeping
    ``must_include``. ``chips`` are the inventory's
    :class:`~..discovery.gpu.GpuChip` (``index``, ``numa_node``,
    ``upstream``). Deterministic: ties go to the lower device id."""
    avail = sorted(set(available))
    must = sorted(set(must_include))
    if count > len(avail) or len(must) > count or not set(must) <= set(avail):
        raise ValueError(
            f"cannot allocate {count} GPUs from {len(avail)} available "
            f"(must_include={must})"
        )
    by_index = {c.index: c for c in chips}

    def node(i: int):
        c = by_index.get(i)
        return c.numa_node if c is not None else None

    def path(i: int) -> tuple[str, ...]:
        c = by_index.get(i)
        return c.upstream if c is not None else ()

    picked = list(must)
    groups: dict[object, list[int]] = {}
    for i in avail:
        if i not in must:
            groups.setdefault(node(i), []).append(i)
    pinned = {node(i) for i in must} - {None}
    order = sorted(
        groups,
        key=lambda n: (n not in pinned, n is None, -len(groups[n]),
                       -1 if n is None else n),
    )
    for n in order:
        cands = groups[n]
        while cands and len(picked) < count:
            best = min(cands, key=lambda i: (
                -max((_shared_depth(path(i), path(p)) for p in picked), default=0),
                -sum(1 for j in cands if path(j) == path(i)),
                i,
            ))
            picked.append(best)
            cands.remove(best)
    chosen = tuple(sorted(picked))
    return Placement(chips=chosen,
                     contiguous=len({node(i) for i in chosen} - {None}) <= 1)


def chip_ids_to_indexes(ids: Iterable[str]) -> list[int]:
    """Device-plugin device ids are strings; GPUs are host-local ints."""
    return [int(i) for i in ids]
