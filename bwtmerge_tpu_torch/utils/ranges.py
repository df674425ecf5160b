"""Closed ranges and work partitioning.

Equivalent capability to the reference's range_type/Range (utils.h:71-99) and
getBounds (utils.cpp:169-187); ours partitions work for device shards instead of
threads.
"""

from __future__ import annotations

from typing import List, Tuple

RangeT = Tuple[int, int]  # closed range [first, second]; empty iff first > second


class Range:
    """Closed-range helpers. Empty ranges are (first > second), e.g. (1, 0)."""

    @staticmethod
    def length(r: RangeT) -> int:
        return r[1] + 1 - r[0]

    @staticmethod
    def empty(r: RangeT) -> bool:
        return r[0] + 1 > r[1] + 1

    @staticmethod
    def bound(value: int, low: int, high: int) -> int:
        return max(min(value, high), low)

    @staticmethod
    def empty_range() -> RangeT:
        return (1, 0)


def get_bounds(r: RangeT, blocks: int) -> List[RangeT]:
    """Split the closed range approximately evenly into at most `blocks` blocks.

    Same contract as reference getBounds (utils.cpp:169-187): the actual number of
    blocks is clamped to [1, length(range)]; blocks are contiguous and cover r.
    """
    if Range.empty(r):
        return []
    blocks = Range.bound(blocks, 1, Range.length(r))
    bounds: List[RangeT] = []
    start = r[0]
    for block in range(blocks):
        first = start
        if start <= r[1]:
            start += max(1, (r[1] + 1 - start) // (blocks - block))
        bounds.append((first, start - 1))
    return bounds
