"""Arithmetic over timelines and samples: interval unions, the reclaimed
bubble of a set of pool timelines, and busy/idle shares.

``union_s`` and the bubble arithmetic are frozen copies of the program's
``rl/coexec.py`` ``_union_s`` and ``MuxReport.reclaimed_bubble_frac``, so
that a change to the program cannot change how its overlap is scored.
"""
from __future__ import annotations


def union_s(intervals) -> float:
    """Total length of the union of (possibly overlapping) intervals."""
    tot = 0.0
    cur_lo = cur_hi = None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                tot += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        tot += cur_hi - cur_lo
    return tot


def merged(intervals) -> list:
    """The union of ``intervals`` as sorted disjoint ``(lo, hi)`` pairs."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def reclaimed_bubble_frac(timelines: dict):
    """``{pool: [(t0, t1), ...]}`` -> the share of the back-to-back bubble
    (total busy time less the busiest pool's) that concurrency reclaimed
    (total busy time less the union of all busy intervals); None when
    there is no bubble (a single pool, or no work)."""
    busy = {p: sum(t1 - t0 for t0, t1 in ivs) for p, ivs in timelines.items()}
    total = sum(busy.values())
    bubble = total - max(busy.values(), default=0.0)
    if bubble <= 0:
        return None
    overlap = total - union_s([iv for ivs in timelines.values()
                               for iv in ivs])
    return overlap / bubble


def idle_gaps(busy, lo: float, hi: float) -> list:
    """The gaps of ``[lo, hi]`` not covered by ``busy`` (disjoint, sorted
    intervals), as ``(start, end)`` pairs, longest first."""
    gaps, at = [], lo
    for b0, b1 in busy:
        if b1 <= lo or b0 >= hi:
            continue
        if b0 > at:
            gaps.append((at, b0))
        at = max(at, b1)
    if hi > at:
        gaps.append((at, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])
