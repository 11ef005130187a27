"""What the per-layer metrics' readers (metrics/*.py) share: the mean of a
span over the traced window's steps, and the device's idle share from the
profiler's window."""
from __future__ import annotations

import statistics
from typing import Optional


def mean_span(record: Optional[dict], span: str) -> Optional[float]:
    """The mean ms of `span` over the window's steps; None if no step has
    it."""
    if not record:
        return None
    values = [s[span] for s in record["spans"] if span in s]
    return statistics.fmean(values) if values else None


def idle_pct(record: Optional[dict]) -> Optional[float]:
    """100 x the share of the profiled window in which no operation ran on
    the device; None without a device trace."""
    prof = record and record.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
