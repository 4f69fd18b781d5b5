"""What the program's own spans say in a traced stretch.

The port marks its phases with ``loans.*`` ranges (``loans_tpu_torch/
utils/tracing.py``), which the trace keeps among its host events beside
the runtime calls. Here a span's time is host time, on the trace's clock:
the union of the named spans' intervals. "Synchronising calls" are the
runtime calls named ``cuda*Synchronize``, "copy calls" those named
``cudaMemcpy*``. A trace whose program has no such span (a commit before
the spans) reads ``None``, as does a run off the card.
"""

from __future__ import annotations

import re

from perfbench.trace import RUNTIME_CATS
from perfbench.yardstick import merged

SYNC = re.compile(r"^cuda\w*Synchronize$")
COPY = re.compile(r"^cudaMemcpy")


def span_intervals(trace, names) -> list[tuple[float, float]]:
    """The union of the host intervals of the spans named ``names`` inside
    the traced stretch, in microseconds, as disjoint sorted intervals."""
    found = [(a, b) for a, b, name, cat in trace.host if cat == "user_annotation" and name in names]
    return merged(found, *trace.window)


def runtime_calls(trace, *patterns) -> list[tuple[float, float]]:
    """The runtime calls whose name matches one of ``patterns``."""
    return [(a, b) for a, b, name, cat in trace.host
            if cat in RUNTIME_CATS and any(p.match(name) for p in patterns)]


def overlap(xs, ys) -> float:
    """Length of the intersection of two lists of disjoint sorted
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_ms(ctx, names, units: str) -> float | None:
    """Host milliseconds inside the spans ``names``, less the part spent in
    synchronising and copy calls, per traced ``units``."""
    spans = _spans(ctx, names)
    if spans is None:
        return None
    waits = merged(runtime_calls(ctx.trace_data, SYNC, COPY), *ctx.trace_data.window)
    inside = sum(b - a for a, b in spans) - overlap(spans, waits)
    return 1e-3 * inside / ctx.traced_units[units]


def span_ms(ctx, names, units: str) -> float | None:
    """Host milliseconds inside the spans ``names``, waits included, per
    traced ``units``."""
    spans = _spans(ctx, names)
    if spans is None:
        return None
    return 1e-3 * sum(b - a for a, b in spans) / ctx.traced_units[units]


def syncs_per(ctx, names, units: str) -> float | None:
    """Synchronising calls that start inside the spans ``names``, per
    traced ``units``."""
    spans = _spans(ctx, names)
    if spans is None:
        return None
    starts = [a for a, _ in runtime_calls(ctx.trace_data, SYNC)]
    return sum(1 for t in starts if any(a <= t <= b for a, b in spans)) / ctx.traced_units[units]


def _spans(ctx, names):
    if ctx.device.type != "cuda":
        return None
    return span_intervals(ctx.trace_data, names) or None
