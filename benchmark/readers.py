"""Shared arithmetic of the metric readers in ``metrics/``.

Each reader is ``read(ctx) -> number or None`` over a
:class:`benchmark.harness.Context`; None leaves the metric out of the
result line (nothing to read in this cell or this run).
"""

from __future__ import annotations


def rate(ctx, entry):
    """Images a second over the window: every image of every unit
    completed, over the time from the window's start to the last unit's
    end."""
    if ctx.entry != entry or not ctx.window_s:
        return None
    return ctx.images / ctx.window_s


def traced(ctx, entry):
    """Whether the run traced units of ``entry``."""
    return ctx.entry == entry and ctx.trace is not None and \
        ctx.traced_units > 0


def busy_share_idle(ctx, entry):
    """100 x (1 - device busy seconds a profiled unit / untraced wall
    seconds a unit)."""
    if not traced(ctx, entry) or not ctx.unit_s:
        return None
    busy = ctx.trace.busy_ns() / 1e9 / ctx.traced_units
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx.unit_s)


def launches(ctx, entry):
    if not traced(ctx, entry):
        return None
    return ctx.trace.launch_calls / ctx.traced_units


def kind_ms(ctx, entry, kind):
    """Device ms a profiled unit in the spans of ``kind`` and their
    backward."""
    if not traced(ctx, entry):
        return None
    if getattr(ctx, "_by_kind", None) is None:
        ctx._by_kind = ctx.trace.device_ns_by_kind()
    ns = ctx._by_kind.get(kind)
    if not ns:
        return None
    return ns / 1e6 / ctx.traced_units


def mfu(ctx, entry):
    """100 x the least time of the unit's math at the card's peaks over
    the untraced wall seconds a unit."""
    from benchmark import work

    if ctx.entry != entry or ctx.peaks is None or not ctx.unit_s:
        return None
    return 100.0 * work.least_time_s(ctx.work, ctx.peaks) / ctx.unit_s
