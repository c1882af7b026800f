"""Reading the program's own spans (``ift.*``) in a traced run.

The port opens a span at each of its layer boundaries while a profiler
records (``inverse_flow_tpu_torch/utils/profiling.py:SPANS``). They are
host events of FUNCTION scope, on the kernels' clock, so
:class:`benchmark.trace.Trace` keeps them among its host ops
(``Trace.cpu``); this module reads them there. A program without them
gives nothing to read, and every reader returns None.

A device op is put down to the innermost ``ift.`` span open on the thread
that launched it, else to the autograd node being evaluated there, whose
sequence number names the forward op, and so the span, that made it: the
rule of ``Trace.device_ns_by_kind``, on the program's spans. An
``ift.coupling.net`` span that opens while the main thread's
``ift.step.backward`` is open is the checkpoint's recompute of the net
(it runs on the backward's thread on the card): it is labelled
:data:`RECOMPUTE`, and the backward of the net stays with the forward's
``ift.coupling.net``. An idle gap of the device goes to the label of the
op that ended it: the host was busy up to that op's launch.
"""

from __future__ import annotations

import bisect

from benchmark import readers

PREFIX = "ift."
UNIT_SPANS = ("ift.step", "ift.sample")
BACKWARD_SPAN = "ift.step.backward"
NET_SPAN = "ift.coupling.net"
RECOMPUTE = "ift.coupling.net (recompute)"


class Inner:
    """The program's spans of one :class:`benchmark.trace.Trace`, and the
    label of each device op."""

    def __init__(self, trace):
        self.trace = trace
        spans = [(tid, a, b, name) for tid, a, b, name, _ in trace.cpu
                 if name.startswith(PREFIX)]
        units = [s for s in spans if s[3] in UNIT_SPANS]
        self.main = units[0][0] if units else None
        self.units = [s for s in units if s[0] == self.main]
        backward = sorted((a, b) for tid, a, b, name in spans
                          if tid == self.main and name == BACKWARD_SPAN)
        starts = [a for a, _ in backward]

        def in_backward(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t < backward[i][1]

        labelled = [(tid, a, b, RECOMPUTE if name == NET_SPAN
                     and in_backward(a) else name)
                    for tid, a, b, name in spans]
        self.spans = labelled
        self.span_segs = trace._segments(labelled)
        seq_label = {}
        for tid, a, b, name, seq in trace.cpu:
            if seq is not None and seq >= 0:
                label = trace._lookup(self.span_segs, tid, a)
                if label is not None:
                    seq_label[(tid, seq)] = label
        nodes = []
        for tid, a, b, fwd_tid, seq in trace.backward:
            # a node whose forward thread the profiler did not name ran
            # forward on the main thread
            label = seq_label.get((fwd_tid, seq),
                                  seq_label.get((self.main, seq)))
            if label is not None:
                nodes.append((tid, a, b, label))
        self.node_segs = trace._segments(nodes)

        # the label of each device op, in the order of trace.device
        self.labels = [self._label(corr) for _, _, corr, _ in trace.device]

    def _label(self, corr):
        """The label of the device op launched by host op ``corr``, or
        None outside every ``ift.`` span and its backward."""
        where = self.trace.launches.get(corr)
        if where is None:
            return None
        tid, t, _ = where
        label = self.trace._lookup(self.span_segs, tid, t)
        if label is None:
            label = self.trace._lookup(self.node_segs, tid, t)
        return label

    def device_ns(self):
        """{label (None: no span): device ns of the ops it launched}."""
        out = {}
        for (a, b, _, _), label in zip(self.trace.device, self.labels):
            out[label] = out.get(label, 0) + b - a
        return out

    def gap_labels(self):
        """[(start, end, label)] of the device's idle gaps, each with the
        label of the op that ended it."""
        starts = [a for a, _, _, _ in self.trace.device]
        return [(a, b, self.labels[bisect.bisect_left(starts, b)])
                for a, b in self.trace.gaps()]

    def idle_ns(self):
        """{label (None: no span): idle ns of the gaps that its ops
        ended}."""
        out = {}
        for a, b, label in self.gap_labels():
            out[label] = out.get(label, 0) + b - a
        return out

    def host_ns(self, name):
        """Host ns in the main thread's spans ``name``."""
        return sum(b - a for tid, a, b, n in self.spans
                   if tid == self.main and n == name)


def of(ctx):
    """The :class:`Inner` of ``ctx``'s trace (read once a run), or None
    where the trace holds none of the program's unit spans."""
    if getattr(ctx, "_inner", None) is None:
        ctx._inner = Inner(ctx.trace)
    return ctx._inner if ctx._inner.units else None


def device_ms(ctx, entry, label):
    """Device ms a profiled unit of the ops put down to ``label``."""
    if not readers.traced(ctx, entry) or of(ctx) is None:
        return None
    ns = of(ctx).device_ns().get(label)
    return ns / 1e6 / ctx.traced_units if ns else None


def enqueue_ms(ctx, entry, name):
    """Host ms a profiled unit inside the unit span ``name``: the time the
    host took to enqueue the unit's work, under the profiler."""
    if not readers.traced(ctx, entry) or of(ctx) is None:
        return None
    ns = of(ctx).host_ns(name)
    return ns / 1e6 / ctx.traced_units if ns else None


def idle_by_span(trace, units):
    """{label: idle ns a unit}, by the span that launched the op ending
    each idle gap (``-``: no span)."""
    return {label or "-": ns / units
            for label, ns in Inner(trace).idle_ns().items()}


def shares(trace):
    """[(device share, idle share)] a profiled unit: the shares of its
    device ops' time and of its idle gaps' time put down to some ``ift.``
    span. A device op or gap belongs to the unit whose span last started
    on the host before the op (or the gap's end) on the device."""
    inner = Inner(trace)
    starts = sorted(a for _, a, _, _ in inner.units)
    dev = [[0, 0] for _ in starts]
    idle = [[0, 0] for _ in starts]

    def add(into, t, ns, label):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0:
            into[i][0] += ns if label is not None else 0
            into[i][1] += ns

    for (a, b, _, _), label in zip(trace.device, inner.labels):
        add(dev, a, b - a, label)
    for a, b, label in inner.gap_labels():
        add(idle, b, b - a, label)
    return [(d[0] / d[1] if d[1] else None, g[0] / g[1] if g[1] else None)
            for d, g in zip(dev, idle)]
