"""Reading a ``torch.profiler`` run: device busy time, launch calls,
device time by span, and the breakdown.

The raw kineto events are read (``kineto_results.events()``), not the
profiler's event tree, which takes tens of seconds to build for one large
train step. The interval union and the launch count are a frozen copy of
the program's ``device_profile`` arithmetic. A device op belongs to the
host op that launched it (its ``linked_correlation_id`` is that op's
``correlation_id``); a host op belongs to the innermost benchmark span
(``bench.<kind>``) open on its thread at its start, else to the autograd
node being evaluated there, whose sequence number names the forward op,
and so the span, that made it. The device side's copies of the spans
(kineto's GPU user annotations) are not device ops.
"""

from __future__ import annotations

import bisect

import numpy as np

SPAN_PREFIX = "bench."
UNIT_SPAN = "bench.unit"
BACKWARD = "autograd::engine::evaluate_function"


def _api_call(name):
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel)."""
    return name[:4] == "cuda" or (name[:2] == "cu" and name[2:3].isupper())


class Trace:
    """The events of one profiled block, as arrays."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        dev, launches, cpu, spans, backward = [], {}, [], [], []
        self.launch_calls = 0
        for e in events:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith(SPAN_PREFIX):
                    dev.append((start, end, e.linked_correlation_id(), name))
                continue
            tid = e.start_thread_id()
            if _api_call(name):
                if name.startswith("cudaLaunch") or name.startswith(
                        "cuLaunch"):
                    self.launch_calls += 1
                continue
            launches[e.correlation_id()] = (tid, start, name)
            if name.startswith(SPAN_PREFIX):
                spans.append((tid, start, end, name[len(SPAN_PREFIX):]))
            elif name.startswith(BACKWARD):
                backward.append((tid, start, end, e.fwd_thread_id(),
                                 e.sequence_nr()))
            else:
                cpu.append((tid, start, end, name, e.sequence_nr()))
        dev.sort()
        self.device = dev
        self.launches = launches
        self.cpu = cpu
        self.spans = spans
        self.backward = backward

    # -- device time -----------------------------------------------------
    def busy_ns(self):
        """The union of the device ops' intervals."""
        busy, end = 0, float("-inf")
        for a, b, _, _ in self.device:
            busy += max(0, b - max(a, end))
            end = max(end, b)
        return busy

    def gaps(self):
        """[(start, end)] of the device's idle gaps between its first and
        last op."""
        out, end = [], None
        for a, b, _, _ in self.device:
            if end is not None and a > end:
                out.append((end, a))
            end = b if end is None else max(end, b)
        return out

    def top_ops(self, n=10):
        """[(device op name, seconds)] of the ``n`` names that took the
        most device time."""
        by = {}
        for a, b, _, name in self.device:
            by[name] = by.get(name, 0) + b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    # -- attribution -------------------------------------------------------
    def _segments(self, intervals):
        """{tid: (starts, ends, labels)}: nested intervals flattened into
        disjoint segments, each labelled with its innermost interval's
        label."""
        by_tid = {}
        for tid, a, b, label in intervals:
            by_tid.setdefault(tid, []).append((a, b, label))
        out = {}
        for tid, ivs in by_tid.items():
            points = sorted([(a, 1, -b, lab) for a, b, lab in ivs]
                            + [(b, 0, 0, None) for a, b, lab in ivs],
                            key=lambda p: (p[0], p[1], p[2]))
            stack, segs, last = [], [], None
            for t, is_start, negb, lab in points:
                if stack and last is not None and t > last:
                    segs.append((last, t, stack[-1][1]))
                if is_start:
                    stack.append((-negb, lab))
                else:
                    stack = [s for s in stack if s[0] > t]
                last = t
            starts = np.array([s[0] for s in segs], dtype=np.int64)
            out[tid] = (starts, np.array([s[1] for s in segs],
                                         dtype=np.int64),
                        [s[2] for s in segs])
        return out

    @staticmethod
    def _lookup(segs, tid, t):
        if tid not in segs:
            return None
        starts, ends, labels = segs[tid]
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < ends[i]:
            return labels[i]
        return None

    def device_ns_by_kind(self):
        """{span kind: device ns of the ops launched inside that kind's
        spans or inside the backward of the ops those spans ran}."""
        span_segs = self._segments(self.spans)
        seq_kind, main = {}, self.main_thread()
        for tid, a, b, name, seq in self.cpu:
            if seq is not None and seq >= 0:
                kind = self._lookup(span_segs, tid, a)
                if kind is not None:
                    seq_kind[(tid, seq)] = kind
        nodes = []
        for tid, a, b, fwd_tid, seq in self.backward:
            # a node whose forward thread the profiler did not name ran
            # forward on the main thread
            kind = seq_kind.get((fwd_tid, seq), seq_kind.get((main, seq)))
            if kind is not None:
                nodes.append((tid, a, b, kind))
        node_segs = self._segments(nodes)
        out = {}
        for a, b, corr, _ in self.device:
            where = self.launches.get(corr)
            if where is None:
                continue
            tid, t, _ = where
            kind = self._lookup(span_segs, tid, t)
            if kind is None:
                kind = self._lookup(node_segs, tid, t)
            if kind is not None:
                out[kind] = out.get(kind, 0) + b - a
        return out

    def idle_gaps(self, n=10):
        """[(what the host was doing, seconds)] of the ``n`` longest idle
        gaps: the host op that launched the device op ending the gap (the
        host was busy up to that launch), with its benchmark span kind
        (``-`` outside every span; a backward op is named as such)."""
        span_segs = self._segments(self.spans)
        starts = [a for a, _, _, _ in self.device]
        out = []
        for a, b in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]:
            i = bisect.bisect_left(starts, b)
            where = self.launches.get(self.device[i][2]) \
                if i < len(self.device) else None
            if where is None:
                out.append(["(no host op)", (b - a) / 1e9])
                continue
            tid, t, name = where
            kind = self._lookup(span_segs, tid, t) or "-"
            out.append([f"{kind}/{name}", (b - a) / 1e9])
        return out

    def main_thread(self):
        """The thread that ran the profiled units."""
        for tid, a, b, kind in self.spans:
            if SPAN_PREFIX + kind == UNIT_SPAN:
                return tid
        return None


def read(prof):
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    return Trace(prof.profiler.kineto_results.events())
