"""The trace reader on a made-up event list: busy time, launch calls and
device time by span, forward spans and the backward nodes they made."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import trace  # noqa: E402

torch = pytest.importorskip("torch")
from torch.autograd import DeviceType  # noqa: E402


class Ev:
    def __init__(self, name, start, end, tid=1, corr=0, linked=0,
                 device=DeviceType.CPU, seq=-1, fwd_tid=0):
        self._v = (name, start, end, tid, corr, linked, device, seq, fwd_tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def device_type(self):
        return self._v[6]

    def sequence_nr(self):
        return self._v[7]

    def fwd_thread_id(self):
        return self._v[8]


def kernel(corr, a, b):
    return Ev(f"k{corr}", a, b, tid=0, linked=corr, device=DeviceType.CUDA)


EVENTS = [
    Ev("bench.unit", 0, 1000, corr=1),
    Ev("bench.coupling", 100, 300, corr=2),
    Ev("aten::conv2d", 110, 200, seq=5, corr=11),
    Ev("cudaLaunchKernel", 150, 155, corr=91),
    Ev("aten::copy_", 340, 380, corr=3),
    Ev("bench.solve", 400, 500, corr=12),
    Ev("cudaLaunchKernel", 450, 455, corr=92),
    # the backward thread: the conv's node, and a recompute span in it
    Ev(trace.BACKWARD + ": ConvolutionBackward0", 600, 700, tid=2, seq=5,
       fwd_tid=1, corr=4),
    Ev("bench.actnorm", 620, 640, tid=2, corr=5),
    Ev("aten::mul", 625, 635, tid=2, corr=14),
    Ev("cudaLaunchKernel", 630, 632, tid=2, corr=93),
    Ev("aten::convolution_backward", 645, 690, tid=2, corr=13),
    Ev("cudaLaunchKernel", 650, 652, tid=2, corr=94),
    Ev("aten::add", 790, 810, corr=15),
    Ev("cudaLaunchKernelExC", 800, 805, corr=95),
    Ev("cudaStreamSynchronize", 950, 990, corr=96),
    kernel(11, 160, 260), kernel(12, 460, 480), kernel(14, 640, 650),
    kernel(13, 660, 700), kernel(15, 810, 900),
    # the device side's copy of a span is no device op
    Ev("bench.solve", 455, 485, tid=0, device=DeviceType.CUDA),
]


def test_busy_launches_and_kinds():
    t = trace.Trace(EVENTS)
    assert t.busy_ns() == 100 + 20 + 10 + 40 + 90
    assert t.launch_calls == 5
    assert t.device_ns_by_kind() == {"coupling": 100 + 40, "solve": 20,
                                     "actnorm": 10, "unit": 90}
    assert t.main_thread() == 1


def test_idle_gaps_name_what_the_host_did():
    t = trace.Trace(EVENTS)
    gaps = t.idle_gaps(n=2)
    assert [g[1] for g in gaps] == [200e-9, 160e-9]
    # the ops that launched the device ops that ended the gaps
    assert gaps[0][0] == "solve/bench.solve"
    assert gaps[1][0] == "actnorm/aten::mul"


def test_top_ops():
    t = trace.Trace(EVENTS)
    assert t.top_ops(2) == [["k11", 100e-9], ["k15", 90e-9]]
