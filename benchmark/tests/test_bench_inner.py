"""The reader of the program's own spans on made-up event lists: the
innermost span, the backward through sequence numbers, the recompute
told from the forward by the backward's window, idle gaps, the enqueue
time, and a trace without the program's spans."""

import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, inner, trace  # noqa: E402

pytest.importorskip("torch")
from benchmark.tests.test_bench_trace import (  # noqa: E402
    EVENTS as NO_PROGRAM_SPANS, Ev, kernel)

NET, RECOMPUTE = "ift.coupling.net", inner.RECOMPUTE

# one train step: the main thread (1) runs the forward, opens the
# backward's span and waits in it; the backward's thread (2) evaluates
# the nodes and recomputes a net inside one of them
EVENTS = [
    Ev("bench.unit", 0, 2000, corr=90),
    Ev("ift.step", 10, 1500, corr=1),
    Ev("ift.step.forward", 20, 400, corr=2),
    Ev("ift.coupling", 30, 200, corr=3),
    Ev(NET, 40, 150, corr=4),
    Ev("aten::conv2d", 50, 100, seq=5, corr=11),
    Ev("aten::mul", 160, 190, seq=6, corr=12),
    Ev("ift.solve", 210, 300, corr=5),
    Ev("ift.solve.build", 220, 250, corr=6),
    Ev("aten::bmm", 225, 240, corr=13),
    # the chain kernel is launched through ctypes: its launching op is
    # the span itself
    Ev("ift.solve.chain", 260, 290, corr=7),
    Ev("aten::sum", 310, 320, seq=7, corr=14),
    Ev("ift.step.backward", 500, 1200, corr=8),
    Ev(trace.BACKWARD + ": ConvolutionBackward0", 600, 700, tid=2, seq=5,
       fwd_tid=1, corr=9),
    Ev(NET, 610, 650, tid=2, corr=10),
    Ev("aten::conv2d", 615, 640, tid=2, seq=3, corr=15),
    Ev("aten::convolution_backward", 660, 690, tid=2, corr=16),
    Ev(trace.BACKWARD + ": MulBackward0", 710, 750, tid=2, seq=6,
       fwd_tid=1, corr=30),
    Ev("aten::mul", 720, 740, tid=2, corr=17),
    # a node whose forward thread the profiler did not name
    Ev(trace.BACKWARD + ": SumBackward0", 760, 800, tid=2, seq=7,
       fwd_tid=0, corr=31),
    Ev("aten::ones", 765, 770, tid=2, corr=18),
    Ev("ift.step.optim", 1300, 1400, corr=19),
    Ev("aten::_foreach_add", 1310, 1390, corr=20),
    # the loss read back, outside the step
    Ev("aten::item", 1600, 1650, corr=21),
    kernel(11, 160, 260), kernel(12, 270, 280), kernel(13, 290, 300),
    kernel(7, 300, 340), kernel(14, 350, 355), kernel(15, 650, 700),
    kernel(16, 700, 760), kernel(17, 780, 790), kernel(18, 800, 805),
    kernel(20, 1400, 1410), kernel(21, 1700, 1710),
]


def labels(events):
    t = trace.Trace(events)
    i = inner.Inner(t)
    return {name: label for (_, _, _, name), label in zip(t.device,
                                                          i.labels)}


def ctx_of(events, entry="train", units=1):
    return SimpleNamespace(entry=entry, trace=trace.Trace(events),
                           traced_units=units)


def test_a_device_op_goes_to_the_innermost_span_on_its_thread():
    got = labels(EVENTS)
    assert got["k11"] == NET
    assert got["k12"] == "ift.coupling"
    assert got["k13"] == "ift.solve.build"
    assert got["k7"] == "ift.solve.chain"
    assert got["k14"] == "ift.step.forward"
    assert got["k20"] == "ift.step.optim"
    assert got["k21"] is None


def test_the_backward_follows_the_sequence_numbers():
    got = labels(EVENTS)
    # the net's backward stays with the forward's net, not the recompute
    assert got["k16"] == NET
    assert got["k17"] == "ift.coupling"
    # the forward thread unnamed: the main thread's op of that number
    assert got["k18"] == "ift.step.forward"


def test_the_recompute_is_a_net_inside_the_backwards_window():
    assert labels(EVENTS)["k15"] == RECOMPUTE
    # on the CPU the backward runs on the calling thread: same rule
    cpu = [Ev("ift.step", 0, 1000, corr=1),
           Ev("ift.step.forward", 10, 400, corr=2),
           Ev(NET, 100, 200, corr=3),
           Ev("aten::conv2d", 110, 150, seq=1, corr=11),
           Ev("ift.step.backward", 500, 900, corr=4),
           Ev(NET, 600, 700, corr=5),
           Ev("aten::conv2d", 610, 650, seq=9, corr=12),
           kernel(11, 150, 200), kernel(12, 650, 680)]
    assert inner.Inner(trace.Trace(cpu)).device_ns() == {NET: 50,
                                                         RECOMPUTE: 30}
    # a net outside every step's backward is a forward
    outside = [e for e in cpu if e.name() != "ift.step.backward"]
    assert inner.Inner(trace.Trace(outside)).device_ns() == {NET: 80}


def test_device_ns_and_the_readers():
    t = trace.Trace(EVENTS)
    assert inner.Inner(t).device_ns() == {
        NET: 100 + 60, "ift.coupling": 10 + 10, "ift.solve.build": 10,
        "ift.solve.chain": 40, "ift.step.forward": 5 + 5, RECOMPUTE: 50,
        "ift.step.optim": 10, None: 10}
    ctx = ctx_of(EVENTS, units=2)
    assert inner.device_ms(ctx, "train", "ift.solve.chain") == 40 / 1e6 / 2
    assert inner.device_ms(ctx, "sample", "ift.solve.chain") is None
    assert inner.device_ms(ctx, "train", "ift.act") is None


def test_the_enqueue_time_is_the_unit_spans_host_time():
    ctx = ctx_of(EVENTS, units=2)
    assert inner.enqueue_ms(ctx, "train", "ift.step") == 1490 / 1e6 / 2
    assert inner.of(ctx).host_ns("ift.step.backward") == 700
    # the backward thread's spans are not the main thread's
    assert inner.of(ctx).host_ns(NET) == 110


def test_idle_gaps_go_to_the_span_of_the_op_that_ended_them():
    t = trace.Trace(EVENTS)
    assert inner.idle_by_span(t, 1) == {
        "ift.coupling": (270 - 260) + (780 - 760),
        "ift.solve.build": 290 - 280,
        "ift.step.forward": (350 - 340) + (800 - 790),
        RECOMPUTE: 650 - 355, "ift.step.optim": 1400 - 805,
        "-": 1700 - 1410}
    assert inner.idle_by_span(t, 2)["-"] == (1700 - 1410) / 2
    (busy, idle), = inner.shares(t)
    assert busy == pytest.approx(1 - 10 / 310)
    assert idle == pytest.approx(1 - 290 / 1240)


def test_metrics_read_the_programs_spans():
    ctx = ctx_of(EVENTS)
    expect = {"solve_build_ms.train": 10e-6, "chain_ms.train": 40e-6,
              "coupling_recompute_ms.train": 50e-6, "act_ms.train": None,
              "optim_ms.train": 10e-6, "enqueue_ms.train": 1490e-6,
              "act_ms.sample": None, "enqueue_ms.sample": None}
    for name, value in expect.items():
        got = harness.load_module("metrics", name).read(ctx)
        assert got == (None if value is None else pytest.approx(value)), name


@pytest.mark.parametrize("name", [
    "solve_build_ms.train", "chain_ms.train", "coupling_recompute_ms.train",
    "act_ms.train", "act_ms.sample", "optim_ms.train", "enqueue_ms.train",
    "enqueue_ms.sample"])
@pytest.mark.parametrize("entry", ["train", "sample"])
def test_a_program_without_spans_gives_nothing(name, entry):
    """The parent's program opens no span: every reader returns None."""
    ctx = ctx_of(NO_PROGRAM_SPANS, entry=entry)
    assert harness.load_module("metrics", name).read(ctx) is None
    assert inner.shares(ctx.trace) == []
    ctx.trace = None
    assert harness.load_module("metrics", name).read(ctx) is None


def test_the_breakdown_for_perf_md():
    from benchmark import breakdown

    b = breakdown.breakdown(trace.Trace(EVENTS), 1, [5, 200_000])
    assert b["busy_ms"] == 310e-6
    assert b["device_ms_by_span"][NET] == 160e-6
    assert b["device_ms_by_span"]["-"] == 10e-6
    assert list(b["idle_ms_by_span"])[0] == "ift.step.optim"
    assert b["top_ops_by_span"]["k11"] == {NET: 100e-6}
    assert b["spans"][NET] == 1 and b["spans"][RECOMPUTE] == 1
    assert b["launch_calls_over_100us"] == 1
    assert b["launch_call_ms"] == pytest.approx(0.200005)
