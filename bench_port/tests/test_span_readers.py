"""The readers of the program's spans against hand counts: a device trace and
spans made by hand, spans outside the window ignored, overlapping spans
counted once, and no reading where the program recorded no span; the idle
split by span name; and tiny profiled runs of each cell on the CPU, whose
spans (the names the program records) the cell's readers find."""

from __future__ import annotations

import sys
import types

import pytest

from bench_port.lib import common, spans as spans_lib
from bench_port.lib.trace import DeviceTrace

READERS = ("stage1_roofline", "idle_in_dispatch.search", "idle_in_finish.search",
           "optimizer_host_ms.train", "idle_in_processor.train", "idle_in_processor.ingest",
           "processor_ms_per_page.ingest", "to_device_ms_per_page.ingest")


def _reader(name):
    return common.load_module(common.BENCH_DIR / "metrics" / f"{name}.py").read


def _span(name, start, end, device_ms=None, **counts):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end, device_ms=device_ms,
                                 counts=counts)


def _trace():
    """Window [1000, 2000] ns; the device busy over [1000, 1100], [1300,
    1500] and [1900, 2000] (one event before the window's end runs past
    it), so idle over [1100, 1300] and [1500, 1900]: 600 ns."""
    tr = DeviceTrace(False)
    tr.events = [("a", 900, 1100), ("b", 1300, 1400), ("c", 1350, 1500), ("d", 1900, 2100)]
    tr.t0_ns, tr.t1_ns = 1000, 2000
    return tr


SPANS = [
    # processor: A and B overlap (union [1050, 1350]: 200 ns idle), C 100 ns
    # idle; one before the window and one past its end are left out
    _span("processor.images", 1050, 1250, pages=2),
    _span("processor.images", 1200, 1350, pages=1),
    _span("processor.images", 1600, 1700, pages=3),
    _span("processor.images", 500, 900, pages=8),
    _span("processor.images", 1950, 2050, pages=8),
    # the patches' copies: 50 + 30 ns over 2 + 2 pages
    _span("embed.to_device", 1250, 1300, pages=2),
    _span("embed.to_device", 1700, 1730, pages=2),
    # search: dispatches overlap (union [1000, 1320]: 200 ns idle); finish
    # [1450, 1650]: 150 ns idle
    _span("search.dispatch", 1000, 1150),
    _span("search.dispatch", 1120, 1320),
    _span("search.dispatch", 100, 990),
    _span("search.stage1", 1010, 1050, device_ms=3.0),
    _span("search.stage1", 1130, 1160, device_ms=5.0),
    _span("search.stage1", 2010, 2050, device_ms=100.0),
    _span("search.finish", 1450, 1650),
    # training: three steps in the window, two optimizer spans (100 + 200 ns)
    _span("train.step", 1000, 1300),
    _span("train.step", 1300, 1700),
    _span("train.step", 1700, 1990),
    _span("train.optimizer", 1100, 1200),
    _span("train.optimizer", 1400, 1600),
    _span("train.optimizer", 2000, 2500),
]


@pytest.fixture
def hand_spans(monkeypatch):
    monkeypatch.setattr(spans_lib, "program_spans", lambda: list(SPANS))


def test_idle_inside_spans_is_an_intersection_counted_once(hand_spans):
    facts = {"trace": _trace()}
    assert spans_lib.idle_intervals(facts["trace"]) == [(1100, 1300), (1500, 1900)]
    assert _reader("idle_in_processor.train")(facts) == pytest.approx(30.0)
    assert _reader("idle_in_processor.ingest")(facts) == pytest.approx(30.0)
    assert _reader("idle_in_dispatch.search")(facts) == pytest.approx(20.0)
    assert _reader("idle_in_finish.search")(facts) == pytest.approx(15.0)


def test_host_time_readers(hand_spans):
    facts = {"trace": _trace()}
    # (200 + 150 + 100) ns over 2 + 1 + 3 pages
    assert _reader("processor_ms_per_page.ingest")(facts) == pytest.approx(450e-6 / 6)
    assert _reader("to_device_ms_per_page.ingest")(facts) == pytest.approx(80e-6 / 4)
    # (100 + 200) ns over three steps
    assert _reader("optimizer_host_ms.train")(facts) == pytest.approx(300e-6 / 3)


def test_stage1_roofline_is_the_least_time_over_the_spans_device_time(hand_spans):
    # each batch's stage-1 reads 3.35e9 bytes (1 ms at 3.35 TB/s); 8 ms of
    # device time in the window's two spans
    work = [(0.0, 0.0, 3.35e9, 1e6), (0.0, 0.0, 3.35e9, 1e6)]
    assert _reader("stage1_roofline")({"trace": _trace(), "work": work}) == pytest.approx(25.0)
    assert _reader("stage1_roofline")({"trace": _trace(), "work": []}) is None


@pytest.mark.parametrize("name", READERS)
def test_no_reading_without_spans(monkeypatch, name):
    facts = {"trace": _trace(), "work": [(0.0, 0.0, 3.35e9, 1e6)]}
    monkeypatch.setattr(spans_lib, "program_spans", lambda: [])
    assert _reader(name)(facts) is None
    monkeypatch.setattr(spans_lib, "program_spans", lambda: list(SPANS))
    assert _reader(name)({}) is None  # an untraced run has no trace


@pytest.mark.parametrize("name", READERS)
def test_no_reading_from_a_program_without_spans(monkeypatch, name):
    """A parent commit without the tracing module: the readers give None and
    raise nothing."""
    import visual_rag_tpu_torch

    monkeypatch.delattr(visual_rag_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "visual_rag_tpu_torch.tracing", None)
    assert spans_lib.program_spans() == []
    facts = {"trace": _trace(), "work": [(0.0, 0.0, 3.35e9, 1e6)]}
    assert _reader(name)(facts) is None


def test_idle_split_by_name_and_outside_every_span():
    tr = _trace()
    split = spans_lib.idle_split(tr, [
        _span("outer", 1050, 1400), _span("inner", 1080, 1120), _span("inner", 1290, 1310),
        _span("late", 1850, 1950), _span("past", 1950, 2050)])
    # idle [1100, 1300] and [1500, 1900]: outer holds 200 ns of it (its
    # children's 20 + 10 ns among them), late 50 ns; 350 ns outside any
    assert split["idle_s"] == pytest.approx(600e-9)
    assert split["idle_in_spans_s"] == pytest.approx(250e-9)
    assert split["covered_share"] == pytest.approx(250 / 600)
    assert split["names"] == {
        "inner": {"n": 2, "idle_s": pytest.approx(30e-9), "busy_s": pytest.approx(30e-9),
                  "host_s": pytest.approx(60e-9)},
        "late": {"n": 1, "idle_s": pytest.approx(50e-9), "busy_s": pytest.approx(50e-9),
                 "host_s": pytest.approx(100e-9)},
        "outer": {"n": 1, "idle_s": pytest.approx(200e-9), "busy_s": pytest.approx(150e-9),
                  "host_s": pytest.approx(350e-9)},
    }
    assert split["outside"] == [[pytest.approx(350e-9), "untracked host"]]


# each cell's span readers; stage1_roofline reads device time, none on the CPU
CELL_READERS = {
    "colqwen25.search.b1024": ("idle_in_dispatch.search", "idle_in_finish.search"),
    "colqwen25.train.b4": ("optimizer_host_ms.train", "idle_in_processor.train"),
    "colsmol.ingest.b8": ("idle_in_processor.ingest", "processor_ms_per_page.ingest",
                          "to_device_ms_per_page.ingest"),
}


@pytest.mark.parametrize("workload", sorted(CELL_READERS))
def test_a_profiled_tiny_run_gives_each_reader_its_spans(workload):
    """The CPU has no device trace: a CPU profiler session turns the spans
    on, and the untraced window (no device interval, all of it idle) is
    read."""
    from torch.profiler import ProfilerActivity, profile

    from bench_port.tests import tiny
    from visual_rag_tpu_torch import tracing

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        facts = tiny.run(tiny.cell(workload)).facts
    for name in CELL_READERS[workload]:
        value = _reader(name)(facts)
        assert value is not None and value > 0, name
    split = spans_lib.idle_split(facts["trace"], spans_lib.program_spans())
    assert split["covered_share"] > 0 and split["names"]
    tracing.clear()
