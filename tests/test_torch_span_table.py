"""`summersph_tpu_torch.span_table`'s attribution, held to a synthetic
profile: a device operation goes to the span its launch starts in (by
correlation id), overlapping operations count once, self against
inclusive, each idle hole goes to the innermost span at its midpoint, to
the profiler's buffer row, or to the row of no span, and a span left open
is left out.  No JAX, no card."""

from types import SimpleNamespace

import pytest

from summersph_tpu_torch import span_table

START_NS = 10_000_000_000


def event(name, a, b, *, device=False, id=0, linked=0):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=a, end=b),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        id=id, linked_correlation_id=linked, is_user_annotation=False)


def span(name, parent, step, a_us, b_us):
    return (name, parent, step, START_NS + int(a_us * 1e3),
            START_NS + int(b_us * 1e3))


@pytest.fixture(scope="module")
def table():
    # step [0, 100) > force_eval [10, 60) > sort [12, 30); stats [70, 90)
    collected = {"spans": [span("step", -1, 0, 0, 100),
                           span("force_eval", 0, 0, 10, 60),
                           span("sort", 1, 0, 12, 30),
                           span("stats", 0, 0, 70, 90)],
                 "counters": {"sph_candidates": 300, "sph_rows": 3},
                 "dropped": 0}
    events = [
        # launches (runtime calls) and the operations they start
        event("cudaLaunchKernel", 13, 14, id=1),     # in sort
        event("cudaLaunchKernel", 15, 16, id=2),     # in sort
        event("cudaLaunchKernel", 40, 41, id=3),     # in force_eval
        event("cudaLaunchKernel", 75, 76, id=4),     # in stats
        event("cudaLaunchKernel", 120, 121, id=5),   # after every span
        event("sort_a", 20, 30, device=True, id=1),
        event("sort_b", 25, 35, device=True, id=2),          # overlaps a
        event("force", 45, 55, device=True, linked=3),       # linked id
        event("stats", 80, 84, device=True, id=4),
        event("late", 130, 140, device=True, id=5),
        event("orphan", 95, 96, device=True, id=99),         # no launch
        # the profiler's buffer request over the hole (84, 95)
        event(span_table.BUFFER_CALL, 86, 93),
    ]
    return span_table.Table(events, START_NS, collected)


def test_host_time_inclusive_and_self(table):
    r = table.rows
    assert r["step"].host_us == pytest.approx(100.0)
    assert r["step"].host_self_us == pytest.approx(100 - 50 - 20)
    assert r["force_eval"].host_self_us == pytest.approx(50 - 18)
    assert r["sort"].host_self_us == pytest.approx(18)
    assert table.steps == 1


def test_correlation_and_union(table):
    assert table.device_ops == 6
    assert table.device_ops_linked == 5          # the orphan has no launch
    assert table.device_ops_in_span == 4         # 'late' is after the spans
    r = table.rows
    # sort_a and sort_b overlap: [20, 35) once
    assert r["sort"].device_us == pytest.approx(15.0)
    assert r["sort"].launches == 2
    assert r["force_eval"].device_us == pytest.approx(15.0 + 10.0)
    assert r["force_eval"].device_self_us == pytest.approx(10.0)
    assert r["force_eval"].launches_self == 1
    assert r["step"].device_us == pytest.approx(15 + 10 + 4)
    assert r["step"].device_self_us == 0.0
    assert table.step_child_share() == pytest.approx(1.0)
    assert table.device_us(["sort", "stats"]) == pytest.approx(19.0)
    assert table.device_us(["sort", "force_eval"]) == pytest.approx(25.0)


def test_gaps_go_to_the_innermost_span_or_their_own_rows(table):
    # window [13, 140): device union [20, 35) [45, 55) [80, 84) [95, 96)
    # [130, 140); holes (13, 20) in sort, (35, 45) in force_eval,
    # (55, 80) midpoint 67.5 in step, (84, 95) in the buffer request,
    # (96, 130) midpoint 113 in no span
    r = table.rows
    assert r["sort"].idle_self_us == pytest.approx(7.0)
    assert r["force_eval"].idle_self_us == pytest.approx(10.0)
    assert r["force_eval"].idle_us == pytest.approx(17.0)
    assert r["step"].idle_self_us == pytest.approx(25.0)
    assert r["step"].idle_us == pytest.approx(42.0)
    assert r[span_table.PROFILER_ROW].idle_us == pytest.approx(11.0)
    assert r[span_table.NO_SPAN_ROW].idle_us == pytest.approx(34.0)
    assert table.window_us == pytest.approx(127.0)
    assert table.busy_us == pytest.approx(15 + 10 + 4 + 1 + 10)


def test_lines(table):
    lines = table.lines()
    assert lines[0].startswith("span step n=1 host_ms=0.1 ")
    assert "counter sph_candidates 300" in lines
    assert lines[-1].startswith("spans: 4 spans (0 dropped), 1 steps")


def test_union_us():
    assert span_table.union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert span_table.union_us([]) == 0.0


def test_a_span_left_open_is_left_out():
    # segment [0, 50) > step, left open > sort [5, 10): the sort's parent
    # becomes none, and its device operation stays its own
    collected = {"spans": [span("segment", -1, -1, 0, 50),
                           ("step", 0, 0, START_NS, 0),
                           span("sort", 1, 0, 5, 10)],
                 "counters": {}, "dropped": 0}
    events = [event("cudaLaunchKernel", 6, 7, id=1),
              event("sort_a", 8, 9, device=True, id=1)]
    t = span_table.Table(events, START_NS, collected)
    assert [s[0] for s in t.spans] == ["segment", "sort"]
    assert [s[1] for s in t.spans] == [-1, -1]
    assert t.steps == 0
    assert t.rows["sort"].device_us == pytest.approx(1.0)
    assert t.rows["segment"].device_us == 0.0
