"""The port's host spans (``ksfd_tpu_torch/utils/spans.py``) on the CPU.

Held here: with no profiler nothing is kept and no profiler range is
opened; under ``torch.profiler`` nesting, parents and self time
are right, and a span that straddles the profiler's start or stop is
dropped; in a device-loop ``Solver.solve``, an ``EnsembleSolver`` solve
and a ``make_multistep_fn`` call the span counts equal the program's
own counters, and the profiler's events hold each ``ksfd::`` span with
its children's intervals inside its own.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.solvers import (
    EnsembleSolver,
    Solver,
    make_multistep_fn,
)
from ksfd_tpu_torch.tools.flagship import example_numerics
from ksfd_tpu_torch.tools.problems import bench_clargs
from ksfd_tpu_torch.utils import spans
from ksfd_tpu_torch.utils.spans import span, summary

N = 16
KW = dict(t0=0.0, dt=1e-3, rtol=1e-6, atol=0.01)


@pytest.fixture(autouse=True)
def fresh():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.clear()
    yield
    spans.clear()
    torch.set_num_threads(prev)


def problem():
    """The 2D bench problem at N x N and its start state."""
    ps, grid, ops = problem_from_clargs(bench_clargs(N), N, N, device="cpu")
    x = torch.arange(N, dtype=torch.float64) / N
    bump = torch.sin(2 * np.pi * (x[:, None] + x[None, :]))
    u0 = torch.stack([9000.0 + 90.0 * bump, 9000.0 + 60.0 * bump,
                      9000.0 + 10.0 * bump])
    return ops, u0


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_keeps_nothing_and_never_calls_record_function(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    ops, u0 = problem()
    multi, _ = make_multistep_fn(ops, example_numerics(adapt_type="none"),
                                 atol=0.01, rtol=1e-6)
    h = torch.tensor(1e-3, dtype=torch.float64)
    multi(u0, torch.zeros((), dtype=torch.float64), h, 2)
    s = Solver(ops, example_numerics(), tmax=1.0, maxsteps=2, **KW)
    s.solve(u0)
    with span("attempt") as a, span("tier") as b:
        assert a is b
    assert spans.records() == [] and summary() == {}


def test_nesting_parents_and_self_time():
    with recording():
        with span("attempt"):
            with span("tier"):
                time.sleep(0.002)
                with span("step"):
                    time.sleep(0.003)
            with span("read"):
                time.sleep(0.004)
            time.sleep(0.001)
        with span("attempt"):
            pass
    recs = spans.records()
    names = [r[0] for r in recs]
    assert names == ["ksfd::attempt", "ksfd::tier", "ksfd::step",
                     "ksfd::read", "ksfd::attempt"]
    assert [r[3] for r in recs] == [-1, 0, 1, 0, -1]
    for name, s, e, parent in recs:
        assert e >= s
        if parent >= 0:
            assert recs[parent][1] <= s and e <= recs[parent][2]
    dur = [(e - s) * 1e-9 for _, s, e, _ in recs]
    sm = summary()
    assert sm["ksfd::attempt"]["count"] == 2
    assert sm["ksfd::attempt"]["total_s"] == pytest.approx(dur[0] + dur[4])
    assert sm["ksfd::attempt"]["self_s"] == pytest.approx(
        dur[0] - dur[1] - dur[3] + dur[4])
    assert sm["ksfd::tier"]["self_s"] == pytest.approx(dur[1] - dur[2])
    assert sm["ksfd::step"]["self_s"] == pytest.approx(dur[2])
    assert 0.001 <= sm["ksfd::attempt"]["self_s"] < sm["ksfd::attempt"][
        "total_s"]
    assert set(summary(within="ksfd::tier")) == {"ksfd::step"}
    assert set(summary(within="ksfd::attempt")) == {
        "ksfd::tier", "ksfd::step", "ksfd::read"}


@pytest.mark.parametrize("edge", ["start", "stop"])
def test_a_span_that_straddles_the_profiler_is_dropped(edge):
    prof = recording()
    if edge == "stop":
        prof.__enter__()
    with span("attempt"):
        if edge == "start":
            prof.__enter__()
        with span("tier"):
            pass
        if edge == "stop":
            prof.__exit__(None, None, None)
    if edge == "start":
        with span("read"):
            pass
        prof.__exit__(None, None, None)
    with span("attempt"):
        pass
    recs = spans.records()
    if edge == "start":
        # the child inside the session is kept, with no parent
        assert [(r[0], r[3]) for r in recs] == [("ksfd::tier", -1),
                                                ("ksfd::read", -1)]
        assert summary(within="ksfd::attempt") == {}
    else:
        # the child ended before the stop; its parent straddles it
        assert [(r[0], r[3]) for r in recs] == [("ksfd::tier", -1)]
    assert "ksfd::attempt" not in summary()


def _nearest_span(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith(spans.PREFIX):
        p = p.cpu_parent
    return p


_RUNS = {}


def _run(kind):
    """Run ``kind`` under the profiler once per module; returns (summary,
    the program's counts to hold it to, the profiler's ``ksfd::``
    events, the kept spans)."""
    if kind not in _RUNS:
        _RUNS[kind] = _profiled(kind)
    return _RUNS[kind]


def _profiled(kind):
    ops, u0 = problem()
    with recording() as prof:
        if kind == "solver":
            s = Solver(ops, example_numerics(), tmax=1.0, maxsteps=6, **KW)
            s.solve(u0)
            st = s.stats
            assert st.chunk_attempts > 0 and st.host_retries == 0
            want = {"ksfd::attempt": st.chunk_attempts,
                    "ksfd::read": st.chunk_attempts,
                    "ksfd::tier": sum(st.tier_calls),
                    "ksfd::dispatch": st.dispatches}
        elif kind == "ensemble":
            U0 = torch.stack([u0, u0 * 1.001, u0 * 0.999])
            es = EnsembleSolver(ops, example_numerics(), tmax=1.0,
                                maxsteps=4, **KW)
            es.solve(U0)
            tot = es._chunk.totals
            assert tot.reads > 0
            want = {"ksfd::attempt": tot.reads, "ksfd::read": tot.reads,
                    "ksfd::tier": tot.occupied,
                    "ksfd::dispatch": tot.dispatches}
        else:
            nm = example_numerics(adapt_type="none")
            multi, tab = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6)
            nsteps = 3
            multi(u0, torch.zeros((), dtype=torch.float64),
                  torch.tensor(1e-3, dtype=torch.float64), nsteps)
            want = {"ksfd::step": nsteps,
                    "ksfd::pc": nm.ksp_iters * tab.stages * nsteps}
    events = [ev for ev in prof.events() if ev.name.startswith(spans.PREFIX)]
    return (summary(), want, events, spans.records(),
            summary(within="ksfd::attempt"))


@pytest.mark.parametrize("kind", ["solver", "ensemble", "multistep"])
def test_span_counts_equal_the_program_counters(kind):
    sm, want, _, _, inside = _run(kind)
    got = {name: sm.get(name, {}).get("count", 0) for name in want}
    assert got == want
    if kind != "multistep":
        assert inside["ksfd::tier"]["count"] == want["ksfd::tier"]
        assert (inside["ksfd::tier"]["total_s"]
                + inside["ksfd::read"]["total_s"]
                <= sm["ksfd::attempt"]["total_s"])
        assert sm["ksfd::post_accept"]["count"] >= 1
        assert sm["ksfd::step"]["count"] == want["ksfd::tier"]


@pytest.mark.parametrize("kind", ["solver", "ensemble", "multistep"])
def test_the_profiler_events_hold_each_span_and_its_children(kind):
    sm, _, events, recs, _ = _run(kind)
    counts = {}
    for ev in events:
        counts[ev.name] = counts.get(ev.name, 0) + 1
    assert counts == {name: agg["count"] for name, agg in sm.items()}
    nested = 0
    # a user annotation would be mirrored on the card's row, where it
    # would read as busy time
    assert not any(ev.is_user_annotation for ev in events)
    for ev, (name, _, _, parent) in zip(
            sorted(events, key=lambda e: (e.time_range.start,
                                     -e.time_range.end)), recs):
        assert ev.name == name
        outer = _nearest_span(ev)
        if parent < 0:
            assert outer is None
            continue
        nested += 1
        assert outer.name == recs[parent][0]
        assert outer.time_range.start <= ev.time_range.start
        assert ev.time_range.end <= outer.time_range.end
    assert nested > 0
