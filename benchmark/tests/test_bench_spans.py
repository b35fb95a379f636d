"""The per-layer metrics of the program's spans on the CPU: a tiny traced
run of each cell reads every one of them, each positive, and in the
adaptive cells launch + wait stays within the whole attempt's mean.  The
adaptive cells trace 2 attempts here, one of them whole: the CPU
profiler takes minutes to close over the 8 of the ensemble cell."""

import pytest

import run
from bench_cells import cell_metrics
from test_bench_harness import TINY

from ksfd_tpu_torch.utils import spans

#: per cell, the metrics read from the spans
SPAN_METRICS = {
    "agg2d.aggregated": ["launch_ms_per_attempt.solver",
                         "wait_ms_per_attempt.solver",
                         "control_ms_per_attempt.solver"],
    "hex2d.ens16": ["launch_ms_per_attempt.ensemble",
                    "wait_ms_per_attempt.ensemble",
                    "control_ms_per_attempt.ensemble"],
    "agg2d.fixed": ["launch_ms_per_step", "pc_launch_ms_per_step"],
}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_tiny_traced_run_reads_the_span_metrics(cell):
    n, seconds, over = TINY[cell]
    if cell != "agg2d.fixed":
        over = dict(over, trace_attempts=2)
    spans.clear()
    try:
        res = run.run_cell(cell, 2 ** 31 + 11, seconds, 1, device="cpu",
                           n=n, overrides=over, out=lambda s: None)
        every = spans.summary()
    finally:
        spans.clear()
    assert res["correct"] is True
    names = SPAN_METRICS[cell]
    assert set(names) <= {m["name"] for m in cell_metrics(cell, True)}
    got = {k: res["metrics"][k]["value"] for k in names}
    assert all(v > 0 for v in got.values()), got
    if cell == "agg2d.fixed":
        assert every["ksfd::step"]["count"] == (
            TINY[cell][2]["steps_per_call"] * 3)
        return
    kind = names[0].split(".")[-1]
    att = every["ksfd::attempt"]
    mean_ms = att["total_s"] * 1e3 / att["count"]
    launch = got["launch_ms_per_attempt." + kind]
    wait = got["wait_ms_per_attempt." + kind]
    assert launch + wait <= mean_ms
    assert launch + wait + got["control_ms_per_attempt." + kind] == (
        pytest.approx(mean_ms))
