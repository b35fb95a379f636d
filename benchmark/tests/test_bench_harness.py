"""The harness's plumbing on the CPU at tiny grids: BENCHMARK.json
against the contract, cells and metrics found by name, the episode
accounting, the last line's keys and the no-JAX check."""

import json
import re
import subprocess
import sys

import pytest
import torch

import run
from bench_cells import BENCH, ROOT, cell_metrics, load_benchmark, load_cell
from bench_trace import gaps, union_seconds

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

#: tiny versions of each cell: grid, seconds and traffic overrides
TINY = {
    "agg2d.aggregated": (24, 0.5, dict(ramp_accepts=12, span=1.0)),
    "hex2d.ens16": (16, 0.5, dict(members=3, span=0.02)),
    "agg2d.fixed": (16, 0.5, dict(steps_per_call=2)),
}


def test_benchmark_json_keeps_to_the_contract():
    b = load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    assert 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / (m["name"] + ".py")).exists()
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for name, w in cells.items():
        assert NAME.match(name) and w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in configs
        _, wl, cfg = load_cell(name)
        assert (BENCH / "runners" / (wl["kind"] + ".py")).exists()
        assert set(wl["limits"]) == {"state_gap", "enorm_gap",
                                     "decision_faults"}
        reported = [m["name"] for m in cell_metrics(name, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert cell_metrics(name, True)
    for c in configs.values():
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
        assert json.load(open(ROOT / c["file"]))["name"] == c["name"]
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_tiny_run_of_each_cell(cell):
    n, seconds, over = TINY[cell]
    res = run.run_cell(cell, 2 ** 31 + 11, seconds, 0, device="cpu", n=n,
                       overrides=over, out=lambda s: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert res["correct"] is True and res["attempted"] > 0
    want = {m["name"] for m in cell_metrics(cell, False)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["compared"]) == {"state_gap", "enorm_gap",
                                    "decision_faults"}


def test_episode_accounting():
    """Every episode of the Solver cell is the same work: the window's
    counts are whole multiples of the warm episode's."""
    import importlib

    _, wl, cfg = load_cell("agg2d.aggregated")
    wl = dict(wl, ramp_accepts=12, span=1.0)
    drv = importlib.import_module("runners.solver").Runner(
        wl, cfg, 31, torch.device("cpu"), n=24)
    drv.setup()
    w = drv.window(0.5)
    k = w["episodes"]
    for key in ("attempts", "accepts"):
        assert w[key] == k * drv.warm[key]
    assert w["sim_time"] == pytest.approx(k * drv.warm["sim_time"])
    assert drv.warm["sim_time"] >= wl["span"]
    assert drv.decisions()[0] == 0


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import ksfd_tpu_torch  # noqa: F401

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib.xla_client"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "agg2d.fixed",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 2 and proc.stdout == ""


def test_union_and_gaps():
    busy, merged = union_seconds([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0),
                                  (4.5, 5.0)])
    assert busy == pytest.approx(3.5)
    assert merged == [[0.0, 2.0], [3.0, 4.0], [4.5, 5.0]]
    host = [(0.0, 10.0, "outer"), (1.9, 3.1, "aten::item")]
    assert gaps(merged, host) == [["aten::item", 1.0], ["outer", 0.5]]
