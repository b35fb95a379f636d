"""The benchmark's aggregation3d configuration through the port's fixed-dt
chain on the CPU, held against the benchmark's plain float64 reference.

``benchmark/configs/aggregation3d.json`` (options84's system in a
periodic cube, 384^3 x 3 on the card) runs here at 12 points per axis
with its spacing kept (``bench_cells.config_params``), so a step at the
cell's h is as stiff as the cell's: ``interop.problem_from_clargs`` ->
``make_multistep_fn``, one chained call of two steps from a seeded
noisy start (``bench_cells.start_state``), against
``benchmark/reference/ks.py`` run step by step.  Two tolerances:

- the program in float64 throughout (float64 sweeps and pc, no
  kernels): state and error norm to 1e-10 relative, since only rounding
  separates the two; the same call with the pc's transforms in
  bfloat16 falls outside it, so the tolerance sees a precision below
  the configuration's;
- the configuration's own numerics (float32 sweeps and pc, the
  kernels' plain CPU versions, f0 chained by the delta kernel): the
  check's ``state_gap`` and ``enorm_gap`` (benchmark/bench_check.py)
  within the limits of the ``agg3d.fixed`` cell
  (benchmark/workloads/agg3d.fixed.json), the same numbers the cell
  holds the card's run to.

A traced chained call records 12 ``ksfd::pc`` spans a step (4 stages x
3 Richardson sweeps) in 2D and in 3D: the applications per step that
the benchmark's ``pc_roofline_share`` counts (benchmark/pc_ops.py).
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ksfd_tpu_torch.solvers import make_multistep_fn
from ksfd_tpu_torch.utils import spans

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from bench_cells import build_program, config_params, start_state  # noqa: E402
from reference.ks import Problem, state_gap  # noqa: E402

N = 12
STEPS = 2
SEED = 2 ** 31 + 19


def load_config(name):
    return json.loads((BENCH / "configs" / (name + ".json")).read_text())


CFG3 = load_config("aggregation3d")
WL3 = json.loads((BENCH / "workloads" / "agg3d.fixed.json").read_text())


def build(cfg, n):
    """The port's problem of a configuration at n points per axis
    (``bench_cells.build_program``: the entry point's parsed command line
    through ``interop.problem_from_clargs``), its numerics at fixed dt,
    and the reference at the same size."""
    _, _, ops, numerics = build_program(cfg, n, 1, "cpu")
    numerics = dataclasses.replace(numerics, adapt_type="none")
    return ops, numerics, Problem(config_params(cfg, n), n, "cpu")


@pytest.fixture(scope="module")
def agg3d():
    ops, numerics, ref = build(CFG3, N)
    u = start_state(CFG3, N, [SEED], "cpu")
    h = float(WL3["h"])
    ur, er = u, None
    for _ in range(STEPS):
        ur, e = ref.step(ur, [h], "richardson", 3)
        er = e if er is None else torch.maximum(er, e)
    return ops, numerics, ref, u, ur, float(er)


def chained_call(ops, numerics, ref, u, **numerics_changes):
    nm = dataclasses.replace(numerics, **numerics_changes)
    multi, _ = make_multistep_fn(ops, nm, atol=ref.atol, rtol=ref.rtol)
    h = torch.tensor(float(WL3["h"]), dtype=torch.float64)
    u1, t, emax = multi(u[0], torch.zeros((), dtype=torch.float64), h,
                        STEPS)
    assert float(t) == pytest.approx(STEPS * float(WL3["h"]))
    return multi, u1.unsqueeze(0), float(emax)


def rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


FLOAT64 = dict(sweep_dtype="float64", pc_dtype="float64", use_pallas=False)


def test_the_configuration_is_options84_in_a_cube(agg3d):
    ops, numerics, ref, u, _, _ = agg3d
    assert ops.grid.dim == 3
    assert tuple(int(n) for n in ops.grid.nps) == (N,) * 3
    assert u.shape == (1, 3, N, N, N)
    assert ref.h == [4.0 / 384] * 3
    assert (numerics.ts_type, numerics.ksp_type, int(numerics.ksp_iters),
            numerics.pc_type) == ("rosw", "richardson", 3, "block")


def test_float64_chain_meets_the_reference_to_rounding(agg3d):
    ops, numerics, ref, u, ur, er = agg3d
    multi, u1, e = chained_call(ops, numerics, ref, u, **FLOAT64)
    assert multi.kernels is None and multi.build_info["pc_dtype"] == "float64"
    assert rel(u1, ur) <= 1e-10
    assert abs(e - er) <= 1e-10 * er


def test_bfloat16_transforms_fall_outside_the_float64_tolerance(agg3d):
    ops, numerics, ref, u, ur, er = agg3d
    _, u1, e = chained_call(ops, numerics, ref, u,
                            **dict(FLOAT64, pc_dtype="bfloat16"))
    assert rel(u1, ur) > 1e-10 or abs(e - er) > 1e-10 * er


def test_the_configurations_numerics_stay_within_the_cells_limits(agg3d):
    ops, numerics, ref, u, ur, er = agg3d
    multi, u1, e = chained_call(ops, numerics, ref, u)
    assert multi.kernels is not None
    assert multi.build_info["mixed32"] and multi.build_info["pallas_delta"]
    sgap = float(state_gap(u1, ur, ref.atol, ref.rtol).max())
    egap = abs(e - er) / max(er, 1.0)
    limits = WL3["limits"]
    assert 0.0 < sgap <= limits["state_gap"]
    assert egap <= limits["enorm_gap"]


@pytest.mark.parametrize("config,n", [("aggregation2d", 16),
                                      ("aggregation3d", N)])
def test_a_traced_chained_call_applies_the_pc_12_times_a_step(config, n):
    cfg = load_config(config)
    ops, numerics, ref = build(cfg, n)
    u = start_state(cfg, n, [SEED], "cpu")
    multi, _ = make_multistep_fn(ops, numerics, atol=ref.atol,
                                 rtol=ref.rtol)
    h = torch.tensor(1.0, dtype=torch.float64)
    t = torch.zeros((), dtype=torch.float64)
    spans.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            multi(u[0], t, h, STEPS)
        every = spans.summary()
        within = spans.summary("ksfd::step")
    finally:
        spans.clear()
    assert every["ksfd::step"]["count"] == STEPS
    assert every["ksfd::pc"]["count"] == 12 * STEPS
    assert within["ksfd::pc"]["count"] == 12 * STEPS
