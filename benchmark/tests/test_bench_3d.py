"""The harness over the grid's dimension, on the CPU: the 2D cells'
starts unchanged bit for bit, the 3D reference against the program's
float64 step at 12^3 x 3, the cube's symmetries, a tiny 3D cell through
the whole run, and a workload's own numerics tokens.

``aggregation3d.json`` beside this file is examples/aggregation3d
(64^3 x 3) with its lines and tokens whole, a fixture: no cell of
BENCHMARK.json runs it.  The tests run it at 12 points per axis, the
spacing kept."""

import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

import run
from bench_cells import (build_program, cell_start, config_params,
                         load_cell, orient, start_state)
from reference.ks import Problem, eval_params
from test_bench_harness import TINY

N3 = 12
CFG3 = json.loads((Path(__file__).parent / "aggregation3d.json").read_text())
#: a fixed-dt cell of the fixture, with agg2d.fixed's traffic and limits
WL3 = dict(config="aggregation3d", traffic="fixed", kind="fixed", h=1.0,
           steps_per_call=2, trace_calls=1, noise_seed=1,
           limits=dict(state_gap=0.2, enorm_gap=0.003, decision_faults=0))
ENTRY3 = dict(name="agg3d.tiny", config="aggregation3d", traffic="fixed",
              chips=1)
def _parent_cell_start(cfg, wl, n, seed):
    """The 2D start as the harness drew it before it took a dimension
    from the configuration."""
    p = eval_params(config_params(cfg, n))
    nc = max(2, n // 4)
    members = int(wl.get("members", 1))
    base = int(wl["noise_seed"]) * members
    gen = torch.Generator()
    rows = []
    for s in [base + i for i in range(members)]:
        gen.manual_seed(int(s) % (2 ** 63))
        coarse = torch.randn((nc, nc), generator=gen, dtype=torch.float64)
        spec = torch.fft.rfft2(coarse)
        full = torch.zeros((n, n // 2 + 1), dtype=spec.dtype)
        kx = nc // 2
        full[:kx, :spec.shape[1]] = spec[:kx]
        full[n - (nc - kx):, :spec.shape[1]] = spec[kx:]
        rows.append(torch.fft.irfft2(full, s=(n, n)) * (n * n) / (nc * nc))
    rho = p["murho"] + p["srho0"] * torch.stack(rows)
    fields = [rho] + [rho * (p["s_%d_1" % g] / p["gamma_%d_1" % g])
                      for g in (1, 2)]
    u = torch.stack(fields, dim=1)
    k, s = int(seed) % 8, int(seed) // 8
    u = torch.roll(u, shifts=(s % n, (s // n) % n), dims=(-2, -1))
    if k >= 4:
        u = u.transpose(-2, -1)
    return torch.rot90(u, k % 4, dims=(-2, -1)).contiguous()


@pytest.mark.parametrize("cell", sorted(TINY))
def test_2d_starts_are_bit_for_bit_the_parents(cell):
    """At the cell's own size and at its tiny one."""
    _, wl, cfg = load_cell(cell)
    for n in (TINY[cell][0], int(cfg["nelements"])):
        for seed in (3, 2 ** 31 + 77, 4999999999):
            assert torch.equal(cell_start(cfg, wl, n, seed, "cpu"),
                               _parent_cell_start(cfg, wl, n, seed))


@pytest.fixture(scope="module")
def agg3d():
    _, _, ops, numerics = build_program(CFG3, N3, 7, "cpu")
    ref = Problem(config_params(CFG3, N3), N3, "cpu")
    u = start_state(CFG3, N3, [7], "cpu")
    return ops, numerics, ref, u


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def test_3d_reference_matches_the_programs_float64_step(agg3d):
    """rhs, J v and one ROS34PW2 step with 3 Richardson sweeps, the
    program in float64 throughout."""
    from ksfd_tpu_torch.solvers import make_step_fn

    ops, numerics, ref, u = agg3d
    assert u.shape == (1, 3, N3, N3, N3)
    t = torch.zeros((), dtype=torch.float64)
    assert _rel(ops.rhs(u[0], t), ref.rhs(u)[0]) <= 1e-10
    v = torch.randn(u.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(9))
    assert _rel(ops.linearize(u[0], t)[1](v[0]),
                ref.linearize(u)(v)[0]) <= 1e-10
    assert _rel(ref.linearize(u)(v), ref.jvp(u, v)) <= 1e-10
    nm = dataclasses.replace(numerics, ksp_type="richardson", ksp_iters=3,
                             sweep_dtype="float64", pc_dtype="float64",
                             use_pallas=False, device_loop=False)
    step, _ = make_step_fn(ops, nm, atol=ref.atol, rtol=ref.rtol)
    u1, e = step(u[0], t, torch.tensor(1.0, dtype=torch.float64))
    u1r, er = ref.step(u, [1.0], "richardson", 3)
    assert _rel(u1, u1r[0]) <= 1e-10
    assert abs(float(e) - float(er)) <= 1e-10 * float(er)


@pytest.mark.parametrize("key", [1, 6, 23, 47, 48 * (N3 * 5 + 2) + 29])
def test_3d_orient_commutes_with_the_rhs(agg3d, key):
    _, _, ref, u = agg3d
    ou = orient(u, key)
    assert ou.shape == u.shape and not torch.equal(ou, u)
    f = ref.rhs(u)
    assert torch.allclose(ref.rhs(ou), orient(f, key), rtol=0,
                          atol=1e-9 * float(f.abs().max()))


@pytest.mark.parametrize("fault", [None, "unchanged", "altered"])
def test_a_tiny_3d_cell_is_checked_against_the_3d_reference(fault):
    res = run.run_cell("agg3d.tiny", 2 ** 31 + 5, 0.3, 0, device="cpu",
                       n=N3, fault=fault, cell=(ENTRY3, WL3, CFG3),
                       out=lambda s: None)
    assert res["attempted"] > 0
    worst = max(c["value"] / c["limit"] if c["limit"] else c["value"]
                for c in res["compared"].values())
    if fault is None:
        assert res["correct"] is True and math.isfinite(worst)
    else:
        assert res["correct"] is False and worst > 1


def test_a_workloads_numerics_follow_its_configurations():
    _, wl, cfg = load_cell("agg2d.fixed")
    _, wl2, cfg2 = load_cell("agg2d.fixed", dict(numerics=["-pc_pallas",
                                                           "1"]))
    assert "numerics" not in wl
    assert cfg2["numerics"] == cfg["numerics"] + ["-pc_pallas", "1"]
    nm = build_program(cfg, 16, 1, "cpu")[3]
    nm2 = build_program(cfg2, 16, 1, "cpu")[3]
    assert (nm.pc_pallas, nm2.pc_pallas) == (False, True)
    assert dataclasses.replace(nm2, pc_pallas=False) == nm
