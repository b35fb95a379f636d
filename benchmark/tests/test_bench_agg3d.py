"""The agg3d.fixed cell and the two readers it brings, on the CPU: the
cell's files, a tiny run of it checked against the 3D reference (and a
planted fault caught), the pc's operation count against the products
the program really makes, and ``pc_roofline_share`` and
``elementwise_ms_per_step`` on synthetic traces."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import run
from bench_cells import build_program, cell_metrics, config_params, load_cell
from pc_ops import (F32_ACCURATE_OPS_PER_S, grid_dim, pc_ops_per_step,
                    transform_ops)
from reference.ks import eval_params

from ksfd_tpu_torch.solvers.linalg import BlockSpectralPreconditioner

N = 12
OVER = dict(steps_per_call=2, trace_calls=1)
NEW = ("pc_roofline_share", "elementwise_ms_per_step")


def test_the_cell_reads_its_files():
    entry, wl, cfg = load_cell("agg3d.fixed")
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "aggregation3d", "fixed", 1)
    assert (wl["kind"], wl["h"], wl["steps_per_call"], wl["trace_calls"],
            wl["noise_seed"]) == ("fixed", 1.0, 8, 2, 1)
    assert wl["limits"]["decision_faults"] == 0
    p = eval_params(config_params(cfg))
    assert (p["dim"], p["nelements"]) == (3, 384)
    assert p["width"] == p["height"] == p["depth"] == 4.0
    assert set(cfg["reduced"]) == {"nelements"}
    assert set(cfg["assumed"]) == {"dim", "depth"}
    assert grid_dim("aggregation3d") == 3 and grid_dim("aggregation2d") == 2
    assert grid_dim("no-such-configuration") is None
    traced = {m["name"] for m in cell_metrics("agg3d.fixed", True)}
    assert set(NEW) <= traced and len(traced) == 8
    assert {m["name"] for m in cell_metrics("agg3d.fixed", False)} == {
        "dof_updates_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [None, "unchanged", "altered"])
def test_a_tiny_run_of_the_cell(fault):
    res = run.run_cell("agg3d.fixed", 2 ** 31 + 13, 0.3, 0, device="cpu",
                       n=N, fault=fault, overrides=OVER, out=lambda s: None)
    assert res["attempted"] > 0
    if fault is None:
        assert res["correct"] is True
        assert set(res["metrics"]) == {"dof_updates_per_s", "setup_s"}
    else:
        assert res["correct"] is False
        assert any(c["value"] > c["limit"] for c in res["compared"].values())


@pytest.mark.parametrize("config,n", [("aggregation2d", 8),
                                      ("aggregation2d", 16),
                                      ("aggregation3d", 4),
                                      ("aggregation3d", 6)])
def test_the_count_is_the_products_the_pc_makes(config, n):
    """One application of the program's block pc, its matrix products
    counted by torch's FLOP counter (2 m n k a product), is
    ``transform_ops``: 8 n^3 f in 2D, 12 n^4 f in 3D."""
    cfg = load_cell("agg2d.fixed" if config == "aggregation2d"
                    else "agg3d.fixed")[2]
    _, grid, ops, numerics = build_program(cfg, n, 1, "cpu")
    pc = BlockSpectralPreconditioner(grid, ops, device="cpu")
    dim = grid.dim
    f = int(grid.dof)
    v = torch.rand((f,) + (n,) * dim, dtype=torch.float64)
    means = [v[i].mean() for i in range(f)]
    pack = pc.pack(torch.tensor(2.0, dtype=torch.float64),
                   torch.zeros((), dtype=torch.float64), means)
    with FlopCounterMode(display=False) as counter:
        pc.apply_packed(v, pack)
    want = (8 * n ** 3 * f) if dim == 2 else (12 * n ** 4 * f)
    assert counter.get_total_flops() == transform_ops(f, (n,) * dim) == want
    assert pc_ops_per_step(numerics, f, (n,) * dim) == 12 * want


def _ctx(config, n, per_kernel, steps=8):
    _, wl, cfg = load_cell("agg2d.fixed" if config == "aggregation2d"
                           else "agg3d.fixed")
    numerics = build_program(cfg, 4, 1, "cpu")[3]
    dim = grid_dim(config)
    return dict(kind="fixed", wl=wl, numerics=numerics, fields=3,
                points=n ** dim, members=1,
                trace=dict(steps=steps, per_kernel=per_kernel, busy_s=1.0,
                           window_s=1.0))


GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8"
ARROW = "void (anonymous namespace)::arrow_modes<float, 2>(float const*)"
ELEM = "void at::native::vectorized_elementwise_kernel<4>(int)"
STENCIL = "void (anonymous namespace)::jvp_kernel<true>(float const*)"


@pytest.mark.parametrize("config,n", [("aggregation2d", 1536),
                                      ("aggregation3d", 384)])
def test_the_readers_on_a_synthetic_trace(config, n):
    per = {GEMM: 0.2, "pc_gemm_fwd": 0.04, ARROW: 0.01, ELEM: 0.03,
           STENCIL: 0.05, "void at::native::fft_c2r": 0.02}
    ctx = _ctx(config, n, per)
    ops = 12 * transform_ops(3, (n,) * grid_dim(config))
    share = run._metric_reader("pc_roofline_share")(ctx)
    assert share == pytest.approx(
        100.0 * ops / F32_ACCURATE_OPS_PER_S / (0.24 / 8))
    assert run._metric_reader("elementwise_ms_per_step")(ctx) == (
        pytest.approx(0.04 * 1e3 / 8))
    if config == "aggregation2d":
        # 1.04e12 operations a step at 1536^2 x 3, 6.3 ms at 165 TFLOP/s
        assert ops / F32_ACCURATE_OPS_PER_S == pytest.approx(6.32e-3,
                                                             rel=1e-3)
    else:
        assert ops == pytest.approx(9.4e12, rel=1e-2)


def test_the_readers_without_gemms_or_a_trace():
    ctx = _ctx("aggregation3d", 384, {ARROW: 0.01, ELEM: 0.03,
                                      "void at::native::fft_r2c": 0.1})
    assert run._metric_reader("pc_roofline_share")(ctx) is None
    assert run._metric_reader("elementwise_ms_per_step")(ctx) == (
        pytest.approx(0.04 * 1e3 / 8))
    empty = dict(ctx, trace=dict(ctx["trace"], per_kernel={}))
    for name in NEW:
        assert run._metric_reader(name)(dict(ctx, trace=None)) is None
        assert run._metric_reader(name)(empty) is None


def test_a_tiny_traced_run_on_the_cpu_reads_no_device_metric():
    """The CPU's profile holds no device operation, so neither reader
    gives a number; the spans' readers do."""
    res = run.run_cell("agg3d.fixed", 2 ** 31 + 17, 0.3, 1, device="cpu",
                       n=N, overrides=OVER, out=lambda s: None)
    assert res["correct"] is True
    got = res["metrics"]
    assert not set(NEW) & set(got)
    assert all(math.isfinite(got[k]["value"]) and got[k]["value"] > 0
               for k in ("launch_ms_per_step", "pc_launch_ms_per_step"))
