"""The yardstick's stencil counts against the program's own step."""

import dataclasses

import pytest
import torch

from bench_cells import build_program, load_cell, start_state
from yardstick import (EVAL_PLANES, HBM_BYTES_PER_S, device_groups,
                       library_gemms, stencil_bytes_per_step, stencil_evals)

N = 32


def test_a_chained_step_makes_the_counted_evaluations_on_their_operands():
    """One chained float64 step with 3 Richardson sweeps calls resid 8
    times and delta 4 times (yardstick.stencil_evals), each on
    float32 operand planes of the state's shape, as many as
    EVAL_PLANES counts with the output."""
    from ksfd_tpu_torch.solvers import make_multistep_fn

    _, _, cfg = load_cell("agg2d.fixed")
    _, grid, ops, numerics = build_program(cfg, N, 5, "cpu")
    nm = dataclasses.replace(numerics, adapt_type="none")
    multi, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6)
    kern = multi.kernels
    seen = {"resid": [], "delta": []}

    def spy(name):
        entry = getattr(kern, name)

        def call(*args):
            _, operands = entry.prepare(*args)
            out = entry(*args)
            seen[name].append(([(tuple(x.shape), x.dtype) for x in operands],
                               (tuple(out.shape), out.dtype)))
            return out
        return call

    for name in seen:
        setattr(kern, name, spy(name))
    u = start_state(cfg, N, [5], "cpu")[0]
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)
    steps = 2
    multi(u, f64(0.0), f64(1.0), steps)
    want = stencil_evals(nm.ksp_iters)
    assert want == {"resid": 8, "delta": 4}
    plane = (3, N, N)
    for name, calls in seen.items():
        assert len(calls) == steps * want[name]
        for operands, out in calls:
            assert len(operands) + 1 == EVAL_PLANES[name]
            assert all(o == (plane, torch.float32) for o in operands)
            assert out == (plane, torch.float32)


def test_the_flagship_steps_least_stencil_time():
    """At 1536^2 x 3: 48 float32 planes of 28.3 MB a step, 405.6 us at
    3.35 TB/s; one resid at the kernel table's 33.8 us bound (PERF.md)."""
    evals = stencil_evals(3)
    points = 1536 ** 2
    total = stencil_bytes_per_step(evals, 3, points)
    assert total == 48 * 3 * points * 4
    assert total / HBM_BYTES_PER_S == pytest.approx(405.6e-6, rel=1e-3)
    one = stencil_bytes_per_step({"resid": 1}, 3, points)
    assert one / HBM_BYTES_PER_S == pytest.approx(33.8e-6, rel=1e-3)
    fast = stencil_evals(3, fast32=True)
    assert fast == {"jvp": 8, "rhs": 4}


def test_kernel_groups_by_name():
    per = {"sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8": 1.0,
           "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128>": 2.0,
           "void (anonymous namespace)::jvp_kernel<true>(float const*)": 3.0,
           "void delta_kernel(float const*)": 4.0,
           "pc_gemm_fwd": 5.0, "void at::native::fft_c2r": 6.0,
           "void at::native::vectorized_elementwise_kernel<4>": 7.0}
    assert library_gemms(per) == sorted(list(per)[:2])
    g = device_groups(per)
    assert g == {"gemm": 3.0, "pc kernels": 5.0, "stencil kernels": 7.0,
                 "fft": 6.0, "other": 7.0}
