"""The plain reference against the program's CPU path at 32 x 32."""

import dataclasses

import pytest
import torch

from bench_cells import build_program, config_params, load_cell, start_state
from reference.ks import Problem, fd_weights, state_gap

N = 32


@pytest.fixture(scope="module")
def agg():
    _, _, cfg = load_cell("agg2d.fixed")
    ps, grid, ops, numerics = build_program(cfg, N, 7, "cpu")
    ref = Problem(config_params(cfg, N), N, "cpu")
    u = start_state(cfg, N, [7], "cpu")
    return cfg, ops, numerics, ref, u


def test_fd_weights_are_the_centred_differences():
    assert fd_weights(1, 2).tolist() == pytest.approx(
        [1 / 12, -2 / 3, 0, 2 / 3, -1 / 12])
    assert fd_weights(2, 2).tolist() == pytest.approx(
        [-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12])


def test_rhs_matches_the_program(agg):
    _, ops, _, ref, u = agg
    t = torch.zeros((), dtype=torch.float64)
    f_prog = ops.rhs(u[0], t)
    f_ref = ref.rhs(u)[0]
    assert float((f_prog - f_ref).abs().max()) <= 1e-9 * float(
        f_ref.abs().max())


def test_pc_matches_the_programs_block_pc(agg):
    from ksfd_tpu_torch.solvers.linalg import BlockSpectralPreconditioner

    _, ops, _, ref, u = agg
    pc = BlockSpectralPreconditioner(ops.grid, ops, compute_dtype="float64",
                                     device="cpu")
    t = torch.zeros((), dtype=torch.float64)
    v = torch.randn(u.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    means, rho_diff, _ = ref.pc_stats(u)
    shift = torch.tensor([2.5], dtype=torch.float64)
    got = pc.apply_linearized(v[0], shift[0], t, list(means[0]),
                              rho_diff=rho_diff[0])
    want = ref.pc_apply(v, shift, means, rho_diff)[0]
    assert float((got - want).abs().max()) <= 1e-9 * float(want.abs().max())


@pytest.mark.parametrize("kind,iters,h", [("richardson", 3, 1.0),
                                          ("chebyshev", 48, 0.5)])
def test_step_matches_the_programs_float64_sweeps(agg, kind, iters, h):
    """The program's float64 sweeps with a float64 pc run the same
    arithmetic: the states agree to rounding."""
    from ksfd_tpu_torch.solvers import make_step_fn

    _, ops, numerics, ref, u = agg
    nm = dataclasses.replace(numerics, ksp_type=kind, ksp_iters=iters,
                             sweep_dtype="float64", pc_dtype="float64",
                             use_pallas=False, device_loop=False)
    step, _ = make_step_fn(ops, nm, atol=ref.atol, rtol=ref.rtol)
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)
    u1, e = step(u[0], f64(0.0), f64(h))
    u1r, er = ref.step(u, [h], kind, iters)
    assert float(state_gap(u1[None], u1r, ref.atol, ref.rtol)) < 1e-5
    assert abs(float(e) - float(er)) <= 1e-9 * float(er)


def test_step_of_the_main_path_is_within_float32_sweeps(agg):
    """The default path (float32 sweeps) is close, the float32 fast mode
    is not: the numbers the check compares separate them."""
    from ksfd_tpu_torch.solvers import make_step_fn

    _, ops, numerics, ref, u = agg
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)
    u1r, er = ref.step(u, [1.0], "richardson", 3)
    gaps = {}
    for prec in ("float64", "float32"):
        nm = dataclasses.replace(numerics, precision=prec,
                                 device_loop=False)
        step, _ = make_step_fn(ops, nm, atol=ref.atol, rtol=ref.rtol)
        u1, e = step(u[0], f64(0.0), f64(1.0))
        gaps[prec] = (float(state_gap(u1[None], u1r, ref.atol, ref.rtol)),
                      abs(float(e) - float(er)) / max(float(er), 1.0))
    assert gaps["float64"][0] < 0.05 and gaps["float64"][1] < 1e-3
    assert gaps["float32"][0] > 10 * gaps["float64"][0]


@pytest.mark.parametrize("key", [0, 3, 5, 8 * 7 + 6, 8 * (N * 5 + 2) + 1])
def test_every_seed_orients_the_same_dynamics(agg, key):
    """The start a seed picks is the noise under a grid symmetry, which
    the system commutes with: its right-hand side and its step are the
    symmetric images of the unoriented ones."""
    from bench_cells import orient

    _, _, _, ref, u = agg
    ou = orient(u, key)
    assert not torch.equal(ou, u) or key == 0
    f = ref.rhs(u)
    assert torch.allclose(ref.rhs(ou), orient(f, key), rtol=0,
                          atol=1e-9 * float(f.abs().max()))
    u1, e = ref.step(u, [1.0], "richardson", 3)
    ou1, oe = ref.step(ou, [1.0], "richardson", 3)
    assert torch.allclose(ou1, orient(u1, key), rtol=1e-12, atol=0)
    assert float(oe) == pytest.approx(float(e), rel=1e-10)


def test_linearize_is_forward_mode_jvp(agg):
    _, _, _, ref, u = agg
    v = torch.randn(u.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(9))
    want = ref.jvp(u, v)
    got = ref.linearize(u)(v)
    assert float((got - want).abs().max()) <= 1e-10 * float(
        want.abs().max())
