"""Parity of the PyTorch port's operator layer with ksfd_tpu on the CPU.

Each case feeds the same numpy inputs (made from a seed) through the
JAX package and its counterpart in ksfd_tpu_torch.  Tolerances:
numpy-only pieces (stencil coefficients, eigenbases, tableaus) are
bit-equal; float64 operators agree to 1e-12 relative (the two
frameworks sum in different orders); float32 preconditioner applies
to 1e-5 relative (float32 rounding of the transforms).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sy
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
import ksfd_tpu_torch as KT
from ksfd_tpu.ops import stencil as jstencil
from ksfd_tpu.solvers import linalg as jlinalg
from ksfd_tpu.solvers import steppers as jsteppers
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops import stencil as tstencil
from ksfd_tpu_torch.solvers import linalg as tlinalg
from ksfd_tpu_torch.solvers import steppers as tsteppers

N = 32


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def problems():
    """(JAX ops, port ops) of the bench problem at N^2 x 3."""
    jps, jgrid, jops = ge._make_problem(N, N)
    _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu")
    return jops, tops


def rough_state(shape, seed=0, scale=1000.0):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal(shape)),
        6000 + scale * np.abs(rng.standard_normal(shape)),
        6000 + 0.5 * scale * np.abs(rng.standard_normal(shape)),
    ])


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


# ---------------------------------------------------------------- numpy


@pytest.mark.parametrize("order,sw,h", [(1, 1, 1.0), (1, 2, 0.03125),
                                        (2, 2, 0.03125), (2, 3, 0.1)])
def test_deriv_coeffs_bit_equal(order, sw, h):
    np.testing.assert_array_equal(
        tstencil.deriv_coeffs(order, sw, h),
        jstencil.deriv_coeffs(order, sw, h),
    )


@pytest.mark.parametrize("n,sw", [(16, 2), (33, 2), (64, 3)])
def test_laplacian_eigendecomp_bit_equal(n, sw):
    Qt, lt = tstencil.laplacian_eigendecomp(n, 1.0 / n, sw)
    Qj, lj = jstencil.laplacian_eigendecomp(n, 1.0 / n, sw)
    np.testing.assert_array_equal(Qt, Qj)
    np.testing.assert_array_equal(lt, lj)


@pytest.mark.parametrize("name", ["rosw", "ros34pw2", "beuler", "arkimex",
                                  "ark324", "ark436"])
def test_tableau_bit_equal(name):
    assert dataclasses.asdict(tsteppers.get_tableau(name)) == (
        dataclasses.asdict(jsteppers.get_tableau(name))
    )


def test_esdirk_tableau_not_ported():
    """The ESDIRK tableaus, refused until the DIRK path was ported
    (ROADMAP Queue A item 7), are DIRKTableaus under the reference's
    names, and an unknown name still raises."""
    assert tsteppers.get_tableau("arkimex") is tsteppers.ARK324
    assert tsteppers.get_tableau("ark324") is tsteppers.ARK324
    assert tsteppers.get_tableau("ark436") is tsteppers.ARK436
    for tab in (tsteppers.ARK324, tsteppers.ARK436):
        assert isinstance(tab, tsteppers.DIRKTableau)
        assert type(tab).__name__ == type(
            jsteppers.get_tableau(tab.name[:6])).__name__
    with pytest.raises(KeyError):
        tsteppers.get_tableau("ark999")


def test_numerics_options_same_fields_and_defaults():
    assert dataclasses.asdict(KT.NumericsOptions()) == dataclasses.asdict(
        KJ.NumericsOptions()
    )


def test_solution_parameters_match(problems):
    jops, tops = problems
    jv, tv = jops.ps.values0, tops.ps.values0
    assert list(jv) == list(tv)
    for k in jv:
        assert str(jv[k]) == str(tv[k]), k
    assert [l.name() for l in jops.ps.Vgroups.ligands()] == [
        l.name() for l in tops.ps.Vgroups.ligands()
    ]


def test_free_energy_expressions_match(problems):
    jops, tops = problems
    assert sy.simplify(jops.G_expr - tops.G_expr) == 0
    assert str(jops.G_expr) == str(tops.G_expr)


def test_grid_matches():
    kw = dict(dim=2, width=1.0, height=2.0, nx=8, ny=12, dof=3, order=3)
    tg, jg = KT.Grid(**kw), KJ.Grid(**kw)
    assert tg.state() == jg.state()
    np.testing.assert_array_equal(tg.coords, jg.coords)
    np.testing.assert_array_equal(tg.spacing, jg.spacing)


def test_keyword_expression_rejected():
    with pytest.raises(KT.KSFDException, match="keyword"):
        KT.safe_sympify("lambda + 1")


# ---------------------------------------------------------------- torchify


def test_torchify_matches_jaxify(problems):
    jops, tops = problems
    u = rough_state((N, N), seed=1)
    ref = np.asarray(jops._G_fn(*[jnp.asarray(f) for f in u], 0.0))
    out = tops._G_fn(*[torch.as_tensor(f) for f in u], 0.0).numpy()
    assert rel(out, ref) < 1e-14
    for jf, tf in zip(jops._dG_fns, tops._dG_fns):
        ref = np.asarray(jf(*[jnp.asarray(f) for f in u], 0.0))
        out = tf(*[torch.as_tensor(f) for f in u], 0.0).numpy()
        assert rel(out, ref) < 1e-14


def test_torch_printer_max_min_where():
    x, y = sy.symbols("x y")
    where_ = sy.Function("where_")
    fn = KT.torchify(
        [x, y],
        sy.Max(x, sy.Rational(-1, 2)) + sy.Min(x, y, 3)
        + where_(x < y, sy.Function("log1p")(y), sy.Function("expm1")(x)),
    )
    xs = torch.tensor([-2.0, 0.5, 4.0], dtype=torch.float64)
    ys = torch.tensor([1.0, 0.25, 5.0], dtype=torch.float64)
    ref = (
        torch.clamp(xs, min=-0.5) + torch.minimum(torch.minimum(xs, ys),
                                                  torch.tensor(3.0))
        + torch.where(xs < ys, torch.log1p(ys), torch.expm1(xs))
    )
    torch.testing.assert_close(fn(xs, ys), ref, rtol=0, atol=0)


# ---------------------------------------------------------------- operators


def test_stencil_shift_matches_roll():
    a = np.arange(30.0).reshape(5, 6)
    for off, ax in [(1, 0), (-2, 1), (3, 1)]:
        np.testing.assert_array_equal(
            tstencil.shift(torch.as_tensor(a), off, ax).numpy(),
            np.asarray(jstencil.shift(jnp.asarray(a), off, ax)),
        )


def test_groom_matches(problems):
    jops, tops = problems
    u = rough_state((N, N), seed=2) - 6500.0  # negatives to clamp
    u[0, 0, 0] = np.nan
    u[1, 3, 4] = np.nan
    np.testing.assert_array_equal(
        tops.groom(torch.as_tensor(u)).numpy(),
        np.asarray(jops.groom(jnp.asarray(u))),
    )


@pytest.mark.parametrize("seed", [3, 4])
def test_rhs_matches(problems, seed):
    jops, tops = problems
    u = rough_state((N, N), seed=seed)
    ref = jops.rhs(jnp.asarray(u), 0.5)
    out = tops.rhs(torch.as_tensor(u), 0.5)
    assert out.dtype == torch.float64
    assert rel(out.numpy(), ref) < 1e-12


def test_jacobian_action_matches(problems):
    jops, tops = problems
    u = rough_state((N, N), seed=5)
    v = np.random.default_rng(6).standard_normal(u.shape)
    ref = jops.jacobian_action(jnp.asarray(u), 0.5, jnp.asarray(v))
    out = tops.jacobian_action(torch.as_tensor(u), 0.5, torch.as_tensor(v))
    assert rel(out.numpy(), ref) < 1e-12


def test_linearization_coefficients_match(problems):
    jops, tops = problems
    means = [9000.0, 6000.0, 800.0]
    jc = jops.linearization_coefficients([jnp.asarray(m) for m in means], 0.0)
    tc = tops.linearization_coefficients(
        [torch.tensor(m, dtype=torch.float64) for m in means], 0.0
    )
    for ja, ta in zip(jc, tc):
        np.testing.assert_allclose(
            [float(x) for x in ta], [float(x) for x in ja], rtol=1e-14
        )


def test_stage_delta_ok_and_stiff_coefficients(problems):
    jops, tops = problems
    assert tops.stage_delta_ok() == jops.stage_delta_ok() is True
    jd, jy = jops.stiff_coefficients(0.0)
    td, ty = tops.stiff_coefficients(0.0)
    assert [float(x) for x in td] == [float(x) for x in jd]
    assert [float(x) for x in ty] == [float(x) for x in jy]


def test_flux_form_not_ported(problems):
    """The flux form was ported since this test pinned its refusal: its
    RHS equals the reference's to 1e-12 relative
    (tests/test_torch_with_g.py holds its J-action, steps and
    conservation)."""
    jops, tops = problems
    fops = KT.ops.PDEOperators(tops.ps, tops.grid, flux_form=True,
                               device="cpu")
    jf = type(jops)(jops.ps, jops.grid, flux_form=True)
    u = np.asarray(jops.groom(np.full(tops.grid.Vshape, 9000.0)
                              + 90 * np.random.default_rng(2)
                              .standard_normal(tops.grid.Vshape)))
    got = fops.rhs(torch.from_numpy(u), 0.0).numpy()
    ref = np.asarray(jf.rhs(u, 0.0))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_spatial_source_matches(problems):
    jops, tops = problems
    from ksfd_tpu.ops import SpatialExpression as JS
    from ksfd_tpu_torch.ops import SpatialExpression as TS

    expr = "murho*sin(2*pi*x)*cos(2*pi*y) + t"
    js = JS(jops.ps, jops.grid, expr)
    ts = TS(tops.ps, tops.grid, expr, device="cpu")
    assert ts.tdep and not ts.is_zero()
    assert rel(ts(0.25).numpy(), js(0.25)) < 1e-14
    assert TS(tops.ps, tops.grid, 0.0, device="cpu").is_zero()


# ---------------------------------------------------------- preconditioner


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
@pytest.mark.parametrize("use_rho_diff", [True, False])
def test_apply_linearized_matches(problems, dtype, tol, use_rho_diff):
    jops, tops = problems
    jpc = jlinalg.BlockSpectralPreconditioner(jops.grid, jops,
                                              compute_dtype=dtype)
    tpc = tlinalg.BlockSpectralPreconditioner(tops.grid, tops,
                                              compute_dtype=dtype,
                                              device="cpu")
    rng = np.random.default_rng(7)
    v = rng.standard_normal(jops.grid.Vshape)
    means = [9000.0, 6000.0, 800.0]
    rd = 3.0 if use_rho_diff else None
    shift = 1.0 / (1e-2 * 0.435866521508459)
    ref = jpc.apply_linearized(
        jnp.asarray(v), shift, 0.0, [jnp.asarray(m) for m in means],
        rho_diff=rd,
    )
    out = tpc.apply_linearized(
        torch.as_tensor(v), shift, 0.0,
        [torch.tensor(m, dtype=torch.float64) for m in means],
        rho_diff=rd,
    )
    assert out.dtype == torch.float64
    assert rel(out.numpy(), ref) < tol


def test_spectral_apply_matches(problems):
    jops, tops = problems
    jpc = jlinalg.SpectralPreconditioner(jops.grid, compute_dtype="float64")
    tpc = tlinalg.SpectralPreconditioner(tops.grid, compute_dtype="float64",
                                         device="cpu")
    v = np.random.default_rng(8).standard_normal(jops.grid.Vshape)
    diff, decay = tops.stiff_coefficients(0.0)
    ref = jpc.apply(jnp.asarray(v), 50.0, diff, decay)
    out = tpc.apply(torch.as_tensor(v), 50.0, diff, decay)
    assert rel(out.numpy(), ref) < 1e-12


def test_wlte_norm_delta_matches():
    rng = np.random.default_rng(9)
    u1 = 9000 + rng.standard_normal((3, 8, 8))
    d = 1e-3 * rng.standard_normal((3, 8, 8))
    ref = float(jsteppers.wlte_norm_delta(jnp.asarray(u1), jnp.asarray(d),
                                          0.01, 1e-6))
    out = tsteppers.wlte_norm_delta(torch.as_tensor(u1), torch.as_tensor(d),
                                    0.01, 1e-6)
    assert out.dim() == 0
    assert abs(float(out) - ref) <= 1e-14 * ref
