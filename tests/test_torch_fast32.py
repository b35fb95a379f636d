"""The port's float32 fast mode against ksfd_tpu on the CPU.

``NumericsOptions(precision="float32")`` runs the reference's ``fast32``
branch of make_step_fn: a float32 state, the RHS from the fused rhs
kernel (B7 in 2D, B6a in 3D) and W = shift*v - jvp(v) from the jvp
kernel.  Each case feeds the same seeded numpy inputs through both
packages, in 2D (the bench problem at 32^2) and in 3D (aggregation3d at
16 x 8 x 16); the reference runs its Pallas kernels in interpret mode
(as tests/test_pallas.py and tests/test_3d.py do), the port the plain
versions of its kernels.

Tolerances:

- the plain rhs against the Pallas rhs: 1e-5 of max|ref| on rough and
  clamped states.  On the near-uniform wave state the centred row
  rho*lap(G - G_mean) is made of float32 rounding: one ulp of G moves
  it by its whole size (pallas_stencil.py:44-48), and the two packages
  evaluate log/tanh with different float32 libraries.  There row 0's
  bound adds that rounding floor, ``4 * 2^-23 * max|G| * max|rho| *
  sum|lap coefficients|``, and the U rows keep 1e-5 of their own size;
- the plain rhs against the float64 RHS on rough states: 5e-4 of
  max|ref|, the bound of tests/test_pallas.py:52;
- steps and chains: ``1e-4 * max|u1 - u0| + 4 * 2^-23 * max|u0|``, the
  fast mode's state being float32 itself.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
from ksfd_tpu.ops.pallas_stencil import make_pallas_kernels
from ksfd_tpu.solvers import gmres as jgmres
from ksfd_tpu.solvers import linalg as jlinalg
from ksfd_tpu.solvers import make_multistep_fn as jmultistep
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu.solvers import steppers as jsteppers
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops import PDEOperators
from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels
from ksfd_tpu_torch.ops.stencil import deriv_coeffs
from ksfd_tpu_torch.solvers import gmres as tgmres
from ksfd_tpu_torch.solvers import linalg as tlinalg
from ksfd_tpu_torch.solvers import make_multistep_fn, make_step_fn
from ksfd_tpu_torch.solvers import steppers as tsteppers
from test_torch_3d import _problems as problems_3d

N = 32
SHAPE3 = (16, 8, 16)
EPS32 = 2.0 ** -23
FAST = NumericsOptions(precision="float32")


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("KSFD_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module", params=["2d", "3d"])
def prob(request):
    """The reference's ops and Pallas kernels (interpret mode), the
    port's ops and fused kernels, and the step size of the step tests
    (tests/test_torch_solver.py's and tests/test_torch_3d.py's)."""
    if request.param == "2d":
        jps, _, jops = ge._make_problem(N, N)
        _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu")
        pk = make_pallas_kernels(jops, tile_x=16, interpret=True)
        h = 1e-3
    else:
        jops, tops = problems_3d(SHAPE3)
        pk = make_pallas_kernels(jops, interpret=True)
        h = 1e-2
    return SimpleNamespace(jops=jops, tops=tops, pk=pk, h=h,
                           fk=make_fused_kernels(tops),
                           shape=tuple(tops.grid.Sshape))


def rough_state(shape, seed=0, scale=1000.0):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal(shape)),
        6000 + scale * np.abs(rng.standard_normal(shape)),
        6000 + 0.5 * scale * np.abs(rng.standard_normal(shape)),
    ])


def wave_state(shape):
    """Near-uniform fields ~1e4 with ~1-amplitude structure."""
    axes = [np.arange(n) / n for n in shape]
    wave = np.sin(2 * np.pi * sum(np.meshgrid(*axes, indexing="ij")))
    return np.stack([9000 + wave, 6162 + 0.7 * wave, 797 + 0.1 * wave])


def clamped_state(shape, ops):
    """A raw rough state with points below, at and NaN against the
    floors (the kernel's where-form clamp)."""
    u = rough_state(shape, seed=2)
    last = tuple(n - 1 for n in shape)
    u[(0, 3, 5) + (2,) * (len(shape) - 2)] = 0.5 * ops.rhomin
    u[(0,) + last] = ops.rhomin
    u[(1, 4, 4) + (0,) * (len(shape) - 2)] = ops.Umin
    u[(2, 1) + last[1:]] = np.nan
    return u


def state(name, p):
    if name == "rough":
        return rough_state(p.shape)
    if name == "wave":
        return wave_state(p.shape)
    return clamped_state(p.shape, p.tops)


def rounding_floor(ops, u):
    """The float32 rounding of the centred rho*lap(G - G_mean) row:
    four ulps of max|G| through max|rho| times the Laplacian's
    coefficient sum."""
    ug = ops.groom(torch.as_tensor(u, dtype=torch.float64))
    lap_sum = sum(np.abs(deriv_coeffs(2, ops.sw, h)).sum()
                  for h in ops.spacing)
    G = ops.G(ug, 0.0)
    return (4 * EPS32 * float(G.abs().max()) * float(ug[0].abs().max())
            * lap_sum)


# ------------------------------------------------------------ the kernels


@pytest.mark.parametrize("name", ["rough", "wave", "clamped"])
def test_plain_rhs_matches_pallas(prob, name):
    u = state(name, prob).astype(np.float32)
    ref = np.asarray(prob.pk.rhs(jnp.asarray(u), 0.5))
    out = prob.fk.rhs(torch.from_numpy(u), 0.5)
    assert out.dtype == torch.float32 and out.shape == u.shape
    assert np.isfinite(ref).all() and bool(torch.isfinite(out).all())
    err = np.abs(out.numpy() - ref)
    if name != "wave":
        assert err.max() <= 1e-5 * np.abs(ref).max()
        return
    # the U rows hold 1e-5 of their own size; the floor covers row 0 only
    for l in range(1, ref.shape[0]):
        assert err[l].max() <= 1e-5 * np.abs(ref[l]).max(), l
    floor = rounding_floor(prob.tops, u)
    # row 0 is itself of rounding size here (the floor is 2.3-3.2 times
    # max|ref[0]|); a floor far above it would leave nothing to compare
    assert floor <= 4 * np.abs(ref[0]).max()
    assert err[0].max() <= 1e-5 * np.abs(ref[0]).max() + floor


@pytest.mark.parametrize("seed", [0, 4])
def test_plain_rhs_matches_float64_rhs(prob, seed):
    """On rough states the centred f32 RHS stays within 5e-4 of the
    reference's float64 RHS of the same (f32-representable) state."""
    u = rough_state(prob.shape, seed=seed).astype(np.float32)
    oracle = np.asarray(prob.jops.rhs(jnp.asarray(u.astype(np.float64)),
                                      0.5))
    out = prob.fk.rhs(torch.from_numpy(u), 0.5).numpy()
    assert np.abs(out - oracle).max() <= 5e-4 * np.abs(oracle).max()


def test_scalar_pack(prob):
    """sc = [t, means, G(means), reacts] from float64 means of the
    groomed view, cast once: a NaN entry does not poison it."""
    tops = prob.tops
    u = clamped_state(prob.shape, tops).astype(np.float32)
    sc, (u32,) = prob.fk.kernels["rhs"].prepare(torch.from_numpy(u), 0.25)
    dof = tops.nligands + 1
    assert sc.dtype == torch.float32 and tuple(sc.shape) == (2 * dof + 1,)
    g = np.asarray(prob.jops.groom(jnp.asarray(u.astype(np.float64))))
    means = g.reshape(dof, -1).mean(axis=1)
    G_m = float(tops._G_fn(*[torch.tensor(m) for m in means], 0.25))
    reacts = [c["s"](0.25) * means[0] - c["gamma"](0.25) * means[1 + l]
              for l, c in enumerate(tops._lig_coeffs)]
    ref = np.array([0.25, *means, G_m, *reacts]).astype(np.float32)
    np.testing.assert_array_equal(sc.numpy(), ref)
    assert u32.dtype == torch.float32 and u32.is_contiguous()


def test_sources_added_outside_the_kernel():
    """Active sources are added after the kernel, in f32, and the sum
    matches the reference's fast-mode rhs."""
    jps, jgrid, _ = ge._make_problem(N, N)
    srcs = ["murho*sin(2*pi*x)*cos(2*pi*y) + 100*t", 0.0, "3*x"]
    jops = KJ.ops.PDEOperators(jps, jgrid, sources=srcs)
    ps, grid, _ = problem_from_clargs(jps.clargs, N, N, device="cpu")
    tops = PDEOperators(ps, grid, sources=srcs, device="cpu")
    fk = make_fused_kernels(tops)
    u = rough_state((N, N), seed=5).astype(np.float32)
    ref = np.asarray(make_pallas_kernels(jops, tile_x=16, interpret=True)
                     .rhs(jnp.asarray(u), 0.5))
    ut = torch.from_numpy(u)
    out = fk.rhs(ut, 0.5)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    base = fk.kernels["rhs"](ut, 0.5)
    assert not torch.equal(out, base)
    for i, s in enumerate(tops.sources):
        expect = base[i] + s(0.5).float() if tops._source_active[i] \
            else base[i]
        assert torch.equal(out[i], expect), i


# ------------------------------------------------- float32 building blocks


def test_f32_solver_pieces_match_reference(prob):
    """The fast mode's pieces in float32: the block pc apply with an f32
    shift, f32 means and an f32 rho_diff, three Richardson sweeps over
    an f32 W, and wlte_norm_delta of f32 arrays, each against the
    reference on the same f32 inputs (1e-5 relative: the f32 GEMMs and
    sums take other orders)."""
    jops, tops = prob.jops, prob.tops
    rng = np.random.default_rng(8)
    u = rough_state(prob.shape, seed=6).astype(np.float32)
    v = rng.standard_normal(u.shape).astype(np.float32)
    f32 = lambda x: np.float32(x)
    shift = f32(1.0 / (prob.h * 0.435866521508459))
    means = [f32(m) for m in u.reshape(u.shape[0], -1).mean(axis=1)]
    rho_diff = f32(3.0)
    jpc = jlinalg.BlockSpectralPreconditioner(jops.grid, jops,
                                              compute_dtype="float32")
    tpc = tlinalg.BlockSpectralPreconditioner(tops.grid, tops,
                                              compute_dtype="float32",
                                              device="cpu")
    jM = lambda x: jpc.apply_linearized(
        x, jnp.asarray(shift), jnp.float32(0.0),
        [jnp.asarray(m) for m in means], jnp.asarray(rho_diff))
    tM = lambda x: tpc.apply_linearized(
        x, torch.tensor(shift), torch.tensor(0.0),
        [torch.tensor(m) for m in means], torch.tensor(rho_diff))
    ref, out = np.asarray(jM(jnp.asarray(v))), tM(torch.from_numpy(v))
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # W = shift*I - J with a diagonal f32 J: the solve's own arithmetic
    diag = (0.1 * rng.standard_normal(u.shape)).astype(np.float32)
    ref = np.asarray(jgmres.richardson_solve(
        lambda x: shift * x - jnp.asarray(diag) * x, jnp.asarray(v), jM,
        iters=3))
    td = torch.from_numpy(diag)
    out = tgmres.richardson_solve(lambda x: torch.tensor(shift) * x - td * x,
                                  torch.from_numpy(v), tM, iters=3)
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    d = (1e-3 * v).astype(np.float32)
    ref = float(jsteppers.wlte_norm_delta(jnp.asarray(u), jnp.asarray(d),
                                          0.01, 1e-6))
    e = tsteppers.wlte_norm_delta(torch.from_numpy(u), torch.from_numpy(d),
                                  0.01, 1e-6)
    assert e.dtype == torch.float32 and abs(float(e) - ref) <= 1e-5 * ref


# ------------------------------------------------------------- main path


def _bound(u_ref, u0):
    return (1e-4 * np.abs(u_ref - u0).max()
            + 4 * EPS32 * np.abs(u0).max())


def test_fast_step_matches_reference(prob, interpret):
    u0 = np.array(prob.jops.groom(jnp.asarray(rough_state(prob.shape))))
    step_j, _ = jstep(prob.jops, KJ.NumericsOptions(precision="float32"),
                      atol=0.01, rtol=1e-6)
    u_ref, e_ref = step_j(jnp.asarray(u0), jnp.asarray(0.0),
                          jnp.asarray(prob.h))
    step_t, _ = make_step_fn(prob.tops, FAST, atol=0.01, rtol=1e-6)
    u1, e = step_t(torch.from_numpy(u0), torch.tensor(0.0, dtype=torch.float64),
                   torch.tensor(prob.h, dtype=torch.float64))
    assert u1.dtype == torch.float32 and e.dtype == torch.float32
    assert u_ref.dtype == jnp.float32
    assert bool(torch.isfinite(e)) and np.isfinite(float(e_ref))
    u_ref = np.asarray(u_ref)
    assert np.abs(u1.numpy() - u_ref).max() <= _bound(u_ref, u0)


def test_fast_chain_matches_reference(prob, interpret):
    u0 = np.array(prob.jops.groom(jnp.asarray(rough_state(prob.shape,
                                                          seed=1))))
    multi_j, _ = jmultistep(prob.jops,
                            KJ.NumericsOptions(precision="float32"),
                            atol=0.01, rtol=1e-6, static_steps=False)
    u_ref, t_ref, e_ref = multi_j(jnp.asarray(u0), jnp.asarray(0.0),
                                  jnp.asarray(prob.h), 3)
    multi_t, _ = make_multistep_fn(prob.tops, FAST, atol=0.01, rtol=1e-6)
    u3, t3, e3 = multi_t(torch.from_numpy(u0), 0.0,
                         torch.tensor(prob.h, dtype=torch.float64), 3)
    assert u3.dtype == t3.dtype == e3.dtype == torch.float32
    assert float(t3) == float(t_ref)
    assert bool(torch.isfinite(e3)) and np.isfinite(float(e_ref))
    u_ref = np.asarray(u_ref)
    assert np.abs(u3.numpy() - u_ref).max() <= _bound(u_ref, u0)


def test_fast_launch_counts_per_step(prob):
    """Per fast-mode step: 4 rhs (f0 and stages 2-4), 8 jvp (2 per
    stage solve), no resid or delta.  On the CPU the wrappers run their
    plain bodies, so the bodies' calls are counted."""
    kern = make_fused_kernels(prob.tops)
    calls = {name: 0 for name in kern.kernels}
    for name, k in kern.kernels.items():
        def counted(*a, _name=name, _body=k._body):
            calls[_name] += 1
            return _body(*a)
        k._body = counted
    multi, _ = make_multistep_fn(prob.tops, FAST, atol=0.01, rtol=1e-6,
                                 kernels=kern)
    u, t, e = multi(torch.from_numpy(wave_state(prob.shape)),
                    torch.tensor(0.0, dtype=torch.float64),
                    torch.tensor(prob.h, dtype=torch.float64), 2)
    assert calls == dict(rhs=8, jvp=16, resid=0, delta=0)
    assert all(k.launches == 0 for k in kern.kernels.values())
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(e))


def test_fast_mode_has_no_f0_chain(prob):
    chain, _ = make_step_fn(prob.tops, FAST, chain_f0=True)
    assert chain is None


@pytest.mark.parametrize("change", [
    dict(stage_delta=False), dict(sweep_dtype="float64"),
])
def test_fast_mode_ignores_mixed_path_options(prob, change):
    """stage_delta and sweep_dtype select pieces of the float64 path;
    the reference's fast mode ignores them and so does the port."""
    numerics = dataclasses.replace(FAST, **change)
    step, _ = make_step_fn(prob.tops, numerics, atol=0.01, rtol=1e-6)
    u1, e = step(torch.from_numpy(wave_state(prob.shape)),
                 torch.tensor(0.0, dtype=torch.float64),
                 torch.tensor(prob.h, dtype=torch.float64))
    assert u1.dtype == torch.float32 and bool(torch.isfinite(e))


def test_fast_mode_time_dependent_coefficients_raise(interpret):
    """Time-dependent PDE coefficients no longer raise: the kernels read
    t from their scalar packs, so the fast mode runs its rhs and jvp
    kernels there (delta, which the fast mode never runs, stays off),
    and its step agrees with the reference's, whose Pallas kernels run
    in interpret mode, on the bound of the other fast-mode steps."""
    jps, _, _ = ge._make_problem(N, N)
    clargs = jps.clargs
    clargs.params = [p for p in clargs.params
                     if not p.startswith("gamma_1_1=")] + [
        "gamma_1_1=0.01*(1 + t)"]
    _, _, tops = problem_from_clargs(clargs, N, N, device="cpu")
    assert not tops.stage_delta_ok()
    kern = make_fused_kernels(tops)
    calls = {name: 0 for name in kern.kernels}
    for name, k in kern.kernels.items():
        def counted(*a, _name=name, _body=k._body):
            calls[_name] += 1
            return _body(*a)
        k._body = counted
    step, _ = make_step_fn(tops, FAST, atol=0.01, rtol=1e-6, kernels=kern)
    info = step.build_info
    assert info["kernel_refusal"] is None and info["pallas_rhs"]
    assert info["pallas_jvp"] and not info["pallas_delta"]
    jps = KJ.SolutionParameters(clargs)
    jgrid = KJ.Grid(dim=2, width=1.0, height=1.0, nx=N, ny=N,
                    dof=jps.nligands + 1, order=jps.degree)
    jops = KJ.ops.PDEOperators(jps, jgrid)
    u0 = np.array(jops.groom(jnp.asarray(rough_state((N, N)))))
    t0, h = 20.0, 1e-3
    step_j, _ = jstep(jops, KJ.NumericsOptions(precision="float32"),
                      atol=0.01, rtol=1e-6)
    u_ref, _ = step_j(jnp.asarray(u0), jnp.asarray(t0), jnp.asarray(h))
    u1, e = step(torch.from_numpy(u0),
                 torch.tensor(t0, dtype=torch.float64),
                 torch.tensor(h, dtype=torch.float64))
    assert calls == dict(rhs=4, jvp=8, resid=0, delta=0)
    assert u1.dtype == torch.float32 and bool(torch.isfinite(e))
    u_ref = np.asarray(u_ref)
    assert np.abs(u1.numpy() - u_ref).max() <= _bound(u_ref, u0)
    # the coefficient's change since t = 0 shows far above that bound
    u_at0, _ = step(torch.from_numpy(u0),
                    torch.tensor(0.0, dtype=torch.float64),
                    torch.tensor(h, dtype=torch.float64))
    assert np.abs(u_at0.numpy() - u_ref).max() > 10 * _bound(u_ref, u0)


# ------------------------------------------------------------- on a card


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_cuda_rhs_matches_plain(dim):
    """On a card: B7 (2D) and B6a (3D) equal their plain versions to
    1e-5 of max|plain| on rough, near-uniform and clamped states and
    count their launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    if dim == 2:
        jps, _, _ = ge._make_problem(N, N)
        _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cuda")
    else:
        from test_torch_3d import aggregation3d_params
        from helpers import make_clargs

        tops = problem_from_clargs(
            make_clargs(params=aggregation3d_params(SHAPE3[0])), *SHAPE3,
            device="cuda")[2]
    p = SimpleNamespace(shape=tuple(tops.grid.Sshape), tops=tops)
    k = make_fused_kernels(tops).kernels["rhs"]
    for name in ("rough", "wave", "clamped"):
        u = torch.as_tensor(state(name, p), device="cuda").float()
        n0 = k.launches
        out, ref = k(u, 0.5), k.plain(u, 0.5)
        assert k.launches == n0 + 1
        assert bool(torch.isfinite(out).all())
        assert float((out - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max()), name
