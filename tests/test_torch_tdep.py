"""The fused kernels on problems with time-dependent PDE coefficients.

Each kernel reads t from its scalar pack (``sc[0]``), and the generated
header (ops/codegen.py) prints a time-dependent coefficient as its
float32 expression of t, as the Pallas bodies evaluate ``G_fn(..., t)``
and ``lig[l]["gamma"](t)`` (ksfd_tpu/ops/pallas_stencil.py:584-716).
The step runs the jvp/resid kernels there and drops only the delta
kernel (``stage_delta_ok``), as ksfd_tpu/solvers/solver.py:317-335
does.  The problems: the 2D bench problem at 32^2 and aggregation3d at
8 x 8 x 16, each with its G (through ``s2``) and one ligand decay
depending on t.  Held here:

- the plain rhs, jvp and resid against the reference's Pallas kernels
  in interpret mode, at two times: 1e-5 of max|ref|;
- the CUDA bodies of csrc/stencil2d.cu and csrc/stencil3d.cu, compiled
  as host C++, against the plain bodies at 1e-5 of max|plain|, and a
  member-batched launch with a distinct t per member bit-equal to the
  single-member launches;
- the mixed step, one step and a chain of 3 from t = 20, against the
  reference's step (its Pallas kernels in interpret mode) at 1e-5 of
  the increment; its build flags against the reference's BUILD_INFO and
  its kernel calls per step (8 resid, no delta).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
from helpers import make_clargs
from ksfd_tpu.ops.pallas_stencil import make_pallas_kernels
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu.solvers.solver import BUILD_INFO
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops.codegen import pointwise_header
from ksfd_tpu_torch.ops.fused_stencil import kernel_refusal, \
    make_fused_kernels
from ksfd_tpu_torch.solvers import make_multistep_fn, make_step_fn
from test_torch_3d import aggregation3d_params, host_kernels_3d, \
    host_run_3d
from test_torch_kernels import host_state
from test_torch_probe import host_kernels, host_run

N2 = 32
SHAPE3 = (8, 8, 16)
ATOL = 0.01
#: the coefficients that depend on t
TDEP = ["gamma_1_1=0.01*(1 + t)", "s2=sigma**2/2*(1 + 0.1*t)"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("KSFD_PALLAS_INTERPRET", "1")


def tdep_params(params):
    keys = {p.split("=")[0] for p in TDEP}
    return [p for p in params if p.split("=")[0] not in keys] + TDEP


def clargs_of(dim):
    if dim == 2:
        clargs = ge._make_problem(N2, N2)[0].clargs
        clargs.params = tdep_params(clargs.params)
        return clargs
    return make_clargs(params=tdep_params(aggregation3d_params(SHAPE3[0])))


@pytest.fixture(scope="module", params=[2, 3])
def prob(request):
    """(reference ops, port ops, shape) of the time-dependent problem."""
    dim = request.param
    clargs = clargs_of(dim)
    shape = (N2, N2) if dim == 2 else SHAPE3
    jps = KJ.SolutionParameters(clargs)
    jgrid = KJ.Grid(dim=dim, width=1.0, height=1.0, depth=1.0,
                    **dict(zip(("nx", "ny", "nz"), shape)),
                    dof=jps.nligands + 1, order=jps.degree)
    jops = KJ.ops.PDEOperators(jps, jgrid)
    _, _, tops = problem_from_clargs(clargs, *shape, device="cpu")
    assert jops._G_tdep and jops._lig_tdep
    assert tops._G_tdep and tops._lig_tdep and not tops.stage_delta_ok()
    return jops, tops, shape


def rough_state(shape, seed=0, scale=1000.0):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + f * scale * np.abs(rng.standard_normal(shape))
        for f in (3, 1, 0.5)
    ])


def test_gate_admits_and_header_prints_t(prob):
    """The gate runs the kernels; the header takes t in every pointwise
    function and prints the decay as an expression of it."""
    _, tops, _ = prob
    assert kernel_refusal(tops.grid, tops) is None
    text = pointwise_header(tops)
    for decl in ("ksfd_G(const float* f, float t)",
                 "ksfd_dG(const float* f, float t, float* out)",
                 "const float* s, float t)", "ksfd_gamma(int l, float t)"):
        assert decl in text, decl
    gamma = text[text.index("ksfd_gamma(int l"):]
    assert "case 0: return" in gamma and "t" in gamma.split(";")[0]


@pytest.fixture(scope="module")
def pallas(prob):
    """The reference's Pallas kernels of the problem, interpret mode."""
    jops, _, shape = prob
    return make_pallas_kernels(jops, **(dict(tile_x=16) if len(shape) == 2
                                        else {}), interpret=True)


@pytest.mark.parametrize("t", [0.5, 30.0])
def test_plain_bodies_match_pallas(prob, pallas, t):
    _, tops, shape = prob
    pk = pallas
    fk = make_fused_kernels(tops)
    rng = np.random.default_rng(1)
    u = rough_state(shape)
    u, v, b = (a.astype(np.float32) for a in (
        u, rng.standard_normal(u.shape), rng.standard_normal(u.shape)))
    pairs = [
        (pk.rhs(jnp.asarray(u), t), fk.rhs(torch.from_numpy(u), t)),
        (pk.jvp(jnp.asarray(u), jnp.asarray(v), t),
         fk.jvp(torch.from_numpy(u), torch.from_numpy(v), t)),
        (pk.resid(*[jnp.asarray(a) for a in (u, v, b)], t, 7.5),
         fk.resid(*[torch.from_numpy(a) for a in (u, v, b)], t, 7.5)),
    ]
    for ref, out in pairs:
        ref = np.asarray(ref)
        assert np.isfinite(ref).all() and out.dtype == torch.float32
        assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # the coefficients' change since t = 0 shows far above that bound
    at0 = fk.jvp(torch.from_numpy(u), torch.from_numpy(v), 0.0).numpy()
    ref = np.asarray(pairs[1][0])
    assert np.abs(at0 - ref).max() > 100 * 1e-5 * np.abs(ref).max()


#: the position of t in each kernel's arguments (host_state's tuples)
T_ARG = dict(jvp=2, resid=3, delta=3, rhs=1)


def host_args_3d(tops, shape, seed):
    rng = np.random.default_rng(seed)
    raw = torch.from_numpy(rough_state(shape, seed=seed))
    u64 = tops.groom(raw)
    v, b = (torch.from_numpy(rng.standard_normal(u64.shape))
            for _ in range(2))
    u1 = tops.groom(u64 + torch.from_numpy(
        100.0 * rng.standard_normal(u64.shape)))
    return dict(jvp=(raw, v, 0.5), resid=(raw, v, b, 0.5, 7.5),
                delta=(u64, u1 - u64, u1, 0.5), rhs=(raw, 0.5))


def test_cuda_source_bodies_match_plain(prob, tmp_path):
    """The four march bodies compiled as host C++ with the problem's
    header equal the plain versions at t = 30 (1e-5 of max|plain|); a
    launch of 3 members at t = 0, 15 and 30 equals their single-member
    launches bit for bit."""
    _, tops, shape = prob
    dof = tops.nligands + 1
    if len(shape) == 2:
        host = host_kernels(tops, tmp_path)
        if host is None:
            pytest.skip("no C++ compiler found to compile the kernel bodies")
        fk = make_fused_kernels(tops)
        run = lambda *a: host_run(host, *a, shape, dof)
        states = [host_state(tops, shape, dof, seed=30 + i)
                  for i in range(3)]
    else:
        fk, host = host_kernels_3d(tops, tmp_path)
        run = lambda *a: host_run_3d(host, *a, shape, dof)
        states = [host_args_3d(tops, shape, 30 + i) for i in range(3)]
    for name in ("jvp", "resid", "delta", "rhs"):
        k = fk.kernels[name]
        prepared = []
        for i, per in enumerate(states):
            args = list(per[name])
            args[T_ARG[name]] = 15.0 * i
            prepared.append(k.prepare(*args))
        sc, operands = prepared[-1]
        out = run(name, sc, operands)
        ref = k.body(sc, operands)
        assert torch.isfinite(out).all(), name
        err = float((out - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)
        sc_b = torch.stack([p[0] for p in prepared])
        ops_b = [torch.stack(xs) for xs in zip(*[p[1] for p in prepared])]
        out_b = run(name, sc_b, ops_b)
        for i, (sc, operands) in enumerate(prepared):
            assert torch.equal(out_b[i], run(name, sc, operands)), (name, i)


def scalar(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("nsteps", [1, 3])
def test_step_matches_reference(prob, interpret, nsteps):
    """The mixed step on the kernels (resid, no delta) from t = 20
    against the reference's step with its Pallas kernels, applied in
    turn: within 1e-5 of the increment."""
    jops, tops, shape = prob
    h = 1e-3 if len(shape) == 2 else 1e-2
    u0 = np.array(jops.groom(jnp.asarray(rough_state(shape, seed=3))))
    step_j, _ = jstep(jops, KJ.NumericsOptions(), atol=ATOL, rtol=1e-6)
    u, t = jnp.asarray(u0), 20.0
    for _ in range(nsteps):
        u, _ = step_j(u, t, h)
        t += h
    ref = np.asarray(u)
    assert BUILD_INFO["pallas_resid"] and not BUILD_INFO["pallas_delta"]
    multi, _ = make_multistep_fn(tops, NumericsOptions(), atol=ATOL,
                                 rtol=1e-6)
    out, t1, _ = multi(torch.from_numpy(u0), scalar(20.0), scalar(h), nsteps)
    assert multi.kernels is not None
    inc = float(np.abs(ref - u0).max())
    assert float(np.abs(out.numpy() - ref).max()) <= 1e-5 * inc
    assert abs(float(t1) - t) <= 1e-12 * t


@pytest.mark.parametrize("change", [dict(), dict(stage_delta=False),
                                    dict(precision="float32")])
def test_build_info_and_calls_match_reference(prob, interpret, change):
    """The step's flags are the reference's BUILD_INFO on this problem
    (its kernels on, delta off), and a step calls the kernels the flags
    name: 8 resid on the mixed path, 4 rhs and 8 jvp in the fast mode,
    never delta."""
    jops, tops, shape = prob
    keys = ("mixed32", "pallas_rhs", "pallas_jvp", "pallas_resid",
            "pallas_delta", "fast32")
    jstep(jops, dataclasses.replace(KJ.NumericsOptions(), **change))
    want = {k: bool(BUILD_INFO[k]) for k in keys}
    kern = make_fused_kernels(tops)
    calls = {name: 0 for name in kern.kernels}
    for name, k in kern.kernels.items():
        def counted(*a, _name=name, _body=k._body):
            calls[_name] += 1
            return _body(*a)
        k._body = counted
    numerics = dataclasses.replace(NumericsOptions(), **change)
    step, _ = make_step_fn(tops, numerics, atol=ATOL, rtol=1e-6,
                           kernels=kern)
    assert {k: step.build_info[k] for k in keys} == want
    assert want["pallas_jvp"] and not want["pallas_delta"]
    u1, e = step(torch.from_numpy(rough_state(shape)), scalar(20.0),
                 scalar(1e-3))
    fast = want["fast32"]
    assert calls == dict(rhs=4 if fast else 0, jvp=8 if fast else 0,
                         resid=0 if fast else 8, delta=0)
    assert bool(torch.isfinite(e))
