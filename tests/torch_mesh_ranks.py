"""Gloo ranks for the port's mesh tests, spawned once per test module.

``run_ranks({n: cases, ...})`` starts, for each entry at once, ``n``
processes (spawn), each a torch.distributed rank over gloo on the CPU
(a ``file://`` store in a fresh directory), runs every named case of
``CASES`` in order and hands back ``{n: {rank: {case: result}}}``, the
results numpy arrays, numbers and strings (``start_ranks`` and
``collect`` split the call, so the parent can work while they run).  A rank that fails fails the call with its traceback.  This
module imports torch and the port only: the rank processes never load
JAX, so the test modules compare the results with the reference in the
parent process.
"""

import math
import os
import tempfile
import traceback

import numpy as np

#: the grids of the cases (the test modules build the same on their side)
N2 = 64          # 2D steps, the sharded pc: the bench problem
N2_SMALL = 32    # 2D layout checks
N3 = 32          # 3D
H = 1e-3
H3 = 1e-2
CHUNK_ACCEPTS = 5
CFL_SAFETY = 0.5


def CHUNK_NUMERICS(options):
    """The chunk's numerics, of either package's NumericsOptions class:
    pc_dtype float32 (as test_sharded_adaptive_chunk_f64 pins it) and
    one tier.  Its starts accept every attempt at the bottom tier, and
    the ladder probes only after 16 accepts, so a three-tier ladder
    would take the same attempts; one tier keeps the reference's chunk
    quick to compile."""
    return options(pc_dtype="float32", ksp_iters_max=0)


def rough_state(shape, seed=0, scale=1000.0):
    """The rough state of tests/test_pallas.py at any shape."""
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal(shape)),
        6000 + scale * np.abs(rng.standard_normal(shape)),
        6000 + 0.5 * scale * np.abs(rng.standard_normal(shape)),
    ])


def bench_problem(n):
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.tools.problems import bench_clargs

    return problem_from_clargs(bench_clargs(n), n, n, device="cpu")


def ops2d_params():
    """tests/test_pallas.py ops2d's parameters (options92 at 64^2)."""
    from ksfd_tpu_torch.tools.problems import OPTIONS92_PARAMS

    return [
        p for p in OPTIONS92_PARAMS
        if p.split("=", 1)[0]
        not in ("nelements", "dim", "rho0", "U0_1_1", "U0_2_1")
    ] + ["nelements=64", "dim=2", "height=1", "rho0=murho",
         "U0_1_1=", "U0_2_1="]


def aggregation3d_params(n):
    """The parameter lines of examples/aggregation3d, nelements=n."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = []
    with open(os.path.join(root, "examples", "aggregation3d")) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("--petsc"):
                break
            if line and not line.startswith(("#", "--")):
                params.append(line)
    return [p for p in params if not p.startswith("nelements=")] + [
        "nelements=%d" % n]


# ---- the cases: each takes the rank's context, returns a dict --------

def case_layout(ctx):
    """distribute / local_values / global_from_local / owned_box /
    gather, and the halo rows of one and of two slabs at once."""
    import torch

    from ksfd_tpu_torch.parallel import (
        distribute, global_from_local, grid_mesh, local_values, owned_box,
        process_box, process_count, process_index)
    from ksfd_tpu_torch.parallel.mesh import exchange_halos, halo_rows

    n = N2_SMALL
    _, grid, ops = bench_problem(n)
    mesh = grid_mesh(grid, device="cpu")
    u = rough_state((n, n), seed=3)
    u_loc, m2 = distribute(u, grid, mesh)
    block = local_values(u_loc, mesh)
    out = dict(
        slab=u_loc.numpy(), box=np.array(owned_box(u_loc, mesh)),
        pbox=np.array(process_box(grid, mesh)),
        block_equal=bool(np.array_equal(block, u_loc.numpy())),
        from_block=bool(torch.equal(global_from_local(block, grid, mesh),
                                    u_loc)),
        from_full=bool(torch.equal(global_from_local(u, grid, mesh),
                                   u_loc)),
        gathered=mesh.gather(u_loc).numpy(),
        same_mesh=m2 is mesh, count=process_count(), index=process_index(),
    )
    lo, hi = halo_rows(u_loc, ops.sw, mesh)
    out.update(lo=lo.numpy(), hi=hi.numpy(),
               contiguous=lo.is_contiguous() and hi.is_contiguous())
    v = torch.from_numpy(rough_state((n, n), seed=4)).float()
    v_loc = distribute(v, grid, mesh)[0]
    pair = exchange_halos([u_loc.float(), v_loc], ops.sw, mesh)
    out.update(lo_v=pair[1][0].numpy(), hi_v=pair[1][1].numpy(),
               lo_u32=pair[0][0].numpy())
    return out


def case_reduce(ctx):
    """The mesh reductions, in float64 and bfloat16."""
    import torch

    from ksfd_tpu_torch.parallel import grid_mesh
    from ksfd_tpu_torch.parallel.mesh import (
        all_reduce_max, all_reduce_min, all_reduce_sum)

    _, grid, _ = bench_problem(N2_SMALL)
    mesh = grid_mesh(grid, device="cpu")
    x = torch.tensor([1.0 + mesh.rank, -2.0 * mesh.rank], dtype=torch.float64)
    xb = torch.tensor([0.5 + mesh.rank], dtype=torch.bfloat16)
    return dict(sum=all_reduce_sum(x, mesh).numpy(),
                max=all_reduce_max(x, mesh).numpy(),
                min=all_reduce_min(x, mesh).numpy(),
                bf16=all_reduce_sum(xb, mesh).float().numpy(),
                bf16_dtype=str(all_reduce_sum(xb, mesh).dtype),
                x_kept=x.numpy())


def case_refusals(ctx):
    """A y split (its box), an (n, 2) split of n ranks and a split that
    leaves fewer than sw rows (their errors)."""
    from ksfd_tpu_torch.parallel import grid_mesh

    out = {}
    _, grid, _ = bench_problem(N2_SMALL)
    for label, shape in (("y", (1, ctx["n"])), ("xy", (ctx["n"], 2))):
        try:
            out[label] = grid_mesh(grid, shape=shape, device="cpu").box
        except ValueError as e:
            out[label] = str(e)
    _, small, _ = bench_problem(ctx["n"])     # one row per rank < sw
    try:
        grid_mesh(small, shape=(ctx["n"], 1), device="cpu")
        out["rows"] = "no error"
    except ValueError as e:
        out["rows"] = str(e)
    return out


def case_pc_apply(ctx):
    """make_sharded_apply of the block pc at N2^2 in float32 and
    bfloat16 on a seeded residual, at the rough state's statistics."""
    import torch

    from ksfd_tpu_torch.parallel import distribute, grid_mesh
    from ksfd_tpu_torch.solvers.linalg import (
        BlockSpectralPreconditioner, make_sharded_apply)

    _, grid, ops = bench_problem(N2)
    mesh = grid_mesh(grid, device="cpu")
    u = ops.groom(torch.from_numpy(rough_state((N2, N2))))
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        u.shape)).float()
    u32 = u.float()
    t = torch.zeros((), dtype=torch.float32)
    means = [torch.mean(u32[i]) for i in range(3)]
    rho_diff = torch.max(u32[0] * ops._dG_fns[0](*u32, t))
    shift = torch.tensor(1.0 / (H * 0.435866521508459), dtype=torch.float64)
    out = {}
    for dtype in ("float32", "bfloat16"):
        pc = BlockSpectralPreconditioner(grid, ops, compute_dtype=dtype,
                                         device="cpu")
        apply = make_sharded_apply(pc, ops, mesh)
        y = apply(distribute(v, grid, mesh)[0], shift, t, means, rho_diff)
        out[dtype] = mesh.gather(y).numpy()
        out[dtype + "_dtype"] = str(y.dtype)
    return out


def _steps(ctx, numerics_list, make, h):
    """Each numerics' sharded step from the rough state: the gathered
    state and this rank's enorm and build info."""
    import torch

    from ksfd_tpu_torch.parallel import distribute, grid_mesh
    from ksfd_tpu_torch.solvers import make_step_fn

    _, grid, ops = make()
    mesh = grid_mesh(grid, device="cpu")
    u0 = ops.groom(torch.from_numpy(rough_state(tuple(grid.Sshape))))
    t = torch.zeros((), dtype=torch.float64)
    hh = torch.full((), h, dtype=torch.float64)
    out = {}
    for label, nm in numerics_list:
        step, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6, mesh=mesh)
        u1, e = step(distribute(u0, grid, mesh)[0], t, hh)
        out[label] = mesh.gather(u1).numpy()
        out[label + "_enorm"] = float(e)
        out[label + "_info"] = repr(step.build_info)
    return out


def case_steps_2d(ctx):
    """The sharded 2D steps at N2^2, h=H: float64 with pc_dtype auto
    (bfloat16 on 2 ranks) and pinned float32, and the fast mode."""
    from ksfd_tpu_torch import NumericsOptions

    return _steps(ctx, [
        ("f64_auto", NumericsOptions()),
        ("f64_f32pc", NumericsOptions(pc_dtype="float32")),
        ("fast32", NumericsOptions(precision="float32")),
    ], lambda: bench_problem(N2), H)


def case_step_f64_auto(ctx):
    """The sharded float64 step with pc_dtype auto alone."""
    from ksfd_tpu_torch import NumericsOptions

    return _steps(ctx, [("f64_auto", NumericsOptions())],
                  lambda: bench_problem(N2), H)


def case_multistep_3d(ctx):
    """The sharded 3D multistep at N3^3 (examples/aggregation3d), two
    steps of H3 from the rough state."""
    import torch

    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.parallel import distribute, grid_mesh
    from ksfd_tpu_torch.solvers import make_multistep_fn
    from ksfd_tpu_torch.tools.problems import make_clargs

    _, grid, ops = problem_from_clargs(
        make_clargs(params=aggregation3d_params(N3)), N3, N3, N3,
        device="cpu")
    mesh = grid_mesh(grid, device="cpu")
    u0 = ops.groom(torch.from_numpy(rough_state((N3,) * 3)))
    multi, _ = make_multistep_fn(ops, NumericsOptions(), atol=0.01,
                                 rtol=1e-6, mesh=mesh)
    u, t, emax = multi(distribute(u0, grid, mesh)[0],
                       torch.zeros((), dtype=torch.float64),
                       torch.full((), H3, dtype=torch.float64), 2)
    launches = {k: v.launches for k, v in multi.kernels.kernels.items()}
    return dict(u=mesh.gather(u).numpy(), t=float(t), emax=float(emax),
                launches=repr(launches), info=repr(multi.build_info))


def initial_state(shape):
    """__graft_entry__._initial_state at any shape: near-uniform ~9000."""
    axes = [np.arange(n) / n for n in shape]
    w = np.sin(2 * np.pi * sum(np.meshgrid(*axes, indexing="ij")))
    return np.stack([9000.0 + w, 9000.0 + 0.7 * w, 9000.0 + 0.1 * w])


def case_chunk(ctx):
    """The sharded adaptive chunk (CHUNK_NUMERICS) on
    tests/test_pallas.py's ops2d problem, from the rough state at h=H as
    test_sharded_adaptive_chunk_f64 starts it, and from the near-uniform state
    at h=1 without and with the CFL clamp (CFL_SAFETY): k, attempts, t,
    h, the per-attempt records and the state of each."""
    import torch

    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.parallel import distribute, grid_mesh
    from ksfd_tpu_torch.solvers import make_adaptive_chunk_fn
    from ksfd_tpu_torch.tools.problems import make_clargs

    _, grid, ops = problem_from_clargs(make_clargs(params=ops2d_params()),
                                       64, 64, device="cpu")
    mesh = grid_mesh(grid, device="cpu")
    out = {}
    for label, u0, h0, cfl in (
            ("rough", ops.groom(torch.from_numpy(rough_state((64, 64)))),
             H, None),
            ("smooth", torch.from_numpy(initial_state((64, 64))), 1.0, None),
            ("smooth_cfl", torch.from_numpy(initial_state((64, 64))), 1.0,
             CFL_SAFETY)):
        chunk, _ = make_adaptive_chunk_fn(
            ops, CHUNK_NUMERICS(NumericsOptions), atol=0.01, rtol=1e-6,
            mesh=mesh, cfl_safety=cfl)
        u, t, h, k, attempts, rejected = chunk(
            distribute(u0, grid, mesh)[0], 0.0, h0, 1e9, CHUNK_ACCEPTS)
        out[label] = dict(
            u=mesh.gather(u).numpy(), t=t, h=h, k=k, attempts=attempts,
            rejected=rejected, records=repr(chunk.stats.records),
            per_tier=repr(chunk.stats.per_tier))
    return out


# ---- the Solver on a slab mesh (tests/test_torch_mesh_solver.py) -----

#: the Solver cases' grid (the bench problem), the dense tier's, and
#: their steps
N_SOLVER = 32
N_DENSE = 16
SOLVER_STEPS = 4
ADAPT_ACCEPTS = 6
#: noise every step of dt=1 (tests/test_torch_host_solver.py's NOISE)
NOISE_PARAMS = ["variance_rate=1e-4", "variance_timing_function=t",
                "conserve_worms=True"]
#: a CFL factor that clamps h from the third step of the smooth start
CFL_SAFETY_SOLVER = 1e-5
CFL_PARAMS = ["CFL_safety_factor=%g" % CFL_SAFETY_SOLVER]


def solver_problem(n, extra=()):
    """The bench problem at n^2 with parameter lines ``extra``."""
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.tools.problems import bench_clargs

    clargs = bench_clargs(n)
    clargs.params = list(clargs.params) + list(extra)
    return problem_from_clargs(clargs, n, n, device="cpu")


def solver_run(ops, numerics, u0, mesh=None, fail_first=False, **kw):
    """A Solver run from the global state u0 (numpy): on a mesh each
    rank passes its slab.  Returns the gathered final state, k, t, h,
    the failures, ``stats`` as a dict and the monitor records ``(k, t,
    h, CFL_maxh, sum(rho))``; ``fail_first`` makes the first step
    attempt's error norm non-finite (the GMRES fallback then retries
    it).  The test module runs the one-rank Solver through it too."""
    import torch

    from ksfd_tpu_torch.parallel import distribute
    from ksfd_tpu_torch.solvers import Solver

    s = Solver(ops, numerics, mesh=mesh, **kw)
    if fail_first:
        step = s.step_fn

        def failing(u, t, h):
            u1, e = step(u, t, h)
            failing.calls += 1
            return u1, e * math.nan if failing.calls == 1 else e
        failing.calls = 0
        s.step_fn = failing
    records = []
    s.add_monitor(lambda sv, k, t, u: records.append(
        (k, t, sv.h, sv.CFL_maxh, sv.count_worms(u))))
    u = torch.from_numpy(u0)
    if mesh is not None:
        u = distribute(u, ops.grid, mesh)[0]
    u = s.solve(u)
    if mesh is not None:
        u = mesh.gather(u)
    st = vars(s.stats)
    return dict(u=u.numpy(), k=s.k, t=s.t, h=s.h,
                failures=s.snes_failures, stats=repr(st), records=records,
                info=repr(s.build_info))


def solver_cases():
    """(label, extra parameters, NumericsOptions fields, Solver keywords,
    start, fail_first) of every Solver run that the mesh cases and the
    test module's one-rank runs share."""
    adapt = dict(t0=0.0, dt=H, tmax=1e9, rtol=1e-6, atol=0.01)
    fixed = dict(adapt, maxsteps=SOLVER_STEPS)
    return [
        ("block", (), dict(adapt_type="none", pc_dtype="float32"),
         dict(fixed, block_steps=2), "rough", False),
        ("adaptive", (), dict(pc_dtype="float32"),
         dict(adapt, maxsteps=ADAPT_ACCEPTS), "rough", False),
        ("device_loop", (), dict(pc_dtype="float32", device_loop=True),
         dict(adapt, maxsteps=ADAPT_ACCEPTS), "rough", False),
        ("noise", NOISE_PARAMS, dict(adapt_type="none", pc_dtype="float32"),
         dict(fixed, dt=1.0, maxsteps=3), "smooth", False),
        ("cfl", CFL_PARAMS, dict(pc_dtype="float32"),
         dict(adapt, dt=1.0, maxsteps=SOLVER_STEPS), "smooth", False),
        ("cfl_loop", CFL_PARAMS, dict(pc_dtype="float32",
                                      device_loop=True),
         dict(adapt, dt=1.0, maxsteps=SOLVER_STEPS), "smooth", False),
        ("fallback", (), dict(adapt_type="none", pc_dtype="float64"),
         dict(fixed, maxsteps=2), "rough", True),
    ]


def solver_start(kind, n):
    return (rough_state((n, n)) if kind == "rough"
            else initial_state((n, n)))


def case_mesh_solver(ctx):
    """Every run of ``solver_cases`` through the Solver on this rank's
    slab, with the torch.randn draws of the noise run recorded."""
    import torch

    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.parallel import grid_mesh

    out = {}
    for label, extra, nm, kw, start, fail in solver_cases():
        _, grid, ops = solver_problem(N_SOLVER, extra)
        mesh = grid_mesh(grid, shape=(ctx["n"], 1), device="cpu")
        draws = []
        randn = torch.randn

        def recorded(*a, **k):
            x = randn(*a, **k)
            draws.append(x.numpy().copy())
            return x
        torch.randn = recorded
        try:
            out[label] = solver_run(ops, NumericsOptions(**nm),
                                    solver_start(start, N_SOLVER),
                                    mesh=mesh, fail_first=fail, **kw)
        finally:
            torch.randn = randn
        out[label]["draws"] = draws
    return out


def mesh_steps():
    """(label, n, NumericsOptions fields) of the single steps that the
    mesh cases and the test module's one-rank steps share: the GMRES
    tiers, the unfused step and the exact tiers."""
    return [
        ("gmres_scipy", N_SOLVER, dict(ksp_type="gmres_scipy",
                                       ksp_restart=12, ksp_max_it=4,
                                       stage_delta=False,
                                       pc_dtype="float64")),
        ("gmres", N_SOLVER, dict(ksp_type="gmres", pc_dtype="float64")),
        ("gmres_restarted", N_SOLVER, dict(ksp_type="gmres_restarted",
                                           pc_dtype="float64")),
        ("gmres_rolled", N_SOLVER, dict(ksp_type="gmres_rolled",
                                        ksp_restart=8, ksp_max_it=2,
                                        sweep_dtype="float64",
                                        pc_dtype="float64")),
        ("gmres_rolled_mixed", N_SOLVER, dict(ksp_type="gmres_rolled",
                                              ksp_restart=8, ksp_max_it=2,
                                              pc_dtype="float32")),
        ("unfused", N_SOLVER, dict(use_pallas=False, pc_dtype="float32")),
        ("unfused_f64", N_SOLVER, dict(use_pallas=False,
                                       sweep_dtype="float64",
                                       pc_dtype="float64")),
        ("lu", N_SOLVER, dict(ksp_type="lu")),
        ("dense", N_DENSE, dict(ksp_type="dense")),
    ]


def mesh_step(ops, nm, n, mesh=None):
    """One step of ``nm`` from the groomed rough state at h=H: the
    (gathered) state, enorm and build info."""
    import torch

    from ksfd_tpu_torch.parallel import distribute
    from ksfd_tpu_torch.solvers import make_step_fn

    step, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6, mesh=mesh)
    u0 = ops.groom(torch.from_numpy(rough_state((n, n))))
    if mesh is not None:
        u0 = distribute(u0, ops.grid, mesh)[0]
    u1, e = step(u0, torch.zeros((), dtype=torch.float64),
                 torch.full((), H, dtype=torch.float64))
    if mesh is not None:
        u1 = mesh.gather(u1)
    return dict(u=u1.numpy(), enorm=float(e), info=repr(step.build_info))


def case_mesh_steps(ctx):
    """Every step of ``mesh_steps`` on this rank's slab."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.parallel import grid_mesh

    out = {}
    for label, n, nm in mesh_steps():
        _, grid, ops = solver_problem(n)
        out[label] = mesh_step(ops, NumericsOptions(**nm), n,
                               mesh=grid_mesh(grid, shape=(ctx["n"], 1),
                                              device="cpu"))
    _, grid, ops = solver_problem(N_SOLVER)
    out["y_split"] = mesh_step(
        ops, NumericsOptions(**{s[0]: s[2] for s in mesh_steps()}[
            "unfused"]), N_SOLVER,
        mesh=grid_mesh(grid, shape=(1, ctx["n"]), device="cpu"))
    return out


# ---- the pc forms, 1D, the flux form, with-G and ensembles on a mesh
# (tests/test_torch_mesh_forms.py) ------------------------------------

#: the forms cases' 2D grid and 1D extent
N_FORMS = 32
N_1D = 128
FORM_STEPS_H = H


def forms_problem(kind, n=N_FORMS):
    """(ps, grid, ops) of a forms case: ``bench`` (the bench problem at
    n^2), ``flux`` (its flux form), ``with_g`` (with its G slot),
    ``eigen1d`` (examples/eigenmode1d, options92, at N_1D) or
    ``validate1d`` (options93's manufactured problem at N_1D, with its
    rho source)."""
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.tools.problems import (
        bench_clargs, example_params, make_clargs)

    if kind == "validate1d":
        from ksfd_tpu_torch.tools import validate

        return validate.make_problem(N_1D, device="cpu")
    if kind == "eigen1d":
        return problem_from_clargs(
            make_clargs(params=example_params("eigenmode1d")
                        + ["nelements=%d" % N_1D]), N_1D, device="cpu")
    return problem_from_clargs(bench_clargs(n), n, n, device="cpu",
                               flux_form=kind == "flux",
                               with_g=kind == "with_g")


def forms_start(kind, grid):
    """The start of a forms case: the rough state in 2D (a zero G slot
    under with-G, filled by the first refresh), the eigenmode (options92)
    or options93's exact state at t=0 in 1D."""
    if kind == "validate1d":
        from ksfd_tpu_torch.tools import validate

        return validate.exact_state(grid, 0.0)
    if kind == "eigen1d":
        x = np.arange(N_1D) / N_1D
        w = np.sin(2 * np.pi * (0.25 + 4.0 * x))
        return np.stack([9000.0 + w, 9000.0 + 0.6846227279629311 * w,
                         9000.0 + 0.088562372925828 * w])
    u = rough_state((N_FORMS, N_FORMS))
    if kind == "with_g":
        u = np.concatenate([u, np.zeros((1, N_FORMS, N_FORMS))])
    return u


def form_steps():
    """(label, problem kind, NumericsOptions fields) of the single steps
    of the forms cases: the spectral and no pc, the FFT pc, the flux
    form and with-G states; ``_f64`` ones on float64 sweeps and pc."""
    f64 = dict(sweep_dtype="float64", pc_dtype="float64")
    return [
        ("spectral", "bench", dict(pc_type="spectral", pc_dtype="float32")),
        ("spectral_f64", "bench", dict(pc_type="spectral", **f64)),
        ("spectral_bf16", "bench", dict(pc_type="spectral",
                                        pc_dtype="bfloat16")),
        ("block_bf16", "bench", dict(pc_dtype="bfloat16")),
        ("none_richardson", "bench", dict(pc_type="none")),
        ("none_chebyshev", "bench", dict(pc_type="none",
                                         ksp_type="chebyshev")),
        ("none_gmres", "bench", dict(pc_type="none", ksp_type="gmres")),
        ("fft_block", "bench", dict(pc_fft="on")),
        ("fft_spectral", "bench", dict(pc_fft="on", pc_type="spectral")),
        ("flux", "flux", dict(pc_dtype="float32")),
        ("flux_f64", "flux", f64),
        ("with_g", "with_g", dict(pc_dtype="float32")),
        ("with_g_f64", "with_g", f64),
    ]


def form_step(label, mesh=None):
    """One step of ``form_steps``'s ``label`` at h=H from its start
    (groomed; a with-G state refreshed): the (gathered) state, enorm
    and build info."""
    import torch

    from ksfd_tpu_torch import NumericsOptions

    _, kind, nm = {s[0]: s for s in form_steps()}[label]
    _, grid, ops = forms_problem(kind)
    u0 = ops.groom(torch.from_numpy(forms_start(kind, grid)))
    if hasattr(ops, "refresh_G"):
        u0 = ops.refresh_G(u0, 0.0)
    return mesh_step_from(ops, NumericsOptions(**nm), u0, mesh)


def mesh_step_from(ops, nm, u0, mesh=None):
    """One step of ``nm`` at h=H from the global state u0 (a tensor):
    the (gathered) state, enorm and build info."""
    import torch

    from ksfd_tpu_torch.parallel import distribute
    from ksfd_tpu_torch.solvers import make_step_fn

    step, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6, mesh=mesh)
    if mesh is not None:
        u0 = distribute(u0, ops.grid, mesh)[0]
    u1, e = step(u0, torch.zeros((), dtype=torch.float64),
                 torch.full((), H, dtype=torch.float64))
    if mesh is not None:
        u1 = mesh.gather(u1)
    return dict(u=u1.numpy(), enorm=float(e), info=repr(step.build_info))


def form_solvers():
    """(label, problem kind, NumericsOptions fields, Solver keywords) of
    the Solver runs of the forms cases: 1D meshes (options92 adaptive,
    options93 fixed dt with its source), the flux form and with-G
    states."""
    adapt = dict(t0=0.0, tmax=1e9, rtol=1e-6, atol=0.01)
    return [
        ("eigen1d", "eigen1d", dict(), dict(adapt, dt=1.0, maxsteps=6)),
        ("validate1d", "validate1d", dict(adapt_type="none",
                                          pc_dtype="float64"),
         dict(adapt, dt=1.0, maxsteps=4)),
        ("flux_solver", "flux", dict(pc_dtype="float32"),
         dict(adapt, dt=H, maxsteps=4)),
        ("with_g_solver", "with_g", dict(adapt_type="none",
                                         pc_dtype="float32"),
         dict(adapt, dt=H, maxsteps=3, block_steps=1)),
    ]


def form_solver(label, mesh=None):
    """The Solver run of ``form_solvers``'s ``label`` (solver_run)."""
    from ksfd_tpu_torch import NumericsOptions

    _, kind, nm, kw = {s[0]: s for s in form_solvers()}[label]
    _, grid, ops = forms_problem(kind)
    return solver_run(ops, NumericsOptions(**nm), forms_start(kind, grid),
                      mesh=mesh, **kw)


#: the ensembles' members
N_MEMBERS = 2


def form_ensembles():
    """(label, NumericsOptions fields, EnsembleSolver keywords, extra
    parameters) of the ensemble runs on the bench problem at N_FORMS:
    per step (adaptive), the device loop, and fixed-dt noise."""
    adapt = dict(t0=0.0, tmax=1e9, rtol=1e-6, atol=0.01)
    return [
        ("ens_step", dict(pc_dtype="float32"), dict(adapt, dt=H,
                                                    maxsteps=4), ()),
        ("ens_loop", dict(pc_dtype="float32", device_loop=True),
         dict(adapt, dt=H, maxsteps=4), ()),
        ("ens_noise", dict(adapt_type="none", pc_dtype="float32"),
         dict(adapt, dt=1.0, maxsteps=2, rng_key=7), NOISE_PARAMS),
    ]


def ensemble_start():
    """Member i: the rough state of seed i."""
    return np.stack([rough_state((N_FORMS, N_FORMS), seed=i)
                     for i in range(N_MEMBERS)])


def form_ensemble(label, mesh=None, **change):
    """The EnsembleSolver run of ``form_ensembles``'s ``label`` (its
    numerics with ``change``): per member the (gathered) state, k, t, h,
    failures, and the run's device-loop totals; the noise draws
    recorded."""
    import torch

    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.solvers import EnsembleSolver

    _, nm, kw, extra = {s[0]: s for s in form_ensembles()}[label]
    _, grid, ops = solver_problem(N_FORMS, extra)
    es = EnsembleSolver(ops, NumericsOptions(**dict(nm, **change)),
                        mesh=mesh, **kw)
    U = torch.from_numpy(ensemble_start())
    if mesh is not None:
        U = mesh.local(U, first=2).contiguous()
    draws = []
    randn = torch.randn

    def recorded(*a, **k):
        x = randn(*a, **k)
        draws.append(x.numpy().copy())
        return x
    torch.randn = recorded
    try:
        out = es.solve(U)
    finally:
        torch.randn = randn
    u = out.u if mesh is None else torch.stack(
        [mesh.gather(m) for m in out.u])
    totals = None if es._chunk is None else vars(es._chunk.totals)
    return dict(u=u.numpy(), k=out.k.tolist(), t=out.t.tolist(),
                h=out.h.tolist(), failures=out.snes_failures.tolist(),
                totals=repr(totals), info=repr(es.build_info), draws=draws)


def case_mesh_forms(ctx):
    """Every step, Solver run and ensemble of the forms cases on this
    rank's block (``grid_mesh``'s own split: an x split of these grids)."""
    from ksfd_tpu_torch.parallel import grid_mesh

    out = {}
    for label, kind, _ in form_steps():
        grid = forms_problem(kind)[1]
        out[label] = form_step(label, grid_mesh(grid, device="cpu"))
    for label, kind, _, _ in form_solvers():
        grid = forms_problem(kind)[1]
        out[label] = form_solver(label, grid_mesh(grid, device="cpu"))
    for label, *_ in form_ensembles():
        _, grid, _ = solver_problem(N_FORMS)
        out[label] = form_ensemble(label, grid_mesh(grid, device="cpu"))
    return out


# ---- y and z splits (tests/test_torch_mesh_splits.py) ----------------

#: the split cases' grids
N_SPLIT = 32
N_SPLIT3 = 16


def split_shapes(n):
    """The 2D and 3D mesh shapes of the split cases over n ranks: the
    y split (1, n) and, on 4, also (2, 2); in 3D (1, 1, 2) and
    (1, 2, 2)."""
    two = [(1, n)] + ([(2, 2)] if n == 4 else [])
    return two, [(1, 1, 2) if n == 2 else (1, 2, 2)]


def split_steps():
    """(label, NumericsOptions fields) of the split cases' steps from the
    rough bench state at N_SPLIT^2: the mixed path (float32 sweeps and
    block pc), float64 sweeps and pc, the fast mode and fixed-count
    GMRES."""
    return [
        ("mixed", dict(pc_dtype="float32")),
        ("f64", dict(sweep_dtype="float64", pc_dtype="float64")),
        ("fast32", dict(precision="float32", pc_dtype="float32")),
        ("gmres", dict(ksp_type="gmres", pc_dtype="float64")),
    ]


def split3_problem():
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.tools.problems import make_clargs

    return problem_from_clargs(
        make_clargs(params=aggregation3d_params(N_SPLIT3)), N_SPLIT3,
        N_SPLIT3, N_SPLIT3, device="cpu")


def split3_step(mesh=None):
    """One mixed step of H3 on aggregation3d at N_SPLIT3^3 from the
    rough state."""
    import torch

    from ksfd_tpu_torch import NumericsOptions

    _, _, ops = split3_problem()
    u0 = ops.groom(torch.from_numpy(rough_state((N_SPLIT3,) * 3)))
    out = mesh_step_from(ops, NumericsOptions(pc_dtype="float32"), u0,
                         mesh)
    return out


def case_split_layout(ctx):
    """On each 2D split shape: distribute / gather / process_box /
    global_from_local / owned_box and the halo rows along y."""
    import torch

    from ksfd_tpu_torch.parallel import (
        distribute, global_from_local, grid_mesh, owned_box, process_box)
    from ksfd_tpu_torch.parallel.mesh import halo_rows, state_sharding

    n = N_SPLIT
    _, grid, ops = bench_problem(n)
    u = rough_state((n, n), seed=3)
    out = {}
    for shape in split_shapes(ctx["n"])[0]:
        mesh = grid_mesh(grid, shape=shape, device="cpu")
        u_loc = distribute(u, grid, mesh)[0]
        lo, hi = halo_rows(u_loc, ops.sw, mesh, axis=1)
        out[shape] = dict(
            slab=u_loc.numpy(), box=owned_box(u_loc, mesh),
            pbox=process_box(grid, mesh), coords=mesh.coords,
            from_full=bool(torch.equal(global_from_local(u, grid, mesh),
                                       u_loc)),
            gathered=mesh.gather(u_loc).numpy(), lo=lo.numpy(),
            hi=hi.numpy(), contiguous=lo.is_contiguous(),
            spec=state_sharding(mesh),
            padded=mesh.pad(u_loc, ops.sw).numpy())
    return out


def case_split_steps(ctx):
    """Every step of ``split_steps`` on each 2D split shape, the 3D step
    on the 3D shape, and the Solver's adaptive loop and device loop
    (solver_cases) on the first 2D shape."""
    import torch

    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.parallel import grid_mesh

    out = {}
    shapes2, shapes3 = split_shapes(ctx["n"])
    _, grid, ops = solver_problem(N_SPLIT)
    u0 = ops.groom(torch.from_numpy(rough_state((N_SPLIT, N_SPLIT))))
    for shape in shapes2:
        mesh = grid_mesh(grid, shape=shape, device="cpu")
        for label, nm in split_steps():
            out[(shape, label)] = mesh_step_from(ops, NumericsOptions(**nm),
                                                 u0, mesh)
    cases = {c[0]: c for c in solver_cases()}
    for label in ("adaptive", "device_loop"):
        _, extra, nm, kw, start, fail = cases[label]
        mesh = grid_mesh(grid, shape=shapes2[0], device="cpu")
        out[label] = solver_run(ops, NumericsOptions(**nm),
                                solver_start(start, N_SOLVER), mesh=mesh,
                                fail_first=fail, **kw)
    grid3 = split3_problem()[1]
    out["3d"] = split3_step(grid_mesh(grid3, shape=shapes3[0],
                                      device="cpu"))
    try:
        grid_mesh(grid, shape=(ctx["n"] // 2, 1), device="cpu")
        out["idle"] = "no error"
    except ValueError as e:
        out["idle"] = str(e)
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _rank_main(n, rank, store, cases, queue):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=n)
        ctx = dict(rank=rank, n=n)
        out = {name: CASES[name](ctx) for name in cases}
        dist.barrier()
        dist.destroy_process_group()
        queue.put((n, rank, out, None))
    except BaseException:
        queue.put((n, rank, None, traceback.format_exc()))
        raise


def start_ranks(groups):
    """Spawn one gloo group per ``{n: cases}`` entry, all at once: n
    ranks that run ``cases`` (names of CASES).  Returns a handle for
    ``collect``; the caller may work meanwhile (the test modules run the
    reference while the ranks run)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = []
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for n, cases in groups.items():
            store = os.path.join(tempfile.mkdtemp(prefix="ksfd_ranks_"),
                                 "store")
            procs += [ctx.Process(target=_rank_main,
                                  args=(n, r, store, list(cases), queue))
                      for r in range(n)]
        for p in procs:
            p.start()
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    return dict(groups=list(groups), procs=procs, queue=queue)


def collect(handle, timeout=600):
    """``{n: {rank: {case: result}}}`` of ``start_ranks``'s groups; a
    rank that failed fails the call with its traceback."""
    procs, queue = handle["procs"], handle["queue"]
    results = {n: {} for n in handle["groups"]}
    errors = []
    try:
        for _ in procs:
            n, rank, out, err = queue.get(timeout=timeout)
            if err is not None:
                errors.append("group of %d, rank %d:\n%s" % (n, rank, err))
                break
            results[n][rank] = out
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join(5)
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


def run_ranks(groups, timeout=600):
    """``collect(start_ranks(groups))``: ``{n: {rank: {case:
    result}}}``."""
    return collect(start_ranks(groups), timeout=timeout)
