"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

It builds the CUDA stencil kernels of ksfd_tpu_torch from the sources
in the checkout (csrc/stencil2d.cu and csrc/stencil3d.cu, one nvcc per
problem header, all started together) and runs ten phases, each
printing one line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, the float32 matmul precision and the kernels' builds;
2. each 2D kernel against its plain PyTorch version on the card at
   1024^2 x 3 f32, with CUDA-event times of both;
3. the 2D main path at 1024^2 x 3 f64: ``make_multistep_fn`` with
   default numerics, chained fixed-dt steps at h=1 (2 and 10 steps),
   with exact launch counts, a finite state and embedded error, and the
   slope-timed ms/step and DOF-updates/s;
4. the same slice at 256^2 x 3 on the card and on the CPU (plain
   versions) from one numpy state, agreeing to 1e-5 of the summed
   increment;
5. each 3D kernel against its plain version on the card at 256^3 x 3
   f32 (the aggregation3d problem) and at the odd size 40 x 36 x 20,
   with CUDA-event times at 256^3;
6. the 3D main path at 256^3 x 3 f64 (50.3M DOF), as phase 3;
7. the 3D slice at 64^3 x 3 (examples/aggregation3d's size) on the card
   and on the CPU, as phase 4;
8. the float32 fast mode's rhs kernels against their plain versions:
   B7 at 1024^2 x 3, B6a at 256^3 x 3 and at 40 x 36 x 20 x 3, with
   CUDA-event times of both;
9. the fast mode's main path (``NumericsOptions(precision="float32")``)
   at 1024^2 x 3 and at 256^3 x 3, as phases 3 and 6;
10. the fast mode on the card and on the CPU at 256^2 x 3 and 64^3 x 3,
    agreeing to 1e-4 of the summed increment plus 4 float32 ulps of the
    state.

Then one JSON line of the eight kernels and, last, the result line.  Any
failed phase raises, so the exit code is not 0 and no result prints.
It imports nothing of JAX.  Profiles and long reports go to
chiprun_out/.
"""

import ctypes
import json
from argparse import Namespace
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
N_BIG = 1024
N_CMP = 256
N3_BIG = 256
N3_CMP = 64
ODD3 = (40, 36, 20)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores, same sheet


def check(cond, what):
    if not cond:
        raise RuntimeError("check failed: " + what)


def card_line():
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def make_clargs(params=(), source=(), cappotential="tophat",
                seed=793817931, **kw):
    """A Namespace shaped like ksfdsolver.py's parsed command line (the
    port's copy of the reference's test helper of that name)."""
    ns = Namespace(
        cappotential=cappotential, save=None, check=None, resume=None,
        restart=None, series_retries=0, series_retry_interval=60,
        mpiok=False, showparams=False, noperiodic=False, onestep=False,
        solver="tpu", seed=seed, source=list(source), params=list(params),
        numerics=[], petsc=[],
    )
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


#: Parameters of the two-ligand-group problem of the reference's
#: convergence tests (options92 / options93nx128dt1), the base of the
#: 2D bench problem.
OPTIONS92_PARAMS = [
    "dt=1", "tmax=200000", "maxsteps=10000", "width=1", "nelements=128",
    "dim=1", "degree=3", "atol=0.01", "rtol=1e-6", "rhomin=1e-7",
    "rhomax=28000", "cushion=2000", "sigma=0.02357", "s2=sigma**2/2",
    "Nworms=0", "rho0=murho + arho*sin(2*pi*(0.25+k0*x))",
    "U0_1_1=murho + arho*aUa*sin(2*pi*(0.25+k0*x))",
    "U0_2_1=murho + arho*aUr*sin(2*pi*(0.25+k0*x))",
    "murho=9000.0", "arho=1.0", "aUa=0.6846227279629311",
    "aUr=0.088562372925828", "lamda=0.003974930217658144", "k0=4.0",
    "srho0=0", "ngroups=2", "nligands_1=1", "alpha_1=1500",
    "beta_1=5.56e-4", "s_1_1=0.01", "gamma_1_1=0.01", "D_1_1=1e-6",
    "nligands_2=1", "alpha_2=1500", "beta_2=-5.56e-4", "s_2_1=0.001",
    "gamma_2_1=0.001", "D_2_1=1e-5",
]


def bench_clargs(n):
    """The options84-class bench problem on an n x n grid: the
    parameters of __graft_entry__._make_problem."""
    params = [
        p for p in OPTIONS92_PARAMS
        if p.split("=", 1)[0]
        not in ("nelements", "dim", "rho0", "U0_1_1", "U0_2_1")
    ] + [
        "nelements=%d" % n, "nwidth=%d" % n, "nheight=%d" % n, "dim=2",
        "height=1", "rho0=murho + arho*sin(2*pi*(x+y))", "U0_1_1=",
        "U0_2_1=",
    ]
    return make_clargs(params=params)


def agg3d_clargs(n):
    """The parameters of examples/aggregation3d (rho plus an attractant
    and a repellent ligand group, degree 3, periodic unit cube) with
    nelements=n."""
    params = []
    with open(os.path.join(ROOT, "examples", "aggregation3d")) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("--petsc"):
                break
            if line and not line.startswith(("#", "--", "nelements=")):
                params.append(line)
    return make_clargs(params=params + ["nelements=%d" % n])


def initial_state(grid):
    """Port of __graft_entry__._initial_state, near-uniform ~9000, in
    any dimension: 9000 + (1, 0.7, 0.1) * sin(2 pi (x + y [+ z]))."""
    axes = [np.arange(n) / n for n in grid.Sshape]
    s = np.sin(2 * np.pi * sum(np.meshgrid(*axes, indexing="ij")))
    return np.stack([9000.0 + s, 9000.0 + 0.7 * s, 9000.0 + 0.1 * s])


def ligand_ratios(ps):
    """s/gamma of each ligand: the ligands' equilibrium per unit rho."""
    out = []
    for lig in ps.Vgroups.ligands():
        suffix = lig.name()[1:]
        sval = float(ps.values0.get("s" + suffix, lig.s))
        gval = float(ps.values0.get("gamma" + suffix, lig.gamma))
        out.append(sval / gval)
    return out


def rough_state(grid, ps):
    """Port of bench.py _rough_state (numpy seed 1234): capped peaks
    over a depleted background, ligands at s/gamma * rho."""
    rhomax = float(ps.values0.get("rhomax", 28000.0))
    nx, ny = int(grid.nx), int(grid.ny)
    X, Y = np.meshgrid(np.arange(nx) / nx, np.arange(ny) / ny,
                       indexing="ij")
    rng = np.random.default_rng(1234)
    rho = np.full((nx, ny), 300.0)
    w = 10.0 / nx
    for cx, cy in rng.random((max(48, (nx * ny) // 8192), 2)):
        dx = np.minimum(np.abs(X - cx), 1.0 - np.abs(X - cx))
        dy = np.minimum(np.abs(Y - cy), 1.0 - np.abs(Y - cy))
        rho += 0.95 * rhomax * np.exp(-(dx**2 + dy**2) / (2 * w * w))
    rho = np.minimum(rho, 0.93 * rhomax)
    return np.stack([rho] + [rho * r for r in ligand_ratios(ps)])


def rough_state_3d(grid, ps, device, seed=1234):
    """The 3D counterpart of rough_state, made on ``device``: capped
    Gaussian peaks (sigma 4 cells along x, centres from a numpy seed,
    one per 16384 points and at least 16, about an eighth of the box)
    over a depleted background of 300, ligands at s/gamma * rho."""
    rhomax = float(ps.values0.get("rhomax", 28000.0))
    shape = tuple(grid.Sshape)
    rng = np.random.default_rng(seed)
    w = 4.0 / shape[0]
    coords = [torch.arange(n, dtype=torch.float64, device=device) / n
              for n in shape]
    rho = torch.full(shape, 300.0, dtype=torch.float64, device=device)
    for centre in rng.random((max(16, int(np.prod(shape)) // 16384), 3)):
        g = []
        for ax, c in zip(coords, centre):
            d = torch.abs(ax - float(c))
            d = torch.minimum(d, 1.0 - d)
            g.append(torch.exp(-d * d / (2 * w * w)))
        rho += (0.95 * rhomax) * (g[0][:, None, None] * g[1][None, :, None]
                                  * g[2][None, None, :])
    rho = torch.clamp(rho, max=0.93 * rhomax)
    return torch.stack([rho] + [rho * r for r in ligand_ratios(ps)])


def cuda_ms(fn, reps):
    """Mean ms of fn() over reps back-to-back calls (CUDA events),
    after two warmup calls."""
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# operands read per kernel (the output is written once besides)
_N_IN = dict(rhs=1, jvp=2, resid=3, delta=3)


def point_ops(name, build):
    """Arithmetic operations per grid point that the kernel's function
    needs: the pointwise G and dG (or G_delta) once per point, sympy's
    count of their operations with a transcendental counted as one, and
    the star stencils of the rows as multiply-adds."""
    import sympy as sy

    ops, dim, sw, nl = build.ops, build.dim, build.ops.sw, build.ops.nligands
    d1 = 2 * (2 * sw) - 1          # first derivative: 2*sw taps
    d2 = 2 * (2 * sw + 1) - 1      # second derivative: 2*sw+1 taps
    graddot = dim * (2 * d1 + 1) + dim - 1
    lap = dim * d2 + dim - 1
    if name == "rhs":
        # G and the dof + 1 centrings once per point; rho_c.Gc and
        # rho*lap(Gc); per ligand its lap and 6 multiply-adds
        return (int(sy.count_ops(ops.G_expr)) + nl + 2 + graddot + lap + 2
                + nl * (lap + 6))
    rows = 2 * graddot + 2 * lap + 5 + nl * (lap + 5)
    if name == "delta":
        pointwise = int(sy.count_ops(ops.G_expr)) + int(
            sy.count_ops(ops.G_delta_expr)) + 4
    else:
        pointwise = int(sy.count_ops(ops.G_expr)) + sum(
            int(sy.count_ops(e)) for e in ops.dG_exprs) + 2 * (nl + 1)
    return pointwise + rows + (3 * (nl + 1) if name == "resid" else 0)


def kernel_bound(name, build):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (each operand read once, the output written once) over the
    card's memory rate and its operations over the f32 rate."""
    points = int(np.prod(build.Sshape))
    nbytes = (_N_IN[name] + 1) * build.dof * points * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = points * point_ops(name, build) / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    # the preconditioner's float32 GEMMs run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("phase 1 device: %s | torch %s cuda %s | %s x%d | "
          "matmul.allow_tf32=%s" % (
              card, torch.__version__, torch.version.cuda,
              torch.cuda.get_device_name(0), torch.cuda.device_count(),
              torch.backends.cuda.matmul.allow_tf32))
    return card


# the kernels' mangled names, as ptxas reports them
_PTXAS_NAMES = (("rhs_kernel", "rhs"), ("jvp_kernelILb0", "jvp"),
                ("jvp_kernelILb1", "resid"), ("delta_kernel", "delta"))


def ptxas_summary(log):
    """Registers, spills and static shared memory per kernel from an
    ``nvcc -Xptxas -v`` log."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((n for m, n in _PTXAS_NAMES if m in line), line)
        elif "spill stores" in line and name:
            spills = line.strip().split(",")[1:]
            out.append([name, ",".join(spills).strip()])
        elif "Used" in line and "registers" in line and out:
            out[-1].append(line.split(":", 1)[1].strip())
    return "; ".join(" ".join(x) for x in out)


def phase_build():
    """Build every kernel library the phases use, one nvcc per problem
    header (the stencil coefficients depend on the grid spacing), all
    started together."""
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels

    configs = [
        ("2d %d^2" % N_BIG, bench_clargs(N_BIG), (N_BIG, N_BIG)),
        ("2d %d^2" % N_CMP, bench_clargs(N_CMP), (N_CMP, N_CMP)),
        ("3d %d^3" % N3_BIG, agg3d_clargs(N3_BIG), (N3_BIG,) * 3),
        ("3d %dx%dx%d" % ODD3, agg3d_clargs(ODD3[0]), ODD3),
        ("3d %d^3" % N3_CMP, agg3d_clargs(N3_CMP), (N3_CMP,) * 3),
    ]
    builds = []
    for label, clargs, shape in configs:
        # the header depends on the problem only, not on the device
        _, _, ops = problem_from_clargs(clargs, *shape, device="cpu")
        builds.append((label, make_fused_kernels(ops).build))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda lb: lb[1].library(), builds))
    wall = time.perf_counter() - t0
    reports = ["%s: %s" % (label, ptxas_summary(b.build_info["ptxas"]))
               for label, b in builds[::2]]  # 1024^2, 256^3, 64^3
    smem3d = []
    for fn in ("ksfd_smem_bytes", "ksfd_smem_bytes_rhs"):
        smem_fn = getattr(builds[2][1].library(), fn)
        smem_fn.argtypes, smem_fn.restype = [], ctypes.c_int
        smem3d.append(smem_fn())
    print("phase 1 build: %d libraries in %.2f s wall (nvcc s: %s) | 3D "
          "dynamic shared memory %d B/block (rhs %d B) | %s" % (
              len(builds), wall,
              ", ".join("%s %.2f" % (l, b.build_info["nvcc_seconds"])
                        for l, b in builds),
              smem3d[0], smem3d[1], " | ".join(reports)))


def clamped(u_raw, ops):
    """A copy of a raw f64 state with points below, at and NaN against
    the floors: the kernels' where-form clamp and strict tangent mask."""
    dim = ops.grid.dim
    raw = u_raw.clone()
    raw[(0,) + tuple(slice(None, None, p)
                     for p in (97, 89, 7)[:dim])] = 0.5 * ops.rhomin
    raw[(0, 3, 5, 1)[:dim + 1]] = ops.rhomin
    raw[(1, 5, 7, 2)[:dim + 1]] = ops.Umin
    raw[(2, 9, 11, 3)[:dim + 1]] = float("nan")
    return raw


def kernel_cases(kern, ops, states, gen):
    """(name, label, args) for each kernel on each state (f64 tensors on
    the card): jvp and resid on the groomed f32 state and, for the rough
    one, on a raw state with points below, at and NaN against the
    floors; delta with increments of scale 100 (rough) or 1e-3
    (near-uniform) and with a fifth of the points clamped to the
    floor."""
    shape = tuple(ops.grid.Vshape)
    t = torch.zeros((), dtype=torch.float64, device="cuda")
    shift = torch.full((), 1.0 / 0.435866521508459, dtype=torch.float64,
                       device="cuda")
    randn = lambda: torch.randn(shape, generator=gen, device="cuda",
                                dtype=torch.float64)
    cases = []
    for sname, u_raw in states.items():
        u64 = ops.groom(u_raw)
        u = u64.float()
        v, b = randn().float(), randn().float()
        cases.append(("jvp", sname, (u, v, t)))
        cases.append(("resid", sname, (u, v, b, t, shift)))
        if sname.startswith("rough"):
            uc = clamped(u_raw, ops).float()
            cases.append(("jvp", sname + "/clamped", (uc, v, t)))
            cases.append(("resid", sname + "/clamped", (uc, v, b, t, shift)))
        dname, scale = (("d100", 100.0) if sname.startswith("rough")
                        else ("d1e-3", 1e-3))
        u1 = ops.groom(u64 + scale * randn())
        cases.append(("delta", sname + "/" + dname, (u64, u1 - u64, u1, t)))
        # clamp-to-floor: a fifth of the points fall to the floor
        drop = (torch.rand(shape, generator=gen, device="cuda") < 0.2)
        u1 = ops.groom(u64 - 2.0 * u64 * drop)
        cases.append(("delta", sname + "/floor", (u64, u1 - u64, u1, t)))
    return cases


def rhs_cases(ops, states):
    """(name, label, args) of the rhs kernel on each state (f64 tensors
    on the card): the f32 state as the fast mode holds it and, for the
    rough one, a raw state with points below, at and NaN against the
    floors (the kernel grooms)."""
    t = torch.zeros((), dtype=torch.float32, device="cuda")
    cases = []
    for sname, u_raw in states.items():
        cases.append(("rhs", sname, (ops.groom(u_raw).float(), t)))
        if sname.startswith("rough"):
            cases.append(("rhs", sname + "/clamped",
                          (clamped(u_raw, ops).float(), t)))
    return cases


def compare_kernels(kern, cases, errs, rel, lines):
    """Each case's kernel against its plain version: finite, and within
    1e-5 of the plain version's largest value."""
    for name, label, args in cases:
        k = kern.kernels[name]
        out = k(*args)
        ref = k.plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        check(bool(torch.isfinite(out).all()), "%s %s finite" % (name, label))
        check(err <= 1e-5 * scale,
              "%s %s: max err %.3e > 1e-5 * %.3e" % (name, label, err, scale))
        errs[name] = max(errs.get(name, 0.0), err)
        rel[name] = max(rel.get(name, 0.0), err / scale)
        lines.append("%s/%s err %.3e (%.2e rel)" % (name, label, err,
                                                    err / scale))


def time_kernels(kern, cases, label, reps, plain_reps):
    """CUDA-event ms of each kernel and of its plain body on the same
    prepared f32 operands of the ``label`` state (the build is done)."""
    times = {}
    for name, lab, args in cases:
        if lab.split("/")[0] != label or lab.endswith(("clamped", "floor")):
            continue
        k = kern.kernels[name]
        prepared = k.prepare(*args)
        times[name] = (cuda_ms(lambda: k.launch(*prepared), reps),
                       cuda_ms(lambda: k.body(*prepared), plain_reps))
    return times


def phase_kernels(card):
    """Each 2D kernel against its plain version on the card, 1024^2 x 3."""
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels

    dev = torch.device("cuda")
    ps, grid, ops = problem_from_clargs(bench_clargs(N_BIG), N_BIG, N_BIG,
                                        device=dev)
    kern = make_fused_kernels(ops)
    gen = torch.Generator(device=dev).manual_seed(7)
    states = dict(rough=torch.as_tensor(rough_state(grid, ps), device=dev),
                  initial=torch.as_tensor(initial_state(grid), device=dev))
    cases = kernel_cases(kern, ops, states, gen)
    errs, rel, lines = {}, {}, []
    compare_kernels(kern, cases, errs, rel, lines)
    times = time_kernels(kern, cases, "rough", 200, 20)
    print("phase 2 kernels vs plain 1024^2x3 (%s): %s | ms kernel/plain: "
          "%s" % (card, "; ".join(lines), "; ".join(
              "%s %.4f/%.4f" % (n, a, b) for n, (a, b) in times.items())))
    return kern, errs, rel, times


def phase_kernels_3d(card):
    """Each 3D kernel against its plain version on the card at 256^3 x 3
    (rough and near-uniform states, timed on the rough one) and at the
    odd size ODD3, whose tiles are ragged in every axis."""
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    errs, rel, lines = {}, {}, []
    ps, grid, ops = problem_from_clargs(agg3d_clargs(N3_BIG), *(N3_BIG,) * 3,
                                        device=dev)
    kern = make_fused_kernels(ops)
    states = dict(rough=rough_state_3d(grid, ps, dev),
                  initial=torch.as_tensor(initial_state(grid), device=dev))
    cases = kernel_cases(kern, ops, states, gen)
    compare_kernels(kern, cases, errs, rel, lines)
    times = time_kernels(kern, cases, "rough", 200, 200)
    del cases, states
    ps, grid, ops = problem_from_clargs(agg3d_clargs(ODD3[0]), *ODD3,
                                        device=dev)
    kern_odd = make_fused_kernels(ops)
    states = dict(rough_odd=rough_state_3d(grid, ps, dev))
    compare_kernels(kern_odd, kernel_cases(kern_odd, ops, states, gen),
                    errs, rel, lines)
    print("phase 5 3D kernels vs plain 256^3x3 and %dx%dx%dx3 (%s): %s | "
          "ms kernel/plain at 256^3: %s" % (ODD3 + (card, "; ".join(lines),
          "; ".join("%s %.4f/%.4f" % (n, a, b)
                    for n, (a, b) in times.items()))))
    return kern, errs, rel, times


def phase_rhs_kernels(card):
    """The fast mode's rhs kernels against their plain versions on the
    card: B7 at 1024^2 x 3, B6a at 256^3 x 3 (rough, near-uniform and
    clamped states, timed on the rough one) and at the odd size ODD3."""
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels

    dev = torch.device("cuda")
    out = {}
    errs, rel, lines = {}, {}, []
    for key, clargs, shape, make_rough in (
        ("2d", bench_clargs(N_BIG), (N_BIG, N_BIG),
         lambda grid, ps: torch.as_tensor(rough_state(grid, ps), device=dev)),
        ("3d", agg3d_clargs(N3_BIG), (N3_BIG,) * 3,
         lambda grid, ps: rough_state_3d(grid, ps, dev)),
        ("3d odd", agg3d_clargs(ODD3[0]), ODD3,
         lambda grid, ps: rough_state_3d(grid, ps, dev)),
    ):
        ps, grid, ops = problem_from_clargs(clargs, *shape, device=dev)
        kern = make_fused_kernels(ops)
        states = dict(rough=make_rough(grid, ps))
        if key != "3d odd":
            states["initial"] = torch.as_tensor(initial_state(grid),
                                                device=dev)
        cases = rhs_cases(ops, states)
        e, r, l = {}, {}, []
        compare_kernels(kern, cases, e, r, l)
        lines.append("%s: %s" % (key, "; ".join(l)))
        if key == "3d odd":
            errs["3d"] = max(errs["3d"], e["rhs"])
            rel["3d"] = max(rel["3d"], r["rhs"])
            continue
        errs[key], rel[key] = e["rhs"], r["rhs"]
        out[key] = (kern, time_kernels(kern, cases, "rough", 200, 200))
        del cases, states
    print("phase 8 rhs kernels vs plain, B7 1024^2x3, B6a 256^3x3 and "
          "%dx%dx%dx3 (%s): %s | ms kernel/plain: 2d %.4f/%.4f; 3d "
          "%.4f/%.4f" % (ODD3 + (card, " | ".join(lines))
                         + out["2d"][1]["rhs"] + out["3d"][1]["rhs"]))
    return {key: (out[key][0], errs[key], rel[key], out[key][1]["rhs"])
            for key in ("2d", "3d")}


def phase_main_path(card, tag, clargs, shape, phase, fast32=False):
    """make_multistep_fn at ``shape`` x 3, default numerics (f64) or the
    float32 fast mode, fixed dt h=1, from the near-uniform initial state:
    exact launch counts of the 2- and 10-step chains (each counted from
    0 just before the chain), slope timing and a profiled 2-step
    chain."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels
    from ksfd_tpu_torch.solvers import make_multistep_fn

    dev = torch.device("cuda")
    ps, grid, ops = problem_from_clargs(clargs, *shape, device=dev)
    kern = make_fused_kernels(ops)
    numerics = NumericsOptions(precision="float32" if fast32 else "float64")
    per_step = (dict(rhs=4, jvp=8, resid=0, delta=0) if fast32
                else dict(rhs=0, jvp=0, resid=8, delta=4))
    multi, _ = make_multistep_fn(ops, numerics, atol=0.01,
                                 rtol=1e-6, static_steps=False,
                                 kernels=kern)
    u0 = torch.as_tensor(initial_state(grid), device=dev)
    t0 = torch.zeros((), dtype=torch.float64, device=dev)
    h = torch.full((), 1.0, dtype=torch.float64, device=dev)

    counts = {}
    for n in (2, 10):
        for k in kern.kernels.values():
            k.launches = 0
        u, t, emax = multi(u0, t0, h, n)
        torch.cuda.synchronize()
        counts[n] = {name: k.launches for name, k in kern.kernels.items()}
        check(counts[n] == {k: n * c for k, c in per_step.items()},
              "launch counts %s for %d steps" % (counts[n], n))
        check(u.dtype == (torch.float32 if fast32 else torch.float64),
              "state dtype %s" % u.dtype)
        check(bool(torch.isfinite(u).all()), "state finite")
        check(bool(torch.isfinite(emax)), "emax finite")
        # t accumulates in the state's precision
        check(abs(float(t) - n * float(h))
              <= (1e-6 if fast32 else 1e-9) * n * float(h), "t advanced")
    inc = float((u - u0).abs().max())
    del u

    # slope timing: min over repeats of the 2- and 10-step chains,
    # each from a distinctly perturbed state
    samples = {2: [], 10: []}
    for rep in range(3):
        for n in (2, 10):
            # a perturbation the state's precision keeps
            pert = (1e-6 if fast32 else 1e-9) * (1 + 2 * rep + (n == 10))
            up = u0 * (1.0 + pert) + pert
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            multi(up, t0, h, n)
            torch.cuda.synchronize()
            samples[n].append(time.perf_counter() - t_start)
            del up
    step_s = (min(samples[10]) - min(samples[2])) / 8
    rate = grid.n_dofs / step_s

    # where the time goes: a profiled 2-step chain
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        multi(u0, t0, h, 2)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    os.makedirs(OUT_DIR, exist_ok=True)
    prec = "f32" if fast32 else "f64"
    fname = "main_path_profile%s%s.txt" % ("" if len(shape) == 2 else "_3d",
                                           "_f32" if fast32 else "")
    with open(os.path.join(OUT_DIR, fname), "w") as fh:
        fh.write("%s\n2-step chain, %s x 3 %s, h=%g\n%s\n" % (
            card, tag, prec, float(h), table))
    # device time per step by kernel, and grouped
    cuda_dev = torch.autograd.DeviceType.CUDA
    per_kernel = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != cuda_dev:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = ev.self_cuda_time_total
        per_kernel[ev.key] = dt / 1e3 / 2  # ms per step
    groups = {"gemm": 0.0, "stencil kernels": 0.0, "other": 0.0}
    for key, ms in per_kernel.items():
        low = key.lower()
        if any(w in low for w in ("gemm", "xmma", "cutlass", "sm90")):
            groups["gemm"] += ms
        elif "ksfd" in low or any(
                w in low for w in ("rhs_kernel", "jvp_kernel",
                                   "delta_kernel")):
            groups["stencil kernels"] += ms
        else:
            groups["other"] += ms
    device_ms = sum(groups.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    print("phase %d main path %s x3 %s h=%g (%s): counts %s; emax %.6e; "
          "max|u10-u0| %.6e; %.4f ms/step (2-step %.4f s, 10-step %.4f s); "
          "%.6e DOF-updates/s | profiled device ms/step %.4f (busy %.3f of "
          "the step): %s | top: %s" % (
              phase, tag, prec, float(h), card, counts[10], float(emax), inc,
              step_s * 1e3,
              min(samples[2]), min(samples[10]), rate, device_ms,
              device_ms / (step_s * 1e3),
              "; ".join("%s %.4f" % kv for kv in groups.items()),
              "; ".join("%s %.4f" % (k[:48], v) for k, v in top)))
    return counts[10], step_s, rate


def phase_card_vs_cpu(card, tag, clargs, shape, make_state, phase,
                      fast32=False):
    """The slice at ``shape`` x 3 on the card (kernels) and on the CPU
    (plain versions) from one state made on the CPU: 4 chained steps at
    h=1e-4, agreeing to 1e-5 of the summed per-step increment (f64), or
    in the float32 fast mode to 1e-4 of it plus 4 float32 ulps of the
    state, which is float32 itself."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.solvers import make_multistep_fn

    numerics = NumericsOptions(precision="float32" if fast32 else "float64")
    runs = {}
    state = None
    for dev in ("cpu", "cuda"):
        ps, grid, ops = problem_from_clargs(clargs, *shape, device=dev)
        if state is None:
            state = torch.as_tensor(make_state(grid, ps))
        multi, _ = make_multistep_fn(ops, numerics, atol=0.01, rtol=1e-6)
        u0 = state.to(dev)
        t0 = torch.zeros((), dtype=torch.float64, device=dev)
        h = torch.full((), 1e-4, dtype=torch.float64, device=dev)
        u4, _, emax = multi(u0, t0, h, 4)
        runs[dev] = (u4.cpu(), float(emax))
        if dev == "cpu":
            # the summed per-step increment (one step per call)
            inc, u = 0.0, u0
            for k in range(4):
                un, _, _ = multi(u, t0 + k * h, h, 1)
                inc += float((un - ops.groom(u)).abs().max())
                u = un
    dev_abs = float((runs["cuda"][0] - runs["cpu"][0]).abs().max())
    check(np.isfinite(runs["cuda"][1]) and np.isfinite(runs["cpu"][1]),
          "emax finite")
    if fast32:
        ulps = 4 * 2.0 ** -23 * float(runs["cpu"][0].abs().max())
        tol = 1e-4 * inc + ulps
        terms = "1e-4*inc %.6e + 4 ulps of max|u| %.6e" % (1e-4 * inc, ulps)
    else:
        tol = 1e-5 * inc
        terms = "1e-5*inc %.6e" % tol
    check(dev_abs <= tol, "card vs cpu: %.3e > %s" % (dev_abs, terms))
    print("phase %d card vs cpu %s x3 %s rough h=1e-4 x4 (%s): max dev "
          "%.3e, summed increment %.6e, dev/inc %.3e, bound %.6e (%s); "
          "emax cuda %.6e cpu %.6e" % (
              phase, tag, "f32" if fast32 else "f64", card, dev_abs, inc,
              dev_abs / inc, tol, terms, runs["cuda"][1], runs["cpu"][1]))


def kernel_rows(kern, src, counts, errs, rel, times, suffix):
    """One row per kernel of ``kern``; counts maps each path ("f64",
    "f32") to the kernel launches of its 10-step chain."""
    rows = []
    for name, k in kern.kernels.items():
        bound_ms, bound_by = kernel_bound(name, kern.build)
        rows.append({
            "name": name + suffix, "route": "cuda", "source": src,
            "replaces": k.replaces,
            "launches": sum(c[name] for c in counts.values()),
            "launches_per_step": {p: c[name] // 10
                                  for p, c in counts.items()},
            "max_abs_err": errs[name], "max_rel_err": rel[name],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a fused stencil row
            "library_ms": None,
        })
    return rows


def main():
    card = phase_device()
    phase_build()
    kern, errs, rel, times = phase_kernels(card)
    counts, step_s, rate = phase_main_path(
        card, "%d^2" % N_BIG, bench_clargs(N_BIG), (N_BIG, N_BIG), 3)
    phase_card_vs_cpu(card, "%d^2" % N_CMP, bench_clargs(N_CMP),
                      (N_CMP, N_CMP), rough_state, 4)
    kern3, errs3, rel3, times3 = phase_kernels_3d(card)
    counts3, step3_s, rate3 = phase_main_path(
        card, "%d^3" % N3_BIG, agg3d_clargs(N3_BIG), (N3_BIG,) * 3, 6)
    phase_card_vs_cpu(card, "%d^3" % N3_CMP, agg3d_clargs(N3_CMP),
                      (N3_CMP,) * 3,
                      lambda grid, ps: rough_state_3d(grid, ps, "cpu"), 7)
    rhs = phase_rhs_kernels(card)
    counts32, step32_s, rate32 = phase_main_path(
        card, "%d^2" % N_BIG, bench_clargs(N_BIG), (N_BIG, N_BIG), 9,
        fast32=True)
    counts32_3, step32_3_s, rate32_3 = phase_main_path(
        card, "%d^3" % N3_BIG, agg3d_clargs(N3_BIG), (N3_BIG,) * 3, 9,
        fast32=True)
    phase_card_vs_cpu(card, "%d^2" % N_CMP, bench_clargs(N_CMP),
                      (N_CMP, N_CMP), rough_state, 10, fast32=True)
    phase_card_vs_cpu(card, "%d^3" % N3_CMP, agg3d_clargs(N3_CMP),
                      (N3_CMP,) * 3,
                      lambda grid, ps: rough_state_3d(grid, ps, "cpu"), 10,
                      fast32=True)
    # the rhs kernels of phase 8 are the same kernels as phases 2 and 5
    # build for the same problems: merge their figures
    for key, (ks, es, rs, ts) in ((2, (kern, errs, rel, times)),
                                  (3, (kern3, errs3, rel3, times3))):
        _, e, r, tm = rhs["%dd" % key]
        es["rhs"], rs["rhs"], ts["rhs"] = e, r, tm
    print(card)
    print(json.dumps({
        "kernels": kernel_rows(kern, "ksfd_tpu_torch/csrc/stencil2d.cu",
                               dict(f64=counts, f32=counts32), errs, rel,
                               times, "")
        + kernel_rows(kern3, "ksfd_tpu_torch/csrc/stencil3d.cu",
                      dict(f64=counts3, f32=counts32_3), errs3, rel3,
                      times3, "3d"),
        "ms_per_step": step_s * 1e3, "dof_updates_per_s": rate,
        "ms_per_step_3d": step3_s * 1e3, "dof_updates_per_s_3d": rate3,
        "ms_per_step_f32": step32_s * 1e3, "dof_updates_per_s_f32": rate32,
        "ms_per_step_3d_f32": step32_3_s * 1e3,
        "dof_updates_per_s_3d_f32": rate32_3,
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
