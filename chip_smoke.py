"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

It builds the CUDA kernels of ksfd_tpu_torch from the sources in the
checkout (csrc/stencil2d.cu and csrc/stencil3d.cu, one nvcc per problem
header, and csrc/pc2d.cu, all started together) and runs thirty-six
phases, each printing one line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, the float32 matmul precision and the kernels' builds, with
   ptxas's registers and spills (no stencil kernel of any build may
   spill), each 2D and 3D kernel's threads and shared memory per block
   and its resident blocks per SM (the library's ``ksfd_occupancy``)
   and, for
   csrc/pc2d.cu, the counts of
   HGMMA (wgmma) and UTMALDG (TMA) instructions in each product
   (``cuobjdump -sass``, where the toolkit has it: each must have both);
2. each 2D kernel (B1, B2, B3: the four on one march along x, rhs in
   phase 8) against its plain PyTorch version on the card at 1024^2 x 3
   f32, with CUDA-event times of both and each kernel's share of its
   bound, and at 200 x 136 with 2 and 4 fields (the march's ragged
   strip and x chunk);
3. the 2D main path at 1024^2 x 3 f64: ``make_multistep_fn`` with
   default numerics, chained fixed-dt steps at h=1 (2 and 10 steps),
   with exact launch counts, a finite state and embedded error, and the
   slope-timed ms/step and DOF-updates/s;
4. the same slice at 256^2 x 3 on the card and on the CPU (plain
   versions) from one numpy state, agreeing to 1e-5 of the summed
   increment;
5. each 3D kernel against its plain version on the card at 256^3 x 3
   f32 (the aggregation3d problem) and at the odd size 40 x 36 x 20,
   with CUDA-event times at 256^3 and each kernel's share of its bound;
6. the 3D main path at 256^3 x 3 f64 (50.3M DOF), as phase 3;
7. the 3D slice at 64^3 x 3 (examples/aggregation3d's size) on the card
   and on the CPU, as phase 4;
8. the float32 fast mode's rhs kernels against their plain versions:
   B7 at 1024^2 x 3 (and 200 x 136 with 2 and 4 fields), B6a at 256^3 x
   3 and at 40 x 36 x 20 x 3, with
   CUDA-event times of both and each kernel's share of its bound;
9. the fast mode's main path (``NumericsOptions(precision="float32")``)
   at 1024^2 x 3 and at 256^3 x 3, as phases 3 and 6;
10. the fast mode on the card and on the CPU at 256^2 x 3 and 64^3 x 3,
    agreeing to 1e-4 of the summed increment plus 4 float32 ulps of the
    state;
11. the fused pc's kernels (B5a pc_fwd, B5b pc_inv, 3xTF32 wgmma fed by
    TMA) against their plain versions at 1024^2 x 3, 1536^2 x 3, the
    ragged 200 x 136 x 3 and 201 x 137 x 3 (no axis divisible by 4: the
    pitched copy, counted, with its profiled device µs), with CUDA-event
    times of each kernel, its plain version and the basis-GEMM pc's
    cuBLAS call for the same function, the 3xTF32 tensor-core bound and
    the earlier float32 SIMT one; both ragged sizes also with 2 and 4
    fields;
12. the main path with ``pc_pallas=True`` at 1024^2 x 3, f64 and f32,
    as phases 3 and 9 (its profile must show no library GEMM), and on
    the card against the CPU at 256^2 x 3;
13. the adaptive chunk (``make_adaptive_chunk_fn``) at the flagship's
    1536^2 x 3 (examples/aggregation2d), with the fused and with the
    basis-GEMM pc: a smooth figure at h=1 and a stiff one from the rough
    state, whose ladder must escalate;
14. the chunk with the fused pc on the card and on the CPU at 128^2 x 3
    of the flagship's spacing, agreeing in accepts, attempts and the
    rejected flag;
15. B11, the coefficient-field resid kernel, at 1024^2 x 3 on the
    probe's state (ksfd_tpu_torch/tools/probe_coeff_kernel.py): against
    its plain version and against B1, µs per launch of both, the
    probe's slope µs/sweep of both chains, the bounds and the ms of
    ``prepare``; against its plain version at 200 x 136 with 2 and 4
    fields;
16. the member-batched builds of B1, B2, B3 and B7 at 1024^2 x 3 for 4
    distinct members: one batched launch under ``torch.func.vmap``
    against the 4 single launches (bit for bit) and the plain version,
    µs of both, ptxas registers and spills; the same, not timed, at
    200 x 136 with 2 and 4 fields;
17. the ensemble's fixed-dt path (EnsembleSolver, block_steps) at
    1024^2 x 3 with 1, 4 and 8 members (f64) and 8 in the fast mode:
    exact launches per ensemble step whatever the member count, ms per
    ensemble step and per member, the busy share, members against
    their own single runs;
18. EnsembleSolver adaptive on examples/hexagons2d at its own 384^2 x
    3, 4 members: per step, then with the device loop (one vmapped tier
    step per occupied tier per attempt, its launches those calls', each
    member against its own single-member chunk), ms per accepted
    ensemble step and dispatches per accept of both; a forced fallback
    so that the float64 GMRES step runs, and that step timed;
19. the ensemble on the card and on the CPU at 64^2 x 3, 3 members,
    fixed-dt blocks and adaptive per step, agreeing in counts, t, h
    and state;
20. the member-batched builds of B6a-d at 256^3 x 3 for 4 distinct
    members, as phase 16 (with the batched launch's share of its
    bound);
21. the member-batched fused pc (B5a, B5b) at 1024^2 x 3 for 4 distinct
    members, as phase 16 (and at 200 x 136 with 2 and 4 fields);
22. the 3D ensemble's fixed-dt path at 256^3 x 3 with 1 and 4 members
    (f64) and 4 in the fast mode, as phase 17, with the peak device
    memory;
23. the pc_pallas ensemble's fixed-dt path at 1024^2 x 3 with 4 and 8
    members, as phase 17 (its profile must show no library GEMM);
24. EnsembleSolver adaptive per step on examples/aggregation3d at its
    own 64^3 x 3, 4 members; and the 3D ensemble (32^3 x 3, 2 members)
    and the pc_pallas ensemble (64^2 x 3, 3 members) on the card and
    on the CPU, as phase 19;
25. B9, the halo-slab builds of the four 2D and the four 3D stencil
    kernels, at 1024^2 x 3 and 256^3 x 3 (and the 2D ones at 200 x 136
    with 2 and 4 fields) on 1, 2 and 4 slabs of one
    global state in this one process (the halo rows cut from it): each
    slab within 1e-5 of max|plain| of its plain version, the stitched
    slabs bit for bit the unsharded launch, µs per launch per slab at 2
    slabs beside the plain version, the bound and the share of it;
26. the sharded path on a one-rank NCCL mesh (``mesh=`` with the ring
    closed on itself, every all_reduce through NCCL): the float64 and
    fast-mode multisteps at 1024^2 x 3 and 256^3 x 3 with exact B9
    launch counts, against the unsharded multistep, ms/step of both and
    the profiled device share of the halo rows and the all_reduce;
27. two gloo ranks (spawned processes) time-sliced on the one card: the
    2D step and multistep, the adaptive chunk at the flagship's
    1536^2 x 3 and the 3D multistep, each against the unsharded port on
    the card;
28. the unfused step (no kernel, the RHS linearized once per step):
    examples/peaks1d at its own 384 x 3 (1D: the adaptive chunk, the
    multistep card vs CPU, the device-loop ensemble of 3 members), the
    2D bench problem at 1024^2 x 3 with use_pallas=False against the
    fused step (no stencil launch; ms/step and device ms by group of
    both), the 3D problem at 64 x 64 x 4 (z under 2*sw+1), and each way
    of linearizing the RHS timed in 1D and 2D;
29. time-dependent coefficients through the kernels (each against its
    plain version, the launches of the mixed and fast steps, card vs
    CPU);
30. the host Solver (phase_solver): options93 at 128 x 3 for 2080 fixed
    steps within 5% of the reference's relative error; the flagship at
    1536^2 x 3 from ``ic.start_values`` with the device loop, its
    launches exact, beside the bare chunk on the same start; the Solver
    on the card against the CPU at 128^2 x 3; examples/noise1d's
    injections, conservation and draws;
31. the driver, ``ksfd_tpu_torch.ksfdsolver.main`` (``python -m
    ksfd_tpu_torch``), in this process (phase_entry_point):
    examples/aggregation2d at 1536^2 x 3 with its own ``--numerics
    -device_loop 1 --`` for 64 accepts, bit for bit phase 30's flagship
    run with exactly 512 resid and 256 delta launches; the options92
    gate (examples/eigenmode1d to t = 2e4 on the banded exact tier);
    ``--ensemble=4`` on examples/hexagons2d against EnsembleSolver run
    directly; and, without h5py, ``--save`` refused before any step
    (with it, a 3 + 3 resume against 6 straight steps);
32. the DIRK path (phase_dirk): the chained multistep at 1024^2 x 3
    with ARK324 and ARK436 (f64) and ARK324 in the fast mode, exact
    launches per step, ms/step and the device split beside phases 3 and
    9; card vs CPU at 128^2 x 3; the flagship through ``main`` with
    ``-ts_type arkimex`` on its device loop, launches = tier calls x per
    attempt; the first steps of the reference's arkimex gate
    (examples/eigenmode1d, tests/test_gates.py:80; the whole gate is
    ``python -m ksfd_tpu_torch.tools.arkimex_gate``), its GMRES
    fallback on the card; ``--ensemble=4`` on hexagons2d with arkimex;
33. the pc forms (phase_pc_forms): the FFT block pc, the spectral pc
    and the single-card bfloat16 block pc on the 2D main path at
    1024^2 x 3, f64 and f32, beside the basis-GEMM pc (the FFT pc's
    profile must show cuFFT and no GEMM), the FFT block pc at 256^3 x
    3, and each form card vs CPU at 128^2 x 3;
34. B5 at 1, 5 and 6 fields (phase_b5_fields): each entry at 1024^2
    against its plain version, nb=4 bit for bit against four single
    launches, µs beside the bound and cuBLAS; the ``-pc_pallas 1`` main
    path at 1024^2 x 5 and card vs CPU at 128^2 x 5;
35. the fixed-count Krylov tiers, with-G states and the flux form
    (phase_krylov_with_g_flux): ``-ksp_type gmres_rolled`` on the f64
    main path at 1024^2 x 3 (B2 inside the float64 step, exact
    launches), card vs CPU, its chunk; gmres and ``-pc_type none`` card
    vs CPU; ``--with_g`` through ``main`` on the flagship; the flux form
    at 1024^2 x 3 with sum(rho)'s drift;
36. the Solver on an x-slab mesh and the driver over several processes
    (phase_mesh_solver): the flagship through ``Solver(mesh=)`` on a
    one-rank NCCL mesh against phase 30's one-card Solver (the same k,
    host reads and rejections, exact B9 launches); two gloo ranks
    spawned on the card: the flagship through ``Solver(mesh=)`` with
    equal records on both ranks, one noise injection on the 2D cell
    drawn bit for bit as on one card, then ``main`` over their group
    (the flagship cut to 16 steps, rank 0 alone printing; --ensemble=4
    on hexagons2d, members 0-1 and 2-3);
37. what the reference's mesh runs beyond the x split, and the last
    tools (phase_mesh_forms): on a one-rank NCCL mesh against the one
    card, the flagship with ``-pc_type spectral`` and ``-pc_fft on``
    (B9 launches), the flux form and a with-G state on the 2D cell,
    options93 on a 1D mesh, a 4-member hexagons2d ensemble split over
    the mesh (per step and device loop); two gloo ranks on the card: a
    (1, 2) y split at 256^2 x 3 and ``main`` on eigenmode1d's 1D mesh;
    ``tools/probe_hgap.py`` on the flagship after 150 accepts.

Then one JSON line of the nineteen kernels (B9's eight rows last, with
the mesh Solver's launches per accepted step) and
of every phase's figures, the card's line, one short line per kernel
(µs, bound, plain and library µs, launches per step on each path) and,
last, the result line.  Any failed phase raises (a failed rank fails
phases 27, 36 and 37), so the exit code is not 0 and no result
prints.  It imports
nothing of JAX.  Profiles and long reports go to chiprun_out/.
"""

import ctypes
import dataclasses
import json
import math
import os
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the problem definitions, shared with the probes: the port's copy of
# __graft_entry__._make_problem's parameters and tests/helpers.py's
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels
from ksfd_tpu_torch.tools import arkimex_gate
# ``main`` in this process, recording the solver it builds (phases 31-32)
from ksfd_tpu_torch.tools.arkimex_gate import drive_main as drive_cli
from ksfd_tpu_torch.utils.device import card_line
from ksfd_tpu_torch.tools.problems import (  # noqa: F401 (re-exported)
    OPTIONS92_PARAMS,
    agg3d_clargs,
    bench_clargs,
    example_params,
    make_clargs,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
N_BIG = 1024
N_CMP = 256
N3_BIG = 256
N3_CMP = 64
ODD3 = (40, 36, 20)
#: the other field counts phase 5 holds the 3D kernels to at ODD3
FIELDS3 = (2, 4)
N_AGG = 1536                # examples/aggregation2d, the flagship
RAGGED = (200, 136)         # a size whose pc tiles are ragged
#: the other field counts phases 2, 8, 11, 15, 16, 21 and 25 hold the 2D
#: kernels to at RAGGED (a ragged strip and x chunk of the march)
FIELDS2 = (2, 4)
RAGGED4 = (201, 137)        # both axes not divisible by 4: the pc's pitched copy
N_CHUNK_CMP = 128
N_HEX = 384                 # examples/hexagons2d's own size
N_ENS_CMP = 64              # the ensemble's card vs CPU check
ENS_RUNS = [("f64", 1), ("f64", 4), ("f64", 8), ("f32", 8)]   # phase 17
ENS3_RUNS = [("f64", 1), ("f64", 4), ("f32", 4)]   # phase 22, 256^3
ENS_PC_RUNS = [("f64", 4), ("f64", 8)]             # phase 23, pc_pallas
N3_ENS_CMP = 32             # the 3D ensemble's card vs CPU check
GAMMA = 0.435866521508459   # ROS34PW2's diagonal: shift = 1/(h*GAMMA)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores, same sheet
TF32_OPS_PER_S = 495e12     # TF32 on the tensor cores, dense, same sheet


def check(cond, what):
    if not cond:
        raise RuntimeError("check failed: " + what)


def agg2d_clargs(n, extra=()):
    """The parameters of examples/aggregation2d, the flagship (rho plus
    an attractant and a repellent ligand group, degree 3, a periodic
    4 x 4 square, 1536^2 elements) with nelements=n; ``extra``
    parameters replace the file's of the same name."""
    names = {p.split("=", 1)[0] for p in extra}
    params = [p for p in example_params("aggregation2d")
              if p.split("=", 1)[0] not in names]
    return make_clargs(params=params + list(extra) + ["nelements=%d" % n])


def agg2d_small_clargs(n):
    """aggregation2d's parameters on an n x n grid of the flagship's
    spacing (a square of side 4 n / 1536), so the stiffness per cell and
    the rough state's peaks (10 cells wide) are the flagship's."""
    side = "%.17g" % (4.0 * n / N_AGG)
    return agg2d_clargs(n, ["width=" + side, "height=" + side])


def hex_clargs():
    """The parameters of examples/hexagons2d (the options81-class noisy
    uniform start, rho plus an attractant and a repellent ligand group,
    degree 3, a periodic unit square) at its own 384^2."""
    return make_clargs(params=example_params("hexagons2d")
                       + ["nelements=%d" % N_HEX])


def hex_numerics(**kw):
    """examples/hexagons2d's numerics block (-ts_type rosw,
    -ts_adapt_type basic, -ts_adapt_dt_max 10000, -ts_adapt_dt_min 1e-20,
    -ts_adapt_clip 0.1,5, -ksp_iters 16) as NumericsOptions fields; its
    '-ksp_type preonly -pc_type lu' stays on the iterative stack at
    384^2 x 3, as the reference routes it (solver.py:64-92)."""
    from ksfd_tpu_torch import NumericsOptions

    return NumericsOptions(ts_type="rosw", adapt_type="basic", dt_max=1e4,
                           dt_min=1e-20, clip_low=0.1, clip_high=5.0,
                           ksp_iters=16, **kw)


#: the coefficients that depend on t in phase 29's problem (and in
#: tests/test_torch_tdep.py's)
TDEP_PARAMS = ["gamma_1_1=0.01*(1 + t)", "s2=sigma**2/2*(1 + 0.1*t)"]


def tdep_clargs(n):
    """The bench problem at n^2 with its free energy G (through s2) and
    one ligand decay depending on t."""
    names = {p.split("=", 1)[0] for p in TDEP_PARAMS}
    clargs = bench_clargs(n)
    clargs.params = [p for p in clargs.params
                     if p.split("=", 1)[0] not in names] + TDEP_PARAMS
    return clargs


def initial_state(grid):
    """Port of __graft_entry__._initial_state, near-uniform ~9000, in
    any dimension: 9000 + (1, 0.7, 0.1) * sin(2 pi (x + y [+ z])); with
    1 or 2 fields the first of them, with 4 to 6 more at 0.4, 0.3,
    0.2."""
    axes = [np.arange(n) / n for n in grid.Sshape]
    s = np.sin(2 * np.pi * sum(np.meshgrid(*axes, indexing="ij")))
    return np.stack([9000.0 + a * s for a in
                     (1.0, 0.7, 0.1, 0.4, 0.3, 0.2)[:grid.dof]])


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
    x, y = X[:, 0], Y[0]
    for cx, cy in rng.random((max(48, (nx * ny) // 8192), 2)):
        # the Gaussian is separable: one outer product per peak
        dx = np.minimum(np.abs(x - cx), 1.0 - np.abs(x - cx))
        dy = np.minimum(np.abs(y - cy), 1.0 - np.abs(y - cy))
        rho += (0.95 * rhomax) * np.outer(np.exp(-dx**2 / (2 * w * w)),
                                          np.exp(-dy**2 / (2 * w * w)))
    rho = np.minimum(rho, 0.93 * rhomax)
    return np.stack([rho] + [rho * r for r in ligand_ratios(ps)])


def pallas_rough_state(shape, seed=0, scale=1000.0):
    """tests/test_pallas.py's rough state at any shape (numpy seed 0):
    6000 + (3, 1, 0.5) * scale * |N(0, 1)| per field."""
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal(shape)),
        6000 + scale * np.abs(rng.standard_normal(shape)),
        6000 + 0.5 * scale * np.abs(rng.standard_normal(shape)),
    ])


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


#: cycles per second of torch.cuda._sleep, nominal (the H100 SXM's
#: boost clock; a slower clock only lengthens the sleep)
SLEEP_CYCLES_PER_S = 2.0e9


def cuda_ms(fn, reps):
    """Mean ms of fn() over reps back-to-back calls (CUDA events), after
    two warmup calls.  A sleep on the card, 1.5 times the host's time to
    queue the calls (capped at 2 s), goes first: the card then runs the
    queued calls back to back, so the events time the card's work and
    not the host's launch rate (a ~35 µs launch from Python can take the
    host longer than the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 1.5 * reps * host_s + 1e-3)
                          * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# state-sized planes read per kernel, in units of dof (the output, dof
# planes, is written once besides); coeff_resid also reads C's 3 extra
# planes
_N_IN = dict(rhs=1, jvp=2, resid=3, delta=3, coeff_resid=3)


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
    if name == "coeff_resid":
        # no pointwise function: dG = sum dG'_i v_i, the mask bits and
        # the tangents' selects, then the rows and the residual
        return rows + 4 * (nl + 1) + 3 * (nl + 1)
    if name == "delta":
        pointwise = int(sy.count_ops(ops.G_expr)) + int(
            sy.count_ops(ops.G_delta_expr)) + 4
    else:
        pointwise = int(sy.count_ops(ops.G_expr)) + sum(
            int(sy.count_ops(e)) for e in ops.dG_exprs) + 2 * (nl + 1)
    return pointwise + rows + (3 * (nl + 1) if name == "resid" else 0)


def kernel_bound(name, build, nb=1):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (each operand read once, the output written once) over the
    card's memory rate and its operations over the f32 rate, for ``nb``
    members."""
    points = nb * int(np.prod(build.Sshape))
    planes = (_N_IN[name] + 1) * build.dof + 3 * (name == "coeff_resid")
    nbytes = planes * points * 4
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


# kernel names of library GEMMs (cuBLAS, CUTLASS) in a profile
_LIBRARY_GEMM = ("gemm", "xmma", "cutlass", "sm90")


def library_gemms(per_kernel):
    """The library GEMM kernels (cuBLAS, CUTLASS) of a profile."""
    return sorted(k for k in per_kernel if "pc_gemm" not in k.lower()
                  and any(w in k.lower() for w in _LIBRARY_GEMM))


def device_groups(per_kernel):
    """Device ms by group (library GEMMs, the fused pc's kernels, the
    stencil kernels, cuFFT's kernels (the FFT pc), the rest) of a
    profile's ms by kernel name."""
    groups = {"gemm": 0.0, "pc kernels": 0.0, "stencil kernels": 0.0,
              "fft": 0.0, "other": 0.0}
    for key, ms in per_kernel.items():
        low = key.lower()
        if "pc_gemm" in low:
            groups["pc kernels"] += ms
        elif "fft" in low:
            groups["fft"] += ms
        elif any(w in low for w in _LIBRARY_GEMM):
            groups["gemm"] += ms
        elif "ksfd" in low or any(
                w in low for w in ("rhs_kernel", "jvp_kernel",
                                   "delta_kernel")):
            groups["stencil kernels"] += ms
        else:
            groups["other"] += ms
    return groups

# the kernels' mangled names, as ptxas reports them
_PTXAS_NAMES = (("rhs_kernel", "rhs"), ("jvp_kernelILb0", "jvp"),
                ("jvp_kernelILb1", "resid"), ("delta_kernel", "delta"),
                ("coeff_resid_kernel", "coeff_resid"),
                ("rhs_halo_kernel", "rhs_halo"),
                ("jvp_halo_kernelILb0", "jvp_halo"),
                ("jvp_halo_kernelILb1", "resid_halo"),
                ("delta_halo_kernel", "delta_halo"))


#: csrc/pc2d.cu's pc_gemm_tc<NF, NACC, EPI> instances (the plain
#: product, one field per block, for every entry and field count; the
#: forward entry's second product with the arrow epilogue, all fields per
#: block, for 1 to 4 fields), the arrow pass above 4 fields and the
#: pitched copy
_PTXAS_PC_NAMES = (("pc_gemm_tcILi1ELi1ELb0E", "product"),) + tuple(
    ("pc_gemm_tcILi%dELi%dELb1E" % (nf, nf), "product+arrow nf=%d" % nf)
    for nf in (1, 2, 3, 4)
) + (("pc_arrow_pass", "arrow pass"), ("pc_gemm_pitch_copy", "pitch copy"))
#: the pc2d.cu kernels that are no tensor-core product
_PC_NO_MMA = ("arrow pass", "pitch copy")


def sass_counts(path, ops=("HGMMA", "UTMALDG")):
    """Counts of the SASS instructions ``ops`` per pc_gemm_tc instance of
    a built library (``cuobjdump -sass``), labelled as ptxas_summary
    labels them; None where the toolkit has no cuobjdump."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = next((n for m, n in _PTXAS_PC_NAMES if m in line), None)
            if name is not None:
                out[name] = dict.fromkeys(ops, 0)
        elif name is not None:
            for op in ops:
                out[name][op] += (" %s" % op) in line
    return out


def ptxas_summary(log, names=_PTXAS_NAMES):
    """Registers, spills and static shared memory per kernel from an
    ``nvcc -Xptxas -v`` log."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((n for m, n in names if m in line), line)
        elif "spill stores" in line and name:
            spills = line.strip().split(",")[1:]
            out.append([name, ",".join(spills).strip()])
        elif "Used" in line and "registers" in line and out:
            out[-1].append(line.split(":", 1)[1].strip())
    return "; ".join(" ".join(x) for x in out)


def ptxas_spills(log, names=_PTXAS_NAMES):
    """{kernel: (spill store bytes, spill load bytes)} from an ``nvcc
    -Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((n for m, n in names if m in line), line)
        elif "spill stores" in line and name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            out[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return out


def phase_build():
    """Build every kernel library the phases use, one nvcc per problem
    header (the stencil coefficients depend on the grid spacing), all
    started together."""
    from ksfd_tpu_torch.ops.fused_pc import PC_BUILD

    configs = [
        ("2d %d^2" % N_BIG, bench_clargs(N_BIG), (N_BIG, N_BIG)),
        ("2d %d^2" % N_CMP, bench_clargs(N_CMP), (N_CMP, N_CMP)),
        ("3d %d^3" % N3_BIG, agg3d_clargs(N3_BIG), (N3_BIG,) * 3),
        ("3d %dx%dx%d" % ODD3, agg3d_clargs(ODD3[0]), ODD3),
        ("3d %d^3" % N3_CMP, agg3d_clargs(N3_CMP), (N3_CMP,) * 3),
        ("3d %d^3" % N3_ENS_CMP, agg3d_clargs(N3_ENS_CMP),
         (N3_ENS_CMP,) * 3),
        ("2d agg %d^2" % N_AGG, agg2d_clargs(N_AGG), (N_AGG, N_AGG)),
        ("2d agg %d^2" % N_CHUNK_CMP, agg2d_small_clargs(N_CHUNK_CMP),
         (N_CHUNK_CMP, N_CHUNK_CMP)),
        ("2d hexagons %d^2" % N_HEX, hex_clargs(), (N_HEX, N_HEX)),
        ("2d %d^2" % N_ENS_CMP, bench_clargs(N_ENS_CMP),
         (N_ENS_CMP, N_ENS_CMP)),
        ("2d tdep %d^2" % N_BIG, tdep_clargs(N_BIG), (N_BIG, N_BIG)),
        ("2d tdep %d^2" % N_CMP, tdep_clargs(N_CMP), (N_CMP, N_CMP)),
    ] + [("3d %dx%dx%dx%d" % (ODD3 + (dof,)), agg3d_clargs(ODD3[0], dof),
          ODD3) for dof in FIELDS3] + [
        ("2d %dx%dx%d" % (RAGGED + (dof,)), bench_clargs(RAGGED[0], dof),
         RAGGED) for dof in FIELDS2] + [
        ("2d %d^2" % N_DIRK_CMP, bench_clargs(N_DIRK_CMP),
         (N_DIRK_CMP, N_DIRK_CMP))]
    builds = []
    for label, clargs, shape in configs:
        # the header depends on the problem only, not on the device
        _, _, ops = problem_from_clargs(clargs, *shape, device="cpu")
        build = make_fused_kernels(ops).build
        if all(b.header != build.header for _, b in builds):
            builds.append((label, build))
    # the fused pc needs no header: one library for every grid
    builds.append(("pc2d", PC_BUILD))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda lb: lb[1].library(), builds))
    wall = time.perf_counter() - t0
    reports = ["%s: %s" % (label, ptxas_summary(b.build_info["ptxas"]))
               for label, b in builds[:5:2]]  # 1024^2, 256^3, 64^3
    reports.append("pc2d: %s" % ptxas_summary(
        PC_BUILD.build_info["ptxas"], _PTXAS_PC_NAMES))
    # the tensor cores (HGMMA) and TMA (UTMALDG) in every product
    sass = sass_counts(PC_BUILD.build_info["path"])
    if sass is not None:
        check(all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                  for n, c in sass.items() if n not in _PC_NO_MMA)
              and len(sass) == len(_PTXAS_PC_NAMES), "pc2d.cu's products "
              "without HGMMA or UTMALDG: %s" % sass)
    reports.append("pc2d SASS: %s" % (
        "no cuobjdump" if sass is None else "; ".join(
            "%s HGMMA %d UTMALDG %d" % (n, c["HGMMA"], c["UTMALDG"])
            for n, c in sass.items() if n not in _PC_NO_MMA)))
    # every stencil kernel of every build, unsharded and halo-slab (9 in
    # 2D with B11, 8 in 3D), keeps its registers
    # the delta kernels of a problem whose coefficients depend on t run
    # on no path (stage_delta_ok: the step drops delta there, as the
    # reference does): their spills are reported, not held
    unheld = []
    for label, b in builds[:-1]:
        spills = ptxas_spills(b.build_info["ptxas"])
        held = {n: v for n, v in spills.items()
                if b.ops.stage_delta_ok() or not n.startswith("delta")}
        unheld += ["%s %s %s" % (label, n, v) for n, v in spills.items()
                   if n not in held and any(v)]
        check(len(spills) == (9 if label.startswith("2d") else 8)
              and not any(any(v) for v in held.values()),
              "%s kernels spill: %s" % (label, spills))
    print("phase 1 build: %d libraries in %.2f s wall (nvcc s: %s) | 2D "
          "per block: %s | 3D per block: %s | %s | spills (bytes stored, "
          "loaded) of kernels on no path: %s" % (
              len(builds), wall,
              ", ".join("%s %.2f" % (l, b.build_info["nvcc_seconds"])
                        for l, b in builds),
              launch_geometry(builds[0][1].library(),
                              ("jvp", "resid", "delta", "rhs",
                               "coeff_resid"), "ksfd_smem_bytes", 1),
              launch_geometry(builds[2][1].library(),
                              ("jvp", "resid", "delta", "rhs"),
                              "ksfd_smem_floats", 4),
              " | ".join(reports), "; ".join(unheld) or "none"))
    return reports[-2], sass


def launch_geometry(lib, names, smem_fn, smem_unit):
    """Each kernel's threads and shared memory per block and its
    resident blocks per SM, unsharded and halo-slab (B11 has none)
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` through the
    library's ``ksfd_occupancy``), from a built csrc/stencil2d.cu (the
    march's dynamic ring, B11's static tile: ``ksfd_smem_bytes``) or
    csrc/stencil3d.cu (its dynamic shared memory, ``ksfd_smem_floats``)."""
    for fn, n_args in (("ksfd_threads", 1), (smem_fn, 1),
                       ("ksfd_occupancy", 2)):
        getattr(lib, fn).argtypes = [ctypes.c_int] * n_args
        getattr(lib, fn).restype = ctypes.c_int
    out = []
    for which, name in enumerate(names):
        occ = [lib.ksfd_occupancy(which, h)
               for h in ((0,) if name == "coeff_resid" else (0, 1))]
        check(min(occ) > 0, "%s: no block resident per SM" % name)
        out.append("%s %d threads %d B, %d blocks/SM%s" % (
            name, lib.ksfd_threads(which),
            smem_unit * getattr(lib, smem_fn)(which), occ[0],
            " (halo %d)" % occ[1] if len(occ) > 1 else ""))
    return "; ".join(out)


def clamped(u_raw, ops):
    """A copy of a raw f64 state with points below, at and NaN against
    the floors: the kernels' where-form clamp and strict tangent mask."""
    dim = ops.grid.dim
    raw = u_raw.clone()
    raw[(0,) + tuple(slice(None, None, p)
                     for p in (97, 89, 7)[:dim])] = 0.5 * ops.rhomin
    raw[(0, 3, 5, 1)[:dim + 1]] = ops.rhomin
    raw[(1, 5, 7, 2)[:dim + 1]] = ops.Umin
    raw[(len(raw) - 1, 9, 11, 3)[:dim + 1]] = float("nan")
    return raw


def kernel_cases(kern, ops, states, gen, t=0.0):
    """(name, label, args) for each kernel on each state (f64 tensors on
    the card) at time t: jvp and resid on the groomed f32 state and, for
    the rough one, on a raw state with points below, at and NaN against
    the floors; delta with increments of scale 100 (rough) or 1e-3
    (near-uniform) and with a fifth of the points clamped to the
    floor."""
    shape = tuple(ops.grid.Vshape)
    t = torch.full((), t, dtype=torch.float64, device="cuda")
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


def rhs_cases(ops, states, t=0.0):
    """(name, label, args) of the rhs kernel on each state (f64 tensors
    on the card) at time t: the f32 state as the fast mode holds it and,
    for the rough one, a raw state with points below, at and NaN against
    the floors (the kernel grooms)."""
    t = torch.full((), t, dtype=torch.float32, device="cuda")
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
    """Each 2D kernel against its plain version on the card at 1024^2 x
    3 (timed, with each kernel's share of its bound) and at RAGGED with
    2 and 4 fields (a ragged strip and x chunk of the march)."""

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
    del cases, states
    # other field counts, on the march's ragged strip and x chunk
    for dof in FIELDS2:
        _, kern_f, _, states = fields_case(dof)
        compare_kernels(kern_f, kernel_cases(kern_f, kern_f.build.ops,
                                             states, gen), {}, {}, lines)
    print("phase 2 kernels vs plain 1024^2x3 (and %dx%dx%s fields) (%s): %s "
          "| ms kernel/plain: %s" % (
              RAGGED + ("/".join(map(str, FIELDS2)), card, "; ".join(lines),
                        "; ".join("%s %.4f/%.4f (%.3f)" % (
                            n, a, b, kernel_bound(n, kern.build)[0] / a)
                            for n, (a, b) in times.items()))))
    return kern, errs, rel, times


def fields_case(dof):
    """(ps, kernels, grid, {label: state}) of the bench problem at
    RAGGED with ``dof`` fields (tools/problems.py with_fields), on the
    card: the rough and the near-uniform state."""
    dev = torch.device("cuda")
    ps, grid, ops = problem_from_clargs(bench_clargs(RAGGED[0], dof),
                                        *RAGGED, device=dev)
    return ps, make_fused_kernels(ops), grid, {
        "rough_%dfields" % dof: torch.as_tensor(rough_state(grid, ps),
                                                device=dev),
        "initial_%dfields" % dof: torch.as_tensor(initial_state(grid),
                                                  device=dev)}


def phase_kernels_3d(card):
    """Each 3D kernel against its plain version on the card at 256^3 x 3
    (rough and near-uniform states, timed on the rough one) and at the
    odd size ODD3, whose tiles are ragged in every axis."""

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
    times = time_kernels(kern, cases, "rough", 200, 20)
    del cases, states
    ps, grid, ops = problem_from_clargs(agg3d_clargs(ODD3[0]), *ODD3,
                                        device=dev)
    kern_odd = make_fused_kernels(ops)
    states = dict(rough_odd=rough_state_3d(grid, ps, dev))
    compare_kernels(kern_odd, kernel_cases(kern_odd, ops, states, gen),
                    errs, rel, lines)
    # other field counts (a point's raw values outnumber jvp's and
    # resid's window arrays at 4): every kernel, rhs too
    for dof in FIELDS3:
        ps, grid, ops = problem_from_clargs(agg3d_clargs(ODD3[0], dof),
                                            *ODD3, device=dev)
        kern_f = make_fused_kernels(ops)
        states = {"rough_odd_%dfields" % dof: rough_state_3d(grid, ps, dev)}
        compare_kernels(kern_f, kernel_cases(kern_f, ops, states, gen)
                        + rhs_cases(ops, states), {}, {}, lines)
    print("phase 5 3D kernels vs plain 256^3x3 and %dx%dx%dx3 (and x%s "
          "fields) (%s): %s | ms kernel/plain at 256^3 (share of the "
          "bound): %s" % (
              ODD3 + ("/".join(map(str, FIELDS3)), card, "; ".join(lines),
                      "; ".join(
                  "%s %.4f/%.4f (%.3f)" % (
                      n, a, b, kernel_bound(n, kern.build)[0] / a)
                  for n, (a, b) in times.items()))))
    return kern, errs, rel, times


def phase_rhs_kernels(card):
    """The fast mode's rhs kernels against their plain versions on the
    card: B7 at 1024^2 x 3, B6a at 256^3 x 3 (rough, near-uniform and
    clamped states, timed on the rough one) and at the odd size ODD3."""

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
        out[key] = (kern, time_kernels(kern, cases, "rough", 200, 20))
        del cases, states
    for dof in FIELDS2:
        _, kern_f, _, states = fields_case(dof)
        l = []
        compare_kernels(kern_f, rhs_cases(kern_f.build.ops, states), {}, {},
                        l)
        lines.append("2d %dx%dx%d: %s" % (RAGGED + (dof, "; ".join(l))))
    share = {key: kernel_bound("rhs", out[key][0].build)[0]
             / out[key][1]["rhs"][0] for key in out}
    print("phase 8 rhs kernels vs plain, B7 1024^2x3 (and %dx%dx%s "
          "fields), B6a 256^3x3 and %dx%dx%dx3 (%s): %s | ms kernel/plain "
          "(share of the bound): 2d %.4f/%.4f (%.3f); 3d %.4f/%.4f (%.3f)" % (
              RAGGED + ("/".join(map(str, FIELDS2)),) + ODD3
              + (card, " | ".join(lines)) + out["2d"][1]["rhs"]
              + (share["2d"],) + out["3d"][1]["rhs"] + (share["3d"],)))
    return {key: (out[key][0], errs[key], rel[key], out[key][1]["rhs"])
            for key in ("2d", "3d")}


def phase_main_path(card, tag, clargs, shape, phase, fast32=False,
                    pc_pallas=False, extra=None, per_step=None, label="",
                    figures=None, h=1.0):
    """make_multistep_fn at ``shape`` x 3, default numerics (f64) or the
    float32 fast mode, with the basis-GEMM pc or (``pc_pallas``) the
    fused pc, fixed dt h=1, from the near-uniform initial state: exact
    launch counts of the 2- and 10-step chains (each counted from 0 just
    before the chain), slope timing and a profiled 2-step chain, which
    on the fused pc's path must show no library GEMM.  ``extra``: more
    NumericsOptions fields (a DIRK ``ts_type``, a pc form), with the
    launches ``per_step`` they make and a ``label`` for the line and the
    profile's file; ``figures`` (a dict) receives the device ms per step,
    its groups and the busy share; ``h`` another step size."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.solvers import make_multistep_fn

    dev = torch.device("cuda")
    ps, grid, ops = problem_from_clargs(clargs, *shape, device=dev)
    kern = make_fused_kernels(ops)
    numerics = NumericsOptions(precision="float32" if fast32 else "float64",
                               pc_pallas=pc_pallas, **(extra or {}))
    if per_step is None:
        per_step = (dict(rhs=4, jvp=8, resid=0, delta=0) if fast32
                    else dict(rhs=0, jvp=0, resid=8, delta=4))
    if pc_pallas:
        per_step.update(pc_fwd=12, pc_inv=12)
    multi, _ = make_multistep_fn(ops, numerics, atol=0.01,
                                 rtol=1e-6, static_steps=False,
                                 kernels=kern)
    wrappers = dict(kern.kernels)
    if pc_pallas:
        wrappers.update(multi.fused_pc.kernels)
    u0 = torch.as_tensor(initial_state(grid), device=dev)
    t0 = torch.zeros((), dtype=torch.float64, device=dev)
    h = torch.full((), h, dtype=torch.float64, device=dev)

    counts = {}
    for n in (2, 10):
        for k in wrappers.values():
            k.launches = 0
        u, t, emax = multi(u0, t0, h, n)
        torch.cuda.synchronize()
        counts[n] = {name: k.launches for name, k in wrappers.items()}
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
    prec = (("f32" if fast32 else "f64") + (" pc_pallas" if pc_pallas else "")
            + (" " + label if label else ""))
    fname = "main_path_profile%s%s%s%s.txt" % (
        "" if len(shape) == 2 else "_3d", "_pc" if pc_pallas else "",
        "_f32" if fast32 else "", "_" + label if label else "")
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
    groups = device_groups(per_kernel)
    device_ms = sum(groups.values())
    if pc_pallas:
        check(groups["pc kernels"] > 0 and not library_gemms(per_kernel),
              "the pc_pallas chain runs the pc kernels and no library GEMM: "
              "%s" % library_gemms(per_kernel))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    if figures is not None:
        figures.update(ms_per_step=step_s * 1e3, device_ms=device_ms,
                       busy=device_ms / (step_s * 1e3), groups=groups,
                       launches_per_step=dict(per_step), build_info={
                           k: multi.build_info[k] for k in
                           ("pc", "pc_dtype", "mixed32", "fast32")})
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
                      fast32=False, pc_pallas=False, extra=None, rel=1e-5):
    """The slice at ``shape`` x 3 on the card (kernels) and on the CPU
    (plain versions) from one state made on the CPU: 4 chained steps at
    h=1e-4, agreeing to 1e-5 of the summed per-step increment (f64), or
    in the float32 fast mode to 1e-4 of it plus 4 float32 ulps of the
    state, which is float32 itself.  ``extra``: more NumericsOptions
    fields (named in the line); ``rel`` another float64 bound (the
    bfloat16 pc's, whose M rounds apart on the two devices)."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.solvers import make_multistep_fn

    numerics = NumericsOptions(precision="float32" if fast32 else "float64",
                               pc_pallas=pc_pallas, **(extra or {}))
    if pc_pallas:
        tag += " pc_pallas"
    if extra:
        tag += " " + " ".join("%s=%s" % kv for kv in sorted(extra.items()))
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
        tol = rel * inc
        terms = "%g*inc %.6e" % (rel, tol)
    check(dev_abs <= tol, "card vs cpu: %.3e > %s" % (dev_abs, terms))
    print("phase %d card vs cpu %s x3 %s rough h=1e-4 x4 (%s): max dev "
          "%.3e, summed increment %.6e, dev/inc %.3e, bound %.6e (%s); "
          "emax cuda %.6e cpu %.6e" % (
              phase, tag, "f32" if fast32 else "f64", card, dev_abs, inc,
              dev_abs / inc, tol, terms, runs["cuda"][1], runs["cpu"][1]))
    return dict(max_dev=dev_abs, increment=inc, bound=tol)


def pc_step_scalars(ops, u64, h=1.0):
    """The fused pc's inputs of one step of size h from u64 at t=0, as
    make_step_fn builds them: (shift, t, means, rho_diff, scalar pack)."""
    from ksfd_tpu_torch.ops.fused_pc import pack_pc_scalars

    dev = u64.device
    u32 = ops.groom(u64).float()
    nf = u32.shape[0]
    t = torch.zeros((), dtype=torch.float64, device=dev)
    shift = torch.full((), 1.0 / (h * GAMMA), dtype=torch.float64,
                       device=dev)
    means = [torch.mean(u32[i]) for i in range(nf)]
    dG0 = ops._dG_fns[0](*[u32[i] for i in range(nf)], t)
    rho_diff = torch.max(u32[0] * dG0)
    return shift, t, means, rho_diff, pack_pc_scalars(ops, shift, t, means,
                                                      rho_diff)


def pc_bound(name, grid, nb=1):
    """(bound_ms, bound_by, f32_simt_ms) of one fused-pc entry for ``nb``
    members.  Its two products per field, 2 nx ny (nx + ny) operations,
    run as 3xTF32 (three TF32 passes) over the tensor cores' 495
    TFLOP/s, plus for pc_fwd the arrow epilogue's 3 + 13 nl per mode
    over 67 TFLOP/s, against the bytes it must move (the fields in and
    out, the two bases once, and for pc_fwd lam2d once and the scalar
    packs) over 3.35 TB/s.  f32_simt_ms: the earlier bound, every
    operation over 67 TFLOP/s of float32 outside the tensor cores."""
    nx, ny = (int(n) for n in grid.Sshape)
    nf = int(grid.dof)
    nl = nf - 1
    n_ops = nb * nf * 2.0 * nx * ny * (nx + ny)
    nbytes = 4.0 * (2 * nb * nf * nx * ny + nx * nx + ny * ny)
    if name == "pc_fwd":
        n_ops += nb * nx * ny * (3 + 13 * nl)
        nbytes += 4.0 * (nx * ny + nb * (3 + 4 * nl))
    gemm_ops = nb * nf * 2.0 * nx * ny * (nx + ny)
    t_tc = 3 * gemm_ops / TF32_OPS_PER_S + (n_ops - gemm_ops) / F32_OPS_PER_S
    t_simt, t_bytes = n_ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_tc, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_tc else "operations",
            max(t_simt, t_bytes) * 1e3)


def phase_pc_kernels(card):
    """B5a (pc_fwd) and B5b (pc_inv) against their plain versions on the
    card at 1024^2 x 3, at the flagship's 1536^2 x 3, at the ragged
    RAGGED x 3 and at RAGGED4 x 3 (no axis divisible by 4: the entries'
    pitched copy, which must run there and only there), with the scalar
    packs of a step at h=1 from the rough and the near-uniform state and
    v from a seeded generator: within 1e-5 of max|plain|.  At the two
    square sizes, CUDA-event ms of each kernel, of its plain version and
    of the library call that computes the same function (the basis-GEMM
    pc's cuBLAS products: ``_forward`` then ``_arrow_solve`` for pc_fwd,
    ``_inverse`` for pc_inv), and both bounds; at RAGGED4 the profiled
    device µs of the pitched copy per entry call."""
    from ksfd_tpu_torch.ops.fused_pc import make_fused_block_pc
    from ksfd_tpu_torch.solvers.linalg import BlockSpectralPreconditioner

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    errs, rel, lines, figures = {}, {}, [], {}

    def hold(pc, ops, grid, u64, what):
        """pc_fwd and pc_inv on the scalar pack of a step from u64 and a
        seeded v against their plain versions."""
        sc = pc_step_scalars(ops, u64)[-1]
        v = torch.randn(tuple(grid.Vshape), generator=gen, device=dev)
        modes = pc.fwd(sc, v)
        out = pc.inv(modes)
        for name, got, ref in (("pc_fwd", modes, pc.fwd.plain(sc, v)),
                               ("pc_inv", out, pc.inv.plain(modes))):
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            check(bool(torch.isfinite(got).all()),
                  "%s %s finite" % (name, what))
            check(err <= 1e-5 * scale, "%s %s: max err %.3e > 1e-5 * %.3e"
                  % (name, what, err, scale))
            errs[name] = max(errs.get(name, 0.0), err)
            rel[name] = max(rel.get(name, 0.0), err / scale)
            lines.append("%s/%s err %.3e (%.2e rel)" % (
                name, what, err, err / scale))
        return sc, v

    # other field counts (2..MAX_NF a block), at both ragged sizes: read
    # in place and through the pitched copy
    for dof in FIELDS2:
        for shape in (RAGGED, RAGGED4):
            ps, grid, ops = problem_from_clargs(bench_clargs(shape[0], dof),
                                                *shape, device=dev)
            pc = make_fused_block_pc(grid, ops)
            hold(pc, ops, grid, torch.as_tensor(rough_state(grid, ps),
                                                device=dev),
                 "%dx%dx%d/rough" % (shape + (dof,)))
            check(pc.owner.pitch_copies == (2 * (shape == RAGGED4)),
                  "%s: %d pitched copies" % (shape, pc.owner.pitch_copies))
    for label, clargs, shape in (
            ("%d^2" % N_BIG, bench_clargs(N_BIG), (N_BIG, N_BIG)),
            ("%d^2" % N_AGG, agg2d_clargs(N_AGG), (N_AGG, N_AGG)),
            ("%dx%d" % RAGGED, bench_clargs(RAGGED[0]), RAGGED),
            ("%dx%d" % RAGGED4, bench_clargs(RAGGED4[0]), RAGGED4)):
        ps, grid, ops = problem_from_clargs(clargs, *shape, device=dev)
        pc = make_fused_block_pc(grid, ops)
        states = dict(
            rough=torch.as_tensor(rough_state(grid, ps), device=dev),
            initial=torch.as_tensor(initial_state(grid), device=dev))
        for sname, u64 in states.items():
            sc, v = hold(pc, ops, grid, u64, "%s/%s" % (label, sname))
        check(pc.owner.pitch_copies == (4 * (shape == RAGGED4)),
              "%s: %d pitched copies" % (label, pc.owner.pitch_copies))
        if shape == RAGGED4:
            _, per_kernel = profile_device_ms(
                lambda: [pc.inv(pc.fwd(sc, v)) for _ in range(10)], 20)
            pitch_us = sum(ms for k, ms in per_kernel.items()
                           if "pitch_copy" in k) * 1e3
            entry_us = sum(ms for k, ms in per_kernel.items()
                           if "pc_gemm" in k) * 1e3
            figures["pitch_copy"] = (pitch_us, entry_us)
        if shape in (RAGGED, RAGGED4):
            continue
        shift, t, means, rho_diff, sc = pc_step_scalars(ops, states["rough"])
        v = torch.randn(tuple(grid.Vshape), generator=gen, device=dev)
        lib = BlockSpectralPreconditioner(grid, ops, compute_dtype="float32",
                                          device=dev)
        fwd_in = pc.fwd.prepare(sc, v)
        modes = pc.fwd.launch(*fwd_in)
        inv_in = pc.inv.prepare(modes)
        figures[label] = {
            "pc_fwd": (
                cuda_ms(lambda: pc.fwd.launch(*fwd_in), 50),
                cuda_ms(lambda: pc.fwd.body(*fwd_in), 20),
                cuda_ms(lambda: lib._arrow_solve(lib._forward(v), shift, t,
                                                 means, rho_diff), 20),
            ) + pc_bound("pc_fwd", grid),
            "pc_inv": (
                cuda_ms(lambda: pc.inv.launch(*inv_in), 50),
                cuda_ms(lambda: pc.inv.body(*inv_in), 20),
                cuda_ms(lambda: lib._inverse(modes), 20),
            ) + pc_bound("pc_inv", grid),
        }
        del states, lib, modes
    pitch_us, entry_us = figures.pop("pitch_copy")
    print("phase 11 pc kernels vs plain %d^2x3, %d^2x3, %dx%dx3 and "
          "%dx%dx3 (both also x2 and x4) (%s): %s | ms kernel/plain/library "
          "(3xTF32 bound, by; "
          "f32 SIMT bound): %s | %dx%dx3: pitched copy %.2f us of %.2f us "
          "device per entry call" % (
              N_BIG, N_AGG, RAGGED[0], RAGGED[1], RAGGED4[0], RAGGED4[1],
              card, "; ".join(lines),
              "; ".join("%s %s %.4f/%.4f/%.4f (%.4f, %s; %.4f)"
                        % ((lab, n) + f)
                        for lab, per in figures.items()
                        for n, f in per.items()),
              RAGGED4[0], RAGGED4[1], pitch_us, entry_us))
    figures["pitch_copy_us"] = {"shape": list(RAGGED4), "copy": pitch_us,
                                "entry_device": entry_us}
    return pc, errs, rel, figures


def chunk_numerics(pc_pallas, dt_max):
    """examples/aggregation2d's numerics block (-ts_type rosw,
    -ts_adapt_dt_max 10000, -ts_adapt_clip 0.1,5) as NumericsOptions
    fields, with dt_max then pinned to ``dt_max``."""
    import dataclasses

    from ksfd_tpu_torch import NumericsOptions

    flagship = NumericsOptions(ts_type="rosw", dt_max=1e4, clip_low=0.1,
                               clip_high=5.0, pc_pallas=pc_pallas)
    return dataclasses.replace(flagship, dt_max=dt_max)


def chunk_wrappers(chunk):
    """The kernel wrappers a chunk's tiers share, by name."""
    out = dict(chunk.kernels.kernels)
    if chunk.fused_pc is not None:
        out.update(chunk.fused_pc.kernels)
    return out


def run_chunk(chunk, u, t, h, accepts):
    """One chunk call from launch counts of 0: (its result, host seconds
    to the synchronised end, the launches by kernel)."""
    wrappers = chunk_wrappers(chunk)
    for k in wrappers.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = chunk(u, t, h, 1e30, accepts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, {name: k.launches for name, k in wrappers.items()}


#: accepted steps of the stiff figure's untimed spin-up (bench.py:332)
CHUNK_SPIN = 64


def phase_chunk(card, ops, grid, ps, kern, u_rough, pc_pallas):
    """make_adaptive_chunk_fn at the flagship's 1536^2 x 3 (aggregation2d's
    parameters and numerics), with the fused or the basis-GEMM pc.
    (a) smooth: the near-uniform state with dt_max pinned to h=1, every
    attempt accepted, ms per accepted step from the slope of 2 and 10
    accepts (min of 2).  (b) stiff: the rough state, an untimed spin-up
    of CHUNK_SPIN accepts from h=1e-3 with dt_max=2 (a top-tier
    rejection on the way is tolerated), then 2 and 10 accepts from h=2,
    which must escalate; ms per accepted step from their slope.  Launches
    per accepted step from the difference of the two runs' counts."""
    from ksfd_tpu_torch.solvers import make_adaptive_chunk_fn

    dev = torch.device("cuda")
    tag = "pc_pallas" if pc_pallas else "basis-GEMM pc"
    out = {}
    # (a) smooth
    chunk, _ = make_adaptive_chunk_fn(ops, chunk_numerics(pc_pallas, 1.0),
                                      atol=0.01, rtol=1e-6,
                                      max_attempts=4 * 14, kernels=kern)
    u0 = torch.as_tensor(initial_state(grid), device=dev)
    run_chunk(chunk, u0, 0.0, 1.0, 2)
    samples, counts = {2: [], 10: []}, {}
    for rep in range(2):
        for n in (2, 10):
            pert = 1e-9 * (3 + 2 * rep + (n == 10))
            (u, t, h, k, att, rej), secs, cnt = run_chunk(
                chunk, u0 * (1.0 + pert) + pert, 0.0, 1.0, n)
            check(k == att == n and not rej and t == float(n),
                  "smooth chunk %s: k=%d attempts=%d rejected=%s of %d"
                  % (tag, k, att, rej, n))
            check(bool(torch.isfinite(u).all()), "smooth chunk state finite")
            samples[n].append(secs)
            counts[n] = cnt
    out["smooth_ms"] = (min(samples[10]) - min(samples[2])) / 8 * 1e3
    out["smooth_per_accept"] = {n: (counts[10][n] - counts[2][n]) / 8
                                for n in counts[10]}
    out["smooth_counts"] = counts[10]
    smooth_line = ("(a) smooth h=1: %.4f ms/accept (2-accept %.4f s, "
                   "10-accept %.4f s), launches/accept %s" % (
                       out["smooth_ms"], min(samples[2]), min(samples[10]),
                       out["smooth_per_accept"]))
    del chunk
    # (b) stiff
    chunk, _ = make_adaptive_chunk_fn(ops, chunk_numerics(pc_pallas, 2.0),
                                      atol=0.01, rtol=1e-6,
                                      max_attempts=8 * (CHUNK_SPIN + 4),
                                      kernels=kern)
    (u1, t1, h1, k, spin_att, rej), spin_s, _ = run_chunk(
        chunk, u_rough, 0.0, 1e-3, CHUNK_SPIN)
    spin = chunk.stats
    check(k == CHUNK_SPIN and not rej,
          "stiff spin-up %s: k=%d attempts=%d rejected=%s (records %s)" % (
              tag, k, spin_att, rej, spin.records))
    top_rejects = sum(1 for tier, e, _ in spin.records
                      if tier == len(spin.tiers) - 1 and not e <= 1.0)
    runs, counts = {}, {}
    for n in (2, 10):
        (u, t, h, k, att, rej), secs, cnt = run_chunk(chunk, u1, t1, 2.0, n)
        check(k == n and not rej and bool(torch.isfinite(u).all()),
              "stiff chunk %s: k=%d attempts=%d rejected=%s of %d (records "
              "%s)" % (tag, k, att, rej, n, chunk.stats.records))
        runs[n] = (secs, att, chunk.stats)
        counts[n] = cnt
    secs10, att10, st10 = runs[10]
    check(att10 > 10, "stiff chunk %s: the escalation did not engage "
          "(attempts %d for 10 accepts)" % (tag, att10))
    out["stiff_ms"] = (secs10 - runs[2][0]) / 8 * 1e3
    out["stiff_per_accept"] = {n: (counts[10][n] - counts[2][n]) / 8
                               for n in counts[10]}
    out["stiff_counts"] = counts[10]
    out["stiff_attempts"] = att10
    out["stiff_per_tier"] = st10.per_tier
    print("phase 13 adaptive chunk %d^2x3 aggregation2d %s (%s): %s | (b) "
          "stiff: spin-up %d accepts in %d attempts (per tier %s, top-tier "
          "rejections %d, exit tier %d, h %.6g, t %.6g) %.2f s; 10 accepts "
          "from h=2 in %d attempts (per tier %s, exit tier %d, h %.6g), "
          "2 accepts in %d; %.4f ms/accept (2-accept %.4f s, 10-accept "
          "%.4f s, %.4f ms/accept of the 10-accept run), launches/accept %s"
          % (N_AGG, tag, card, smooth_line, CHUNK_SPIN, spin_att,
             spin.per_tier, top_rejects, spin.tier, h1,
             t1, spin_s, att10, st10.per_tier, st10.tier, h, runs[2][1],
             out["stiff_ms"], runs[2][0], secs10, secs10 / 10 * 1e3,
             out["stiff_per_accept"]))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chunk_records_%s.txt" % (
            "pc" if pc_pallas else "gemm")), "w") as fh:
        fh.write("%s\n(tier, enorm, h) per attempt, %d^2x3 %s\n" % (
            card, N_AGG, tag))
        for what, stats in (("spin-up", spin), ("10 accepts", st10)):
            fh.write("%s: %s\n" % (what, stats.records))
    return out


def phase_chunk_card_vs_cpu(card):
    """The chunk with the fused pc on the card and on the CPU (plain
    versions) at 128^2 x 3 of the flagship's spacing, from the rough
    state made once on the CPU at h=1e-3: 10 accepts within 30 attempts,
    which walk through all three tiers.  Same accepts, attempts and
    rejected flag; t and h within 1e-4 relative; u within 1e-4 of the
    CPU run's increment max|u - u0|.  On a mismatch both per-attempt
    records print before the failure."""
    from ksfd_tpu_torch.solvers import make_adaptive_chunk_fn

    n = N_CHUNK_CMP
    runs, state = {}, None
    for dev in ("cpu", "cuda"):
        ps, grid, ops = problem_from_clargs(agg2d_small_clargs(n), n, n,
                                            device=dev)
        if state is None:
            state = torch.as_tensor(rough_state(grid, ps))
        chunk, _ = make_adaptive_chunk_fn(ops, chunk_numerics(True, 1e4),
                                          atol=0.01, rtol=1e-6,
                                          max_attempts=30)
        u, t, h, k, att, rej = chunk(state.to(dev), 0.0, 1e-3, 1e30, 10)
        launches = {name: w.launches
                    for name, w in chunk_wrappers(chunk).items()}
        runs[dev] = (u.cpu(), t, h, k, att, rej, chunk.stats, launches)
    (uc, tc, hc, kc, ac, rc, sc_, _), (ug, tg, hg, kg, ag, rg, sg, lg) = (
        runs["cpu"], runs["cuda"])
    inc = float((uc - state).abs().max())
    dev_abs = float((ug - uc).abs().max())
    same = ((kg, ag, rg) == (kc, ac, rc) and abs(tg - tc) <= 1e-4 * abs(tc)
            and abs(hg - hc) <= 1e-4 * abs(hc) and dev_abs <= 1e-4 * inc)
    if not same:
        print("phase 14 records cpu: %s" % sc_.records)
        print("phase 14 records cuda: %s" % sg.records)
    check(same, "chunk card vs cpu: k %d/%d attempts %d/%d rejected %s/%s "
          "t %.9g/%.9g h %.9g/%.9g max dev %.3e of increment %.3e" % (
              kg, kc, ag, ac, rg, rc, tg, tc, hg, hc, dev_abs, inc))
    check(kc == 10 and not rc and lg["pc_fwd"] > 0 and lg["resid"] > 0,
          "chunk card vs cpu delivered its accepts through the kernels")
    print("phase 14 chunk card vs cpu %d^2x3 (flagship spacing) pc_pallas "
          "rough h0=1e-3 (%s): k %d, attempts %d (per tier cuda %s, cpu %s), "
          "rejected %s; t %.9g vs %.9g, h %.9g vs %.9g; max dev %.3e, "
          "increment %.6e, dev/inc %.3e; card launches %s" % (
              n, card, kg, ag, sg.per_tier, sc_.per_tier, rg, tg, tc, hg, hc,
              dev_abs, inc, dev_abs / inc, lg))


#: the probe's sweeps per timed chain and repeats (probe_coeff_kernel)
PROBE_SWEEPS = 64
PROBE_REPEATS = 3


def phase_coeff_kernel(card):
    """B11 (the coefficient-field resid, ksfd_coeff_resid) at 1024^2 x 3
    on the probe's state (ksfd_tpu_torch/tools/probe_coeff_kernel.py):
    against its plain version (1e-5 of max|plain|) and against B1 on the
    same (u, v, b) (relative deviation < 1e-5, the probe's assert);
    CUDA-event µs per launch of each and of its plain version, the
    probe's slope µs/sweep of both chains, the bounds and the ms of
    ``prepare``.  Launches counted from 0 before the probe's run."""
    from ksfd_tpu_torch.tools.probe_coeff_kernel import (
        build_coeff_resid,
        run as probe_run,
    )

    dev = torch.device("cuda")
    ps, grid, ops = problem_from_clargs(bench_clargs(N_BIG), N_BIG, N_BIG,
                                        device=dev)
    kern = make_fused_kernels(ops)
    b11 = kern.coeff_resid
    b11.launches = kern.resid.launches = 0
    res, (C, u32, v, b), _ = probe_run(N_BIG, PROBE_SWEEPS, PROBE_REPEATS,
                                       dev, ops=ops, kern=kern)
    torch.cuda.synchronize()
    launches = b11.launches
    check(res["rel_dev"] < 1e-5, "B11 vs B1 rel dev %.3e" % res["rel_dev"])
    t, shift = 0.5, 37.0
    out = b11(C, v, b, t, shift)
    ref = b11.plain(C, v, b, t, shift)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(out).all()), "B11 finite")
    check(err <= 1e-5 * scale, "B11 vs plain: max err %.3e > 1e-5 * %.3e"
          % (err, scale))
    # other field counts, on the tile's ragged edges
    fields = []
    for dof in FIELDS2:
        ps_f, kern_f, grid_f, states = fields_case(dof)
        prep_f, b11_f = build_coeff_resid(kern_f.build.ops, kern_f)
        u_f = states["rough_%dfields" % dof]
        gen = torch.Generator(device=dev).manual_seed(23 + dof)
        v_f = torch.randn(tuple(grid_f.Vshape), generator=gen, device=dev)
        b_f = torch.randn(tuple(grid_f.Vshape), generator=gen, device=dev)
        C_f = prep_f(u_f, t)
        got, want = b11_f(C_f, v_f, b_f, t, shift), b11_f.plain(
            C_f, v_f, b_f, t, shift)
        torch.cuda.synchronize()
        e_f = float((got - want).abs().max())
        check(e_f <= 1e-5 * float(want.abs().max()), "B11 %d fields vs "
              "plain: max err %.3e" % (dof, e_f))
        fields.append("%d fields %.3e" % (dof, e_f))
    prepare, _ = build_coeff_resid(ops, kern)
    u64 = u32.double()
    p11 = b11.prepare(C, v, b, t, shift)
    p1 = kern.resid.prepare(u32, v, b, t, shift)
    ms = {
        "coeff_resid": (cuda_ms(lambda: b11.launch(*p11), 200),
                        cuda_ms(lambda: b11.body(*p11), 20)),
        "resid": (cuda_ms(lambda: kern.resid.launch(*p1), 200),
                  cuda_ms(lambda: kern.resid.body(*p1), 20)),
    }
    prepare_ms = cuda_ms(lambda: prepare(u64, t), 20)
    bounds = {n: kernel_bound(n, kern.build) for n in ms}
    print("phase 15 B11 coeff-field resid %d^2x3 (%s): vs plain err %.3e "
          "(%.2e rel); at %dx%d with %s; vs B1 rel dev %.3e | us/launch "
          "kernel/plain: B11 "
          "%.3f/%.1f, B1 %.3f/%.1f, B1/B11 %.4f | bound us: B11 %.3f (%s), "
          "B1 %.3f (%s) | slope us/sweep (%d sweeps, min of %d): B1 %.3f, "
          "B11 %.3f, B1/B11 %.4f | prepare %.4f ms | probe launches %d" % (
              N_BIG, card, err, err / scale, RAGGED[0], RAGGED[1],
              ", ".join(fields), res["rel_dev"],
              ms["coeff_resid"][0] * 1e3, ms["coeff_resid"][1] * 1e3,
              ms["resid"][0] * 1e3, ms["resid"][1] * 1e3,
              ms["resid"][0] / ms["coeff_resid"][0],
              bounds["coeff_resid"][0] * 1e3, bounds["coeff_resid"][1],
              bounds["resid"][0] * 1e3, bounds["resid"][1], PROBE_SWEEPS,
              PROBE_REPEATS, res["production_us"], res["coeff_us"],
              res["speedup"], prepare_ms, launches))
    return dict(kern=kern, err=err, rel=err / scale, ms=ms["coeff_resid"],
                bound=bounds["coeff_resid"], launches=launches, probe=res,
                prepare_ms=prepare_ms)


#: members of the batched-kernel phase
NB = 4


def batched_cases(ops, gen, nb, base):
    """(name, per-member argument tuples) of the four stencil kernels
    for nb distinct members: the rough state ``base`` (f64 on the card)
    scaled member by member, their own tangents, right-hand sides and
    increments, and their own t and shift (0-d tensors, so each member's
    scalar pack differs)."""
    dev = torch.device("cuda")
    shape = tuple(ops.grid.Vshape)
    randn = lambda: torch.randn(shape, generator=gen, device=dev,
                                dtype=torch.float64)
    cases = {n: [] for n in ("rhs", "jvp", "resid", "delta")}
    for i in range(nb):
        u64 = ops.groom(base * (1.0 + 0.05 * i) + 10.0 * randn())
        u = u64.float()
        t = torch.full((), 0.1 * i, dtype=torch.float64, device=dev)
        shift = torch.full((), (1.0 + i) / GAMMA, dtype=torch.float64,
                           device=dev)
        v, b = randn().float(), randn().float()
        u1 = ops.groom(u64 + 100.0 * randn())
        cases["rhs"].append((u, t.float()))
        cases["jvp"].append((u, v, t))
        cases["resid"].append((u, v, b, t, shift))
        cases["delta"].append((u64, u1 - u64, u1, t))
    return cases


def hold_batched(k, per):
    """One kernel's NB members ``per`` (argument tuples) under
    ``torch.func.vmap``: one launch (counted once), equal bit for bit
    to the NB single launches and within 1e-5 of max|plain| of the plain
    version under vmap.  Returns (max err, scale)."""
    from torch.func import vmap

    stacked = [torch.stack(xs) for xs in zip(*per)]
    singles = [k(*args) for args in per]
    n0 = k.launches
    out = vmap(k)(*stacked)
    torch.cuda.synchronize()
    check(k.launches == n0 + 1, "%s under vmap launched %d times"
          % (k.name, k.launches - n0))
    ref = vmap(k.plain)(*stacked)
    check(all(torch.equal(out[i], singles[i]) for i in range(NB)),
          "%s batched launch equals %d single launches bit for bit"
          % (k.name, NB))
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    check(err <= 1e-5 * scale, "%s batched vs plain: %.3e > 1e-5 * %.3e"
          % (k.name, err, scale))
    return err, scale


def phase_batched_kernels(card, kern, base, phase, tag, reps=100,
                          fields=()):
    """The member-batched builds of the four stencil kernels of ``kern``
    (B1, B2, B3 and B7 in 2D; B6a-d in 3D) at the problem's size for NB
    distinct members made from ``base``: one launch under
    ``torch.func.vmap`` (counted once) equal bit for bit to the NB
    single launches and within 1e-5 of max|plain| of the plain version
    under vmap; CUDA-event µs of one batched launch against NB single
    launches and the bound of NB members; ptxas registers and spills of
    the entries.  ``fields``: other field counts held (not timed) at
    RAGGED, the march's ragged strip and x chunk (2D)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    cases = batched_cases(kern.build.ops, gen, NB, base)
    lines, figures, errs = [], {}, {}
    for name in list(cases):
        # one kernel's members at a time (at 256^3 each holds GBs)
        per = cases.pop(name)
        k = kern.kernels[name]
        err, scale = hold_batched(k, per)
        errs[name] = (err, err / scale)
        prepared = [k.prepare(*args) for args in per]
        sc_b = torch.stack([p[0] for p in prepared])
        ops_b = [torch.stack(xs) for xs in zip(*[p[1] for p in prepared])]
        check(torch.equal(k.launch(sc_b, ops_b),
                          torch.stack([k(*args) for args in per])),
              "%s prepared batched launch equals the vmapped one" % name)

        def four():
            for sc, operands in prepared:
                k.launch(sc, operands)

        figures[name] = (cuda_ms(lambda: k.launch(sc_b, ops_b), reps),
                         cuda_ms(four, reps),
                         kernel_bound(name, kern.build, NB))
        lines.append("%s bitwise equal, vs plain %.3e (%.2e rel)" % (
            name, err, err / scale))
        del per, prepared, sc_b, ops_b
    for dof in fields:
        _, kern_f, _, states = fields_case(dof)
        for name, per in batched_cases(
                kern_f.build.ops, gen, NB,
                states["rough_%dfields" % dof]).items():
            err, scale = hold_batched(kern_f.kernels[name], per)
            lines.append("%dx%dx%d %s bitwise equal, vs plain %.2e rel" % (
                RAGGED + (dof, name, err / scale)))
    ptxas = ptxas_summary(kern.build.build_info["ptxas"])
    print("phase %d batched kernels %s nb=%d (%s): %s | us batched "
          "launch / %d single launches (bound us x%d, the batched launch's "
          "share of it): %s | ptxas: %s" % (
              phase, tag, NB, card, "; ".join(lines), NB, NB, "; ".join(
                  "%s %.3f/%.3f (%.3f, %.3f)" % (
                      n, a * 1e3, b_ * 1e3, bd[0] * 1e3, bd[0] / a)
                  for n, (a, b_, bd) in figures.items()), ptxas))
    return figures, errs


def phase_batched_pc(card):
    """B5a/B5b batched at 1024^2 x 3 for NB distinct members (rough
    states scaled member by member, the scalar packs of their own steps
    at h = 1 + i, their own v): one launch of each entry under
    ``torch.func.vmap`` (counted once) equal bit for bit to the NB single
    launches and within 1e-5 of max|plain| of the plain version under
    vmap; CUDA-event µs of one batched launch against NB single
    launches, and the bound of NB members."""
    from torch.func import vmap

    from ksfd_tpu_torch.ops.fused_pc import make_fused_block_pc

    dev = torch.device("cuda")
    ps, grid, ops = problem_from_clargs(bench_clargs(N_BIG), N_BIG, N_BIG,
                                        device=dev)
    pc = make_fused_block_pc(grid, ops)
    gen = torch.Generator(device=dev).manual_seed(19)
    base = torch.as_tensor(rough_state(grid, ps), device=dev)
    scs, vs = [], []
    for i in range(NB):
        scs.append(pc_step_scalars(ops, base * (1.0 + 0.05 * i),
                                   h=1.0 + i)[-1])
        vs.append(torch.randn(tuple(grid.Vshape), generator=gen, device=dev))
    sc_b, v_b = torch.stack(scs), torch.stack(vs)
    modes = [pc.fwd(scs[i], vs[i]) for i in range(NB)]
    modes_b = torch.stack(modes)
    lines, figures, errs = [], {}, {}
    for k, args, singles in ((pc.fwd, (sc_b, v_b), modes),
                             (pc.inv, (modes_b,),
                              [pc.inv(m) for m in modes])):
        n0 = k.launches
        out = vmap(k)(*args)
        torch.cuda.synchronize()
        check(k.launches == n0 + 1, "%s under vmap launched %d times"
              % (k.name, k.launches - n0))
        check(all(torch.equal(out[i], singles[i]) for i in range(NB)),
              "%s batched launch equals %d single launches bit for bit"
              % (k.name, NB))
        ref = vmap(k.plain)(*args)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        check(err <= 1e-5 * scale, "%s batched vs plain: %.3e > 1e-5 * %.3e"
              % (k.name, err, scale))
        errs[k.name] = (err, err / scale)
        single_args = [[x[i] for x in args] for i in range(NB)]

        def four():
            for a in single_args:
                k.launch(*a)

        figures[k.name] = (cuda_ms(lambda: k.launch(*args), 50),
                           cuda_ms(four, 50), pc_bound(k.name, grid, NB))
        lines.append("%s bitwise equal, vs plain %.3e (%.2e rel)" % (
            k.name, err, err / scale))
    # other field counts at RAGGED (not timed)
    for dof in FIELDS2:
        _, kern_f, grid_f, states = fields_case(dof)
        ops_f = kern_f.build.ops
        pc_f = make_fused_block_pc(grid_f, ops_f)
        base_f = states["rough_%dfields" % dof]
        per_fwd = [(pc_step_scalars(ops_f, base_f * (1.0 + 0.05 * i),
                                    h=1.0 + i)[-1],
                    torch.randn(tuple(grid_f.Vshape), generator=gen,
                                device=dev)) for i in range(NB)]
        per_inv = [(pc_f.fwd(*a),) for a in per_fwd]
        for k, per in ((pc_f.fwd, per_fwd), (pc_f.inv, per_inv)):
            err, scale = hold_batched(k, per)
            lines.append("%dx%dx%d %s bitwise equal, vs plain %.2e rel" % (
                RAGGED + (dof, k.name, err / scale)))
    print("phase 21 batched pc kernels %d^2x3 nb=%d (and %dx%dx%s fields) "
          "(%s): %s | us batched launch / %d single launches (bound us x%d, "
          "by): %s" % (
              N_BIG, NB, RAGGED[0], RAGGED[1],
              "/".join(map(str, FIELDS2)), card, "; ".join(lines), NB, NB,
              "; ".join(
                  "%s %.3f/%.3f (%.3f, %s)" % (n, a * 1e3, b_ * 1e3,
                                               bd[0] * 1e3, bd[1])
                  for n, (a, b_, bd) in figures.items())))
    return figures, errs


def ensemble_members(base, n, seed=0):
    """n members ``base * (1 + 1e-4 N(0,1))`` (tools/ensemble_bench.py:
    71-78), one numpy generator for all."""
    rng = np.random.default_rng(seed)
    return np.stack([base * (1.0 + 1e-4 * rng.standard_normal(base.shape))
                     for _ in range(n)])


def profile_device_ms(fn, steps):
    """Device ms per step of ``fn()`` (which runs ``steps`` steps) from a
    torch.profiler trace of the card alone (no host events, which cost
    seconds on a vmapped block): the sum of the card's kernel times, and
    the same per kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda_dev = torch.autograd.DeviceType.CUDA
    per_kernel = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != cuda_dev:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        dt = ev.self_cuda_time_total if dt is None else dt
        per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + dt / 1e3 / steps
    return sum(per_kernel.values()), per_kernel


def phase_ensemble_fixed(card, clargs, shape, runs, phase, pc_pallas=False,
                         reps=3, member_check=("f64", 4)):
    """The ensemble's fixed-dt path at ``shape`` x 3 (the main path's
    problem and near-uniform state, members base * (1 + 1e-4 N(0,1))):
    EnsembleSolver with block_steps, whose vmapped make_multistep_fn runs
    every member's steps through one batched launch per kernel call
    (with ``pc_pallas``, the fused pc's too).  For each (precision, N) of
    ``runs``: one solve() of a 2-step block, the exact launches per
    ensemble step (8 resid + 4 delta, or 4 rhs + 8 jvp, and 12 + 12 pc
    launches with the fused pc: the same for every N, with no operand
    broadcast to the members) from 2- and 10-step blocks counted from
    0, ms per ensemble step from their slope
    (min of ``reps``), per-member ms, DOF-updates/s, the busy share and
    the device ms by group from a profiled 2-step block (with the fused
    pc it must hold no library GEMM), and the peak device memory of the
    timed blocks.  Each member of ``member_check`` against its own
    single-member make_multistep_fn run: 2 steps at h = 1e-2 within
    1e-5 of the increment (the batched products and reductions round
    apart from the single ones), and the same at the timed h = 1
    printed."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.solvers import EnsembleSolver, make_multistep_fn

    dev = torch.device("cuda")
    ps, grid, ops = problem_from_clargs(clargs, *shape, device=dev)
    kern = make_fused_kernels(ops)
    base = initial_state(grid)
    figures, lines = {}, []
    tag = "x".join(str(n) for n in shape) + "x3"
    for prec, n in runs:
        fast32 = prec == "f32"
        nm = NumericsOptions(adapt_type="none", precision="float32"
                             if fast32 else "float64", pc_pallas=pc_pallas)
        per_step = (dict(rhs=4, jvp=8, resid=0, delta=0) if fast32
                    else dict(rhs=0, jvp=0, resid=8, delta=4))
        if pc_pallas:
            per_step.update(pc_fwd=12, pc_inv=12)
        es = EnsembleSolver(ops, nm, t0=0.0, dt=1.0, tmax=1e9, maxsteps=2,
                            rtol=1e-6, atol=0.01, block_steps=2,
                            kernels=kern)
        U0 = torch.as_tensor(ensemble_members(base, n), device=dev)
        out = es.solve(U0)
        check((out.k == 2).all() and not out.diverged.any()
              and bool(torch.isfinite(out.u).all()),
              "ensemble %s %s N=%d solve: k %s" % (tag, prec, n, out.k))
        del out
        wrappers = dict(kern.kernels)
        if pc_pallas:
            wrappers.update(es.fused_pc.kernels)
        ts = torch.zeros(n, dtype=torch.float64, device=dev)
        hs = torch.ones(n, dtype=torch.float64, device=dev)
        counts, samples = {}, {2: [], 10: []}
        for nst in (2, 10):
            for k in wrappers.values():
                k.launches = k.broadcasts = 0
            _, _, emax = es._vmulti(U0, ts, hs, nst)
            torch.cuda.synchronize()
            counts[nst] = {name: k.launches for name, k in wrappers.items()}
            check(counts[nst] == {k: nst * c for k, c in per_step.items()},
                  "ensemble %s %s N=%d launch counts %s for %d steps"
                  % (tag, prec, n, counts[nst], nst))
            # every operand of every kernel call is per member: the vmap
            # rule copies none of them to the members
            check(not any(k.broadcasts for k in wrappers.values()),
                  "ensemble %s %s N=%d: unbatched kernel operands %s" % (
                      tag, prec, n, {name: k.broadcasts
                                     for name, k in wrappers.items()}))
            check(bool(torch.isfinite(emax).all()), "ensemble emax finite")
        torch.cuda.reset_peak_memory_stats()
        for rep in range(reps):
            for nst in (2, 10):
                pert = (1e-6 if fast32 else 1e-9) * (1 + 2 * rep
                                                     + (nst == 10))
                Up = U0 * (1.0 + pert) + pert
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                es._vmulti(Up, ts, hs, nst)
                torch.cuda.synchronize()
                samples[nst].append(time.perf_counter() - t0)
                del Up
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step_s = (min(samples[10]) - min(samples[2])) / 8
        device_ms, per_kernel = profile_device_ms(
            lambda: es._vmulti(U0, ts, hs, 2), 2)
        groups = device_groups(per_kernel)
        if pc_pallas:
            check(groups["pc kernels"] > 0 and not library_gemms(per_kernel),
                  "the pc_pallas ensemble runs the pc kernels and no library "
                  "GEMM: %s" % library_gemms(per_kernel))
        figures[prec, n] = dict(
            ms=step_s * 1e3, member_ms=step_s * 1e3 / n,
            rate=n * grid.n_dofs / step_s, device_ms=device_ms,
            device_member_ms=device_ms / n,
            busy=device_ms / (step_s * 1e3), peak_gb=peak_gb,
            device_groups=groups, per_step=per_step,
            launches={k: counts[2][k] + counts[10][k] for k in counts[2]})
        lines.append("%s N=%d: %.4f ms/ens step (2-block %.4f s, 10-block "
                     "%.4f s), %.4f ms/member, %.6e DOF-updates/s, device "
                     "%.4f ms/ens step (%.4f per member, busy %.3f; %s), "
                     "peak %.3f GB, launches/step %s" % (
                         prec, n, step_s * 1e3, min(samples[2]),
                         min(samples[10]), step_s * 1e3 / n,
                         n * grid.n_dofs / step_s, device_ms, device_ms / n,
                         device_ms / (step_s * 1e3),
                         ", ".join("%s %.4f" % kv for kv in groups.items()),
                         peak_gb, {k: c // 10 for k, c in counts[10].items()}))
        if (prec, n) == member_check:
            multi, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6,
                                         kernels=kern)
            devs = {}
            for h in (1e-2, 1.0):
                hs_h = torch.full((n,), h, dtype=torch.float64, device=dev)
                ue, _, _ = es._vmulti(U0, ts, hs_h, 2)
                worst = 0.0
                for i in range(n):
                    ui, _, _ = multi(U0[i], ts[i], hs_h[i], 2)
                    inc = float((ui - U0[i]).abs().max())
                    worst = max(worst, float((ue[i] - ui).abs().max()) / inc)
                    del ui
                devs[h] = worst
                del ue
            check(devs[1e-2] <= 1e-5, "ensemble members vs single runs at "
                  "h=1e-2: %.3e of the increment" % devs[1e-2])
            lines.append("%s N=%d members vs their single runs (2 steps): "
                         "%.3e of the increment at h=1e-2, %.3e at h=1"
                         % (prec, n, devs[1e-2], devs[1.0]))
        del es, U0
    print("phase %d ensemble fixed-dt %s%s h=1 (%s): %s" % (
        phase, tag, " pc_pallas" if pc_pallas else "", card,
        " | ".join(lines)))
    return figures


def hex_starts(grid, n, seed):
    """n pointwise noisy uniform starts 9000 + 90 N(0,1) per field and
    point, member i from numpy seed seed + i (phase 28's; phases 18, 24
    and 30 start from ic.start_values, ic_starts)."""
    return np.stack([
        9000.0 + 90.0 * np.random.default_rng(seed + i).standard_normal(
            tuple(grid.Vshape))
        for i in range(n)])


def ic_starts(clargs, grid, ps, n, seed):
    """n fresh starts of ``ic.start_values`` (the problem's srho0 field
    on its coarse randgrid plus rho0, the ligands given or at their
    local steady state), member i drawn from the process Generator
    seeded ``seed + i``, made on the CPU: numpy (n, dof, *Sshape)."""
    from ksfd_tpu_torch import ic
    from ksfd_tpu_torch.randomfield import Generator

    out = []
    for i in range(n):
        Generator(seed + i)
        u, _ = ic.start_values(clargs, grid, ps, device="cpu")
        out.append(u.numpy())
    return np.stack(out)


#: accepted steps per member of phase 18's run
HEX_STEPS = 24
#: accepted steps per member of phase 18's two-tier device-loop run
TIER_STEPS = 8


def zero_launches(kern):
    for k in kern.kernels.values():
        k.launches = 0


def launch_counts(kern):
    return {name: k.launches for name, k in kern.kernels.items()}


def tier_signatures(es, U1):
    """Each device-loop tier step's launches per call (one call of its
    vmapped build on the one-member batch U1): a call launches each
    batched kernel once, whatever its member count."""
    c = es._chunk
    dev = U1.device
    t = torch.zeros(1, dtype=torch.float64, device=dev)
    h = torch.full((1,), 1e-8, dtype=torch.float64, device=dev)
    sig = []
    for step in c.steps:
        args = (U1, t, h) + ((c.rhs0(U1, t),) if c.chain else ())
        zero_launches(es.kernels)
        step(*args)
        torch.cuda.synchronize()
        sig.append(launch_counts(es.kernels))
    return sig


def count_tier_calls(es):
    """Wrap the device loop's tier steps; returns the per-tier calls."""
    calls = [0] * len(es._chunk.steps)
    for tier, step in enumerate(list(es._chunk.steps)):
        def counted(*args, _tier=tier, _step=step):
            calls[_tier] += 1
            return _step(*args)
        es._chunk.steps[tier] = counted
    return calls


def forced_escalation(step):
    """``step`` (a tier step, vmapped or not) whose first call reports a
    finite rejection (enorm 1e3) for its first member, which then
    retries the same h one tier up."""
    first = [True]

    def wrapped(*args):
        out = step(*args)
        if not first[0]:
            return out
        first[0] = False
        e = out[1].clone()
        e.reshape(-1)[0] = 1e3
        return (out[0], e) + tuple(out[2:])

    return wrapped


def check_device_loop(es, calls, sig, launches, label):
    """The tier steps ran once per attempt per occupied tier (the
    dispatch records against the wrapped steps' calls) and the kernels'
    launches are those calls' launches (the GMRES retry and the fresh
    f0 launch no stencil kernel)."""
    tot = es._chunk.totals
    occupied = tot.occupied
    check(sum(calls) == occupied and tot.calls == calls,
          "%s: tier-step calls %s, %d occupied tier-attempts, records %s"
          % (label, calls, occupied, tot.calls))
    want = {n: sum(c * sg[n] for c, sg in zip(calls, sig)) for n in launches}
    check(launches == want, "%s: launches %s, tier calls x per-call launches"
          " %s" % (label, launches, want))
    return occupied


def phase_ensemble_adaptive(card):
    """EnsembleSolver adaptive on examples/hexagons2d's parameters and
    numerics at its own 384^2 x 3, 4 members from ic.start_values
    (srho0=90 on a 96^2 randgrid, member i seeded seed + i: ic_starts),
    dt=1e-8, HEX_STEPS accepts each: first per step (device_loop off),
    then with the device loop (``device_loop=True``: per attempt one
    vmapped tier step per occupied tier).  Per member the accepts,
    rejections, fallback rescues and steps, the t and h range, ms per
    accepted ensemble step and dispatches per accept of each loop.  The
    device loop must reach HEX_STEPS for every member, run its tier
    steps once per attempt per occupied tier with the launches those
    calls make, and give each member the k, t and h of the port's
    single-member chunk (make_adaptive_chunk_fn, max_attempts 128) on
    that member alone, u within 1e-5 of max|u|; t and h to 1e-4
    relative, as phase 14 holds the chunk's card against the CPU: the
    pc's batched cuBLAS products round apart from the single ones in
    the last float32 bits, the float32 sweeps carry that into each
    embedded error norm (a cancelling sum), and h compounds it over the
    accepts (1.7e-5 measured).  On the CPU, where a batched call runs
    each member's plain version, they are equal
    (tests/test_torch_ensemble_chunk.py).  Then the device loop on two
    tiers at once (rich3 escalating to rich16 and cheb48, TIER_STEPS
    accepts each, member 0's first attempt forced to a finite
    rejection, so it escalates while the others stay): the tier calls
    and launches checked as above, more tier calls than host reads, and
    each member against its own chunk (member 0's forced alike).  Then
    one forced fallback (the fast step fails for member 0
    once, as tests/test_ensemble.py:493-562 stages it), so the float64
    GMRES step runs on the card: member 0 is rescued and stays on it;
    and the GMRES step alone, timed."""
    from ksfd_tpu_torch.solvers import EnsembleSolver, make_adaptive_chunk_fn

    dev = torch.device("cuda")
    clargs = hex_clargs()
    ps, grid, ops = problem_from_clargs(clargs, N_HEX, N_HEX, device=dev)
    kern = make_fused_kernels(ops)
    U0 = ic_starts(clargs, grid, ps, 4, clargs.seed)
    kw = dict(t0=0.0, dt=float(ps.params0["dt"]),
              tmax=float(ps.params0["tmax"]), rtol=float(ps.params0["rtol"]),
              atol=float(ps.params0["atol"]), kernels=kern)
    # warm both loops up (the first vmapped calls), untimed
    for dl in (False, True):
        EnsembleSolver(ops, hex_numerics(device_loop=dl), maxsteps=2,
                       **kw).solve(U0)
    es = EnsembleSolver(ops, hex_numerics(), maxsteps=HEX_STEPS, **kw)
    hs_seen = []
    es.add_monitor(lambda es, ks, ts, U: hs_seen.append(es.hs.copy()))
    zero_launches(kern)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = es.solve(U0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts(kern)
    check((out.k == HEX_STEPS).all() and not out.diverged.any()
          and bool(torch.isfinite(out.u).all()),
          "hexagons2d ensemble: k %s diverged %s" % (out.k, out.diverged))
    check(launches["resid"] > 0 and launches["delta"] > 0,
          "hexagons2d ensemble ran through the kernels: %s" % launches)
    hs = np.array(hs_seen)
    members = "; ".join(
        "m%d: k %d, rejections %d, fallback rescues %d, t %.6g, h "
        "%.3g..%.3g" % (i, out.k[i], out.snes_failures[i], es.rescues[i],
                        out.t[i], hs[:, i].min(), hs[:, i].max())
        for i in range(4))
    natural = dict(iterations=es.iterations, secs=secs, launches=launches,
                   k=out.k.tolist(), rejections=out.snes_failures.tolist(),
                   rescues=es.rescues.tolist(),
                   ms_per_accept=secs / HEX_STEPS * 1e3,
                   dispatches_per_accept=es.iterations / HEX_STEPS)

    # the device loop
    esd = EnsembleSolver(ops, hex_numerics(device_loop=True),
                         maxsteps=HEX_STEPS, **kw)
    esd._build_steps()
    sig = tier_signatures(esd, esd._vgroom(torch.as_tensor(U0[:1],
                                                           device=dev)))
    calls = count_tier_calls(esd)
    zero_launches(kern)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outd = esd.solve(U0)
    torch.cuda.synchronize()
    dsecs = time.perf_counter() - t0
    dlaunches = launch_counts(kern)
    check((outd.k == HEX_STEPS).all() and not outd.diverged.any()
          and bool(torch.isfinite(outd.u).all()),
          "hexagons2d device loop: k %s diverged %s" % (outd.k,
                                                         outd.diverged))
    occupied = check_device_loop(esd, calls, sig, dlaunches,
                                 "hexagons2d device loop")
    dispatches = esd._chunk.totals.dispatches
    chunk, _ = make_adaptive_chunk_fn(ops, hex_numerics(), atol=kw["atol"],
                                      rtol=kw["rtol"], max_attempts=128,
                                      kernels=kern)
    devs = []
    for i in range(4):
        ui = ops.groom(torch.as_tensor(U0[i], device=dev))
        u1, t1, h1, k1, _, _ = chunk(ui, 0.0, kw["dt"], kw["tmax"],
                                     HEX_STEPS)
        trel = abs(t1 - outd.t[i]) / abs(t1)
        hrel = abs(h1 - outd.h[i]) / abs(h1)
        udev = float((u1 - outd.u[i]).abs().max() / u1.abs().max())
        check(k1 == outd.k[i] and trel <= 1e-4 and hrel <= 1e-4
              and udev <= 1e-5,
              "device loop member %d vs its own chunk: k %d/%d, t %.3e h "
              "%.3e rel, u %.3e of max|u|" % (i, outd.k[i], k1, trel, hrel,
                                              udev))
        devs.append((trel, hrel, udev))
    # two tiers at once: rich3 escalating to rich16 and cheb48, member
    # 0's first tier-0 attempt forced to a finite rejection, so that it
    # escalates while the others stay on tier 0
    nm2 = dataclasses.replace(hex_numerics(device_loop=True), ksp_iters=3)
    es2 = EnsembleSolver(ops, nm2, maxsteps=TIER_STEPS, **kw)
    es2._build_steps()
    sig2 = tier_signatures(es2, esd._vgroom(torch.as_tensor(U0[:1],
                                                            device=dev)))
    calls2 = count_tier_calls(es2)
    es2._chunk.steps[0] = forced_escalation(es2._chunk.steps[0])
    zero_launches(kern)
    out2 = es2.solve(U0)
    launches2 = launch_counts(kern)
    check((out2.k == TIER_STEPS).all() and not out2.diverged.any()
          and bool(torch.isfinite(out2.u).all()),
          "two-tier device loop: k %s diverged %s" % (out2.k, out2.diverged))
    check_device_loop(es2, calls2, sig2, launches2, "two-tier device loop")
    tot2 = es2._chunk.totals
    check(len(es2._chunk.tiers) > 1 and calls2[1] > 0
          and tot2.occupied > tot2.reads,
          "two-tier device loop: tier calls %s in %d reads" % (calls2,
                                                               tot2.reads))
    chunk2, _ = make_adaptive_chunk_fn(ops, nm2, atol=kw["atol"],
                                       rtol=kw["rtol"], max_attempts=128,
                                       kernels=kern)
    plain0 = chunk2.steps[0]
    devs2 = []
    for i in range(4):
        chunk2.steps[0] = forced_escalation(plain0) if i == 0 else plain0
        ui = ops.groom(torch.as_tensor(U0[i], device=dev))
        u1, t1, h1, k1, _, _ = chunk2(ui, 0.0, kw["dt"], kw["tmax"],
                                      TIER_STEPS)
        d = (abs(t1 - out2.t[i]) / abs(t1), abs(h1 - out2.h[i]) / abs(h1),
             float((u1 - out2.u[i]).abs().max() / u1.abs().max()))
        check(k1 == out2.k[i] and d[0] <= 1e-4 and d[1] <= 1e-4
              and d[2] <= 1e-5,
              "two-tier device loop member %d vs its own chunk: k %d/%d, "
              "t %.3e h %.3e rel, u %.3e of max|u|" % ((i, out2.k[i], k1)
                                                       + d))
        devs2.append(d)
    two_tier = dict(tier_calls=calls2, reads=tot2.reads,
                    attempts=tot2.attempts, launches=launches2,
                    max_rel_dev_vs_own_chunk=[max(d) for d in zip(*devs2)])
    device = dict(dispatches=dispatches, secs=dsecs, launches=dlaunches,
                  k=outd.k.tolist(),
                  rejections=outd.snes_failures.tolist(),
                  rescues=esd.rescues.tolist(), tier_calls=calls,
                  attempts=esd._chunk.totals.attempts,
                  ms_per_accept=dsecs / HEX_STEPS * 1e3,
                  dispatches_per_accept=dispatches / HEX_STEPS,
                  max_rel_dev_vs_own_chunk=[max(d) for d in zip(*devs)],
                  two_tier=two_tier)

    # the forced fallback: member 0's first fast step fails, its robust
    # retry runs (and is taken as accepted)
    es = EnsembleSolver(ops, hex_numerics(), maxsteps=3, **kw)
    es._build_steps()
    step, fb = es._vstep, es._get_fallback()
    forced = {"step": True, "fb": True}

    def wstep(u, t, h):
        u1, e = step(u, t, h)
        if forced["step"]:
            forced["step"] = False
            e = e.clone()
            e[0] = float("inf")
        return u1, e

    def wfb(u, t, h):
        u1, e = fb(u, t, h)
        if forced["fb"]:
            forced["fb"] = False
            fb_e.append(float(e))
            e = torch.full_like(e, 0.5)
        return u1, e

    fb_e = []
    es._vstep, es._fallback = wstep, wfb
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2 = es.solve(U0)
    torch.cuda.synchronize()
    fsecs = time.perf_counter() - t0
    check(es.rescues[0] == 1 and es._fbm[0] and (out2.k == 3).all()
          and bool(torch.isfinite(out2.u).all()),
          "forced fallback: rescues %s fbm %s k %s" % (es.rescues, es._fbm,
                                                       out2.k))
    # the GMRES step alone, on member 0's start
    u_fb = ops.groom(torch.as_tensor(U0[0], device=dev))
    t_fb = torch.zeros((), dtype=torch.float64, device=dev)
    h_fb = torch.full((), 1e-2, dtype=torch.float64, device=dev)
    fb(u_fb, t_fb, h_fb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        _, e_fb = fb(u_fb, t_fb, h_fb)
    torch.cuda.synchronize()
    fb_ms = (time.perf_counter() - t0) / 3 * 1e3
    check(bool(torch.isfinite(e_fb)), "the GMRES step's enorm is finite")
    natural.update(fallback_step_ms=fb_ms, forced_fallback_secs=fsecs)
    print("phase 18 ensemble adaptive hexagons2d %d^2x3 4 members dt=1e-8 "
          "(%s): per step: %d accepts each in %d outer iterations, %.3f s, "
          "%.4f ms per accepted ensemble step, %.4f dispatches per accept | "
          "%s | launches %s | device loop: %d dispatches (%.4f per accept), "
          "%d member attempts in %d tier-step calls %s, %.3f s, %.4f ms per "
          "accepted ensemble step, rejections %s, rescues %s, launches %s "
          "(tier calls x per-call launches %s), vs each member's own chunk: "
          "t, h, u max rel dev %s | two tiers (rich3, member 0 forced up "
          "once): %d accepts each, tier calls %s in %d host reads, %d member "
          "attempts, launches %s, vs own chunks t, h, u max rel dev %s | "
          "forced fallback: member 0 rescued (its "
          "GMRES step's own enorm %.4g) and parked on the fallback, %.3f s "
          "for 3 accepts; the GMRES step (J from the once-per-step "
          "linearization) %.2f ms at h=1e-2" % (
              N_HEX, card, HEX_STEPS, natural["iterations"], secs,
              natural["ms_per_accept"], natural["dispatches_per_accept"],
              members, launches, dispatches,
              device["dispatches_per_accept"], device["attempts"],
              occupied, calls, dsecs, device["ms_per_accept"],
              device["rejections"], device["rescues"], dlaunches, sig,
              ["%.3e" % d for d in device["max_rel_dev_vs_own_chunk"]],
              TIER_STEPS, calls2, tot2.reads, tot2.attempts, launches2,
              ["%.3e" % d for d in two_tier["max_rel_dev_vs_own_chunk"]],
              fb_e[0], fsecs, fb_ms))
    natural["device_loop"] = device
    natural["launches"] = {n: launches[n] + dlaunches[n] + launches2[n]
                           for n in launches}
    return natural


def phase_ensemble_card_vs_cpu(card, phase, make_clargs_for, shape,
                               n_members, pc_pallas=False):
    """The ensemble on the card and on the CPU (plain versions) at
    ``shape`` x 3, ``n_members`` members from one numpy state: fixed dt
    in 2-step blocks (4 steps at h=1e-3) and adaptive per step (8
    accepts from h=1e-3), with the basis-GEMM or (``pc_pallas``) the
    fused pc.  The same k, rejections, snes_failures and rescues per
    member; u within 1e-5 of the increment; t and h within 1e-6
    relative on the fixed-dt path (they are equal) and 1e-5 on the
    adaptive one: there each accept's h follows the embedded error
    norm, a cancelling sum that the card's and the CPU's float32 sweeps
    round apart (9.9e-7 measured in 2D; phase 14 allows 1e-4)."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.solvers import EnsembleSolver

    cases = (("fixed", NumericsOptions(adapt_type="none",
                                       pc_pallas=pc_pallas), 2, 4, 1e-6),
             ("adaptive", NumericsOptions(pc_pallas=pc_pallas), 1, 8, 1e-5))
    tag = "x".join(str(n) for n in shape) + "x3"
    lines = []
    for label, nm, block, steps, th_rtol in cases:
        runs, U0 = {}, None
        for dev in ("cpu", "cuda"):
            ps, grid, ops = problem_from_clargs(make_clargs_for(shape[0]),
                                                *shape, device=dev)
            if U0 is None:
                U0 = ensemble_members(initial_state(grid), n_members, seed=1)
            es = EnsembleSolver(ops, nm, t0=0.0, dt=1e-3, tmax=1e9,
                                maxsteps=steps, rtol=1e-6, atol=0.01,
                                block_steps=block)
            out = es.solve(U0)
            runs[dev] = (out.u.cpu().numpy(), out.t, out.h, out.k,
                         out.snes_failures, es.rescues)
            if dev == "cuda":
                launched = {n: k.launches for n, k in es.kernels.kernels.items()}
                if pc_pallas:
                    launched.update({n: k.launches for n, k in
                                     es.fused_pc.kernels.items()})
        (uc, tc, hc, kc, sc_, rc), (ug, tg, hg, kg, sg, rg) = (runs["cpu"],
                                                               runs["cuda"])
        inc = float(np.abs(uc - U0).max())
        dev_abs = float(np.abs(ug - uc).max())
        trel = float(np.max(np.abs(tg - tc) / np.abs(tc)))
        hrel = float(np.max(np.abs(hg - hc) / np.abs(hc)))
        check((kg == kc).all() and (sg == sc_).all() and (rg == rc).all()
              and (kc == steps).all(),
              "ensemble card vs cpu %s %s: k %s/%s snes %s/%s rescues %s/%s"
              % (tag, label, kg, kc, sg, sc_, rg, rc))
        check(trel <= th_rtol and hrel <= th_rtol and dev_abs <= 1e-5 * inc,
              "ensemble card vs cpu %s %s: t %.3e h %.3e rel, u %.3e of the "
              "increment %.3e" % (tag, label, trel, hrel, dev_abs, inc))
        check(launched["resid"] > 0 and (not pc_pallas
                                         or launched["pc_fwd"] > 0),
              "ensemble card vs cpu %s %s ran through the kernels: %s"
              % (tag, label, launched))
        lines.append("%s: k %s, rejections %s, t/h rel dev %.3e/%.3e, u "
                     "dev %.3e (%.3e of the increment %.6e)" % (
                         label, kg.tolist(), sg.tolist(), trel, hrel, dev_abs,
                         dev_abs / inc, inc))
    print("phase %d ensemble card vs cpu %s%s %d members (%s): %s" % (
        phase, tag, " pc_pallas" if pc_pallas else "", n_members, card,
        " | ".join(lines)))


def agg3d_numerics():
    """examples/aggregation3d's numerics block (-ts_type rosw,
    -ts_adapt_type basic, -ts_adapt_dt_max 10000, -ts_adapt_dt_min 1e-20,
    -ts_adapt_clip 0.1,5) as NumericsOptions fields; its '-ksp_type
    preonly -pc_type lu' stays on the port's default iterative stage
    solver, as phase 18 keeps hexagons2d's."""
    from ksfd_tpu_torch import NumericsOptions

    return NumericsOptions(ts_type="rosw", adapt_type="basic", dt_max=1e4,
                           dt_min=1e-20, clip_low=0.1, clip_high=5.0)


#: accepted steps per member of phase 24's adaptive 3D run
AGG3D_STEPS = 24


def phase_ensemble_adaptive_3d(card):
    """EnsembleSolver adaptive per step (device_loop off) on
    examples/aggregation3d's parameters and numerics at its own 64^3 x 3,
    4 members from ic.start_values (srho0=90 on a 16^3 randgrid,
    ic_starts), dt=1e-6, AGG3D_STEPS accepts: per member the accepts,
    rejections, fallback rescues and the t and h range, ms per outer
    iteration and the launches (each one batched launch for all
    members)."""
    from ksfd_tpu_torch.solvers import EnsembleSolver

    dev = torch.device("cuda")
    n = N3_CMP
    clargs = agg3d_clargs(n)
    ps, grid, ops = problem_from_clargs(clargs, n, n, n, device=dev)
    kern = make_fused_kernels(ops)
    U0 = ic_starts(clargs, grid, ps, 4, clargs.seed)
    es = EnsembleSolver(ops, agg3d_numerics(), t0=0.0,
                        dt=float(ps.params0["dt"]),
                        tmax=float(ps.params0["tmax"]),
                        maxsteps=AGG3D_STEPS, rtol=float(ps.params0["rtol"]),
                        atol=float(ps.params0["atol"]), kernels=kern)
    hs_seen = []
    es.add_monitor(lambda es, ks, ts, U: hs_seen.append(es.hs.copy()))
    for k in kern.kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = es.solve(U0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kern.kernels.items()}
    check((out.k == AGG3D_STEPS).all() and not out.diverged.any()
          and bool(torch.isfinite(out.u).all()),
          "aggregation3d ensemble: k %s diverged %s" % (out.k, out.diverged))
    check(launches["resid"] > 0 and launches["delta"] > 0,
          "aggregation3d ensemble ran through the kernels: %s" % launches)
    hs = np.array(hs_seen)
    members = "; ".join(
        "m%d: k %d, rejections %d, fallback rescues %d, t %.6g, h "
        "%.3g..%.3g" % (i, out.k[i], out.snes_failures[i], es.rescues[i],
                        out.t[i], hs[:, i].min(), hs[:, i].max())
        for i in range(4))
    print("phase 24 ensemble adaptive aggregation3d %d^3x3 4 members dt=1e-6 "
          "(%s): %d accepts each in %d outer iterations, %.3f s, %.4f ms per "
          "outer iteration | %s | launches %s" % (
              n, card, AGG3D_STEPS, es.iterations, secs,
              secs / es.iterations * 1e3, members, launches))
    return dict(iterations=es.iterations, secs=secs, launches=launches,
                k=out.k.tolist(), rejections=out.snes_failures.tolist(),
                rescues=es.rescues.tolist())


# ----------------------------------------------------------------- B9


#: slab counts of phase 25, and the one its times are taken at
B9_SPLITS = (1, 2, 4)
B9_TIMED = 2


def slab_meshes(grid, S, device="cuda"):
    """The S ranks' meshes of an x split in this one process (no process
    group): ``cut`` takes each slab and its halo rows from a global
    tensor, as ``distribute`` and ``halo_rows`` give them to the ranks."""
    from ksfd_tpu_torch.parallel.mesh import SlabMesh

    dev = str(torch.device(device, torch.cuda.current_device()))
    return [SlabMesh(grid, None, (S,) + (1,) * (grid.dim - 1), r, "gloo",
                     dev, [dev] * S)
            for r in range(S)]


def slab_operands(kernel, mesh, operands):
    """A halo-slab kernel's operands cut from the unsharded prepared
    ones: each stencil operand's slab with its lo and hi rows, then the
    own-point operands' slabs."""
    sw = kernel._owner.ops.sw
    out = []
    for x in operands[:kernel.n_st]:
        out += list(mesh.cut(x, sw))
    return out + [mesh.cut(x, sw)[0] for x in operands[kernel.n_st:]]


def halo_bound(name, build, S):
    """(bound_ms, bound_by) of one halo-slab launch on a slab of an
    S-way split: the slab's operands and each stencil operand's 2 sw
    halo rows read once, the slab's output written once, over the
    card's memory rate; its points' operations over the f32 rate."""
    from ksfd_tpu_torch.ops.fused_stencil import HALO_OPERANDS

    n_st, n_own = HALO_OPERANDS[name]
    nx_loc = build.Sshape[0] // S
    row = int(np.prod(build.Sshape[1:]))
    rows = n_st * (nx_loc + 2 * build.ops.sw) + (n_own + 1) * nx_loc
    t_bytes = rows * row * build.dof * 4 / HBM_BYTES_PER_S
    t_ops = nx_loc * row * point_ops(name, build) / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_halo_kernels(card):
    """B9: each halo-slab kernel (2D at 1024^2 x 3 and, not timed, at
    RAGGED with 2 and 4 fields; 3D at 256^3 x 3) on
    S in B9_SPLITS slabs of one global state, in one process, the halo
    rows cut from it: every slab within 1e-5 of max|plain| of its plain
    version, the stitched slabs bit for bit the unsharded launch under
    the same scalar pack (the B1-B3/B7 and B6a-d cases of phases 2, 5
    and 8: rough, near-uniform and clamped states); µs per launch per
    slab at S = B9_TIMED beside its plain version and its bound."""
    dev = torch.device("cuda")
    out = {}
    rough2 = lambda grid, ps: torch.as_tensor(rough_state(grid, ps),
                                              device=dev)
    for key, clargs, shape, make_rough in (
        ("2d", bench_clargs(N_BIG), (N_BIG, N_BIG), rough2),
        ("3d", agg3d_clargs(N3_BIG), (N3_BIG,) * 3,
         lambda grid, ps: rough_state_3d(grid, ps, dev)),
    ) + tuple(("2d %d fields" % dof, bench_clargs(RAGGED[0], dof), RAGGED,
               rough2) for dof in FIELDS2):
        ps, grid, ops = problem_from_clargs(clargs, *shape, device=dev)
        full = make_fused_kernels(ops)
        gen = torch.Generator(device=dev).manual_seed(13)
        states = dict(rough=make_rough(grid, ps),
                      initial=torch.as_tensor(initial_state(grid),
                                              device=dev))
        cases = kernel_cases(full, ops, states, gen) + rhs_cases(ops, states)
        errs, rel, lines = {}, {}, []
        times = {}
        for S in B9_SPLITS:
            meshes = slab_meshes(grid, S)
            slab = make_fused_kernels(ops, mesh=meshes[0])
            for name, label, args in cases:
                sc, operands = full.kernels[name].prepare(*args)
                ref = full.kernels[name].launch(sc, operands)
                k = slab.kernels[name]
                outs = []
                for m in meshes:
                    ops_m = slab_operands(k, m, operands)
                    o = k.launch(sc, ops_m)
                    plain = k.body(sc, ops_m)
                    torch.cuda.synchronize()
                    err = float((o - plain).abs().max())
                    scale = float(plain.abs().max())
                    check(bool(torch.isfinite(o).all()),
                          "B9 %s %s %s S=%d finite" % (key, name, label, S))
                    check(err <= 1e-5 * scale, "B9 %s %s %s S=%d: max err "
                          "%.3e > 1e-5 * %.3e" % (key, name, label, S, err,
                                                  scale))
                    errs[name] = max(errs.get(name, 0.0), err)
                    rel[name] = max(rel.get(name, 0.0), err / scale)
                    outs.append(o)
                    del plain
                check(torch.equal(torch.cat(outs, dim=1), ref),
                      "B9 %s %s %s: %d slabs stitched differ from the "
                      "unsharded launch" % (key, name, label, S))
                del outs, ref
                if (S == B9_TIMED and label.split("/")[0] == "rough"
                        and not label.endswith(("clamped", "floor"))
                        and name not in times and shape != RAGGED):
                    ops_m = slab_operands(k, meshes[0], operands)
                    reps = 200 if key == "2d" else 20
                    times[name] = (
                        cuda_ms(lambda: k.launch(sc, ops_m), reps),
                        cuda_ms(lambda: k.body(sc, ops_m), 5),
                        None) + halo_bound(name, full.build, S)
                    del ops_m
            lines.append("S=%d bit-equal" % S)
        print("phase 25 B9 %s %s x%d on %s slabs (%s): every case of "
              "phases 2/5/8 within 1e-5 of plain (max rel %s), stitched "
              "bit-equal to the unsharded launch at every S | µs per launch "
              "per slab at S=%d kernel/plain (bound, by, share of the "
              "bound): %s" % (
                  key, "x".join(map(str, shape)), grid.dof,
                  "/".join(map(str, B9_SPLITS)), card,
                  ", ".join("%s %.2e" % kv for kv in rel.items()), B9_TIMED,
                  "; ".join("%s %.1f/%.1f (%.1f, %s, %.3f)" % (
                      n, a * 1e3, b * 1e3, bd * 1e3, by, bd / a)
                      for n, (a, b, _, bd, by) in times.items())))
        out[key] = (slab, errs, rel, times)
        del cases, states, full
        torch.cuda.empty_cache()
    return out


#: a free local port for a one-rank NCCL group (no network: localhost)
def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def b9_counts(kern):
    return {name: k.launches for name, k in kern.kernels.items()}


def slope_ms(multi, u0, t0, h, fast32):
    """ms/step from the slope of a 2- and a 10-step chain (min of 2)."""
    samples = {2: [], 10: []}
    for rep in range(2):
        for n in (2, 10):
            pert = (1e-6 if fast32 else 1e-9) * (1 + 2 * rep + (n == 10))
            up = u0 * (1.0 + pert) + pert
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            multi(up, t0, h, n)
            torch.cuda.synchronize()
            samples[n].append(time.perf_counter() - t_start)
    return (min(samples[10]) - min(samples[2])) / 8 * 1e3


def phase_one_rank_nccl(card):
    """The whole sharded path on a one-rank NCCL mesh (the ring closed
    on itself, every all_reduce through NCCL): the 2D float64 and
    fast-mode multisteps at 1024^2 x 3 and at 256^3 x 3 with ``mesh=``,
    from the near-uniform state at h=1: exact
    B9 launches per step (each chain from counts of 0), the state after
    2 steps against the unsharded multistep of the same run (1e-5 of the
    increment in float64; in the fast mode, whose state is float32, 1e-4
    of it plus 4 float32 ulps of the state, phase 10's rule), ms/step of
    both, and the profiled device share of the halo rows and the
    all_reduce (their ``ksfd::halo``/``ksfd::all_reduce`` ranges)."""
    import torch.distributed as dist

    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.parallel import distribute, grid_mesh
    from ksfd_tpu_torch.parallel.mesh import all_reduce_sum, exchange_halos
    from ksfd_tpu_torch.solvers import make_multistep_fn
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method="tcp://localhost:%d"
                            % free_port(), world_size=1, rank=0)
    figs, totals = {}, {}
    try:
        for key, clargs, shape, fast32 in (
            ("2d_f64", bench_clargs(N_BIG), (N_BIG, N_BIG), False),
            ("2d_f32", bench_clargs(N_BIG), (N_BIG, N_BIG), True),
            ("3d_f64", agg3d_clargs(N3_BIG), (N3_BIG,) * 3, False),
            ("3d_f32", agg3d_clargs(N3_BIG), (N3_BIG,) * 3, True),
        ):
            ps, grid, ops = problem_from_clargs(clargs, *shape, device=dev)
            mesh = grid_mesh(grid, device=dev)
            check(mesh.backend == "nccl" and mesh.shape[0] == 1,
                  "one-rank mesh")
            if key == "2d_f64":
                # host µs per call of the mesh's two communications
                x3 = torch.ones(3, dtype=torch.float64, device=dev)
                slab = torch.ones((3,) + shape, dtype=torch.float32,
                                  device=dev)
                per_call = {}
                for what, fn in (
                        ("all_reduce", lambda: all_reduce_sum(x3, mesh)),
                        ("halo", lambda: exchange_halos([slab, slab],
                                                        ops.sw, mesh))):
                    fn()
                    torch.cuda.synchronize()
                    t_start = time.perf_counter()
                    for _ in range(100):
                        fn()
                    torch.cuda.synchronize()
                    per_call[what] = (time.perf_counter() - t_start) * 1e4
                figs["host_us_per_call"] = per_call
                print("phase 26 one-rank NCCL mesh: host µs per call "
                      "(100 calls, synchronised): %s" % per_call)
            numerics = NumericsOptions(
                precision="float32" if fast32 else "float64")
            multi_s, _ = make_multistep_fn(ops, numerics, atol=0.01,
                                           rtol=1e-6, static_steps=False,
                                           mesh=mesh)
            multi_1, _ = make_multistep_fn(ops, numerics, atol=0.01,
                                           rtol=1e-6, static_steps=False)
            kern = multi_s.kernels
            check(kern.kind.startswith("halo-slab"), kern.kind)
            per_step = (dict(rhs=4, jvp=8, resid=0, delta=0) if fast32
                        else dict(rhs=0, jvp=0, resid=8, delta=4))
            u0 = torch.as_tensor(initial_state(grid), device=dev)
            t0 = torch.zeros((), dtype=torch.float64, device=dev)
            h = torch.full((), 1.0, dtype=torch.float64, device=dev)
            u_loc = distribute(u0, grid, mesh)[0]
            for n in (2, 10):
                for k in kern.kernels.values():
                    k.launches = 0
                u_s, t_s, e_s = multi_s(u_loc, t0, h, n)
                torch.cuda.synchronize()
                cnt = b9_counts(kern)
                check(cnt == {k: n * c for k, c in per_step.items()},
                      "B9 launch counts %s for %d steps" % (cnt, n))
                check(bool(torch.isfinite(u_s).all()) and
                      bool(torch.isfinite(e_s)), "sharded state finite")
                if n == 2:
                    u_s2, e_s2 = u_s, float(e_s)
            for name, c in cnt.items():
                totals[(key[:2], name)] = totals.get((key[:2], name), 0) + c
            u_1, _, e_1 = multi_1(u0, t0, h, 2)
            inc = float((u_1 - u0.to(u_1.dtype)).abs().max())
            dev_abs = float((u_s2 - u_1).abs().max())
            tol = 1e-5 * inc
            if fast32:
                tol = 1e-4 * inc + 4 * 2.0 ** -23 * float(u_1.abs().max())
            check(dev_abs <= tol, "%s one-rank NCCL vs unsharded: %.3e > "
                  "%.3e" % (key, dev_abs, tol))
            del u_s, u_1
            ms_s = slope_ms(multi_s, u_loc, t0, h, fast32)
            ms_1 = slope_ms(multi_1, u0, t0, h, fast32)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                multi_s(u_loc, t0, h, 2)
                torch.cuda.synchronize()
            cuda_dev = torch.autograd.DeviceType.CUDA
            cpu_dev = torch.autograd.DeviceType.CPU
            device_ms = sum(
                (getattr(ev, "self_device_time_total", None)
                 or ev.self_cuda_time_total)
                for ev in prof.key_averages()
                if getattr(ev, "device_type", None) == cuda_dev) / 1e3 / 2
            # the host ranges' own kernels (the device-side annotation of
            # a range spans its idle gaps too, and is not counted)
            comm = {w: sum(ev.device_time_total for ev in prof.events()
                           if ev.name == "ksfd::" + w
                           and ev.device_type == cpu_dev) / 1e3 / 2
                    for w in ("halo", "all_reduce")}
            host = {w: sum(ev.cpu_time_total for ev in prof.events()
                           if ev.name == "ksfd::" + w
                           and ev.device_type == cpu_dev) / 1e3 / 2
                    for w in ("halo", "all_reduce")}
            os.makedirs(OUT_DIR, exist_ok=True)
            with open(os.path.join(OUT_DIR, "one_rank_nccl_profile_%s.txt"
                                   % key), "w") as fh:
                fh.write("%s\n2-step sharded chain, one-rank NCCL mesh, "
                         "%s\n%s\n%s\n" % (
                             card, key,
                             prof.key_averages().table(
                                 sort_by="cuda_time_total", row_limit=25),
                             prof.key_averages().table(
                                 sort_by="cpu_time_total", row_limit=40)))
            nccl = sum((getattr(ev, "self_device_time_total", None)
                        or ev.self_cuda_time_total)
                       for ev in prof.key_averages()
                       if getattr(ev, "device_type", None) == cuda_dev
                       and "nccl" in ev.key.lower()) / 1e3 / 2
            check(sum(ev.name == "ksfd::all_reduce" for ev in prof.events())
                  > 0, "%s: no all_reduce in the profiled chain" % key)
            figs[key] = dict(ms_per_step=ms_s, ms_per_step_unsharded=ms_1,
                             device_ms_per_step=device_ms,
                             halo_ms_per_step=comm["halo"],
                             all_reduce_ms_per_step=comm["all_reduce"],
                             halo_host_ms_per_step=host["halo"],
                             all_reduce_host_ms_per_step=host["all_reduce"],
                             nccl_kernel_ms_per_step=nccl,
                             dev_over_inc=dev_abs / inc,
                             enorm=e_s2, enorm_unsharded=float(e_1),
                             launches_per_step=per_step)
            print("phase 26 one-rank NCCL mesh %s %s x3 (%s): B9 counts %s "
                  "for 10 steps; max|u_sharded - u| %.3e = %.3e of the "
                  "increment %.6e (bound %.3e); emax %.6e vs %.6e; %.4f "
                  "ms/step sharded, %.4f unsharded; profiled device "
                  "%.4f ms/step, halo %.4f, all_reduce %.4f (NCCL kernels "
                  "%.4f): share %.4f; host ms/step in the profiled chain: "
                  "halo %.4f, all_reduce %.4f" % (
                      key, "x".join(map(str, shape)), card, cnt, dev_abs,
                      dev_abs / inc, inc, tol, e_s2, float(e_1), ms_s, ms_1,
                      device_ms, comm["halo"], comm["all_reduce"], nccl,
                      (comm["halo"] + comm["all_reduce"])
                      / max(device_ms, 1e-9), host["halo"],
                      host["all_reduce"]))
            del multi_s, multi_1, kern, ops, u0, u_loc, u_s2
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return figs, totals


#: phase 27's ranks
N_RANKS = 2


def _gloo_rank(rank, n, store, queue):
    """One of phase 27's ranks: a gloo group over the one card (the halo
    rows and the all_reduce through the host), each path sharded, rank 0
    also the unsharded reference of the same path on the card."""
    import traceback

    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=n)
        out = _gloo_paths(rank)
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


def _gloo_paths(rank):
    import torch.distributed as dist

    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.parallel import distribute, grid_mesh
    from ksfd_tpu_torch.solvers import (
        make_adaptive_chunk_fn, make_multistep_fn, make_step_fn)

    dev = torch.device("cuda", 0)
    out = {}
    f64 = lambda x: torch.full((), x, dtype=torch.float64, device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def against(key, u_s, u_ref, u0, e_s=None, e_ref=None, tol_inc=1e-5):
        """On rank 0: the gathered sharded state against the unsharded
        one, within tol_inc of the increment (and enorm within 1e-2)."""
        inc = float((u_ref - u0).abs().max())
        dev_abs = float((u_s - u_ref).abs().max())
        out[key] = dict(dev_over_inc=dev_abs / inc, inc=inc)
        check(dev_abs <= tol_inc * inc, "%s: two ranks vs unsharded %.3e > "
              "%g of the increment %.3e" % (key, dev_abs, tol_inc, inc))
        if e_s is not None:
            out[key].update(enorm=e_s, enorm_unsharded=e_ref)
            check(abs(e_s - e_ref) <= 1e-2 * e_ref, "%s: enorm %.6e vs "
                  "%.6e" % (key, e_s, e_ref))

    # 2D steps at 1024^2 x 3: pc_dtype auto (the bf16 sharded pc) on
    # tests/test_pallas.py's rough state, the state of the envelope it is
    # held to (test_pallas.py:293-332: h=1e-3 at 64^2, an accepted step),
    # at that step's stiffness per cell, h = 1e-3 (64/n)^2, and float32
    # pinned on bench.py's capped-peak rough state; the bf16 pc's
    # deviation on the capped-peak state is reported beside them
    ps, grid, ops = problem_from_clargs(bench_clargs(N_BIG), N_BIG, N_BIG,
                                        device=dev)
    h_env = 1e-3 * (64.0 / N_BIG) ** 2
    mesh = grid_mesh(grid, device=dev)
    check(mesh.backend == "gloo" and mesh.shape[0] == N_RANKS, repr(mesh))
    states = dict(
        pallas=ops.groom(torch.as_tensor(pallas_rough_state(grid.Sshape),
                                         device=dev)),
        bench=ops.groom(torch.as_tensor(rough_state(grid, ps), device=dev)))
    for label, nm, state, gate in (
            ("step_2d_auto", NumericsOptions(), "pallas", True),
            ("step_2d_f32pc", NumericsOptions(pc_dtype="float32"), "bench",
             True),
            ("step_2d_auto_capped", NumericsOptions(), "bench", False)):
        u0 = states[state]
        step, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6, mesh=mesh)
        u_loc = distribute(u0, grid, mesh)[0]
        step(u_loc, f64(0.0), f64(h_env))
        (u1, e1), secs = timed(lambda: step(u_loc, f64(0.0), f64(h_env)))
        u1 = mesh.gather(u1)
        if rank == 0:
            # unsharded, pc_dtype auto is float32
            ref, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6)
            ur, er = ref(u0, f64(0.0), f64(h_env))
            check(float(er) < 1.0, "%s: the envelope's step is an accepted "
                  "one; enorm %.6e at h=%g" % (label, float(er), h_env))
            if gate:
                against(label, u1, ur, u0, float(e1), float(er))
            else:
                inc = float((ur - u0).abs().max())
                out[label] = dict(
                    dev_over_inc=float((u1 - ur).abs().max()) / inc,
                    inc=inc, enorm=float(e1), enorm_unsharded=float(er))
            out[label].update(ms=secs * 1e3, state=state, h=h_env,
                              pc_dtype=step.build_info["pc_dtype"])
        dist.barrier()
    del states
    # the 2D f64 multistep from the near-uniform state at h=1, pc pinned
    u0 = torch.as_tensor(initial_state(grid), device=dev)
    nm = NumericsOptions(pc_dtype="float32")
    multi, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6, mesh=mesh)
    u_loc = distribute(u0, grid, mesh)[0]
    multi(u_loc, f64(0.0), f64(1.0), 2)
    (res2, s2) = timed(lambda: multi(u_loc, f64(0.0), f64(1.0), 2))
    (_, s10) = timed(lambda: multi(u_loc, f64(0.0), f64(1.0), 10))
    u2 = mesh.gather(res2[0])
    if rank == 0:
        ref, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6)
        against("multistep_2d", u2, ref(u0, f64(0.0), f64(1.0), 2)[0], u0)
        out["multistep_2d"]["ms_per_step"] = (s10 - s2) / 8 * 1e3
    dist.barrier()
    del ops, mesh, multi, u0, u_loc, u2, res2
    torch.cuda.empty_cache()
    # the adaptive chunk at the flagship's 1536^2 x 3, smooth, pc auto
    ps, grid, ops = problem_from_clargs(agg2d_clargs(N_AGG), N_AGG, N_AGG,
                                        device=dev)
    mesh = grid_mesh(grid, device=dev)
    u0 = torch.as_tensor(initial_state(grid), device=dev)
    nm = chunk_numerics(False, 1.0)
    chunk, _ = make_adaptive_chunk_fn(ops, nm, atol=0.01, rtol=1e-6,
                                      max_attempts=4 * 14, mesh=mesh)
    u_loc = distribute(u0, grid, mesh)[0]
    (res, secs) = timed(lambda: chunk(u_loc, 0.0, 1.0, 1e30, 6))
    stats = chunk.stats
    if rank == 0:
        ref, _ = make_adaptive_chunk_fn(ops, nm, atol=0.01, rtol=1e-6,
                                        max_attempts=4 * 14)
        r = ref(u0, 0.0, 1.0, 1e30, 6)
        out["chunk"] = dict(k=res[3], attempts=res[4], per_tier=stats.per_tier,
                            k_unsharded=r[3], attempts_unsharded=r[4],
                            per_tier_unsharded=ref.stats.per_tier,
                            pc_dtype=chunk.build_info["pc_dtype"],
                            ms_per_accept=secs / max(res[3], 1) * 1e3)
        check((res[3], res[4], stats.per_tier) == (
            r[3], r[4], ref.stats.per_tier),
            "chunk: k %d attempts %d per tier %s vs unsharded %d %d %s" % (
                res[3], res[4], stats.per_tier, r[3], r[4],
                ref.stats.per_tier))
    out["chunk_records"] = repr(stats.records)
    dist.barrier()
    del ops, mesh, chunk, u0, u_loc, res
    torch.cuda.empty_cache()
    # the 3D multistep at 256^3 x 3, pc pinned, from the near-uniform state
    ps, grid, ops = problem_from_clargs(agg3d_clargs(N3_BIG), *(N3_BIG,) * 3,
                                        device=dev)
    mesh = grid_mesh(grid, device=dev)
    u0 = torch.as_tensor(initial_state(grid), device=dev)
    nm = NumericsOptions(pc_dtype="float32")
    multi, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6, mesh=mesh)
    u_loc = distribute(u0, grid, mesh)[0]
    (res2, s2) = timed(lambda: multi(u_loc, f64(0.0), f64(1.0), 2))
    u2 = mesh.gather(res2[0])
    del res2
    if rank == 0:
        ref, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6)
        against("multistep_3d", u2, ref(u0, f64(0.0), f64(1.0), 2)[0], u0)
        out["multistep_3d"]["ms_per_step"] = s2 / 2 * 1e3
    dist.barrier()
    return out


def phase_two_ranks(card):
    """Two gloo ranks time-sliced on the one card (spawned processes),
    the halo rows and the all_reduce through the host: the 2D float64
    step at 1024^2 x 3 (pc_dtype auto, the bfloat16 sharded pc, on
    tests/test_pallas.py's rough state, and float32 pinned on bench.py's
    capped-peak rough state, at h = 1e-3 (64/1024)^2, the stiffness per
    cell of that test's accepted step: 1e-5 of the increment, enorm 1e-2
    relative; the bfloat16 pc on the capped-peak state is reported), the
    2D multistep (pinned), the adaptive chunk
    at the flagship's 1536^2 x 3 (smooth, 6 accepts: the same k and
    attempts per tier), the 3D multistep at 256^3 x 3 (pinned), each
    against the unsharded port on the card.  A rank that fails fails the
    phase.  The times are of two ranks sharing one card, not a scaling
    figure."""
    import multiprocessing as mp
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="ksfd_gloo_"), "store")
    procs = [ctx.Process(target=_gloo_rank, args=(r, N_RANKS, store, queue))
             for r in range(N_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:
            rank, res, err = queue.get(timeout=900)
            if err is not None:
                errors.append("rank %d:\n%s" % (rank, err))
                break
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=120 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join(10)
    check(not errors, "two-rank phase failed:\n" + "\n".join(errors))
    check(results[0]["chunk_records"] == results[1]["chunk_records"],
          "the ranks' chunk records differ")
    r0 = results[0]
    wall = time.perf_counter() - t0
    print("phase 27 two gloo ranks time-sliced on one card (%s; not a "
          "scaling figure; %.2f s wall with the spawn): %s" % (
              card, wall, " | ".join(
                  "%s %s" % (k, {kk: (round(v, 9) if isinstance(v, float)
                                      else v) for kk, v in r0[k].items()})
                  for k in ("step_2d_auto", "step_2d_f32pc",
                            "step_2d_auto_capped", "multistep_2d", "chunk",
                            "multistep_3d"))))
    return {k: v for k, v in r0.items() if k != "chunk_records"}



# ------------------------------------------------------- the unfused step

N_PEAKS = 384               # examples/peaks1d's own size
PEAKS_ACCEPTS = 36          # accepts of phase 28's 1D chunk
PEAKS_ENS_STEPS = 24        # accepts per member of phase 28's 1D ensemble
SMALL3 = (64, 64, 4)        # a 3D extent under 2*sw+1 on z


def peaks_clargs():
    """The parameters of examples/peaks1d (1D, rho plus an attractant and
    a repellent ligand group, degree 3, 384 elements)."""
    return make_clargs(params=example_params("peaks1d"))


def peaks_numerics(**kw):
    """examples/peaks1d's numerics block (-ts_type rosw, -ts_adapt_type
    basic, -ts_adapt_dt_max 10000, -ts_adapt_dt_min 1e-20,
    -ts_adapt_clip 0.1,5) as NumericsOptions fields."""
    from ksfd_tpu_torch import NumericsOptions

    return NumericsOptions(ts_type="rosw", adapt_type="basic", dt_max=1e4,
                           dt_min=1e-20, clip_low=0.1, clip_high=5.0, **kw)


def step_ms(multi, u0, h, n_lo=2, n_hi=6, reps=2):
    """Host ms per step of a multistep from the slope between ``n_lo``
    and ``n_hi`` steps (the min over reps of each)."""
    dev = u0.device
    t0 = torch.zeros((), dtype=torch.float64, device=dev)
    hh = torch.full((), h, dtype=torch.float64, device=dev)
    best = {}
    for n in (n_lo, n_hi):
        for _ in range(reps):
            torch.cuda.synchronize()
            start = time.perf_counter()
            multi(u0, t0, hh, n)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            best[n] = min(best.get(n, secs), secs)
    return (best[n_hi] - best[n_lo]) / (n_hi - n_lo) * 1e3


def jvp_linearize(ops):
    """``ops.linearize`` by ``torch.func.jvp`` of the RHS at every apply
    (a primal evaluation with each tangent)."""
    def linearize(u, t, primal=True):
        def fn(uu):
            return ops.rhs(uu, t)

        return (fn(u) if primal else None,
                lambda v: torch.func.jvp(fn, (u,), (v,))[1])

    return linearize


def fx_linearize(ops):
    """``ops.linearize`` by ``torch.func.linearize`` once per step (one
    make_fx trace, then the tangent graph at every apply)."""
    def linearize(u, t, primal=True):
        f0, jvp = torch.func.linearize(lambda uu: ops.rhs(uu, t), u)
        return (f0 if primal else None), jvp

    return linearize


def linearization_ms(ops, numerics, u0, h):
    """Host ms per step of the unfused multistep with each way of
    linearizing the RHS: the port's coefficient fields
    (PDEOperators.linearize), and in its place ``torch.func.jvp`` per
    apply and ``torch.func.linearize`` per step; a 2-step chain after a
    1-step warmup, and each one's 2-step state's max deviation from the
    first's."""
    from ksfd_tpu_torch.solvers import make_multistep_fn

    dev = u0.device
    t0 = torch.zeros((), dtype=torch.float64, device=dev)
    hh = torch.full((), h, dtype=torch.float64, device=dev)
    out, states = {}, {}
    for how, lin in (("fields", None), ("jvp", jvp_linearize(ops)),
                     ("linearize", fx_linearize(ops))):
        if lin is not None:
            ops.linearize = lin
        try:
            multi, _ = make_multistep_fn(ops, numerics, atol=0.01,
                                         rtol=1e-6)
            multi(u0, t0, hh, 1)
            torch.cuda.synchronize()
            start = time.perf_counter()
            states[how] = multi(u0, t0, hh, 2)[0]
            torch.cuda.synchronize()
            out[how] = (time.perf_counter() - start) / 2 * 1e3
        finally:
            vars(ops).pop("linearize", None)
    devs = {how: float((u - states["fields"]).abs().max())
            for how, u in states.items()}
    return out, devs


def card_vs_cpu_multistep(clargs, shape, numerics, make_state, h, nsteps):
    """The unfused multistep on the card and on the CPU from one numpy
    state: (card state, cpu state, u0) as numpy."""
    from ksfd_tpu_torch.solvers import make_multistep_fn

    res = {}
    u0 = None
    for dev in ("cpu", "cuda"):
        ps, grid, ops = problem_from_clargs(clargs, *shape, device=dev)
        if u0 is None:
            u0 = make_state(grid)
        multi, _ = make_multistep_fn(ops, numerics, atol=0.01, rtol=1e-6)
        check(multi.kernels is None, "the unfused multistep built kernels")
        u, _, e = multi(torch.as_tensor(u0, device=dev),
                        torch.zeros((), dtype=torch.float64, device=dev),
                        torch.full((), h, dtype=torch.float64, device=dev),
                        nsteps)
        check(bool(torch.isfinite(u).all()) and bool(torch.isfinite(e)),
              "unfused multistep finite on %s" % dev)
        res[dev] = u.double().cpu().numpy()
    return res["cuda"], res["cpu"], u0


def phase_unfused(card):
    """The unfused step (the reference's XLA path: no kernel; W from the
    RHS linearized once per step) on the card.

    (a) examples/peaks1d at its own 384 x 3 (1D): the adaptive chunk for
        PEAKS_ACCEPTS accepts from a noisy uniform start (hex_starts);
        the fixed-dt multistep card vs CPU, the default mixed step
        within 1e-5 of the increment and the float64-sweep step within
        1e-10 of max|u|; each way of linearizing the RHS timed;
    (b) the 2D bench problem at 1024^2 x 3 with use_pallas=False, the
        mixed step and the float64-sweep step: no stencil launch (a
        kernel namespace passed in stays at 0); against the
        float64-sweep step the mixed unfused state within 1e-5 of the
        increment and the fused step's within 1e-4 (its delta kernel's
        float32 envelope on this near-uniform state: 6.1e-5, the plain
        versions on the CPU too); host ms/step and device ms by group of
        all three; each way of linearizing timed;
    (c) aggregation3d at 64 x 64 x 4 (z under 2*sw+1) from a noisy
        uniform start: the gate refuses and the unfused step runs, card
        vs CPU within 1e-5 of the increment;
    (d) the 1D ensemble with the device loop, 3 members, PEAKS_ENS_STEPS
        accepts each, its tier calls checked, each member against its
        own chunk (k equal, t and h to 1e-4 relative, as phase 18)."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.ops.fused_stencil import kernels_available
    from ksfd_tpu_torch.solvers import (
        EnsembleSolver,
        make_adaptive_chunk_fn,
        make_multistep_fn,
    )

    dev = torch.device("cuda")
    lines = []
    fig = {}
    # (a) peaks1d
    clargs = peaks_clargs()
    ps, grid, ops = problem_from_clargs(clargs, N_PEAKS, device=dev)
    check(grid.dim == 1 and not kernels_available(grid, ops),
          "peaks1d is 1D and off the kernel gate")
    start = hex_starts(grid, 3, clargs.seed)
    chunk, _ = make_adaptive_chunk_fn(ops, peaks_numerics(), atol=0.01,
                                      rtol=1e-6)
    u0 = ops.groom(torch.as_tensor(start[0], device=dev))
    chunk(u0, 0.0, 1e-8, 2e5, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, t, h, k, attempts, rejected = chunk(u0, 0.0, 1e-8, 2e5,
                                           PEAKS_ACCEPTS)
    torch.cuda.synchronize()
    csecs = time.perf_counter() - t0
    check(k == PEAKS_ACCEPTS and not rejected
          and bool(torch.isfinite(u).all()),
          "peaks1d chunk: k %d attempts %d rejected %s" % (k, attempts,
                                                           rejected))
    fig["peaks1d_chunk"] = dict(ms_per_accept=csecs / k * 1e3, k=k,
                                attempts=attempts, t=t, h=h,
                                per_tier=chunk.stats.per_tier)
    lines.append("(a) peaks1d %dx3 chunk: %d accepts in %d attempts %s, t "
                 "%.6g, h %.4g, %.3f ms per accept" % (
                     N_PEAKS, k, attempts, chunk.stats.per_tier, t, h,
                     csecs / k * 1e3))
    def peaks_start(g):
        return ops.groom(torch.as_tensor(start[0], device=dev)).cpu().numpy()

    for label, nm, tol in (("mixed", NumericsOptions(), None),
                           ("f64 sweeps",
                            NumericsOptions(sweep_dtype="float64"), 1e-10)):
        ug, uc, u0n = card_vs_cpu_multistep(clargs, (N_PEAKS,), nm,
                                            peaks_start, 1e-2, 4)
        inc = float(np.abs(uc - u0n).max())
        dev_abs = float(np.abs(ug - uc).max())
        bound = (1e-5 * inc if tol is None
                 else tol * float(np.abs(uc).max()))
        check(dev_abs <= bound, "peaks1d card vs cpu %s: %.3e > %.3e" % (
            label, dev_abs, bound))
        lines.append("peaks1d card vs cpu 4 steps h=1e-2 %s: %.3e (%.3e of "
                     "the increment %.4e)" % (label, dev_abs, dev_abs / inc,
                                              inc))
    lin1, lin1_dev = linearization_ms(ops, NumericsOptions(), u0, 1e-2)
    fig["linearize_ms_per_step_peaks1d"] = lin1
    lines.append("peaks1d ms/step by linearization %s (2-step state dev "
                 "%s)" % ({k_: round(v, 4) for k_, v in lin1.items()},
                          {k_: "%.2e" % v for k_, v in lin1_dev.items()}))

    # (b) the 2D bench problem, unfused against fused
    ps, grid, ops = problem_from_clargs(bench_clargs(N_BIG), N_BIG, N_BIG,
                                        device=dev)
    kern = make_fused_kernels(ops)
    u0 = torch.as_tensor(initial_state(grid), device=dev)
    t0_ = torch.zeros((), dtype=torch.float64, device=dev)
    h1 = torch.full((), 1.0, dtype=torch.float64, device=dev)
    res = {}
    for label, nm in (("fused", NumericsOptions()),
                      ("unfused", NumericsOptions(use_pallas=False)),
                      ("f64 sweeps", NumericsOptions(
                          use_pallas=False, sweep_dtype="float64"))):
        multi, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6,
                                     kernels=kern)
        zero_launches(kern)
        u2, _, e2 = multi(u0, t0_, h1, 2)
        torch.cuda.synchronize()
        launched = launch_counts(kern)
        ms = step_ms(multi, u0, 1.0)
        dev_ms, per_kernel = profile_device_ms(
            lambda: multi(u0, t0_, h1, 2), 2)
        res[label] = (u2, launched, ms, dev_ms, device_groups(per_kernel),
                      float(e2))
    uf, lf, msf, dmsf, gf, ef = res["fused"]
    uu, lu, msu, dmsu, gu, eu = res["unfused"]
    u64, l64, ms64, dms64, g64, e64 = res["f64 sweeps"]
    inc = float((u64 - u0).abs().max())
    dev_u = float((uu - u64).abs().max()) / inc
    dev_f = float((uf - u64).abs().max()) / inc
    check(all(v == 0 for v in lu.values()) and lf["resid"] > 0
          and all(v == 0 for v in l64.values()),
          "use_pallas=False launched %s (fused %s)" % (lu, lf))
    # against the float64-sweep step: the unfused mixed step within
    # 1e-5 of the increment; the fused step within its delta kernel's
    # float32 envelope, which on this near-uniform state at 1024^2 is
    # 6.1e-5 of the increment (the plain versions on the CPU agree)
    check(dev_u <= 1e-5 and dev_f <= 1e-4, "1024^2 vs the f64-sweep step: "
          "unfused %.3e, fused %.3e of the increment %.3e" % (
              dev_u, dev_f, inc))
    check(gu["stencil kernels"] == 0.0 and g64["stencil kernels"] == 0.0,
          "the unfused profile shows stencil kernels: %s" % gu)
    lin2, lin2_dev = linearization_ms(ops, NumericsOptions(use_pallas=False),
                                      u0, 1.0)
    fig["bench_1024"] = dict(
        fused_ms_per_step=msf, unfused_ms_per_step=msu,
        f64_sweeps_ms_per_step=ms64, fused_device_ms=dmsf,
        unfused_device_ms=dmsu, f64_sweeps_device_ms=dms64,
        fused_groups=gf, unfused_groups=gu, f64_sweeps_groups=g64,
        unfused_launches=lu, fused_launches=lf,
        dev_vs_f64_sweeps=dict(unfused=dev_u, fused=dev_f),
        linearize_ms_per_step=lin2)
    grp = lambda g: "; ".join("%s %.3f" % kv for kv in g.items())  # noqa
    lines.append("(b) bench %d^2x3 h=1 2 steps: unfused launches %s; vs the "
                 "f64-sweep step unfused %.3e, fused %.3e of the increment "
                 "%.4e; emax fused %.4e unfused %.4e f64 sweeps %.4e; "
                 "ms/step host fused %.3f unfused %.3f f64 sweeps %.3f; "
                 "device ms/step fused %.3f (%s) unfused %.3f (%s) f64 "
                 "sweeps %.3f (%s); unfused ms/step by linearization %s "
                 "(2-step state dev %s)" % (
                     N_BIG, lu, dev_u, dev_f, inc, ef, eu, e64, msf, msu,
                     ms64, dmsf, grp(gf), dmsu, grp(gu), dms64, grp(g64),
                     {k_: round(v, 3) for k_, v in lin2.items()},
                     {k_: "%.2e" % v for k_, v in lin2_dev.items()}))
    del uf, uu, u64, kern, ops

    # (c) 3D with z under 2*sw+1
    clargs3 = agg3d_clargs(SMALL3[0])
    _, grid3, ops3 = problem_from_clargs(clargs3, *SMALL3, device=dev)
    check(not kernels_available(grid3, ops3), "64x64x4 is off the gate")
    ug, uc, u0n = card_vs_cpu_multistep(
        clargs3, SMALL3, NumericsOptions(),
        lambda g: hex_starts(g, 1, clargs3.seed)[0], 1e-2, 2)
    inc = float(np.abs(uc - u0n).max())
    dev_abs = float(np.abs(ug - uc).max())
    check(dev_abs <= 1e-5 * inc, "3D 64x64x4 card vs cpu: %.3e of %.3e" % (
        dev_abs, inc))
    lines.append("(c) aggregation3d %dx%dx%dx3 unfused, 2 steps h=1e-2, card "
                 "vs cpu %.3e of the increment %.4e" % (
                     SMALL3 + (dev_abs / inc, inc)))

    # (d) the 1D ensemble with the device loop
    ps, grid, ops = problem_from_clargs(clargs, N_PEAKS, device=dev)
    nm = peaks_numerics(device_loop=True)
    esd = EnsembleSolver(ops, nm, t0=0.0, dt=1e-8, tmax=2e5,
                         maxsteps=PEAKS_ENS_STEPS, rtol=1e-6, atol=0.01)
    esd._build_steps()
    calls = count_tier_calls(esd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = esd.solve(start)
    torch.cuda.synchronize()
    esecs = time.perf_counter() - t0
    check((out.k == PEAKS_ENS_STEPS).all() and not out.diverged.any()
          and bool(torch.isfinite(out.u).all()),
          "peaks1d device loop: k %s" % out.k)
    tot = esd._chunk.totals
    occupied = tot.occupied
    check(sum(calls) == occupied and tot.calls == calls, "peaks1d device "
          "loop: %s calls, %d occupied tier-attempts" % (calls, occupied))
    chunk, _ = make_adaptive_chunk_fn(ops, peaks_numerics(), atol=0.01,
                                      rtol=1e-6, max_attempts=128)
    worst = 0.0
    for i in range(3):
        ui = ops.groom(torch.as_tensor(start[i], device=dev))
        u1, t1, h1_, k1, _, _ = chunk(ui, 0.0, 1e-8, 2e5, PEAKS_ENS_STEPS)
        rel = max(abs(t1 - out.t[i]) / t1, abs(h1_ - out.h[i]) / h1_)
        check(k1 == out.k[i] and rel <= 1e-4, "peaks1d device loop member "
              "%d: k %d/%d, t/h rel %.3e" % (i, out.k[i], k1, rel))
        worst = max(worst, rel)
    fig["peaks1d_device_loop"] = dict(
        ms_per_accept=esecs / PEAKS_ENS_STEPS * 1e3,
        dispatches=tot.dispatches,
        tier_calls=calls, rejections=out.snes_failures.tolist())
    lines.append("(d) peaks1d device-loop ensemble 3 members: %d accepts "
                 "each in %d dispatches, tier calls %s over %d occupied "
                 "tier-attempts, rejections %s, %.3f ms per accepted "
                 "ensemble step, t/h max rel dev vs own chunks %.3e" % (
                     PEAKS_ENS_STEPS, tot.dispatches, calls, occupied,
                     out.snes_failures.tolist(),
                     esecs / PEAKS_ENS_STEPS * 1e3, worst))
    print("phase 28 unfused step (%s): %s" % (card, " | ".join(lines)))
    return fig


# -------------------------------------- time-dependent PDE coefficients

T_TDEP = 20.0               # the time phase 29's steps start at


def phase_tdep(card):
    """Time-dependent PDE coefficients through the kernels: each kernel
    reads t from its scalar pack, the generated header evaluates the
    coefficients at it, and the step drops only the delta kernel (as
    the reference does, ksfd_tpu/solvers/solver.py:317-335).

    (a) the bench problem with G and one ligand decay depending on t at
        1024^2 x 3: each kernel against its plain version at t = 30, on
        a rough and a near-uniform state (1e-5 of the plain version's
        largest value); 2 mixed steps and 2 fast-mode steps from t = 20
        launch 16 resid and no delta, and 8 rhs and 16 jvp;
    (b) at 256^2 x 3, 4 chained mixed steps h=1e-4 from t = 20 on the
        card (kernels) and on the CPU (plain versions): within 1e-5 of
        the summed increment; the same steps from t = 0 differ from
        them by more than 10 times that bound (the kernels follow t)."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.solvers import make_multistep_fn

    dev = torch.device("cuda")
    ps, grid, ops = problem_from_clargs(tdep_clargs(N_BIG), N_BIG, N_BIG,
                                        device=dev)
    check(ops._G_tdep and ops._lig_tdep and not ops.stage_delta_ok(),
          "phase 29's G and decay depend on t")
    kern = make_fused_kernels(ops)
    gen = torch.Generator(device="cuda").manual_seed(29)
    states = {"rough": torch.as_tensor(rough_state(grid, ps), device=dev),
              "wave": torch.as_tensor(initial_state(grid), device=dev)}
    errs, rel, lines = {}, {}, []
    compare_kernels(kern, kernel_cases(kern, ops, states, gen, t=30.0)
                    + rhs_cases(ops, states, t=30.0), errs, rel, lines)
    u0 = states["rough"]
    t20 = torch.full((), T_TDEP, dtype=torch.float64, device=dev)
    h = torch.full((), 1e-4, dtype=torch.float64, device=dev)
    launched = {}
    for label, nm in (("mixed", NumericsOptions()),
                      ("fast", NumericsOptions(precision="float32"))):
        multi, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6,
                                     kernels=kern)
        check(not multi.build_info["pallas_delta"]
              and multi.build_info["kernel_refusal"] is None,
              "phase 29 %s: %s" % (label, multi.build_info))
        zero_launches(kern)
        u2, _, e2 = multi(u0, t20, h, 2)
        torch.cuda.synchronize()
        launched[label] = launch_counts(kern)
        check(bool(torch.isfinite(u2).all()) and bool(torch.isfinite(e2)),
              "phase 29 %s steps finite" % label)
    want = {"mixed": dict(rhs=0, jvp=0, resid=16, delta=0),
            "fast": dict(rhs=8, jvp=16, resid=0, delta=0)}
    check(launched == want, "phase 29 launches %s, want %s" % (launched,
                                                               want))
    del states, u0, u2, kern, ops

    # (b) card vs CPU from t = 20, and the card from t = 0
    clargs = tdep_clargs(N_CMP)
    runs = {}
    state = None
    for where, t_start in (("cpu", T_TDEP), ("cuda", T_TDEP), ("cuda", 0.0)):
        ps, grid, ops = problem_from_clargs(clargs, N_CMP, N_CMP,
                                            device=where)
        if state is None:
            state = torch.as_tensor(rough_state(grid, ps))
        multi, _ = make_multistep_fn(ops, NumericsOptions(), atol=0.01,
                                     rtol=1e-6)
        check(multi.kernels is not None, "phase 29 runs the kernels (on "
              "the CPU their plain versions)")
        t_ = torch.full((), t_start, dtype=torch.float64, device=where)
        hh = torch.full((), 1e-4, dtype=torch.float64, device=where)
        u = state.to(where)
        if where == "cpu":
            # the summed per-step increment (the CPU run starts at t = 20)
            inc, ui = 0.0, u
            for k in range(4):
                un, _, _ = multi(ui, t_ + k * hh, hh, 1)
                inc += float((un - ops.groom(ui)).abs().max())
                ui = un
        runs[where, t_start] = multi(u, t_, hh, 4)[0].cpu()
    dev_abs = float((runs["cuda", T_TDEP] - runs["cpu", T_TDEP]).abs().max())
    t_effect = float((runs["cuda", 0.0] - runs["cuda", T_TDEP]).abs().max())
    check(dev_abs <= 1e-5 * inc and t_effect > 10 * 1e-5 * inc,
          "phase 29 card vs cpu %.3e, t effect %.3e, 1e-5 of the summed "
          "increment %.3e" % (dev_abs, t_effect, 1e-5 * inc))
    print("phase 29 time-dependent coefficients (%s): %d^2x3 kernels vs "
          "plain at t=30: %s | launches, 2 steps from t=%g: %s | %d^2x3 "
          "card vs cpu, 4 steps h=1e-4 from t=%g: %.3e (%.3e of the summed "
          "increment %.4e); the same steps from t=0 differ by %.3e" % (
              card, N_BIG, "; ".join(lines), T_TDEP, launched, N_CMP,
              T_TDEP, dev_abs, dev_abs / inc, inc, t_effect))
    return dict(max_abs_err=errs, max_rel_err=rel, launches=launched,
                card_vs_cpu_rel_to_increment=dev_abs / inc,
                t_effect_rel_to_increment=t_effect / inc)


#: phase 30's depths: (b) the flagship's accepted steps from dt=1e-8,
#: (c) the card-vs-CPU run's, (d) noise1d's
FLAG_ACCEPTS = 64
SOLVER_CMP_ACCEPTS = 16
NOISE_ACCEPTS = 200
N_SOLVER_CMP = 128
N_NOISE = 512               # examples/noise1d's own size
#: options93's relative error within this share of the reference's
GATE_SHARE = 0.05


def tier_launches(chunk, ops, u, t):
    """Launches of each tier step of a chunk for one attempt from u at t
    (h=1e-8), by tier: {kernel: launches}."""
    wrappers = chunk_wrappers(chunk)
    f64 = lambda x: torch.full((), x, dtype=torch.float64, device=u.device)
    f0 = ops.rhs(u, f64(t)) if chunk.chain else None
    out = []
    for step in chunk.steps:
        for k in wrappers.values():
            k.launches = 0
        if chunk.chain:
            step(u, f64(t), f64(1e-8), f0)
        else:
            step(u, f64(t), f64(1e-8))
        torch.cuda.synchronize()
        out.append({n: k.launches for n, k in wrappers.items()})
    return out


def solver_run(solver, u0):
    """``solver.solve(u0)`` synchronised: (u, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = solver.solve(u0)
    torch.cuda.synchronize()
    return u, time.perf_counter() - t0


def phase_solver(card):
    """The port's host Solver (solvers/solver.py Solver) on the card.

    (a) options93 (ksfd_tpu_torch/tools/validate.py): the manufactured
        1D problem at its full 128 x 3, 2080 fixed steps of dt=1 with
        default numerics; the relative error against the exact state
        within GATE_SHARE of the reference's 6.18e-5; ms per step;
    (b) the flagship, examples/aggregation2d at its full 1536^2 x 3,
        from ``ic.start_values`` (srho0=90, the clargs' seed), its
        numerics with ``device_loop=True``, FLAG_ACCEPTS accepts from
        dt=1e-8 (after an untimed run of 2): ms per accepted step, the
        chunk's tier calls, host reads, retries, fallback steps and
        rescues; the resid (B1) and delta (B3) launches of the run equal
        each tier's launches per attempt times its calls, and no rhs or
        jvp launch; beside it the bare chunk (make_adaptive_chunk_fn,
        as phase 13) on the same start and the same accepts: equal
        k, t, h and state where the Solver took one dispatch, and the
        Solver's host ms per accept over the chunk's;
    (c) the Solver on the card and on the CPU (plain versions) at
        128^2 x 3 of the flagship's spacing, the device loop, from one
        ic start, SOLVER_CMP_ACCEPTS accepts: k and failures equal, t
        and h to 1e-4 relative, u within 1e-5 of max|u| (phase 18's
        bounds: batched cuBLAS products round apart);
    (d) examples/noise1d at its own 512 x 3 through the Solver with the
        device loop, NOISE_ACCEPTS accepts: every injection at the first
        accept past the variance timing function's next time (each
        chunk bounded there), worms conserved to 1e-12 after each, and
        the draws log(rho'/rho)/sd with mean 0 and variance 1."""
    from ksfd_tpu_torch.solvers import Solver, make_adaptive_chunk_fn
    from ksfd_tpu_torch.solvers.solver import next_noise_time
    from ksfd_tpu_torch.tools import validate
    from ksfd_tpu_torch.tools.flagship import example_numerics

    dev = torch.device("cuda")
    lines = []
    fig = {}
    # (a) options93
    gate = validate.run_gate(nx=128, steps=2080, device=dev)
    rel = gate["rel_err"]
    ref = validate.REFERENCE_REL_ERR
    check(gate["steps"] == 2080 and abs(rel - ref) <= GATE_SHARE * ref,
          "options93 relative error %.4e, reference %.3g" % (rel, ref))
    fig["options93"] = dict(rel_err=rel, max_abs_err=gate["max_abs_err"],
                            ms_per_step=gate["wall_s"] / 2080 * 1e3)
    lines.append("(a) options93 128x3 2080 steps dt=1: relative error %.4e "
                 "(reference %.3g), %.3f ms/step" % (
                     rel, ref, fig["options93"]["ms_per_step"]))
    # (b) the flagship
    clargs = agg2d_clargs(N_AGG)
    ps, grid, ops = problem_from_clargs(clargs, N_AGG, N_AGG, device=dev)
    kern = make_fused_kernels(ops)
    u0 = torch.as_tensor(ic_starts(clargs, grid, ps, 1, clargs.seed)[0],
                         device=dev)
    p0 = ps.params0
    kw = dict(t0=0.0, dt=float(p0["dt"]), tmax=float(p0["tmax"]),
              rtol=float(p0["rtol"]), atol=float(p0["atol"]), kernels=kern)
    nm = example_numerics()
    Solver(ops, nm, maxsteps=2, **kw).solve(u0)
    solver = Solver(ops, nm, maxsteps=FLAG_ACCEPTS, **kw)
    zero_launches(kern)
    u_s, secs = solver_run(solver, u0)
    launches = launch_counts(kern)
    st = solver.stats
    check(solver.k == FLAG_ACCEPTS and not solver.diverged
          and bool(torch.isfinite(u_s).all()),
          "flagship Solver: k=%d diverged=%s" % (solver.k, solver.diverged))
    per_tier = tier_launches(solver._chunk, ops, ops.groom(u0), 0.0)
    want = {n: sum(c * pt[n] for c, pt in zip(st.tier_calls, per_tier))
            for n in launches}
    check(launches == want and launches["resid"] > 0
          and launches["delta"] > 0 and launches["rhs"] == launches["jvp"]
          == 0, "flagship Solver launches %s, want %s (tier calls %s, per "
          "attempt %s)" % (launches, want, st.tier_calls, per_tier))
    chunk, _ = make_adaptive_chunk_fn(ops, nm, atol=kw["atol"],
                                      rtol=kw["rtol"], max_attempts=128,
                                      kernels=kern)
    ug0 = ops.groom(u0)
    run_chunk(chunk, ug0, 0.0, kw["dt"], 2)
    (uc, tc, hc, kc, attc, rejc), csecs, _ = run_chunk(
        chunk, ug0, 0.0, kw["dt"], FLAG_ACCEPTS)
    if st.dispatches == 1:
        check(kc == solver.k and tc == solver.t and hc == solver.h
              and torch.equal(ops.groom(uc), u_s),
              "flagship Solver vs its bare chunk: k %d/%d t %r/%r h %r/%r"
              % (solver.k, kc, solver.t, tc, solver.h, hc))
    fig["flagship"] = dict(
        accepts=solver.k, t=solver.t, h=solver.h,
        ms_per_accept=secs / solver.k * 1e3,
        chunk_ms_per_accept=csecs / kc * 1e3,
        host_ms_per_accept=(secs - csecs) / solver.k * 1e3,
        tier_calls=st.tier_calls, host_reads=st.chunk_attempts
        + st.step_attempts, dispatches=st.dispatches,
        on_device_rejections=st.chunk_rejections,
        host_retries=st.host_retries, fallback_steps=st.fallback_steps,
        exact_rescues=st.exact_rescues, launches=launches,
        launches_per_attempt=per_tier)
    lines.append(
        "(b) aggregation2d %d^2x3 from ic.start_values, device loop, %d "
        "accepts from dt=1e-8 to t=%.6g (h %.4g): %.3f ms/accept (bare "
        "chunk on the same start %.3f, the Solver's host %.3f), %d "
        "dispatches, tier calls %s, %d host reads, %d on-device "
        "rejections, %d host retries, %d fallback steps, %d exact "
        "rescues; launches %s = tier calls x per attempt %s" % (
            N_AGG, solver.k, solver.t, solver.h,
            fig["flagship"]["ms_per_accept"],
            fig["flagship"]["chunk_ms_per_accept"],
            fig["flagship"]["host_ms_per_accept"], st.dispatches,
            st.tier_calls, fig["flagship"]["host_reads"],
            st.chunk_rejections, st.host_retries, st.fallback_steps,
            st.exact_rescues, launches, per_tier))
    u_flag = u_s.cpu()  # phase 31 (a) runs the same start through the CLI
    del solver, chunk, kern, ops, u0, u_s, uc, ug0
    # (c) card vs CPU
    n = N_SOLVER_CMP
    clargs = agg2d_small_clargs(n)
    out = {}
    start = None
    for where in ("cuda", "cpu"):
        ps, grid, ops = problem_from_clargs(clargs, n, n, device=where)
        if start is None:
            start = ic_starts(clargs, grid, ps, 1, clargs.seed)[0]
        s = Solver(ops, nm, t0=0.0, dt=1e-8, tmax=2e5,
                   maxsteps=SOLVER_CMP_ACCEPTS, rtol=float(ps.params0["rtol"]),
                   atol=float(ps.params0["atol"]))
        u = s.solve(start).cpu().numpy()
        out[where] = (s, u)
    (sg, ug), (sc, uc) = out["cuda"], out["cpu"]
    dev_abs = float(np.abs(ug - uc).max())
    scale = float(np.abs(uc).max())
    check(sg.k == sc.k == SOLVER_CMP_ACCEPTS
          and sg.snes_failures == sc.snes_failures
          and abs(sg.t - sc.t) <= 1e-4 * abs(sc.t)
          and abs(sg.h - sc.h) <= 1e-4 * abs(sc.h)
          and dev_abs <= 1e-5 * scale,
          "Solver card vs cpu %d^2: k %d/%d failures %d/%d t %r/%r h %r/%r "
          "u %.3e of %.4e" % (n, sg.k, sc.k, sg.snes_failures,
                              sc.snes_failures, sg.t, sc.t, sg.h, sc.h,
                              dev_abs, scale))
    lines.append("(c) %d^2x3 card vs cpu, %d accepts: t %.6g/%.6g h %.4g/"
                 "%.4g, failures %d, u %.3e of max|u| %.4e" % (
                     n, sg.k, sg.t, sc.t, sg.h, sc.h, sg.snes_failures,
                     dev_abs, scale))
    fig["card_vs_cpu"] = dict(accepts=sg.k, t=(sg.t, sc.t), h=(sg.h, sc.h),
                              u_max_abs_dev=dev_abs)
    del out
    # (d) noise1d
    clargs = make_clargs(params=example_params("noise1d")
                         + ["nelements=%d" % N_NOISE])
    ps, grid, ops = problem_from_clargs(clargs, N_NOISE, device=dev)
    u0 = torch.as_tensor(ic_starts(clargs, grid, ps, 1, clargs.seed)[0],
                         device=dev)
    p0 = ps.params0
    solver = Solver(ops, example_numerics(), t0=0.0, dt=float(p0["dt"]),
                    tmax=float(p0["tmax"]), maxsteps=NOISE_ACCEPTS,
                    rtol=float(p0["rtol"]), atol=float(p0["atol"]),
                    rng_state=clargs.seed)
    check(solver._chunk is not None, "noise1d runs the device loop")
    draws, marks, exits = [], [], []
    add_variance = solver.add_variance

    def recorded(u, dt, t):
        u1 = add_variance(u, dt, t)
        sd = math.sqrt(float(ps.funcs["variance_rate"](t)) * dt)
        draws.append((torch.log(u1[0] / u[0]) / sd).cpu().numpy())
        return u1
    solver.add_variance = recorded
    chunk = solver._chunk

    def bounded(u, t, h, tmax, max_acc):
        """The chunk, its bound and exit recorded."""
        res = chunk(u, t, h, tmax, max_acc)
        bounded.stats = chunk.stats
        acc = [hh for _, e, hh in chunk.stats.records if e <= 1.0]
        exits.append((t, tmax, res[1], acc[-1] if acc else None))
        return res
    bounded.tiers = chunk.tiers
    solver._chunk = bounded
    solver.add_monitor(lambda s, k, t, u: marks.append(
        (t, s.lastvart, float(torch.sum(u[0])))))
    u, secs = solver_run(solver, u0)
    Nw = marks[0][2]
    vtf = ps.funcs["variance_timing_function"]
    injections = [(t, lv) for t, lv, _ in marks[1:] if lv == t]
    check(solver.k == NOISE_ACCEPTS and len(injections) >= 3
          and len(injections) == len(draws) == solver.stats.injections,
          "noise1d: k=%d, %d injections, %d draws" % (
              solver.k, len(injections), len(draws)))
    prev = 0.0
    for t_i, _ in injections:
        tn = next_noise_time(ps, prev, float(p0["tmax"]))
        hit = [e for e in exits if e[2] == t_i]
        check(tn is not None and hit and abs(hit[0][1] - tn) <= 1e-12 * tn
              and t_i >= tn and t_i - hit[0][3] <= tn
              and float(vtf(t_i)) - float(vtf(prev)) >= 1.0,
              "noise1d injection at t=%r: next noise time %r, exit %s" % (
                  t_i, tn, hit))
        prev = t_i
    cons = max(abs(w - Nw) / Nw for t, lv, w in marks[1:] if lv == t)
    check(cons <= 1e-12, "noise1d conservation %.3e" % cons)
    z = np.concatenate(draws)
    zmean, zvar = float(z.mean()), float(z.var())
    check(abs(zmean) <= 5.0 / math.sqrt(z.size)
          and abs(zvar - 1.0) <= 5.0 * math.sqrt(2.0 / z.size),
          "noise1d draws: mean %.4f variance %.4f of %d" % (
              zmean, zvar, z.size))
    fig["noise1d"] = dict(accepts=solver.k, t=solver.t,
                          injections=[t for t, _ in injections],
                          conservation=cons, z_mean=zmean, z_var=zvar,
                          ms_per_accept=secs / solver.k * 1e3,
                          dispatches=solver.stats.dispatches)
    lines.append("(d) noise1d %dx3, %d accepts to t=%.6g in %d dispatches "
                 "(%.3f ms/accept): %d injections at t %s, each the first "
                 "accept past the next noise time; conservation %.2e; "
                 "draws mean %.4f variance %.4f of %d" % (
                     N_NOISE, solver.k, solver.t, solver.stats.dispatches,
                     fig["noise1d"]["ms_per_accept"], len(injections),
                     ["%.6g" % t for t, _ in injections], cons, zmean, zvar,
                     z.size))
    print("phase 30 host Solver (%s): %s" % (card, " | ".join(lines)))
    return fig, u_flag


#: phase 31's cut of examples/hexagons2d's --ensemble run: members and
#: accepted steps per member
CLI_MEMBERS = 4
CLI_ENS_ACCEPTS = 8
#: where phase 31 writes its options files (and, with h5py, its series)
CLI_DIR = os.path.join(OUT_DIR, "phase31")


def cut_options(example, name, **lines):
    """examples/<example> without its --save and --check lines, with
    the parameter lines ``lines`` in place of the file's, written under
    CLI_DIR: '@<path>' (the card's machine has no h5py, and the
    driver refuses duplicated parameters)."""
    os.makedirs(CLI_DIR, exist_ok=True)
    with open(os.path.join(ROOT, "examples", example)) as fh:
        src = fh.read().splitlines()
    src = [ln for ln in src if not ln.startswith(("--save=", "--check="))
           and ln.split("=", 1)[0] not in lines]
    path = os.path.join(CLI_DIR, name)
    with open(path, "w") as fh:
        fh.write("\n".join(src + ["%s=%s" % kv for kv in lines.items()])
                 + "\n")
    return "@" + path


def phase_entry_point(card, flag30, u_flag):
    """The port's driver (ksfd_tpu_torch/ksfdsolver.py main, what
    ``python -m ksfd_tpu_torch`` runs) in this process on the card.

    (a) examples/aggregation2d at its full 1536^2 x 3 without its
        --save/--check lines, maxsteps=FLAG_ACCEPTS, with the example's
        own ``--numerics -device_loop 1 --``: k, t, h and the state
        equal phase 30 (b)'s direct Solver run bit for bit (the same
        seed, the same start); exactly FLAG_ACCEPTS x (8, 4) resid (B1)
        and delta (B3) launches, phase 30 (b)'s, and no other; the
        CLI's setup seconds apart from its ms per accept;
    (b) options92: examples/eigenmode1d cut to tmax=20000 (as
        tests/test_gates.py:40 cuts it), its PETSc block routed to the
        banded exact tier: 100 <= k <= 500, the last step longer than
        2000, 4 peaks, 200 < min rho < 600, 20000 < max rho < 28000;
        steps, failures, seconds;
    (c) --ensemble=CLI_MEMBERS on examples/hexagons2d at its own
        384^2 x 3 with -device_loop 1, CLI_ENS_ACCEPTS accepts: every
        member's k, t, h and state equal EnsembleSolver run directly on
        the same starts (ic_starts, member i seeded seed + i; noise
        seed = seed); ms per accepted ensemble step;
    (d) without h5py (the card's machine has none): 'h5py: absent', and
        --save raises the KSFDException naming h5py before any step;
        with h5py: 3 steps with checkpoints and a --resume of 3 more
        against 6 straight steps (tests/test_torch_driver.py's 1D
        problem), bit for bit."""
    from ksfd_tpu_torch import KSFDException
    from ksfd_tpu_torch.solvers import EnsembleSolver
    from ksfd_tpu_torch.utils.cli import decode_numerics

    lines = []
    fig = {}
    loop = ("--numerics", "-device_loop", "1", "--")
    # (a) the flagship
    opt = cut_options("aggregation2d", "aggregation2d",
                      maxsteps=FLAG_ACCEPTS)
    status, s, setup, rest = drive_cli(opt, *loop)
    launches = launch_counts(s.kernels)
    want = {"resid": 8 * FLAG_ACCEPTS, "delta": 4 * FLAG_ACCEPTS,
            "jvp": 0, "rhs": 0}
    check(status == 0 and s.k == flag30["accepts"] == FLAG_ACCEPTS
          and s.t == flag30["t"] and s.h == flag30["h"]
          and torch.equal(s.u.cpu(), u_flag),
          "the CLI's flagship against phase 30 (b): status %d k %d/%d t %r/%r "
          "h %r/%r" % (status, s.k, flag30["accepts"], s.t, flag30["t"],
                       s.h, flag30["h"]))
    check(launches == want == flag30["launches"],
          "the CLI's flagship launches %s, want %s (phase 30 (b) %s)" % (
              launches, want, flag30["launches"]))
    fig["flagship"] = dict(
        accepts=s.k, t=s.t, h=s.h, setup_s=setup,
        ms_per_accept=rest / s.k * 1e3,
        solver_ms_per_accept_phase30=flag30["ms_per_accept"],
        dispatches=s.stats.dispatches, tier_calls=s.stats.tier_calls,
        launches=launches)
    lines.append(
        "(a) python -m ksfd_tpu_torch @examples/aggregation2d (no --save/"
        "--check, maxsteps=%d) --numerics -device_loop 1 --, %d^2x3: setup "
        "%.2f s (parse, sympy, kernels, start), %.3f ms/accept (phase 30 "
        "(b) %.3f), %d dispatches; k, t=%.6g, h=%.4g and state equal phase "
        "30 (b) bit for bit; launches %s" % (
            FLAG_ACCEPTS, N_AGG, setup, fig["flagship"]["ms_per_accept"],
            flag30["ms_per_accept"], s.stats.dispatches, s.t, s.h,
            launches))
    del s
    # (b) options92
    opt = cut_options("eigenmode1d", "eigenmode1d", tmax=20000)
    t0 = time.perf_counter()
    status, s, setup, rest = drive_cli(opt)
    secs = time.perf_counter() - t0
    rho = s.u[0].cpu().numpy()
    (_, k_prev, t_prev), (_, k_last, t_last) = s.records[-2:]
    peaks = int((np.diff(np.r_[rho > rho.mean(), (rho > rho.mean())[0]]
                         .astype(int)) == 1).sum())
    check(status == 0 and s.numerics.ksp_type == "banded"
          and 100 <= s.k <= 500 and t_last >= 20000.0
          and t_last - t_prev > 2000.0 and peaks == 4
          and 200.0 < rho.min() < 600.0 and 20000.0 < rho.max() < 28000.0
          and float(s.u[1:].min()) > 0.0,
          "options92: status %d ksp %s k %d last step %.4g peaks %d rho "
          "[%.4g, %.4g]" % (status, s.numerics.ksp_type, s.k,
                            t_last - t_prev, peaks, rho.min(), rho.max()))
    fig["options92"] = dict(steps=s.k, failures=s.snes_failures,
                            seconds=secs, setup_s=setup, t=t_last,
                            last_step=t_last - t_prev, peaks=peaks,
                            rho_min=float(rho.min()),
                            rho_max=float(rho.max()))
    lines.append(
        "(b) options92 (eigenmode1d 128x3, tmax=2e4, banded exact tier): "
        "%d steps, %d failures, %.2f s (setup %.2f), last step %.4g, %d "
        "peaks, rho [%.2f, %.2f]" % (
            s.k, s.snes_failures, secs, setup, t_last - t_prev, peaks,
            rho.min(), rho.max()))
    del s
    # (c) the ensemble
    opt = cut_options("hexagons2d", "hexagons2d", maxsteps=CLI_ENS_ACCEPTS)
    argv = (opt, "--ensemble=%d" % CLI_MEMBERS) + loop
    status, es, setup, rest = drive_cli(*argv)
    ens_launches = launch_counts(es.kernels)
    from ksfd_tpu_torch import ksfdsolver

    clargs = ksfdsolver.parse_commandline(list(argv))
    ps, grid, ops = problem_from_clargs(clargs, N_HEX, N_HEX, device="cuda")
    p0 = ps.params0
    direct = EnsembleSolver(
        ops, decode_numerics(clargs.numerics, petsc_tokens=clargs.petsc),
        t0=0.0, dt=float(p0["dt"]), tmax=float(p0["tmax"]),
        maxsteps=CLI_ENS_ACCEPTS, rtol=float(p0["rtol"]),
        atol=float(p0["atol"]), rng_key=clargs.seed)
    out = direct.solve(ic_starts(clargs, grid, ps, CLI_MEMBERS, clargs.seed))
    check(status == 0 and (es.ks == out.k).all() and (es.ks ==
          CLI_ENS_ACCEPTS).all() and (es.ts == out.t).all()
          and (es.hs == out.h).all() and torch.equal(es.u, out.u)
          and ens_launches["resid"] > 0 and ens_launches["delta"] > 0,
          "--ensemble=%d against EnsembleSolver: status %d k %s/%s t %s/%s "
          "launches %s" % (CLI_MEMBERS, status, es.ks, out.k, es.ts, out.t,
                           ens_launches))
    fig["ensemble"] = dict(members=CLI_MEMBERS, accepts=CLI_ENS_ACCEPTS,
                           setup_s=setup,
                           ms_per_ensemble_accept=rest / CLI_ENS_ACCEPTS
                           * 1e3, t=list(es.ts), launches=ens_launches)
    lines.append(
        "(c) --ensemble=%d hexagons2d %d^2x3, device loop, %d accepts: setup "
        "%.2f s, %.3f ms per accepted ensemble step; k, t, h and states "
        "equal EnsembleSolver run directly bit for bit; launches %s" % (
            CLI_MEMBERS, N_HEX, CLI_ENS_ACCEPTS, setup,
            fig["ensemble"]["ms_per_ensemble_accept"], ens_launches))
    del es, direct, out, ops
    # (d) h5py
    try:
        import h5py  # noqa: F401
    except ImportError:
        h5 = False
    else:
        h5 = True
    tiny = os.path.join(CLI_DIR, "tiny")
    common = ["tmax=1e6", "width=1", "nelements=16", "dim=1", "degree=3",
              "atol=0.01", "rtol=1e-6", "sigma=0.02357", "s2=sigma**2/2",
              "Nworms=0", "srho0=0", "rho0=9000+100*sin(2*pi*x)",
              "ngroups=1", "nligands_1=1", "alpha_1=1500",
              "beta_1=5.56e-4", "s_1_1=0.01", "gamma_1_1=0.01",
              "D_1_1=1e-6"]
    if not h5:
        try:
            status, s, _, _ = drive_cli("--save=" + tiny, "dt=0.1",
                                        "maxsteps=2", *common)
        except KSFDException as e:
            refused = str(e)
        else:
            refused = None
        check(refused is not None and "h5py" in refused,
              "--save without h5py: %r" % (refused,))
        fig["h5py"] = dict(present=False, refusal=refused)
        lines.append("(d) h5py: absent; --save refused before any step: %s"
                     % refused)
    else:
        from ksfd_tpu_torch.io import TimeSeries
        from ksfd_tpu_torch.tools.lastcheckpoint import last_checkpoint

        sa = drive_cli("--save=" + tiny + "A", "dt=0.1", "maxsteps=6",
                       *common)[1]
        drive_cli("--check=" + tiny + "cp", "dt=0.1", "maxsteps=3", *common)
        cp = last_checkpoint(tiny + "cp")
        sc = drive_cli("--save=" + tiny + "C", "--resume=" + cp,
                       "maxsteps=6", *common)[1]
        ta, tc = (TimeSeries(p, mode="r") for p in (tiny + "A", tiny + "C"))
        ua = ta.retrieve_by_time(ta.sorted_times()[-1])
        uc = tc.retrieve_by_time(tc.sorted_times()[-1])
        check(cp.endswith("_3_") and sa.k == sc.k == 6 and sa.t == sc.t
              and np.array_equal(ua, uc),
              "3 + 3 resume on the card: %s k %d/%d t %r/%r" % (
                  cp, sa.k, sc.k, sa.t, sc.t))
        ta.close()
        tc.close()
        fig["h5py"] = dict(present=True, resume_k=sc.k, t=sc.t)
        lines.append("(d) h5py: present; 3 + 3 resume equal to 6 straight "
                     "steps bit for bit (t=%.6g)" % sc.t)
    print("phase 31 entry point (%s): %s" % (card, " | ".join(lines)))
    return fig


#: phase 32's DIRK paths at 1024^2 x 3: (label, NumericsOptions fields,
#: fast mode, launches per chained step at 3 sweeps, h).  The fast mode
#: runs at h=1e-2: at h=1 its float32 stage values, whose rounding the
#: ESDIRK combination adds to u undamped, blow up on the near-uniform
#: 1024^2 state, in the reference too (error norms 44.9, then 83795, on
#: the CPU through its XLA path)
DIRK_PATHS = [
    ("ark324", dict(ts_type="arkimex"), False,
     dict(rhs=0, jvp=0, resid=12, delta=10), 1.0),
    ("ark436", dict(ts_type="ark436"), False,
     dict(rhs=0, jvp=0, resid=20, delta=16), 1.0),
    ("ark324", dict(ts_type="arkimex"), True,
     dict(rhs=10, jvp=12, resid=0, delta=0), 1e-2),
]
N_DIRK_CMP = 128
#: phase 32 (d) runs the arkimex gate's first steps, past its first
#: failures: the whole gate (python -m ksfd_tpu_torch.tools.arkimex_gate)
#: is its GMRES fallback for most of its steps, launch-bound on the card
#: (390.58 s in PR 16's chip run), past this script's time limit
DIRK_GATE_HEAD = 12


def phase_dirk(card, rosw_flag, rosw_f64, rosw_f32):
    """Phase 32, the DIRK path (ARK324 and ARK436, solvers/solver.py
    ``_combine_dirk``) on the card.

    (a) the fixed-dt chained multistep at 1024^2 x 3, ARK324 and ARK436
        in float64 at h=1 and ARK324 in the fast mode at h=1e-2
        (DIRK_PATHS; phase_main_path:
        exact launches per step, slope-timed ms/step, the profiled
        device split), beside phases 3 and 9's ROS34PW2 figures;
    (b) card against CPU at 128^2 x 3 for 4 steps, ARK324 f64 and f32
        and ARK436 f64, within phase 4's and 10's gates;
    (c) the flagship (examples/aggregation2d, 1536^2 x 3) through
        ``main`` with ``--numerics -device_loop 1 -ts_type arkimex --``
        for FLAG_ACCEPTS accepts from ic.start_values: ms per accept
        beside phase 31 (a)'s rosw run, launches = tier calls x per
        attempt (rich3: 12 resid, 10 delta);
    (d) the reference's arkimex gate (tests/test_gates.py:80,
        tools/arkimex_gate.py: examples/eigenmode1d cut to tmax=2e4
        with ``-ts_type arkimex`` at its ``-snes_type ksponly``), its
        first DIRK_GATE_HEAD steps: the card, finite, the float64 GMRES
        fallback run (the whole gate is the tool's own run);
    (e) ``--ensemble=4`` on examples/hexagons2d at 384^2 x 3 with
        arkimex on the device loop, CLI_ENS_ACCEPTS accepts."""
    fig = {}
    big = "%d^2" % N_BIG
    for label, extra, fast32, per_step, h in DIRK_PATHS:
        key = "%s_%s" % (label, "f32" if fast32 else "f64")
        f = {}
        counts, step_s, _ = phase_main_path(
            card, big, bench_clargs(N_BIG), (N_BIG, N_BIG), 32,
            fast32=fast32, extra=extra, per_step=per_step, label=label,
            figures=f, h=h)
        f.update(launches=counts, h=h)
        f["ms_per_step_rosw"] = (rosw_f32 if fast32 else rosw_f64)[
            "ms_per_step"]
        f["device_ms_rosw"] = (rosw_f32 if fast32 else rosw_f64)[
            "device_ms"]
        fig[key] = f
    cmp = "%d^2" % N_DIRK_CMP
    for extra, fast32 in ((dict(ts_type="arkimex"), False),
                          (dict(ts_type="arkimex"), True),
                          (dict(ts_type="ark436"), False)):
        fig["card_vs_cpu_%s_%s" % (extra["ts_type"], "f32" if fast32
                                   else "f64")] = phase_card_vs_cpu(
            card, cmp, bench_clargs(N_DIRK_CMP), (N_DIRK_CMP,) * 2,
            rough_state, 32, fast32=fast32, extra=extra)
    lines = []
    ark = ("--numerics", "-device_loop", "1", "-ts_type", "arkimex", "--")
    # (c) the flagship through main
    opt = cut_options("aggregation2d", "aggregation2d_arkimex",
                      maxsteps=FLAG_ACCEPTS)
    status, s, setup, rest = drive_cli(opt, *ark)
    launches = launch_counts(s.kernels)
    st = s.stats
    per_tier = tier_launches(s._chunk, s.ops, s.ops.groom(s.u), s.t)
    want = {n: sum(c * pt[n] for c, pt in zip(st.tier_calls, per_tier))
            for n in launches}
    check(status == 0 and s.k == FLAG_ACCEPTS and not s.diverged
          and s.tableau.name == "ark324l2sa"
          and bool(torch.isfinite(s.u).all()),
          "the arkimex flagship: status %d k %d diverged %s tableau %s" % (
              status, s.k, s.diverged, s.tableau.name))
    check(launches == want and per_tier[0] == dict(
        rhs=0, jvp=0, resid=12, delta=10),
          "the arkimex flagship's launches %s, want %s (tier calls %s, per "
          "attempt %s)" % (launches, want, st.tier_calls, per_tier))
    fig["flagship"] = dict(
        accepts=s.k, t=s.t, h=s.h, setup_s=setup,
        ms_per_accept=rest / s.k * 1e3,
        rosw_ms_per_accept_phase31=rosw_flag["ms_per_accept"],
        rosw_t_phase31=rosw_flag["t"], dispatches=st.dispatches,
        tier_calls=st.tier_calls, on_device_rejections=st.chunk_rejections,
        host_retries=st.host_retries, fallback_steps=st.fallback_steps,
        launches=launches, launches_per_attempt=per_tier)
    lines.append(
        "(c) python -m ksfd_tpu_torch @examples/aggregation2d (maxsteps=%d) "
        "--numerics -device_loop 1 -ts_type arkimex --, %d^2x3: setup %.2f "
        "s, %.3f ms/accept to t=%.6g (rosw, phase 31 (a): %.3f to t=%.6g), "
        "%d dispatches, tier calls %s, %d on-device rejections, %d host "
        "retries; launches %s = tier calls x per attempt %s" % (
            FLAG_ACCEPTS, N_AGG, setup, fig["flagship"]["ms_per_accept"],
            s.t, rosw_flag["ms_per_accept"], rosw_flag["t"], st.dispatches,
            st.tier_calls, st.chunk_rejections, st.host_retries, launches,
            per_tier))
    del s
    # (d) the arkimex gate's first steps (the whole gate: the tool)
    gate = arkimex_gate.run(maxsteps=DIRK_GATE_HEAD)
    check(gate["ok"] and gate["device"].startswith("cuda")
          and gate["fallback_steps"] > 0,
          "the arkimex gate's first %d steps: %s" % (DIRK_GATE_HEAD, gate))
    fig["arkimex_gate_head"] = gate
    lines.append(
        "(d) the arkimex gate's first %d steps (eigenmode1d 128x3, "
        "-ts_type arkimex, -snes_type ksponly, iterative: the direct tier "
        "is Rosenbrock-only): to t=%.6g, %d failures, %d fallback steps "
        "(GMRES, 4 Newton iterations), %.2f s (setup %.2f); the whole "
        "gate is python -m ksfd_tpu_torch.tools.arkimex_gate" % (
            gate["steps"], gate["t"], gate["failures"],
            gate["fallback_steps"], gate["seconds"], gate["setup_s"]))
    # (e) the ensemble
    opt = cut_options("hexagons2d", "hexagons2d_arkimex",
                      maxsteps=CLI_ENS_ACCEPTS)
    status, es, setup, rest = drive_cli(opt, "--ensemble=%d" % CLI_MEMBERS,
                                        *ark)
    ens_launches = launch_counts(es.kernels)
    check(status == 0 and (es.ks == CLI_ENS_ACCEPTS).all()
          and es.tableau.name == "ark324l2sa"
          and bool(torch.isfinite(es.u).all())
          and ens_launches["resid"] > 0 and ens_launches["delta"] > 0,
          "--ensemble=%d arkimex: status %d k %s launches %s" % (
              CLI_MEMBERS, status, es.ks, ens_launches))
    fig["ensemble"] = dict(members=CLI_MEMBERS, accepts=CLI_ENS_ACCEPTS,
                           setup_s=setup,
                           ms_per_ensemble_accept=rest / CLI_ENS_ACCEPTS
                           * 1e3, t=list(es.ts), launches=ens_launches,
                           tier_calls=list(es._chunk.totals.calls))
    lines.append(
        "(e) --ensemble=%d hexagons2d %d^2x3 -ts_type arkimex (ksponly), "
        "device loop, %d accepts: setup %.2f s, %.3f ms per accepted "
        "ensemble step, tier calls %s; launches %s" % (
            CLI_MEMBERS, N_HEX, CLI_ENS_ACCEPTS, setup,
            fig["ensemble"]["ms_per_ensemble_accept"],
            list(es._chunk.totals.calls), ens_launches))
    del es
    print("phase 32 DIRK (%s): %s" % (card, " | ".join(lines)))
    return fig


#: phase 33's pc forms: (label, NumericsOptions fields)
PC_FORMS = [("fft", dict(pc_fft="on")), ("spectral", dict(pc_type="spectral")),
            ("bf16", dict(pc_dtype="bfloat16"))]


def phase_pc_forms(card, gemm_f64, gemm_f32):
    """Phase 33, the preconditioner forms beside the block pc's basis
    GEMMs (solvers/linalg.py): the FFT block pc (``pc_fft`` on, cuFFT
    through torch.fft), the spectral pc and the single-card bfloat16
    block pc, each on the 2D main path at 1024^2 x 3 in float64 and the
    fast mode (phase_main_path: the default launches per step, ms/step,
    the device split against phases 3 and 9's basis-GEMM pc); the FFT
    block pc at 256^3 x 3; each form on the card against the CPU at
    128^2 x 3 (within 1e-5 of the increment; the bfloat16 pc within
    1e-4, its M rounding apart on the two devices, as its CPU test
    against the reference holds it)."""
    fig = {}
    big = "%d^2" % N_BIG
    for label, extra in PC_FORMS:
        for fast32 in (False, True):
            f = {}
            counts, _, _ = phase_main_path(
                card, big, bench_clargs(N_BIG), (N_BIG, N_BIG), 33,
                fast32=fast32, extra=extra, label=label, figures=f)
            gemm = gemm_f32 if fast32 else gemm_f64
            f.update(launches=counts,
                     basis_gemm_ms_per_step=gemm["ms_per_step"],
                     basis_gemm_device_ms=gemm["device_ms"],
                     basis_gemm_groups=gemm["groups"])
            if label == "fft":
                check(f["groups"]["fft"] > 0 and f["groups"]["gemm"] == 0,
                      "the FFT pc's profile shows cuFFT and no GEMM: %s"
                      % f["groups"])
            fig["%s_%s" % (label, "f32" if fast32 else "f64")] = f
    f = {}
    counts, _, _ = phase_main_path(
        card, "%d^3" % N3_BIG, agg3d_clargs(N3_BIG), (N3_BIG,) * 3, 33,
        extra=dict(pc_fft="on"), label="fft", figures=f)
    f["launches"] = counts
    fig["fft_3d_f64"] = f
    cmp = "%d^2" % N_DIRK_CMP
    for label, extra in PC_FORMS:
        fig["card_vs_cpu_" + label] = phase_card_vs_cpu(
            card, cmp, bench_clargs(N_DIRK_CMP), (N_DIRK_CMP,) * 2,
            rough_state, 33, extra=extra,
            rel=1e-4 if label == "bf16" else 1e-5)
    print("phase 33 pc forms (%s): device ms/step f64, f32 (basis-GEMM "
          "%.4f, %.4f): %s" % (
              card, gemm_f64["device_ms"], gemm_f32["device_ms"],
              "; ".join("%s %.4f, %.4f (GEMM %.4f, %.4f; FFT %.4f, %.4f)" % (
                  label, fig[label + "_f64"]["device_ms"],
                  fig[label + "_f32"]["device_ms"],
                  fig[label + "_f64"]["groups"]["gemm"],
                  fig[label + "_f32"]["groups"]["gemm"],
                  fig[label + "_f64"]["groups"]["fft"],
                  fig[label + "_f32"]["groups"]["fft"])
                  for label, _ in PC_FORMS)))
    return fig


#: phase 34's field counts of B5 beyond 2..4: 1 (no ligand, the NF = 1
#: instance) and 5, 6 (the plain second product and the arrow pass)
B5_FIELDS = (1, 5, 6)
#: the 5-field pc_pallas main path of phase 34
PC_NF = 5


def phase_b5_fields(card):
    """Phase 34, B5 (pc2d.cu) at the field counts pc2d.cu took last:

    (a) B5a (pc_fwd) and B5b (pc_inv) at 1024^2 x nf for nf in B5_FIELDS
        (tools/problems.py with_fields: the bench problem with no ligand
        or with 4 and 5 ligands), the scalar pack of a step at h=1 from
        the rough state and a seeded v: within 1e-5 of max|plain|; NB
        members under vmap one launch, bit for bit the NB single
        launches; CUDA-event ms of each entry, its plain version and the
        basis-GEMM pc's cuBLAS products for the same apply, and the
        bound (3xTF32, scaled by nf; pc_bound);
    (b) the ``-pc_pallas 1`` main path at 1024^2 x PC_NF (phase_main_path:
        12 pc_fwd and 12 pc_inv per step beside 8 resid and 4 delta,
        ms/step, device ms, no library GEMM), and card against CPU at
        128^2 x PC_NF within 1e-5 of the increment."""
    from ksfd_tpu_torch.ops.fused_pc import make_fused_block_pc
    from ksfd_tpu_torch.solvers.linalg import BlockSpectralPreconditioner

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(34)
    fig, lines = {"fields": {}}, []
    for dof in B5_FIELDS:
        ps, grid, ops = problem_from_clargs(bench_clargs(N_BIG, dof), N_BIG,
                                            N_BIG, device=dev)
        check(grid.dof == dof, "%d fields: grid dof %d" % (dof, grid.dof))
        pc = make_fused_block_pc(grid, ops)
        base = torch.as_tensor(rough_state(grid, ps), device=dev)
        shift, t, means, rho_diff, sc = pc_step_scalars(ops, base)
        v = torch.randn(tuple(grid.Vshape), generator=gen, device=dev)
        modes = pc.fwd(sc, v)
        out = pc.inv(modes)
        per = {}
        for name, got, ref in (("pc_fwd", modes, pc.fwd.plain(sc, v)),
                               ("pc_inv", out, pc.inv.plain(modes))):
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            check(bool(torch.isfinite(got).all()) and err <= 1e-5 * scale,
                  "%s with %d fields: max err %.3e > 1e-5 * %.3e"
                  % (name, dof, err, scale))
            per[name] = dict(max_abs_err=err, max_rel_err=err / scale)
        per_fwd = [(pc_step_scalars(ops, base * (1.0 + 0.05 * i),
                                    h=1.0 + i)[-1],
                    torch.randn(tuple(grid.Vshape), generator=gen,
                                device=dev)) for i in range(NB)]
        per_inv = [(pc.fwd(*a),) for a in per_fwd]
        for k, args in ((pc.fwd, per_fwd), (pc.inv, per_inv)):
            err, scale = hold_batched(k, args)
            per[k.name]["nb%d_bitwise" % NB] = True
            per[k.name]["nb%d_max_rel_err" % NB] = err / scale
        lib = BlockSpectralPreconditioner(grid, ops, compute_dtype="float32",
                                          device=dev)
        fwd_in = pc.fwd.prepare(sc, v)
        inv_in = pc.inv.prepare(modes)
        for name, k, args, library in (
                ("pc_fwd", pc.fwd, fwd_in,
                 lambda: lib._arrow_solve(lib._forward(v), shift, t, means,
                                          rho_diff)),
                ("pc_inv", pc.inv, inv_in, lambda: lib._inverse(modes))):
            bound_ms, bound_by, _ = pc_bound(name, grid)
            per[name].update(
                ms=cuda_ms(lambda: k.launch(*args), 30),
                plain_ms=cuda_ms(lambda: k.body(*args), 5),
                library_ms=cuda_ms(library, 5),
                bound_ms=bound_ms, bound_by=bound_by)
        fig["fields"][dof] = per
        lines.append("%d^2x%d: %s" % (N_BIG, dof, "; ".join(
            "%s %.2f us (bound %.2f, %s; plain %.2f; cuBLAS %.2f), err "
            "%.2e rel, nb=%d bitwise" % (
                n, f["ms"] * 1e3, f["bound_ms"] * 1e3, f["bound_by"],
                f["plain_ms"] * 1e3, f["library_ms"] * 1e3,
                f["max_rel_err"], NB) for n, f in per.items())))
        del pc, base, lib, modes, out, per_fwd, per_inv, fwd_in, inv_in
    f = {}
    counts, _, _ = phase_main_path(
        card, "%d^2" % N_BIG, bench_clargs(N_BIG, PC_NF), (N_BIG, N_BIG), 34,
        pc_pallas=True, label="nf%d" % PC_NF, figures=f)
    f["launches"] = counts
    fig["pc_pallas_nf%d" % PC_NF] = f
    fig["card_vs_cpu_pc_pallas_nf%d" % PC_NF] = phase_card_vs_cpu(
        card, "%d^2 %d fields" % (N_DIRK_CMP, PC_NF),
        bench_clargs(N_DIRK_CMP, PC_NF), (N_DIRK_CMP,) * 2, rough_state, 34,
        pc_pallas=True)
    print("phase 34 B5 at %s fields (%s): %s | pc_pallas %d^2x%d: %.4f "
          "ms/step, device %.4f ms, launches/10 steps %s" % (
              "/".join(map(str, B5_FIELDS)), card, " | ".join(lines), N_BIG,
              PC_NF, f["ms_per_step"], f["device_ms"], counts))
    return fig


#: phase 35's gmres_rolled: GMRES(ROLLED_M), ROLLED_CYCLES cycles per
#: stage solve (the defaults, 50 cycles of GMRES(20), would take some 4200
#: jvp launches a step)
ROLLED_M, ROLLED_CYCLES = 8, 2
ROLLED = dict(ksp_type="gmres_rolled", ksp_restart=ROLLED_M,
              ksp_max_it=ROLLED_CYCLES)
#: jvp launches per step of the mixed gmres_rolled path: 4 stage solves,
#: each ROLLED_CYCLES cycles of one residual and ROLLED_M Arnoldi W applies
ROLLED_JVP = 4 * ROLLED_CYCLES * (ROLLED_M + 1)
ROLLED_CHUNK_ACCEPTS = 12


def phase_krylov_with_g_flux(card, cli_flagship):
    """Phase 35, the fixed-count Krylov tiers, with-G states and the
    flux form on the card.

    (a) ``-ksp_type gmres_rolled`` (ROLLED) on the 2D main path at
        1024^2 x 3 in float64: mixed32, W = shift v - jvp(v) from B2
        inside the float64 step, the stage right-hand sides on B3; exact
        launches per chained step (ROLLED_JVP jvp, 4 delta, no resid),
        ms/step, device ms; card against CPU at 128^2 x 3; the adaptive
        chunk with gmres_rolled (one tier) for ROLLED_CHUNK_ACCEPTS
        accepts at 1024^2 x 3 from the near-uniform state, launches =
        attempts x (ROLLED_JVP, 4);
    (b) ``-ksp_type gmres`` and ``-pc_type none -ksp_type richardson``
        card against CPU at 128^2 x 3 (no full-width timing: each is a
        float64 GMRES of 3 W applies per stage, off the main path);
    (c) ``--with_g`` through ``main`` on examples/aggregation2d at its
        1536^2 x (3+1), device loop, FLAG_ACCEPTS accepts from phase
        31's start: the unfused step (no stencil kernel: the kernels
        refuse with-G states, as the reference's do), ms per accept
        beside phase 31 (a)'s, and the stored G slot against ``ops.G``
        of the fields after the last accept (max relative difference,
        float64);
    (d) ``flux_form=True`` on the 2D cell at 1024^2 x 3, float64: the
        unfused step (the kernels refuse it), slope-timed ms/step over
        a chain, and sum(rho)'s drift over 10 chained steps (conserved to
        the float32 sweeps' roundoff)."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.solvers import make_adaptive_chunk_fn
    from ksfd_tpu_torch.solvers import make_multistep_fn

    dev = torch.device("cuda")
    fig, lines = {}, []
    big = "%d^2" % N_BIG
    # (a) gmres_rolled over B2 on the f64 path
    f = {}
    counts, _, _ = phase_main_path(
        card, big, bench_clargs(N_BIG), (N_BIG, N_BIG), 35, extra=ROLLED,
        per_step=dict(rhs=0, jvp=ROLLED_JVP, resid=0, delta=4),
        label="gmres_rolled", figures=f)
    check(f["build_info"]["mixed32"], "gmres_rolled runs mixed32")
    f["launches"] = counts
    fig["gmres_rolled_f64"] = f
    cmp = "%d^2" % N_DIRK_CMP
    fig["card_vs_cpu_gmres_rolled"] = phase_card_vs_cpu(
        card, cmp, bench_clargs(N_DIRK_CMP), (N_DIRK_CMP,) * 2, rough_state,
        35, extra=ROLLED)
    ps, grid, ops = problem_from_clargs(bench_clargs(N_BIG), N_BIG, N_BIG,
                                        device=dev)
    kern = make_fused_kernels(ops)
    chunk, _ = make_adaptive_chunk_fn(ops, NumericsOptions(**ROLLED),
                                      atol=0.01, rtol=1e-6, kernels=kern)
    check(chunk.tiers == [("gmres_rolled", 3)] and chunk.chain,
          "the gmres_rolled chunk: one chained tier, %s" % chunk.tiers)
    u0 = torch.as_tensor(initial_state(grid), device=dev)
    zero_launches(kern)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, t, h, k, attempts, rej = chunk(u0, 0.0, 1.0, 1e9,
                                      ROLLED_CHUNK_ACCEPTS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts(kern)
    check(k == ROLLED_CHUNK_ACCEPTS and not rej
          and bool(torch.isfinite(u).all())
          and launches == dict(rhs=0, jvp=attempts * ROLLED_JVP, resid=0,
                               delta=4 * attempts),
          "the gmres_rolled chunk: k %d attempts %d rejected %s launches %s"
          % (k, attempts, rej, launches))
    fig["gmres_rolled_chunk"] = dict(accepts=k, attempts=attempts, t=t,
                                     h=h, ms_per_accept=secs / k * 1e3,
                                     launches=launches)
    lines.append(
        "(a) gmres_rolled GMRES(%d) x %d f64 %s x3: %.4f ms/step, device "
        "%.4f ms (%s), launches/10 steps %s; chunk %d accepts in %d "
        "attempts, %.3f ms/accept, launches %s" % (
            ROLLED_M, ROLLED_CYCLES, big, f["ms_per_step"], f["device_ms"],
            "; ".join("%s %.4f" % kv for kv in f["groups"].items()),
            counts, k, attempts, secs / k * 1e3, launches))
    del chunk, kern, ops, u, u0
    # (b) gmres and pc_type none with Richardson, card vs CPU
    for label, extra in (("gmres", dict(ksp_type="gmres")),
                         ("pc_none_richardson", dict(pc_type="none"))):
        fig["card_vs_cpu_" + label] = phase_card_vs_cpu(
            card, cmp, bench_clargs(N_DIRK_CMP), (N_DIRK_CMP,) * 2,
            rough_state, 35, extra=extra)
    # (c) --with_g through main
    opt = cut_options("aggregation2d", "aggregation2d_with_g",
                      maxsteps=FLAG_ACCEPTS)
    status, s, setup, rest = drive_cli(opt, "--with_g", "--numerics",
                                       "-device_loop", "1", "--")
    g_ops = s.ops
    G = g_ops.G(s.u[:-1], s.t)
    g_dev = float(((s.u[-1] - G).abs() / G.abs().clamp(min=1e-300)).max())
    check(status == 0 and s.k == FLAG_ACCEPTS and s.u.shape[0] == 4
          and s.kernels is None and g_dev <= 1e-12
          and bool(torch.isfinite(s.u).all()),
          "--with_g: status %d k %d dof %d kernels %s G rel dev %.3e" % (
              status, s.k, s.u.shape[0], s.kernels, g_dev))
    fig["with_g"] = dict(accepts=s.k, t=s.t, h=s.h, setup_s=setup,
                         ms_per_accept=rest / s.k * 1e3,
                         rosw_ms_per_accept_phase31=cli_flagship[
                             "ms_per_accept"],
                         dispatches=s.stats.dispatches,
                         tier_calls=s.stats.tier_calls,
                         G_max_rel_dev=g_dev, kernel_refusal=s.build_info[
                             "kernel_refusal"])
    lines.append(
        "(c) --with_g aggregation2d %d^2x(3+1), device loop: setup %.2f s, "
        "%.3f ms/accept (phase 31 without G %.3f), k %d, t=%.6g, tier calls "
        "%s; the unfused step (%s: no stencil launch); G slot vs ops.G max "
        "rel %.3e" % (N_AGG, setup, rest / s.k * 1e3,
                      cli_flagship["ms_per_accept"], s.k, s.t,
                      s.stats.tier_calls, s.build_info["kernel_refusal"],
                      g_dev))
    del s, g_ops, G
    # (d) the flux form
    ps, grid, ops = problem_from_clargs(bench_clargs(N_BIG), N_BIG, N_BIG,
                                        device=dev, flux_form=True)
    multi, _ = make_multistep_fn(ops, NumericsOptions(), atol=0.01,
                                 rtol=1e-6)
    check(multi.kernels is None
          and multi.build_info["kernel_refusal"] == "the flux form",
          "the flux form's step is unfused: %s" % multi.build_info)
    u0 = ops.groom(torch.as_tensor(rough_state(grid, ps), device=dev))
    ms = step_ms(multi, u0, 1e-2)
    tt = torch.zeros((), dtype=torch.float64, device=dev)
    u, _, emax = multi(u0, tt, torch.full_like(tt, 1e-2), 10)
    s0, s1 = float(u0[0].sum()), float(u[0].sum())
    moved = float((u[0] - u0[0]).abs().sum())
    drift = abs(s1 - s0)
    check(bool(torch.isfinite(u).all()) and math.isfinite(float(emax))
          and drift <= 4 * 2.0 ** -23 * moved,
          "flux form: sum(rho) drift %.3e > 4 ulps of sum|drho| %.3e"
          % (drift, moved))
    fig["flux_form"] = dict(ms_per_step=ms, sum_rho=s0, drift=drift,
                            drift_rel=drift / abs(s0),
                            sum_abs_drho=moved, emax=float(emax))
    lines.append(
        "(d) flux form %s x3 f64 h=1e-2 (unfused): %.4f ms/step; sum(rho) "
        "%.10e, drift over 10 steps %.3e (%.3e rel; sum|drho| %.3e)" % (
            big, ms, s0, drift, drift / abs(s0), moved))
    print("phase 35 Krylov tiers, with-G, flux form (%s): %s" % (
        card, " | ".join(lines)))
    return fig


# ------------------------------------------- the Solver on an x-slab mesh

#: phase 36's depths: (b) the flagship's accepts on two gloo ranks, (c)
#: the driver's steps over two processes, its --ensemble accepts
MESH_FLAG_ACCEPTS = 16
MESH_CLI_STEPS = 16
#: (b)'s noise run: the 2D cell at h=1, one injection in two steps
MESH_NOISE_PARAMS = ["variance_rate=1e-4", "variance_timing_function=t/2",
                     "conserve_worms=True"]


def mesh_solver_records(solver):
    """A Solver's records for equality across ranks: k, t, h, failures,
    stats and the monitor records it gathered."""
    return dict(k=solver.k, t=solver.t, h=solver.h,
                failures=solver.snes_failures, stats=vars(solver.stats),
                records=list(getattr(solver, "mesh_records", [])))


def mesh_flagship(dev, make_mesh, accepts, numerics=None):
    """The flagship (examples/aggregation2d at 1536^2 x 3 from
    ``ic.start_values``, its numerics with the device loop, or
    ``numerics``, from dt=1e-8) through ``Solver(mesh=)`` on
    ``make_mesh(grid)`` for
    ``accepts`` accepts after an untimed run of 2: the Solver, its
    gathered state, seconds, the B9 launches of the timed run (counts
    set to 0 just before it), the launches each tier's attempt makes and
    the start."""
    from ksfd_tpu_torch.parallel import distribute
    from ksfd_tpu_torch.solvers import Solver
    from ksfd_tpu_torch.tools.flagship import example_numerics

    clargs = agg2d_clargs(N_AGG)
    ps, grid, ops = problem_from_clargs(clargs, N_AGG, N_AGG, device=dev)
    mesh = make_mesh(grid)
    u0 = torch.as_tensor(ic_starts(clargs, grid, ps, 1, clargs.seed)[0],
                         device=dev)
    p0 = ps.params0
    kw = dict(t0=0.0, dt=float(p0["dt"]), tmax=float(p0["tmax"]),
              rtol=float(p0["rtol"]), atol=float(p0["atol"]), mesh=mesh)
    nm = numerics or example_numerics()
    warm = Solver(ops, nm, maxsteps=2, **kw)
    u_loc = distribute(u0, grid, mesh)[0]
    warm.solve(u_loc)
    solver = Solver(ops, nm, maxsteps=accepts, kernels=warm.kernels, **kw)
    solver.mesh_records = []
    solver.add_monitor(lambda s_, k, t, u: s_.mesh_records.append(
        (k, t, s_.h, s_.CFL_maxh)))
    kern = solver.kernels
    check(kern.kind.startswith("halo-slab"), kern.kind)
    zero_launches(kern)
    u_s, secs = solver_run(solver, u_loc)
    launches = launch_counts(kern)
    per_tier = tier_launches(solver._chunk, ops, ops.groom(u_loc), 0.0)
    st = solver.stats
    want = {n: sum(c * pt[n] for c, pt in zip(st.tier_calls, per_tier))
            for n in launches}
    check(solver.k == accepts and not solver.diverged
          and bool(torch.isfinite(u_s).all()),
          "mesh Solver flagship: k=%d diverged=%s" % (solver.k,
                                                     solver.diverged))
    check(launches == want and launches["resid"] > 0
          and launches["delta"] > 0 and launches["rhs"] == launches["jvp"]
          == 0, "mesh Solver B9 launches %s, want %s (tier calls %s, per "
          "attempt %s)" % (launches, want, st.tier_calls, per_tier))
    return solver, mesh.gather(u_s), secs, launches, per_tier, u0


def mesh_noise(dev, make_mesh):
    """(b)'s noise run: the 2D cell (bench 1024^2 x 3, near-uniform
    state, h=1, fixed dt) with one injection in two steps, conserving
    worms: the Solver on ``make_mesh(grid)`` (on one card for
    ``make_mesh`` None), the normal it drew (at the global shape), the
    largest conservation error and the (gathered) state."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.parallel import distribute
    from ksfd_tpu_torch.solvers import Solver

    clargs = bench_clargs(N_BIG)
    clargs.params = list(clargs.params) + MESH_NOISE_PARAMS
    ps, grid, ops = problem_from_clargs(clargs, N_BIG, N_BIG, device=dev)
    mesh = None if make_mesh is None else make_mesh(grid)
    u0 = torch.as_tensor(initial_state(grid), device=dev)
    s = Solver(ops, NumericsOptions(adapt_type="none", pc_dtype="float32"),
               t0=0.0, dt=1.0, tmax=1e9, maxsteps=2, rtol=1e-6, atol=0.01,
               rng_state=7, mesh=mesh)
    s.mesh_records = []
    s.add_monitor(lambda s_, k, t, u: s_.mesh_records.append(
        (k, t, s_.h, s_.count_worms(u))))
    draws = []
    randn = torch.randn

    def recorded(*a, **k):
        x = randn(*a, **k)
        draws.append(x)
        return x
    torch.randn = recorded
    try:
        u = s.solve(u0 if mesh is None else distribute(u0, grid, mesh)[0])
    finally:
        torch.randn = randn
    check(s.stats.injections == 1 and len(draws) == 1,
          "noise run: %d injections, %d draws" % (s.stats.injections,
                                                  len(draws)))
    nworms = s.mesh_records[0][3]
    cons = max(abs(r[3] - nworms) / nworms for r in s.mesh_records)
    check(cons <= 1e-12, "noise run conservation %.3e" % cons)
    return s, draws[0], cons, u if mesh is None else mesh.gather(u)


def _mesh_rank(rank, n, store, queue):
    """One of phase 36's gloo ranks on the one card: (b) the flagship
    and the noise run through ``Solver(mesh=)``, then (c) the driver's
    ``main`` over the same process group (the flagship cut to
    MESH_CLI_STEPS steps, then --ensemble=4 hexagons2d), its standard
    output captured."""
    import contextlib
    import io
    import traceback

    import torch.distributed as dist

    from ksfd_tpu_torch.parallel import grid_mesh
    from ksfd_tpu_torch.parallel.distributed import process_count

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=n)
        dev = torch.device("cuda", 0)
        out = {}

        def make_mesh(grid):
            mesh = grid_mesh(grid, device=dev)
            check(mesh.backend == "gloo" and mesh.shape[0] == n, repr(mesh))
            return mesh
        solver, u_s, secs, launches, per_tier, u0 = mesh_flagship(
            dev, make_mesh, MESH_FLAG_ACCEPTS)
        out["flagship"] = dict(
            mesh_solver_records(solver), secs=secs, launches=launches,
            launches_per_attempt=per_tier,
            ms_per_accept=secs / solver.k * 1e3,
            finite=bool(torch.isfinite(u_s).all()),
            pc_dtype=solver.build_info["pc_dtype"])
        del solver, u_s, u0
        s, draw, cons, u = mesh_noise(dev, make_mesh)
        out["noise"] = dict(mesh_solver_records(s), conservation=cons)
        if rank == 0:
            s1, draw1, cons1, u1 = mesh_noise(dev, None)
            inc = float((u1 - torch.as_tensor(initial_state(
                s1.ops.grid), device=dev)).abs().max())
            out["noise"].update(
                draw_equal=bool(torch.equal(draw, draw1)),
                dev_over_inc=float((u - u1).abs().max()) / inc,
                injections_one_card=s1.stats.injections)
        del s, draw, u
        torch.cuda.empty_cache()
        # (c) the driver over the same group: main sees two processes
        check(process_count() == n, "process group")
        loop = ("--numerics", "-device_loop", "1", "--")
        for key, argv in (
                ("cli_flagship", (cut_options(
                    "aggregation2d", "aggregation2d_mesh%d" % rank,
                    maxsteps=MESH_CLI_STEPS),) + loop),
                ("cli_ensemble", (cut_options(
                    "hexagons2d", "hexagons2d_mesh%d" % rank,
                    maxsteps=CLI_ENS_ACCEPTS),
                    "--ensemble=%d" % CLI_MEMBERS) + loop)):
            text = io.StringIO()
            dist.barrier()
            with contextlib.redirect_stdout(text):
                status, s, setup, rest = drive_cli(*argv)
            out[key] = dict(status=status, stdout=text.getvalue(),
                            setup_s=setup, rest_s=rest)
            if key == "cli_flagship":
                out[key].update(mesh_solver_records(s),
                                mesh=repr(s.mesh),
                                launches=launch_counts(s.kernels))
            else:
                out[key].update(ks=[int(k) for k in s.ks],
                                ts=[float(t) for t in s.ts],
                                member_offset=int(s.member_offset))
            del s
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


def phase_mesh_solver(card, flag30, u_flag, cli31):
    """Phase 36, the Solver on an x-slab mesh and the driver over
    several processes (solvers/solver.py ``Solver(mesh=)``,
    ksfd_tpu_torch/ksfdsolver.py ``main``).

    (a) the flagship at 1536^2 x 3 from ``ic.start_values`` through
        ``Solver(mesh=)`` on a one-rank NCCL mesh, FLAG_ACCEPTS accepts
        (after an untimed 2), as phase 30 (b): the same k, attempts and
        on-device rejections as phase 30 (b)'s one-card Solver, the
        state within 1e-5 of its increment; the B9 launches (resid,
        delta halo builds) equal each tier's launches per attempt times
        its calls; ms per accept against phase 30 (b)'s;
    (b) two gloo ranks spawned on the card, time-sliced: the same
        flagship through ``Solver(mesh=)`` for MESH_FLAG_ACCEPTS
        accepts, every record and ``stats`` equal on both ranks, exact
        B9 launches; and the 2D cell with ``variance_rate`` set, one
        injection in two steps: the normal drawn at the global shape
        equal to the one-card draw bit for bit, worms conserved to
        1e-12;
    (c) on the same two processes, ksfdsolver's ``main`` over their
        group: examples/aggregation2d cut to MESH_CLI_STEPS steps (no
        --save: the card's machine has no h5py), both exit 0, rank 0
        prints the monitor lines and rank 1 none, the ranks' records
        equal; then --ensemble=CLI_MEMBERS hexagons2d at 384^2 x 3 for
        CLI_ENS_ACCEPTS accepts, members 0-1 and 2-3, their k equal and
        t to 1e-6 relative of phase 31 (c)'s one-process run.
    A rank that fails fails the phase.  Two ranks sharing one card are
    no scaling figure."""
    import multiprocessing as mp
    import tempfile

    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    fig, lines = {}, []
    # (a)
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method="tcp://localhost:%d"
                            % free_port(), world_size=1, rank=0)
    try:
        from ksfd_tpu_torch.parallel import grid_mesh

        def make_mesh(grid):
            mesh = grid_mesh(grid, device=dev)
            check(mesh.backend == "nccl" and mesh.shape[0] == 1, repr(mesh))
            return mesh
        solver, u_s, secs, launches, per_tier, u0 = mesh_flagship(
            dev, make_mesh, FLAG_ACCEPTS)
    finally:
        dist.destroy_process_group()
    st = solver.stats
    u_one = u_flag.to(dev)
    inc = float((u_one - solver.ops.groom(u0)).abs().max())
    dev_abs = float((u_s - u_one).abs().max())
    same = (solver.k == flag30["accepts"]
            and st.chunk_attempts + st.step_attempts == flag30["host_reads"]
            and st.chunk_rejections == flag30["on_device_rejections"]
            and st.tier_calls == flag30["tier_calls"])
    check(same and dev_abs <= 1e-5 * inc,
          "one-rank NCCL mesh Solver vs phase 30 (b): k %d/%d host reads "
          "%d/%d rejections %d/%d tier calls %s/%s; %.3e of the increment"
          % (solver.k, flag30["accepts"], st.chunk_attempts
             + st.step_attempts, flag30["host_reads"], st.chunk_rejections,
             flag30["on_device_rejections"], st.tier_calls,
             flag30["tier_calls"], dev_abs / inc))
    fig["one_rank_nccl"] = dict(
        accepts=solver.k, t=solver.t, h=solver.h,
        ms_per_accept=secs / solver.k * 1e3,
        ms_per_accept_one_card_phase30=flag30["ms_per_accept"],
        tier_calls=st.tier_calls, host_reads=st.chunk_attempts
        + st.step_attempts, on_device_rejections=st.chunk_rejections,
        dispatches=st.dispatches, dev_over_inc=dev_abs / inc,
        launches=launches, launches_per_attempt=per_tier)
    lines.append(
        "(a) Solver(mesh=) one-rank NCCL, aggregation2d %d^2x3 from "
        "ic.start_values, %d accepts to t=%.6g: %.3f ms/accept (one card, "
        "phase 30 (b): %.3f); tier calls %s, %d host reads, %d on-device "
        "rejections as phase 30 (b); state %.3e of the increment; B9 "
        "launches %s = tier calls x per attempt %s" % (
            N_AGG, solver.k, solver.t, fig["one_rank_nccl"]["ms_per_accept"],
            flag30["ms_per_accept"], st.tier_calls,
            fig["one_rank_nccl"]["host_reads"], st.chunk_rejections,
            dev_abs / inc, launches, per_tier))
    del solver, u_s, u0, u_one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # (b) and (c): two gloo ranks on the card
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="ksfd_mesh_"), "store")
    procs = [ctx.Process(target=_mesh_rank, args=(r, N_RANKS, store, queue))
             for r in range(N_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:
            rank, res, err = queue.get(timeout=600)
            if err is not None:
                errors.append("rank %d:\n%s" % (rank, err))
                break
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=120 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join(10)
    check(not errors, "phase 36 ranks failed:\n" + "\n".join(errors))
    wall = time.perf_counter() - t0
    r0, r1 = results[0], results[1]
    rec_keys = ("k", "t", "h", "failures", "stats", "records")
    for key in ("flagship", "noise", "cli_flagship"):
        for rk in rec_keys:
            check(r0[key][rk] == r1[key][rk], "phase 36 %s: the ranks' %s "
                  "differ: %r / %r" % (key, rk, r0[key][rk], r1[key][rk]))
    flag = r0["flagship"]
    check(flag["k"] == MESH_FLAG_ACCEPTS and flag["finite"]
          and flag["launches"] == r1["flagship"]["launches"],
          "two-rank flagship: %r" % {k: flag[k] for k in ("k", "launches")})
    noise = r0["noise"]
    check(noise["draw_equal"] and noise["injections_one_card"] == 1
          and noise["stats"]["injections"] == 1,
          "two-rank noise draw against the one card: %r" % noise)
    cli = (r0["cli_flagship"], r1["cli_flagship"])
    monitor = [sum("clock:" in ln and "step" in ln
                   for ln in c["stdout"].splitlines()) for c in cli]
    check(cli[0]["status"] == cli[1]["status"] == 0
          and cli[0]["k"] == MESH_CLI_STEPS
          and monitor[0] >= 2 and monitor[1] == 0
          and cli[0]["launches"]["resid"] > 0
          and cli[0]["launches"]["delta"] > 0,
          "two-process driver: status %s k %d, monitor lines %s, "
          "launches %s" % ([c["status"] for c in cli], cli[0]["k"],
                           monitor, cli[0]["launches"]))
    ens = (r0["cli_ensemble"], r1["cli_ensemble"])
    ts1 = cli31["ensemble"]["t"]
    ens_ts = ens[0]["ts"] + ens[1]["ts"]
    ens_dt = max(abs(a - b) / abs(b) for a, b in zip(ens_ts, ts1))
    check(ens[0]["status"] == ens[1]["status"] == 0
          and ens[0]["member_offset"] == 0
          and ens[1]["member_offset"] == CLI_MEMBERS // N_RANKS
          and ens[0]["ks"] + ens[1]["ks"] == [CLI_ENS_ACCEPTS] * CLI_MEMBERS
          and ens_dt <= 1e-6
          and "members 0-1" in ens[0]["stdout"]
          and "members 2-3" in ens[1]["stdout"],
          "two-process --ensemble=%d: status %s ks %s t %s / %s" % (
              CLI_MEMBERS, [e["status"] for e in ens], ens[0]["ks"]
              + ens[1]["ks"], ens_ts, ts1))
    fig["two_gloo_ranks"] = dict(
        wall_s=wall, flagship={k: flag[k] for k in (
            "k", "t", "h", "ms_per_accept", "launches",
            "launches_per_attempt", "pc_dtype")},
        flagship_tier_calls=flag["stats"]["tier_calls"],
        noise=dict(draw_equal=noise["draw_equal"],
                   conservation=noise["conservation"],
                   dev_over_inc=noise["dev_over_inc"]),
        cli_flagship=dict(steps=cli[0]["k"], t=cli[0]["t"],
                          setup_s=[c["setup_s"] for c in cli],
                          ms_per_accept=[c["rest_s"] / c["k"] * 1e3
                                         for c in cli],
                          launches=cli[0]["launches"],
                          monitor_lines=monitor),
        cli_ensemble=dict(setup_s=[e["setup_s"] for e in ens],
                          ms_per_ensemble_accept=[
                              e["rest_s"] / CLI_ENS_ACCEPTS * 1e3
                              for e in ens],
                          t_rel_dev=ens_dt))
    lines.append(
        "(b) two gloo ranks on the card (not a scaling figure; %.1f s wall "
        "with the spawn): the flagship through Solver(mesh=), %d accepts "
        "to t=%.6g (pc %s): %.3f ms/accept, tier calls %s, records and "
        "stats equal on both ranks, B9 launches %s per rank = tier calls x "
        "per attempt; the 2D cell %d^2x3 with one noise injection: the "
        "global-shape draw equal to the one card's bit for bit, "
        "conservation %.2e, state %.3e of the increment from the one "
        "card's" % (wall, flag["k"], flag["t"], flag["pc_dtype"],
                    flag["ms_per_accept"], flag["stats"]["tier_calls"],
                    flag["launches"], N_BIG, noise["conservation"],
                    noise["dev_over_inc"]))
    lines.append(
        "(c) main over the two processes' group: aggregation2d cut to %d "
        "steps, exit 0 on both, monitor lines %s (rank 0, rank 1), setup "
        "%s s, %s ms/accept, launches %s; --ensemble=%d hexagons2d %d^2x3, "
        "%d accepts: members 0-1 and 2-3, setup %s s, %s ms per accepted "
        "ensemble step, t within %.2e of phase 31 (c)'s one process" % (
            MESH_CLI_STEPS, monitor,
            ["%.2f" % c["setup_s"] for c in cli],
            ["%.3f" % (c["rest_s"] / c["k"] * 1e3) for c in cli],
            cli[0]["launches"], CLI_MEMBERS, N_HEX, CLI_ENS_ACCEPTS,
            ["%.2f" % e["setup_s"] for e in ens],
            ["%.3f" % (e["rest_s"] / CLI_ENS_ACCEPTS * 1e3) for e in ens],
            ens_dt))
    print("phase 36 Solver on an x-slab mesh, driver over processes (%s): "
          "%s" % (card, " | ".join(lines)))
    return fig


#: phase 37: accepts of the flagship's pc forms on a one-rank mesh, of
#: the mesh ensemble, steps of options93 on a 1D mesh, of the 2D cell's
#: flux form and with-G state, of the two ranks' y split and the 1D
#: driver; probe_hgap's start, step sizes and tiers
FORM_ACCEPTS = 16
MESH_ENS_ACCEPTS = 8
MESH_1D_STEPS = 64
FORM_STEPS = 4
N_SPLIT_CARD = 256
SPLIT_STEPS = 4
EIG_CLI_STEPS = 20
HGAP_ACCEPTS = 150
HGAP_HS = (1.0, 4.0, 16.0, 64.0)
HGAP_TIERS = ("rich3", "rich16", "cheb48")


def dev_over_inc(label, u_mesh, u_one, u0, tol=1e-5):
    """max|u_mesh - u_one| over the increment max|u_one - u0|, checked
    at most ``tol``."""
    inc = float((u_one - u0).abs().max())
    rel = float((u_mesh - u_one).abs().max()) / inc
    check(rel <= tol, "%s: mesh vs one card %.3e of the increment > %g"
          % (label, rel, tol))
    return rel


def _form_rank(rank, n, store, queue):
    """One of phase 37 (b)'s two gloo ranks on the card: the 2D cell at
    N_SPLIT_CARD^2 x 3 split (1, 2), SPLIT_STEPS fixed steps, then the
    driver's ``main`` over the group on examples/eigenmode1d cut to
    EIG_CLI_STEPS steps (its 1D mesh, the banded tier)."""
    import contextlib
    import io
    import traceback

    import torch.distributed as dist

    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.parallel import distribute, grid_mesh
    from ksfd_tpu_torch.solvers import make_multistep_fn

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=n)
        dev = torch.device("cuda", 0)
        out = {}
        ps, grid, ops = problem_from_clargs(bench_clargs(N_SPLIT_CARD),
                                            N_SPLIT_CARD, N_SPLIT_CARD,
                                            device=dev)
        mesh = grid_mesh(grid, shape=(1, n), device=dev)
        u0 = ops.groom(torch.as_tensor(rough_state(grid, ps), device=dev))
        nm = NumericsOptions(pc_dtype="float32")
        tt = torch.zeros((), dtype=torch.float64, device=dev)
        hh = torch.full_like(tt, 1e-3)
        multi, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6,
                                     mesh=mesh)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        u, _, emax = multi(distribute(u0, grid, mesh)[0], tt, hh,
                           SPLIT_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        u = mesh.gather(u)
        out["split"] = dict(emax=float(emax), ms_per_step=secs
                            / SPLIT_STEPS * 1e3, box=mesh.box,
                            info=repr(multi.build_info))
        if rank == 0:
            one, _ = make_multistep_fn(ops, dataclasses.replace(
                nm, use_pallas=False), atol=0.01, rtol=1e-6)
            u1, _, _ = one(u0, tt, hh, SPLIT_STEPS)
            out["split"]["dev_over_inc"] = dev_over_inc(
                "(b) y split", u, u1, u0)
        del multi, u, u0
        text = io.StringIO()
        dist.barrier()
        with contextlib.redirect_stdout(text):
            status, s, setup, rest = drive_cli(cut_options(
                "eigenmode1d", "eigenmode1d_mesh%d" % rank,
                maxsteps=EIG_CLI_STEPS))
        out["cli"] = dict(status=status, stdout=text.getvalue(),
                          setup_s=setup, rest_s=rest, k=s.k, t=s.t,
                          mesh=repr(s.mesh), box=s.mesh.box,
                          stats=vars(s.stats))
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


def phase_mesh_forms(card):
    """Phase 37, the mesh does all that the reference's mesh does
    (parallel/mesh.py, solvers/linalg.py ``make_sharded_apply``,
    solvers/ensemble.py ``EnsembleSolver(mesh=)``) and the last tools.

    (a) on a one-rank NCCL mesh, each held against the one-card port at
        1e-5 of the increment: the flagship at 1536^2 x 3 from
        ``ic.start_values`` (phase 30's cell) for FORM_ACCEPTS accepts
        with ``-pc_type spectral`` and with ``-pc_fft on`` (the same k;
        its B9 launches = tier calls x per attempt); the flux form and
        a with-G state on the 2D cell at 1024^2 x 3 (FORM_STEPS fixed
        steps, unfused: no launch); options93 on a 1D mesh (128 x 3,
        MESH_1D_STEPS steps); a 4-member hexagons2d 384^2 x 3 ensemble
        split over the mesh, MESH_ENS_ACCEPTS accepts per step and in
        the device loop (the unfused step: the same k, t and h to 1e-4
        relative, as phase 18 holds members, against the one-card
        ensemble with ``use_pallas=False``);
    (b) two gloo ranks time-sliced on the card: the 2D cell at 256^2 x 3
        split (1, 2), SPLIT_STEPS steps against one card; the driver's
        ``main`` over the two processes on examples/eigenmode1d cut to
        EIG_CLI_STEPS steps (its 1D mesh, boxes (0, 64) and (64, 128));
    (c) tools/probe_hgap.py on the flagship at 1536^2 x 3 after
        HGAP_ACCEPTS accepts: enorm(h) for HGAP_TIERS over HGAP_HS and
        each tier's slope-timed ms per step.
    """
    import multiprocessing as mp
    import tempfile

    import torch.distributed as dist

    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.parallel import distribute, grid_mesh
    from ksfd_tpu_torch.solvers import (
        EnsembleSolver, Solver, make_multistep_fn)
    from ksfd_tpu_torch.tools import probe_hgap, validate
    from ksfd_tpu_torch.tools.flagship import example_numerics

    dev = torch.device("cuda", torch.cuda.current_device())
    fig, lines = {}, []
    f64 = lambda x: torch.full((), x, dtype=torch.float64, device=dev)
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method="tcp://localhost:%d"
                            % free_port(), world_size=1, rank=0)
    try:
        def make_mesh(grid):
            mesh = grid_mesh(grid, device=dev)
            check(mesh.backend == "nccl" and mesh.size == 1, repr(mesh))
            return mesh
        # (a) the flagship's pc forms
        for key, change in (("spectral", dict(pc_type="spectral")),
                            ("fft", dict(pc_fft="on"))):
            nm = example_numerics(**change)
            solver, u_s, secs, launches, per_tier, u0 = mesh_flagship(
                dev, make_mesh, FORM_ACCEPTS, numerics=nm)
            ops = solver.ops
            kw = dict(t0=0.0, dt=solver.dt0, tmax=solver.tmax,
                      rtol=solver.rtol, atol=solver.atol)
            # the one card warmed as the mesh run is (2 untimed accepts)
            Solver(ops, nm, maxsteps=2, **kw).solve(u0)
            one = Solver(ops, nm, maxsteps=FORM_ACCEPTS, **kw)
            u_one, secs_one = solver_run(one, u0)
            check(one.k == solver.k, "(a) %s: k %d vs one card %d"
                  % (key, solver.k, one.k))
            fig[key] = dict(
                accepts=solver.k, t=solver.t, pc=solver.build_info["pc"],
                ms_per_accept=secs / solver.k * 1e3,
                ms_per_accept_one_card=secs_one / one.k * 1e3,
                b9_launches=launches, launches_per_attempt=per_tier,
                tier_calls=solver.stats.tier_calls,
                dev_over_inc=dev_over_inc("(a) flagship " + key, u_s, u_one,
                                          ops.groom(u0)))
            del solver, u_s, u_one, one, u0, ops
            torch.cuda.empty_cache()
        lines.append("(a) flagship %d^2x3 on a one-rank NCCL mesh, %d "
                     "accepts: %s" % (N_AGG, FORM_ACCEPTS, "; ".join(
                         "%s (%s): %.3f ms/accept (one card %.3f), B9 %s, "
                         "%.2e of the increment" % (
                             k, fig[k]["pc"], fig[k]["ms_per_accept"],
                             fig[k]["ms_per_accept_one_card"],
                             fig[k]["b9_launches"], fig[k]["dev_over_inc"])
                         for k in ("spectral", "fft"))))
        # (a) the flux form and a with-G state on the 2D cell
        tt, hh = f64(0.0), f64(1e-3)
        nm = NumericsOptions(pc_dtype="float32")
        for key in ("flux_form", "with_g"):
            ps, grid, ops = problem_from_clargs(
                bench_clargs(N_BIG), N_BIG, N_BIG, device=dev,
                flux_form=key == "flux_form", with_g=key == "with_g")
            mesh = make_mesh(grid)
            base = torch.as_tensor(rough_state(grid, ps) if key != "with_g"
                                   else np.concatenate([rough_state(
                                       grid, ps), np.zeros((1,) + tuple(
                                           grid.Sshape))]), device=dev)
            u0 = ops.groom(base)
            if key == "with_g":
                u0 = ops.refresh_G(u0, 0.0)
            multi, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6,
                                         mesh=mesh)
            check(multi.kernels is None, "(a) %s: unfused" % key)
            multi(distribute(u0, grid, mesh)[0], tt, hh, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u, _, _ = multi(distribute(u0, grid, mesh)[0], tt, hh,
                            FORM_STEPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            one, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6)
            u1, _, _ = one(u0, tt, hh, FORM_STEPS)
            fig[key] = dict(ms_per_step=secs / FORM_STEPS * 1e3,
                            dev_over_inc=dev_over_inc(
                                "(a) " + key, mesh.gather(u), u1, u0))
            del multi, one, u, u1, u0, ops
            torch.cuda.empty_cache()
        # (a) options93 on a 1D mesh
        ps, grid, ops = validate.make_problem(128, device=dev)
        mesh = make_mesh(grid)
        u0 = torch.as_tensor(validate.exact_state(grid, 0.0), device=dev)
        kw = dict(t0=0.0, dt=1.0, tmax=1e9, maxsteps=MESH_1D_STEPS,
                  rtol=1e-6, atol=0.01)
        nm = NumericsOptions(adapt_type="none")
        s1d = Solver(ops, nm, mesh=mesh, **kw)
        u_m, secs = solver_run(s1d, distribute(u0, grid, mesh)[0])
        one = Solver(ops, nm, **kw)
        u_one, _ = solver_run(one, u0)
        fig["options93_1d"] = dict(
            steps=s1d.k, mesh_shape=mesh.shape,
            ms_per_step=secs / s1d.k * 1e3,
            dev_over_inc=dev_over_inc("(a) options93 1D", mesh.gather(u_m),
                                      u_one, u0))
        lines.append("flux form / with-G %d^2x3 %d steps (unfused): %.3f / "
                     "%.3f ms/step, %.2e / %.2e of the increment; options93 "
                     "128x3 on a %s mesh, %d steps: %.3f ms/step, %.2e" % (
                         N_BIG, FORM_STEPS, fig["flux_form"]["ms_per_step"],
                         fig["with_g"]["ms_per_step"],
                         fig["flux_form"]["dev_over_inc"],
                         fig["with_g"]["dev_over_inc"], mesh.shape,
                         s1d.k, fig["options93_1d"]["ms_per_step"],
                         fig["options93_1d"]["dev_over_inc"]))
        # (a) the ensemble split over the mesh
        clargs = hex_clargs()
        ps, grid, ops = problem_from_clargs(clargs, N_HEX, N_HEX, device=dev)
        mesh = make_mesh(grid)
        U0 = torch.as_tensor(ic_starts(clargs, grid, ps, 4, clargs.seed),
                             device=dev)
        kw = dict(t0=0.0, dt=float(ps.params0["dt"]),
                  tmax=float(ps.params0["tmax"]),
                  rtol=float(ps.params0["rtol"]),
                  atol=float(ps.params0["atol"]), maxsteps=MESH_ENS_ACCEPTS)
        ens = {}
        for dl in (False, True):
            nm = hex_numerics(device_loop=dl)
            es = EnsembleSolver(ops, nm, mesh=mesh, **kw)
            U_loc = mesh.local(U0, first=2).contiguous()
            EnsembleSolver(ops, nm, mesh=mesh, **dict(kw, maxsteps=2)).solve(
                U_loc)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = es.solve(U_loc)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            ref = EnsembleSolver(ops, dataclasses.replace(
                nm, use_pallas=False), **kw).solve(U0)
            t_rel = float(np.max(np.abs(out.t - ref.t) / np.abs(ref.t)))
            h_rel = float(np.max(np.abs(out.h - ref.h) / np.abs(ref.h)))
            check(es.build_info["kernels"] is None
                  and list(out.k) == list(ref.k) == [MESH_ENS_ACCEPTS] * 4
                  and t_rel <= 1e-4 and h_rel <= 1e-4,
                  "(a) mesh ensemble (device loop %s): k %s / %s, t %.2e h "
                  "%.2e relative" % (dl, out.k, ref.k, t_rel, h_rel))
            ens["device_loop" if dl else "per_step"] = dict(
                ms_per_ensemble_accept=secs / MESH_ENS_ACCEPTS * 1e3,
                t_rel=t_rel, h_rel=h_rel, k=[int(k) for k in out.k])
            del es, out, ref
        fig["ensemble_hexagons2d"] = ens
        lines.append("4-member hexagons2d %d^2x3 split over the mesh, %d "
                     "accepts: %s" % (N_HEX, MESH_ENS_ACCEPTS, "; ".join(
                         "%s %.3f ms per ensemble accept, t %.1e h %.1e of "
                         "the one card's" % (k, v["ms_per_ensemble_accept"],
                                             v["t_rel"], v["h_rel"])
                         for k, v in ens.items())))
        del ops, U0
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # (b) two gloo ranks on the card
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="ksfd_forms_"), "store")
    procs = [ctx.Process(target=_form_rank, args=(r, N_RANKS, store, queue))
             for r in range(N_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:
            rank, res, err = queue.get(timeout=600)
            if err is not None:
                errors.append("rank %d:\n%s" % (rank, err))
                break
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=120 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join(10)
    check(not errors, "phase 37 ranks failed:\n" + "\n".join(errors))
    wall = time.perf_counter() - t0
    r0, r1 = results[0], results[1]
    half = N_SPLIT_CARD // 2
    check(r0["split"]["box"] == ((0, N_SPLIT_CARD), (0, half))
          and r1["split"]["box"] == ((0, N_SPLIT_CARD),
                                     (half, N_SPLIT_CARD))
          and r0["split"]["emax"] == r1["split"]["emax"]
          and "'kernels': None" in r0["split"]["info"],
          "(b) y split: %r / %r" % (r0["split"], r1["split"]))
    cli = (r0["cli"], r1["cli"])
    check(cli[0]["status"] == cli[1]["status"] == 0
          and cli[0]["k"] == cli[1]["k"] == EIG_CLI_STEPS
          and cli[0]["stats"] == cli[1]["stats"]
          and cli[0]["box"] == ((0, 64),) and cli[1]["box"] == ((64, 128),),
          "(b) 1D driver: %r" % ([{k: c[k] for k in ("status", "k", "box")}
                                  for c in cli],))
    fig["two_gloo_ranks"] = dict(
        wall_s=wall, split_ms_per_step=[r["split"]["ms_per_step"]
                                        for r in (r0, r1)],
        split_dev_over_inc=r0["split"]["dev_over_inc"],
        cli_eigenmode1d=dict(steps=cli[0]["k"], t=cli[0]["t"],
                             setup_s=[c["setup_s"] for c in cli],
                             ms_per_step=[c["rest_s"] / c["k"] * 1e3
                                          for c in cli]))
    lines.append("(b) two gloo ranks on the card (not a scaling figure, "
                 "%.1f s wall with the spawn): %d^2x3 split (1, 2), %d "
                 "steps: %s ms/step, %.2e of the increment; eigenmode1d "
                 "through main on its 1D mesh, %d steps to t=%.6g: %s "
                 "ms/step" % (wall, N_SPLIT_CARD, SPLIT_STEPS,
                              ["%.3f" % x for x in fig["two_gloo_ranks"][
                                  "split_ms_per_step"]],
                              r0["split"]["dev_over_inc"], cli[0]["k"],
                              cli[0]["t"], ["%.3f" % x for x in fig[
                                  "two_gloo_ranks"]["cli_eigenmode1d"][
                                  "ms_per_step"]]))
    # (c) probe_hgap
    t0 = time.perf_counter()
    ops, u, t = probe_hgap.rough_state(None, HGAP_ACCEPTS, device=dev,
                                       out=lambda s: None)
    start_s = time.perf_counter() - t0
    hgap = probe_hgap.probe(ops, u, t, list(HGAP_HS), list(HGAP_TIERS),
                            time_steps=True, out=lambda s: None)
    check(all(math.isfinite(e) for row in hgap["curves"].values()
              for e in row), "(c) probe_hgap: %r" % hgap)
    hgap.update(t=t, start_s=start_s)
    fig["probe_hgap"] = hgap
    del ops, u
    torch.cuda.empty_cache()
    lines.append("(c) probe_hgap on the flagship %d^2x3 after %d accepts "
                 "(t=%.6g, %.1f s to reach): enorm over h %s: %s; largest h "
                 "with enorm <= 1: %s; ms/step %s" % (
                     N_AGG, HGAP_ACCEPTS, t, start_s, list(HGAP_HS),
                     {k: ["%.3g" % e for e in v]
                      for k, v in hgap["curves"].items()},
                     hgap["sustained"],
                     {k: round(v, 3)
                      for k, v in hgap["ms_per_step"].items()}))
    print("phase 37 the mesh's forms, splits and ensembles, probe_hgap "
          "(%s): %s" % (card, " | ".join(lines)))
    return fig


def kernel_lines(rows):
    """One short line per kernel row: µs, bound µs, plain µs, library µs
    and the launches per step on each path (the tail of the output keeps
    them where the kernels line may be cut)."""
    us = lambda x: "-" if x is None else "%.2f" % (1e3 * x)
    out = []
    for r in rows:
        per = r.get("launches_per_step", {})
        out.append("kernel %s: %s us (bound %s us, by %s; plain %s us; "
                   "library %s us); launches %d; per step: %s" % (
                       r["name"], us(r["ms"]), us(r["bound_ms"]),
                       r["bound_by"], us(r["plain_ms"]),
                       us(r["library_ms"]), r["launches"],
                       ", ".join("%s %s" % (p, ("%g" % c) if isinstance(
                           c, (int, float)) else c)
                                 for p, c in per.items())))
    return out


def kernel_rows(kern, src, per_step, totals, errs, rel, times, suffix,
                extra=None):
    """One row per kernel of ``kern`` (a namespace of wrappers by name,
    ``kernels``); ``per_step`` maps each path to the kernel launches per
    step (per accepted step for the chunk) and ``totals`` to the
    launches counted on the main-path runs.  ``times`` holds (ms,
    plain ms[, library ms, bound ms, bound by]) per kernel; without the
    bound it is computed from the stencil build.  ``extra`` adds keys to
    a kernel's row by name."""
    rows = []
    for name, k in kern.kernels.items():
        tm = times[name]
        if len(tm) > 2:
            ms, plain_ms, library_ms, bound_ms, bound_by = tm
        else:
            (ms, plain_ms), library_ms = tm, None
            bound_ms, bound_by = kernel_bound(name, kern.build)
        rows.append({
            "name": name + suffix, "route": "cuda", "source": src,
            "replaces": k.replaces,
            "launches": totals[name],
            "launches_per_step": {p: c[name] for p, c in per_step.items()
                                  if name in c},
            "max_abs_err": errs[name], "max_rel_err": rel[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a fused stencil row; the
            # pc entries' is the basis-GEMM pc's cuBLAS apply
            "library_ms": library_ms,
        })
        if extra:
            rows[-1].update(extra.get(name, {}))
    return rows


def b9_rows(halo, one_rank, totals, mesh_per_accept=None):
    """The kernels line's B9 rows: phase 25's errors and times per slab
    (``halo``), phase 26's launches per step on each path
    (``one_rank``), phase 36's per accepted step of the mesh Solver's
    flagship (``mesh_per_accept``, 2D) and the launches counted on
    those runs (``totals``)."""
    rows = []
    for dim, src in (("2d", "stencil2d.cu"), ("3d", "stencil3d.cu")):
        slab, errs, rel, times = halo[dim]
        per_step = {"one_rank_" + k[3:]: f["launches_per_step"]
                    for k, f in one_rank.items() if k.startswith(dim)}
        if dim == "2d" and mesh_per_accept:
            per_step.update(mesh_per_accept)
        rows += kernel_rows(
            slab, "ksfd_tpu_torch/csrc/" + src, per_step,
            {n: totals[dim, n] for n in slab.kernels}, errs, rel, times,
            "_halo" + ("3d" if dim == "3d" else ""),
            extra={n: {"slabs": B9_TIMED, "per": "launch per slab"}
                   for n in slab.kernels})
    return rows


def ensemble_json(figures):
    """An ensemble phase's figures by "<precision>_N<members>"."""
    return {"%s_N%d" % k: {kk: v for kk, v in f.items()
                           if kk not in ("per_step", "launches")}
            for k, f in figures.items()}


def main():
    seconds = []

    def timed(label, fn, *args, **kw):
        """fn(*args, **kw), its wall seconds recorded under ``label``."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds.append((label, time.perf_counter() - t0))
        return out

    card = phase_device()
    ptxas_pc, sass_pc = timed("build", phase_build)
    kern, errs, rel, times = timed("2", phase_kernels, card)
    main_f64, main_f32 = {}, {}
    counts, step_s, rate = timed(
        "3", phase_main_path, card, "%d^2" % N_BIG, bench_clargs(N_BIG),
        (N_BIG, N_BIG), 3, figures=main_f64)
    timed("4", phase_card_vs_cpu, card, "%d^2" % N_CMP, bench_clargs(N_CMP),
          (N_CMP, N_CMP), rough_state, 4)
    kern3, errs3, rel3, times3 = timed("5", phase_kernels_3d, card)
    counts3, step3_s, rate3 = timed(
        "6", phase_main_path, card, "%d^3" % N3_BIG, agg3d_clargs(N3_BIG),
        (N3_BIG,) * 3, 6)
    timed("7", phase_card_vs_cpu, card, "%d^3" % N3_CMP,
          agg3d_clargs(N3_CMP), (N3_CMP,) * 3,
          lambda grid, ps: rough_state_3d(grid, ps, "cpu"), 7)
    rhs = timed("8", phase_rhs_kernels, card)
    counts32, step32_s, rate32 = timed(
        "9 2d", phase_main_path, card, "%d^2" % N_BIG, bench_clargs(N_BIG),
        (N_BIG, N_BIG), 9, fast32=True, figures=main_f32)
    counts32_3, step32_3_s, rate32_3 = timed(
        "9 3d", phase_main_path, card, "%d^3" % N3_BIG,
        agg3d_clargs(N3_BIG), (N3_BIG,) * 3, 9, fast32=True)
    timed("10 2d", phase_card_vs_cpu, card, "%d^2" % N_CMP,
          bench_clargs(N_CMP), (N_CMP, N_CMP), rough_state, 10, fast32=True)
    timed("10 3d", phase_card_vs_cpu, card, "%d^3" % N3_CMP,
          agg3d_clargs(N3_CMP), (N3_CMP,) * 3,
          lambda grid, ps: rough_state_3d(grid, ps, "cpu"), 10, fast32=True)
    pc_ragged, pc_errs, pc_rel, pc_figs = timed("11", phase_pc_kernels, card)
    counts_pc, step_pc_s, rate_pc = timed(
        "12 f64", phase_main_path, card, "%d^2" % N_BIG, bench_clargs(N_BIG),
        (N_BIG, N_BIG), 12, pc_pallas=True)
    counts32_pc, step32_pc_s, rate32_pc = timed(
        "12 f32", phase_main_path, card, "%d^2" % N_BIG, bench_clargs(N_BIG),
        (N_BIG, N_BIG), 12, fast32=True, pc_pallas=True)
    for fast32 in (False, True):
        timed("12 cpu", phase_card_vs_cpu, card, "%d^2" % N_CMP,
              bench_clargs(N_CMP), (N_CMP, N_CMP), rough_state, 12,
              fast32=fast32, pc_pallas=True)
    ps, grid, ops = problem_from_clargs(agg2d_clargs(N_AGG), N_AGG, N_AGG,
                                        device="cuda")
    kern_agg = make_fused_kernels(ops)
    u_rough = torch.as_tensor(rough_state(grid, ps), device="cuda")
    chunks = {pc: timed("13", phase_chunk, card, ops, grid, ps, kern_agg,
                        u_rough, pc)
              for pc in (True, False)}
    del u_rough, kern_agg, ops
    timed("14", phase_chunk_card_vs_cpu, card)
    b11 = timed("15", phase_coeff_kernel, card)
    batched, batched_errs = timed(
        "16", phase_batched_kernels, card, b11["kern"],
        torch.as_tensor(rough_state(b11["kern"].build.ops.grid,
                                    b11["kern"].build.ops.ps),
                        device="cuda"), 16, "%d^2x3" % N_BIG,
        fields=FIELDS2)
    ens = timed("17", phase_ensemble_fixed, card, bench_clargs(N_BIG),
                (N_BIG, N_BIG), ENS_RUNS, 17)
    hexa = timed("18", phase_ensemble_adaptive, card)
    timed("19", phase_ensemble_card_vs_cpu, card, 19, bench_clargs,
          (N_ENS_CMP,) * 2, 3)
    ops3 = kern3.build.ops
    batched3, batched3_errs = timed(
        "20", phase_batched_kernels, card, kern3,
        rough_state_3d(ops3.grid, ops3.ps, "cuda"), 20, "%d^3x3" % N3_BIG,
        reps=20)
    del ops3
    batched_pc, batched_pc_errs = timed("21", phase_batched_pc, card)
    ens3 = timed("22", phase_ensemble_fixed, card, agg3d_clargs(N3_BIG),
                 (N3_BIG,) * 3, ENS3_RUNS, 22, reps=2,
                 member_check=ENS3_RUNS[-2])
    ens_pc = timed("23", phase_ensemble_fixed, card, bench_clargs(N_BIG),
                   (N_BIG, N_BIG), ENS_PC_RUNS, 23, pc_pallas=True,
                   member_check=ENS_PC_RUNS[0])
    agg3 = timed("24 adaptive", phase_ensemble_adaptive_3d, card)
    timed("24 cpu 3d", phase_ensemble_card_vs_cpu, card, 24, agg3d_clargs,
          (N3_ENS_CMP,) * 3, 2)
    timed("24 cpu pc", phase_ensemble_card_vs_cpu, card, 24, bench_clargs,
          (N_ENS_CMP,) * 2, 3, pc_pallas=True)
    halo = timed("25", phase_halo_kernels, card)
    one_rank, b9_totals = timed("26", phase_one_rank_nccl, card)
    check(all(c > 0 for c in b9_totals.values()) and len(b9_totals) == 8,
          "a B9 kernel ran no launch on phase 26's paths: %s" % b9_totals)
    two_ranks = timed("27", phase_two_ranks, card)
    unfused = timed("28", phase_unfused, card)
    tdep = timed("29", phase_tdep, card)
    solver30, u_flag = timed("30", phase_solver, card)
    cli31 = timed("31", phase_entry_point, card, solver30["flagship"], u_flag)
    dirk32 = timed("32", phase_dirk, card, cli31["flagship"], main_f64,
                   main_f32)
    forms33 = timed("33", phase_pc_forms, card, main_f64, main_f32)
    b5_34 = timed("34", phase_b5_fields, card)
    krylov35 = timed("35", phase_krylov_with_g_flux, card,
                     cli31["flagship"])
    mesh36 = timed("36", phase_mesh_solver, card, solver30["flagship"],
                   u_flag, cli31)
    del u_flag
    forms37 = timed("37", phase_mesh_forms, card)
    print("phase seconds: %s" % "; ".join("%s %.2f" % kv for kv in seconds))
    # the rhs kernels of phase 8 are the same kernels as phases 2 and 5
    # build for the same problems: merge their figures
    for key, (ks, es, rs, ts) in ((2, (kern, errs, rel, times)),
                                  (3, (kern3, errs3, rel3, times3))):
        _, e, r, tm = rhs["%dd" % key]
        es["rhs"], rs["rhs"], ts["rhs"] = e, r, tm
    # launches per step of each path (per accepted step for the chunk,
    # per ensemble step for the ensembles, the same for every N), and
    # the launches counted on the main-path runs
    per_step = {p: {n: c // 10 for n, c in cs.items()} for p, cs in (
        ("f64", counts), ("f32", counts32), ("f64_pc", counts_pc),
        ("f32_pc", counts32_pc))}
    runs2d = [counts, counts32, counts_pc, counts32_pc]
    for pc, fig in chunks.items():
        sfx = "_pc" if pc else ""
        per_step["chunk_smooth" + sfx] = fig["smooth_per_accept"]
        per_step["chunk_stiff" + sfx] = fig["stiff_per_accept"]
        runs2d += [fig["smooth_counts"], fig["stiff_counts"]]
    per_step["ensemble_f64"] = ens["f64", 8]["per_step"]
    per_step["ensemble_f32"] = ens["f32", 8]["per_step"]
    per_step["ensemble_f64_pc"] = ens_pc[ENS_PC_RUNS[0]]["per_step"]
    runs2d += [f["launches"] for f in ens.values()] + [hexa["launches"]]
    runs2d.append(unfused["bench_1024"]["fused_launches"])
    runs2d += [f["launches"] for f in ens_pc.values()]
    # the host Solver's flagship run (phase 30 (b)), B1 and B3 only;
    # per accepted step of that run
    flag = solver30["flagship"]
    runs2d.append(flag["launches"])
    per_step["solver_flagship"] = {n: c / flag["accepts"]
                                   for n, c in flag["launches"].items()}
    # the driver's flagship and --ensemble runs (phase 31 (a), (c))
    cli = cli31["flagship"]
    runs2d += [cli["launches"], cli31["ensemble"]["launches"]]
    per_step["cli_flagship"] = {n: c / cli["accepts"]
                                for n, c in cli["launches"].items()}
    # the DIRK paths (phase 32) and the pc forms (phase 33): per step of
    # the chained multistep, per accepted step of the driver's arkimex
    # flagship
    for prefix, figs in (("dirk_", dirk32), ("pc_", forms33)):
        for key, f in figs.items():
            # the 2D multistep runs: 10 steps each
            if key.endswith(("_f64", "_f32")) and "launches" in f \
                    and key != "fft_3d_f64":
                per_step[prefix + key] = {n: c // 10
                                          for n, c in f["launches"].items()}
                runs2d.append(f["launches"])
    ark = dirk32["flagship"]
    runs2d += [ark["launches"], dirk32["ensemble"]["launches"]]
    # B5 at 5 fields and gmres_rolled over B2 (phases 34, 35): per step
    # of the 10-step chains; the gmres_rolled chunk's launches
    for key, f in (("f64_pc_nf%d" % PC_NF, b5_34["pc_pallas_nf%d" % PC_NF]),
                   ("gmres_rolled_f64", krylov35["gmres_rolled_f64"])):
        per_step[key] = {n: c // 10 for n, c in f["launches"].items()}
        runs2d.append(f["launches"])
    runs2d.append(krylov35["gmres_rolled_chunk"]["launches"])
    per_step["cli_flagship_arkimex"] = {n: c / ark["accepts"]
                                        for n, c in ark["launches"].items()}
    totals = {n: sum(c.get(n, 0) for c in runs2d)
              for n in list(kern.kernels) + ["pc_fwd", "pc_inv"]}
    per_step3 = {"f64": {n: c // 10 for n, c in counts3.items()},
                 "f32": {n: c // 10 for n, c in counts32_3.items()},
                 "ensemble_f64": ens3["f64", 1]["per_step"],
                 "ensemble_f32": ens3[ENS3_RUNS[-1]]["per_step"]}
    per_step3["pc_fft_f64"] = {n: c // 10 for n, c in
                               forms33["fft_3d_f64"]["launches"].items()}
    runs3d = [counts3, counts32_3, agg3["launches"],
              forms33["fft_3d_f64"]["launches"]] + [
        f["launches"] for f in ens3.values()]
    totals3 = {n: sum(c.get(n, 0) for c in runs3d) for n in kern3.kernels}
    # the mesh Solver's flagship (phase 36 (a), one-rank NCCL; (b), per
    # rank of two gloo ranks): B9's 2D resid and delta, per accepted step
    mesh_per_accept = {}
    for key, f in (("mesh_solver_one_rank_nccl", mesh36["one_rank_nccl"]),
                   ("mesh_solver_two_gloo_ranks",
                    mesh36["two_gloo_ranks"]["flagship"]),
                   ("mesh_solver_spectral_one_rank_nccl", dict(
                       accepts=forms37["spectral"]["accepts"],
                       launches=forms37["spectral"]["b9_launches"])),
                   ("mesh_solver_fft_one_rank_nccl", dict(
                       accepts=forms37["fft"]["accepts"],
                       launches=forms37["fft"]["b9_launches"]))):
        acc = f.get("accepts", f.get("k"))
        mesh_per_accept[key] = {n: c / acc for n, c in f["launches"].items()}
        for n, c in f["launches"].items():
            b9_totals[("2d", n)] = b9_totals.get(("2d", n), 0) + c
    big = "%d^2" % N_BIG
    agg = "%d^2" % N_AGG
    pc_times = {n: pc_figs[big][n][:5] for n in ("pc_fwd", "pc_inv")}
    # the member-batched builds at nb = NB: one batched launch, NB
    # single launches and the bound of NB members
    def batched_keys(figs, errs_b):
        return {n: {"ms_nb%d" % NB: a, "ms_%d_single" % NB: b_,
                    "bound_ms_nb%d" % NB: bd[0],
                    "batched_max_abs_err": errs_b[n][0]}
                for n, (a, b_, bd) in figs.items()}

    pc_extra = batched_keys(batched_pc, batched_pc_errs)
    for n in ("pc_fwd", "pc_inv"):
        pc_extra[n].update(zip(("ms_1536", "plain_ms_1536", "library_ms_1536",
                                "bound_ms_1536"), pc_figs[agg][n][:4]))
        pc_extra[n].update(bound_ms_f32_simt=pc_figs[big][n][5],
                           bound_ms_1536_f32_simt=pc_figs[agg][n][5],
                           pitch_copy_us=pc_figs["pitch_copy_us"])
        # phase 34: the same entry at 1024^2 with 1, 5 and 6 fields
        pc_extra[n]["fields_1024"] = {
            str(dof): per[n] for dof, per in b5_34["fields"].items()}
    b11_row = {
        "name": "coeff_resid", "route": "cuda",
        "source": "ksfd_tpu_torch/csrc/stencil2d.cu",
        "replaces": b11["kern"].coeff_resid.replaces,
        "launches": b11["launches"],
        "launches_per_step": {"probe": "1 per sweep"},
        "path": "probe (ksfd_tpu_torch/tools/probe_coeff_kernel.py)",
        "max_abs_err": b11["err"], "max_rel_err": b11["rel"],
        "ms": b11["ms"][0], "plain_ms": b11["ms"][1],
        "bound_ms": b11["bound"][0], "bound_by": b11["bound"][1],
        "library_ms": None, "library": "none",
        "probe_us_per_sweep": {"resid": b11["probe"]["production_us"],
                               "coeff_resid": b11["probe"]["coeff_us"]},
        "prepare_ms": b11["prepare_ms"],
    }
    rows = (kernel_rows(kern, "ksfd_tpu_torch/csrc/stencil2d.cu",
                        per_step, totals, errs, rel, times, "",
                        extra=batched_keys(batched, batched_errs))
            + [b11_row]
            + kernel_rows(kern3, "ksfd_tpu_torch/csrc/stencil3d.cu",
                          per_step3, totals3, errs3, rel3, times3, "3d",
                          extra=batched_keys(batched3, batched3_errs))
            + kernel_rows(pc_ragged, "ksfd_tpu_torch/csrc/pc2d.cu", per_step,
                          totals, pc_errs, pc_rel, pc_times, "",
                          extra=pc_extra)
            + b9_rows(halo, one_rank, b9_totals, mesh_per_accept))
    print(json.dumps({
        "kernels": rows,
        "ptxas_pc2d": ptxas_pc,
        "sass_pc2d": sass_pc,
        "ms_per_step": step_s * 1e3, "dof_updates_per_s": rate,
        "ms_per_step_3d": step3_s * 1e3, "dof_updates_per_s_3d": rate3,
        "ms_per_step_f32": step32_s * 1e3, "dof_updates_per_s_f32": rate32,
        "ms_per_step_3d_f32": step32_3_s * 1e3,
        "dof_updates_per_s_3d_f32": rate32_3,
        "ms_per_step_pc": step_pc_s * 1e3,
        "ms_per_step_f32_pc": step32_pc_s * 1e3,
        "ms_per_accept_chunk_smooth": chunks[False]["smooth_ms"],
        "ms_per_accept_chunk_smooth_pc": chunks[True]["smooth_ms"],
        "ms_per_accept_chunk_stiff": chunks[False]["stiff_ms"],
        "ms_per_accept_chunk_stiff_pc": chunks[True]["stiff_ms"],
        "ensemble": ensemble_json(ens),
        "ensemble_hexagons2d": hexa,
        "ensemble_3d": ensemble_json(ens3),
        "ensemble_pc": ensemble_json(ens_pc),
        "ensemble_aggregation3d": agg3,
        "one_rank_nccl": one_rank,
        "two_gloo_ranks_one_card": two_ranks,
        "unfused": unfused,
        "time_dependent_coefficients": tdep,
        "solver": solver30,
        "entry_point": cli31,
        "dirk": dirk32,
        "pc_forms": forms33,
        "b5_fields": {k: v for k, v in b5_34.items() if k != "fields"},
        "krylov_with_g_flux": krylov35,
        "mesh_solver": mesh36,
        "mesh_forms": forms37,
    }))
    # the card, and one short line per kernel, where the returned end of
    # the output keeps them
    print(card)
    for line in kernel_lines(rows):
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
