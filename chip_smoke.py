"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

It builds the CUDA stencil kernels of ksfd_tpu_torch from the sources
in the checkout and runs four phases, each printing one line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, the float32 matmul precision and the kernels' build;
2. each kernel against its plain PyTorch version on the card at
   1024^2 x 3 f32, with CUDA-event times of both;
3. the main path at 1024^2 x 3 f64: ``make_multistep_fn`` with default
   numerics, chained fixed-dt steps at h=1 (2 and 10 steps), with
   exact launch counts, a finite state and embedded error, and the
   slope-timed ms/step and DOF-updates/s;
4. the same slice at 256^2 x 3 on the card and on the CPU (plain
   versions) from one numpy state, agreeing to 1e-5 of the summed
   increment.

Then one JSON line of the kernels and, last, the result line.  Any
failed phase raises, so the exit code is not 0 and no result prints.
It imports nothing of JAX.  Profiles and long reports go to
chiprun_out/.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
N_BIG = 1024
N_CMP = 256


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


def bench_clargs(n):
    """The options84-class bench problem on an n x n grid: the
    parameters of __graft_entry__._make_problem."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from helpers import OPTIONS92_PARAMS, make_clargs

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


def initial_state(grid):
    """Port of __graft_entry__._initial_state: near-uniform ~9000."""
    x = np.arange(grid.nx) / grid.nx
    y = np.arange(grid.ny) / grid.ny
    X, Y = np.meshgrid(x, y, indexing="ij")
    s = np.sin(2 * np.pi * (X + Y))
    return np.stack([9000.0 + s, 9000.0 + 0.7 * s, 9000.0 + 0.1 * s])


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
    fields = [rho]
    for lig in ps.Vgroups.ligands():
        suffix = lig.name()[1:]
        sval = float(ps.values0.get("s" + suffix, lig.s))
        gval = float(ps.values0.get("gamma" + suffix, lig.gamma))
        fields.append(rho * (sval / gval))
    return np.stack(fields)


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


def phase_kernels(card):
    """Each kernel against its plain version on the card, 1024^2 x 3."""
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels

    dev = torch.device("cuda")
    ps, grid, ops = problem_from_clargs(bench_clargs(N_BIG), N_BIG, N_BIG,
                                        device=dev)
    kern = make_fused_kernels(ops)
    t0 = time.perf_counter()
    kern.build.library()
    info = kern.build.build_info
    ptxas = [l.strip() for l in info["ptxas"].splitlines()
             if "registers" in l or "spill" in l]
    print("phase 1 build: nvcc %.2f s (setup incl. load %.2f s) | %s" % (
        info["nvcc_seconds"], time.perf_counter() - t0, " ; ".join(ptxas)))

    rng = np.random.default_rng(7)
    to = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    states = dict(rough=rough_state(grid, ps), initial=initial_state(grid))
    t = to(0.0, torch.float64)
    shift = to(1.0 / 0.435866521508459, torch.float64)
    errs = {k: 0.0 for k in kern.kernels}
    rel = {k: 0.0 for k in kern.kernels}
    cases = []
    for sname, u_np in states.items():
        u64 = ops.groom(to(u_np, torch.float64))
        u = u64.float()
        v = to(rng.standard_normal(grid.Vshape))
        b = to(rng.standard_normal(grid.Vshape))
        cases.append(("jvp", sname, (u, v, t)))
        cases.append(("resid", sname, (u, v, b, t, shift)))
        if sname == "rough":
            # the groom's where-form clamp and the strict tangent mask:
            # points below, at and NaN against the floors
            raw = u_np.copy()
            raw[0, ::97, ::89] = 0.5 * ops.rhomin
            raw[0, 3, 5] = ops.rhomin
            raw[1, 5, 7] = ops.Umin
            raw[2, 9, 11] = np.nan
            uc = to(raw)
            cases.append(("jvp", "clamped", (uc, v, t)))
            cases.append(("resid", "clamped", (uc, v, b, t, shift)))
        scales = [("d100", 100.0)] if sname == "rough" else [("d1e-3", 1e-3)]
        for dname, scale in scales:
            d = to(scale * rng.standard_normal(grid.Vshape), torch.float64)
            u1 = ops.groom(u64 + d)
            cases.append(("delta", sname + "/" + dname,
                          (u64, u1 - u64, u1, t)))
        # clamp-to-floor: a fifth of the points fall to the floor
        drop = to(rng.random(grid.Vshape) < 0.2, torch.float64)
        u1 = ops.groom(u64 - 2.0 * u64 * drop)
        cases.append(("delta", sname + "/floor", (u64, u1 - u64, u1, t)))
    lines = []
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
        errs[name] = max(errs[name], err)
        rel[name] = max(rel[name], err / scale)
        lines.append("%s/%s err %.3e (%.2e rel)" % (name, label, err,
                                                    err / scale))
    # times at the main path's shapes (the rough state's operands):
    # the kernel and the plain body on the same prepared f32 operands
    times = {}
    for name, label, args in cases:
        if label not in ("rough", "rough/d100"):
            continue
        k = kern.kernels[name]
        prepared = k.prepare(*args)
        times[name] = (cuda_ms(lambda: k.launch(*prepared), 200),
                       cuda_ms(lambda: k.body(*prepared), 20))
    print("phase 2 kernels vs plain (%s): %s | ms kernel/plain: %s" % (
        card, "; ".join(lines),
        "; ".join("%s %.4f/%.4f" % (n, a, b) for n, (a, b) in times.items())))
    return kern, errs, rel, times


def phase_main_path(card):
    """make_multistep_fn at 1024^2 x 3 f64, fixed dt h=1."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels
    from ksfd_tpu_torch.solvers import make_multistep_fn

    dev = torch.device("cuda")
    ps, grid, ops = problem_from_clargs(bench_clargs(N_BIG), N_BIG, N_BIG,
                                        device=dev)
    kern = make_fused_kernels(ops)
    multi, _ = make_multistep_fn(ops, NumericsOptions(), atol=0.01,
                                 rtol=1e-6, static_steps=False,
                                 kernels=kern)
    u0 = torch.as_tensor(initial_state(grid), device=dev)
    t0 = torch.zeros((), dtype=torch.float64, device=dev)
    h = torch.ones((), dtype=torch.float64, device=dev)

    counts = {}
    for n in (2, 10):
        for k in kern.kernels.values():
            k.launches = 0
        u, t, emax = multi(u0, t0, h, n)
        torch.cuda.synchronize()
        counts[n] = {name: k.launches for name, k in kern.kernels.items()}
        check(counts[n] == dict(jvp=0, resid=8 * n, delta=4 * n),
              "launch counts %s for %d steps" % (counts[n], n))
        check(bool(torch.isfinite(u).all()), "state finite")
        check(bool(torch.isfinite(emax)), "emax finite")
        check(abs(float(t) - n) < 1e-9, "t advanced")
    inc = float((u - u0).abs().max())

    # slope timing: min over repeats of the 2- and 10-step chains,
    # each from a distinctly perturbed state
    samples = {2: [], 10: []}
    for rep in range(3):
        for n in (2, 10):
            pert = 1e-9 * (1 + 2 * rep + (n == 10))
            up = u0 * (1.0 + pert) + pert
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            multi(up, t0, h, n)
            torch.cuda.synchronize()
            samples[n].append(time.perf_counter() - t_start)
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
    with open(os.path.join(OUT_DIR, "main_path_profile.txt"), "w") as fh:
        fh.write("%s\n2-step chain, 1024^2 x 3, h=1\n%s\n" % (card, table))
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
        elif "ksfd" in low or "jvp_kernel" in low or "delta_kernel" in low:
            groups["stencil kernels"] += ms
        else:
            groups["other"] += ms
    device_ms = sum(groups.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    print("phase 3 main path 1024^2x3 f64 h=1 (%s): counts %s; emax %.6e; "
          "max|u10-u0| %.6e; %.4f ms/step (2-step %.4f s, 10-step %.4f s); "
          "%.6e DOF-updates/s | profiled device ms/step %.4f (busy %.3f of "
          "the step): %s | top: %s" % (
              card, counts[10], float(emax), inc, step_s * 1e3,
              min(samples[2]), min(samples[10]), rate, device_ms,
              device_ms / (step_s * 1e3),
              "; ".join("%s %.4f" % kv for kv in groups.items()),
              "; ".join("%s %.4f" % (k[:48], v) for k, v in top)))
    return counts[10], step_s, rate


def phase_card_vs_cpu(card):
    """The 256^2 x 3 slice on the card (kernels) and on the CPU (plain
    versions) from one numpy state: 4 chained steps."""
    from ksfd_tpu_torch import NumericsOptions
    from ksfd_tpu_torch.interop import problem_from_clargs
    from ksfd_tpu_torch.solvers import make_multistep_fn

    runs = {}
    for dev in ("cuda", "cpu"):
        ps, grid, ops = problem_from_clargs(bench_clargs(N_CMP), N_CMP,
                                            N_CMP, device=dev)
        multi, _ = make_multistep_fn(ops, NumericsOptions(), atol=0.01,
                                     rtol=1e-6)
        u0 = torch.as_tensor(rough_state(grid, ps), device=dev)
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
    check(dev_abs <= 1e-5 * inc,
          "card vs cpu: %.3e > 1e-5 * %.3e" % (dev_abs, inc))
    print("phase 4 card vs cpu 256^2x3 rough h=1e-4 x4 (%s): max dev "
          "%.3e, summed increment %.6e, dev/inc %.3e; emax cuda %.6e "
          "cpu %.6e" % (card, dev_abs, inc, dev_abs / inc, runs["cuda"][1],
                        runs["cpu"][1]))


def main():
    card = phase_device()
    kern, errs, rel, times = phase_kernels(card)
    counts, step_s, rate = phase_main_path(card)
    phase_card_vs_cpu(card)
    src = "ksfd_tpu_torch/csrc/stencil2d.cu"
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": k.replaces, "launches": counts[name],
         "max_abs_err": errs[name], "max_rel_err": rel[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "on_main_path": name != "jvp"}
        for name, k in kern.kernels.items()
    ], "ms_per_step": step_s * 1e3, "dof_updates_per_s": rate}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
