"""Measurement probe: where the time of the fused pc's kernels goes.

B5a/B5b (csrc/pc2d.cu) run a ring of TMA loads into shared memory, the
consumers' reads and TF32 split of their A fragments, and three wgmma
passes per k-step.  This probe builds variants of the source that drop
one part at a time (each a text edit of csrc/pc2d.cu, built into
``ksfd_tpu_torch/_build/`` like the library itself) and times every
variant's two entries with CUDA events, in turns (in order, then
reversed), on one problem:

- ``full``: the library as it is (checked against the plain versions to
  1e-5 of max|plain| first);
- ``one_pass``: one wgmma pass (hi.hi) per k-step instead of three;
- ``no_mma``: no wgmma; the consumers still read and split A;
- ``no_reads``: the consumers do not read A from shared memory (their
  fragments are constants); three wgmma passes;
- ``ring``: the ring alone: the consumers wait for each stage and
  release it, nothing else (A and the B hi/lo planes come in: 32 KB per
  stage);
- ``ring_b_hi``: the ring alone, the B lo plane not loaded (24 KB);
- ``ring_a``: the ring alone, A only (16 KB).

The variants other than ``full`` compute wrong numbers by design; they
only time.  Run on the card:

    python -m ksfd_tpu_torch.tools.probe_pc_ring [--nx 1024 1536]
        [--reps 30]

It prints one line per size and variant (µs of pc_fwd and pc_inv, each
turn) and, last, one JSON line with the card's name and power limit and
the mean µs per size and variant.
"""

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..interop import problem_from_clargs
from ..ops import fused_pc
from ..ops.fused_stencil import BUILD_DIR, build_library
from ..utils.device import card_line
from .problems import bench_clargs

__all__ = ["variants", "build_variants", "run", "main"]

_THREE_PASSES = """          wgmma_tf32(part, lo[ks], b_hi + 2 * ks, ks > 0);
          wgmma_tf32(part, hi[ks], b_lo + 2 * ks, 1);
          wgmma_tf32(part, hi[ks], b_hi + 2 * ks, 1);"""
_READS = """          const float x[4] = {swz_ld(at, r0, k0), swz_ld(at, r0 + 8, k0),
                              swz_ld(at, r0, k0 + 4),
                              swz_ld(at, r0 + 8, k0 + 4)};"""
_STAGE_BODY = ("#pragma unroll\n      for (int f = 0; f < NACC; ++f) {\n"
               "        const char* at", "      mbar_arrive(&empty[s]);\n")
_EXPECT = "mbar_expect_tx(&full[s], R::STAGE);"
_B_BOX = "|| !encode(&mb, bt, w.K, w.N, 2, ldb, BN, 2))"
_B_LOAD = """        tma_load_3d(st + NACC * A_TILE_BYTES, &map_b, kt * BK, n0, 0,
                    &full[s]);"""


def _edit(src, old, new):
    if old not in src:
        raise RuntimeError("csrc/pc2d.cu changed: the probe's anchor %r "
                           "is gone" % old[:60])
    return src.replace(old, new)


def variants(src):
    """The variants' sources by name, from the text of csrc/pc2d.cu."""
    out = {"full": src}
    out["one_pass"] = _edit(src, _THREE_PASSES,
                            "          wgmma_tf32(part, hi[ks], b_hi + 2 * "
                            "ks, ks > 0);")
    out["no_mma"] = _edit(src, _THREE_PASSES, """#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[4 * ks + j] += __uint_as_float(hi[ks][j])
                                + __uint_as_float(lo[ks][j]);""")
    out["no_reads"] = _edit(src, _READS, "          const float x[4] = "
                            "{(float)r0, (float)k0, (float)kt, 2.f};")
    a = src.index(_STAGE_BODY[0])
    b = src.index(_STAGE_BODY[1], a)
    ring = src[:a] + "      acc[0][0] += (float)kt;\n" + src[b:]
    out["ring"] = ring
    out["ring_b_hi"] = _edit(
        _edit(ring, _EXPECT,
              "mbar_expect_tx(&full[s], R::STAGE - B_TILE_BYTES / 2);"),
        _B_BOX, "|| !encode(&mb, bt, w.K, w.N, 2, ldb, BN, 1))")
    out["ring_a"] = _edit(
        _edit(ring, _EXPECT,
              "mbar_expect_tx(&full[s], R::STAGE - B_TILE_BYTES);"),
        _B_LOAD, "")
    return out


def _event_us(fn, reps):
    """Mean µs of fn() over reps back-to-back calls (CUDA events), after
    a warm-up call, behind a sleep on the card 1.5 times the host's time
    to queue them (at 2e9 cycles per second), so that the events time
    the card and not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 1.5 * reps * host_s + 1e-3) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps * 1e3


def build_variants():
    """The variants' libraries by name, one nvcc each, all started
    together."""
    src = fused_pc.CSRC_PC.read_text()
    paths = {}
    for name, text in variants(src).items():
        paths[name] = BUILD_DIR / ("probe_pc_%s.cu" % name)
        paths[name].parent.mkdir(parents=True, exist_ok=True)
        paths[name].write_text(text)
    with ThreadPoolExecutor(len(paths)) as pool:
        built = pool.map(lambda path: build_library(
            "", path, entries=fused_pc._ENTRIES)[0], paths.values())
        return dict(zip(paths, built))


def run(libs, nx=1024, reps=30):
    """Check ``full`` of ``libs`` (build_variants) and time all of them
    in turns on the bench problem at nx^2 x 3; returns {variant: [(fwd
    µs, inv µs), ...]}."""
    dev = torch.device("cuda")
    _, grid, ops = problem_from_clargs(bench_clargs(nx), nx, nx, device=dev)
    pc = fused_pc.make_fused_block_pc(grid, ops)
    gen = torch.Generator(device=dev).manual_seed(3)
    v = torch.randn(tuple(grid.Vshape), generator=gen, device=dev)
    f64 = lambda x: torch.tensor(x, dtype=torch.float64, device=dev)
    sc = fused_pc.pack_pc_scalars(ops, f64(2.29), f64(0.0),
                                  [f64(9000.0)] * grid.dof, f64(1.0))
    fwd_in = pc.fwd.prepare(sc, v)
    fused_pc.PC_BUILD._lib = libs["full"]
    modes = pc.fwd.launch(*fwd_in)
    inv_in = pc.inv.prepare(modes)
    for got, want in ((modes, pc.fwd.body(*fwd_in)),
                      (pc.inv.launch(*inv_in), pc.inv.body(*inv_in))):
        err = float((got - want).abs().max())
        if not err <= 1e-5 * float(want.abs().max()):
            raise RuntimeError("pc2d.cu against its plain version: %.3e"
                               % err)
    times = {name: [] for name in libs}
    try:
        for name in list(libs) + list(reversed(list(libs))):
            fused_pc.PC_BUILD._lib = libs[name]
            times[name].append((
                _event_us(lambda: pc.fwd.launch(*fwd_in), reps),
                _event_us(lambda: pc.inv.launch(*inv_in), reps)))
    finally:
        fused_pc.PC_BUILD._lib = None
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, nargs="+", default=[1024])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    libs = build_variants()
    means = {}
    for nx in args.nx:
        times = run(libs, nx, args.reps)
        for name, turns in times.items():
            print("%d^2x3 %-10s pc_fwd %s us, pc_inv %s us" % (
                nx, name, " / ".join("%.1f" % t[0] for t in turns),
                " / ".join("%.1f" % t[1] for t in turns)))
        means[nx] = {name: [sum(t[i] for t in turns) / len(turns)
                            for i in (0, 1)]
                     for name, turns in times.items()}
    print(json.dumps({"card": card_line(), "us": means}))


if __name__ == "__main__":
    main()
