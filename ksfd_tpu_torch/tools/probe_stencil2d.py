"""Measurement probe: where the time of the 2D jvp and resid kernels goes.

B2 (jvp) and B1 (resid) of csrc/stencil2d.cu march along x: they load
u and v, evaluate the pointwise functions (the groom, the tangent mask,
G and dG.v) into a ring of rows and compute the star-stencil rows from
it; resid also reads b and v at each output.  This probe builds
variants of the source that drop one part at a time (each a text edit,
built into ``ksfd_tpu_torch/_build/`` like the library itself) and
times both kernels of every variant with CUDA events, in turns (in
order, then reversed), on the 2D bench problem (tools/problems.py
bench_clargs) at n^2 x 3 for each n given:

- ``full``: the library as it is (checked against the plain versions to
  1e-5 of max|plain| first);
- ``no_pointwise``: G and dG replaced by loaded values (the groom, the
  tangent mask and the rows stay);
- ``loads_only``: the evaluated values stored, no stencil rows computed:
  each output is its centre values, read and written as before;
- ``rows_only``: the loads of u and v replaced by constants of the
  data's size (fields 6000-7008, tangents -100-87.5), so no global reads
  of them and no address arithmetic for them; the evaluations and the
  rows stay;
- ``no_output_reads``: resid writes its rows without reading b and v at
  the outputs (jvp unchanged, a control);
- ``early_reads`` (computes what ``full`` computes, checked like it):
  resid reads b and v at a thread's outputs of the step into registers
  before the step's second barrier, in place of at each output after
  it;
- ``b_prefetch`` (likewise): an L2 prefetch of the lines of b at the
  step's outputs, issued at the step's start;
- with ``--geometry TY,TX,LX,NT,MINB`` (repeatable): ``full`` with TY
  output columns a block, steps of TX rows, chunks of LX rows, NT
  threads and MINB resident blocks per SM (the registers ptxas sizes
  for) in place of its own, a variant named e.g.
  ``march_64x16_lx32_256t_3b`` that computes what ``full`` computes and
  is checked like it.

The variants that drop a part compute wrong numbers by design; they
only time.  ``early_reads`` and ``b_prefetch`` are designs that were
tried and not kept.  Run on the card:

    python -m ksfd_tpu_torch.tools.probe_stencil2d [--n 1024 1536]
        [--reps 50] [--geometry ...]

It prints one line per size and variant (µs of jvp and resid, each
turn, and ptxas's registers and spills of the unsharded entries) and,
last, one JSON line with the card's name and power limit and the mean
µs per size, variant and kernel.
"""

import argparse
import json
import re
from concurrent.futures import ThreadPoolExecutor

import torch

from ..interop import problem_from_clargs
from ..ops.fused_stencil import BUILD_DIR, CSRC, build_library, \
    make_fused_kernels
from ..utils.device import card_line
from .probe_stencil3d import _ptxas, run
from .problems import bench_clargs

__all__ = ["KERNELS", "SAME", "variants", "geometry", "build_variants",
           "main"]

#: the kernels timed, in the order of each line
KERNELS = ("jvp", "resid")

#: the variants that drop a part: edits of jvp_point, jvp_rows and the
#: step's loads
_PARTS = {
    "no_pointwise": [
        ("  ksfd_dG(f, dg);\n",
         "  for (int k = 0; k < DOF; ++k) dg[k] = f[k];\n"),
        ("  val[1] = ksfd_G(f);\n", "  val[1] = f[0];\n"),
    ],
    "loads_only": [
        ("  float row = graddot(w[3], w[1], cen + 3 * ca, cen + 1 * ca) +\n"
         "              graddot(w[0], w[2], cen, cen + 2 * ca) +\n"
         "              vr * lap(w[1], cen + 1 * ca) + "
         "w[0][SW] * lap(w[2], cen + 2 * ca);\n",
         "  float row = w[1][SW] + w[2][SW];\n"),
        ("    row = -ksfd_gamma(l) * w[4 + l][SW] + ksfd_s(l) * vr +\n"
         "          ksfd_D(l) * lap(w[4 + l], cen + (4 + l) * ca);\n",
         "    row = w[4 + l][SW];\n"),
    ],
    "rows_only": [
        ("        raw[q] = ru[q * fs];\n"
         "        raw[DOF + q] = rv[q * fs];\n",
         "        raw[q] = 6000.0f + 16.0f * (float)((i + 7 * q) & 63);\n"
         "        raw[DOF + q] = 12.5f * (float)(((i * 5 + q * 3) & 15) - 8);\n"),
    ],
    "no_output_reads": [
        ("cen + 2 * ca);\n  out[g] = RESID ? b[g] - shift * v[g] + row : row;\n",
         "cen + 2 * ca);\n  out[g] = row;\n"),
        ("    const size_t gl = (1 + l) * plane + g;\n"
         "    out[gl] = RESID ? b[gl] - shift * v[gl] + row : row;\n",
         "    const size_t gl = (1 + l) * plane + g;\n    out[gl] = row;\n"),
    ],
}

#: the rows phase's loop head, and resid's reads of b and v at a thread's
#: outputs of the step into registers before the barrier (early_reads)
_ROWS = ("    __syncthreads();\n"
         "    for (int i = threadIdx.x; i < nrow * MTY; i += MNT) {\n"
         "      const int kx = i / MTY, ty = i - kx * MTY, y = y0 + ty;\n")
_EARLY_ROWS = """    float bsv[RESID ? PER : 1][DOF];
    if (RESID) {
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int i = threadIdx.x + p * MNT, kx = i / MTY;
        const int y = y0 + (i - kx * MTY);
        if (i < nrow * MTY && y < ny) {
          const size_t g = (size_t)(x0 + kx) * ny + y;
#pragma unroll
          for (int q = 0; q < DOF; ++q)
            bsv[p][q] = b[q * plane + g] - shift * v[q * plane + g];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = threadIdx.x + p * MNT;
      if (i >= nrow * MTY) break;
      const int kx = i / MTY, ty = i - kx * MTY, y = y0 + ty;
"""

#: an L2 prefetch of resid's b lines at a step's outputs, issued at the
#: step's start, one line a thread (b_prefetch)
_PREFETCH_FN = """// A hint: the 128-byte line of p into L2 (nothing in the host build).
__device__ __forceinline__ void prefetch_l2(const float* p) {
#ifdef __CUDACC__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#else
  (void)p;
#endif
}

"""
_PREFETCH_STEP = """    if (RESID) {
      constexpr int NLN = (MTY + 31) / 32;
      for (int i = threadIdx.x; i < nrow * DOF * NLN; i += MNT) {
        const int r = i / (DOF * NLN), j = i - r * DOF * NLN;
        const int q = j / NLN, y = y0 + 32 * (j - q * NLN);
        if (y < ny) prefetch_l2(b + q * plane + (size_t)(x0 + r) * ny + y);
      }
    }
"""
_LANDING = "    // where the landing rows lie (the step before is past its loads)\n"
_POINT = "// One point's window values"

#: the variants that compute what full computes: designs tried
_SAME_EDITS = {
    "early_reads": [
        ("constexpr int MW = 2 * SW + 1;         // window rows of a stencil\n",
         "constexpr int MW = 2 * SW + 1;         // window rows of a stencil\n"
         "constexpr int PER = (MTX * MTY + MNT - 1) / MNT;\n"),
        ("cen + 2 * ca);\n  out[g] = RESID ? b[g] - shift * v[g] + row : row;\n",
         "cen + 2 * ca);\n  out[g] = RESID ? bs[0] + row : row;\n"),
        ("    const size_t gl = (1 + l) * plane + g;\n"
         "    out[gl] = RESID ? b[gl] - shift * v[gl] + row : row;\n",
         "    const size_t gl = (1 + l) * plane + g;\n"
         "    out[gl] = RESID ? bs[1 + l] + row : row;\n"),
        ("                                         float shift,\n"
         "                                         const float* __restrict__ v,\n"
         "                                         const float* __restrict__ b,\n",
         "                                         const float* bs,\n"),
        ("MHY, shift, v, b, out,", "MHY, bsv[p], out,"),
        (_ROWS, _EARLY_ROWS),
    ],
    "b_prefetch": [
        (_POINT, _PREFETCH_FN + _POINT),
        (_LANDING, _PREFETCH_STEP + _LANDING),
    ],
}
SAME = ("full",) + tuple(_SAME_EDITS)

#: the march's geometry line
_GEOMETRY = re.compile(r"(struct March \{\n  static constexpr int TY = )\d+"
                       r"(, TX = )\d+(, LX = )\d+(, NT = KSFD_THREADS\()\d+"
                       r"(\), MINB = )\d+;")


def variants(src):
    """The variants' sources by name, from the text of
    csrc/stencil2d.cu."""
    out = {"full": src}
    for name, edits in list(_PARTS.items()) + list(_SAME_EDITS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(
                    "csrc/stencil2d.cu changed: the probe's anchor %r is "
                    "not found once" % old.strip()[:60])
            text = text.replace(old, new)
        out[name] = text
    return out


def geometry(src, spec):
    """(name, source): ``src`` with the march's launch geometry of
    ``spec``, "TY,TX,LX,NT,MINB", in place of its own."""
    nums = [int(n) for n in spec.split(",")]
    if len(nums) != 5:
        raise ValueError("geometry %r: TY,TX,LX,NT,MINB" % spec)

    def put(m):
        return "".join(m.group(i + 1) + str(nums[i]) for i in range(5)) + ";"

    text, n = _GEOMETRY.subn(put, src)
    if n != 1:
        raise RuntimeError("csrc/stencil2d.cu: no march to give the "
                           "geometry %r" % spec)
    return "march_%dx%d_lx%d_%dt_%db" % tuple(nums), text


def build_variants(header, geometries=()):
    """The variants' (library, build info) by name, one nvcc each, all
    started together, for one problem's pointwise header; each of
    ``geometries`` (``geometry``'s specs) adds a geometry of ``full``."""
    text = CSRC.read_text()
    out = variants(text)
    out.update(geometry(text, spec) for spec in geometries)
    paths = {}
    for name, vtext in out.items():
        paths[name] = BUILD_DIR / ("probe_s2d_%s.cu" % name)
        paths[name].parent.mkdir(parents=True, exist_ok=True)
        paths[name].write_text(vtext)
    with ThreadPoolExecutor(len(paths)) as pool:
        built = pool.map(lambda path: build_library(header, path, ndim=2),
                         paths.values())
        return dict(zip(paths, built))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[1024])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--geometry", action="append", default=[],
                    metavar="TY,TX,LX,NT,MINB",
                    help="also time full with this launch geometry of the "
                    "march, e.g. 64,16,64,256,3")
    args = ap.parse_args(argv)
    text = CSRC.read_text()
    exact = list(SAME) + [geometry(text, g)[0] for g in args.geometry]
    means = {}
    for n in args.n:
        _, _, ops = problem_from_clargs(bench_clargs(n), n, n, device="cuda")
        kern = make_fused_kernels(ops)
        # the header depends on the spacing: one build per size
        built = build_variants(kern.build.header, args.geometry)
        libs = {name: lib for name, (lib, _) in built.items()}
        times = run(kern, libs, args.reps, exact, KERNELS)
        for name, turns in times.items():
            print("%d^2x3 %-22s %s | %s" % (n, name, ", ".join(
                "%s %s us" % (k, " / ".join("%.2f" % t[i] for t in turns))
                for i, k in enumerate(KERNELS)),
                _ptxas(built[name][1]["ptxas"])))
        means[n] = {name: {k: sum(t[i] for t in turns) / len(turns)
                           for i, k in enumerate(KERNELS)}
                    for name, turns in times.items()}
    print(json.dumps({"card": card_line(), "us": means}))


if __name__ == "__main__":
    main()
