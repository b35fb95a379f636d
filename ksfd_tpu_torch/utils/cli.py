"""Command-line parsing: @file indirection and the numerics options.

Counterpart: ksfd_tpu/utils/cli.py (the reference's ksfdargparse.py and
ksfdsolver2.py grammar).  The same grammar and the same decoding:

- options ``--name=value``; parameters ``name=value`` (sympy
  expressions);
- subsystem blocks ``--numerics <args...> --`` (the native numerics)
  and ``--petsc <args...> --`` (a reference PETSc block: the options
  with a meaning here are translated, the rest recorded in
  ``unrecognized`` and noted on stderr);
- ``@optionsfile`` indirection with '#' comments (shlex rules).

``decode_numerics`` decodes every token the reference decodes; where
the port refuses a combination, the refusal is the step's
(solvers/solver.py ``_check_numerics``).
"""

import re
import shlex
import sys
from argparse import ArgumentParser, SUPPRESS
from dataclasses import dataclass, field, asdict

from .debug import logger
from .exceptions import KSFDException

logMAIN = logger("MAIN")

__all__ = ["Parser", "NumericsOptions", "decode_numerics"]


class Parser(ArgumentParser):
    """ArgumentParser with @file indirection and subsystem extraction.
    Counterpart: ksfd_tpu/utils/cli.py:Parser.

    ``parse_args`` returns the usual Namespace, plus attributes named
    after each subsystem ('numerics', 'petsc') holding the raw token
    lists of the corresponding blocks.
    """

    subsystems = ["numerics", "petsc"]

    def __init__(self, *args, **kwargs):
        super().__init__(
            *args, fromfile_prefix_chars="@", allow_abbrev=False, **kwargs
        )
        # for the help message only: the blocks are stripped before the
        # arguments reach argparse
        for subsystem in self.subsystems:
            self.add_argument(
                "--" + subsystem,
                action="append",
                default=SUPPRESS,
                help="{s} subsystem arguments; terminate with --".format(
                    s=subsystem),
            )

    def convert_arg_line_to_args(self, arg_line):
        return shlex.split(arg_line, comments=True)

    def _extract_subsystem_blocks(self, tokens):
        """One left-to-right scan pulling out '--<name> ... --' blocks.

        Returns (remaining_tokens, {name: block_tokens}).  A block runs
        from its introducer to the next bare '--' (or the end); repeated
        blocks of one subsystem concatenate; '--numerics=<tokens>' is a
        self-contained block.
        """
        blocks = {name: [] for name in self.subsystems}
        rest = []
        stream = iter(tokens)
        for tok in stream:
            name = inline = None
            if tok.startswith("--"):
                body = tok[2:]
                if body in blocks:
                    name = body
                elif "=" in body:
                    head, _, val = body.partition("=")
                    if head in blocks:
                        name, inline = head, shlex.split(val)
            if name is None:
                rest.append(tok)
                continue
            if inline is not None:
                blocks[name].extend(inline)
                continue
            for inner in stream:
                if inner == "--":
                    break
                blocks[name].append(inner)
        return rest, blocks

    def parse_args(self, args=None, namespace=None):
        if args is None:
            args = sys.argv[1:]
        args = self._read_args_from_files(list(args))
        args, blocks = self._extract_subsystem_blocks(args)
        # argparse cannot interleave positionals (parameters) with
        # optionals: the name=value tokens go last, which keeps their
        # order and allows 'prog @file --resume=x maxsteps=2'
        params = [a for a in args if _is_param(a)]
        args = [a for a in args if not _is_param(a)] + params
        ns = super().parse_args(args, namespace=namespace)
        for subsystem in self.subsystems:
            setattr(ns, subsystem, blocks[subsystem])
        return ns


def _is_param(arg):
    return re.match(r"^[A-Za-z_]\w*=", arg) is not None


@dataclass
class NumericsOptions:
    """The numerical-method configuration.

    Counterpart: ksfd_tpu/utils/cli.py:NumericsOptions — the same
    fields with the same defaults, so one options object describes a
    run of either package.  The comments below are the reference's; the
    port runs every ksp_type and pc_type of the reference (gmres,
    gmres_rolled and gmres_restarted are the fixed-count Krylov tiers of
    solvers/gmres.py) and raises NotImplementedError, naming the ROADMAP
    item, for what it does not run yet (solvers/solver.py
    _check_numerics).
    """

    ts_type: str = "rosw"        # rosw (ROS34PW2 W-method) | arkimex
                                 # (ARK324L2SA ESDIRK) | beuler
    adapt_type: str = "basic"    # basic | none
    dt_min: float = 1e-20
    dt_max: float = 1e4
    clip_low: float = 0.1
    clip_high: float = 5.0
    safety: float = 0.9
    rollback_factor: float = 0.25   # -ts_adapt_scale_solve_failed
    max_snes_failures: int = 100    # consecutive failed-solve limit
    ksp_type: str = "richardson"  # richardson (preconditioned sweeps,
                                  # TPU default) | gmres (fixed-iter) |
                                  # gmres_scipy (tol-based) |
                                  # dense/direct | banded (1D native)
                                  # | lu (sparse SuperLU, any dim)
    ksp_max_it: int = 50
    ksp_rtol: float = 1e-8
    ksp_restart: int = 20
    ksp_iters_max: int = 16       # escalated sweep count for the
                                  # device-fused adaptive chunk's
                                  # on-device retry tier: a finite
                                  # rejection of the ksp_iters fast
                                  # attempt retries ONCE at this count
                                  # at the SAME h before shrinking
                                  # (and parks there briefly), so
                                  # stiff phases no longer force a
                                  # static worst-case -ksp_iters for
                                  # the whole run (VERDICT r3 #2).
                                  # <= ksp_iters disables.
    ksp_iters: int = 3            # sweeps / Krylov dim of fixed solvers
                                  # (3 measured equivalent to 4 on all
                                  # gates: options92/93, 256^2 TPU ramp
                                  # failure counts — see docs/PERF.md)
                                  # (block pc: 4 sweeps match 16 to
                                  # 1e-11 over chained 1024^2 steps;
                                  # hard states escalate to the GMRES
                                  # retry path automatically)
    ksp_iters_max2: int = 48      # THIRD escalation tier for the
                                  # fused adaptive chunk: application
                                  # count of the top tier, reached
                                  # when a ksp_iters_max attempt is
                                  # itself rejected at finite enorm.
                                  # Lets the controller hold h values
                                  # only a near-exact solve supports
                                  # (the h-gap, VERDICT r4 #1);
                                  # <= ksp_iters_max disables.
    esc_cheb: bool = True         # the TOP chunk tier (ksp_iters_max2)
                                  # runs CHEBYSHEV-accelerated
                                  # iteration instead of plain
                                  # Richardson (requires pc_type block
                                  # for the on-device spectral-interval
                                  # estimate; inner-product-free, so
                                  # chunk-safe).  ~sqrt(kappa) fewer
                                  # applications per contraction on
                                  # the aggregated phase's spread
                                  # spectrum — truncation-limited at
                                  # h=64+ where rich16 caps at ~5
                                  # (docs/PERF.md r5).  The MIDDLE
                                  # tier stays Richardson — it never
                                  # amplifies (eigenvalues in (0,2)),
                                  # keeping one robust-by-construction
                                  # escalation; measured equivalent
                                  # to Chebyshev at the aggregation
                                  # onset, so the safety is free.
                                  # -esc_cheb 0 opts out.
    cheb_lmin: float = 0.0        # Chebyshev interval lower bound for
                                  # -ksp_type chebyshev tiers; 0 =
                                  # estimate per step on device from
                                  # the pointwise diffusivity spread
                                  # (block pc only)
    cheb_lmax: float = 1.2        # interval upper bound: the block pc
                                  # over-damps (rho_diff is a max), so
                                  # M^{-1}W eigenvalues sit <= ~1; the
                                  # 0.2 margin guards coupling
                                  # excursions (eigenvalues ABOVE lmax
                                  # diverge, below lmin merely contract
                                  # slower — asymmetric by design)
    cheb_safety: float = 0.5      # multiplier on the AUTO lmin
                                  # estimate (the scalar-diffusivity
                                  # model ignores coupling spread;
                                  # under-estimating lmin is graceful)
    pc_type: str = "block"       # block (per-mode mean-state
                                 # linearization inverse, default) |
                                 # spectral (per-field diagonal) | none
    precision: str = "float64"   # float64 (parity) | float32 (fast
                                 # mode; fused Pallas kernels on TPU 2D)
    use_pallas: bool = True      # allow fused kernels in f32 mode
    device_loop: bool = False    # fuse the ADAPTIVE accept/reject loop
                                 # on device (chunks between monitors;
                                 # noise injection bounds each chunk
                                 # at the next injection time; a
                                 # constant CFL factor clamps h on
                                 # device; only a TIME-DEPENDENT CFL
                                 # factor falls back to the host loop)
    pc_dtype: str = "auto"       # transform dtype (approx inverse).
                                 # auto (default): float32 on a
                                 # single device; bfloat16 when the
                                 # build mesh spans >1 device or
                                 # process_count > 1 (VERDICT r4 #2 —
                                 # the multi-chip wire lever engages
                                 # by default where it matters).
                                 # bf16 also stores the transform
                                 # intermediates/coefficients in bf16:
                                 # single-chip-neutral (the apply is
                                 # MXU-utilization-bound, measured
                                 # 146 vs 145 us at 1024^2) but HALVES
                                 # the sharded pc's all-reduce wire
                                 # bytes — the multi-chip comm knob
                                 # (tests/test_comm_audit.py pins the
                                 # halving).  Explicit -pc_dtype
                                 # f32/bf16/f64 always wins (the
                                 # sharded-vs-single identity tests
                                 # pin f32 on both sides).
    pc_pallas: bool = False      # fused Pallas block-pc apply
                                 # (ops/pallas_pc.py).  Measured AT
                                 # PARITY with the einsum apply on
                                 # v5e (143 vs 145 us at 1024^2x3 —
                                 # both MXU-utilization-bound, see
                                 # tools/probe_pc_kernel.py), so the
                                 # simpler sharding-transparent
                                 # einsums stay the default; kept
                                 # selectable for platforms where
                                 # Mosaic GEMMs beat XLA's.
    pc_fft: str = "off"          # spectral-pc transforms via f32
                                 # rfftn/irfftn instead of the basis
                                 # matmuls.  ~100x fewer FLOPs but
                                 # MEASURED SLOWER on TPU v5e (43 vs
                                 # 18 ms/step at 1536^2 - XLA:TPU's
                                 # FFT is far off the MXU einsum
                                 # rate), so default off; kept for
                                 # FFT-strong platforms.  auto = on
                                 # for single-device processes only
                                 # (an FFT along a sharded axis would
                                 # gather); -pc_fft 1/0 forces
    sweep_dtype: str = "float32"  # richardson sweep-chain dtype; f32
                                  # (default) halves sweep HBM traffic
                                  # while stage rhs/combos/error stay
                                  # f64 — measured state deviation vs
                                  # 16 f64 sweeps: 1.9e-7 at 1024^2
                                  # (same as f64 4-sweep truncation);
                                  # -ksp_sweep_dtype f64 opts out
    stage_delta: bool = True     # evaluate stage RHS as f(u0) + fused
                                 # increment kernel (f32, accurate to
                                 # ~1e-6 of the increment; ops/delta.py)
                                 # instead of a full f64 eval per
                                 # stage.  Active only on the mixed
                                 # path (sweep_dtype f32, Pallas
                                 # available, no TD coefficients);
                                 # -stage_delta 0 opts out
    snes_iters: int = 2          # modified-Newton iterations per DIRK
                                 # stage (-snes_type ksponly sets 1,
                                 # matching the reference's PETSc runs)
    petsc_direct: bool = False   # a PETSc block requested the exact
                                 # direct solve ('-ksp_type preonly
                                 # -pc_type lu', the reference's MUMPS
                                 # configuration); ksfdsolver routes it
                                 # onto -ksp_type banded/lu at startup
                                 # when the grid fits a host
                                 # factorization (solver.
                                 # route_petsc_direct), else keeps the
                                 # iterative stack with a stderr note
    monitor: bool = False
    unrecognized: list = field(default_factory=list)

    def asdict(self):
        return asdict(self)


_TS_TYPE_MAP = {
    "rosw": "rosw",
    # the implicit (ESDIRK) part of PETSc's default ARKIMEX3 scheme,
    # ARK324L2SA (the DIRK path, solvers/solver.py _combine_dirk)
    "arkimex": "arkimex",
    "beuler": "beuler",
}

_FALSE = ("0", "false", "False")
_PRECISIONS = {"f32": "float32", "f64": "float64",
               "float32": "float32", "float64": "float64"}


def decode_numerics(tokens, petsc_tokens=()):
    """NumericsOptions from --numerics tokens and/or a PETSc block.
    Counterpart: ksfd_tpu/utils/cli.py:decode_numerics.

    Native tokens have PETSc's ``-key value`` shape (``-ts_type rosw
    -ksp_rtol 1e-10``); the PETSc block is read first, so a native token
    wins.  A bad or missing value raises KSFDException; a token with no
    meaning here is recorded in ``unrecognized`` and noted on stderr.
    ``-ksp_type preonly`` with ``-pc_type lu`` (the reference's MUMPS
    configuration) sets ``petsc_direct`` unless a native ``-ksp_type``
    was given.
    """
    opts = NumericsOptions()
    toks = list(petsc_tokens) + list(tokens)
    i = 0
    arkimex_scheme = None
    saw_preonly = saw_pc_lu = explicit_ksp = False
    pending_notes = []

    def take_value(i):
        if i + 1 < len(toks) and not toks[i + 1].startswith("-"):
            return toks[i + 1], i + 2
        # numeric values may start with '-' ('-ts_adapt_clip -0.1,5')
        if i + 1 < len(toks):
            nxt = toks[i + 1]
            try:
                for part in nxt.split(","):
                    float(part)
                return nxt, i + 2
            except ValueError:
                pass
        return None, i + 1

    def bad(tok, val, want=""):
        return KSFDException(
            "bad or missing value for numerics option "
            "{t}: {v!r}{w}".format(t=tok, v=val, w=want))

    def fnum(val, tok):
        try:
            return float(val)
        except (TypeError, ValueError):
            raise bad(tok, val)

    def inum(val, tok):
        try:
            return int(val)
        except (TypeError, ValueError):
            raise bad(tok, val)

    def note(tok, val):
        opts.unrecognized.append("{t} {v}".format(t=tok, v=val))

    while i < len(toks):
        tok = toks[i]
        key = tok.lstrip("-")
        if key == "ts_type":
            val, i = take_value(i)
            if val in _TS_TYPE_MAP:
                opts.ts_type = _TS_TYPE_MAP[val]
            else:
                note(tok, val)
        elif key == "ts_arkimex_type":
            # the scheme within -ts_type arkimex: 3 is ARK324L2SA, 4 is
            # ARK436L2SA; applied after the loop iff ts_type is arkimex
            val, i = take_value(i)
            if val in ("3", "ark324", "ark324l2sa"):
                arkimex_scheme = "ark324"
            elif val in ("4", "ark436", "ark436l2sa"):
                arkimex_scheme = "ark436"
            else:
                note(tok, val)
        elif key == "ts_adapt_type":
            val, i = take_value(i)
            if val in ("none", "basic"):
                opts.adapt_type = val
            else:
                # other PETSc adaptors map to basic, and are recorded
                opts.adapt_type = "basic"
                note(tok, val)
        elif key == "ts_adapt_dt_max":
            val, i = take_value(i)
            opts.dt_max = fnum(val, tok)
        elif key == "ts_adapt_dt_min":
            val, i = take_value(i)
            opts.dt_min = fnum(val, tok)
        elif key == "ts_adapt_clip":
            val, i = take_value(i)
            try:
                lo, hi = val.split(",")
            except (AttributeError, TypeError, ValueError):
                raise bad(tok, val, " (want lo,hi)")
            opts.clip_low, opts.clip_high = fnum(lo, tok), fnum(hi, tok)
        elif key == "ts_adapt_scale_solve_failed":
            val, i = take_value(i)
            opts.rollback_factor = fnum(val, tok)
        elif key == "ts_adapt_safety":
            val, i = take_value(i)
            opts.safety = fnum(val, tok)
        elif key == "ts_max_snes_failures":
            val, i = take_value(i)
            opts.max_snes_failures = inum(val, tok)
        elif key == "snes_type":
            val, i = take_value(i)
            if val == "ksponly":
                # one linear solve per implicit stage, the reference's
                # configuration
                opts.snes_iters = 1
            else:
                note(tok, val)
        elif key == "snes_iters":
            val, i = take_value(i)
            opts.snes_iters = inum(val, tok)
        elif key == "ksp_max_it":
            val, i = take_value(i)
            opts.ksp_max_it = inum(val, tok)
        elif key == "ksp_rtol":
            val, i = take_value(i)
            opts.ksp_rtol = fnum(val, tok)
        elif key == "ksp_iters":
            val, i = take_value(i)
            opts.ksp_iters = inum(val, tok)
        elif key == "ksp_iters_max":
            val, i = take_value(i)
            opts.ksp_iters_max = inum(val, tok)
        elif key == "ksp_iters_max2":
            val, i = take_value(i)
            opts.ksp_iters_max2 = inum(val, tok)
        elif key == "esc_cheb":
            val, i = take_value(i)
            opts.esc_cheb = str(val) not in _FALSE
        elif key == "cheb_lmin":
            val, i = take_value(i)
            opts.cheb_lmin = fnum(val, tok)
        elif key == "cheb_lmax":
            val, i = take_value(i)
            opts.cheb_lmax = fnum(val, tok)
        elif key == "cheb_safety":
            val, i = take_value(i)
            opts.cheb_safety = fnum(val, tok)
        elif key in ("ksp_restart", "ksp_gmres_restart"):
            val, i = take_value(i)
            opts.ksp_restart = inum(val, tok)
        elif key == "ksp_type":
            val, i = take_value(i)
            if val in (
                "richardson", "chebyshev", "gmres", "gmres_restarted",
                "gmres_rolled", "gmres_scipy", "dense", "direct",
                "banded", "lu",
            ):
                opts.ksp_type = val
                # a native selection overrides the PETSc-pair routing
                explicit_ksp = True
            elif val == "preonly":
                saw_preonly = True
                pending_notes.append(
                    "ksp_type preonly (kept default; exact direct "
                    "solves: -ksp_type lu any-dim, banded 1D)"
                )
            else:
                note(tok, val)
        elif key == "pc_type":
            val, i = take_value(i)
            if val in ("spectral", "block", "none"):
                opts.pc_type = val
            elif val in ("lu", "cholesky"):
                saw_pc_lu = True
                pending_notes.append("{t} {v}".format(t=tok, v=val))
            else:
                note(tok, val)
        elif key == "device_loop":
            val, i = take_value(i)
            opts.device_loop = str(val) not in _FALSE
        elif key == "use_pallas":
            val, i = take_value(i)
            opts.use_pallas = str(val) not in _FALSE
        elif key == "stage_delta":
            val, i = take_value(i)
            opts.stage_delta = str(val) not in _FALSE
        elif key == "precision":
            val, i = take_value(i)
            opts.precision = _PRECISIONS.get(val, opts.precision)
        elif key in ("ksp_sweep_dtype", "sweep_dtype"):
            val, i = take_value(i)
            opts.sweep_dtype = _PRECISIONS.get(val, opts.sweep_dtype)
        elif key == "pc_dtype":
            val, i = take_value(i)
            opts.pc_dtype = dict(_PRECISIONS, bf16="bfloat16",
                                 bfloat16="bfloat16", auto="auto").get(
                                     val, opts.pc_dtype)
        elif key == "pc_pallas":
            val, i = take_value(i)
            opts.pc_pallas = str(val) not in _FALSE
        elif key == "pc_fft":
            val, i = take_value(i)
            opts.pc_fft = {
                "0": "off", "false": "off", "off": "off",
                "1": "on", "true": "on", "on": "on",
                "auto": "auto",
            }.get(str(val), opts.pc_fft)
        elif key in ("ts_adapt_monitor", "snes_monitor", "ksp_monitor",
                     "monitor"):
            val, i = take_value(i)
            opts.monitor = str(val) not in _FALSE
        else:
            # consume an attached value if one follows
            val, i = take_value(i)
            opts.unrecognized.append(tok if val is None else
                                     "{t} {v}".format(t=tok, v=val))
    if arkimex_scheme is not None and opts.ts_type == "arkimex":
        opts.ts_type = arkimex_scheme
    if saw_preonly and saw_pc_lu and not explicit_ksp:
        # the reference's MUMPS configuration: an exact direct solve,
        # routed once the grid is known (solvers.route_petsc_direct)
        opts.petsc_direct = True
        opts.unrecognized.append(
            "ksp_type preonly + pc_type lu: exact direct solve "
            "requested (routed onto -ksp_type banded/lu at startup "
            "when the grid fits a host factorization)"
        )
    else:
        opts.unrecognized.extend(pending_notes)
    if opts.unrecognized:
        # the -options_left analog: a typo in a numerics block is never
        # silently absorbed
        print(
            "ksfd: numerics options ignored or translated: "
            + "; ".join(opts.unrecognized),
            file=sys.stderr,
        )
        logMAIN("ignored numerics options:", opts.unrecognized)
    return opts
