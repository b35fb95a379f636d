"""Numerics options of the command line.

Counterpart: ksfd_tpu/utils/cli.py.  Only ``NumericsOptions`` is ported
so far; the ``Parser`` and the ``--petsc`` block translation come with
the I/O and the entry point (ROADMAP Queue A item 6, A8 part 2).
"""

from dataclasses import dataclass, field, asdict

__all__ = ["NumericsOptions"]


@dataclass
class NumericsOptions:
    """The numerical-method configuration.

    Counterpart: ksfd_tpu/utils/cli.py:NumericsOptions — the same
    fields with the same defaults, so one options object describes a
    run of either package.  The comments below are the reference's; the
    port builds only the default path (see solvers/solver.py) and
    raises NotImplementedError for the rest.
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
