"""Ensemble integration: N independent trajectories as one batched program.

Counterpart: ksfd_tpu/solvers/ensemble.py:EnsembleSolver (and
:shard_members, which raises here), on 1D, 2D and 3D problems.  The
implicit step of solvers/solver.py is ``torch.func.vmap``-ped,
unchanged, over a leading member axis: under vmap each fused stencil
kernel, 2D or 3D, and with ``pc_pallas`` (2D) each fused pc kernel
launches its member-batched build once for all members (the vmap rule
of ops/fused_stencil.py, the counterpart of ``jax.custom_batching``),
the basis-GEMM preconditioner's products become batched products, and
the unfused step (1D, ``use_pallas=False``, the gate's refusals) runs
its once-per-step linearization batched.  The member axis stays on
the card; every member carries its own t, h, step count, controller and
fallback state on the host, in numpy.

Per member the semantics are the scalar host loop's: accept or reject
by the embedded error estimate, the PETSc-style vector h controller
with its clip and rollback (``_h_accept_vec``/``_h_reject_vec``), the
robust fallback retry at the same h with its per-member hysteresis (a
rescued member stays on the robust solver for ``fb_probe`` accepts
before it probes the fast path again), the CFL clamp, conservation,
grooming, monitors, and noise injection.  With ``block_steps > 1`` on a
fixed-dt run (``adapt_type="none"``) a vmapped ``make_multistep_fn``
fuses that many steps per member between monitor calls.

**The device loop** (``device_loop=True`` with adaptive steps, a solver
other than ``banded`` and a constant ``CFL_safety_factor``: the
reference's rule, ensemble.py:325-346) runs the adaptive chunk of
solvers/solver.py for every member in one dispatch per outer iteration
(``_chunk_iteration``, ensemble.py:473-629).  The reference vmaps its
``lax.while_loop`` chunk; the port's chunk is a host controller, so the
member axis is written out: one ``ChunkLadder`` per member (its own h
walk, tier, park and probe state, ``max_attempts=128``), and each
attempt runs ONE vmapped tier step (or f0-chain step) per occupied tier
on that tier's members (gathered with ``index_select``, scattered back
with ``index_copy``), so the member-batched kernels launch once per
tier; all members' enorms (and CFL bounds) come to the host in one
transfer per attempt.  The reference's batched ``lax.switch`` runs
every tier on every member and keeps each member's own; running each
member only on its tier gives the same result.  Each member's chunk
stops at its next noise time (``next_noise_time``); a member already
past it takes one accept per dispatch.  After the chunk: rejections
count in ``snes_failures``, the members that accepted get noise,
grooming and the CFL clamp, a stuck member gets the GMRES retry (probe
length ``min(64, 2**streak)``), an unrescued one shrinks h and counts a
failure; monitors run once per dispatch that accepted.

The robust fallback (``ksp_type="gmres_scipy"``, solvers/gmres.py
``gmres_solve``) runs member by member: a Python loop over the members
that need it runs the unbatched step.  The reference vmaps it, and
JAX's batched ``while_loop`` freezes the members whose GMRES has
converged, so each member's result there equals its unbatched one too;
the loop is that retry, not a way around a batched kernel.

Noise: one ``torch.Generator`` on the state's device per member,
seeded from ``(rng_key, member_offset + i)``, drawn only when the
member injects.  It cannot reproduce JAX's PRNG keys bit for bit, so
noise runs are held to statistics and to the reference's injection
times.

Usage:
    es = EnsembleSolver(ops, numerics, t0=.., dt=.., tmax=..,
                        maxsteps=.., atol=.., rtol=..)
    out = es.solve(U0)            # U0: (n_members, dof, *Sshape)
    out.u, out.t, out.k, out.diverged, out.snes_failures  # per member

With-G states (ops/operators_with_g.py) refresh every member's G slot
after grooming, at the start and after every accepted step
(ensemble.py:640-646, :465-469).  The fixed-count Krylov tiers
(``ksp_type`` gmres, gmres_rolled, gmres_restarted, and ``pc_type`` none
with Richardson or Chebyshev) run under vmap as the sweeps do: they read
nothing on the host.

Members go on ranks, not on devices: ``--ensemble`` over several
processes (ksfdsolver.py run_ensemble) gives each process a contiguous
slab of members, and ``shard_members`` places a process's members on
its one device.

**On a mesh** (``mesh=``, parallel/mesh.py: each member split over the
ranks' boxes, ``U`` this rank's ``(n_members, dof, *block)``) the
ensemble runs the reference's "xla" flavour (ksfd_tpu/solvers/
ensemble.py:210-290: ``use_pallas=False``, the unfused step, no
kernel; the reference has no batched mesh-sharded kernel either,
pallas_stencil.py:524-526): the same vmapped steps, whose halo pads,
reductions and gathers run as the mesh's custom ops with ONE collective
for all members (parallel/mesh.py).  Every decision comes from
all-reduced values (each member's error norm, CFL bound, means and
conserved mass), so every rank takes the same one; the noise is drawn
at the global shape and each rank keeps its block, per step and in the
device loop.
``pc_pallas`` where the reference's gate falls back (a 1D or 3D problem,
float64 transforms, a with-G state) takes the basis-GEMM pc
(``build_info``).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch
from torch.func import vmap

from ..ops.fused_pc import make_fused_block_pc
from ..ops.fused_stencil import check_mesh
from ..parallel.mesh import all_reduce_max, all_reduce_sum
from ..utils.cli import NumericsOptions
from ..utils.debug import logger
from ..utils.exceptions import KSFDException
from .solver import (
    ChunkLadder,
    _pc_pallas_fallback,
    build_chunk_tiers,
    chunk_cfl_safety,
    make_cfl_maxh,
    make_multistep_fn,
    make_step_fn,
    next_noise_time,
    noise_active,
    run_attempts,
    step_kernels,
)
from .steppers import get_tableau

logENS = logger("ENSEMBLE")

__all__ = ["EnsembleSolver", "shard_members", "noise_active"]


def shard_members(U, devices=None):
    """The members ``U`` placed for one EnsembleSolver.  Counterpart:
    ksfd_tpu/solvers/ensemble.py:shard_members, whose member axis
    divides over a process's local devices.  The port runs one rank per
    card and puts members on ranks instead (ksfdsolver.py run_ensemble:
    contiguous member slabs, one per process), so a process holds its
    members on one device: ``U`` on ``devices[0]`` (its own device when
    None), and ValueError for more than one device."""
    devices = list(devices) if devices is not None else []
    if len(devices) > 1:
        raise ValueError(
            "shard_members: %d devices given; the port puts members on "
            "ranks, one device each (--ensemble over KSFD_NUM_PROCS "
            "processes, ksfdsolver.py run_ensemble), not on several "
            "devices of one process" % len(devices))
    U = torch.as_tensor(U)
    return U.to(torch.device(devices[0])) if devices else U


def _member_seed(seed, index):
    """The 63-bit seed of member ``index``'s noise generator, mixed from
    the run's seed and the member's global index (so a member slab of a
    larger ensemble draws what the whole run would)."""
    words = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


class EnsembleSolver:
    """Vector adaptive controller over a vmapped implicit step."""

    default_hmin = 1e-20

    def __init__(
        self,
        ops,
        numerics=None,
        t0=0.0,
        dt=0.001,
        tmax=20.0,
        maxsteps=100,
        rtol=1e-5,
        atol=1e-5,
        hmin=None,
        rng_key=None,
        block_steps=1,
        member_offset=0,
        kernels=None,
        mesh=None,
    ):
        """As the reference's constructor.  ``rng_key`` is the noise
        seed, an integer (None: 0), where the reference takes a
        ``jax.random.PRNGKey``.  block_steps > 1 (fixed-dt runs only):
        that many steps per member in one vmapped multistep call
        between monitor calls.  member_offset: global index of this
        solver's first member, which seeds its noise generators.
        kernels: a ``make_fused_kernels(ops)`` namespace to share (its
        launch counters then count the ensemble's launches; unused
        where the step is unfused).  mesh: a parallel/mesh.py SlabMesh;
        each member is then split over its ranks and the steps are
        unfused (module docstring)."""
        self.ops = ops
        self.ps = ops.ps
        self.numerics = numerics or NumericsOptions()
        self.mesh = mesh
        if mesh is not None:
            check_mesh(ops, mesh)
            # the reference's "xla" flavour on a sharded state
            self.numerics = dataclasses.replace(self.numerics,
                                                use_pallas=False)
        self.t0 = float(t0)
        self.dt0 = float(dt)
        self.tmax = float(tmax)
        self.maxsteps = int(maxsteps)
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.hmin = float(hmin) if hmin else self.default_hmin
        self.seed = 0 if rng_key is None else int(rng_key)
        self.monitors = []
        n = self.numerics
        if n.ksp_type in ("banded", "lu"):
            raise KSFDException(
                "ksp_type=%s is a host-side direct solve (scalar "
                "Solver only); ensembles need a device stage solver"
                % n.ksp_type
            )
        self.tableau = get_tableau(n.ts_type)
        self.block_steps = int(block_steps)
        self.member_offset = int(member_offset)
        self.kernels = kernels
        # built lazily by solve() (or _build_steps)
        self._vstep = None
        self._vmulti = None
        self._chunk = None
        self._fallback = None
        self.fused_pc = None
        self._vgroom = vmap(ops.groom)
        self._vrefresh = (vmap(ops.refresh_G) if hasattr(ops, "refresh_G")
                          else None)
        self._vmax_fn = vmap(
            lambda u, t: torch.stack(
                [torch.max(torch.abs(v))
                 for v in ops.velocity(u, t, mesh=mesh)]
            )
        )
        # per-member state, filled by solve()
        self.u = None
        self.ts = self.hs = self.ks = None
        self.diverged = None
        self.snes_failures = None

    def _groom(self, U, ts):
        """Groom every member, then (with-G states) refresh its G slot
        at its own t; both are idempotent on members groomed before."""
        U = self._vgroom(U)
        if self._vrefresh is not None:
            U = self._vrefresh(U, self._dev(ts))
        return U

    # -- monitors ---------------------------------------------------
    def add_monitor(self, monitor):
        """monitor(es, ks, ts, U) with per-member vectors, called after
        every outer iteration that accepted at least one member."""
        self.monitors.append(monitor)

    def monitor(self, ks, ts, U):
        for m in self.monitors:
            m(self, ks, ts, U)

    # -- vector h controller (elementwise Solver._new_h_*) ----------
    def _h_accept_vec(self, h, enorm):
        n = self.numerics
        expo = -1.0 / (self.tableau.order + 1)
        with np.errstate(divide="ignore", over="ignore",
                         invalid="ignore"):
            hfac = np.where(
                enorm <= 0.0,
                n.clip_high,
                n.safety * np.maximum(enorm, 1e-300) ** expo,
            )
        hfac = np.clip(hfac, n.clip_low, n.clip_high)
        return np.clip(h * hfac, n.dt_min, n.dt_max)

    def _h_reject_vec(self, h, enorm, finite):
        n = self.numerics
        expo = -1.0 / (self.tableau.order + 1)
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            hfac = np.where(
                finite,
                np.clip(
                    n.safety
                    * np.where(finite, np.maximum(enorm, 1e-300), 1.0)
                    ** expo,
                    n.clip_low,
                    0.9,
                ),
                n.rollback_factor,
            )
        return np.maximum(h * hfac, n.dt_min)

    # -- steps ------------------------------------------------------
    def _build_steps(self):
        """Build the vmapped step (and, for fixed-dt blocks, the
        vmapped multistep; for the device loop, the vmapped tier steps)
        on one shared kernel build (none where the step is unfused) and,
        with ``pc_pallas``, one shared fused pc (``self.fused_pc``, whose
        launch counters then count the ensemble's pc launches)."""
        nm = self.numerics
        mesh = self.mesh
        kern = step_kernels(self.ops, nm, mesh, kernels=self.kernels)
        self.kernels = kern
        self.fused_pc = (make_fused_block_pc(self.ops.grid, self.ops)
                         if nm.pc_pallas and _pc_pallas_fallback(
                             nm, self.ops, mesh) is None else None)
        kw = dict(atol=self.atol, rtol=self.rtol, kernels=kern,
                  fused_pc=self.fused_pc, mesh=mesh)
        step, _ = make_step_fn(self.ops, nm, **kw)
        self.build_info = step.build_info
        self._vstep = vmap(step)
        self._vmulti = None
        if self.block_steps > 1 and nm.adapt_type == "none":
            multi, _ = make_multistep_fn(self.ops, nm, **kw)

            def vmulti(U, ts, hs, nblk):
                return vmap(lambda u, t, h: multi(u, t, h, nblk))(U, ts, hs)

            self._vmulti = vmulti
        self._chunk = None
        if (nm.device_loop and nm.adapt_type != "none"
                and nm.ksp_type != "banded"
                and "CFL_safety_factor" not in self.ps.tdfuncs):
            self._chunk = self._build_chunk(kw)
        self._fallback = None

    def _build_chunk(self, kw):
        """The device loop's pieces (ensemble.py:325-346 builds the
        vmapped chunk): the vmapped tier steps of solvers/solver.py
        build_chunk_tiers (chain steps where every tier chains f0); the
        vmapped fresh RHS that starts the chain; the vmapped CFL bound
        for a constant ``CFL_safety_factor``.  ``last`` holds the last
        dispatch's record (tier-step calls per tier, the occupied tiers
        of each attempt, attempts and accepts per member), ``totals``
        the run's sums (``reads``: attempts, one host read each;
        ``occupied``: tier-step calls)."""
        ops, mesh = self.ops, self.mesh
        tb = build_chunk_tiers(ops, self.numerics, **kw)
        cfl = make_cfl_maxh(ops, chunk_cfl_safety(self.ps), mesh)
        return SimpleNamespace(
            tiers=tb.tiers, chain=tb.chain,
            steps=[vmap(step) for step in tb.steps],
            rhs0=vmap(lambda u, t: ops.rhs(ops.groom(u), t, mesh=mesh)),
            cfl=None if cfl is None else vmap(cfl),
            expo=tb.expo, max_attempts=128, max_rejects=24,
            last=None, totals=SimpleNamespace(
                dispatches=0, calls=[0] * len(tb.tiers), occupied=0,
                attempts=0, reads=0))

    def _get_fallback(self):
        """The robust retry step ``fb(u, t, h) -> (u1, enorm)`` of ONE
        member (ensemble.py:350-368): GMRES stage solves in the state's
        precision (f64 by default) on the dataclasses.replace of the
        numerics the reference builds.  None unless the fast solver is
        Richardson."""
        if self.numerics.ksp_type not in ("richardson",):
            return None
        if self._fallback is None:
            nm = dataclasses.replace(
                self.numerics, ksp_type="gmres_scipy",
                ksp_restart=12, ksp_max_it=4, stage_delta=False,
                snes_iters=max(4, self.numerics.snes_iters),
            )
            self._fallback, _ = make_step_fn(
                self.ops, nm, atol=self.atol, rtol=self.rtol,
                kernels=self.kernels, fused_pc=self.fused_pc,
                mesh=self.mesh,
            )
        return self._fallback

    # -- per-member physics helpers ---------------------------------
    def _dev(self, x, dtype=torch.float64):
        """A host value or vector as a tensor on the members' device."""
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.ops.device)

    def _sum(self, x, dim=None):
        """torch.sum, over the mesh's ranks on a mesh."""
        total = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
        return total if self.mesh is None else all_reduce_sum(total,
                                                              self.mesh)

    def _select(self, mask, a, b):
        """Per member: a where mask, else b (mask a numpy bool vector)."""
        sel = self._dev(mask, torch.bool).reshape(
            (len(mask),) + (1,) * (a.dim() - 1))
        return torch.where(sel, a, b)

    def _cfl_maxh(self, U, ts):
        """Per-member max stable h (Solver.CFL_step vectorized; on a
        mesh the maxima over the ranks)."""
        vmaxs = self._vmax_fn(U, self._dev(ts))
        if self.mesh is not None:
            vmaxs = all_reduce_max(vmaxs, self.mesh)
        vmaxs = vmaxs.cpu().numpy()
        sw = self.ops.grid.stencil_width
        sp = np.asarray(self.ops.grid.spacing, dtype=float)
        with np.errstate(divide="ignore"):
            hmaxs = np.where(vmaxs == 0.0, np.inf, sw * sp / vmaxs)
        return hmaxs.min(axis=1)

    def _cfl_clamp(self, U, ts, hs, active):
        if "CFL_safety_factor" in self.ps.tdfuncs:
            fn = self.ps.funcs["CFL_safety_factor"]
            sf = np.asarray([float(fn(float(t))) for t in ts])
        else:
            s0 = float(
                self.ps.values0.get("CFL_safety_factor", 0.0) or 0.0
            )
            if s0 <= 0.0:
                return hs
            sf = np.full(len(ts), s0)
        if not (sf > 0.0).any():
            return hs
        maxh = np.where(sf > 0.0, sf * self._cfl_maxh(U, ts), np.inf)
        return np.where(active, np.minimum(hs, maxh), hs)

    def _inject_noise(self, U, ts, lastvart, accepted, conserve, Nw0):
        """Per-member geometric-Brownian injection (Solver.add_variance
        with a generator per member; only injected members draw)."""
        inject = np.zeros(len(ts), dtype=bool)
        sds = np.zeros(len(ts))
        vr_fn = self.ps.funcs["variance_rate"]
        vtf_fn = self.ps.funcs["variance_timing_function"]
        for i in np.nonzero(accepted)[0]:
            t, lv = float(ts[i]), float(lastvart[i])
            vrate = float(vr_fn(t) or 0.0)
            if vrate <= 0.0:
                continue
            if float(vtf_fn(t)) - float(vtf_fn(lv)) < 1.0:
                continue
            inject[i] = True
            sds[i] = np.sqrt(vrate * (t - lv))
        if not inject.any():
            return U, lastvart
        U = U.clone()
        mesh = self.mesh
        shape = U.shape[2:] if mesh is None else self.ops.grid.Sshape
        for i in np.nonzero(inject)[0]:
            # on a mesh the draw at the global shape, this rank's block
            stn = torch.randn(shape, generator=self._gens[i],
                              dtype=U.dtype, device=U.device)
            if mesh is not None:
                stn = mesh.local(stn)
            rho = U[i, 0] * torch.exp(sds[i] * stn)
            if conserve:
                rho = rho * (float(Nw0[i]) / self._sum(rho))
            U[i, 0] = rho
        lastvart = np.where(inject, ts, lastvart)
        return U, lastvart

    # -- the device loop ---------------------------------------------
    def _run_chunk(self, U, ts, hs, tmax_eff, max_acc):
        """One dispatch of the adaptive chunk for every member: the
        reference's vmapped ``chunk(u, t, h, tmax, max_accepts)``
        (solver.py:1039-1212) as solvers/solver.py run_attempts over a
        ChunkLadder per member.  Each attempt runs one vmapped step per
        occupied tier on that tier's members, gathered with
        ``index_select`` and scattered back with ``index_copy``, and one
        host read brings every enorm (and CFL bound).  Returns per
        member (U, t, h, accepts, attempts, rejected)."""
        c = self._chunk
        N = len(ts)
        dev = U.device
        ladders = [ChunkLadder(self.numerics, len(c.tiers), c.expo, hs[i],
                               c.max_rejects) for i in range(N)]
        cur = SimpleNamespace(U=U, f0=None)
        if c.chain and (max_acc > 0).any():
            # one fresh float64 RHS per dispatch starts each member's
            # chain (the reference's f0 at chunk entry)
            run = torch.as_tensor(np.nonzero(max_acc > 0)[0], device=dev)
            cur.f0 = torch.zeros_like(U).index_copy(
                0, run, c.rhs0(U.index_select(0, run),
                               self._dev(ts[max_acc > 0])))

        def attempt(tier, idx, t, h):
            sel = torch.as_tensor(idx, device=dev)
            tv, hv = self._dev(t), self._dev(h)
            Ug = cur.U.index_select(0, sel)
            if c.chain:
                u1, enorm, f1 = c.steps[tier](Ug, tv, hv,
                                              cur.f0.index_select(0, sel))
            else:
                (u1, enorm), f1 = c.steps[tier](Ug, tv, hv), None
            e = enorm.to(torch.float64)
            if c.cfl is not None:
                cfl = c.cfl(self._vgroom(u1), tv + hv)
                e = torch.stack([e, cfl.to(torch.float64)])

            def commit(acc):
                loc = torch.as_tensor(acc, device=dev)
                glob = sel.index_select(0, loc)
                cur.U = cur.U.index_copy(
                    0, glob, u1.index_select(0, loc).to(U.dtype))
                if f1 is not None:
                    cur.f0 = cur.f0.index_copy(0, glob,
                                               f1.index_select(0, loc))
            return e, commit

        run = run_attempts(ladders, ts, tmax_eff, max_acc, c.max_attempts,
                           attempt)
        calls = [sum(tier in occ for occ in run.occupied)
                 for tier in range(len(c.tiers))]
        k, attempts = np.array(run.k), np.array(run.attempts)
        c.last = SimpleNamespace(calls=calls, occupied=run.occupied,
                                 attempts=attempts, accepts=k)
        tot = c.totals
        tot.dispatches += 1
        tot.calls = [a + b for a, b in zip(tot.calls, calls)]
        tot.occupied += sum(len(occ) for occ in run.occupied)
        tot.attempts += int(attempts.sum())
        tot.reads += len(run.occupied)
        return (cur.U, np.array(run.t), np.array([lad.h for lad in ladders]),
                k, attempts, np.array([lad.rejected for lad in ladders]))

    def _post_accept(self, U, ts, hs, lastvart, mask, conserve, Nw0):
        """The post-accept sequence (noise, groom, refresh_G, CFL clamp)
        on the members in ``mask`` (ensemble.py:452-467); grooming the
        others again is a no-op."""
        if noise_active(self.ps):
            U, lastvart = self._inject_noise(U, ts, lastvart, mask,
                                             conserve, Nw0)
        U = self._groom(U, ts)
        hs = self._cfl_clamp(U, ts, hs, mask)
        return U, hs, lastvart

    def _chunk_iteration(self, U, ts, hs, ks, snes, consec, diverged,
                         lastvart, active, conserve, Nw0):
        """One device-loop outer iteration (ensemble.py:473-629): every
        active member not parked on the fallback runs the chunk, bounded
        at its next noise time (one accept per dispatch past it) and by
        its remaining accepts; the chunk's rejections count as failures;
        a stuck or parked member takes the robust fallback step."""
        n = self.numerics
        N = len(ts)
        fbm = active & self._fbm
        chunk_active = active & ~self._fbm
        kacc = np.zeros(N, dtype=int)
        rej = np.zeros(N, dtype=bool)
        if chunk_active.any():
            tmax_eff = np.full(N, self.tmax)
            if noise_active(self.ps):
                for i in np.nonzero(chunk_active)[0]:
                    tn = next_noise_time(self.ps, float(lastvart[i]),
                                         self.tmax)
                    if tn is not None and tn < tmax_eff[i]:
                        tmax_eff[i] = tn
            max_acc = np.where(chunk_active, self.maxsteps - ks, 0)
            straddled = chunk_active & (tmax_eff < ts)
            tmax_eff = np.where(straddled, self.tmax, tmax_eff)
            max_acc = np.where(straddled, np.minimum(max_acc, 1), max_acc)
            U, t1, h1, kacc, attempts, rej = self._run_chunk(
                U, ts, hs, tmax_eff, max_acc)
            logENS("chunk accepted/attempts", kacc, attempts)
            snes = snes + np.where(active, np.maximum(0, attempts - kacc), 0)
            ts = np.where(active, t1, ts)
            hs = np.where(active, h1, hs)
            ks = ks + np.where(active, kacc, 0)
        anyacc = active & (kacc > 0)
        consec = np.where(anyacc, 0, consec)
        if anyacc.any():
            U, hs, lastvart = self._post_accept(U, ts, hs, lastvart, anyacc,
                                                conserve, Nw0)
        stuck = chunk_active & rej
        # a zero-accept stuck exit doubles the next fallback probe
        self._rejstreak = np.where(
            stuck & (kacc == 0), self._rejstreak + 1,
            np.where(chunk_active, 0, self._rejstreak))
        need_fb = stuck | fbm
        if need_fb.any():
            fb = self._get_fallback()
            ebn = np.full(N, np.nan)
            rescued = np.zeros(N, dtype=bool)
            if fb is not None:
                if stuck.any():
                    logENS("chunk stuck members", np.nonzero(stuck)[0])
                    self._fbprobe = np.where(
                        stuck, np.minimum(64, 1 << np.minimum(
                            self._rejstreak, 6)), self._fbprobe)
                    self._fbacc = np.where(stuck, 0, self._fbacc)
                    self._fbm = self._fbm | stuck
                u1b = {}
                for i in np.nonzero(need_fb)[0]:
                    ub, eb = fb(U[i], self._dev(ts[i]), self._dev(hs[i]))
                    u1b[i], ebn[i] = ub, float(eb)
                rescued = need_fb & np.isfinite(ebn) & (ebn <= 1.0)
                if rescued.any():
                    logENS("fallback accepted members",
                           np.nonzero(rescued)[0])
                    U = U.clone()
                    for i in np.nonzero(rescued)[0]:
                        U[i] = u1b[i].to(U.dtype)
                    ts = np.where(rescued, ts + hs, ts)
                    ks = ks + rescued
                    anyacc = anyacc | rescued
                    consec = np.where(rescued, 0, consec)
                    hs = np.where(rescued, self._h_accept_vec(hs, ebn), hs)
                    self.rescues += rescued & stuck
                    U, hs, lastvart = self._post_accept(
                        U, ts, hs, lastvart, rescued, conserve, Nw0)
                    # hysteresis: leave the fallback after fb_probe
                    # accepts (the rescue counts as the first)
                    self._fbacc = np.where(rescued, self._fbacc + 1,
                                           self._fbacc)
                    leave = rescued & (
                        self._fbacc % np.maximum(self._fbprobe, 1) == 0)
                    self._fbm = self._fbm & ~leave
            failed = need_fb & ~rescued
            snes = snes + failed
            consec = np.where(failed, consec + 1, consec)
            hs = np.where(failed,
                          self._h_reject_vec(hs, ebn, np.isfinite(ebn)), hs)
            # a one-shot probe whose retry failed hands the shrunk h back
            # to the chunk
            self._fbm = self._fbm & ~(failed & (self._fbprobe <= 1))
            diverged = diverged | (consec > n.max_snes_failures)
        if anyacc.any():
            self.u = U
            self.ks, self.ts, self.hs = ks, ts, hs
            self.monitor(ks, ts, U)
        return U, ts, hs, ks, snes, consec, diverged, lastvart

    # -- the loop ----------------------------------------------------
    def solve(self, U0):
        """Integrate every member to tmax/maxsteps.  Returns a
        SimpleNamespace with per-member u, t, h, k, diverged,
        snes_failures (and leaves the same on self).  U0: an array or
        tensor (n_members, dof, *Sshape); the members run on the
        device of ``ops`` (the card unless the problem was built
        elsewhere)."""
        n = self.numerics
        adapt = n.adapt_type != "none"
        U = torch.as_tensor(U0, device=self.ops.device)
        N = U.shape[0]
        if self._vstep is None:
            self._build_steps()
        ts = np.full(N, self.t0)
        U = self._groom(U, ts)
        hs = np.full(N, min(max(self.dt0, n.dt_min), n.dt_max))
        ks = np.zeros(N, dtype=int)
        diverged = np.zeros(N, dtype=bool)
        consec = np.zeros(N, dtype=int)
        snes = np.zeros(N, dtype=int)
        # per-member fallback hysteresis (the scalar controller's
        # _fb_mode/_fb_accepts/_fb_probe)
        self._fbm = np.zeros(N, dtype=bool)
        self._fbacc = np.zeros(N, dtype=int)
        self._fbprobe = np.full(N, 64, dtype=int)
        self._rejstreak = np.zeros(N, dtype=int)
        # per member: fast-path failures the fallback rescued
        self.rescues = np.zeros(N, dtype=int)
        self.iterations = 0
        self._gens = [
            torch.Generator(device=U.device).manual_seed(
                _member_seed(self.seed, self.member_offset + i))
            for i in range(N)
        ]
        lastvart = np.full(N, self.t0)
        conserve = self.ps.params0["conserve_worms"]
        conserve = False if conserve == "False" else bool(conserve)
        Nw0 = self._sum(U[:, 0].reshape(N, -1), dim=1).cpu().numpy()
        hs = self._cfl_clamp(U, ts, hs, np.ones(N, dtype=bool))
        self.u = U
        self.ks, self.ts, self.hs = ks, ts, hs
        self.monitor(ks, ts, U)
        while True:
            active = (
                ~diverged
                & (ks < self.maxsteps)
                & (ts <= self.tmax)
                & (hs >= self.hmin)
            )
            if not active.any():
                break
            self.iterations += 1
            if self._chunk is not None:
                U, ts, hs, ks, snes, consec, diverged, lastvart = (
                    self._chunk_iteration(U, ts, hs, ks, snes, consec,
                                          diverged, lastvart, active,
                                          conserve, Nw0))
                continue
            nblk = 1
            if self._vmulti is not None:
                nblk = max(1, min(self.block_steps,
                                  self.maxsteps - int(ks[active].max())))
            if nblk > 1:
                # fused fixed-dt blocks (noise/CFL/monitors act at
                # block boundaries, like the scalar block mode)
                u1, _, enorm = self._vmulti(U, self._dev(ts), self._dev(hs),
                                            nblk)
            else:
                u1, enorm = self._vstep(U, self._dev(ts), self._dev(hs))
            e = enorm.to(torch.float64).cpu().numpy()
            finite = np.isfinite(e)
            rejected = active & ((~finite) | (adapt & (e > 1.0)))
            fbm = active & self._fbm
            need = (rejected & ~self._fbm) | fbm
            fb = self._get_fallback() if nblk == 1 and need.any() else None
            if fb is not None:
                ebn = np.full(N, np.nan)
                u1b = {}
                for i in np.nonzero(need)[0]:
                    ub, eb = fb(U[i], self._dev(ts[i]), self._dev(hs[i]))
                    u1b[i], ebn[i] = ub, float(eb)
                # members IN fallback mode take the robust result as
                # THE step; rejected fast-path members get the same-h
                # robust retry and ENGAGE fallback mode
                rescued = (
                    rejected
                    & ~self._fbm
                    & np.isfinite(ebn)
                    & ((ebn <= 1.0) | (not adapt))
                )
                if rescued.any():
                    logENS("fallback rescued members",
                           np.nonzero(rescued)[0])
                    self._fbm = self._fbm | rescued
                    self._fbacc = np.where(rescued, 0, self._fbacc)
                    self._fbprobe = np.where(rescued, 64, self._fbprobe)
                    self.rescues += rescued
                take_fb = fbm | rescued
                if take_fb.any():
                    u1 = u1.clone()
                    for i in np.nonzero(take_fb)[0]:
                        u1[i] = u1b[i]
                e = np.where(take_fb, ebn, e)
                finite = np.isfinite(e)
                rejected = active & ((~finite) | (adapt & (e > 1.0)))
            accepted = active & ~rejected
            # hysteresis: after fb_probe accepts on the robust solver,
            # probe the fast path again
            fb_acc = accepted & self._fbm
            self._fbacc = np.where(fb_acc, self._fbacc + 1, self._fbacc)
            leave = fb_acc & (
                self._fbacc % np.maximum(self._fbprobe, 1) == 0
            )
            self._fbm = self._fbm & ~leave
            snes += rejected
            consec = np.where(rejected, consec + 1, 0)
            diverged |= consec > n.max_snes_failures
            # commit accepted members (a diverged member's NaN state
            # never reaches U)
            if accepted.any():
                U = self._select(accepted, u1.to(U.dtype), U)
                ts = np.where(accepted, ts + nblk * hs, ts)
                ks = ks + nblk * accepted
            if adapt:
                hs = np.where(
                    accepted,
                    self._h_accept_vec(hs, e),
                    np.where(rejected, self._h_reject_vec(hs, e, finite),
                             hs),
                )
            else:
                hs = np.where(rejected, self._h_reject_vec(hs, e, finite),
                              hs)
                # fixed-dt semantics: restore the nominal dt on accept
                hs = np.where(accepted,
                              min(max(self.dt0, n.dt_min), n.dt_max), hs)
            if accepted.any():
                U, hs, lastvart = self._post_accept(
                    U, ts, hs, lastvart, accepted, conserve, Nw0)
                self.u = U
                self.ks, self.ts, self.hs = ks, ts, hs
                self.monitor(ks, ts, U)
        self.u = U
        self.ts, self.hs, self.ks = ts, hs, ks
        self.diverged = diverged
        self.snes_failures = snes
        return SimpleNamespace(
            u=U, t=ts, h=hs, k=ks, diverged=diverged,
            snes_failures=snes,
        )
