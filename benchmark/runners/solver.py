"""The host Solver with the device loop (``solvers/solver.py:Solver``),
from the cell's start (``bench_cells.cell_start``) run to ``wl["ramp_accepts"]``
accepted steps in set-up; each episode restarts it from there (its t
and h) and runs to t + ``wl["span"]``."""

from bench_cells import cell_start
from runners.base import Adaptive

__all__ = ["Runner"]


class Runner(Adaptive):
    def setup(self):
        from ksfd_tpu_torch.solvers import Solver

        t0 = self.build()
        u0 = cell_start(self.cfg, self.wl, self.n, self.seed,
                        self.device)[0]
        t0 = self.lap("start state", t0)
        self.solver = Solver(
            self.ops, self.numerics, t0=float(self.p.get("t0", 0.0)),
            dt=float(self.p["dt"]), tmax=1e30,
            maxsteps=int(self.wl["ramp_accepts"]), rtol=self.rtol,
            atol=self.atol)
        chunk = self.solver._chunk
        self.tiers = list(chunk.tiers)
        self.rec.wrap_list(chunk.steps)
        self.episode_ends = {}
        # one call of the ramp, drawn from the seed, checked with the rest
        self.rec.want.add(("ramp", int(self.rng.integers(
            0, int(self.wl["ramp_accepts"])))))
        t0 = self.lap("steps built", t0)
        self.rec.new_episode("ramp")
        self.u_start = self.solver.solve(u0)
        self.lap("ramp", t0)
        st = self.solver.stats
        self.episode_ends["ramp"] = (
            float(self.p.get("t0", 0.0)), 1e30, [self.solver.t],
            st.host_retries == 0 and st.fallback_steps == 0)
        self.t_start, self.h_start = float(self.solver.t), float(self.solver.h)
        self.timings.update(ramp_t=self.t_start, ramp_h=self.h_start)
        self.warm_up()

    def episode(self, key):
        s = self.solver
        self.rec.new_episode(key)
        s.dt0 = self.h_start
        s.maxsteps = 10 ** 9
        s.tmax = self.t_start + float(self.wl["span"])
        s.solve(self.u_start, t=self.t_start)
        st = s.stats
        clean = st.host_retries == 0 and st.fallback_steps == 0
        self.episode_ends[key] = (self.t_start, s.tmax, [s.t], clean)
        return dict(attempts=st.chunk_attempts, accepts=st.chunk_accepts,
                    calls=st.chunk_attempts, sim_time=s.t - self.t_start,
                    host_retries=st.host_retries)
