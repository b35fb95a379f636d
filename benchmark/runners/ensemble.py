"""``EnsembleSolver`` with the device loop (``solvers/ensemble.py``):
``wl["members"]`` members, member i from the noise of seed
``noise_seed * members + i`` under the symmetry the run's seed picks
(``bench_cells.cell_start``); each episode integrates all of them from
t0 with the configuration's first step to t0 + ``wl["span"]``."""

import numpy as np
import torch

from bench_cells import cell_start
from runners.base import Adaptive

__all__ = ["Runner"]


class Runner(Adaptive):
    def setup(self):
        from ksfd_tpu_torch.solvers import EnsembleSolver

        t0 = self.build()
        self.members = int(self.wl["members"])
        self.U0 = cell_start(self.cfg, self.wl, self.n, self.seed,
                             self.device)
        t0 = self.lap("start state", t0)
        self.t0 = float(self.p.get("t0", 0.0))
        self.es = EnsembleSolver(
            self.ops, self.numerics, t0=self.t0, dt=float(self.p["dt"]),
            tmax=self.t0 + float(self.wl["span"]), maxsteps=10 ** 9,
            rtol=self.rtol, atol=self.atol, rng_key=self.seed)
        self.es._build_steps()
        self.lap("steps built", t0)
        chunk = self.es._chunk
        self.tiers = list(chunk.tiers)
        self.rec.wrap_list(chunk.steps)
        self.episode_ends = {}
        self.warm_up()

    def episode(self, key):
        es = self.es
        tot = es._chunk.totals
        before = (tot.attempts, tot.reads)
        self.rec.new_episode(key)
        out = es.solve(self.U0)
        clean = not (np.any(es.rescues) or np.any(es._fbm))
        self.episode_ends[key] = (self.t0, es.tmax, list(out.t), clean)
        return dict(attempts=tot.attempts - before[0],
                    calls=tot.reads - before[1],
                    accepts=int(np.sum(out.k)),
                    sim_time=float(np.sum(out.t - self.t0)),
                    host_retries=int(np.sum(es.rescues)))

    def window(self, seconds):
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        tot = super().window(seconds)
        if self.device.type == "cuda":
            tot["peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        return tot
