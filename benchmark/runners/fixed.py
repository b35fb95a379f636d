"""The fixed-dt chained multistep (``solvers/solver.py:
make_multistep_fn``) at h = ``wl["h"]`` from the cell's start
(``bench_cells.cell_start``): each call advances ``wl["steps_per_call"]`` steps, chained on
the last call's state, and reads its largest error norm."""

import dataclasses
import time

import torch

from bench_cells import cell_start
from bench_record import plant
from runners.base import Base

__all__ = ["Runner"]


class Runner(Base):
    def setup(self):
        from ksfd_tpu_torch.solvers import make_multistep_fn

        t0 = self.build()
        nm = dataclasses.replace(self.numerics, adapt_type="none")
        self.multi, _ = make_multistep_fn(self.ops, nm, atol=self.atol,
                                          rtol=self.rtol)
        t0 = self.lap("steps built", t0)
        self.kind, self.iters = nm.ksp_type, int(nm.ksp_iters)
        self.nsteps = int(self.wl["steps_per_call"])
        dev = self.device
        self.u = cell_start(self.cfg, self.wl, self.n, self.seed, dev)[0]
        self.t = torch.zeros((), dtype=torch.float64, device=dev)
        self.h = torch.full((), float(self.wl["h"]), dtype=torch.float64,
                            device=dev)
        self.calls = 0
        self.captured = []
        t0 = self.lap("start state", t0)
        self.call()
        self.lap("warm call", t0)
        self.call_s = self.timings["warm call"]

    def call(self, keep=False):
        """One chained call; ``keep`` copies its input and output."""
        u_in = self.u.clone() if keep else None
        u, t, emax = self.multi(self.u, self.t, self.h, self.nsteps)
        if self.fault is not None:
            args = (self.u, self.t, self.h)
            u = plant(self.fault, args, (u, emax))[0]
        e = self._last_e = float(emax)
        if keep:
            self.captured.append(dict(key=self.calls, u=u_in,
                                      u1=u.clone(), e=e))
        self.u, self.t = u, t
        self.calls += 1
        return e

    def window(self, seconds):
        """Calls until ``seconds`` have passed; the call drawn from the
        seed among those the warm call's time predicts, and the last one,
        are copied for the check."""
        expected = max(1, int(0.8 * seconds / max(self.call_s, 1e-3)))
        pick = int(self.rng.integers(0, expected))
        self.sync()
        t0 = time.perf_counter()
        k = 0
        last = None
        self.laps = []
        while True:
            keep = k == pick
            if not keep:
                last = (self.u.clone(), self.calls)
            t_call = time.perf_counter()
            self.call(keep=keep)
            self.laps.append(time.perf_counter() - t_call)
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        wall = time.perf_counter() - t0
        if k - 1 != pick and last is not None:
            u_in, key = last
            self.captured.append(dict(key=key, u=u_in, u1=self.u.clone(),
                                      e=self._last_e))
        self.counters = dict(wall_s=wall, calls=k, steps=k * self.nsteps,
                             dof=int(self.u.numel()))
        return self.counters

    def stretch(self, tracer):
        """``wl["trace_calls"]`` calls under the profiler."""
        calls = int(self.wl.get("trace_calls", 2))
        tracer.start()
        try:
            for _ in range(calls):
                self.call()
        finally:
            tracer.stop()
        return dict(steps=calls * self.nsteps, attempts=None)

    def samples(self):
        return [dict(key=c["key"], kind=self.kind, iters=self.iters,
                     u=c["u"].unsqueeze(0), u1=c["u1"].unsqueeze(0),
                     t=torch.zeros(1, dtype=torch.float64,
                                   device=self.device),
                     h=self.h.reshape(1),
                     e=torch.tensor([c["e"]], dtype=torch.float64),
                     steps=self.nsteps, kept=True)
                for c in self.captured]

    def decisions(self):
        return 0, 0
