"""What every runner kind shares: the cell's problem, the clock, the
episode loop of the adaptive kinds and the sample of calls to check.

A runner kind is ``runners/<kind>.py`` with a class ``Runner``.  The
harness calls ``setup()``, ``window(seconds)``, ``stretch(tracer)``
(with ``--trace 1``), then ``samples()``, ``decisions()`` and
``release()``.
"""

import math
import time

import numpy as np
import torch

from bench_cells import build_program
from bench_record import Recorder, replay_decisions
from reference.ks import eval_params

__all__ = ["Base", "Adaptive", "sync"]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Base:
    """One cell's program at its size on ``device``.  ``n`` overrides the
    configuration's grid (tests only), ``fault`` plants a fault in the
    program's results (tests only)."""

    def __init__(self, wl, cfg, seed, device, n=None, fault=None):
        self.wl, self.cfg = wl, cfg
        self.seed = int(seed)
        self.device = torch.device(device)
        self.n = int(cfg["nelements"] if n is None else n)
        self.rng = np.random.default_rng(self.seed)
        self.rec = Recorder(fault)
        self.fault = fault
        self.p = eval_params(cfg["params"])
        self.atol, self.rtol = float(self.p["atol"]), float(self.p["rtol"])
        self.counters = {}
        self.timings = {}

    def lap(self, what, since):
        """Record the seconds of a set-up stage and restart the clock."""
        self.sync()
        now = time.perf_counter()
        self.timings[what] = round(now - since, 3)
        return now

    def build(self):
        t0 = time.perf_counter()
        self.ps, self.grid, self.ops, self.numerics = build_program(
            self.cfg, self.n, self.seed, self.device)
        return self.lap("problem", t0)

    def sync(self):
        sync(self.device)

    def release(self):
        """Free the program's state before the reference runs."""
        for name in ("solver", "es", "multi", "ops", "u", "U0", "u_start"):
            if hasattr(self, name):
                setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Adaptive(Base):
    """A kind that runs whole episodes: each restarts from the start
    state made in set-up and runs to its start time plus ``span``."""

    members = 1

    def episode(self, key):
        """Run one episode; returns its counters."""
        raise NotImplementedError

    def pick_samples(self, warm, expected):
        """The calls to copy in the window: in one episode drawn from the
        seed among the first ``min(3, expected)``, the accepted call
        with the largest h of the warm episode and ``wl["samples"]``
        more drawn from the seed."""
        calls = self.rec.calls(warm)
        accepted = [(max(hs), k) for k, (_, _, hs, es) in enumerate(calls)
                    if all(math.isfinite(e) and e <= 1.0 for e in es)]
        picks = {max(accepted)[1]} if accepted else set()
        extra = int(self.wl.get("samples", 2))
        pool = [k for k in range(len(calls)) if k not in picks]
        if pool:
            picks |= set(int(k) for k in self.rng.choice(
                pool, size=min(extra, len(pool)), replace=False))
        ep = int(self.rng.integers(0, max(1, min(3, expected))))
        self.sample_episode = ep
        self.rec.want |= {(ep, k) for k in picks}

    def warm_up(self):
        t0 = time.perf_counter()
        warm = self.episode("warm")
        self.lap("warm episode", t0)
        self.warm_s = self.timings["warm episode"]
        self.warm = warm
        return warm

    def window(self, seconds):
        """Whole episodes until ``seconds`` have passed; the last one is
        finished."""
        expected = max(1, int(seconds / max(self.warm_s, 1e-3)))
        self.pick_samples("warm", expected)
        tot = {}
        self.sync()
        t0 = time.perf_counter()
        k = 0
        self.laps = []
        while True:
            t_ep = time.perf_counter()
            c = self.episode(k)
            self.laps.append(time.perf_counter() - t_ep)
            for key, val in c.items():
                tot[key] = tot.get(key, 0) + val
            k += 1
            self.sync()
            if time.perf_counter() - t0 >= seconds:
                break
        tot["wall_s"] = time.perf_counter() - t0
        tot["episodes"] = k
        self.counters = tot
        return tot

    def stretch(self, tracer):
        """One more episode with ``wl["trace_attempts"]`` of its calls,
        from the second on, under the profiler."""
        first = 1
        last = first + int(self.wl.get("trace_attempts", 2))

        def hook(index):
            if index == first:
                tracer.start()
            elif index == last:
                tracer.stop()
        self.rec.hook = hook
        try:
            self.episode("trace")
        finally:
            self.rec.hook = None
            tracer.stop()
        return dict(attempts=min(last, self.rec.index) - first)

    def decisions(self):
        """Faults of the accept rule over the window's episodes (and the
        set-up's), skipped where the program's host fallback stepped."""
        faults = replayed = 0
        for key, (t0, tmax, t_final, clean) in self.episode_ends.items():
            if not clean:
                continue
            f, r = replay_decisions(self.rec.calls(key), t0, self.members,
                                    tmax, t_final)
            faults += f
            replayed += r
        return faults, replayed

    def samples(self):
        """The copied calls as ``dict(kind, iters, u, h, u1, e, key)``,
        with a member axis first."""
        out = []
        for c in self.rec.captured:
            kind, iters = self.tiers[c["tier"]]
            lead = (lambda x: x) if c["u"].dim() == 4 else (
                lambda x: x.unsqueeze(0))
            out.append(dict(key=c["key"], kind=kind, iters=int(iters),
                            u=lead(c["u"]), u1=lead(c["u1"]),
                            t=c["t"].reshape(-1), h=c["h"].reshape(-1),
                            e=c["e"].reshape(-1), steps=1))
        return out
