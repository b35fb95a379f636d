"""What the harness keeps of the program's own calls.

``Recorder.wrap`` puts a thin layer around each of the program's tier
steps (the callables its adaptive loop calls per attempt, ``(u, t, h[,
f0]) -> (u1, enorm[, f1])``): every call's t, h and enorm tensors are
logged without a host read, the calls picked for the correctness check
are copied whole, and a test can plant a fault in what the program gets
back.  Nothing else of the program changes.
"""

import math

__all__ = ["Recorder", "plant", "replay_decisions"]


def plant(fault, args, out):
    """``out`` with ``fault`` planted: the state returned unchanged, one
    point of the new state altered by 1, or (members on the first axis)
    the second half of the members left unstepped."""
    if fault is None:
        return out
    out = list(out)
    u, u1 = args[0], out[0]
    if fault == "unchanged":
        out[0] = u.to(u1.dtype)
        if len(out) > 2:
            out[2] = args[3]
    elif fault == "altered":
        u1 = u1.clone()
        flat = u1.view(-1)
        flat[flat.numel() // 2] += 1.0
        out[0] = u1
    elif fault == "half":
        if u1.dim() == 4 and u1.shape[0] > 1:
            k = u1.shape[0] // 2
            u1 = u1.clone()
            u1[k:] = u[k:].to(u1.dtype)
            out[0] = u1
            if len(out) > 2:
                f1 = out[2].clone()
                f1[k:] = args[3][k:]
                out[2] = f1
    else:
        raise ValueError("unknown fault %r" % (fault,))
    return tuple(out)


class Recorder:
    """The log and the copies of the program's step calls, by episode.

    ``want`` holds ``(episode, index)`` pairs to copy; ``hook(index)``,
    when set, runs before each call (the traced stretch starts and stops
    the profiler there)."""

    def __init__(self, fault=None):
        self.fault = fault
        self.episode = None
        self.index = 0
        self.log = {}
        self.want = set()
        self.captured = []
        self.hook = None

    def new_episode(self, key):
        self.episode = key
        self.index = 0
        self.log[key] = []

    def wrap(self, fn, tier):
        def step(*args):
            if self.hook is not None:
                self.hook(self.index)
            out = plant(self.fault, args, fn(*args))
            key = (self.episode, self.index)
            self.log[self.episode].append((tier, args[1], args[2], out[1]))
            if key in self.want:
                self.captured.append(dict(
                    key=key, tier=tier, u=args[0].clone(),
                    t=args[1].clone(), h=args[2].clone(),
                    u1=out[0].clone(), e=out[1].clone()))
            self.index += 1
            return out
        return step

    def wrap_list(self, steps):
        """Wrap every tier step of the program's list in place."""
        for tier, fn in enumerate(list(steps)):
            steps[tier] = self.wrap(fn, tier)

    def calls(self, key):
        """The episode's calls as host numbers: ``[(tier, ts, hs, es)]``
        with lists of one entry per member in the call."""
        out = []
        for tier, t, h, e in self.log.get(key, []):
            as_list = lambda x: [float(v) for v in
                                 x.detach().reshape(-1).to("cpu").tolist()]
            out.append((tier, as_list(t), as_list(h), as_list(e)))
        return out


def replay_decisions(calls, t0, members, tmax, t_final):
    """Count where the program's accept decisions leave its rule: each
    attempt of a member at (t, h) with error norm e is accepted exactly
    when e is finite and at most 1, and then the member's next attempt
    (or its final time) is at t + h, else at t.  The members in a call
    are those whose t has not passed ``tmax``, in member order.  Returns
    ``(faults, attempts replayed)``."""
    t = [float(t0)] * members
    faults = replayed = 0
    for _, ts, hs, es in calls:
        active = [i for i in range(members) if t[i] <= tmax]
        if len(active) != len(ts):
            return faults + 1, replayed
        for j, i in enumerate(active):
            if ts[j] != t[i]:
                faults += 1
                t[i] = ts[j]
            if math.isfinite(es[j]) and es[j] <= 1.0:
                t[i] = t[i] + hs[j]
            replayed += 1
    faults += sum(1 for i in range(members) if t[i] != float(t_final[i]))
    return faults, replayed
