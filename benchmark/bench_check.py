"""The comparison that decides ``correct``.

Each call the runner copied is run again by the plain reference
(reference/ks.py, over the grid's 2 or 3 axes) from the program's own
input state, with the program's h and solve tier, in float64, and three
numbers are compared with the cell's limits (``limits`` in its workload file):

- ``state_gap``: over the copied calls whose new state the program
  keeps (every call of a fixed-dt chain; an adaptive attempt where the
  reference accepts it), the largest gap between the program's new
  state and the reference's, in units of the step controller's weight
  ``atol + rtol |u|``; infinite where no call was compared;
- ``enorm_gap``: over the copied calls whose reference error norm is at
  most 10, the largest gap between the two error norms over the larger
  of the reference's and 1 (relative where the decision is taken, in
  the norm's own units below it);
- ``decision_faults``: attempts whose accept or reject leaves the rule
  (accepted exactly when the error norm is finite and at most 1, and
  then t advances by h), over every attempt of the window, plus copied
  calls that the reference decides the other way (outside 1e-3 of 1).

A call's reference runs the call's steps one after the other (the
fixed-dt chain: ``steps`` steps, its error norm the largest).
"""

import math

import torch

from reference.ks import Problem, state_gap

__all__ = ["judge"]


def _reference_call(ref, s, device):
    u = s["u"].to(device=device, dtype=torch.float64)
    h = s["h"].to(device=device, dtype=torch.float64)
    emax = None
    for _ in range(int(s["steps"])):
        u, e = ref.step(u, h, s["kind"], s["iters"])
        emax = e if emax is None else torch.maximum(emax, e)
    return u, emax


def judge(samples, decisions, params, n, limits, device, out):
    """``(correct, compared)``: ``compared`` maps each number to its value
    and limit; ``out`` gets one line per copied call."""
    ref = Problem(params, n, device)
    sgap = egap = 0.0
    compared_states = 0
    faults, replayed = decisions
    for s in samples:
        u1r, er = _reference_call(ref, s, device)
        u1 = s["u1"].to(device)
        gaps = state_gap(u1, u1r, ref.atol, ref.rtol).tolist()
        ers = er.tolist()
        eps = [float(x) for x in s["e"].reshape(-1).tolist()]
        for g, e_p, e_r in zip(gaps, eps, ers):
            if s.get("kept") or (math.isfinite(e_r) and e_r <= 1.0):
                sgap = max(sgap, g if math.isfinite(g) else math.inf)
                compared_states += 1
            if math.isfinite(e_r) and e_r <= 10.0:
                rel = (abs(e_p - e_r) / max(e_r, 1.0)
                       if math.isfinite(e_p) else math.inf)
                egap = max(egap, rel)
            ok_p = math.isfinite(e_p) and e_p <= 1.0
            ok_r = math.isfinite(e_r) and e_r <= 1.0
            if ok_p != ok_r and not (math.isfinite(e_r)
                                     and abs(e_r - 1.0) < 1e-3):
                faults += 1
        out("check %s: %s x%d h=%s members=%d state_gap=%s enorm=%s ref=%s"
            % (s["key"], s["kind"], s["iters"],
               "%.6g" % float(s["h"].max()), len(gaps),
               max(gaps), max(eps), max(ers)))
    if not compared_states:
        out("no new state was compared")
        sgap = math.inf
    compared = {
        "state_gap": dict(value=sgap, limit=float(limits["state_gap"])),
        "enorm_gap": dict(value=egap, limit=float(limits["enorm_gap"])),
        "decision_faults": dict(value=faults,
                                limit=float(limits["decision_faults"])),
    }
    correct = bool(samples) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    out("checked %d copied calls, replayed %d attempts" % (len(samples),
                                                           replayed))
    return correct, compared
