"""Plain float64 reference of the benchmark's Keller-Segel system.

The system, on a periodic grid of 2 or 3 dimensions (the
configuration's ``dim``) with ``n`` points per axis over ``width x
height [x depth]`` (spacing ``width / n`` along x, and so on):

- free energy  G = sum_g -beta_g log(alpha_g + sum_l U_gl)
                   + maxscale s2 (tanh((rho - rhomax) / cushion) + 1)
                   + s2 log(rho)
- worm density drho/dt = grad(rho).grad(G) + rho lap(G)
- each ligand  dU/dt   = -gamma U + s rho + D lap(U)

with every derivative the centred finite difference of half-width
``sw = 1 + degree // 2`` (Fornberg's weights on the offsets -sw..sw)
along each axis, every Laplacian the sum of the axes' second
differences, and the fields clamped below at ``rhomin`` and ``Umin``
before the right-hand side is taken.

One implicit step is Rang and Angermann's ROS34PW2 W-method (4 stages,
order 3, embedded order 2) with J the exact Jacobian at the step's
start (by the product rule, checked against forward-mode
differentiation), each stage solve ``W Y = b`` (``W = I / (h gamma) - J``) by a
fixed number of preconditioner applications, Richardson
(``x = M b``, then ``x += M (b - W x)``) or Chebyshev (Saad, Iterative
Methods for Sparse Linear Systems, 2nd ed., Alg. 12.1, on the interval
estimated from the pointwise diffusivity spread).  M inverts, per
Fourier mode, the system linearized about the state's field means with
the rho row's diffusivity bounded by ``max(rho dG/drho)``: an arrow
matrix per mode, solved by its Schur complement, applied here through
the FFT over the grid's axes (the Laplacian's Fourier symbol the sum
of the axes' symbols).  The error norm is the root mean square of the
embedded difference over ``atol + rtol max(|u1|, |u1 + d|)``.

Everything is float64 and batched over a leading member axis: a state
is ``(members, fields) + (n,) * dim``.  Nothing here imports the
program under test; the parameters are read from the configuration's
own lines.
"""

import math

import numpy as np
import torch

__all__ = ["eval_params", "fd_weights", "Problem", "ROS34PW2",
           "state_gap"]

#: parameters the configurations leave at their documented defaults
DEFAULTS = {"degree": 3, "width": 1.0, "height": 1.0, "Umin": 1e-7,
            "rhomin": 1e-7, "rhomax": 28000.0, "cushion": 2000.0,
            "maxscale": 2.0, "ngroups": 1}

_NAMESPACE = {name: getattr(math, name) for name in
              ("pi", "sin", "cos", "exp", "log", "sqrt", "tanh")}


def eval_params(lines):
    """``name=value`` lines to a dict of floats.  A value is a Python
    expression over math's functions and the names defined so far; an
    empty value or one that does not evaluate (a spatial expression
    such as ``rho0``) is skipped."""
    vals = dict(DEFAULTS)
    for line in lines:
        name, _, expr = line.partition("=")
        if not expr.strip():
            continue
        try:
            vals[name.strip()] = float(eval(expr, dict(_NAMESPACE), vals))
        except (NameError, SyntaxError, TypeError):
            continue
    return vals


def fd_weights(order, sw):
    """Weights of the ``order``-th derivative on offsets -sw..sw at unit
    spacing (the Vandermonde system of Fornberg's construction)."""
    offs = np.arange(-sw, sw + 1, dtype=float)
    m = len(offs)
    A = np.array([offs ** k for k in range(m)])
    rhs = np.zeros(m)
    rhs[order] = math.factorial(order)
    w = np.linalg.solve(A, rhs)
    w[np.abs(w) < 1e-14] = 0.0
    return w


def _transform(A, Gamma, b, b2):
    Ginv = np.linalg.inv(Gamma)
    return dict(gamma=float(Gamma[0, 0]), a=A @ Ginv,
                c=np.diag(1.0 / np.diag(Gamma)) - Ginv, m=b @ Ginv,
                m2=b2 @ Ginv, order=3)


_g = 4.3586652150845900e-01
#: ROS34PW2 (Rang and Angermann 2005), the published (A, Gamma, b, b2)
#: in the transformed form Y_i = h * stage increment
ROS34PW2 = _transform(
    A=np.array([[0.0, 0.0, 0.0, 0.0],
                [8.7173304301691801e-01, 0.0, 0.0, 0.0],
                [8.4457060015369423e-01, -1.1299064236484185e-01, 0.0, 0.0],
                [0.0, 0.0, 1.0, 0.0]]),
    Gamma=np.array([
        [_g, 0.0, 0.0, 0.0],
        [-8.7173304301691801e-01, _g, 0.0, 0.0],
        [-9.0338057013044082e-01, 5.4180672388095326e-02, _g, 0.0],
        [2.4212380706095346e-01, -1.2232505839045147e+00,
         5.4526025533510214e-01, _g]]),
    b=np.array([2.4212380706095346e-01, -1.2232505839045147e+00,
                1.5452602553351020e+00, 4.3586652150845900e-01]),
    b2=np.array([3.7810903145819369e-01, -9.6042292212423178e-02,
                 5.0000000000000000e-01, 2.1793326075422950e-01]))


def _dot(a, b, acc=None):
    """``acc + a[0] b[0] + a[1] b[1] + ...``, added left to right."""
    for x, y in zip(a, b):
        acc = x * y if acc is None else acc + x * y
    return acc


class Problem:
    """The system of one configuration at ``n`` points per axis on
    ``device``."""

    def __init__(self, params, n, device="cpu", atol=None, rtol=None):
        p = eval_params(params)
        self.p = p
        self.n = int(n)
        self.dim = int(p.get("dim", 2))
        if self.dim not in (2, 3):
            raise ValueError("dim=%d: the reference takes 2 or 3" % self.dim)
        self.device = torch.device(device)
        extents = (float(p["width"]), float(p.get("height", 1.0)),
                   float(p.get("depth", 1.0)))[:self.dim]
        self.h = [e / self.n for e in extents]
        self.axes = tuple(range(-self.dim, 0))
        self.sw = 1 + int(p["degree"]) // 2
        self.atol = float(p["atol"] if atol is None else atol)
        self.rtol = float(p["rtol"] if rtol is None else rtol)
        self.s2 = float(p["s2"])
        self.groups = []
        self.ligands = []           # (s, gamma, D) per ligand, in order
        for g in range(1, int(p["ngroups"]) + 1):
            nl = int(p.get("nligands_%d" % g, 1))
            self.groups.append((float(p["alpha_%d" % g]),
                                float(p["beta_%d" % g]), nl))
            for l in range(1, nl + 1):
                key = "_%d_%d" % (g, l)
                self.ligands.append((float(p["s" + key]),
                                     float(p["gamma" + key]),
                                     float(p["D" + key])))
        self.nf = 1 + len(self.ligands)
        self.w1 = fd_weights(1, self.sw)
        self.w2 = fd_weights(2, self.sw)
        # the Laplacian's Fourier symbol per mode, (n,) * dim
        k = np.arange(self.n)
        lam = None
        for a, h in enumerate(self.h):
            sym = np.full(self.n, self.w2[self.sw] / h ** 2)
            for j in range(1, self.sw + 1):
                sym = sym + 2.0 * self.w2[self.sw + j] / h ** 2 * np.cos(
                    2.0 * np.pi * j * k / self.n)
            sym = sym.reshape([-1 if b == a else 1 for b in range(self.dim)])
            lam = sym if lam is None else lam + sym
        self.lam = torch.as_tensor(lam, dtype=torch.float64,
                                   device=self.device)
        self.lap_max = float((-self.lam).max())

    def _col(self, x):
        """Per-member values as ``(members, 1) + (1,) * dim``."""
        return x.reshape((-1, 1) + (1,) * self.dim)

    # -- the operator -------------------------------------------------
    def _deriv(self, f, axis, w, h, order):
        acc = None
        for j in range(-self.sw, self.sw + 1):
            c = float(w[j + self.sw]) / h ** order
            if c:
                term = c * torch.roll(f, -j, dims=axis)
                acc = term if acc is None else acc + term
        return acc

    def grad(self, f):
        return tuple(self._deriv(f, a, self.w1, h, 1)
                     for a, h in zip(self.axes, self.h))

    def lap(self, f):
        acc = None
        for a, h in zip(self.axes, self.h):
            d = self._deriv(f, a, self.w2, h, 2)
            acc = d if acc is None else acc + d
        return acc

    def groom(self, u):
        rho = torch.clamp(torch.nan_to_num(u[:, :1], nan=self.p["rhomin"]),
                          min=self.p["rhomin"])
        Us = torch.clamp(torch.nan_to_num(u[:, 1:], nan=self.p["Umin"]),
                         min=self.p["Umin"])
        return torch.cat([rho, Us], dim=1)

    def G(self, u):
        p = self.p
        rho = u[:, 0]
        G = (p["maxscale"] * self.s2
             * (torch.tanh((rho - p["rhomax"]) / p["cushion"]) + 1.0)
             + self.s2 * torch.log(rho))
        i = 1
        for alpha, beta, nl in self.groups:
            G = G - beta * torch.log(alpha + sum(u[:, i + l]
                                                 for l in range(nl)))
            i += nl
        return G

    def dG_drho(self, u):
        p = self.p
        rho = u[:, 0]
        sech2 = 1.0 - torch.tanh((rho - p["rhomax"]) / p["cushion"]) ** 2
        return p["maxscale"] * self.s2 * sech2 / p["cushion"] + self.s2 / rho

    def dG_dU(self, means):
        """dG/dU_l at the field means (members, fields), per ligand."""
        out = []
        i = 1
        for alpha, beta, nl in self.groups:
            tot = alpha + sum(means[:, i + l] for l in range(nl))
            out += [-beta / tot] * nl
            i += nl
        return out

    def rhs(self, u):
        """du/dt of the groomed state."""
        u = self.groom(u)
        rho = u[:, 0]
        G = self.G(u)
        rows = [_dot(self.grad(rho), self.grad(G)) + rho * self.lap(G)]
        for l, (s, gamma, D) in enumerate(self.ligands):
            U = u[:, 1 + l]
            rows.append(-gamma * U + s * rho + D * self.lap(U))
        return torch.stack(rows, dim=1)

    def jvp(self, u, v):
        """J(u) v, the exact directional derivative of ``rhs`` by
        forward-mode differentiation (the check of ``linearize``)."""
        return torch.func.jvp(self.rhs, (u,), (v,))[1]

    def linearize(self, u):
        """``v -> J(u) v`` by the product rule, with the fields, G, its
        stencils and each dG/dfield evaluated once: the rho row
        ``grad(v_rho).grad(G) + grad(rho).grad(Gv) + v_rho lap(G) + rho
        lap(Gv)``, ``Gv = sum_i dG/dfield_i v_i``, each ligand row
        ``-gamma v_U + s v_rho + D lap(v_U)``; a clamped field's tangent
        is zero below its floor."""
        p = self.p
        floors = torch.tensor([p["rhomin"]] + [p["Umin"]] * (self.nf - 1),
                              dtype=u.dtype, device=u.device)
        live = (u > floors.reshape((1, -1) + (1,) * self.dim)).to(u.dtype)
        ug = self.groom(u)
        rho = ug[:, 0]
        G = self.G(ug)
        gG, gr, lG = self.grad(G), self.grad(rho), self.lap(G)
        dG = [self.dG_drho(ug)]
        i = 1
        for alpha, beta, nl in self.groups:
            tot = alpha + sum(ug[:, i + l] for l in range(nl))
            dG += [-beta / tot] * nl
            i += nl

        def jv(v):
            vm = live * v
            Gv = sum(dG[k] * vm[:, k] for k in range(self.nf))
            acc = _dot(gr, self.grad(Gv), _dot(self.grad(vm[:, 0]), gG))
            rows = [acc + vm[:, 0] * lG + rho * self.lap(Gv)]
            for l, (s, gamma, D) in enumerate(self.ligands):
                rows.append(-gamma * vm[:, 1 + l] + s * vm[:, 0]
                            + D * self.lap(vm[:, 1 + l]))
            return torch.stack(rows, dim=1)
        return jv

    # -- the preconditioner ------------------------------------------
    def pc_stats(self, u):
        """Per member: field means, max and min of rho dG/drho."""
        means = u.mean(dim=self.axes)
        d = u[:, 0] * self.dG_drho(u)
        return means, d.amax(dim=self.axes), d.amin(dim=self.axes)

    def pc_apply(self, v, shift, means, rho_diff):
        """The per-mode arrow solve of the mean-state linearization,
        through the FFT over the grid's axes; ``shift``, ``rho_diff`` per
        member."""
        col = lambda x: x.reshape((-1,) + (1,) * self.dim)
        lam = self.lam
        c = torch.fft.fftn(v, dim=self.axes)
        dGU = [col(g) for g in self.dG_dU(means)]
        rho_mean, sh = col(means[:, 0]), col(shift)
        schur = sh - col(rho_diff) * lam
        rhs_r, dens = c[:, 0], []
        for l, (s, gamma, D) in enumerate(self.ligands):
            b_l = -rho_mean * lam * dGU[l]
            d_l = sh + gamma - D * lam
            schur = schur + b_l * s / d_l
            rhs_r = rhs_r - b_l * c[:, 1 + l] / d_l
            dens.append(d_l)
        x_r = rhs_r / schur
        rows = [x_r] + [(c[:, 1 + l] + s * x_r) / dens[l]
                        for l, (s, _, _) in enumerate(self.ligands)]
        return torch.fft.ifftn(torch.stack(rows, dim=1), dim=self.axes).real

    # -- the step -----------------------------------------------------
    def step(self, u, h, kind="richardson", iters=3, cheb=(1.2, 0.5)):
        """One ROS34PW2 step of every member from u (members, fields) +
        (n,) * dim with step sizes h (members,): ``(u1, enorm)``.
        ``kind`` and ``iters`` choose the stage solve; ``cheb`` is the
        Chebyshev interval's upper end and its safety factor on the
        lower end."""
        tab = ROS34PW2
        u = self.groom(u)
        h = torch.as_tensor(h, dtype=torch.float64, device=u.device)
        hb = self._col(h)
        shift = 1.0 / (h * tab["gamma"])
        shb = self._col(shift)
        means, rho_diff, rho_dmin = self.pc_stats(u)

        def M(v):
            return self.pc_apply(v, shift, means, rho_diff)

        jv = self.linearize(u)

        def W(x):
            return shb * x - jv(x)

        if kind == "chebyshev":
            lmax = torch.full_like(shift, cheb[0])
            dmin = torch.clamp(rho_dmin, min=0.0)
            a = ((shift + dmin * self.lap_max)
                 / (shift + rho_diff * self.lap_max))
            lmin = torch.minimum(torch.clamp(a * cheb[1], min=1e-4),
                                 0.5 * lmax)

        def solve(bi):
            if kind == "richardson":
                x = M(bi)
                for _ in range(iters - 1):
                    x = x + M(bi - W(x))
                return x
            theta = self._col(0.5 * (lmax + lmin))
            delta = self._col(torch.clamp(0.5 * (lmax - lmin), min=1e-8))
            sigma = theta / delta
            rho = 1.0 / sigma
            d = M(bi) / theta
            x = d
            for _ in range(iters - 1):
                z = M(bi - W(x))
                rho_new = 1.0 / (2.0 * sigma - rho)
                d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
                x = x + d
                rho = rho_new
            return x

        f0 = self.rhs(u)
        Ys = []
        for i in range(4):
            Ui = u
            for j in range(i):
                if tab["a"][i, j]:
                    Ui = Ui + tab["a"][i, j] * Ys[j]
            bi = f0 if i == 0 else self.rhs(Ui)
            for j in range(i):
                if tab["c"][i, j]:
                    bi = bi + (tab["c"][i, j] / hb) * Ys[j]
            Ys.append(solve(bi))
        u1, d = u, None
        for j in range(4):
            u1 = u1 + tab["m"][j] * Ys[j]
            dm = tab["m2"][j] - tab["m"][j]
            if dm:
                d = dm * Ys[j] if d is None else d + dm * Ys[j]
        w = self.atol + self.rtol * torch.maximum(u1.abs(), (u1 + d).abs())
        enorm = torch.sqrt(((d / w) ** 2).mean(dim=tuple(range(1, u.dim()))))
        return u1, enorm


def state_gap(u_prog, u_ref, atol, rtol):
    """Per member, the largest |u_prog - u_ref| over ``atol + rtol
    |u_ref|`` (the step controller's weights) over fields and points."""
    w = atol + rtol * u_ref.abs()
    gap = ((u_prog.to(torch.float64) - u_ref).abs() / w)
    return torch.nan_to_num(gap, nan=math.inf).amax(
        dim=tuple(range(1, gap.dim())))
