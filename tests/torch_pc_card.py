"""The basis-GEMM block pc's arrow solve on a card (csrc/arrow.cu).

The kernel (``BlockSpectralPreconditioner.arrow``) is held bit for bit
against ``chain_apply``: the per-mode solve as separate PyTorch
operations with every scalar cast at each application, the JAX
package's ``BlockSpectralPreconditioner._arrow_solve`` term by term.
The kernel rounds each operation on its own in that order, so on the
card the two must be equal, not merely close.  Cases: the flagship's
aggregation2d constants at 256^2 x 3, 2 and 5 fields, a with-G state, a
3D grid, a float64 pc and 4 members under ``torch.func.vmap``, each
application counted as one launch.  Then: the per-step pack and 12
applications under ``torch.cuda.set_sync_debug_mode("error")``, and
the kernel's name against the benchmark's kernel groups
(benchmark/yardstick.py).

This module imports no JAX, so the card's machine runs it by itself
(``python3 -m pytest -q --noconftest -p no:cacheprovider
tests/torch_pc_card.py``); tests/test_torch_pc.py imports its tests,
which skip without a card, and its helpers.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ksfd_tpu_torch.interop import problem_from_clargs  # noqa: E402
from ksfd_tpu_torch.solvers.linalg import (  # noqa: E402
    BlockSpectralPreconditioner,
)
from ksfd_tpu_torch.tools.problems import (  # noqa: E402
    agg3d_clargs,
    bench_clargs,
)


def chain_arrow_solve(pc, c, shift, t, means, rho_diff, nextra=0):
    """The per-mode solve as separate tensor operations, each scalar
    cast here (the JAX package's ``_arrow_solve`` with ``rho_diff`` set,
    term by term)."""
    cd = pc.compute_dtype
    dev = c.device
    cast = lambda x: torch.as_tensor(x, dtype=cd, device=dev)
    nf = pc.nfields
    lam = pc.lam_cd
    dG, s, gamma, D = pc.ops.linearization_coefficients(means, t)
    rho_mean = cast(means[0])
    shift = cast(shift)
    dG = [cast(g) for g in dG]
    schur = shift - cast(rho_diff) * lam
    rhs_r = c[0]
    xs_den = []
    for l in range(nf - 1):
        b_l = -rho_mean * lam * dG[1 + l]
        c_l = -cast(s[l])
        d_l = shift + cast(gamma[l]) - cast(D[l]) * lam
        schur = schur - b_l * c_l / d_l
        rhs_r = rhs_r - b_l * c[1 + l] / d_l
        xs_den.append((c_l, d_l))
    x_r = rhs_r / schur
    outs = [x_r]
    for l in range(nf - 1):
        c_l, d_l = xs_den[l]
        outs.append((c[1 + l] - c_l * x_r) / d_l)
    for extra in range(nf, nf + nextra):
        outs.append(c[extra] / shift)
    return torch.stack(outs, dim=0)


def chain_apply(pc, v, shift, t, means, rho_diff):
    """``apply_linearized`` with the solve of ``chain_arrow_solve``."""
    c = pc._forward(v.to(pc.compute_dtype))
    outs = chain_arrow_solve(pc, c, shift, t, means, rho_diff,
                             nextra=v.shape[0] - pc.nfields)
    return pc._inverse(outs).to(v.dtype)


def statistics(ops, u, device, dtype=torch.float32):
    """The step's pc statistics of a state: per-field means and the rho
    row's diffusivity bound, as ``dtype`` tensors on ``device`` (the
    mixed path's f32 view), with shift and t as float64 tensors."""
    u = torch.as_tensor(u, dtype=dtype, device=device)
    nf = ops.nligands + 1
    means = [torch.mean(u[i]) for i in range(nf)]
    t = torch.tensor(0.0, dtype=torch.float64, device=device)
    dG0 = ops._dG_fns[0](*[u[i] for i in range(nf)], t)
    rho_diff = torch.max(u[0] * dG0)
    shift = torch.tensor(1.0 / (3.94 * 0.4358665215), dtype=torch.float64,
                         device=device)
    return shift, t, means, rho_diff


def rough(grid, ps, seed=7):
    """A rough positive state of the grid's shape: rough_state in 2D
    with three fields, else 6000 + 1000 |N(0, 1)| per field."""
    if grid.dim == 2 and grid.dof == 3:
        return chip_smoke.rough_state(grid, ps)
    rng = np.random.default_rng(seed)
    return 6000.0 + 1000.0 * np.abs(
        rng.standard_normal((grid.dof,) + tuple(grid.Sshape)))


#: the card cases: (clargs, shape, with_g, pc dtype)
CASES = {
    "agg2d-256": (lambda: chip_smoke.agg2d_clargs(256), (256, 256), False,
                  "float32"),
    "dof2": (lambda: bench_clargs(64, 2), (64, 64), False, "float32"),
    "dof5": (lambda: bench_clargs(64, 5), (64, 64), False, "float32"),
    "with-g": (lambda: bench_clargs(64), (64, 64), True, "float32"),
    "3d": (lambda: agg3d_clargs(24), (24, 24, 24), False, "float32"),
    "f64": (lambda: bench_clargs(64), (64, 64), False, "float64"),
}


def case_inputs(name, device):
    """(pc, v, shift, t, means, rho_diff) of a case on ``device``."""
    make, shape, with_g, pc_dtype = CASES[name]
    ps, grid, ops = problem_from_clargs(make(), *shape, device=device,
                                        with_g=with_g)
    pc = BlockSpectralPreconditioner(grid, ops, compute_dtype=pc_dtype,
                                     device=device)
    u = rough(grid, ps)[:ops.nligands + 1]
    shift, t, means, rho_diff = statistics(ops, u, device)
    v = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (grid.dof,) + tuple(grid.Sshape))).to(torch.float32).to(device)
    return pc, v, shift, t, means, rho_diff


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (csrc/arrow.cu runs only there)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_card_arrow_kernel_equals_chain(card, name):
    """One launch per application, bit for bit the chain's result."""
    pc, v, shift, t, means, rho_diff = case_inputs(name, card)
    before = pc.arrow.launches
    got = pc.apply_linearized(v, shift, t, means, rho_diff)
    assert pc.arrow.launches == before + 1
    want = chain_apply(pc, v, shift, t, means, rho_diff)
    assert got.dtype == want.dtype and got.shape == v.shape
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_card_arrow_kernel_batches_members_under_vmap(card):
    """The mode solve of 4 members under vmap: one launch, lam not
    copied, each member bit for bit its own single solve and the
    chain's.  (The vmapped products may take other cuBLAS kernels than
    single ones, so the members are held at the modes.)"""
    pc, v, shift, t, means, rho_diff = case_inputs("dof2", card)
    nb = 4
    scale = torch.linspace(0.9, 1.2, nb, device=card)
    modes = torch.stack([pc._forward(v * (1 + 0.1 * i)) for i in range(nb)])
    packs = torch.stack([pc.pack(shift * s, t, means, rho_diff * s)
                         for s in scale])
    before, copies = pc.arrow.launches, pc.arrow.broadcasts
    out = torch.func.vmap(pc.solve_modes)(modes, packs)
    assert pc.arrow.launches == before + 1
    assert pc.arrow.broadcasts == copies
    for i, s in enumerate(scale):
        one = pc.solve_modes(modes[i], packs[i])
        want = chain_arrow_solve(pc, modes[i], shift * s, t, means,
                                 rho_diff * s)
        assert torch.equal(out[i], one) and torch.equal(one, want), i


@pytest.mark.cuda
def test_card_pack_and_applications_synchronise_nothing(card):
    """The per-step pack (device scalars, and Python numbers filled on
    the card) and 12 applications raise nothing under the sync debug
    mode "error"."""
    pc, v, shift, t, means, rho_diff = case_inputs("agg2d-256", card)
    pc.apply_linearized(v, shift, t, means, rho_diff)   # build, warm
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pack = pc.pack(shift, t, means, rho_diff)
        x = v
        for _ in range(12):
            x = pc.apply_packed(x, pack)
        pc.pack(2.29, 0.0, means, rho_diff)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_card_arrow_kernel_name_stays_outside_the_yardstick_groups(card):
    """In a profile of one application the kernel counts as ``other``
    in benchmark/yardstick.py's device groups, and ``library_gemms``
    lists the cuBLAS products (at least the four of a 2D apply) and not
    the kernel."""
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        from yardstick import device_groups, library_gemms
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    from torch.profiler import ProfilerActivity, profile

    pc, v, shift, t, means, rho_diff = case_inputs("agg2d-256", card)
    pack = pc.pack(shift, t, means, rho_diff)
    pc.apply_packed(v, pack)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pc.apply_packed(v, pack)
        torch.cuda.synchronize()
    cuda_dev = torch.autograd.DeviceType.CUDA
    counts = {ev.key: ev.count for ev in prof.key_averages()
              if getattr(ev, "device_type", None) == cuda_dev}
    arrow = [k for k in counts if "arrow_modes" in k]
    assert len(arrow) == 1 and counts[arrow[0]] == 1, counts
    assert device_groups({arrow[0]: 1.0})["other"] == 1.0
    gemms = library_gemms(counts)
    assert arrow[0] not in gemms
    assert sum(counts[k] for k in gemms) >= 4, counts
