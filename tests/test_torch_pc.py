"""The port's fused block-pc apply (``-pc_pallas 1``) against ksfd_tpu.

ops/fused_pc.py's plain versions stand for the CUDA kernels of
csrc/pc2d.cu on the CPU.  They are held against the reference's fused
Pallas apply in interpret mode (float32 dots, as tests/test_pallas.py:749
runs it) at 128^2, the reference's alignment gate; against the port's own
basis-GEMM ``apply_linearized`` at ragged 2D sizes, which the port's gate
admits and the reference's does not; and the CUDA source's host path
(the card kernels' tile walk, TF32 split and k-step order, each wgmma a
scalar loop), compiled as host C++, against the plain versions.
Tolerances: the scalar pack to 1e-7 relative (float32 casts of the same
float64 numbers), the apply to 1e-5 of max|reference| (float32 products
summed in another order, or 3xTF32 products, tests/test_pallas.py:783),
a pc_pallas step to 1e-5 of the increment (the mixed-precision envelope
of tests/test_torch_solver.py); the TF32 split exactly.

The basis-GEMM pc's per-step scalar pack and arrow solve (csrc/arrow.cu,
solvers/linalg.py) are held exactly: the pack against the scalars cast
at each application, the plain chain and the source's host body against
that chain, bit for bit; its card tests live in tests/torch_pc_card.py
(no JAX import) and are collected here too.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import chip_smoke
import ksfd_tpu as KJ
from ksfd_tpu.ops.pallas_pc import make_pallas_block_pc, pallas_pc_available
from ksfd_tpu.ops.pallas_pc import pack_pc_scalars as jpack
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops.fused_pc import (
    CSRC_PC,
    fused_pc_available,
    make_fused_block_pc,
    pack_pc_scalars,
    reference_fuses,
    scratch_floats,
    split_planes,
    tf32,
)
from ksfd_tpu_torch.solvers import (
    make_adaptive_chunk_fn,
    make_multistep_fn,
    make_step_fn,
)
from ksfd_tpu_torch.solvers.linalg import (
    CSRC_ARROW,
    BlockSpectralPreconditioner,
)
from ksfd_tpu_torch.tools.problems import bench_clargs
# the basis-GEMM pc's arrow kernel on a card: its tests are collected
# here too (they skip without a card) and its helpers shared
from torch_pc_card import (  # noqa: F401
    card,
    chain_apply,
    chain_arrow_solve,
    rough,
    statistics,
    test_card_arrow_kernel_batches_members_under_vmap,
    test_card_arrow_kernel_equals_chain,
    test_card_arrow_kernel_name_stays_outside_the_yardstick_groups,
    test_card_pack_and_applications_synchronise_nothing,
)

N = 128


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("KSFD_PALLAS_INTERPRET", "1")


def problem(shape):
    """The bench problem (options84 class) of the reference's and the
    port's at ``shape``: (jps, jgrid, jops, tops)."""
    jps, jgrid, jops = ge._make_problem(*shape)
    _, _, tops = problem_from_clargs(jps.clargs, *shape, device="cpu")
    return jps, jgrid, jops, tops


@pytest.fixture(scope="module")
def prob128():
    return problem((N, N))


def pc_inputs(tops, seed=3):
    """A groomed rough state (bench.py's _rough_state, numpy seed 1234),
    the reference's pc statistics of it at t=0 as float64 numpy numbers,
    a shift and a float32 v from a numpy seed."""
    u0 = tops.groom(torch.from_numpy(
        chip_smoke.rough_state(tops.grid, tops.ps))).numpy()
    nf = u0.shape[0]
    means = [float(u0[i].mean()) for i in range(nf)]
    dG0 = tops._dG_fns[0](*[torch.from_numpy(u0[i]) for i in range(nf)],
                          0.0).numpy()
    rho_diff = float((u0[0] * dG0).max())
    v = np.random.default_rng(seed).standard_normal(u0.shape).astype(
        np.float32)
    return SimpleNamespace(u0=u0, means=means, rho_diff=rho_diff, v=v,
                           shift=2.29, t=0.0)


def port_pack(tops, x):
    f64 = lambda a: torch.tensor(a, dtype=torch.float64)
    return pack_pc_scalars(tops, f64(x.shift), f64(x.t),
                           [f64(m) for m in x.means], f64(x.rho_diff))


def test_pack_pc_scalars_matches_reference(prob128):
    _, _, jops, tops = prob128
    x = pc_inputs(tops)
    ref = np.asarray(jpack(jops, x.shift, x.t,
                           [jnp.asarray(m) for m in x.means], x.rho_diff))
    out = port_pack(tops, x)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (11,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-7, atol=0)


def test_fused_pc_matches_reference_kernels(prob128):
    """The plain fwd + inv against the reference's Pallas apply
    (interpret mode) on the same scalar pack, at 128^2 x 3."""
    _, jgrid, jops, tops = prob128
    x = pc_inputs(tops)
    sc = jpack(jops, x.shift, x.t, [jnp.asarray(m) for m in x.means],
               x.rho_diff)
    jpc = make_pallas_block_pc(jgrid, jops, interpret=True)
    ref_modes = np.asarray(jpc.fwd(sc, jnp.asarray(x.v)))
    ref = np.asarray(jpc(sc, jnp.asarray(x.v)))
    pc = make_fused_block_pc(tops.grid, tops)
    sct, v = torch.from_numpy(np.array(sc)), torch.from_numpy(x.v)
    modes = pc.fwd(sct, v)
    out = pc(sct, v)
    assert out.dtype == torch.float32 and out.shape == v.shape
    for got, want in ((modes.numpy(), ref_modes), (out.numpy(), ref)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert pc.fwd.launches == pc.inv.launches == 0


@pytest.mark.parametrize("shape", [(48, 40), (45, 37)])
def test_fused_pc_ragged_matches_apply_linearized(shape):
    """At sizes the reference's gate refuses (not 128-aligned), the fused
    apply equals the port's float32 basis-GEMM apply with rho_diff set."""
    _, _, _, tops = problem(shape)
    assert fused_pc_available(tops.grid, tops)
    x = pc_inputs(tops)
    f64 = lambda a: torch.tensor(a, dtype=torch.float64)
    means = [f64(m) for m in x.means]
    pcg = BlockSpectralPreconditioner(tops.grid, tops, compute_dtype="float32",
                                      device="cpu")
    v = torch.from_numpy(x.v)
    want = pcg.apply_linearized(v, f64(x.shift), f64(x.t), means,
                                rho_diff=f64(x.rho_diff))
    got = make_fused_block_pc(tops.grid, tops)(port_pack(tops, x), v)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# -- the CUDA source's kernel bodies on the host -------------------------

# pc2d.cu compiled as host C++20: its scalar host path (the card's tile
# walk, split, k-step order, transposed stores and arrow epilogue, each
# wgmma a scalar loop) behind the entries ksfd_pc_fwd_host,
# ksfd_pc_inv_host and ksfd_tf32_split.


@pytest.fixture(scope="module")
def host_pc(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to compile the kernel bodies")
    d = tmp_path_factory.mktemp("pc2d")
    lib = d / "libpc.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-x", "c++",
         "-o", str(lib), str(CSRC_PC)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    host = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    host.ksfd_pc_fwd_host.argtypes = [P] * 7 + [I] * 5
    host.ksfd_pc_inv_host.argtypes = [P] * 5 + [I] * 5
    host.ksfd_tf32_split.argtypes = [P] * 3 + [I]
    return host


def host_pc_run(host, pc, sc, v, vec):
    """The host fwd then inv on prepared operands, one member or a
    leading member axis: (modes, out).  ``vec`` 1 reads the state as it
    lies (ny % 4 == 0), 0 through the pitched copy, as the card does for
    ragged rows."""
    o = pc.owner
    nb = int(v.shape[0]) if v.dim() == 4 else 1
    shape = tuple(v.shape[-2:])
    tmp = torch.empty(scratch_floats(o.nf, *shape, nb))
    modes, out = torch.empty_like(v), torch.empty_like(v)
    (fx, fy), (ix, iy) = o.planes_fwd, o.planes_inv
    assert host.ksfd_pc_fwd_host(
        sc.data_ptr(), v.data_ptr(), fx.data_ptr(), fy.data_ptr(),
        o.lam2d.data_ptr(), tmp.data_ptr(), modes.data_ptr(), o.nf, *shape,
        nb, vec) == 0
    assert host.ksfd_pc_inv_host(
        modes.data_ptr(), ix.data_ptr(), iy.data_ptr(), tmp.data_ptr(),
        out.data_ptr(), o.nf, *shape, nb, vec) == 0
    return modes, out


def test_tf32_split_is_exact(host_pc):
    """The kernels' operand split: hi = tf32(x) has at most 10 mantissa
    bits (the low 13 bits zero), hi + lo == x exactly (|lo| at most half
    a TF32 ulp of a normal x), ties round away
    from zero; the C split (the host emulation of cvt.rna.tf32.f32) and
    fused_pc.tf32 agree bit for bit; the basis planes are [hi; tf32(lo)]
    with zero padding."""
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(
            -30, 30, 4096),
        np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -3e-39, 3.4e38],
                 dtype=np.float32),
        # ties: the 13 dropped bits exactly half
        (np.array([0x3F801000, 0xBF805000], dtype=np.uint32)
         .view(np.float32)),
    ]).astype(np.float32)
    hi, lo = np.empty_like(x), np.empty_like(x)
    host_pc.ksfd_tf32_split(x.ctypes.data, hi.ctypes.data, lo.ctypes.data,
                            x.size)
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0)
    assert np.array_equal(hi + lo, x)
    assert np.array_equal(hi.view(np.uint32), tf32(x).view(np.uint32))
    normal = np.abs(x) >= np.finfo(np.float32).tiny
    assert np.all(np.abs(lo[normal]).astype(np.float64)
                  <= np.abs(x[normal]).astype(np.float64) * 2.0 ** -11)
    assert list(hi[-2:].view(np.uint32)) == [0x3F802000, 0xBF806000]
    a = rng.standard_normal((5, 7)).astype(np.float32)
    planes = split_planes(a)
    assert planes.shape == (2, 5, 8) and not planes[:, :, 7:].any()
    assert np.array_equal(planes[0, :, :7], tf32(a))
    assert np.array_equal(planes[1, :, :7], tf32(a - tf32(a)))
    assert np.abs(planes[0, :, :7] + planes[1, :, :7] - a).max() <= (
        2.0 ** -21 * np.abs(a).max())


def port_problem(shape, dof):
    """The port's ops of the bench problem at ``shape`` with ``dof``
    fields (3: __graft_entry__'s own parameters)."""
    if dof == 3:
        return problem(shape)[3]
    return problem_from_clargs(bench_clargs(shape[0], dof), *shape,
                               device="cpu")[2]


@pytest.mark.parametrize("shape,vec,dof", [
    pytest.param((48, 40), 1, 3, id="shape0-1"),
    pytest.param((48, 40), 0, 3, id="shape1-0"),
    pytest.param((45, 37), 0, 3, id="shape2-0"),
    pytest.param((132, 68), 1, 3, id="shape3-1"),
    pytest.param((48, 40), 1, 2, id="dof2-1"),
    pytest.param((45, 37), 0, 2, id="dof2-0"),
    pytest.param((48, 40), 1, 4, id="dof4-1"),
    pytest.param((45, 37), 0, 4, id="dof4-0"),
    pytest.param((48, 40), 1, 1, id="dof1-1"),
    pytest.param((45, 37), 0, 1, id="dof1-0"),
    pytest.param((48, 40), 1, 5, id="dof5-1"),
    pytest.param((45, 37), 0, 5, id="dof5-0"),
    pytest.param((132, 68), 1, 6, id="dof6-1"),
    pytest.param((45, 37), 0, 6, id="dof6-0"),
])
def test_cuda_source_bodies_match_plain(host_pc, shape, vec, dof):
    """The fwd (two 3xTF32 products and the arrow epilogue, or above
    MAX_NF = 4 fields the plain second product and the arrow pass) and
    inv of csrc/pc2d.cu's host path, compiled as host C++, equal the
    plain versions to 1e-5 of max|plain|: one tile, ragged tiles in both
    axes, several tiles, with the state read as it lies (vec=1) and
    through the pitched copy (vec=0), with 1 to 6 fields.  vec=1 needs
    ny % 4 == 0, as the card's TMA needs 16-byte row pitches."""
    tops = port_problem(shape, dof)
    x = pc_inputs(tops)
    pc = make_fused_block_pc(tops.grid, tops)
    sc = port_pack(tops, x)
    v = torch.from_numpy(x.v).contiguous()
    modes, out = host_pc_run(host_pc, pc, sc, v, vec)
    for got, want in ((modes, pc.fwd.plain(sc, v)),
                      (out, pc.inv.plain(modes))):
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


def test_probe_pc_ring_variants_follow_the_source():
    """tools/probe_pc_ring.py's variants are text edits of csrc/pc2d.cu:
    every anchor is still in the source and every variant differs from
    it."""
    from ksfd_tpu_torch.tools.probe_pc_ring import variants

    src = CSRC_PC.read_text()
    out = variants(src)
    assert set(out) == {"full", "one_pass", "no_mma", "no_reads", "ring",
                        "ring_b_hi", "ring_a"}
    assert out["full"] == src
    assert len({text for text in out.values()}) == len(out)


def batched_pc_inputs(tops, nb):
    """nb members' scalar packs (a shift and means of their own) and
    float32 right-hand sides, stacked: ((nb, k) pack, (nb, dof, nx, ny))."""
    x = pc_inputs(tops)
    rng = np.random.default_rng(8)
    packs, vs = [], []
    for i in range(nb):
        xi = SimpleNamespace(**vars(x))
        xi.shift = x.shift * (1.0 + i)
        xi.means = [m * (1.0 + 0.01 * i) for m in x.means]
        packs.append(port_pack(tops, xi))
        vs.append(torch.from_numpy(rng.standard_normal(
            tops.grid.Vshape).astype(np.float32)))
    return torch.stack(packs), torch.stack(vs)


@pytest.mark.parametrize("shape,vec,dof", [
    pytest.param((48, 40), 1, 3, id="shape0-1"),
    pytest.param((45, 37), 0, 3, id="shape1-0"),
    pytest.param((48, 40), 1, 2, id="dof2-1"),
    pytest.param((45, 37), 0, 4, id="dof4-0"),
    pytest.param((45, 37), 0, 1, id="dof1-0"),
    pytest.param((48, 40), 1, 5, id="dof5-1"),
    pytest.param((45, 37), 0, 6, id="dof6-0"),
])
def test_cuda_source_batched_bodies_match_single_members(host_pc, shape,
                                                         vec, dof):
    """The member-batched pc2d.cu host path (the members' planes in the
    tile walk, their own pack rows, the bases shared), compiled as host
    C++ with nb = 3, equals three single-member runs bit for bit, in fwd
    and inv, reading the state as it lies and through the pitched copy
    with ragged tiles, with 1 to 6 fields (above 4 the arrow pass per
    member); and the plain version under vmap within 1e-5 of its largest
    value."""
    from torch.func import vmap

    tops = port_problem(shape, dof)
    pc = make_fused_block_pc(tops.grid, tops)
    sc_b, v_b = batched_pc_inputs(tops, 3)
    modes_b, out_b = host_pc_run(host_pc, pc, sc_b, v_b, vec)
    for i in range(3):
        modes, out = host_pc_run(host_pc, pc, sc_b[i].contiguous(),
                                 v_b[i].contiguous(), vec)
        assert torch.equal(modes_b[i], modes) and torch.equal(out_b[i], out)
    for got, want in ((modes_b, vmap(pc.fwd.plain)(sc_b, v_b)),
                      (out_b, vmap(pc.inv.plain)(modes_b))):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


def test_fused_pc_under_vmap_matches_members():
    """Under torch.func.vmap each fused-pc entry (through the custom op's
    vmap rule) equals the per-member calls bit for bit, also with the
    right-hand side unbatched (broadcast); on the CPU it launches
    nothing."""
    from torch.func import vmap

    _, _, _, tops = problem((32, 32))
    pc = make_fused_block_pc(tops.grid, tops)
    sc_b, v_b = batched_pc_inputs(tops, 3)
    modes = vmap(pc.fwd)(sc_b, v_b)
    assert torch.equal(modes, torch.stack([pc.fwd(sc_b[i], v_b[i])
                                           for i in range(3)]))
    out = vmap(pc)(sc_b, v_b)
    assert torch.equal(out, torch.stack([pc(sc_b[i], v_b[i])
                                         for i in range(3)]))
    shared = vmap(pc.fwd, in_dims=(0, None))(sc_b, v_b[0])
    assert torch.equal(shared, torch.stack([pc.fwd(sc_b[i], v_b[0])
                                            for i in range(3)]))
    assert pc.fwd.launches == pc.inv.launches == 0


# -- the pc_pallas step ---------------------------------------------------


def test_pc_pallas_step_matches_reference(prob128, interpret):
    """One default-numerics step with -pc_pallas 1 at 128^2 against the
    reference's (its fused pc and stencil kernels in interpret mode)."""
    _, _, jops, tops = prob128
    u0 = tops.groom(torch.from_numpy(
        chip_smoke.rough_state(tops.grid, tops.ps))).numpy()
    step_j, _ = jstep(jops, KJ.NumericsOptions(pc_pallas=True), atol=0.01,
                      rtol=1e-6)
    from ksfd_tpu.solvers.solver import BUILD_INFO

    assert BUILD_INFO["pallas_pc"]
    u_ref, e_ref = step_j(jnp.asarray(u0), jnp.asarray(0.0),
                          jnp.asarray(1e-3))
    step_t, _ = make_step_fn(tops, NumericsOptions(pc_pallas=True),
                             atol=0.01, rtol=1e-6)
    u1, e = step_t(torch.from_numpy(u0), torch.tensor(0.0, dtype=torch.float64),
                   torch.tensor(1e-3, dtype=torch.float64))
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert inc > 0 and np.isfinite(float(e_ref))
    assert np.abs(u1.numpy() - u_ref).max() <= 1e-5 * inc


@pytest.mark.parametrize("precision,per_step", [
    ("float64", dict(rhs=0, jvp=0, resid=8, delta=4, pc_fwd=12, pc_inv=12)),
    ("float32", dict(rhs=4, jvp=8, resid=0, delta=0, pc_fwd=12, pc_inv=12)),
])
def test_pc_pallas_launch_counts_per_step(precision, per_step):
    """Per pc_pallas step: 12 pc_fwd and 12 pc_inv (3 applies per stage
    solve), beside the stencil kernels of the precision's path.  On the
    CPU the wrappers run their plain bodies, so the bodies' calls are
    counted, and no launch."""
    _, _, _, tops = problem((32, 32))
    nm = NumericsOptions(pc_pallas=True, precision=precision)
    multi, _ = make_multistep_fn(tops, nm, atol=0.01, rtol=1e-6)
    wrappers = dict(multi.kernels.kernels, **multi.fused_pc.kernels)
    calls = {name: 0 for name in wrappers}
    for name, k in wrappers.items():
        def counted(*a, _name=name, _body=k._body):
            calls[_name] += 1
            return _body(*a)
        k._body = counted
    u, t, e = multi(torch.from_numpy(chip_smoke.initial_state(tops.grid)),
                    torch.tensor(0.0, dtype=torch.float64),
                    torch.tensor(1.0, dtype=torch.float64), 2)
    assert calls == {k: 2 * c for k, c in per_step.items()}
    assert all(k.launches == 0 for k in wrappers.values())
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(e))


# -- the gate --------------------------------------------------------------


def fallback_step_matches_reference(jops, tops, nm, u0, h, ref_nm=None):
    """Where the fused pc cannot run, a ``pc_pallas`` step takes the
    basis-GEMM pc, as the reference's does: it builds, records why,
    launches no B5 (makes no fused pc at all), equals the port's step
    without ``pc_pallas`` bit for bit, and is within 1e-5 of the
    increment of the reference's step with ``pc_pallas`` (its f32
    sweeps round apart from the port's, as in
    test_pc_pallas_step_matches_reference).  ``ref_nm``: the
    reference's spelling of ``nm``, where the port takes an alias."""
    from ksfd_tpu.solvers.solver import BUILD_INFO

    step_j, _ = jstep(jops, KJ.NumericsOptions(**(ref_nm or nm)), atol=0.01,
                      rtol=1e-6)
    u_ref, e_ref = step_j(jnp.asarray(u0), jnp.asarray(0.0), jnp.asarray(h))
    assert not BUILD_INFO["pallas_pc"]
    step_t, _ = make_step_fn(tops, NumericsOptions(**nm), atol=0.01,
                             rtol=1e-6)
    assert step_t.build_info["pc"] == "basis-GEMM"
    assert step_t.build_info["pc_pallas_fallback"]
    multi, _ = make_multistep_fn(tops, NumericsOptions(**nm), atol=0.01,
                                 rtol=1e-6)
    assert multi.fused_pc is None
    plain_nm = dict(nm, pc_pallas=False)
    step_0, _ = make_step_fn(tops, NumericsOptions(**plain_nm), atol=0.01,
                             rtol=1e-6)
    args = (torch.from_numpy(u0), torch.tensor(0.0, dtype=torch.float64),
            torch.tensor(h, dtype=torch.float64))
    u1, e = step_t(*args)
    u1_0, e_0 = step_0(*args)
    assert torch.equal(u1, u1_0) and torch.equal(e, e_0)
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert inc > 0 and np.isfinite(float(e_ref))
    assert np.abs(u1.numpy() - u_ref).max() <= 1e-5 * inc
    return step_t.build_info["pc_pallas_fallback"]


def rough_fields(tops, seed=6):
    """A groomed rough state of tops's field count: 6000 + (3000, 1000,
    500, ...)|N(0,1)| from a numpy seed."""
    rng = np.random.default_rng(seed)
    shape, dof = tuple(tops.grid.Sshape), tops.grid.dof
    u = np.stack([6000 + s * np.abs(rng.standard_normal(shape))
                  for s in ((3000, 1000) + (500,) * (dof - 2))[:dof]])
    return tops.groom(torch.from_numpy(u)).numpy()


def test_pc_pallas_on_a_3d_grid_takes_the_basis_gemm_pc(interpret):
    """The fused pc is 2D, as the reference's is; on a 3D grid
    ``pc_pallas`` takes the basis-GEMM pc, as the reference's gate
    (ksfd_tpu/solvers/solver.py:258-282) does; the fused pc itself
    still refuses the grid."""
    from test_torch_3d import SHAPE, _problems, wave_state

    jops, tops = _problems(SHAPE)
    assert not fused_pc_available(tops.grid, tops)
    why = fallback_step_matches_reference(
        jops, tops, dict(pc_pallas=True), np.array(tops.groom(
            torch.from_numpy(wave_state())).numpy()), 1.0)
    assert "3D grid" in why
    with pytest.raises(NotImplementedError, match="Queue B item 1"):
        make_fused_block_pc(tops.grid, tops)


@pytest.mark.parametrize("pc_dtype", ["float64", "f64"])
def test_pc_pallas_with_float64_transforms_takes_the_basis_gemm_pc(
        pc_dtype, interpret):
    """With float64 transforms ``pc_pallas`` takes the basis-GEMM pc, as
    the reference's gate does (the fused apply is float32), in both
    precisions."""
    _, _, jops, tops = problem((32, 32))
    nm = dict(pc_pallas=True, pc_dtype=pc_dtype)
    assert not fused_pc_available(tops.grid, tops, pc_dtype)
    why = fallback_step_matches_reference(
        jops, tops, nm, rough_fields(tops), 1e-3,
        dict(nm, pc_dtype="float64"))  # the reference has no "f64"
    assert "float64" in why
    multi, _ = make_multistep_fn(
        tops, NumericsOptions(precision="float32", **nm))
    assert multi.fused_pc is None


def five_field_problems(shape):
    """The bench problem with 5 fields at ``shape``, the reference's and
    the port's: (jgrid, jops, tops)."""
    clargs = bench_clargs(shape[0], 5)
    jps = KJ.SolutionParameters(clargs)
    jgrid = KJ.Grid(dim=2, width=1.0, height=1.0, nx=shape[0], ny=shape[1],
                    dof=5, order=3)
    jops = KJ.ops.PDEOperators(jps, jgrid)
    _, tgrid, tops = problem_from_clargs(clargs, *shape, device="cpu")
    assert tgrid.state() == jgrid.state() and tops.grid.dof == 5
    return jgrid, jops, tops


def fused_step_matches_reference(jops, tops, u0, h, ref_fuses):
    """A default-numerics ``pc_pallas`` step of the port (the fused pc's
    plain version on the CPU) within 1e-5 of the increment of the
    reference's (its fused Pallas pc in interpret mode where its gate
    admits the grid, ``ref_fuses``, else its einsum pc)."""
    from ksfd_tpu.solvers.solver import BUILD_INFO

    step_j, _ = jstep(jops, KJ.NumericsOptions(pc_pallas=True), atol=0.01,
                      rtol=1e-6)
    assert BUILD_INFO["pallas_pc"] is ref_fuses
    u_ref, e_ref = step_j(jnp.asarray(u0), jnp.asarray(0.0), jnp.asarray(h))
    step_t, _ = make_step_fn(tops, NumericsOptions(pc_pallas=True),
                             atol=0.01, rtol=1e-6)
    assert step_t.build_info["pc"] == "fused (B5a, B5b)"
    assert step_t.build_info["pc_pallas_fallback"] is None
    u1, e = step_t(torch.from_numpy(u0),
                   torch.tensor(0.0, dtype=torch.float64),
                   torch.tensor(h, dtype=torch.float64))
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    assert inc > 0 and np.isfinite(float(e_ref)) and np.isfinite(float(e))
    assert np.abs(u1.numpy() - u_ref).max() <= 1e-5 * inc


def test_pc_pallas_with_five_fields_takes_the_basis_gemm_pc(interpret):
    """5 fields on extents the reference's gate refuses (32^2: not
    128-aligned): the reference takes its einsum pc; the port, whose
    gate admits any 2D extent and (since the arrow pass) any field
    count, runs its fused pc, within 1e-5 of the increment of the
    reference's step.  (Until then the port took the basis-GEMM pc
    here, as the name says.)"""
    jgrid, jops, tops = five_field_problems((32, 32))
    assert not pallas_pc_available(jgrid, jops)
    assert not reference_fuses(tops.grid)
    assert fused_pc_available(tops.grid, tops)
    fused_step_matches_reference(jops, tops, rough_fields(tops), 1e-3,
                                 False)


def test_pc_pallas_with_five_fields_where_the_reference_fuses_raises(
        interpret):
    """5 fields at 128^2, where the reference's gate runs its fused
    Pallas pc: the port's fused pc runs too (it raised here, naming B5,
    until pc2d.cu took any field count), the step within 1e-5 of the
    increment of the reference's interpret-mode step; the multistep and
    the chunk build on it; with float64 transforms both fall back."""
    jgrid, jops, tops = five_field_problems((N, N))
    assert pallas_pc_available(jgrid, jops)
    assert reference_fuses(tops.grid)
    fused_step_matches_reference(jops, tops, rough_fields(tops), 1e-3, True)
    for build in (make_multistep_fn, make_adaptive_chunk_fn):
        fn, _ = build(tops, NumericsOptions(pc_pallas=True), atol=0.01,
                      rtol=1e-6)
        assert fn.fused_pc is not None
    step, _ = make_step_fn(tops, NumericsOptions(pc_pallas=True,
                                                 pc_dtype="float64"))
    assert "float64" in step.build_info["pc_pallas_fallback"]


@pytest.mark.parametrize("dof", [1, 6])
def test_pc_pallas_at_other_field_counts_matches_reference(dof,
                                                           interpret):
    """1 field (no ligand: the arrow is ``c0 / (shift - rho_diff
    lam)``) and 6 (the arrow pass) at 128^2: the port's fused pc's
    plain version through the step against the reference's
    interpret-mode Pallas pc, within 1e-5 of the increment."""
    clargs = bench_clargs(N, dof)
    jps = KJ.SolutionParameters(clargs)
    jgrid = KJ.Grid(dim=2, width=1.0, height=1.0, nx=N, ny=N, dof=dof,
                    order=3)
    jops = KJ.ops.PDEOperators(jps, jgrid)
    _, _, tops = problem_from_clargs(clargs, N, N, device="cpu")
    assert tops.grid.dof == dof and pallas_pc_available(jgrid, jops)
    fused_step_matches_reference(jops, tops, rough_fields(tops), 1e-3, True)


def test_fused_pc_refuses_other_devices():
    _, _, _, tops = problem((32, 32))
    pc = make_fused_block_pc(tops.grid, tops)
    v = torch.zeros(tops.grid.Vshape, device="meta")
    sc = torch.zeros(11, device="meta")
    with pytest.raises(ValueError, match="pc_fwd kernel"):
        pc.fwd(sc, v)
    with pytest.raises(ValueError, match="pc_inv kernel"):
        pc.inv(v)


# -- the basis-GEMM pc's scalar pack and arrow solve ----------------------
#
# The pack is built once per step on the device; the arrow solve reads
# it, as csrc/arrow.cu's kernel on the card and as the plain chain
# elsewhere.  Both are held bit for bit against the chain that casts
# every scalar at each application (torch_pc_card.chain_apply).

_PC_PROBLEMS = {}


def pc_case(dof=3, shape=(16, 12), pc_dtype="float32", with_g=False,
            use_fft=False, tdep=False):
    """(pc, v, shift, t, means, rho_diff) on the CPU: the bench problem
    (with a t-dependent ligand decay and free energy where ``tdep``),
    the step's statistics of a rough state as float32 tensors at t = 0
    (t = 30 where ``tdep``), a float32 v."""
    key = (dof, shape, with_g, tdep)
    if key not in _PC_PROBLEMS:
        clargs = (chip_smoke.tdep_clargs(shape[0]) if tdep
                  else bench_clargs(shape[0], dof))
        _PC_PROBLEMS[key] = problem_from_clargs(clargs, *shape,
                                                device="cpu", with_g=with_g)
    ps, grid, ops = _PC_PROBLEMS[key]
    pc = BlockSpectralPreconditioner(grid, ops, compute_dtype=pc_dtype,
                                     device="cpu", use_fft=use_fft)
    shift, t, means, rho_diff = statistics(
        ops, rough(grid, ps)[:ops.nligands + 1], "cpu")
    if tdep:
        t = torch.tensor(30.0, dtype=torch.float64)
    v = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (grid.dof,) + tuple(grid.Sshape)).astype(np.float32))
    return pc, v, shift, t, means, rho_diff


@pytest.mark.parametrize("case", ["f32", "f64", "tdep", "no-rho-diff",
                                  "numbers", "dof5"])
def test_block_pc_pack_equals_the_per_application_casts(case):
    """``pc.pack`` holds, value for value, the scalars the chain casts at
    each application, in fused_pc.py's layout (the fused pc's own
    ``pack_pc_scalars`` equals it for a float32 pc); with ``rho_diff``
    None slot 1 is ``rho_mean dG_0`` at the means."""
    pc, _, shift, t, means, rho_diff = pc_case(
        dof=5 if case == "dof5" else 3, tdep=case == "tdep",
        pc_dtype="float64" if case == "f64" else "float32")
    if case == "no-rho-diff":
        rho_diff = None
    if case == "numbers":
        shift, t, rho_diff = 2.29, 0.0, float(rho_diff)
    ops, cd = pc.ops, pc.compute_dtype
    cast = lambda x: torch.as_tensor(x, dtype=cd)
    dG, s, gamma, D = ops.linearization_coefficients(means, t)
    want = [shift, means[0] * dG[0] if rho_diff is None else rho_diff,
            means[0]] + dG[1:] + s + gamma + D
    pack = pc.pack(shift, t, means, rho_diff)
    assert pack.dtype == cd and pack.shape == (len(want),)
    assert torch.equal(pack, torch.stack([cast(x) for x in want]))
    if case == "tdep":
        assert ops._lig_tdep and float(pack[3 + 2 * 2]) == float(
            cast(0.01 * (1 + 30.0)))
    if cd == torch.float32:
        assert torch.equal(pack_pc_scalars(ops, shift, t, means, rho_diff),
                           pack)


@pytest.mark.parametrize("case", ["2d", "with-g", "no-rho-diff", "fft",
                                  "bf16", "dof1"])
def test_block_pc_apply_equals_the_chain_on_cpu(case):
    """Off the card the apply is the plain chain on the pack, bit for
    bit the chain that casts at each application, in every form that
    keeps it: with-G, the FFT form, bf16 transforms; without rho_diff
    the pack's ``rho_mean dG_0`` at the means; no kernel launch."""
    pc, v, shift, t, means, rho_diff = pc_case(
        dof=1 if case == "dof1" else 3, with_g=case == "with-g",
        use_fft=case == "fft",
        pc_dtype="bfloat16" if case == "bf16" else "float32")
    got = pc.apply_linearized(v, shift, t, means,
                              None if case == "no-rho-diff" else rho_diff)
    if case == "no-rho-diff":
        rho_diff = means[0] * pc.ops._dG_fns[0](*means, t)
    want = chain_apply(pc, v, shift, t, means, rho_diff)
    assert got.dtype == v.dtype and torch.equal(got, want)
    assert pc.arrow is None if case == "fft" else pc.arrow.launches == 0


@pytest.fixture(scope="module")
def host_arrow(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to compile the kernel body")
    lib = tmp_path_factory.mktemp("arrow") / "libarrow.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-x", "c++", "-o", str(lib), str(CSRC_ARROW)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    host = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    host.arrow_modes_host.argtypes = [P, I, P, P, P, I, I, ctypes.c_longlong,
                                      I, I]
    return host


@pytest.mark.parametrize("dof,with_g,pc_dtype,nb", [
    (1, False, "float32", 1), (2, False, "float32", 2),
    (3, False, "float32", 1), (3, True, "float32", 2),
    (3, False, "float64", 2), (5, False, "float32", 1),
    (6, False, "float32", 2),
])
def test_arrow_source_host_body_equals_the_chain(host_arrow, dof, with_g,
                                                 pc_dtype, nb):
    """csrc/arrow.cu's per-mode body, compiled as host C++ (no
    contraction), equals the plain chain bit for bit: every instance
    (0 to 4 ligands in registers, 5 read again), a with-G field, float64
    modes, members with their own packs."""
    pc, v, shift, t, means, rho_diff = pc_case(dof=dof, with_g=with_g,
                                               pc_dtype=pc_dtype)
    cd = pc.compute_dtype
    modes = torch.stack([pc._forward(v.to(cd) * (1 + 0.5 * i))
                         for i in range(nb)]).contiguous()
    packs = torch.stack([pc.pack(shift * (1 + 0.1 * i), t, means,
                                 rho_diff * (1 - 0.1 * i))
                         for i in range(nb)]).contiguous()
    out = torch.empty_like(modes)
    lam = pc.lam_cd.contiguous()
    nl = pc.nfields - 1
    assert host_arrow.arrow_modes_host(
        packs.data_ptr(), packs.shape[1], modes.data_ptr(), lam.data_ptr(),
        out.data_ptr(), nl, modes.shape[1] - pc.nfields, lam.numel(), nb,
        int(cd == torch.float64)) == 0
    for i in range(nb):
        want = pc._arrow_chain(packs[i], modes[i])
        assert torch.equal(out[i], want), i


# -- on a card -------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_pc_kernels_match_plain():
    """On a card: B5a and B5b equal their plain versions to 1e-5 of
    max|plain| at an aligned and a ragged size and count one launch per
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    for shape in ((128, 128), (45, 37)):
        jps, _, _ = ge._make_problem(*shape)
        _, _, tops = problem_from_clargs(jps.clargs, *shape, device="cuda")
        x = pc_inputs(problem_from_clargs(jps.clargs, *shape,
                                          device="cpu")[2])
        pc = make_fused_block_pc(tops.grid, tops)
        sc = port_pack(tops, x).cuda()
        v = torch.from_numpy(x.v).cuda()
        modes = pc.fwd(sc, v)
        out = pc.inv(modes)
        assert pc.fwd.launches == pc.inv.launches == 1
        for got, want in ((modes, pc.fwd.plain(sc, v)),
                          (out, pc.inv.plain(modes))):
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (shape, err)
