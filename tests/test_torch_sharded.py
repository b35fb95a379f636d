"""The port's sharded step, multistep and chunk against the reference's.

Gloo ranks on the CPU (tests/torch_mesh_ranks.py, spawned once for the
module: 2 ranks for every case, 4 for the default float64 step) run
``make_step_fn``/``make_multistep_fn``/``make_adaptive_chunk_fn`` with
``mesh=``, each rank on its slab; the gathered results are held here to
the reference's sharded builds on a (2, 1) (or (4, 1)) mesh with the
Pallas kernels in interpret mode (``KSFD_PALLAS_INTERPRET=1``, as its
own tests set it), at the envelopes of tests/test_pallas.py:293-366:

- the float64 step (pc_dtype auto, the bfloat16 sharded pc on both
  sides; pinned float32 against the port's unsharded step): 1e-5 of the
  increment, enorm 1e-2 relative;
- the float32 fast mode: 1e-4 of the increment plus 4 float32 ulps of
  the state (tests/test_torch_fast32.py's bound);
- the 3D multistep (examples/aggregation3d at 32^3): 1e-5 of the
  increment, emax 1e-2 relative;
- the chunk (tests/test_pallas.py's ops2d): from the rough state the
  same k and attempts and t within 1e-3 relative; from the near-uniform
  state also the state within 1e-4 of the increment
  (test_torch_chunk.py's assert_parity), and with the CFL clamp the same
  against the port's unsharded chunk; every rank reads the same enorm
  and takes the same ladder decisions.

Build-only checks run in one process on a mesh without a group: the
``pc_dtype`` auto resolution (test_sharding.py:155-182), ``pc_pallas``
on a mesh, and the refusals.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ksfd_tpu as KJ
import ksfd_tpu.ops  # noqa: F401 (KJ.ops)
from helpers import make_clargs
from ksfd_tpu.parallel import distribute as jdistribute
from ksfd_tpu.parallel import grid_mesh as jgrid_mesh
from ksfd_tpu.solvers import make_multistep_fn as jmultistep
from ksfd_tpu.solvers import make_step_fn as jstep
from ksfd_tpu.solvers.solver import make_adaptive_chunk_fn as jchunk_fn
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.parallel.mesh import SlabMesh
from ksfd_tpu_torch.solvers import (
    make_adaptive_chunk_fn,
    make_multistep_fn,
    make_step_fn,
    shard_members,
)
from torch_mesh_ranks import (
    CFL_SAFETY,
    CHUNK_ACCEPTS,
    CHUNK_NUMERICS,
    H,
    H3,
    N2,
    N3,
    aggregation3d_params,
    initial_state,
    ops2d_params,
    rough_state,
    run_ranks,
)

EPS32 = 2.0 ** -23


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def interpret_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KSFD_PALLAS_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results: 2 ranks for every case, 4 for the float64
    step with the default (bfloat16) sharded pc; one spawn of each for
    the module."""
    return run_ranks({2: ["steps_2d", "multistep_3d", "chunk"],
                      4: ["step_f64_auto"]})


def jax_step(jops, jgrid, numerics, u0, h, n):
    """The reference's sharded step on an (n, 1) mesh."""
    mesh = jgrid_mesh(jgrid, shape=(n, 1))
    step, _ = jstep(jops, numerics, atol=0.01, rtol=1e-6, mesh=mesh)
    us, _ = jdistribute(jnp.asarray(u0), jgrid, mesh=mesh)
    u1, e = step(us, jnp.asarray(0.0), jnp.asarray(h))
    return np.asarray(u1), float(e)


@pytest.fixture(scope="module")
def problem2d():
    jps, jgrid, jops = ge._make_problem(N2, N2)
    u0 = np.array(jops.groom(jnp.asarray(rough_state((N2, N2)))))
    return jgrid, jops, u0, jps


@pytest.mark.parametrize("n,label", [(2, "f64_auto"), (2, "f64_f32pc"),
                                     (4, "f64_auto")])
def test_sharded_f64_step_matches_reference(ranks, problem2d, interpret_env,
                                            n, label):
    """The float64 step over n gloo ranks against the reference's
    sharded step, with pc_dtype auto (the bfloat16 sharded pc on both
    sides), and with pc_dtype float32 against the port's unsharded step
    (the reference's own sharded-vs-single check): 1e-5 of the
    increment, enorm 1e-2 relative, every rank with the same enorm."""
    jgrid, jops, u0, jps = problem2d
    if label == "f64_auto":
        u_ref, e_ref = jax_step(jops, jgrid, KJ.NumericsOptions(), u0, H, n)
    else:
        _, _, ops = problem_from_clargs(jps.clargs, N2, N2, device="cpu")
        step, _ = make_step_fn(ops, NumericsOptions(pc_dtype="float32"),
                               atol=0.01, rtol=1e-6)
        u1, e1 = step(torch.from_numpy(u0), torch.zeros((),
                      dtype=torch.float64), torch.tensor(H, dtype=torch.float64))
        u_ref, e_ref = u1.numpy(), float(e1)
    assert e_ref < 1.0
    inc = np.abs(u_ref - u0).max()
    case = "steps_2d" if n == 2 else "step_f64_auto"
    enorms = {res[case][label + "_enorm"] for res in ranks[n].values()}
    assert len(enorms) == 1
    for res in ranks[n].values():
        out = res[case]
        assert out[label].dtype == np.float64
        assert np.abs(out[label] - u_ref).max() / inc < 1e-5
        assert abs(out[label + "_enorm"] - e_ref) <= 1e-2 * e_ref
        want = "bfloat16" if label == "f64_auto" else "float32"
        assert "'pc_dtype': '%s'" % want in out[label + "_info"]
        assert "halo-slab (B9) over %d x-slabs" % n in out[label + "_info"]


def test_sharded_fast_step_matches_reference(ranks, problem2d,
                                             interpret_env):
    """The float32 fast mode over 2 ranks against the reference's
    sharded fast step (its rhs and jvp kernels sharded)."""
    jgrid, jops, u0, _ = problem2d
    u_ref, e_ref = jax_step(jops, jgrid,
                            KJ.NumericsOptions(precision="float32"), u0, H, 2)
    bound = (1e-4 * np.abs(u_ref - u0).max()
             + 4 * EPS32 * np.abs(u0).max())
    for res in ranks[2].values():
        out = res["steps_2d"]
        assert out["fast32"].dtype == np.float32
        assert np.abs(out["fast32"] - u_ref).max() <= bound
        assert np.isfinite(out["fast32_enorm"]) and np.isfinite(e_ref)


def test_sharded_3d_multistep_matches_reference(ranks, interpret_env):
    """Two steps of the 3D multistep (aggregation3d at 32^3) over 2
    ranks against the reference's sharded multistep on a (2, 1, 1)
    mesh."""
    clargs = make_clargs(params=aggregation3d_params(N3))
    jps = KJ.SolutionParameters(clargs)
    jgrid = KJ.Grid(dim=3, width=1, height=1, depth=1, nx=N3, ny=N3, nz=N3,
                    dof=3, order=3)
    jops = KJ.ops.PDEOperators(jps, jgrid)
    u0 = np.asarray(jops.groom(jnp.asarray(rough_state((N3,) * 3))))
    mesh = jgrid_mesh(jgrid, shape=(2, 1, 1))
    multi, _ = jmultistep(jops, KJ.NumericsOptions(), atol=0.01, rtol=1e-6,
                          mesh=mesh)
    us, _ = jdistribute(jnp.asarray(u0), jgrid, mesh=mesh)
    u_ref, t_ref, e_ref = multi(us, jnp.asarray(0.0), jnp.asarray(H3), 2)
    u_ref = np.asarray(u_ref)
    inc = np.abs(u_ref - u0).max()
    for res in ranks[2].values():
        out = res["multistep_3d"]
        assert np.abs(out["u"] - u_ref).max() / inc < 1e-5
        assert abs(out["t"] - float(t_ref)) < 1e-15
        assert abs(out["emax"] - float(e_ref)) <= 1e-2 * float(e_ref)
        assert "halo-slab (B9) over 2 x-slabs" in out["info"]


@pytest.fixture(scope="module")
def chunk_refs(interpret_env):
    """The reference's sharded chunk (CHUNK_NUMERICS) on
    tests/test_pallas.py's ops2d problem over a (2, 1) mesh, one build
    for both starts: the rough state from h=H (as
    test_sharded_adaptive_chunk_f64 starts it) and the near-uniform
    state from h=1."""
    ps = KJ.SolutionParameters(make_clargs(params=ops2d_params()))
    jgrid = KJ.Grid(dim=2, width=1.0, height=1.0, nx=64, ny=64, dof=3,
                    order=3)
    jops = KJ.ops.PDEOperators(ps, jgrid)
    mesh = jgrid_mesh(jgrid, shape=(2, 1))
    chunk, _ = jchunk_fn(jops, CHUNK_NUMERICS(KJ.NumericsOptions),
                         atol=0.01, rtol=1e-6, mesh=mesh)
    out = {}
    for label, u0, h0 in (
            ("rough", jops.groom(jnp.asarray(rough_state((64, 64)))), H),
            ("smooth", jnp.asarray(initial_state((64, 64))), 1.0)):
        us, _ = jdistribute(u0, jgrid, mesh=mesh)
        ju, jt, jh, jk, ja, jr = chunk(us, jnp.asarray(0.0),
                                       jnp.asarray(h0), 1e9, CHUNK_ACCEPTS)
        out[label] = (np.array(u0), h0, np.asarray(ju), float(jt),
                      float(jh), int(jk), int(ja), bool(jr))
    return out


def test_sharded_chunk_matches_reference(ranks, chunk_refs):
    """The sharded chunk from the rough state as
    test_sharded_adaptive_chunk_f64 runs it: the same k and attempts as
    the reference's sharded chunk and t within 1e-3 of its t; both ranks
    read the same enorm per attempt and take the same decisions.  (Here
    enorm is a few float32 roundings of the sweeps, 2.5e-3 at the first
    accept, and each accept's h follows it: the states are held to each
    other on the smooth start below.)"""
    _, _, _, jt, _, jk, ja, jr = chunk_refs["rough"]
    results = [res["chunk"]["rough"] for res in ranks[2].values()]
    assert results[0]["records"] == results[1]["records"]
    for out in results:
        assert (out["k"], out["attempts"], out["rejected"]) == (jk, ja, jr)
        assert out["k"] == CHUNK_ACCEPTS
        assert abs(out["t"] - jt) <= 1e-3 * jt


def test_sharded_smooth_chunk_matches_reference_and_single(
        ranks, chunk_refs, port_ops2d):
    """The sharded chunk from the near-uniform state at h=1: the state
    within 1e-4 of the increment of the reference's sharded chunk, the
    same k, attempts, t and h to 1e-4 (test_torch_chunk.py's
    assert_parity); with the CFL clamp (its velocity bound global over
    the ranks) the same against the port's unsharded chunk."""
    u0, h0, ju, jt, jh, jk, ja, jr = chunk_refs["smooth"]
    single, _ = make_adaptive_chunk_fn(
        port_ops2d, CHUNK_NUMERICS(NumericsOptions), atol=0.01, rtol=1e-6,
        cfl_safety=CFL_SAFETY)
    u1, t1, h1, k1, a1, r1 = single(torch.from_numpy(u0), 0.0, h0, 1e9,
                                    CHUNK_ACCEPTS)
    for label, (ref, t_r, h_r, k_r, a_r, r_r) in (
            ("smooth", (ju, jt, jh, jk, ja, jr)),
            ("smooth_cfl", (u1.numpy(), t1, h1, k1, a1, r1))):
        results = [res["chunk"][label] for res in ranks[2].values()]
        assert results[0]["records"] == results[1]["records"]
        inc = np.abs(ref - u0).max()
        for out in results:
            assert (out["k"], out["attempts"], out["rejected"]) == (
                k_r, a_r, r_r)
            assert np.abs(out["u"] - ref).max() <= 1e-4 * inc, label
            assert abs(out["t"] - t_r) <= 1e-4 * t_r
            assert abs(out["h"] - h_r) <= 1e-4 * h_r


# ------------------------------------------------- build-only, one process


@pytest.fixture(scope="module")
def port2d():
    _, grid, ops = problem_from_clargs(make_clargs(params=ops2d_params()),
                                       64, 64, device="cpu")
    return grid, ops


@pytest.fixture(scope="module")
def port_ops2d(port2d):
    return port2d[1]


def fake_mesh(grid, n):
    """Rank 0's mesh of an n-way x split without a process group: the
    builds make no collective."""
    return SlabMesh(grid, None, n, 0, "gloo", "cpu", ["cpu"] * n)


def test_pc_dtype_auto_resolution(port2d):
    """pc_dtype auto is bfloat16 exactly on a mesh of more than one rank
    (the sharded apply's one bf16 all_reduce), float32 on one device or
    one rank; an explicit pc_dtype wins; a mesh always takes the
    sharded apply (the port's state is local)."""
    grid, ops = port2d
    info = lambda nm, mesh: make_step_fn(ops, nm, atol=0.01, rtol=1e-6,
                                         mesh=mesh)[0].build_info
    single = info(NumericsOptions(), None)
    assert (single["pc_dtype"], single["pc"]) == ("float32", "basis-GEMM")
    assert single["kernels"] == "unsharded" and single["mesh_shape"] is None
    two = info(NumericsOptions(), fake_mesh(grid, 2))
    assert two["pc_dtype"] == "bfloat16" and two["mesh_shape"] == (2, 1)
    assert two["pc"].startswith("sharded")
    one = info(NumericsOptions(), fake_mesh(grid, 1))
    assert one["pc_dtype"] == "float32" and one["pc"].startswith("sharded")
    pinned = info(NumericsOptions(pc_dtype="float32"), fake_mesh(grid, 2))
    assert pinned["pc_dtype"] == "float32"
    assert info(NumericsOptions(pc_dtype="bfloat16"),
                fake_mesh(grid, 1))["pc_dtype"] == "bfloat16"


def test_pc_pallas_on_a_mesh_takes_the_sharded_basis_gemm_pc(port2d):
    """The reference's fused pc is single-shard (solver.py:258-265): on
    a mesh pc_pallas builds the sharded basis-GEMM apply, and the build
    info says so."""
    grid, ops = port2d
    multi, _ = make_multistep_fn(ops, NumericsOptions(pc_pallas=True),
                                 mesh=fake_mesh(grid, 2))
    assert multi.fused_pc is None
    assert multi.build_info["pc"].startswith("sharded basis-GEMM")
    assert multi.kernels.kind == "halo-slab (B9) over 2 x-slabs"


@pytest.mark.parametrize("build,match", [
    (lambda ops, m: make_step_fn(ops, NumericsOptions(ksp_type="gmres_scipy"),
                                 mesh=m), r"Queue A item 11 \(A14\)"),
    (lambda ops, m: make_adaptive_chunk_fn(
        ops, NumericsOptions(ksp_type="gmres_scipy"), mesh=m),
     r"Queue A item 11 \(A14\)"),
    (lambda ops, m: make_step_fn(ops, NumericsOptions(pc_fft="on"), mesh=m),
     r"Queue A item 11 \(A14\)"),
    (lambda ops, m: make_step_fn(ops, NumericsOptions(), mesh=object()),
     r"Queue A item 11 \(A14\)"),
    (lambda ops, m: shard_members(torch.zeros(2, 3, 8, 8)),
     r"Queue A item 11 \(A14\)"),
], ids=["gmres-step", "gmres-chunk", "fft-on-mesh", "other-mesh",
        "member-mesh"])
def test_refusals(port2d, build, match):
    """The GMRES step on a mesh, the FFT pc on a mesh (``pc_fft`` on: it
    is single-card, as the reference's is), a mesh that is not a slab
    mesh and member meshes raise, naming the ROADMAP item."""
    grid, ops = port2d
    with pytest.raises(NotImplementedError, match=match):
        build(ops, fake_mesh(grid, 2))


def test_kernels_of_another_mesh_refused(port2d):
    """Kernels built for one mesh (or none) cannot serve a step on
    another: their halo rows would be the wrong ranks'."""
    grid, ops = port2d
    from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels

    kern = make_fused_kernels(ops)
    with pytest.raises(ValueError, match="built for mesh"):
        make_step_fn(ops, dataclasses.replace(NumericsOptions()),
                     mesh=fake_mesh(grid, 2), kernels=kern)
