"""The port's fused stencil kernels against the Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version; here it
is held against ksfd_tpu's Pallas kernel in interpret mode on the same
seeded numpy inputs, and the delta kernel also against the float64
oracle increment at the bounds of tests/test_pallas.py.  The generated
CUDA header is compiled as host C++ and checked against the torchify'd
float32 expressions.  The CUDA kernels themselves run only on a card:
those tests carry the ``cuda`` marker and skip elsewhere
(chip_smoke.py runs the same comparison at full size).
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ksfd_tpu.ops.pallas_stencil import make_pallas_kernels
from ksfd_tpu_torch.interop import problem_from_clargs
from ksfd_tpu_torch.ops import fused_stencil
from ksfd_tpu_torch.ops.codegen import pointwise_header
from ksfd_tpu_torch.ops.fused_stencil import make_fused_kernels
from ksfd_tpu_torch.tools.problems import bench_clargs
from test_torch_probe import host_kernels, host_run

N = 32


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built():
    """(JAX ops, port ops, Pallas kernels in interpret mode, port
    kernels) of the bench problem at N^2 x 3."""
    jps, _, jops = ge._make_problem(N, N)
    _, _, tops = problem_from_clargs(jps.clargs, N, N, device="cpu")
    return (jops, tops, make_pallas_kernels(jops, tile_x=16, interpret=True),
            make_fused_kernels(tops))


def rough_state(seed=0, scale=1000.0):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal((N, N))),
        6000 + scale * np.abs(rng.standard_normal((N, N))),
        6000 + 0.5 * scale * np.abs(rng.standard_normal((N, N))),
    ])


def wave_state():
    """Near-uniform fields ~1e4 with ~1-amplitude structure."""
    wave = np.sin(2 * np.pi * np.arange(N) / N)[:, None] * np.ones((N, N))
    return np.stack([9000 + wave, 6162 + 0.7 * wave, 797 + 0.1 * wave])


def f32(*arrays):
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("state", ["rough", "wave"])
def test_plain_resid_and_jvp_match_pallas(built, state):
    jops, tops, pk, fk = built
    rng = np.random.default_rng(1)
    u = rough_state() if state == "rough" else wave_state()
    # active clamps (tangent masked): below, at and NaN against a floor
    u[0, 3, 5] = 0.5 * tops.rhomin
    u[0, 7, 2] = tops.rhomin
    u[1, 4, 4] = tops.Umin
    u[2, 1, 9] = np.nan
    u, v, b = f32(u, rng.standard_normal(u.shape),
                  rng.standard_normal(u.shape))
    ref = np.asarray(pk.jvp(jnp.asarray(u), jnp.asarray(v), 0.5))
    out = fk.jvp(*[torch.from_numpy(a) for a in (u, v)], 0.5)
    assert out.dtype == torch.float32 and np.isfinite(ref).all()
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    ref = np.asarray(pk.resid(*[jnp.asarray(a) for a in (u, v, b)], 0.5, 7.5))
    out = fk.resid(*[torch.from_numpy(a) for a in (u, v, b)], 0.5, 7.5)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("state,scale,oracle_tol", [
    ("rough", 100.0, 3e-6),
    ("wave", 1e-3, 1e-6),
    ("floor", None, 3e-6),
])
def test_plain_delta_matches_pallas_and_oracle(built, state, scale,
                                               oracle_tol):
    jops, tops, pk, fk = built
    rng = np.random.default_rng(3)
    u0 = jops.groom(jnp.asarray(wave_state() if state == "wave"
                                else rough_state()))
    if state == "floor":
        # a fifth of the points clamp to the floor (the big branch)
        drop = rng.random(u0.shape) < 0.2
        d = jnp.asarray(np.where(drop, -2.0 * np.asarray(u0),
                                 100.0 * rng.standard_normal(u0.shape)))
    else:
        d = jnp.asarray(scale * rng.standard_normal(u0.shape))
    ug = jops.groom(u0 + d)
    dd = ug - u0
    ref = np.asarray(pk.delta(u0, dd, ug, 0.5))
    out = fk.delta(*[torch.from_numpy(np.array(a)) for a in (u0, dd, ug)],
                   0.5).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    oracle = np.asarray(jops.rhs(ug, 0.5) - jops.rhs(u0, 0.5))
    for x in (out, ref):
        assert np.abs(x - oracle).max() / np.abs(oracle).max() < oracle_tol


def test_plain_path_counts_no_launch(built):
    _, _, _, fk = built
    u = torch.from_numpy(rough_state().astype(np.float32))
    before = {k: kk.launches for k, kk in fk.kernels.items()}
    fk.rhs(u, 0.0)
    fk.jvp(u, u, 0.0)
    fk.resid(u, u, u, 0.0, 1.0)
    fk.delta(u.double(), 0 * u.double(), u.double(), 0.0)
    assert {k: kk.launches for k, kk in fk.kernels.items()} == before


def test_wrapper_raises_on_other_devices(built):
    _, _, _, fk = built
    u = torch.empty((3, N, N), device="meta")
    with pytest.raises(ValueError, match="meta"):
        fk.kernels["rhs"](u, 0.0)
    with pytest.raises(ValueError, match="meta"):
        fk.jvp(u, u, 0.0)
    with pytest.raises(ValueError, match="meta"):
        fk.resid(u, u, u, 0.0, 1.0)
    with pytest.raises(ValueError, match="meta"):
        fk.delta(u, u, u, 0.0)


def test_build_raises_without_nvcc(built, monkeypatch, tmp_path):
    _, tops, _, _ = built
    monkeypatch.setattr(fused_stencil.shutil, "which", lambda name: None)
    monkeypatch.setattr(fused_stencil, "NVCC_DEFAULT",
                        str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(fused_stencil, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        make_fused_kernels(tops).build.library()
    assert not (tmp_path / "build").exists()


def test_header_is_single_precision(built):
    _, tops, _, _ = built
    text = pointwise_header(tops)
    assert "log1pf(" in text and "tanhf(" in text and "logf(" in text
    for word in ("double", "log(", "tanh(", "log1p(", "fmax("):
        assert word not in text.replace("log1pf(", "").replace(
            "logf(", "").replace("tanhf(", "").replace("fmaxf(", ""), word


_HOST_SHIM = r"""
#include <math.h>
#define __device__
#define __forceinline__ inline
#include "ksfd_pointwise.cuh"
extern "C" void eval_all(int n, const float* f, const float* d,
                         const float* s, float* G, float* dG, float* Gd) {
  for (int i = 0; i < n; ++i) {
    const float* fi = f + i * KSFD_DOF;
    G[i] = ksfd_G(fi, 0.0F);
    ksfd_dG(fi, 0.0F, dG + i * KSFD_DOF);
    Gd[i] = ksfd_G_delta(fi, d + i * KSFD_DOF, s + i * KSFD_DOF, 0.0F);
  }
}
"""


def test_generated_header_matches_torchify(built, tmp_path):
    """The generated header compiled as host C++ evaluates G, each
    dG_i and G_delta like the torchify'd float32 functions, to 1e-6 of
    each function's largest value within each group of points: big
    increments (the direct log difference), moderate ones, clamp-to-
    floor shifted states and small increments (where log1p matters)."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to compile the generated header")
    _, tops, _, _ = built
    (tmp_path / "ksfd_pointwise.cuh").write_text(pointwise_header(tops))
    (tmp_path / "shim.cpp").write_text(_HOST_SHIM)
    lib = tmp_path / "libshim.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(tmp_path), "-o", str(lib), str(tmp_path / "shim.cpp")],
                   check=True, capture_output=True)
    rng = np.random.default_rng(11)
    n = 800
    f = np.stack([300 + 25000 * rng.random(n), 30 + 25000 * rng.random(n),
                  3 + 2500 * rng.random(n)], axis=1)
    # point groups, each held to its own scale
    groups = dict(
        big=slice(0, 200),        # |d| >= a/2: the direct log difference
        moderate=slice(200, 400),
        floor=slice(400, 600),    # shifted state clamped to the floor
        small=slice(600, 800),    # |d| ~ 1e-5 a: where log1p matters
    )
    d = f * rng.uniform(-0.3, 0.3, size=f.shape)
    d[groups["big"]] = f[groups["big"]] * rng.uniform(0.5, 3.0, (200, 3))
    d[groups["small"]] = f[groups["small"]] * 1e-5 * rng.standard_normal(
        (200, 3))
    s = f + d
    s[400:500, 0] = tops.rhomin
    s[450:600, 1:] = tops.Umin
    d = s - f
    f, d, s = (np.ascontiguousarray(a, dtype=np.float32) for a in (f, d, s))
    G, Gd = np.empty(n, np.float32), np.empty(n, np.float32)
    dG = np.empty((n, 3), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    shim = ctypes.CDLL(str(lib))
    shim.eval_all.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
    shim.eval_all(n, ptr(f), ptr(d), ptr(s), ptr(G), ptr(dG), ptr(Gd))

    cols = lambda a: [torch.from_numpy(a[:, k].copy()) for k in range(3)]

    def close(out, ref):
        return all(
            np.abs(out[g] - ref[g]).max() <= 1e-6 * np.abs(ref[g]).max()
            for g in groups.values()
        )

    assert close(G, tops._G_fn(*cols(f), 0.0).numpy())
    for k, fn in enumerate(tops._dG_fns):
        assert close(dG[:, k], fn(*cols(f), 0.0).numpy()), k
    ref = tops._G_delta_fn(*cols(f), *cols(d), *cols(s), 0.0).numpy()
    assert np.isfinite(Gd).all() and np.isfinite(ref).all()
    assert close(Gd, ref)


def host_state(tops, shape, dof, seed=9):
    """A raw rough state with points below, at and NaN against the
    floors, and the kernels' arguments on it: jvp, resid and rhs on the
    raw state, delta on the groomed one with increments of scale 100."""
    rng = np.random.default_rng(seed)
    u = np.stack([6000 + s * np.abs(rng.standard_normal(shape))
                  for s in ((3000, 1000) + (500,) * (dof - 2))])
    u[0, 3, 5] = 0.5 * tops.rhomin
    u[0, shape[0] - 1, shape[1] - 1] = tops.rhomin
    u[1, 4, 4] = tops.Umin
    u[dof - 1, 1, shape[1] - 1] = np.nan
    raw = torch.from_numpy(u)
    u64 = tops.groom(raw)
    v = torch.from_numpy(rng.standard_normal(u.shape))
    b = torch.from_numpy(rng.standard_normal(u.shape))
    d = torch.from_numpy(100.0 * rng.standard_normal(u.shape))
    u1 = tops.groom(u64 + d)
    return dict(jvp=(raw, v, 0.5), resid=(raw, v, b, 0.5, 7.5),
                delta=(u64, u1 - u64, u1, 0.5), rhs=(raw, 0.5))


def host_problem(shape, dof):
    """The bench problem's port ops at ``shape`` with ``dof`` fields (3:
    __graft_entry__'s own parameters)."""
    clargs = (ge._make_problem(*shape)[0].clargs if dof == 3
              else bench_clargs(shape[0], dof))
    return problem_from_clargs(clargs, *shape, device="cpu")[2]


#: host cases of the 2D bodies: a grid of whole strips, one whose strip
#: and chunk are ragged, and strips and chunks of the march (40 rows: a
#: chunk of two 16-row steps and one of 8 rows; 256 columns: four
#: 64-column strips; 136: two and a ragged one of 8); with 2 to 6 fields
#: (6 the most the 2D build holds: B11's static tile; the rings pass 48
#: KB of shared memory, opted in, from 3 fields for rhs, 5 for delta and
#: 6 for jvp and resid)
HOST_CASES = [
    pytest.param((N, N), 3, id="shape0"),
    pytest.param((20, 36), 3, id="shape1"),
    pytest.param((40, 256), 3, id="strips"),
    pytest.param((40, 136), 2, id="dof2_strips"),
    pytest.param((40, 136), 4, id="dof4_strips"),
    pytest.param((40, 136), 5, id="dof5_strips"),
    pytest.param((40, 136), 6, id="dof6_strips"),
    pytest.param((20, 36), 2, id="dof2_ragged"),
    pytest.param((20, 36), 4, id="dof4_ragged"),
]


@pytest.mark.parametrize("shape,dof", HOST_CASES)
def test_cuda_source_bodies_match_plain(shape, dof, tmp_path):
    """The four march bodies of csrc/stencil2d.cu, compiled as host C++
    (KSFD_NT=1), equal the plain versions to 1e-5 of max|plain| on a
    grid of whole strips, on one whose strip and chunk are ragged (the
    periodic wrap and the bounds guards) and on strips and chunks of the
    march, with 2 to 6 fields; jvp, resid and rhs on a raw state with
    points below, at and NaN against the floors."""
    tops = host_problem(shape, dof)
    host = host_kernels(tops, tmp_path)
    if host is None:
        pytest.skip("no C++ compiler found to compile the kernel bodies")
    fk = make_fused_kernels(tops)
    for name, args in host_state(tops, shape, dof).items():
        k = fk.kernels[name]
        sc, operands = k.prepare(*args)
        out = host_run(host, name, sc, operands, shape, dof)
        ref = k.body(sc, operands)
        assert torch.isfinite(out).all(), name
        err = float((out - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)


@pytest.mark.parametrize("dof", [2, 3, 4, 5, 6])
def test_cuda_march_bodies_match_members(dof, tmp_path):
    """The march's member-batched build (members slowest in its 1D
    grid), compiled as host C++ with nb = 4, equals four single-member
    runs bit for bit (all four kernels, distinct states, t and shift),
    on strips (a ragged one) and chunks of the march, with 2 to 6
    fields."""
    shape = (40, 136)
    tops = host_problem(shape, dof)
    host = host_kernels(tops, tmp_path)
    if host is None:
        pytest.skip("no C++ compiler found to compile the kernel bodies")
    fk = make_fused_kernels(tops)
    per = [host_state(tops, shape, dof, seed=20 + i) for i in range(4)]
    for name in ("jvp", "resid", "delta", "rhs"):
        k = fk.kernels[name]
        prepared = []
        for i, args in enumerate(per):
            args = list(args[name])
            args[dict(jvp=2, resid=3, delta=3, rhs=1)[name]] = 0.1 * i
            if name == "resid":
                args[4] = 3.0 + i
            prepared.append(k.prepare(*args))
        sc_b = torch.stack([p[0] for p in prepared])
        ops_b = [torch.stack(xs) for xs in zip(*[p[1] for p in prepared])]
        out = host_run(host, name, sc_b, ops_b, shape, dof)
        for i, (sc, operands) in enumerate(prepared):
            single = host_run(host, name, sc, operands, shape, dof)
            assert torch.equal(out[i], single), (name, i)
            ref = k.body(sc, operands)
            assert float((single - ref).abs().max()) <= 1e-5 * float(
                ref.abs().max()), (name, i)


def test_probe_stencil2d_variants_follow_the_source(tmp_path):
    """tools/probe_stencil2d.py's variants are text edits of the march
    of csrc/stencil2d.cu: every anchor is found once, every variant
    differs from the source and compiles as host C++ (KSFD_NT=1),
    ``full``, the source itself, keeps all four kernels within 1e-5 of
    max|plain|, the design it checks like ``full`` (``centre_reads``)
    and the launch geometries it times (``--geometry``, one per policy)
    compute what ``full`` computes bit for bit (on a grid of several
    strips and chunks), and each variant that drops a part changes the
    kernels it drops it from (``no_output_reads``: resid only)."""
    from concurrent.futures import ThreadPoolExecutor

    from ksfd_tpu_torch.tools.probe_stencil2d import (
        KERNELS,
        SAME,
        geometry,
        variants,
    )

    src = fused_stencil.CSRC.read_text()
    out = variants(src)
    assert set(out) == {"full", "no_pointwise", "loads_only", "rows_only",
                        "no_output_reads", "centre_reads"}
    assert set(SAME) == {"full", "centre_reads"}
    assert out["full"] == src and len(set(out.values())) == len(out)
    for spec in ("Jvp=32,8,24,128,4,1", "Delta=128,1,8,256,2,3",
                 "Rhs=64,4,64,128,3,8"):
        gname, text = geometry(src, spec)
        assert text != src and gname not in out
        out[gname] = text
    assert {"jvp_32x8_lx24_128t_4b_r1", "delta_128x1_lx8_256t_2b_r3",
            "rhs_64x4_lx64_128t_3b_r8"} <= set(out)
    with pytest.raises(RuntimeError):
        geometry(src.replace("struct Delta {", "struct Box {"),
                 "Delta=32,8,24,128,4,1")
    shape = (40, 256)
    tops = host_problem(shape, 3)
    with ThreadPoolExecutor(len(out)) as pool:
        hosts = dict(zip(out, pool.map(
            lambda kv: host_kernels(tops, tmp_path / kv[0], source=kv[1]),
            out.items())))
    if hosts["full"] is None:
        pytest.skip("no C++ compiler found to compile the kernel bodies")
    fk = make_fused_kernels(tops)
    args = host_state(tops, shape, 3)
    runs = {}
    for variant, host in hosts.items():
        runs[variant] = {}
        for name in KERNELS:
            k = fk.kernels[name]
            sc, operands = k.prepare(*args[name])
            runs[variant][name] = host_run(host, name, sc, operands, shape, 3)
            if variant == "full":
                ref = k.body(sc, operands)
                assert float((runs["full"][name] - ref).abs().max()) <= \
                    1e-5 * float(ref.abs().max()), name
    for name in KERNELS:
        for same in [v for v in out if v not in variants(src) or v in SAME]:
            assert torch.equal(runs[same][name], runs["full"][name]), (
                same, name)
        for variant in ("no_pointwise", "loads_only", "rows_only"):
            assert not torch.equal(runs[variant][name], runs["full"][name])
        assert torch.equal(runs["no_output_reads"][name],
                           runs["full"][name]) == (name != "resid")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(built):
    """On a card: each CUDA kernel equals its plain version (1e-5 of
    the largest reference value) and counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    _, tops, _, fk = built
    rng = np.random.default_rng(5)
    to = lambda a: torch.as_tensor(a, device="cuda")
    u64 = tops.groom(to(rough_state()))
    u, v, b = u64.float(), to(rng.standard_normal(u64.shape)).float(), \
        to(rng.standard_normal(u64.shape)).float()
    d = to(100.0 * rng.standard_normal(u64.shape))
    u1 = tops.groom(u64 + d)
    cases = [(fk.jvp, (u, v, 0.5)), (fk.resid, (u, v, b, 0.5, 7.5)),
             (fk.delta, (u64, u1 - u64, u1, 0.5)),
             (fk.kernels["rhs"], (u, 0.5))]
    for k, args in cases:
        n0 = k.launches
        out, ref = k(*args), k.plain(*args)
        assert k.launches == n0 + 1
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
