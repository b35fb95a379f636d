"""The benchmark of ksfd_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of BENCHMARK.json: it builds the cell's configuration
through the program (set-up: parse, sympy, the problem, the kernel
libraries, the start state, one warm episode or call), measures for
``--seconds`` (whole episodes, the last one finished), with ``--trace
1`` profiles a short stretch after that, then checks a sample of the
window's calls against the plain reference (bench_check.py) and
prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared`` (each number of the check beside its limit, also the last
lines on standard error).

Everything of one cell is found by its name: ``workloads/<cell>.json``
(configuration, runner kind, traffic parameters, limits),
``configs/<config>.json``, ``runners/<kind>.py`` and one reader per
metric, ``metrics/<metric>.py``.  Without a CUDA card, or with fewer
than the cell's chips, it exits with status 2 and prints no result;
if a JAX module or the JAX package is loaded once the window has
closed, status 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "ksfd_tpu")


def _caches():
    """Every build and kernel cache at a fixed path inside the
    checkout."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _metric_reader(name):
    path = HERE / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _err(line):
    print(line, file=sys.stderr, flush=True)


def run_cell(name, seed, seconds, trace, device="cuda", n=None, fault=None,
             overrides=None, cell=None, t_start=None, out=_err):
    """Run cell ``name`` and return its result dict (None where a
    forbidden module is loaded).  ``n`` (the grid per axis), ``fault``
    (planted in the program's results, bench_record.plant),
    ``overrides`` (of the workload's traffic parameters) and ``cell`` (an ``(entry, workload, config)`` in place
    of the files of ``name``) are for tests on the CPU only."""
    import torch

    from bench_cells import cell_metrics, config_params, load_cell
    from bench_check import judge
    from bench_trace import Tracer

    t_start = T_START if t_start is None else t_start
    entry, wl, cfg = cell or load_cell(name, overrides)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    kind = importlib.import_module("runners." + wl["kind"])
    drv = kind.Runner(wl, cfg, seed, dev, n=n, fault=fault)
    drv.timings["start"] = round(time.perf_counter() - t_start, 3)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    out("set-up %.3f s: %s" % (setup_s, json.dumps(drv.timings)))
    window = drv.window(float(seconds))
    out("window %s" % json.dumps(window, default=float))
    laps = sorted(getattr(drv, "laps", []))
    if laps:
        out("laps (episodes or calls): %d, s min %.4f median %.4f max %.4f"
            % (len(laps), laps[0], laps[len(laps) // 2], laps[-1]))
    traced = None
    if trace:
        tracer = Tracer(dev)
        stretch = drv.stretch(tracer)
        traced = tracer.result()
        if traced is not None:
            traced.update(stretch)
            out("traced %.6f s busy of %.6f s" % (traced["busy_s"],
                                                  traced["window_s"]))
    peak = 0
    if dev.type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(dev),
                   getattr(drv, "setup_peak", 0))
    bad = forbidden_modules()
    if bad:
        out("forbidden modules loaded: %s" % ", ".join(bad))
        return None
    samples, decisions = drv.samples(), drv.decisions()
    ctx = dict(kind=wl["kind"], setup_s=setup_s, window=window,
               trace=traced, fields=int(drv.ops.grid.dof),
               points=int(drv.ops.grid.nps.prod()),
               members=getattr(drv, "members", 1),
               numerics=drv.numerics, wl=wl)
    drv.release()
    t_check = time.perf_counter()
    correct, compared = judge(samples, decisions, config_params(cfg, drv.n),
                              drv.n, wl["limits"], dev, out)
    out("check %.3f s" % (time.perf_counter() - t_check))
    metrics = {}
    for m in cell_metrics(name, trace):
        val = _metric_reader(m["name"])(ctx)
        if val is not None:
            metrics[m["name"]] = dict(value=float(val), unit=m["unit"])
    res = dict(correct=correct,
               attempted=int(window.get("attempts", window.get("steps", 0))),
               failed=int(window.get("host_retries", 0)), metrics=metrics)
    res["device"] = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"),
        count=int(entry["chips"]), memory_peak_bytes=int(peak))
    if traced is not None:
        res["device"].update(busy_s=traced["busy_s"],
                             window_s=traced["window_s"])
        res["breakdown"] = dict(device_ops=traced["device_ops"],
                                idle_gaps=traced["idle_gaps"])
    for key, c in compared.items():
        out("%s %r limit %r" % (key, c["value"], c["limit"]))
    res["compared"] = compared
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    from bench_cells import load_cell

    entry, _, _ = load_cell(args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(entry["chips"])):
        _err("no CUDA card, or fewer than the %d the cell asks for: "
             "nothing measured" % int(entry["chips"]))
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, args.trace)
    if res is None:
        return 3
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
