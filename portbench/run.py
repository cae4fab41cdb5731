"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It measures ``bundlesdf_tpu_torch`` on the CUDA card it is started on.  A
run sets up (builds the cell's inputs from the seed, builds the program's
objects, warms every shape the window uses), measures for ``--seconds``,
with ``--trace 1`` profiles a short slice after the window, checks what
the timed path produced against the plain reference (``reference/``),
and prints one JSON line last on standard output.  The numbers it
compared, each with its limit, are the last lines of standard error and
the last key of that line.

Everything is found by name, so that a configuration, a cell or a metric
is added with files and ``BENCHMARK.json`` entries alone:

- ``BENCHMARK.json`` (the checkout's root): the cell's configuration,
  traffic and metrics (an entry with ``workloads`` is reported in those
  cells, one without in every cell that reports what it moves);
- ``portbench/workloads/<cell>.json``: the cell's configuration, traffic
  and driver, and the limits of its comparison;
- ``portbench/traffic/<traffic>.json``: the traffic's parameters, read by
  the video generator (``video.py``) and the driver;
- ``portbench/configs/<config>.json`` (the configuration's ``file``): the
  program's configs as they are run;
- ``portbench/drivers/<driver>.py``: its ``Cell(ctx)`` sets up, and has
  ``window(seconds)``, ``traced_slice()`` and ``verify()``;
- ``portbench/metrics/<metric>.py``: its ``read(run)`` gives the metric,
  or None where the run has nothing for it to read.

It exits with 1, printing no result, without a CUDA card or with fewer
cards than the cell asks for, and when the run loaded JAX or the JAX
package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# the checkout's root, not this folder, on the path: the program and this
# package import from there, and a module here would shadow a standard one
sys.path[:] = [ROOT] + [q for q in sys.path if os.path.abspath(q or ".") != BENCH_DIR]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def plan(cell: str, root: str = ROOT) -> dict:
    """Everything a run of ``cell`` needs, found by name: its entry, its
    configuration's entry and file, its workload file, its metrics."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    work = load_json(os.path.join(root, "portbench", "workloads", f"{cell}.json"))
    if (work["config"], work["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{cell}: BENCHMARK.json names ({entry['config']}, "
                         f"{entry['traffic']}), its workload file ({work['config']}, "
                         f"{work['traffic']})")
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"cell": cell, "entry": entry, "config": load_json(os.path.join(root, config["file"])),
            "workload": work,
            "traffic": load_json(os.path.join(root, "portbench", "traffic",
                                              f"{work['traffic']}.json")),
            "end_to_end": e2e, "per_layer": per_layer,
            "metrics_dir": os.path.join(root, "portbench", "metrics")}


def read_metrics(p: dict, run: dict, which: str) -> dict:
    """Each of the cell's ``which`` metrics that its reader finds, with its
    unit."""
    out = {}
    for m in p[which]:
        reader = _load_module(os.path.join(p["metrics_dir"], f"{m['name']}.py"),
                              f"portbench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(p: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set up, measure, trace and check one run; returns the result line's
    object (the caller checks the card and the imports)."""
    import torch

    from portbench import trace as trace_mod

    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        driver = importlib.import_module(f"portbench.drivers.{p['workload']['driver']}")
        ctx = types.SimpleNamespace(config=p["config"], traffic=p["traffic"],
                                    limits=p["workload"]["limits"], seed=seed,
                                    device=torch.device(device), tmp=tmp)
        cell = driver.Cell(ctx)
        cuda = ctx.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        record = cell.window(seconds)
        run = {"cfg": p["config"], "traffic": ctx.traffic, "record": record,
               "setup_s": setup_s, "trace": None}
        if trace:
            run["trace"] = trace_mod.run_traced(cell.traced_slice)
        peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
        checks = cell.verify()
        cell = None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    metrics = read_metrics(p, run, "per_layer" if trace else "end_to_end")
    correct = all(c["value"] <= c["limit"] for c in checks)
    out = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": peak}}
    if trace:
        out["device"].update(busy_s=run["trace"]["busy_s"], window_s=run["trace"]["window_s"])
        out["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                            "idle_gaps": run["trace"]["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    if record.get("failed_ids"):
        print(f"portbench: FAIL frames (session, frame): {record['failed_ids']}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = os.path.join(ROOT, "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    p = plan(args.workload)
    chips = int(p["entry"]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 1
    from portbench import guard

    out = run_cell(p, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = guard.forbidden_modules()
    if found:
        print("portbench: the run loaded JAX or the JAX package: " + ", ".join(found),
              file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
