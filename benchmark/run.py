"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything is found by name from
`BENCHMARK.json`: the cell's configuration file, its traffic file
`benchmark/traffic/<traffic>.json`, the driver that the traffic names
(`benchmark/drivers/<driver>.py`), the limits of the comparison that
decides `correct` (`benchmark/limits/<workload>.json`) and, with
`--trace 1`, one reader per per-layer metric (`benchmark/metrics/<name>.py`,
a function `read(ctx)` that returns the number or None when it finds
nothing to read).

The run needs as many CUDA cards as the cell asks for, and exits with 2
and prints no result without them, as it does when `jax`, `jaxlib`,
`flax` or the JAX package is loaded once the window has closed. The last
line of standard output is the result; the last lines of standard error
give each number compared beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "binocular3dgs_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finite_or_null(x):
    """`x` with every non-finite float replaced by None (JSON has no NaN)."""
    if isinstance(x, dict):
        return {k: finite_or_null(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite_or_null(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(workload: str) -> tuple[dict, dict, dict, dict]:
    """(the BENCHMARK.json entry of the cell, its configuration, its traffic,
    the whole BENCHMARK.json)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return entry, load_json(ROOT, conf["file"]), load_json(HERE, "traffic",
                                                           entry["traffic"] + ".json"), bench


def read_metric(name: str, ctx: dict):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  os.path.join(HERE, "metrics", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def per_layer(bench: dict, workload: str, ctx: dict) -> dict:
    out = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = read_metric(m["name"], ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device) -> dict:
    """The result of one run of `workload` on `device`, before the checks of
    the environment; the tests call it on the CPU at a small size."""
    from . import compare

    entry, config, traffic, bench = cell(workload)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    res = driver.run(config, traffic, seed, seconds, trace, device, T_START, log=log)
    ok, checks = compare.judge(res["numbers"], compare.load_limits(
        os.path.join(HERE, "limits", workload + ".json")))
    if trace:
        metrics = per_layer(bench, workload, res["ctx"])
    else:
        values = {"train_it_s": res["train_it_s"], "setup_s": res["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    return dict(correct=ok and res["failed"] == 0, attempted=res["attempted"],
                failed=res["failed"], metrics=metrics, res=res, checks=checks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        raise SystemExit("--seed is a non-negative whole number")

    entry = cell(args.workload)[0]
    # one host compute thread, set before torch is imported: the cells are
    # host bound, and idle worker threads spinning beside the dispatching
    # thread slow it by different amounts from run to run
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"the cell needs {entry['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        log(f"loaded in the result's process: {', '.join(found)}")
        return 2
    res = out["res"]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
           "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": dev}
    if args.trace:
        tr = res["ctx"]["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(finite_or_null(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
