"""One run of one cell: ``python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

Everything that belongs to one cell is found by name from ``BENCHMARK.json``:

- the configuration ``cardbench/configs/<config>.json``, whose ``kind``
  names the builder and reference in ``cardbench/kinds/<kind>.py``;
- the traffic ``cardbench/traffic/<traffic>.json``, whose ``driver``
  (``cardbench/drivers/<driver>.py``) runs the window and whose
  ``generator`` (``cardbench/generators.py``) makes the inputs;
- the limits of the comparison ``cardbench/limits/<cell>.json``;
- each per-layer metric's reader ``cardbench/layer_metrics/<metric>.py``.

The run checks for the cards first and prints nothing but an error without
them.  It keeps the program's build and kernel caches inside the checkout,
and it fails, printing no result, if JAX or the JAX package was imported.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "torch_rechub_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/cache/triton", "TORCH_EXTENSIONS_DIR": "build/cache/torch_extensions"}


class Refused(SystemExit):
    """A run that cannot give a result: the message goes to standard error, the exit code is 2."""

    def __init__(self, message: str):
        print(f"cardbench: {message}", file=sys.stderr)
        super().__init__(2)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise Refused(f"no workload {name!r} in BENCHMARK.json")


def set_cache_dirs() -> None:
    """Every build and kernel cache of the run at a fixed path inside the checkout."""
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"


def pin_cpus() -> None:
    """Keeps the run's threads on two CPUs, the same two every run, before any thread starts: in one call
    three host-bound DeepFM runs spread 20% left to the scheduler and 2% on two fixed CPUs (``PERF.md``)."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 4:
        os.sched_setaffinity(0, cpus[2:4])


def check_cards(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")
    torch.set_num_threads(1)  # one host thread: the host only launches, and idle pools add noise
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state float32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def layer_metric(name: str):
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench.layer_metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reported(metrics: list, workload: dict) -> list:
    """The metrics of ``metrics`` this cell reports: those whose ``workloads`` list it (``setup_s``, with no list, everywhere)."""
    return [m for m in metrics if workload["name"] in m.get("workloads", [workload["name"]])]


def resolve(workload_name: str, overrides: dict = None):
    """The cell, its configuration, traffic, kind and driver modules, and its limits."""
    bench = load_json(ROOT / "BENCHMARK.json")
    workload = cell(workload_name, bench)
    cfg = {**load_json(HERE / "configs" / f"{workload['config']}.json"), **(overrides or {}).get("config", {})}
    traffic = {**load_json(HERE / "traffic" / f"{workload['traffic']}.json"), **(overrides or {}).get("traffic", {})}
    limits = load_json(HERE / "limits" / f"{workload['name']}.json")["limits"]
    kind = importlib.import_module(f"cardbench.kinds.{cfg['kind']}")
    driver = importlib.import_module(f"cardbench.drivers.{traffic['driver']}")
    return SimpleNamespace(bench=bench, workload=workload, cfg=cfg, traffic=traffic, limits=limits, kind=kind, driver=driver)


def run(args, t0: float, device=None, overrides: dict = None, fault=None) -> dict:
    """One run; returns the result line's object.  ``device``, ``overrides`` and ``fault`` serve the tests."""
    import torch

    set_cache_dirs()
    c = resolve(args.workload, overrides)
    if device is None:
        pin_cpus()
        device = check_cards(c.workload["chips"])
    out = c.driver.run(c, args.seed, args.seconds, bool(args.trace), device, t0, fault=fault, overrides=overrides)
    correct = bool(out["correct"])
    e2e = {m["name"]: m for m in c.bench["end_to_end"]}
    if args.trace:
        ctx = SimpleNamespace(trace=out["trace"], cfg=c.cfg, traffic=c.traffic, window=out["window"], traced_work=out["traced_work"], chips=c.workload["chips"])
        metrics = {}
        for m in reported(c.bench["per_layer"], c.workload):
            value = layer_metric(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {n: {"value": v, "unit": e2e[n]["unit"]} for n, v in out["end_to_end"].items() if n in {m["name"] for m in reported(c.bench["end_to_end"], c.workload)}}
    on_card = device.type == "cuda"
    result = {
        "correct": correct,
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": c.workload["chips"] if on_card else 1,
            "memory_peak_bytes": out["memory_peak_bytes"],
            "power_limit": power_limit() if on_card else "not measured",
        },
    }
    if args.trace:
        t = out["trace"]
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
    result["checks"] = {n: {"value": out["checks"][n], "limit": lim["limit"]} for n, lim in c.limits.items()}
    return result


def report(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of standard error, then the result line."""
    found = forbidden_modules()
    if found:
        print(f"cardbench: the run imported {', '.join(found)}; the benchmark runs the port only", file=sys.stderr)
        raise SystemExit(3)
    for name, chk in result["checks"].items():
        print(f"check {name}: {chk['value']!r} (limit {chk['limit']!r})", file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result)), flush=True)


def finite(x):
    """``x`` with every non-finite float written as a string ("inf", "nan"), so that the line stays JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and (x != x or x in (float("inf"), float("-inf"))):
        return repr(x)
    return x
