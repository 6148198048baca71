"""The benchmark's frame: it finds a cell's configuration, traffic mix,
limits and per-layer readers by the names in ``BENCHMARK.json``, runs the
mix's driver, checks the card and the process, and prints the result.

A cell ``<config>.<mix>`` reads:

* ``portbench/configs/<config>.json``: the model's sizes;
* ``portbench/traffic/<mix>.json``: the mix's parameters, and under
  ``"driver"`` the module of ``portbench/drivers/`` that runs it;
* ``portbench/limits/<cell>.json``: the limit of each number the output
  check compares;
* ``portbench/metrics/<metric>.py`` for each per-layer metric the cell
  reports: ``read(reading) -> float | None``.

A driver's ``run(run)`` makes its inputs and weights from ``run.seed``,
warms up, measures for ``run.seconds`` seconds (traced with ``run.trace``),
checks the outputs and returns a :class:`Reading`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "subgc_tpu")


class Refused(SystemExit):
    """The run cannot give a result; the message goes to standard error."""

    def __init__(self, msg: str, code: int = 3):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)
        super().__init__(code)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Reading:
    """What a driver returns.  ``end_to_end``: each end-to-end metric's
    value; ``checks``: each compared number; ``layers``: what the per-layer
    readers read (spans, counts, the trace); ``device``: extra keys of the
    result's ``device`` (busy_s, window_s in a traced run)."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, float]
    memory_peak_bytes: int
    layers: dict = dataclasses.field(default_factory=dict)
    device: dict = dataclasses.field(default_factory=dict)
    breakdown: Optional[dict] = None


class Run:
    """One run of one cell: its files, its arguments and its set-up clock."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float,
                 trace: bool, device="cuda", t_start=None, config=None,
                 traffic=None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise Refused(f"no workload {workload!r} in BENCHMARK.json")
        self.bench = bench
        self.cell = cells[workload]
        self.name = workload
        self.cfg = config or _load_json(
            os.path.join(HERE, "configs", self.cell["config"] + ".json"))
        self.traffic = traffic or _load_json(
            os.path.join(HERE, "traffic", self.cell["traffic"] + ".json"))
        self.limits = _load_json(os.path.join(HERE, "limits",
                                              workload + ".json"))
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name):
        """Time one part of the set-up (waits for the card at its end)."""
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.phases[name] = self.phases.get(name, 0.0) + \
            time.perf_counter() - t0

    def log(self, msg):
        print(msg, flush=True)

    def reports(self, metric: dict) -> bool:
        """Whether this cell reports ``metric`` (an entry of
        BENCHMARK.json)."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if metric in self.bench["end_to_end"]:
            return True
        moved = {m["name"]: m for m in self.bench["end_to_end"]}
        return self.reports(moved[metric["moves"]])


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def read_layer_metric(name: str, layers: dict):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(layers)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def execute(run: Run) -> dict:
    """Run the cell's driver and assemble the result line's object."""
    driver = importlib.import_module(
        "portbench.drivers." + run.traffic["driver"])
    reading: Reading = driver.run(run)
    found = forbidden_modules()
    if found:
        raise Refused("the process imported " + ", ".join(found)
                      + ": the benchmark measures the port alone")
    import torch
    if run.trace:
        metrics = {}
        for m in run.bench["per_layer"]:
            if not run.reports(m):
                continue
            value = read_layer_metric(m["name"], reading.layers)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": reading.end_to_end[m["name"]],
                               "unit": m["unit"]}
                   for m in run.bench["end_to_end"] if run.reports(m)}
    dev = torch.device(run.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                       else "cpu"),
              "count": run.cell["chips"],
              "memory_peak_bytes": int(reading.memory_peak_bytes)}
    device.update(reading.device)
    checks = {}
    for k, v in reading.checks.items():
        if k not in run.limits:
            raise Refused(f"no limit for the number {k!r} in "
                          f"portbench/limits/{run.name}.json")
        checks[k] = {"value": v, "limit": run.limits[k]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": reading.attempted,
           "failed": reading.failed, "metrics": metrics, "device": device}
    if run.trace and reading.breakdown:
        out["breakdown"] = reading.breakdown
    out["checks"] = checks
    return out


def main(argv=None, t_start=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = _load_json(os.path.join(ROOT, "BENCHMARK.json"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, ".portbench_cache",
                                                 "nv")
    import torch
    run = Run(bench, args.workload, args.seed, args.seconds,
              bool(args.trace), t_start=t_start)
    chips = run.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA device(s); "
                      f"{torch.cuda.device_count()} found")
    # float32 as the configuration states it: TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run.log(f"card: {card_line()}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
    out = execute(run)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
