"""The harness: finds a cell's files by name, runs its traffic generator,
reads the per-layer metrics and assembles the result line.

Everything a cell needs comes from files named after it:

  BENCHMARK.json             the cell's configuration, traffic and metrics
  configs/<config>.json      widths, dtype, cuts; its ``family`` names
  models/<family>.py            the port's model and the reference's loss
                                (bench/models/__init__.py), and its
                                ``graph_generator`` names
  gen/<graph_generator>.py      the graph's generator
  traffic/<traffic>.json     the mix's parameters; its ``generator`` names
  traffic/<generator>.py        the code that drives the port (``run(run)``)
  workloads/<cell>.json      the limits of the numbers that decide ``correct``
  metrics/<metric>.py        one reader per per-layer metric (``read(r)``)

A generator builds the system under test from the seed, runs its first
steps, measures inside `Run.traced` and returns an `Outcome`; the
harness never imports the port itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from bench import check, peaks, trace as trace_mod

BENCH = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


# ----------------------------------------------------------- the cell
@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, float]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]
    return Cell(
        name=name,
        config=json.loads((BENCH / "configs" / f"{entry['config']}.json").read_text()),
        mix=json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text()),
        chips=int(entry["chips"]),
        end_to_end=e2e,
        per_layer=layer,
        limits=check.load_limits(BENCH / "workloads" / f"{name}.json"),
    )


def load_by_path(path: Path):
    """Import one file of the benchmark as a module (names may hold dots)."""
    name = f"bench_{path.parent.name}_" + path.stem.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def prepare_env(workdir: Path, trace: bool) -> None:
    """The port's settings for a run, before the port is imported: no
    AUTOSAGE_* setting leaks in from outside; host spans are recorded
    only in traced runs, and whatever the port writes goes under
    ``workdir``. The kernels' build cache stays where kernels/build.py
    fixes it, inside the checkout."""
    for key in [k for k in os.environ if k.startswith("AUTOSAGE_")]:
        del os.environ[key]
    os.environ["AUTOSAGE_CACHE"] = str(workdir / "schedule_cache.json")
    os.environ["AUTOSAGE_OBS_DIR"] = str(workdir / "obs")
    if trace:
        os.environ["AUTOSAGE_OBS"] = "1"


def workdir_for(cell: str) -> Path:
    """A fresh directory for one run's state, under TMPDIR."""
    d = Path(tempfile.gettempdir()) / "autosage-bench" / cell
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


# -------------------------------------------------------- the window
def _hist_snapshot() -> Dict[str, Dict[tuple, tuple]]:
    from repro_torch.core import obs

    out = {}
    for name in obs.REGISTRY.to_dict()["histograms"]:
        out[name] = {lk: (h.count, h.sum) for lk, h in obs.REGISTRY.hist_series(name).items()}
    return out


@dataclasses.dataclass
class HistDelta:
    """The observations a histogram took inside the window."""

    count: int
    sum: float


@dataclasses.dataclass
class Window:
    """What happened inside the measured window."""

    steps: int = 0
    failed: int = 0
    t_start: float = 0.0
    t_end: float = 0.0
    trace: Optional[trace_mod.Trace] = None
    spans: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    hists_before: Dict = dataclasses.field(default_factory=dict)
    hists_after: Dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    def hist_delta(self, name: str, **labels: Any) -> HistDelta:
        """The window's observations of histogram ``name``, summed over
        the label sets that match ``labels``."""
        want = {k: str(v) for k, v in labels.items()}
        out = HistDelta(0, 0.0)
        for lk, (count, total) in self.hists_after.get(name, {}).items():
            if any(dict(lk).get(k) != v for k, v in want.items()):
                continue
            n0, s0 = self.hists_before.get(name, {}).get(lk, (0, 0.0))
            out = HistDelta(out.count + count - n0, out.sum + total - s0)
        return out


def _window_spans(workdir: Path, t0: float, t1: float) -> List[Dict[str, Any]]:
    from repro_torch.core import obs

    paths = obs.flush(str(workdir / "obs"))
    if "spans" not in paths:
        return []
    spans = [json.loads(line) for line in Path(paths["spans"]).read_text().splitlines() if line]
    return sorted((s for s in spans if t0 <= s["t_mono"] <= t1), key=lambda s: s["t_mono"])


class Run:
    """One run of a cell, handed to its traffic generator."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, t0: float, workdir: Path):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.t0, self.workdir = device, t0, workdir
        self.window: Optional[Window] = None

    @property
    def setup_s(self) -> float:
        return self.window.t_start - self.t0

    @contextlib.contextmanager
    def traced(self) -> Iterator[Window]:
        """The measured window: set-up ends where it begins. In a traced
        run the profiler records the device timeline and the port's host
        spans are collected; the port's histograms are read on both sides."""
        w = self.window = Window(hists_before=_hist_snapshot())
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            from bench import annotate

            annotate.install()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
        w.t_start = time.perf_counter()
        try:
            with torch.profiler.record_function(trace_mod.WINDOW):
                yield w
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            w.t_end = time.perf_counter()
        finally:
            if prof is not None:
                prof.stop()
        w.hists_after = _hist_snapshot()
        if prof is not None:
            path = self.workdir / "profile.json"
            prof.export_chrome_trace(str(path))
            w.trace = trace_mod.load_chrome_trace(path)
            path.unlink()
            w.spans = _window_spans(self.workdir, w.t_start, w.t_end)

    def loop(self, step: Callable[[], bool]) -> Window:
        """A closed loop: ``step()`` (True when it succeeded) again and
        again until ``seconds`` have passed; every step ends synchronised."""
        times = []
        with self.traced() as w:
            while True:
                t = time.perf_counter()
                w.failed += 0 if step() else 1
                w.steps += 1
                times.append(time.perf_counter() - t)
                if time.perf_counter() - w.t_start >= self.seconds:
                    break
        times.sort()
        print(f"window: {w.steps} steps, ms min {times[0] * 1e3:.1f} median "
              f"{times[len(times) // 2] * 1e3:.1f} max {times[-1] * 1e3:.1f}; {host_memory()}",
              file=sys.stderr)
        return w


@dataclasses.dataclass
class Outcome:
    """What a traffic generator reports: end-to-end values by metric name, the
    requests or steps attempted and failed, the numbers compared with
    the reference, the peak device memory and the work model its
    metric readers use."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    memory_peak_bytes: int
    work: Dict[str, Any]


# ---------------------------------------------------------- readings
@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader may read."""

    cell: Cell
    window: Window
    work: Dict[str, Any]
    peaks: Optional[Dict[str, float]]

    @property
    def steps(self) -> int:
        return self.window.steps


def read_per_layer(cell: Cell, reading: Reading) -> Dict[str, Dict[str, Any]]:
    """Each of the cell's per-layer metrics that its reader found."""
    out = {}
    for m in cell.per_layer:
        value = load_by_path(BENCH / "metrics" / f"{m['name']}.py").read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def host_memory() -> str:
    """This process's resident host memory now and at its peak (Linux's
    VmRSS and VmHWM), for the stderr lines of each phase."""
    fields = {}
    with contextlib.suppress(OSError):
        for line in Path("/proc/self/status").read_text().splitlines():
            key, _, value = line.partition(":")
            if key in ("VmRSS", "VmHWM"):
                fields[key] = int(value.split()[0]) / 2**20
    return (f"host rss {fields.get('VmRSS', float('nan')):.2f} GiB, "
            f"peak {fields.get('VmHWM', float('nan')):.2f} GiB")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float, workdir: Path) -> Dict[str, Any]:
    """Drive one run and return its result object (without printing)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state fp32
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, seed, seconds, trace, device, t0, workdir)
    generator = load_by_path(BENCH / "traffic" / f"{cell.mix['generator']}.py")
    outcome: Outcome = generator.run(run)
    w = run.window
    correct = outcome.failed == 0 and check.judge(outcome.numbers, cell.limits)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    dev: Dict[str, Any] = {"platform": "gpu" if device.type == "cuda" else device.type,
                           "kind": name, "count": 1,
                           "memory_peak_bytes": int(outcome.memory_peak_bytes),
                           "power_limit_w": power_limit_w() if device.type == "cuda" else None}
    result: Dict[str, Any] = {"correct": bool(correct), "attempted": outcome.attempted,
                              "failed": outcome.failed}
    if trace:
        result["metrics"] = read_per_layer(cell, Reading(cell, w, outcome.work, peaks.peaks_for(name)))
        dev["busy_s"] = trace_mod.busy_s(w.trace)
        dev["window_s"] = w.trace.window_s
        result["device"] = dev
        result["breakdown"] = trace_mod.breakdown(w.trace)
    else:
        values = {"setup_s": run.setup_s, **outcome.end_to_end}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in values}
        result["device"] = dev
    result["checks"] = {k: {"value": outcome.numbers.get(k), "limit": lim}
                        for k, lim in cell.limits.items()}
    return result
