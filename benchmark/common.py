"""What every traffic kind of the benchmark shares: the cell's files found
by name, the device's description, seeds, the host clock of the process,
spans, the reading of a profiler trace, and the result line.

Nothing here imports the port; the kinds under `traffic/` do."""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
SPEC = REPO / "BENCHMARK.json"
# modules that may not be loaded in the process that prints the result
# (top-level names, compared whole: the port's name begins with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "embodied_object_detection_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file `path` as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell(dict):
    """One cell, found by name: its entry of BENCHMARK.json, its
    configuration file, its traffic mix file and its own file of
    checks."""

    @property
    def config(self) -> dict:
        return self["config_file"]

    @property
    def traffic(self) -> dict:
        return self["traffic_file"]


def find_cell(name: str, spec: Optional[dict] = None,
              bench: Path = BENCH) -> Cell:
    spec = spec if spec is not None else load_json(SPEC)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    cell = Cell(entry)
    cell["config_file"] = load_json(REPO / conf["file"]) \
        if not Path(conf["file"]).is_absolute() else load_json(conf["file"])
    cell["traffic_file"] = load_json(bench / "traffic" /
                                     f"{entry['traffic']}.json")
    cell["checks_file"] = load_json(bench / "workloads" / f"{name}.json")
    cell["end_to_end"] = [m for m in spec["end_to_end"]
                          if name in m.get("workloads", [name])]
    cell["per_layer"] = [m for m in spec["per_layer"]
                         if name in m.get("workloads", [name])]
    return cell


def miniature(cell: Cell) -> Cell:
    """The cell cut to the CPU rehearsal's miniature (tests/miniature.json),
    in place."""
    mini = load_json(BENCH / "tests" / "miniature.json")
    cell["config_file"] = dict(cell.config, overrides={
        **cell.config["overrides"], **mini["overrides"]})
    cell["traffic_file"] = {**cell.traffic,
                            **mini["traffic"][cell.traffic["kind"]]}
    return cell


def traffic_kind(cell: Cell):
    """The module of the cell's traffic kind: traffic/<kind>.py."""
    return importlib.import_module(f"benchmark.traffic.{cell.traffic['kind']}")


def metric_reader(name: str, bench: Path = BENCH):
    """metrics/<name>.py's `read(trace) -> value or None`."""
    return load_module(bench / "metrics" / f"{name}.py",
                       "benchmark_metric_" + re.sub(r"\W", "_", name)).read


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for (seed, tags): any whole seed, large ones too."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a torch.Generator from (seed, tags)."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(
        1, dtype=np.uint64)[0] >> np.uint64(1))


def process_age_s() -> float:
    """Seconds since this process started (its start time in
    /proc/self/stat against the system's uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def smi(query: str) -> str:
    """One `nvidia-smi --query-gpu` reading of card 0 (empty if it fails)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return (out.stdout.strip().splitlines() or [""])[0]


def require_cards(count: int) -> None:
    """Exit (code 2, no result) unless `count` CUDA cards are there."""
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < count:
        print(f"the cell needs {count} cards, {torch.cuda.device_count()} "
              f"found", file=sys.stderr)
        sys.exit(2)


def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def device_info(count: int, device: str = "cuda") -> dict:
    """The result's `device`; a rehearsal on the CPU says so and claims no
    card."""
    import torch
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu rehearsal", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The FORBIDDEN top-level names among `names` (default: the loaded
    modules), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@contextlib.contextmanager
def span(name: str, clock: Dict[str, float], traced: bool):
    """Host time of the block added to clock[name]; in a traced run also a
    profiler range named bench.<name>."""
    t0 = time.perf_counter()
    if traced:
        import torch
        with torch.profiler.record_function(f"bench.{name}"):
            yield
    else:
        yield
    clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0


# ------------------------------------------------------------ the trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_name(key: str) -> str:
    """A kernel's name without its namespace, template or arguments."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", key)
    return m.group(1) if m else key[:80]


def profile(fn, device: str = "cuda"):
    """Run fn() under torch.profiler (host and device); returns (fn's
    result, the chrome trace's events). The trace file is written to the
    run's temporary directory and removed."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, events


class Trace:
    """A chrome trace's device work, with each device op tied to the host
    ranges its launch lies in."""

    def __init__(self, events: List[dict]):
        self.events = events
        launch_at = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "cuda_runtime":
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_at[corr] = (e["tid"], e["ts"])
        self.device = []        # (start, end, name, cat, launch (tid, ts))
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                corr = e.get("args", {}).get("correlation")
                self.device.append((e["ts"], e["ts"] + e["dur"],
                                    e["name"], e["cat"],
                                    launch_at.get(corr)))
        self.device.sort()

    def ranges(self, pattern: str, cats=("user_annotation", "cpu_op",
                                         "python_function")):
        """[(tid, start, end, name)] of the host ranges whose name matches
        `pattern` (re.match)."""
        rx = re.compile(pattern)
        return [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"])
                for e in self.events
                if e.get("ph") == "X" and e.get("cat") in cats and
                rx.match(e.get("name", ""))]

    def window(self, name: str = "bench.unit") -> Tuple[float, float]:
        r = self.ranges(re.escape(name) + "$", ("user_annotation",))
        return min(x[1] for x in r), max(x[2] for x in r)

    def launched_in(self, ranges) -> List[Tuple[tuple, tuple]]:
        """[(device op, range)] of the device ops launched inside one of
        `ranges` (ranges of one kind do not nest on a thread)."""
        by_tid = collections.defaultdict(list)
        for r in ranges:
            by_tid[r[0]].append(r)
        index = {}
        for tid, rs in by_tid.items():
            rs.sort(key=lambda r: r[1])
            index[tid] = ([r[1] for r in rs], rs)
        out = []
        for op in self.device:
            launch = op[4]
            if launch is None or launch[0] not in index:
                continue
            starts, rs = index[launch[0]]
            i = bisect.bisect_right(starts, launch[1]) - 1
            if i >= 0 and rs[i][2] >= launch[1]:
                out.append((op, rs[i]))
        return out

    def device_s_in(self, pattern: str) -> float:
        return sum(op[1] - op[0] for op, _ in
                   self.launched_in(self.ranges(pattern))) / 1e6

    def kernels_in(self, lo: float, hi: float) -> int:
        return sum(1 for op in self.device
                   if op[3] == "kernel" and lo <= op[0] < hi)

    def busy_s(self, lo: float, hi: float) -> float:
        """Seconds in [lo, hi] (trace us) in which a device op ran."""
        busy, cur = 0.0, None
        for s, e, *_ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        if cur is not None:
            busy += cur[1] - cur[0]
        return busy / 1e6

    def top_ops(self, lo: float, hi: float, n: int = 10):
        """[[kernel name, seconds]] of the device ops that took the most
        time in [lo, hi]."""
        total = collections.Counter()
        for s, e, name, cat, _ in self.device:
            if lo <= s < hi:
                total[kernel_name(name) if cat == "kernel" else cat] += \
                    (e - s) / 1e6
        return [[k, v] for k, v in total.most_common(n)]

    def idle_gaps(self, lo: float, hi: float, main_tid, n: int = 10):
        """[[what the host was doing, seconds]] of the longest gaps in
        [lo, hi] in which no device op ran: the benchmark's span and the
        innermost host op on the main thread at the gap's middle."""
        gaps, end = [], lo
        for s, e, *_ in self.device:
            if s >= hi:
                break
            if s > end:
                gaps.append((min(s, hi) - end, end))
            end = max(end, e)
        if hi > end:
            gaps.append((hi - end, end))
        gaps.sort(reverse=True)
        host = sorted((r for r in self.ranges(r".", ("user_annotation",
                                                       "cpu_op"))
                       if r[0] == main_tid), key=lambda r: r[1])
        out = []
        for length, start in gaps[:n]:
            mid = start + length / 2
            around = [r for r in host if r[1] <= mid <= r[2]]
            bench = [r[3] for r in around if r[3].startswith("bench.")]
            inner = min(around, key=lambda r: r[2] - r[1])[3] \
                if around else "no host op"
            label = f"{bench[-1] if bench else 'outside spans'}: {inner}"
            out.append([label, length / 1e6])
        return out


def main_thread(trace: Trace) -> int:
    r = trace.ranges(r"bench\.unit$", ("user_annotation",))
    return r[0][0] if r else 0


# ------------------------------------------------------------ the result

def emit(result: dict, checks: Dict[str, Tuple[float, float]]) -> None:
    """Print the checks (number and limit each) as the last lines of
    standard error and the result as the last line of standard output,
    the checks under the key that comes last. Exits 3, printing no
    result, if a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the measuring process: "
              f"{', '.join(found)}", file=sys.stderr)
        sys.exit(3)
    result = dict(result)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


class TraceView:
    """What the per-layer readers read from a traced run: the traced
    window's trace, the work done in it, and the bounds and FLOPs counted
    for it; and, since the profiler slows the host, the host time of an
    equal unit run just before it without the profiler (`plain_s`) with
    the host clock of its spans (`clock`)."""

    EODT = r"eodt::|.*RoiAlignFunctionBackward"

    def __init__(self, trace: Trace, clock: Dict[str, float], frames: int,
                 steps: int, flops: float, f32_share: float,
                 bounds: Dict[str, Tuple[int, float]], peak_bytes: int,
                 plain_s: float):
        lo, hi = trace.window()
        self.trace, self.clock = trace, clock
        self.plain_s = plain_s
        self.frames, self.steps = frames, steps
        self.window_s = (hi - lo) / 1e6
        self.busy_s = trace.busy_s(lo, hi)
        self.launches = trace.kernels_in(lo, hi)
        self.flops, self.f32_share = flops, f32_share
        self.bounds = bounds
        self.peak_bytes = peak_bytes
        self.lo, self.hi = lo, hi

    def device_s(self, pattern: str) -> float:
        """Device seconds of the ops launched inside host ranges whose
        name matches `pattern`."""
        return self.trace.device_s_in(pattern)

    def eodt_by_kernel(self) -> Dict[str, Tuple[float, float]]:
        """{kernel: (bound s, device s)} of the port's kernels: device
        time of the ops launched inside each `eodt::` op (and the ROIAlign
        backward's autograd node)."""
        dev = collections.Counter()
        for op, r in self.trace.launched_in(self.trace.ranges(self.EODT)):
            name = "roi_align_backward" if "RoiAlign" in r[3] else \
                r[3].split("::", 1)[1]
            dev[name] += (op[1] - op[0]) / 1e6
        return {k: (self.bounds.get(k, (0, 0.0))[1], dev[k])
                for k in set(dev) | set(self.bounds)}

    def breakdown(self) -> dict:
        return {"device_ops": self.trace.top_ops(self.lo, self.hi),
                "idle_gaps": self.trace.idle_gaps(self.lo, self.hi,
                                                  main_thread(self.trace))}
