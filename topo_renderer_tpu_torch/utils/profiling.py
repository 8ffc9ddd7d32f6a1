"""Profiling and tracing utilities.

Port of `topo_renderer_tpu/utils/profiling.py` (the reference has no
profiling at all, SURVEY §5):
  * :class:`FrameTimer` — rolling per-stage wall times; a stage given
    ``block_on`` waits for that tensor's device before it stops its clock;
  * :func:`trace` — a context manager around `torch.profiler.profile` that
    writes a Chrome trace (view it in Perfetto or chrome://tracing, or
    summarize it with :func:`summarize_trace`);
  * :func:`summarize_trace` — per-name device time totals of the newest
    trace in a directory.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import tempfile
import time
from collections import defaultdict, deque

import torch

# Chrome-trace categories of the operations that run on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _wait_for(x) -> None:
    """Wait for the devices of every CUDA tensor in ``x`` (a tensor, or
    tuples, lists and dicts of them); CPU tensors need no wait."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            for item in v.values():
                visit(item)
        elif isinstance(v, (tuple, list)):
            for item in v:
                visit(item)

    visit(x)
    for device in devices:
        torch.cuda.synchronize(device)


class FrameTimer:
    """Rolling statistics of named stages.

    Usage::
        timer = FrameTimer()
        with timer.stage("render", block_on=out):  # waits for out's device
            ...
        print(timer.report())

    The wait in ``block_on`` is a host sync: that is the timer's purpose,
    and no frame path times itself with it.
    """

    def __init__(self, window: int = 120):
        self._window = window
        self._samples: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _wait_for(block_on)
            self._samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def stats(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            if not xs:
                continue
            s = sorted(xs)
            out[name] = {
                "mean_ms": 1e3 * sum(s) / len(s),
                "p50_ms": 1e3 * s[len(s) // 2],
                "min_ms": 1e3 * s[0],
                "max_ms": 1e3 * s[-1],
                "n": float(len(s)),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, st in sorted(self.stats().items()):
            lines.append(
                f"{name:>24}: mean {st['mean_ms']:7.2f} ms  "
                f"p50 {st['p50_ms']:7.2f}  min {st['min_ms']:7.2f}  "
                f"max {st['max_ms']:7.2f}  (n={int(st['n'])})"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block with torch.profiler (CPU, and CUDA where present)
    and write a Chrome trace ``*.pt.trace.json`` into ``log_dir`` (default:
    ``topo_trace`` under the temporary directory). Yields ``log_dir``. With
    CUDA, the block's queued device work is waited for before the trace
    closes, so that its kernels are in it."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "topo_trace")
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.pt.trace.json"))


def summarize_trace(log_dir: str, top: int = 25) -> list[tuple[float, str]]:
    """Per-name device time totals (ms) of the newest Chrome trace in
    ``log_dir``, largest first, at most ``top``: kernels, copies and sets.
    Returns [] when there is no trace, or the trace holds no device event
    (a CPU-only run)."""
    files = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"), recursive=True)
    if not files:
        return []
    with open(max(files, key=os.path.getmtime), encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    totals: dict[str, float] = defaultdict(float)
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            totals[ev.get("name", "")] += float(ev.get("dur", 0.0)) / 1e3
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [(ms, name) for name, ms in ranked]
