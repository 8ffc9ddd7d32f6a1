"""The port's `utils/profiling.py` against the JAX package's on the CPU:
`FrameTimer` statistics and report on the same samples, its stages (with
and without ``block_on``), `summarize_trace` on a Chrome trace written
here, and `trace` around CPU work (no device events, so no summary)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from topo_renderer_tpu.utils.profiling import FrameTimer as JaxFrameTimer
from topo_renderer_tpu_torch.utils import profiling
from topo_renderer_tpu_torch.utils.profiling import FrameTimer, summarize_trace, trace


@pytest.mark.parametrize("window", [3, 120])
def test_frame_timer_equals_jax(window):
    rng = np.random.default_rng(11)
    samples = {name: rng.uniform(1e-4, 0.05, n).tolist() for name, n in (("render", 7), ("encode", 2), ("pull", 1))}
    ours, theirs = FrameTimer(window), JaxFrameTimer(window)
    for name, xs in samples.items():
        for x in xs:
            ours.add(name, x)
            theirs.add(name, x)
    assert ours.stats() == theirs.stats()
    assert ours.report() == theirs.report()
    assert ours.stats()["render"]["n"] == min(window, 7)


def test_frame_timer_stages():
    """`tests/test_misc.py::test_frame_timer`, and ``block_on`` with CPU
    tensors (nothing to wait for) in a tensor, a tuple and a dict."""
    t = FrameTimer()
    with t.stage("a"):
        time.sleep(0.002)
    x = torch.ones(4)
    for block_on in (x, (x, [x * 2]), {"color": x}):
        with t.stage("a", block_on=block_on):
            time.sleep(0.002)
    st = t.stats()["a"]
    assert st["n"] == 4 and st["mean_ms"] >= 1.0 and st["min_ms"] <= st["p50_ms"] <= st["max_ms"]
    assert "a" in t.report()
    with pytest.raises(ZeroDivisionError):
        with t.stage("b"):
            1 / 0
    assert t.stats()["b"]["n"] == 1  # a stage that raised is still timed


def _event(name, cat, dur_us, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 0, "ts": 0, "dur": dur_us}


def test_summarize_trace_sums_device_events(tmp_path):
    events = [
        _event("crossing_search_kernel", "kernel", 30.0),
        _event("crossing_search_kernel", "kernel", 12.5),
        _event("window_slice_multi_kernel", "kernel", 3.0),
        _event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 40.0),
        _event("Memset (Device)", "gpu_memset", 1.0),
        _event("aten::add", "cpu_op", 900.0),
        _event("cudaLaunchKernel", "cuda_runtime", 700.0),
        _event("crossing_search_kernel", "kernel", 99.0, ph="i"),
    ]
    older = tmp_path / "a" / "old.pt.trace.json"
    older.parent.mkdir()
    older.write_text(json.dumps({"traceEvents": [_event("stale", "kernel", 1e6)]}))
    newest = tmp_path / "b.pt.trace.json"
    newest.write_text(json.dumps({"traceEvents": events}))
    os.utime(older, (1, 1))
    got = summarize_trace(str(tmp_path))
    assert [name for _, name in got] == ["crossing_search_kernel", "Memcpy DtoH (Device -> Pinned)",
                                         "window_slice_multi_kernel", "Memset (Device)"]
    assert [ms for ms, _ in got] == pytest.approx([0.0425, 0.04, 0.003, 0.001], rel=1e-12)
    assert [name for _, name in summarize_trace(str(tmp_path), top=1)] == ["crossing_search_kernel"]
    assert summarize_trace(str(tmp_path / "missing")) == []


def test_trace_on_the_cpu(tmp_path, monkeypatch):
    """`trace` writes a Chrome trace of CPU work; it holds no device event,
    so `summarize_trace` gives [], as JAX's gives when it cannot read a
    capture. Without a directory it writes under the temporary directory."""
    with trace(str(tmp_path / "t")) as where:
        y = torch.randn(64, 64) @ torch.randn(64, 64)
    assert where == str(tmp_path / "t") and y.shape == (64, 64)
    files = [f for f in os.listdir(where) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(where, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert summarize_trace(where) == []

    monkeypatch.setattr(profiling.tempfile, "gettempdir", lambda: str(tmp_path))
    with trace() as where:
        torch.ones(3).sum()
    assert where == str(tmp_path / "topo_trace") and os.listdir(where)
