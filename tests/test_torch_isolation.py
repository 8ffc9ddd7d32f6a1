"""The port stands alone: no JAX, no JAX package, CUDA by default.

`topo_renderer_tpu_torch` (and `chip_smoke.py`, which drives it on the
card) must import neither `jax` nor anything of `topo_renderer_tpu`: the
card's machine runs the port without JAX. Nor may it import the JAX
package's measurement programs (the repository's ``bench.py`` and
``scripts/``) or put ``scripts`` on ``sys.path``: the port keeps its own
copies (`topo_renderer_tpu_torch/bench.py`, `topo_renderer_tpu_torch/scripts/`).
Checked twice: in a fresh interpreter through `sys.modules`, and statically
over every source file.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import topo_renderer_tpu_torch
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.ops import crossing, window_slice
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec
from topo_renderer_tpu_torch.render.engine import RenderEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "topo_renderer_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "topo_renderer_tpu"}
# The JAX package's measurement programs, as top-level modules of the
# repository's root or of its ``scripts/`` directory.
SCRIPTS = {"bench", "scripts", "perf_probe", "stage_probe", "trace_render", "make_demos"}


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_forbidden_module_after_import():
    code = (
        "import importlib, pkgutil, sys\n"
        "import topo_renderer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from topo_renderer_tpu_torch.ops.raycast import march_guided_panorama, render_perspective\n"
        "from topo_renderer_tpu_torch.ops.panorama import panorama_crossing_prepass\n"
        "from topo_renderer_tpu_torch.frontends.cli import main\n"
        "from topo_renderer_tpu_torch.backend.server import main as backend_main\n"
        "from topo_renderer_tpu_torch.app.application import Application\n"
        "from topo_renderer_tpu_torch.data.tiff import read_geotiff, write_geotiff\n"
        "from topo_renderer_tpu_torch.data.background import BackgroundRunner\n"
        "from topo_renderer_tpu_torch import native\n"
        "from topo_renderer_tpu_torch.frontends.web.server import WebFrontend, main as web_main\n"
        "from topo_renderer_tpu_torch.frontends.desktop import DesktopFrontend\n"
        "from topo_renderer_tpu_torch.utils.profiling import FrameTimer, summarize_trace, trace\n"
        "from topo_renderer_tpu_torch.models.scene import Scene, build_height_mips, build_max_mips\n"
        "from topo_renderer_tpu_torch.parallel.mesh import Mesh, make_mesh, gather_rows\n"
        "from topo_renderer_tpu_torch.parallel.sharded import render_batch_sharded, jit_sharded_step\n"
        "from topo_renderer_tpu_torch.parallel.sharded_mosaic import shard_mosaic, render_batch_scan_sharded\n"
        "from topo_renderer_tpu_torch.parallel.sharded_update import apply_slot_update_sharded\n"
        "from topo_renderer_tpu_torch import bench\n"
        "from topo_renderer_tpu_torch.scripts import make_demos, perf_probe, stage_probe, trace_render\n"
        "import numpy as np\n"
        "blob = write_geotiff(np.ones((3, 4), np.float32), (1.0, 1.0, 0.0), (0.0,) * 6)\n"
        "assert read_geotiff(blob)[0].shape == (3, 4)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN | SCRIPTS)!r})\n"
        "print(len(sys.modules), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120, check=True
    ).stdout.split()
    assert int(out[0]) > 50
    assert out[1:] == ["[]"], out


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_the_repository_scripts(path):
    """No absolute import of the JAX package's measurement programs, and no
    ``sys.path`` change that names ``scripts``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            names = []
        for name in names:
            assert name.split(".")[0] not in SCRIPTS, f"{path}:{node.lineno} imports {name}"
        if isinstance(node, ast.Call) and ast.unparse(node.func).startswith("sys.path"):
            assert "scripts" not in ast.unparse(node), f"{path}:{node.lineno} puts scripts on sys.path"
        if isinstance(node, (ast.Assign, ast.AugAssign)) and "sys.path" in ast.unparse(node):
            assert "scripts" not in ast.unparse(node), f"{path}:{node.lineno} puts scripts on sys.path"


def test_engine_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RenderEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        topo_renderer_tpu_torch.resolve_device(None)


def test_app_and_cli_need_cuda_by_default(monkeypatch):
    """`Application()` and the CLI without ``--device`` run on CUDA and raise
    without it, before a worker or a request exists."""
    from topo_renderer_tpu_torch.app.application import Application
    from topo_renderer_tpu_torch.config import Settings
    from topo_renderer_tpu_torch.frontends import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TOPO_BACKEND_URL", "http://127.0.0.1:9")
    with pytest.raises(RuntimeError, match="CUDA"):
        Application(Settings(backend_url="http://127.0.0.1:9"))
    for command in ("panorama", "render"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([command, "--lat", "45.5", "--lon", "12.5", "--width", "64", "--height", "16"])


SPAN = 0.03
COUNTERS = (crossing.crossing_search, window_slice.window_slice_multi,
            window_slice.window_slice_multi_batched, window_slice.window_slice)


def _cpu_engine():
    n = 65
    ps = SPAN / (n - 1)
    ys, xs = np.mgrid[0:n, 0:n] / (n - 1)
    heights = (1500 + 400 * np.sin(5 * xs) * np.cos(4 * ys)).astype(np.float32)
    engine = RenderEngine(device="cpu")
    engine.add_terrain(
        GeoLocation.from_coord(47, 11), heights,
        CoordinateTransform((0.0, 0.0), (11.0, 47.0 + SPAN), (ps, ps)),
    )
    for f in COUNTERS:
        f.launches = 0
    return engine, Camera().reset(GeoCoord(47.0 + SPAN / 2, 11.0 + SPAN / 4), 2300.0)


def test_cpu_fast_frame_launches_no_kernel_and_exact_frame_raises():
    """Fast and exact frames on the CPU launch no kernel, the exact march's
    rungs without guard legs included; an unknown quality raises."""
    engine, cam = _cpu_engine()
    for split in (True, False):
        res = engine.render(cam, 32, 24, n_steps=384, n_refine=4, host_copy=False,
                            guided_kw=(("guard_legs", False), ("split_brackets", split)))
        assert res.hit.any() and res.hit.device.type == "cpu"
    with pytest.raises(ValueError, match="exact_quality"):
        engine.render(cam, 32, 24, fast=True, exact_quality="best")
    res = engine.render(cam, 48, 32, n_steps=64, fast=True, wire="yuv420", host_copy=False)
    frame, labels, _, _ = res.finish(res.color.numpy())
    assert frame.shape == (32, 48, 3) and labels == {}
    assert res.depth.device.type == "cpu"
    for guided in (True, False):
        res = engine.render(cam, 48, 32, n_steps=384, n_refine=4, guided=guided, wire="yuv420", host_copy=False)
        assert res.finish(res.color.numpy())[0].shape == (32, 48, 3) and res.hit.any()
    assert [f.launches for f in COUNTERS] == [0, 0, 0, 0]


def test_cpu_streaming_engine_launches_no_kernel():
    """A streaming engine on the CPU: slot updates and the frames after them
    launch no kernel."""
    n = 33
    ps = SPAN / (n - 1)
    ys, xs = np.mgrid[0:2 * n - 1, 0:n] / (n - 1)
    field = (1500 + 400 * np.sin(5 * xs) * np.cos(4 * ys)).astype(np.float32)
    tiles = [(GeoLocation.from_coord(47 - k, 11), field[k * (n - 1) : k * (n - 1) + n],
              CoordinateTransform((0.0, 0.0), (11.0, 47.0 + SPAN - k * SPAN), (ps, ps))) for k in (0, 1)]
    engine = RenderEngine(device="cpu", streaming=True)
    engine.add_terrain(*tiles[0])
    engine.mosaic
    for f in COUNTERS:
        f.launches = 0
    engine.add_terrain(*tiles[1])
    assert engine._pending and engine.loaded_locations == {tiles[0][0], tiles[1][0]}
    cam = Camera().reset(GeoCoord(47.0 + SPAN / 2, 11.0 + SPAN / 4), 2300.0)
    assert engine.render(cam, 48, 32, n_steps=64, fast=True, host_copy=False).hit.any()
    engine.unload_terrain(tiles[0][0])
    assert engine._pending and engine.loaded_locations == {tiles[1][0]}
    engine.render(cam, 48, 32, n_steps=384, n_refine=4, host_copy=False)
    assert not engine._pending and [f.launches for f in COUNTERS] == [0, 0, 0, 0]


def test_cpu_path_launches_no_kernel():
    engine, cam = _cpu_engine()
    spec = PanoramaSpec.fast(64, 16, n_steps=64, clipmap_threshold=0)
    res = engine.render_panorama(cam, spec, fog="atmosphere")
    assert res.color.shape == (16, 64, 3)
    assert res.hit.any()
    eyes = torch.stack([cam.eye, cam.eye * 1.0001])
    batch = engine.render_batch(eyes, spec, torch.stack([cam.sun_angle.to_vec3()] * 2))
    assert batch.shape == (2, 16, 64, 3) and batch.device.type == "cpu"
    assert [f.launches for f in COUNTERS] == [0, 0, 0, 0]


@pytest.mark.parametrize("value", [0.25, [1.0, 2.0, 3.0], np.float64(1.1), torch.tensor([4.0, 5.0], dtype=torch.float64)])
def test_host_values_stay_on_the_host_device(value):
    """`f32` rounds as ``jnp.float32`` does and, with no device or the CPU,
    leaves its value where it is: only a CUDA target takes the pinned copy."""
    from topo_renderer_tpu_torch.ops.geometry import f32, to_device

    want = torch.as_tensor(value, dtype=torch.float32)
    for device in (None, "cpu"):
        got = f32(value, device)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert torch.equal(got, want)
    assert to_device(want, None) is want


def test_multi_device_paths_are_not_refused(monkeypatch):
    """The multi-device slice is ported: a geo mesh, ``geo_shard`` and a
    row-sharded cell table no longer raise NotImplementedError, and no
    module of the port raises it."""
    from topo_renderer_tpu_torch.app import application
    from topo_renderer_tpu_torch.config import Settings
    from topo_renderer_tpu_torch.ops.surface import cell_rows, sample_attributes_cell
    from topo_renderer_tpu_torch.parallel.mesh import Mesh
    from topo_renderer_tpu_torch.parallel.sharded_mosaic import shard_mosaic

    mesh = Mesh(["cpu"] * 2, ("geo",))
    engine, cam = _cpu_engine()
    sharded = RenderEngine(device="cpu", geo_mesh=mesh)
    for loc, tile in engine._tiles.items():
        sharded.add_terrain(loc, tile.heights, tile.transform)
    assert sharded.mosaic.cell_sharded and sharded.mosaic.sharded_rows == (0,)
    m = shard_mosaic(engine.mosaic, mesh, keep_cell_table=True)
    idx = torch.arange(0, 64 * 64, 97)
    assert torch.equal(cell_rows(m, idx), cell_rows(engine.mosaic, idx))
    gx, gy = torch.tensor([3.5, 40.25]), torch.tensor([7.75, 60.5])
    assert all(torch.equal(a, b) for a, b in zip(sample_attributes_cell(m, gx, gy),
                                                 sample_attributes_cell(engine.mosaic, gx, gy)))
    assert sharded.render(cam, 32, 24, n_steps=64, fast=True, host_copy=False).hit.any()
    monkeypatch.setattr(application, "BackgroundRunner", lambda *a, **k: type("R", (), {"spawn": lambda s: None})())
    app = application.Application(Settings(backend_url="http://127.0.0.1:9", geo_shard=2), device="cpu")
    assert app.engine._geo_mesh.shape == {"geo": 2}
    for path in PKG.rglob("*.py"):
        assert "NotImplementedError" not in path.read_text(), path
