"""The port's measurement programs against the JAX package's, on the CPU.

`topo_renderer_tpu_torch/scripts/perf_probe.py::synthetic_mosaic_device`
against the repository's ``scripts/perf_probe.py`` (built as that script
builds it, one jitted program), and the calls of every config of
`topo_renderer_tpu_torch/bench.py` against the JAX functions that
``bench.py`` calls, on the JAX script's tables carried across
(`mosaic_from_arrays`).

Tolerances of the scene build. The JAX build is one XLA program: XLA folds
the grid's ``/ n`` and the constant factors of ``12 * k * xs * pi`` into
one float32 constant and contracts each multiply-add into a fused one, and
its ``sin``/``cos`` are not PyTorch's. The port evaluates the script's
expressions op by op, so a sinusoid's argument (up to ~150 rad, an ulp of
1.5e-5) differs in its last bits: heights, mips, max pyramids and cell rows
agree within 0.05 m (measured at most 0.024 m on heights up to ~2600 m).
The normals are quantized to the reference's 8-bit texture, one step of
which is about 4 of the packed 10-bit codes: a packed code differs by at
most 4, on at most 0.5% of the texels of all levels (measured 0.1-0.2%).
Everything else (shapes, which levels have window tables, the rotation,
bounds, host data) is exact.

Frames are held at the golden tolerance (<= 2/255 per channel on >= 99% of
pixels) to the JAX functions evaluated primitive by primitive
(`jax.disable_jit()`; `test_torch_panorama.py` says why); hit masks and
label visibility are compared directly.
"""

import functools
import importlib.util
import json
import math
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_panorama import frac_bad
from tests.test_torch_window_slice import jax_mosaic_to_port
from topo_renderer_tpu.models.camera import Camera as JaxCamera
from topo_renderer_tpu.ops import panorama as jpano
from topo_renderer_tpu.ops import raycast as jray
from topo_renderer_tpu.ops.shading import to_srgb8_image as jax_srgb8
from topo_renderer_tpu.render import engine as jengine
from topo_renderer_tpu_torch import bench
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.ops import crossing
from topo_renderer_tpu_torch.ops.panorama import PanoramaSpec, extract_clipmap_windows, render_batch_scan
from topo_renderer_tpu_torch.ops.shading import to_srgb8_image
from topo_renderer_tpu_torch.render import transport
from topo_renderer_tpu_torch.render.engine import RenderEngine
from topo_renderer_tpu_torch.scripts import make_demos, perf_probe, stage_probe, trace_render

ROOT = pathlib.Path(__file__).resolve().parent.parent
HEIGHT_ATOL = 0.05  # metres
CODE_MAX = 4  # packed 10-bit normal codes: one step of the 8-bit normal texture
CODE_SHARE = 0.005


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU work here runs on one thread. Its tensors are mid-sized
    (a prepass of 896 steps x 256 columns, an 801^2 scene), so each op would
    open an OpenMP region over every core; beside other test processes that
    do the same, such regions wait on one another and a seconds-long test
    runs for many minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def jax_probe():
    """The repository's ``scripts/perf_probe.py`` as a module. It turns on
    JAX's persistent compilation cache when imported; the settings are put
    back, so that nothing is written outside the run."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    kept = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location("jax_perf_probe", ROOT / "scripts" / "perf_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for k, v in kept.items():
        jax.config.update(k, v)
    return module


@functools.lru_cache(maxsize=None)
def jax_scene(n, rugged=False):
    m = jax_probe().synthetic_mosaic_device(n=n, rugged=rugged)
    jax.block_until_ready(m.heights_flat)
    return m


def _heights_close(a, b, what):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=HEIGHT_ATOL, err_msg=what)


def _codes(words):
    w = np.asarray(words).view(np.uint32).astype(np.int64)
    return np.stack([(w >> s) & 0x3FF for s in (0, 10, 20)])


# ---- the synthetic scene ------------------------------------------------------

@pytest.mark.parametrize("n,rugged", [(257, False), (577, False), (257, True)],
                         ids=["n257", "n577_window_table", "n257_rugged"])
def test_synthetic_mosaic_matches_jax_script(n, rugged):
    jm = jax_scene(n, rugged)
    pm = perf_probe.synthetic_mosaic_device(n=n, rugged=rugged, device="cpu")
    assert pm.shape == jm.shape == (n, n) and pm.mip_shapes == jm.mip_shapes
    assert pm.has_cell_table and pm.cell_width == 4 and jm.cell_heights_flat.shape == (n * n, 4)
    for name in ("heights_flat", "attr_packed_flat", "cell_heights_flat"):
        assert tuple(getattr(pm, name).shape) == getattr(jm, name).shape, name
    for name in ("mip_heights_flat", "mip_attr_flat", "mip_hmax_flat"):
        assert [tuple(t.shape) for t in getattr(pm, name)] == [t.shape for t in getattr(jm, name)], name
    assert [w is None for w in pm.win_attr_2d] == [w is None for w in jm.win_attr_2d]
    assert (pm.win_attr_2d[0] is not None) == (n * n > 262_144)

    _heights_close(jm.heights_flat, pm.heights_flat, "heights")
    _heights_close(jm.cell_heights_flat, pm.cell_heights_flat, "cell rows")
    for level, (a, b) in enumerate(zip(jm.mip_heights_flat, pm.mip_heights_flat), 1):
        _heights_close(a, b, f"mip {level}")
    for level, (a, b) in enumerate(zip(jm.mip_hmax_flat, pm.mip_hmax_flat), 1):
        _heights_close(a, b, f"max pyramid {level}")
    attrs = [(jm.attr_packed_flat, pm.attr_packed_flat)] + list(zip(jm.mip_attr_flat, pm.mip_attr_flat))
    differ, texels = 0, 0
    for level, (a, b) in enumerate(attrs):
        _heights_close(np.asarray(a)[:, 0], b[:, 0], f"attr heights {level}")
        d = np.abs(_codes(np.asarray(a)[:, 1]) - _codes(b[:, 1].numpy()))
        assert d.max() <= CODE_MAX, (level, d.max())
        differ += int((d > 0).any(axis=0).sum())
        texels += d.shape[1]
    assert differ <= CODE_SHARE * texels, (differ, texels)
    for a, b in zip(jm.win_attr_2d, pm.win_attr_2d):
        if a is not None:  # the 2-D tables hold the same words as the flat rows
            np.testing.assert_array_equal(b[1].contiguous().view(torch.int32).numpy().reshape(-1),
                                          pm.attr_packed_flat[:, 1].contiguous().view(torch.int32).numpy())

    assert abs(float(pm.hmax) - float(jm.hmax)) <= HEIGHT_ATOL
    np.testing.assert_array_equal(pm.bound_center.numpy(), np.asarray(jm.bound_center))
    assert float(pm.bound_radius) == float(jm.bound_radius) == np.float32(n / 1200.0 * 111_000.0)
    np.testing.assert_array_equal(pm.model_point.numpy(), np.asarray(jm.model_point))
    np.testing.assert_array_equal(pm.pixel_scale.numpy(), np.asarray(jm.pixel_scale))
    np.testing.assert_array_equal(pm.host.tile_rot, np.asarray(jm.host.tile_rot))
    assert pm.host.valid.all() and not pm.host.cell_tile.any() and pm.host.valid.shape == (n, n)
    np.testing.assert_array_equal(pm.host.model_point, np.asarray(jm.model_point))
    assert pm.texel_m == jm.texel_m


def test_eye_at_is_on_the_host_and_equals_jax():
    eye = perf_probe.eye_at(47.0, 23.0, 2800.0)
    assert eye.device.type == "cpu" and eye.dtype == torch.float32
    np.testing.assert_array_equal(eye.numpy(), np.asarray(jax_probe().eye_at(47.0, 23.0, 2800.0)))


# ---- the configs' calls on the JAX script's tables ------------------------------

N_FRAMES = 577  # level 0 has a window table
EYE = perf_probe.eye_at(51.76, 18.24, 2800.0)  # near the scene's centre
SUN = np.array([0.3, 0.5, 0.8], np.float32)
FOV = math.radians(45.0)
PANO_KW = dict(width=128, height=32, n_steps=64, clipmap_threshold=100_000)  # level 0 windowed


@functools.lru_cache(maxsize=None)
def frames_scene():
    jm = jax_scene(N_FRAMES)
    return jm, jax_mosaic_to_port(jm)


def cameras():
    """bench.py's pose (pitch -0.05, yaw 0.8), as a JAX and a port camera."""
    return (JaxCamera(eye=jnp.asarray(EYE.numpy()), pitch=-0.05, yaw=0.8),
            Camera(eye=EYE, pitch=-0.05, yaw=0.8))


def check_frame(port_u8, port_hit, jax_u8, jax_hit):
    assert port_u8.shape == jax_u8.shape
    assert frac_bad(port_u8, jax_u8) < 0.01, frac_bad(port_u8, jax_u8)
    np.testing.assert_array_equal(port_hit, jax_hit)
    assert 0.05 < port_hit.mean() < 0.95


@pytest.mark.parametrize("fog", ["atmosphere", "distance"], ids=["config4", "config2"])
def test_panorama_call_matches_eager_jax(fog):
    """Configs 4 and 2 in bench.py's form: window extraction, then the
    render from those windows."""
    jm, pm = frames_scene()
    ps, js = PanoramaSpec.fast(**PANO_KW), jpano.PanoramaSpec.fast(**PANO_KW)
    assert extract_clipmap_windows(pm, EYE, ps)[0][1] is not None
    out = bench.panorama_call(pm, EYE, ps, torch.from_numpy(SUN), fog)
    with jax.disable_jit():
        eye = jnp.asarray(EYE.numpy())
        win = jpano.extract_clipmap_windows(jm, eye, js)
        jo = jpano.render_panorama(jm, eye, js, SUN, fog=fog, windows=win)
        want = np.asarray(jax_srgb8(jo["color"]))
    check_frame(to_srgb8_image(out["color"]).numpy(), out["hit"].numpy(), want, np.asarray(jo["hit"]))


def test_batch_matches_eager_jax():
    """Config 5's `render_batch_scan`, two viewpoints."""
    jm, pm = frames_scene()
    ps, js = PanoramaSpec.fast(**PANO_KW), jpano.PanoramaSpec.fast(**PANO_KW)
    eyes = torch.stack([EYE, perf_probe.eye_at(51.70, 18.35, 2500.0)])
    suns = torch.from_numpy(SUN).expand(2, 3)
    got = to_srgb8_image(render_batch_scan(pm, eyes, suns, ps, fog="atmosphere")).numpy()
    with jax.disable_jit():
        want = np.asarray(jax_srgb8(jpano.render_batch_scan(
            jm, jnp.asarray(eyes.numpy()), jnp.asarray(suns.numpy()), js, fog="atmosphere")))
    for b in range(2):
        assert frac_bad(got[b], want[b]) < 0.01, (b, frac_bad(got[b], want[b]))


@pytest.mark.parametrize("rung", [False, True], ids=["full", "interactive_rung"])
def test_exact_frame_matches_eager_jax(rung):
    """Config 1's guided exact frame, 64 x 36, and its interactive rung."""
    jm, pm = frames_scene()
    jcam, pcam = cameras()
    kw = RenderEngine._EXACT_RUNG_INTERACTIVE if rung else ()
    out = bench.exact_frame(pm, pcam, 64, 36, FOV, guided_kw=kw)
    with jax.disable_jit():
        jo = jray.render_perspective(jm, jcam, width=64, height=36, n_steps=1024, n_refine=24, guided=True,
                                     fov_hint=FOV, guided_kw=kw)
        want = np.asarray(jax_srgb8(jo["color"]))
    check_frame(to_srgb8_image(out["color"]).numpy(), out["hit"].numpy(), want, np.asarray(jo["hit"]))


def scene_peaks(jm, count=48, seed=3):
    """``count`` peaks 30 m above the scene's terrain, from a seed."""
    rng = np.random.default_rng(seed)
    n = jm.shape[0]
    r, c = rng.integers(1, n - 1, count), rng.integers(1, n - 1, count)
    h = np.asarray(jm.heights)[r, c] + 30.0
    pos = np.stack([perf_probe.eye_at(52.0 - ri / 1200.0, 18.0 + ci / 1200.0, hi).numpy()
                    for ri, ci, hi in zip(r, c, h)])
    return pos.astype(np.float32), np.ones((count,), bool)


@pytest.mark.parametrize("labels", [False, True], ids=["config6", "config3"])
def test_wire_frame_matches_jax_one_program_frame(labels):
    """Configs 6 and 3: bench's wire frame, composed from the functions the
    engine calls, against JAX's one-program `_frame_wire` and
    `_fast_frame_with_labels`; pixels decoded from both wire vectors, label
    bytes equal."""
    jm, pm = frames_scene()
    jcam, pcam = cameras()
    w, h = 96, 54
    pos, valid = scene_peaks(jm)
    got = bench.wire_frame(pm, pcam, w, h, FOV, labels=(torch.from_numpy(pos), torch.from_numpy(valid))
                           if labels else None).numpy()
    with jax.disable_jit():
        if labels:
            _, want = jengine._fast_frame_with_labels(
                jm, jcam, jnp.asarray(pos), jnp.asarray(valid), width=w, height=h, n_steps=512, pixelize_n=None,
                fov_hint=FOV, tolerance_rel=0.05, wire_mode="yuv420")
        else:
            _, want = jengine._frame_wire(jm, jcam, width=w, height=h, n_steps=512, n_refine=0, pixelize_n=None,
                                          fov_hint=FOV, fast=True, guided=False, wire_mode="yuv420")
    want = np.asarray(want)
    assert got.dtype == np.uint8 and got.shape == want.shape
    p = len(pos) if labels else 0
    img, lab = transport.decode_frame(got, h, w, p, mode="yuv420")
    want_img, want_lab = transport.decode_frame(want, h, w, p, mode="yuv420")
    assert frac_bad(img, want_img) < 0.01, frac_bad(img, want_img)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 200
    if labels:
        np.testing.assert_array_equal(lab, want_lab)
        assert 0 < lab[0].sum() < p


def test_stage_probe_profile_matches_jax():
    """stage_probe's stage 2 (the port's `_build_lod_profile` under its
    setup) against JAX's, under the JAX script's setup, and stage 3 equal
    to K1's plain version on stage 2's profile."""
    jm, pm = frames_scene()
    ps, js = PanoramaSpec.fast(**PANO_KW), jpano.PanoramaSpec.fast(**PANO_KW)
    win = extract_clipmap_windows(pm, EYE, ps)
    e_prof, *attrs = stage_probe.profile_only(pm, EYE, ps, win)
    with jax.disable_jit():
        eye = jnp.asarray(EYE.numpy())
        a0, up, (ex, ey), (nx0, ny0, nz0), _ = jpano._eye_frame(eye)  # scripts/stage_probe.py::setup_ctx
        ws = js.width // js.profile_stride
        phi = js.azimuth_start + js.azimuth_span * ((jnp.arange(ws, dtype=jnp.float32) + 0.5) / ws)
        cps, sps = jnp.cos(phi), jnp.sin(phi)
        h_prof_b = tuple(c[None, :] for c in (nx0 * cps + ex * sps, ny0 * cps + ey * sps, nz0 * cps))
        k = jnp.arange(js.n_steps, dtype=jnp.float32)[:, None]
        sigma = jnp.exp(jnp.float32(jnp.log(js.s_near)) + jnp.float32(jnp.log(js.s_far / js.s_near))
                        * (k / (js.n_steps - 1))) / 6371000.0
        je, jattrs = jpano._build_lod_profile(jm, js, jpano.extract_clipmap_windows(jm, eye, js), a0, up,
                                              h_prof_b, sigma)
    np.testing.assert_allclose(e_prof.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    for got, want in zip(attrs, jattrs):
        assert (got.numpy() != np.asarray(want)).mean() < 0.01
    got = stage_probe.through_crossing(pm, EYE, ps, win)
    e_lo, e_hi = ps.elevation_range()
    rows = (torch.arange(ps.height, dtype=torch.float32) + 0.5) / ps.height
    want = crossing.crossing_search_plain(e_prof, *attrs, torch.tan(e_hi - rows * (e_hi - e_lo)))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---- the programs on the CPU: code paths, not measurements --------------------------

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "configs"}
COMMON = {"config", "metric", "value", "unit", "target", "vs_baseline", "stats"}
# Each config's own keys and stage keys, as bench.py writes them
# (`bench.py:191-206, 224-233, 305-319, 398-421, 473-494, 518-538`).
CONFIG_KEYS = {
    4: ({"stages"}, {"extract_ms", "render_ms"}),
    2: (set(), None),
    5: (set(), None),
    1: ({"stages"}, {"prepass_ms", "march_ms", "gather_rounds", "ms_per_round", "interactive_rung_ms",
                     "rung_rounds", "rung_ms_per_round"}),
    6: ({"fps", "stages"}, {"device_ms", "transport_ms", "wire_bytes", "rgb888_ms", "rgb888_bytes"}),
    3: ({"stages"}, {"label_overhead_ms"}),
}


def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def test_bench_smoke_line(monkeypatch, capsys):
    """`bench.main` under the smoke shapes, one call per timed loop, on the
    CPU: this checks the code path and bench.py's keys and measures
    nothing."""
    monkeypatch.setattr(bench, "SMOKE", True)
    configs = []
    bench.main(configs, device="cpu", one_rep=True)
    bench._emit(configs)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == BENCH_KEYS
    assert line["unit"] == "ms" and line["vs_baseline"] is None and _finite(line["value"])
    assert [c["config"] for c in line["configs"]] == [1, 2, 3, 4, 5, 6]
    for c in line["configs"]:
        extra, stages = CONFIG_KEYS[c["config"]]
        assert set(c) == COMMON | extra, c["config"]
        assert c["target"] is None and c["vs_baseline"] is None and _finite(c["value"]) and c["value"] > 0
        assert c["unit"] == ("panoramas/s" if c["config"] == 5 else "ms")
        assert set(c["stats"]) == {"min", "stddev", "reps"} and all(_finite(v) for v in c["stats"].values())
        if stages is not None:
            assert set(c["stages"]) == stages and all(_finite(v) for v in c["stages"].values())
    assert line["value"] == line["configs"][3]["value"]


def test_bench_failure_keeps_partial_line_and_fails(monkeypatch, capsys):
    """A config that raises: the line keeps the configs that finished,
    carries ``error``, and the program exits non-zero."""
    def broken(*a, **k):
        raise RuntimeError("batch broke")

    monkeypatch.setattr(bench, "SMOKE", True)
    monkeypatch.setattr(bench, "REPS", {"sustained": 1, "exact": 1, "batch": 1, "wire": (1, 1)})
    monkeypatch.setattr(bench, "render_batch_scan", broken)
    assert bench.run(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == BENCH_KEYS | {"error"} and "batch broke" in line["error"]
    assert [c["config"] for c in line["configs"]] == [2, 4] and _finite(line["value"])


ENTRY_POINTS = {
    "bench.main": lambda: bench.main([]),
    "bench.run": lambda: bench.run([]),
    "synthetic_mosaic_device": lambda: perf_probe.synthetic_mosaic_device(n=9),
    "perf_probe.main": lambda: perf_probe.main([]),
    "stage_probe.main": lambda: stage_probe.main([]),
    "trace_render.main": lambda: trace_render.main([]),
    "make_demos.main": lambda: make_demos.main(["unused"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_cuda(monkeypatch, capsys, name):
    """Without a device every new entry point runs on CUDA, and raises
    where there is none (the program `bench.run` prints its error line and
    returns 1)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name == "bench.run":
        assert ENTRY_POINTS[name]() == 1
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "CUDA" in line["error"] and line["configs"] == []
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()


def test_scripts_on_the_cpu(monkeypatch, tmp_path, capsys):
    """perf_probe's sweep, stage_probe's four stages and trace_render's
    trace at tiny shapes on the CPU (code paths; the CPU trace holds no
    device operation)."""
    tiny = PanoramaSpec.fast(width=64, height=16, n_steps=32)
    res = perf_probe.main(["--n", "65", "--device", "cpu"], sweep=((64, 16, 32, 2),))
    assert len(res) == 1 and res[0][1] > 0
    monkeypatch.setenv("PROBE_N", "129")
    monkeypatch.setattr(stage_probe, "SPEC", tiny)
    ms = stage_probe.main(["--device", "cpu"])
    assert set(ms) == {"extract", "profile", "crossing", "full"} and all(v > 0 for v in ms.values())
    monkeypatch.setattr(trace_render, "SPEC", PanoramaSpec(width=64, height=16, n_steps=32, n_refine=2))
    assert trace_render.main(["65", "--device", "cpu", "--trace-dir", str(tmp_path)]) == []
    assert list(tmp_path.glob("*.pt.trace.json"))
    out = capsys.readouterr().out
    assert "64x16 N=32" in out and "4. full render" in out and "render:" in out


def test_make_demos_on_the_cpu(tmp_path):
    """make_demos writes both PNGs into the directory given: 2048 x 512,
    real terrain content, the labels it printed."""
    from PIL import Image

    res = make_demos.main([str(tmp_path), "--device", "cpu"])
    assert res["labels"] >= 1
    for key in ("panorama", "fog"):
        img = np.asarray(Image.open(res[key]))
        assert res[key].parent == tmp_path and img.shape == (512, 2048, 3)
        assert len(np.unique(img.reshape(-1, 3), axis=0)) > 200
