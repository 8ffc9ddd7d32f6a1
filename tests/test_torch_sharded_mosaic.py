"""The row-sharded mosaic (`parallel/sharded_mosaic.py`,
`parallel/sharded_update.py`) against the JAX package's, on the CPU.

The scene is `tests/test_sharded_mosaic.py`'s: one n=1281 tile, 0.5°
across, sharded over 8 row bands at ``size_threshold=500_000`` (level 0
sharded, level 1 windowed but replicated) or ``100_000`` (levels 0-2
sharded, level 2 read in full); clipmap specs window above 200_000 texels.
JAX's mosaic is carried across with `mosaic_from_arrays`, so both packages
shard the same tables. Port meshes name the CPU eight times; JAX's use its
eight virtual devices (`tests/conftest.py`).

Tolerances:
- Tables and windows: every band of every sharded leaf, every replicated
  leaf and every window equal JAX's bit for bit (int32 words).
- The port's sharded frames, panoramas and batches against the port's
  replicated ones on the same tables: bit for bit.
- Against JAX's sharded programs, the frame rule the repo states
  (`test_torch_panorama.py`, `test_torch_exact_frame.py`): u8 frames within
  2/255 on >= 99% of pixels against JAX evaluated primitive by primitive
  (`jax.disable_jit()`), and against the jitted program (FMA-contracted,
  `ROADMAP.md` §3) no further than that evaluation is, + 1%; hit masks
  equal on >= 99.9% of pixels, depth within 5e-3 relative on common hits.
  The panorama, the fast frame and the batch meet the first limit against
  the jitted program directly. For the exact frame the primitive-by-
  primitive reference is JAX's replicated frame: JAX's sharded exact frame
  equals it bit for bit (`tests/test_sharded_mosaic.py`), and its sharded
  program evaluated so on eight devices takes minutes.
- Slot updates: add and unload against `shard_mosaic` of the replicated
  update, bit for bit.
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tests.helpers import make_tile
from tests.test_torch_exact_frame import port_camera
from tests.test_torch_panorama import frac_bad
from tests.test_torch_parallel import _sharded_tables
from tests.test_torch_streaming import port_tile, streaming_engine
from tests.test_torch_window_slice import jax_mosaic_to_port
from topo_renderer_tpu.models.camera import Camera as JaxCamera
from topo_renderer_tpu.models.scene import build_mosaic as jax_build_mosaic
from topo_renderer_tpu.ops import raycast as jray
from topo_renderer_tpu.ops.panorama import PanoramaSpec as JaxSpec
from topo_renderer_tpu.ops.panorama import render_panorama as jax_render_panorama
from topo_renderer_tpu.ops.shading import to_srgb8_image as jax_srgb8
from topo_renderer_tpu.parallel import sharded_mosaic as jsm
from topo_renderer_tpu_torch.data.coordinate_transform import CoordinateTransform
from topo_renderer_tpu_torch.geo import GeoLocation
from topo_renderer_tpu_torch.models import mosaic_update
from topo_renderer_tpu_torch.models.scene import POISON_HEIGHT, TerrainTile, build_mosaic
from topo_renderer_tpu_torch.ops import crossing, window_slice
from topo_renderer_tpu_torch.ops.panorama import (
    PanoramaSpec,
    _clipmap_window_plan,
    extract_clipmap_windows,
    render_batch_scan,
    render_panorama,
)
from topo_renderer_tpu_torch.ops.raycast import render_perspective, render_perspective_fast
from topo_renderer_tpu_torch.ops.shading import to_srgb8_image
from topo_renderer_tpu_torch.ops.surface import (
    cell_rows,
    sample_attributes_cell,
    sample_attributes_nearest,
    sample_attributes_soa,
    sample_height,
    sample_height_level,
)
from topo_renderer_tpu_torch.parallel.mesh import Mesh
from topo_renderer_tpu_torch.parallel.sharded_mosaic import (
    extract_clipmap_windows_sharded,
    render_batch_scan_sharded,
    render_perspective_fast_sharded,
    render_perspective_sharded,
    shard_mosaic,
)
from topo_renderer_tpu_torch.parallel.sharded_update import apply_slot_update_sharded

THRESHOLDS = (500_000, 100_000)
COUNTERS = (crossing.crossing_search, window_slice.window_slice_multi,
            window_slice.window_slice_multi_batched, window_slice.window_slice)


def _jax_mesh(n=8):
    return JaxMesh(np.array(jax.devices()[:n]), ("geo",))


def _port_mesh(n=8):
    return Mesh(["cpu"] * n, ("geo",))


@pytest.fixture(scope="module")
def scene():
    """{"jm", "pm": the replicated mosaics, "eye": numpy, ("js", t), ("ps",
    t): sharded at threshold t, cell table kept}."""
    tile = make_tile(49, 20, n=1281, span_deg=0.5)
    jm = jax_build_mosaic([tile], on_device=True)
    lat, lon = np.radians(49.25), np.radians(20.25)
    r = 6_371_000.0 + 2200.0
    eye = np.array([r * np.cos(lat) * np.cos(lon), r * np.cos(lat) * np.sin(lon), r * np.sin(lat)], np.float32)
    out = {"jm": jm, "pm": jax_mosaic_to_port(jm), "eye": eye}
    for t in THRESHOLDS:
        out["js", t] = jsm.shard_mosaic(jm, _jax_mesh(), size_threshold=t, keep_cell_table=True)
        out["ps", t] = shard_mosaic(out["pm"], _port_mesh(), size_threshold=t, keep_cell_table=True)
    return out


def _spec(cls, **kw):
    kw.setdefault("clipmap_threshold", 200_000)
    return cls.fast(width=512, height=128, n_steps=192, **kw)


def _bits(x):
    return np.asarray(x).view(np.int32)


def _port_bits(x):
    return x.contiguous().view(torch.int32).numpy()


def _jax_bands(arr, row_axis):
    """A JAX array's addressable shards in row order."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[row_axis].start or 0)
    return [np.asarray(s.data) for s in shards]


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_shard_mosaic_equals_jax_shards(scene, threshold):
    """Every band of every sharded leaf equals JAX's addressable shard, and
    every replicated leaf JAX's array, word for word; shapes, padding,
    ``sharded_rows`` and the memory split match; the copy owns its memory."""
    js, ps, pm = scene["js", threshold], scene["ps", threshold], scene["pm"]
    assert ps.shape == js.shape and ps.mip_shapes == js.mip_shapes and ps.sharded_rows == js.sharded_rows
    assert ps.has_cell_table and ps.cell_sharded and ps.shape[0] % 64 == 0 and ps.shape[0] > pm.shape[0]
    assert ps.sharded_rows == ((0,) if threshold == 500_000 else (0, 1, 2))

    def leaf(name, p, j, row_axis=0):
        if isinstance(p, tuple):
            bands = _jax_bands(j, row_axis)
            assert len(p) == len(bands) == 8, name
            for b, (x, y) in enumerate(zip(p, bands)):
                # Each device holds 1/8 of the table, never a full copy.
                assert x.numel() == j.size // 8, (name, b)
                np.testing.assert_array_equal(_port_bits(x), _bits(y), err_msg=f"{name} band {b}")
        else:
            np.testing.assert_array_equal(_port_bits(p), _bits(j), err_msg=name)

    for name in ("heights_flat", "attr_packed_flat", "cell_heights_flat", "model_point", "pixel_scale", "hmax",
                 "bound_center", "bound_radius"):
        leaf(name, getattr(ps, name), getattr(js, name))
    for name in ("mip_heights_flat", "mip_attr_flat", "mip_hmax_flat"):
        for lv, (p, j) in enumerate(zip(getattr(ps, name), getattr(js, name))):
            leaf(f"{name}[{lv}]", p, j)
    assert len(ps.win_attr_2d) == len(js.win_attr_2d)
    for lv, (p, j) in enumerate(zip(ps.win_attr_2d, js.win_attr_2d)):
        assert (p is None) == (j is None)
        if p is not None:
            leaf(f"win_attr_2d[{lv}]", p, j, row_axis=1)
    pointers = {t.data_ptr() for name in ("mip_hmax_flat", "mip_heights_flat") for t in getattr(pm, name)}
    assert not pointers & {t.data_ptr() for t in ps.mip_hmax_flat}
    no_cell = shard_mosaic(pm, _port_mesh(), size_threshold=threshold)
    assert not no_cell.has_cell_table and not no_cell.cell_sharded and tuple(no_cell.cell_heights_flat.shape) == (1, 8)


def test_sharded_accessors_equal_jax(scene):
    """`heights`, `normals_packed` and `normals` of a sharded mosaic join
    the bands in row order, padded rows included (poisoned heights, zero
    words), as JAX's read its sharded arrays: bit for bit; the host
    bookkeeping (`valid`, `cell_tile`, `tile_rot`) of each package's own
    build passes through `shard_mosaic` unchanged, equal to JAX's."""
    js, ps, pm = scene["js", 500_000], scene["ps", 500_000], scene["pm"]
    assert ps.shape == js.shape and ps.shape[0] > pm.shape[0]
    np.testing.assert_array_equal(_bits(ps.heights.numpy()), _bits(js.heights))
    np.testing.assert_array_equal(ps.heights[: pm.shape[0]].numpy(), pm.heights.numpy())
    assert (ps.heights[pm.shape[0]:] == POISON_HEIGHT).all()
    packed = ps.normals_packed
    assert packed.dtype == torch.uint32 and packed.shape == ps.shape
    np.testing.assert_array_equal(packed.numpy(), np.asarray(js.normals_packed))
    assert not packed[pm.shape[0]:].view(torch.int32).any()
    np.testing.assert_array_equal(_bits(ps.normals.numpy()), _bits(js.normals))

    tile = make_tile(49, 20, n=65, span_deg=0.05)
    jm = jax_build_mosaic([tile], on_device=True)
    tr = tile.transform
    own = build_mosaic([TerrainTile(GeoLocation.from_coord(49, 20), tile.heights,
                                    CoordinateTransform(tr.raster_point, tr.model_point, tr.pixel_scale))],
                       device="cpu")
    js = jsm.shard_mosaic(jm, _jax_mesh(), size_threshold=500_000)
    ps = shard_mosaic(own, _port_mesh(), size_threshold=500_000)
    for name in ("valid", "cell_tile", "tile_rot"):
        np.testing.assert_array_equal(np.asarray(getattr(ps, name)), np.asarray(getattr(js, name)), err_msg=name)


def _windows_equal(a, b):
    """Count of the windowed entries; every entry equal word for word."""
    n = 0
    assert len(a) == len(b)
    for lv, (ea, eb) in enumerate(zip(a, b)):
        for j, (x, y) in enumerate(zip(ea, eb)):
            assert (x is None) == (y is None), (lv, j)
            if x is not None:
                n += 1
                x = _port_bits(x) if isinstance(x, torch.Tensor) else _bits(x)
                y = _port_bits(y) if isinstance(y, torch.Tensor) else _bits(y)
                np.testing.assert_array_equal(x, y, err_msg=f"level {lv} slot {j}")
    return n


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_sharded_extraction_equals_jax_and_replicated(scene, threshold):
    ps, eye = scene["ps", threshold], scene["eye"]
    spec = _spec(PanoramaSpec)
    for f in COUNTERS:
        f.launches = 0
    got = extract_clipmap_windows_sharded(ps, torch.from_numpy(eye), spec, _port_mesh())
    assert [f.launches for f in COUNTERS] == [0, 0, 0, 0]  # the CPU runs the plain versions
    want = jsm.extract_clipmap_windows_sharded(scene["js", threshold], jnp.asarray(eye), _spec(JaxSpec), _jax_mesh())
    assert _windows_equal(got, want) >= 2
    assert _windows_equal(got, extract_clipmap_windows(scene["pm"], torch.from_numpy(eye), spec)) >= 2
    # A sharded mosaic's own extraction routes to the sharded one.
    assert _windows_equal(extract_clipmap_windows(ps, torch.from_numpy(eye), spec), got) >= 2


def test_window_spanning_multiple_shard_bands(scene):
    """Windows taller than a band assemble from every band they span."""
    ps, eye = scene["ps", 500_000], scene["eye"]
    h_loc = ps.shape[0] // 8
    for n_steps in (256, 384, 512, 768, 1024):
        spec = PanoramaSpec.fast(width=512, height=128, n_steps=n_steps, clipmap_threshold=200_000)
        if any(u and wsy > h_loc for (_, u, wsy, _, _) in _clipmap_window_plan(spec, ps)):
            break
    else:
        pytest.fail("no spec exercises multi-band windows")
    jspec = JaxSpec.fast(width=512, height=128, n_steps=n_steps, clipmap_threshold=200_000)
    got = extract_clipmap_windows_sharded(ps, torch.from_numpy(eye), spec, _port_mesh())
    want = jsm.extract_clipmap_windows_sharded(scene["js", 500_000], jnp.asarray(eye), jspec, _jax_mesh())
    assert _windows_equal(got, want) >= 2
    assert _windows_equal(got, extract_clipmap_windows(scene["pm"], torch.from_numpy(eye), spec)) >= 2


def test_sharded_reads_equal_unsharded(scene):
    """`cell_rows` and every sampler read a sharded mosaic (levels 0-2 in
    bands) as the unsharded one, word for word, on and off the tables."""
    pm, ps = scene["pm"], scene["ps", 100_000]
    rng = np.random.default_rng(11)
    h, w = pm.shape
    # Rows past h - 1 are the sharded copy's padding, south of the scene:
    # samples there are outside it in both, but the cells they clamp to
    # differ.
    gx = torch.from_numpy(rng.uniform(-3.0, w + 2.0, (40, 50)).astype(np.float32))
    gy = torch.from_numpy(rng.uniform(-3.0, h - 1.0, (40, 50)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, h * w, (40, 50)))
    assert np.array_equal(_port_bits(cell_rows(ps, idx)), _port_bits(cell_rows(pm, idx)))
    for fn in (sample_attributes_cell, sample_attributes_soa, sample_attributes_nearest):
        for a, b in zip(fn(ps, gx, gy), fn(pm, gx, gy)):
            assert torch.equal(a, b), fn.__name__
    assert torch.equal(sample_height(ps, gx, gy), sample_height(pm, gx, gy))
    for level in range(4):
        for nearest in (False, True):
            assert torch.equal(sample_height_level(ps, level, gx, gy, nearest),
                               sample_height_level(pm, level, gx, gy, nearest)), (level, nearest)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_sharded_panorama(scene, threshold):
    """A panorama from the sharded windows equals the replicated one bit for
    bit, and JAX's sharded panorama at the frame tolerance; a spec that is
    not clipmapped reads the bands in full and equals it too."""
    pm, ps, eye = scene["pm"], scene["ps", threshold], scene["eye"]
    sun = np.array([0.3, 0.5, 0.8], np.float32)
    spec = _spec(PanoramaSpec)
    out_r = render_panorama(pm, torch.from_numpy(eye), spec, torch.from_numpy(sun), fog="atmosphere")
    out_s = render_panorama(ps, torch.from_numpy(eye), spec, torch.from_numpy(sun), fog="atmosphere",
                            windows=extract_clipmap_windows_sharded(ps, torch.from_numpy(eye), spec, _port_mesh()))
    assert 0.1 < float(out_r["hit"].float().mean()) < 0.9
    for k in ("color", "depth", "distance", "hit"):
        assert torch.equal(out_r[k], out_s[k]), k
    js = scene["js", threshold]
    jwin = jsm.extract_clipmap_windows_sharded(js, jnp.asarray(eye), _spec(JaxSpec), _jax_mesh())
    jout = jax_render_panorama(js, jnp.asarray(eye), _spec(JaxSpec), jnp.asarray(sun), fog="atmosphere", windows=jwin)
    assert frac_bad(to_srgb8_image(out_s["color"]).numpy(), np.asarray(jax_srgb8(jout["color"]))) <= 0.01
    assert (out_s["hit"].numpy() == np.asarray(jout["hit"])).mean() >= 0.999
    if threshold == 100_000:
        plain = PanoramaSpec(width=64, height=16, n_steps=64, n_refine=2)
        a = render_panorama(pm, torch.from_numpy(eye), plain, torch.from_numpy(sun))
        b = render_panorama(ps, torch.from_numpy(eye), plain, torch.from_numpy(sun))
        assert all(torch.equal(a[k], b[k]) for k in ("color", "depth", "hit")) and a["hit"].any()


def _frames_close(port, jax_out, eager=None):
    """The frame rule against JAX's jitted sharded frame, and with
    ``eager`` (JAX's frame evaluated primitive by primitive) against it."""
    pc = to_srgb8_image(port["color"]).numpy()
    jc = np.asarray(jax_srgb8(jax_out["color"]))
    if eager is None:
        assert frac_bad(pc, jc) <= 0.01, frac_bad(pc, jc)
    else:
        ec = np.asarray(jax_srgb8(eager["color"]))
        assert frac_bad(pc, ec) <= 0.01, frac_bad(pc, ec)
        assert frac_bad(pc, jc) <= frac_bad(ec, jc) + 0.01, (frac_bad(pc, jc), frac_bad(ec, jc))
    if "hit" not in port:  # a batch: colours only
        return
    ph, jh = port["hit"].numpy(), np.asarray(jax_out["hit"])
    assert (ph == jh).mean() >= 0.999
    both = ph & jh
    np.testing.assert_allclose(port["depth"].numpy()[both], np.asarray(jax_out["depth"])[both], rtol=5e-3)


def test_sharded_fast_frame(scene):
    pm, ps, eye = scene["pm"], scene["ps", 500_000], scene["eye"]
    jcam = JaxCamera(eye=jnp.asarray(eye), pitch=0.35, yaw=0.8)
    cam = port_camera(jcam)
    kw = dict(width=96, height=64, n_steps=256, clipmap_threshold=500_000)
    got = render_perspective_fast_sharded(ps, cam, _port_mesh(), **kw)
    ref = render_perspective_fast(pm, cam, **kw)
    for k in ("color", "depth", "distance", "hit"):
        assert torch.equal(got[k], ref[k]), k
    assert 0.1 < float(got["hit"].float().mean()) < 1.0
    _frames_close(got, jsm.render_perspective_fast_sharded(scene["js", 500_000], jcam, _jax_mesh(), **kw))


def test_sharded_exact_frame(scene):
    """The triangle-exact frame against the row-sharded cell table: every
    cell-row read gathered band by band; the padded poison rows south of
    the scene can only be missed."""
    pm, ps, eye = scene["pm"], scene["ps", 500_000], scene["eye"]
    jcam = JaxCamera(eye=jnp.asarray(eye), pitch=0.35, yaw=0.8)
    cam = port_camera(jcam)
    kw = dict(width=96, height=64, n_steps=256, n_refine=12, guided=True, fov_hint=math.radians(45.0))
    got = render_perspective_sharded(ps, cam, _port_mesh(), **kw)
    ref = render_perspective(pm, cam, **kw)
    for k in ("color", "depth", "distance", "hit"):
        assert torch.equal(got[k], ref[k]), k
    with jax.disable_jit():
        eager = jray.render_perspective(scene["jm"], jcam, **kw)
    _frames_close(got, jsm.render_perspective_sharded(scene["js", 500_000], jcam, _jax_mesh(), **kw), eager)
    with pytest.raises(ValueError, match="keep_cell_table"):
        render_perspective_sharded(shard_mosaic(pm, _port_mesh(), size_threshold=500_000), cam, **kw)


def test_sharded_batch_scan(scene):
    """Pass 1's band windows (K3 per band on the card), one assembly per
    level, pass 2 per eye: equal to the replicated batch scan bit for bit at
    both thresholds (at 100_000 level 2 is sharded but not windowed, so the
    render reads it band by band), and to JAX's sharded scan at the frame
    tolerance at 500_000. At 100_000 JAX's scan is off by up to 0.68 in a
    colour: its render inside the `shard_map` reads that level from the
    device's own band (`ROADMAP.md` §3)."""
    pm, eye = scene["pm"], scene["eye"]
    spec = _spec(PanoramaSpec)
    eyes = torch.from_numpy(np.stack([eye, eye * np.float32(1.0 + 1e-5)]))
    suns = torch.tensor([[0.3, 0.5, 0.8]]).expand(2, 3).contiguous()
    want = render_batch_scan(pm, eyes, suns, spec, fog="atmosphere")
    for t in THRESHOLDS:
        got = render_batch_scan_sharded(scene["ps", t], eyes, suns, spec, _port_mesh(), fog="atmosphere")
        assert torch.equal(got, want), t
    assert torch.equal(render_batch_scan(scene["ps", 100_000], eyes, suns, spec, fog="atmosphere"), want)
    jgot = np.asarray(jsm.render_batch_scan_sharded(scene["js", 500_000], jnp.asarray(eyes.numpy()),
                                                    jnp.asarray(suns.numpy()), _spec(JaxSpec), _jax_mesh(),
                                                    fog="atmosphere"))
    for i in range(2):
        _frames_close({"color": want[i]}, {"color": jgot[i]})


def test_sharded_slot_update_bit_matches_resharded(monkeypatch):
    """Add and unload against a 2-band sharded streaming mosaic equal
    `shard_mosaic` of the replicated update bit for bit (the update math is
    shared, `compute_slot_blocks`; this holds the band reads and writes)."""
    mesh = _port_mesh(2)
    eng = streaming_engine()
    a, b = port_tile(0, 0), port_tile(0, 1)
    for t in (a, b):
        eng.add_terrain(t.location, t.heights, t.transform)
    m0 = eng.mosaic
    assert not eng._pending

    calls = []
    orig = mosaic_update.apply_slot_update

    def spy(m, blk, oy, ox, slices, rot, geo, **kw):
        calls.append((blk.clone(), oy, ox, slices, rot.clone(), geo, dict(kw)))
        return orig(m, blk, oy, ox, slices, rot, geo, **kw)

    from topo_renderer_tpu_torch.render import engine as engine_mod

    monkeypatch.setattr(engine_mod, "apply_slot_update", spy)
    skw = dict(size_threshold=10_000, keep_cell_table=True)
    s = shard_mosaic(m0, mesh, **skw)
    assert 0 in s.sharded_rows and s.shape == m0.shape  # aligned, unpadded
    c = port_tile(1, 1)
    for step in ("add", "unload"):
        if step == "add":
            eng.add_terrain(c.location, c.heights, c.transform)
        else:
            eng.unload_terrain(b.location)
        replicated = eng.mosaic  # applies the queued slot update
        blk, oy, ox, slices, rot, geo, kw = calls[-1]
        s = apply_slot_update_sharded(s, blk, oy, ox, slices, rot, geo, mesh, **kw)
        want = _sharded_tables(dataclasses.replace(shard_mosaic(replicated, mesh, **skw),
                                                   bound_center=s.bound_center, bound_radius=s.bound_radius))
        got = _sharded_tables(s)
        assert got.keys() == want.keys()
        assert [k for k in want if not np.array_equal(got[k].numpy(), want[k].numpy())] == [], step
        assert float(s.hmax) == float(replicated.hmax)
    assert len(calls) == 2
