"""The port's host data modules vs the JAX package: settings, peaks CSV,
GeoTIFF write and read (Python and native decoders), the native overlay
primitives, depth-state helpers and image output.

Mirrors `tests/test_{config,peak,tiff,native,misc}.py`: the same inputs,
made from a numpy seed, go through both packages and must give equal
results, bit for bit. TIFFs of every layout the decoders accept (strips and
tiles, little- and big-endian, compression 1/5/8/32946, predictors 1/2/3)
are built here, beside JAX's own fixtures.
"""

import ctypes
import io
import struct
import zlib

import numpy as np
import pytest

import topo_renderer_tpu.data.tiff as jtiff
from tests.test_native import _minimal_tiff
from tests.test_tiff import PIXEL_SCALE, TIEPOINT, _deflate_variant, synthetic_heights
from topo_renderer_tpu import native as jnative
from topo_renderer_tpu.config import Settings as JaxSettings
from topo_renderer_tpu.data import peak as jpeak
from topo_renderer_tpu.geo import GeoCoord as JaxCoord
from topo_renderer_tpu.models import depth_state as jdepth
from topo_renderer_tpu.models.camera import Camera as JaxCamera
from topo_renderer_tpu.utils import imageio as jimageio
from topo_renderer_tpu_torch import native
from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.data import peak, tiff
from topo_renderer_tpu_torch.geo import GeoCoord
from topo_renderer_tpu_torch.models import depth_state
from topo_renderer_tpu_torch.models.camera import Camera
from topo_renderer_tpu_torch.utils import imageio

# ---- config -------------------------------------------------------------

CONFIG_CASES = {
    "defaults": ("", {}),
    "file": ('data_dir = "/srv/dem"\nbackend_url = "http://tiles:3333"\nport = 4444\n', {}),
    "env wins": ('data_dir = "/srv/dem"\nport = 4444\n', {"TOPO_PORT": "5555", "TOPO_DATA_DIR": "/other"}),
    "extra keys": ('custom_flag = "yes"\n', {"TOPO_SOMETHING": "x", "OTHER": "y"}),
    "geo shard": ("geo_shard = 2\n", {"TOPO_ADDRESS": "127.0.0.1"}),
}


@pytest.mark.parametrize("case", CONFIG_CASES)
def test_settings_equal(case, tmp_path):
    text, env = CONFIG_CASES[case]
    path = tmp_path / "Settings.toml"
    if text:
        path.write_text(text)
    got = Settings.load(path=path, env=env)
    want = JaxSettings.load(path=path, env=env)
    assert vars(got) == vars(want)


# ---- peaks --------------------------------------------------------------

CSV_SAMPLE = (
    "latitude,longitude,name,elevation\n"
    "49.542824,20.111383,Turbacz,1310.0\n"
    "50.054916,19.893354,Kopiec Kościuszki,326.5\n"
)


def _seeded_csv(seed=3, n=300):
    rng = np.random.default_rng(seed)
    rows = [f"{rng.uniform(44, 47):.6f},{rng.uniform(11, 14):.6f},Peak {i},{rng.uniform(200, 4000):.1f}"
            for i in range(n)]
    return "latitude,longitude,name,elevation\n" + "\n".join(rows) + "\n"


def _peaks_tuple(peaks):
    return [(p.latitude, p.longitude, p.name, p.elevation) for p in peaks]


@pytest.mark.parametrize("source", ["str", "bytes", "stream", "seeded"])
def test_read_peaks_equal(source):
    text = _seeded_csv() if source == "seeded" else CSV_SAMPLE
    make = {"str": lambda: text, "bytes": lambda: text.encode(), "stream": lambda: io.BytesIO(text.encode()),
            "seeded": lambda: text}[source]
    got, want = peak.read_peaks(make()), jpeak.read_peaks(make())
    assert _peaks_tuple(got) == _peaks_tuple(want)
    assert _peaks_tuple(peak.sort_by_elevation_desc(got)) == _peaks_tuple(jpeak.sort_by_elevation_desc(want))


def test_read_peaks_errors_equal():
    bad = "latitude,longitude,name,elevation\n49.5,20.1,Good,1310.0\noops,20.1,Bad1,100.0\n49.5,nope,Bad2,abc\n4\n"
    with pytest.raises(peak.PeakCsvError) as got:
        peak.read_peaks(bad)
    with pytest.raises(jpeak.PeakCsvError) as want:
        jpeak.read_peaks(bad)
    assert [str(e) for e in got.value.errors] == [str(e) for e in want.value.errors]
    assert str(got.value) == str(want.value) and len(got.value.errors) == 3


# ---- TIFF ---------------------------------------------------------------

def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first, early change), as `tests/test_tiff.py` encodes."""
    table = {bytes([i]): i for i in range(256)}
    next_code, bits = 258, 9
    codes = [(256, 9)]
    prev = b""
    for byte in data:
        cur = prev + bytes([byte])
        if cur in table:
            prev = cur
            continue
        codes.append((table[prev], bits))
        table[cur] = next_code
        next_code += 1
        if next_code + 1 > (1 << bits) and bits < 12:
            bits += 1
        prev = bytes([byte])
    if prev:
        codes.append((table[prev], bits))
    codes.append((257, bits))
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc = (acc << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def _predict(block: np.ndarray, predictor: int, bo: str) -> bytes:
    """Encode one [rows, cols] block's bytes with a TIFF predictor."""
    if predictor == 1:
        return block.astype(block.dtype.newbyteorder(bo)).tobytes()
    if predictor == 2:
        diff = block.copy()
        diff[:, 1:] = block[:, 1:] - block[:, :-1]  # wraps in the integer type
        return diff.astype(block.dtype.newbyteorder(bo)).tobytes()
    # Floating-point predictor: each row's big-endian bytes split into
    # planes (most significant first), then byte-differenced along the row.
    rows, cols = block.shape
    size = block.dtype.itemsize
    planes = block.astype(block.dtype.newbyteorder(">")).view(np.uint8).reshape(rows, cols, size)
    flat = planes.transpose(0, 2, 1).reshape(rows, cols * size)
    out = flat.copy()
    out[:, 1:] = flat[:, 1:] - flat[:, :-1]
    return out.tobytes()


def make_tiff(heights, *, bo="<", compression=1, predictor=1, tile=None, rows_per_strip=None):
    """A single-band GeoTIFF of ``heights`` (its dtype) in any layout the
    decoders read: strips of ``rows_per_strip`` rows, or ``tile`` = (th, tw)
    tiles padded at the edges; byte order ``bo``."""
    h, w = heights.shape
    fmt = {"f": 3, "i": 2, "u": 1}[heights.dtype.kind]
    bits = heights.dtype.itemsize * 8
    if tile is None:
        rps = rows_per_strip or h
        blocks = [heights[y : y + rps] for y in range(0, h, rps)]
    else:
        th, tw = tile
        blocks = []
        for y in range(0, h, th):
            for x in range(0, w, tw):
                blk = np.zeros((th, tw), heights.dtype)
                part = heights[y : y + th, x : x + tw]
                blk[: part.shape[0], : part.shape[1]] = part
                blocks.append(blk)
    raw = [_predict(b, predictor, bo) for b in blocks]
    comp = {1: lambda b: b, 5: _lzw_encode, 8: zlib.compress, 32946: zlib.compress}[compression]
    payloads = [comp(b) for b in raw]
    tags = [
        (256, 4, 1, struct.pack(bo + "I", w)),
        (257, 4, 1, struct.pack(bo + "I", h)),
        (258, 3, 1, struct.pack(bo + "H", bits)),
        (259, 3, 1, struct.pack(bo + "H", compression)),
        (262, 3, 1, struct.pack(bo + "H", 1)),
        (277, 3, 1, struct.pack(bo + "H", 1)),
        (317, 3, 1, struct.pack(bo + "H", predictor)),
        (339, 3, 1, struct.pack(bo + "H", fmt)),
        (33550, 12, 3, struct.pack(bo + "3d", *PIXEL_SCALE)),
        (33922, 12, 6, struct.pack(bo + "6d", *TIEPOINT)),
    ]
    n = len(payloads)
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    if tile:
        tags += [(322, 3, 1, struct.pack(bo + "H", tile[1])), (323, 3, 1, struct.pack(bo + "H", tile[0]))]
    else:
        tags.append((278, 4, 1, struct.pack(bo + "I", rows_per_strip or h)))
    entries = sorted(tags + [(off_tag, 4, n, b"\0" * 4 * n),
                             (cnt_tag, 4, n, struct.pack(bo + f"{n}I", *map(len, payloads)))])
    data_start = 8 + 2 + 12 * len(entries) + 4
    payload_start = data_start + sum(len(v) for *_, v in entries if len(v) > 4)
    offsets = payload_start + np.cumsum([0] + [len(p) for p in payloads[:-1]])
    entries = [(t, ty, c, struct.pack(bo + f"{n}I", *map(int, offsets)) if t == off_tag else v)
               for t, ty, c, v in entries]
    buf = io.BytesIO()
    buf.write((b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42, 8))
    buf.write(struct.pack(bo + "H", len(entries)))
    cursor = data_start
    for tag, typ, count, packed in entries:
        if len(packed) <= 4:
            buf.write(struct.pack(bo + "HHI", tag, typ, count) + packed.ljust(4, b"\0"))
        else:
            buf.write(struct.pack(bo + "HHII", tag, typ, count, cursor))
            cursor += len(packed)
    buf.write(struct.pack(bo + "I", 0))
    for *_, packed in entries:
        if len(packed) > 4:
            buf.write(packed)
    for p in payloads:
        buf.write(p)
    return buf.getvalue()


def _ints(dtype, shape=(23, 37), seed=4):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -30000), min(info.max, 30000), size=shape, endpoint=True).astype(dtype)


LAYOUTS = {
    "float32 strips": (lambda: synthetic_heights(23, 37), {}),
    "float32 3-row strips big-endian": (lambda: synthetic_heights(23, 37), dict(bo=">", rows_per_strip=3)),
    "float32 lzw": (lambda: synthetic_heights(17, 21), dict(compression=5)),
    "float32 deflate": (lambda: synthetic_heights(19, 23), dict(compression=8)),
    "float32 old deflate": (lambda: synthetic_heights(19, 23), dict(compression=32946, rows_per_strip=5)),
    "float32 predictor 3": (lambda: synthetic_heights(21, 29), dict(predictor=3, compression=8)),
    "float32 predictor 3 big-endian lzw": (lambda: synthetic_heights(21, 29), dict(predictor=3, compression=5, bo=">")),
    "float32 tiles": (lambda: synthetic_heights(40, 50), dict(tile=(16, 16))),
    "float32 tiles big-endian deflate": (lambda: synthetic_heights(40, 50), dict(tile=(16, 32), bo=">", compression=8)),
    "float64 strips": (lambda: synthetic_heights(13, 17).astype(np.float64), dict(rows_per_strip=4)),
    "int16 predictor 2": (lambda: _ints(np.int16), dict(predictor=2, compression=8)),
    "int16 big-endian predictor 2 tiles": (lambda: _ints(np.int16), dict(predictor=2, bo=">", tile=(16, 16))),
    "uint16 lzw": (lambda: _ints(np.uint16), dict(compression=5)),
    "int32 predictor 2": (lambda: _ints(np.int32), dict(predictor=2, rows_per_strip=7)),
    "uint8": (lambda: _ints(np.uint8), {}),
    "int8 big-endian": (lambda: _ints(np.int8), dict(bo=">")),
    "uint32 tiles": (lambda: _ints(np.uint32), dict(tile=(16, 16), compression=5)),
}


def _excess_strips():
    w = h = 4
    rows = np.arange(w, dtype="<f4")
    payload = (rows.tobytes() + rows.tobytes()) * 4

    def build(start):
        offs = struct.pack("<4I", *[start + i * 2 * w * 4 for i in range(4)])
        return _minimal_tiff([
            (256, 4, 1, struct.pack("<I", w)), (257, 4, 1, struct.pack("<I", h)),
            (258, 3, 1, struct.pack("<H", 32)), (259, 3, 1, struct.pack("<H", 1)),
            (277, 3, 1, struct.pack("<H", 1)), (278, 4, 1, struct.pack("<I", 2)),
            (273, 4, 4, offs), (279, 4, 4, struct.pack("<4I", *([2 * w * 4] * 4))),
            (339, 3, 1, struct.pack("<H", 3)),
        ], payload)

    return build(len(build(0)) - len(payload))


def _tiles_without_dims():
    payload = np.zeros((4, 4), "<f4").tobytes()

    def build(start):
        return _minimal_tiff([
            (256, 4, 1, struct.pack("<I", 4)), (257, 4, 1, struct.pack("<I", 4)),
            (258, 3, 1, struct.pack("<H", 32)), (259, 3, 1, struct.pack("<H", 1)),
            (277, 3, 1, struct.pack("<H", 1)), (324, 4, 1, struct.pack("<I", start)),
            (325, 4, 1, struct.pack("<I", len(payload))), (339, 3, 1, struct.pack("<H", 3)),
        ], payload)

    return build(len(build(0)) - len(payload))


def _bad_lzw():
    stream = bytes([0x20, 0xCB, 0x00])  # literal 65, then code 300 beyond the table

    def build(start):
        return _minimal_tiff([
            (256, 4, 1, struct.pack("<I", 4)), (257, 4, 1, struct.pack("<I", 4)),
            (258, 3, 1, struct.pack("<H", 32)), (259, 3, 1, struct.pack("<H", 5)),
            (277, 3, 1, struct.pack("<H", 1)), (278, 4, 1, struct.pack("<I", 4)),
            (273, 4, 1, struct.pack("<I", start)), (279, 4, 1, struct.pack("<I", len(stream))),
            (339, 3, 1, struct.pack("<H", 3)),
        ], stream)

    return build(len(build(0)) - len(stream))


# JAX's fixtures (`tests/test_tiff.py`, `tests/test_native.py`) as blobs.
FIXTURES = {
    "writer roundtrip": lambda: jtiff.write_geotiff(synthetic_heights(), PIXEL_SCALE, TIEPOINT),
    "deflate variant": lambda: _deflate_variant(jtiff.write_geotiff(synthetic_heights(19, 23), PIXEL_SCALE, TIEPOINT)),
    "garbage": lambda: b"definitely not a tiff",
    "bigtiff magic": lambda: b"II\x2b\x00\x00\x00\x00\x00",
    "excess strips": _excess_strips,
    "tiles without dims": _tiles_without_dims,
    "bad lzw code": _bad_lzw,
}
for _name, (_make, _kw) in LAYOUTS.items():
    FIXTURES[_name] = (lambda make=_make, kw=_kw: make_tiff(make(), **kw))


def _outcome(fn, blob):
    try:
        heights, info = fn(blob)
    except Exception as e:  # noqa: BLE001 - both packages must fail alike
        return ("error", type(e).__name__, str(e))
    return ("ok", heights.dtype.str, heights.tobytes(), heights.shape, info.width, info.height,
            info.dtype.str, info.pixel_scale, info.tiepoint, info.model_transformation)


@pytest.mark.parametrize("name", FIXTURES)
def test_read_geotiff_python_path_equal(name, monkeypatch):
    monkeypatch.setattr(tiff, "_try_native", lambda data: None)
    monkeypatch.setattr(jtiff, "_try_native", lambda data: None)
    blob = FIXTURES[name]()
    got, want = _outcome(tiff.read_geotiff, blob), _outcome(jtiff.read_geotiff, blob)
    assert got == want
    # The Python decoder keeps the source dtype. It undoes predictor 2 in
    # the host's byte order, so a big-endian file with it decodes wrong in
    # both packages (a reference limitation, kept): equal, not checked.
    if name in LAYOUTS and not ("big-endian" in name and "predictor 2" in name):
        assert got[0] == "ok"
        src = LAYOUTS[name][0]()
        expect = src.astype(np.float32) if src.dtype.kind == "f" else src
        np.testing.assert_array_equal(np.frombuffer(got[2], np.dtype(got[1])).reshape(got[3]), expect)


@pytest.mark.parametrize("name", FIXTURES)
def test_read_geotiff_native_path_equal(name):
    assert native.available() and jnative.available(), "g++ and zlib build both native libraries"
    blob = FIXTURES[name]()
    got, want = native.tiff_decode(blob), jnative.tiff_decode(blob)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == np.float32 and got[1] == want[1]
    # The default path: native where it decodes, Python where it declines.
    assert _outcome(tiff.read_geotiff, blob) == _outcome(jtiff.read_geotiff, blob)


def test_disable_native_env(monkeypatch):
    """TOPO_DISABLE_NATIVE: the library is not loaded and the Python decoder
    returns the source's integer dtype where the native one gives float32."""
    blob = make_tiff(_ints(np.int16), predictor=2)
    assert native.tiff_decode(blob)[0].dtype == np.float32
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("TOPO_DISABLE_NATIVE", "1")
    assert not native.available() and native.tiff_decode(blob) is None
    heights, info = tiff.read_geotiff(blob)
    assert heights.dtype == np.int16 and info.dtype == np.int16


def test_native_builds_outside_the_package():
    path = native.lib_path()
    assert path.exists() and path.parent.name == "topo_renderer_tpu_torch" and path.parent.parent.name == "build"


@pytest.mark.parametrize("seed", range(4))
def test_write_geotiff_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 70, 2))
    heights = rng.normal(1500.0, 400.0, (h, w)).astype(np.float32 if seed % 2 else np.float64)
    scale = tuple(float(v) for v in rng.uniform(1e-4, 1e-2, 2)) + (0.0,)
    tie = (0.0, 0.0, 0.0, float(rng.uniform(-180, 180)), float(rng.uniform(-90, 90)), 0.0)
    blob = tiff.write_geotiff(heights, scale, tie)
    assert blob == jtiff.write_geotiff(heights, scale, tie)
    np.testing.assert_array_equal(tiff.read_geotiff(blob)[0], heights.astype(np.float32))


def test_overlay_primitives_equal():
    """The port's native overlay primitives draw what JAX's do, on seeded
    shapes and at the edges of the image."""
    libs = (native.load(), jnative.load())
    rng = np.random.default_rng(7)
    imgs = [np.zeros((32, 48, 3), np.uint8) for _ in libs]
    glyph = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    for _ in range(12):
        line = [float(v) for v in rng.uniform(-8, 56, 4)]
        rect = [float(v) for v in (*rng.uniform(-4, 40, 2), *rng.uniform(1, 30, 2), rng.uniform(0, 0.5))]
        col = [int(v) for v in rng.integers(0, 256, 3)]
        gx, gy = (int(v) for v in rng.integers(-5, 50, 2))
        for lib, img in zip(libs, imgs):
            ptr = img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            lib.topo_fill_round_rect(ptr, 48, 32, *rect, *col)
            lib.topo_draw_line(ptr, 48, 32, *line, *col[::-1])
            lib.topo_blit_glyph(ptr, 48, 32, glyph.ctypes.data_as(ctypes.c_char_p), 9, 7, gx, gy, *col)
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert imgs[0].any()


# ---- depth state and image output ----------------------------------------

def test_depth_state_equal():
    assert [depth_state.pad_256(v) for v in (0, 1, 256, 257, 3200)] == [jdepth.pad_256(v) for v in (0, 1, 256, 257, 3200)]
    cam, jcam = Camera().reset(GeoCoord(49.0, 20.0), 1500.0), JaxCamera().reset(JaxCoord(49.0, 20.0), 1500.0)
    state = depth_state.DepthState(depth_state.Size(800, 600), cam)
    jstate = jdepth.DepthState(jdepth.Size(800, 600), jcam)
    for size, other, jother in ((depth_state.Size(800, 600), cam, jcam), (depth_state.Size(640, 480), cam, jcam),
                                (depth_state.Size(800, 600), cam.rotate_yaw(0.1), jcam.rotate_yaw(0.1))):
        assert state.matches(size, other) == jstate.matches(jdepth.Size(size.width, size.height), jother)
    assert state.matches(depth_state.Size(800, 600), cam)


def test_image_output_equal(tmp_path):
    img = np.random.default_rng(8).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    assert imageio.encode_png(img) == jimageio.encode_png(img)
    assert imageio.encode_jpeg(img, quality=70) == jimageio.encode_jpeg(img, quality=70)
    imageio.save_image(tmp_path / "a.png", img)
    jimageio.save_image(tmp_path / "b.png", img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
