"""The port's tile backend, fetch client and background pipeline vs the JAX
package, on `tests/test_backend_pipeline.py`'s fixture.

The port's `BackendServer` serves the fixture; the port's and JAX's clients
fetch from it. Heights, transform, size, peak names and order must be
equal; peak positions equal within the camera tests' rtol 1e-6 (XLA's and
torch's float32 sin/cos may differ in a last bit). The runner's events and
notifications must come in JAX's order and counts.
"""

import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import topo_renderer_tpu.data.background as jbackground
from tests.test_backend_pipeline import TILE_N, make_fixtures
from topo_renderer_tpu.backend import server as jserver
from topo_renderer_tpu.config import Settings as JaxSettings
from topo_renderer_tpu.data import fetch as jfetch
from topo_renderer_tpu.geo import GeoCoord as JaxCoord, GeoLocation as JaxLocation
from topo_renderer_tpu_torch.backend import server
from topo_renderer_tpu_torch.backend.server import BackendServer
from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.data import background, fetch
from topo_renderer_tpu_torch.data.background import BackgroundRunner, DataRequested, fetch_terrain
from topo_renderer_tpu_torch.geo import GeoCoord, GeoLocation
from topo_renderer_tpu_torch.render import fonts


def _many_peaks(root, loc, n=240, seed=11):
    """Replace the fixture's peaks CSV by ``n`` seeded peaks, some outside
    the tile (dropped) and some with equal elevations (order ties)."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(48.9, 50.05, n)
    lon = rng.uniform(19.95, 21.05, n)
    elev = np.round(rng.uniform(500, 2600, n), 0)
    elev[::7] = 1500.0
    rows = [f"{a:.6f},{o:.6f},Gipfel {i},{e:.1f}" for i, (a, o, e) in enumerate(zip(lat, lon, elev))]
    (root / server.peaks_file_name(loc)).write_text("latitude,longitude,name,elevation\n" + "\n".join(rows) + "\n")


@pytest.fixture()
def backend(tmp_path):
    loc, heights = make_fixtures(tmp_path)
    srv = BackendServer(Settings(address="127.0.0.1", port=0, data_dir=str(tmp_path)))
    srv.start()
    yield srv, GeoLocation.from_coord(49, 20), heights, tmp_path
    srv.stop()


def test_file_names_equal():
    for lat, lon in ((49, 20), (-3, -70), (0, 0), (-90, 179), (89, -180)):
        loc, jloc = GeoLocation.from_coord(lat, lon), JaxLocation.from_coord(lat, lon)
        assert server.dem_file_name(loc) == jserver.dem_file_name(jloc)
        assert server.peaks_file_name(loc) == jserver.peaks_file_name(jloc)


def test_http_protocol(backend):
    srv, loc, heights, root = backend
    blob = fetch.get_tiff_from_http(srv.url, loc)
    assert blob == (root / server.dem_file_name(loc)).read_bytes()
    assert blob == jfetch.get_tiff_from_http(srv.url, JaxLocation.from_coord(49, 20))
    csv = fetch.get_peaks_from_http(srv.url, loc)
    assert csv == (root / server.peaks_file_name(loc)).read_bytes() and b"Testspitze" in csv
    # A missing tile: 200, text/html, an empty body -> None (`main.rs:56-59`).
    missing = GeoLocation.from_coord(10, 10)
    assert fetch.get_tiff_from_http(srv.url, missing) is None
    assert fetch.get_peaks_from_http(srv.url, missing) is None
    with urllib.request.urlopen(f"{srv.url}/dem?{missing.to_request_params()}") as r:
        assert r.status == 200 and r.headers["Content-Type"] == "text/html" and r.read() == b""
        assert r.headers["Access-Control-Allow-Origin"] == "*"
    with urllib.request.urlopen(f"{srv.url}/peaks?latitude=bogus") as r:
        assert r.status == 200 and r.read() == b""
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{srv.url}/nothing")
    assert e.value.code == 404


def test_request_burst_does_not_stall(backend):
    """The listen backlog holds a burst of 64 connections (socketserver's
    default of 5 drops SYNs past it, and each dropped one waits for the
    kernel's SYN retry), and all 64 requests are answered."""
    srv, loc, _, _ = backend
    assert srv._httpd.request_queue_size >= 64
    url = f"{srv.url}/peaks?{loc.to_request_params()}"
    bodies, errors = [], []

    def get():
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                bodies.append(r.read())
        except OSError as e:
            errors.append(e)

    threads = [threading.Thread(target=get) for _ in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads) and errors == [] and len(bodies) == 64
    assert len(set(bodies)) == 1 and bodies[0]


@pytest.mark.parametrize("have_zstd", [True, False])
def test_peaks_transport_encoding(backend, monkeypatch, have_zstd):
    """zstd only where `zstandard` imports, on the server and in the client."""
    srv, loc, _, root = backend
    monkeypatch.setattr(server, "_HAVE_ZSTD", have_zstd)
    req = urllib.request.Request(f"{srv.url}/peaks?{loc.to_request_params()}", headers={"Accept-Encoding": "zstd"})
    with urllib.request.urlopen(req) as r:
        assert r.headers.get("Content-Encoding") == ("zstd" if have_zstd else None)
    monkeypatch.setattr(fetch, "_HAVE_ZSTD", have_zstd)
    assert fetch.get_peaks_from_http(srv.url, loc) == (root / server.peaks_file_name(loc)).read_bytes()


@pytest.mark.parametrize("peaks", ["fixture", "seeded"])
def test_fetch_terrain_equal(backend, peaks):
    srv, loc, heights, root = backend
    if peaks == "seeded":
        _many_peaks(root, loc)
    got_peaks, (h, transform, size) = fetch_terrain(loc, Settings(backend_url=srv.url))
    want_peaks, (jh, jtransform, jsize) = jbackground.fetch_terrain(
        JaxLocation.from_coord(49, 20), JaxSettings(backend_url=srv.url))
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(h, heights)
    assert h.dtype == jh.dtype and size == jsize == (TILE_N, TILE_N)
    assert (transform.raster_point, transform.model_point, transform.pixel_scale) == (
        jtransform.raster_point, jtransform.model_point, jtransform.pixel_scale)
    assert [p.name for p in got_peaks] == [p.name for p in want_peaks] and len(got_peaks) > 1
    got_pos = np.stack([p.position for p in got_peaks])
    want_pos = np.stack([np.asarray(p.position) for p in want_peaks])
    assert got_pos.dtype == np.float32 and got_pos.shape == want_pos.shape
    np.testing.assert_allclose(got_pos, want_pos, rtol=1e-6)
    if peaks == "seeded":
        assert len(got_peaks) < 240  # peaks off the tile are dropped
        # Most are bit-equal; the rest differ in a last bit of sin/cos.
        assert (got_pos == want_pos).all(axis=1).mean() > 0.5


def _run(runner_cls, settings, requests):
    events, notes_seen = [], []
    runner = runner_cls(settings, lambda kind, payload: events.append((kind, payload)))
    notes = runner.subscribe()
    runner.spawn()
    try:
        for req in requests:
            runner.send(req)
        runner.drain(timeout=30)
    finally:
        runner.shutdown()
    while not notes.empty():
        n = notes.get_nowait()
        notes_seen.append((n.kind, n.name, n.error))
    return events, notes_seen


def test_runner_events_equal(backend):
    srv, loc, _, _ = backend
    cur = (49.35135, 20.21139)
    events, notes = _run(BackgroundRunner, Settings(backend_url=srv.url),
                         [DataRequested(requested=loc, current_location=GeoCoord(*cur))])
    jevents, jnotes = _run(jbackground.BackgroundRunner, JaxSettings(backend_url=srv.url),
                           [jbackground.DataRequested(requested=JaxLocation.from_coord(49, 20),
                                                      current_location=JaxCoord(*cur))])
    assert [k for k, _ in events] == [k for k, _ in jevents] == ["reset_camera", "peaks_ready", "terrain_ready"]
    assert notes == jnotes and [k for k, *_ in notes] == ["task_started", "task_finished"]
    got, want = dict(events), dict(jevents)
    assert got["reset_camera"]["height"] == want["reset_camera"]["height"]
    assert got["reset_camera"]["location"] == GeoCoord(*cur)
    np.testing.assert_array_equal(got["terrain_ready"]["heights"], want["terrain_ready"]["heights"])
    assert got["terrain_ready"]["size"] == want["terrain_ready"]["size"]


def test_runner_task_errored_equal(backend):
    """Missing tiles and a tile away from the viewpoint: no reset_camera
    event, errors and counts as JAX's."""
    srv, loc, _, _ = backend
    reqs = [((11, 11), (11.5, 11.5)), ((49, 20), (48.5, 19.5))]
    events, notes = _run(BackgroundRunner, Settings(backend_url=srv.url),
                         [DataRequested(GeoLocation.from_coord(*a), GeoCoord(*b)) for a, b in reqs])
    jevents, jnotes = _run(jbackground.BackgroundRunner, JaxSettings(backend_url=srv.url),
                           [jbackground.DataRequested(JaxLocation.from_coord(*a), JaxCoord(*b)) for a, b in reqs])
    assert [k for k, _ in events] == [k for k, _ in jevents] == ["peaks_ready", "terrain_ready"]
    assert sorted(notes) == sorted(jnotes)
    errors = [n for n in notes if n[0] == "task_errored"]
    assert len(errors) == 1 and "Empty terrain map" in errors[0][2]


def test_fetch_retries_equal(monkeypatch):
    """A transient URLError is retried; three failures raise FetchError, with
    the same attempts and back-off as JAX's `_get`."""

    class _Resp:
        headers = {}

        def read(self):
            return b"payload"

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    for mod in (fetch, jfetch):
        calls, sleeps = [], []

        def flaky(req, timeout=None):
            calls.append(req.full_url)
            if len(calls) == 1:
                raise urllib.error.URLError("connection reset")
            return _Resp()

        monkeypatch.setattr(mod.urllib.request, "urlopen", flaky)
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)
        assert mod._get("http://x/dem", timeout=1.0) == b"payload" and len(calls) == 2

        def down(req, timeout=None):
            calls.append(req.full_url)
            raise urllib.error.URLError("refused")

        monkeypatch.setattr(mod.urllib.request, "urlopen", down)
        with pytest.raises(mod.FetchError):
            mod._get("http://x/dem", timeout=1.0, retries=2)
        assert len(calls) == 5 and sleeps == [0.3, 0.3, 0.6]


def test_non_latin_peak_loads_its_font(backend, monkeypatch):
    """A CJK peak name makes the worker ask the process font library for
    its script's font (`background_runner.rs:250-254`); terrain_ready is not
    held up by it."""
    srv, loc, _, root = backend
    (root / server.peaks_file_name(loc)).write_text("latitude,longitude,name,elevation\n49.5,20.5,富士山,2500.0\n")
    asked = []
    done = threading.Event()

    class Lib:
        def load_additional_fonts(self, scripts):
            asked.append(set(scripts))
            done.set()
            return 0

    monkeypatch.setattr(fonts, "_library", Lib())
    events, _ = _run(BackgroundRunner, Settings(backend_url=srv.url),
                     [DataRequested(requested=loc, current_location=GeoCoord(49.35, 20.2))])
    assert done.wait(10) and asked == [{"Hani"}]
    assert [k for k, _ in events][-1] == "terrain_ready"
    assert background.PEAK_HEIGHT_OFFSET_M == jbackground.PEAK_HEIGHT_OFFSET_M


def test_server_main_uses_settings(monkeypatch):
    """`topo-backend-torch` serves on the address and port of Settings."""
    seen = {}

    class Fake:
        def __init__(self, settings):
            seen["settings"] = settings

        def serve_forever(self):
            seen["served"] = time.monotonic()

    monkeypatch.setattr(server, "BackendServer", Fake)
    monkeypatch.setenv("TOPO_PORT", "4321")
    monkeypatch.setenv("TOPO_ADDRESS", "127.0.0.1")
    server.main()
    assert seen["settings"].port == 4321 and seen["settings"].address == "127.0.0.1" and "served" in seen
