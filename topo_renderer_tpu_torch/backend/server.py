"""Tile data backend: HTTP server for DEM GeoTIFFs and peak CSVs.

Copy of `topo_renderer_tpu/backend/server.py` for the PyTorch port; it imports nothing
of the JAX package.

Drop-in equivalent of the reference's axum service
(`topo-backend/src/main.rs`), protocol-compatible so either backend can
serve either client:
  * ``GET /peaks?latitude=49N&longitude=20E`` -> text/csv, zstd-compressed
    when the client accepts it (`main.rs:117-125`); file name
    ``peaks/peaks_{lat}_{lon}.csv`` with sign-prefixed integers
    (`main.rs:35-47`).
  * ``GET /dem?latitude=...&longitude=...`` -> image/tiff
    (`main.rs:63-93`); file name
    ``COP90/COP90_hh/Copernicus_DSM_30_{N|S}{lat:02}_00_{E|W}{lon:03}_00_DEM.tif``.
  * A missing file returns an **empty 200 body with text/html** — the
    client treats empty as "no tile" (`main.rs:56-59,88-92`).
  * CORS: GET from any origin (`main.rs:100-102`).
  * Config: ``Settings.toml`` {address, port, data_dir} + ``TOPO_*`` env
    (`main.rs:104-110`), defaults 0.0.0.0:3333.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

from topo_renderer_tpu_torch.config import Settings
from topo_renderer_tpu_torch.geo import (
    GeoLocation,
    LatitudeDirection,
    LongitudeDirection,
    parse_latitude,
    parse_longitude,
)

try:
    import zstandard

    _HAVE_ZSTD = True
except Exception:  # pragma: no cover
    _HAVE_ZSTD = False


def peaks_file_name(location: GeoLocation) -> str:
    """`topo-backend/src/main.rs:35-47` — sign-prefixed integer degrees."""
    lat_sign = "" if location.latitude.direction == LatitudeDirection.N else "-"
    lon_sign = "" if location.longitude.direction == LongitudeDirection.E else "-"
    return (
        f"peaks/peaks_{lat_sign}{location.latitude.degree}_"
        f"{lon_sign}{location.longitude.degree}.csv"
    )


def dem_file_name(location: GeoLocation) -> str:
    """`topo-backend/src/main.rs:67-79` — Copernicus naming convention."""
    ns = "N" if location.latitude.direction == LatitudeDirection.N else "S"
    ew = "E" if location.longitude.direction == LongitudeDirection.E else "W"
    return (
        f"COP90/COP90_hh/Copernicus_DSM_30_{ns}{location.latitude.degree:02d}"
        f"_00_{ew}{location.longitude.degree:03d}_00_DEM.tif"
    )


class _Handler(BaseHTTPRequestHandler):
    settings: Settings = Settings()

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _parse_location(self, query: dict) -> GeoLocation | None:
        try:
            return GeoLocation(
                parse_latitude(query["latitude"][0]),
                parse_longitude(query["longitude"][0]),
            )
        except (KeyError, ValueError, IndexError):
            return None

    def _empty(self):
        # Missing file -> empty body, text/html (`main.rs:56-59`).
        self.send_response(200)
        self.send_header("Content-Type", "text/html")
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _serve(self, rel_name: str, content_type: str, compress: bool):
        path = Path(self.settings.data_dir) / rel_name
        try:
            body = path.read_bytes()
        except OSError:
            self._empty()
            return
        encoding = None
        if (
            compress
            and _HAVE_ZSTD
            and "zstd" in self.headers.get("Accept-Encoding", "")
        ):
            # zstd at the fastest level (`main.rs:120-125`).
            body = zstandard.ZstdCompressor(level=1).compress(body)
            encoding = "zstd"
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Access-Control-Allow-Origin", "*")
        if encoding:
            self.send_header("Content-Encoding", encoding)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        query = parse_qs(url.query)
        if url.path == "/peaks":
            loc = self._parse_location(query)
            if loc is None:
                self._empty()
                return
            self._serve(peaks_file_name(loc), "text/csv", compress=True)
        elif url.path == "/dem":
            loc = self._parse_location(query)
            if loc is None:
                self._empty()
                return
            self._serve(dem_file_name(loc), "image/tiff", compress=False)
        else:
            self.send_response(404)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", "0")
            self.end_headers()


class BacklogHTTPServer(ThreadingHTTPServer):
    """A threading HTTP server with a listen backlog of 128.

    socketserver's backlog of 5 overflows when clients open many
    connections at once (a fetch client's 8 workers open their tile and
    peaks connections together; browser tabs keep two frames and a status
    poll each); Linux then drops the SYN and the client resends it after
    1 s, so the request stalls for a second or more. The JAX package's
    servers keep the 5."""

    request_queue_size = 128


class BackendServer:
    """Embeddable server (used by tests and the CLI `topo-backend-torch`)."""

    def __init__(self, settings: Settings | None = None):
        self.settings = settings or Settings.load()
        handler = type("BoundHandler", (_Handler,), {"settings": self.settings})
        self._httpd = BacklogHTTPServer(
            (self.settings.address, int(self.settings.port)), handler
        )
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self.settings.address
        if host == "0.0.0.0":
            host = "127.0.0.1"
        return f"http://{host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def serve_forever(self) -> None:
        self._httpd.serve_forever()


def main() -> None:
    import logging

    logging.basicConfig(level=logging.INFO)
    settings = Settings.load()
    logging.info("Starting api backend service on %s:%s", settings.address, settings.port)
    BackendServer(settings).serve_forever()


if __name__ == "__main__":
    main()
