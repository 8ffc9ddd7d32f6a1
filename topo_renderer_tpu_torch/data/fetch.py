"""HTTP tile/peaks fetch client.

Copy of `topo_renderer_tpu/data/fetch.py` for the PyTorch port; it imports nothing
of the JAX package.

Parity with the reference's reqwest calls
(`topo-renderer/src/control/background_runner.rs:170-199`):
  * ``GET {backend_url}/dem?latitude=49N&longitude=20E`` -> GeoTIFF bytes
  * ``GET {backend_url}/peaks?...`` -> CSV bytes (zstd transport encoding
    when the server negotiates it)
  * an empty body means "no tile here" and maps to ``None``
    (`background_runner.rs:113-115,186-198`).
"""

from __future__ import annotations

import time
import urllib.error
import urllib.request

from topo_renderer_tpu_torch.geo import GeoLocation

try:
    import zstandard

    _HAVE_ZSTD = True
except Exception:  # pragma: no cover
    _HAVE_ZSTD = False


class FetchError(RuntimeError):
    pass


def _get(url: str, timeout: float, retries: int = 2) -> bytes | None:
    """GET with bounded retries: a transiently-failing tile fetch (connection
    reset, server momentarily busy) would otherwise poison the tile for the
    whole session and surface as a misleading 'no terrain arrived' timeout."""
    headers = {"Accept-Encoding": "zstd" if _HAVE_ZSTD else "identity"}
    req = urllib.request.Request(url, headers=headers)
    last: Exception | None = None
    for attempt in range(retries + 1):
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                body = resp.read()
                if resp.headers.get("Content-Encoding") == "zstd":
                    if not _HAVE_ZSTD:
                        raise FetchError(
                            "server sent zstd but zstandard is unavailable"
                        )
                    body = zstandard.ZstdDecompressor().decompress(
                        body, max_output_size=256 * 1024 * 1024
                    )
            return body if body else None
        except urllib.error.URLError as e:
            last = e
            if attempt < retries:
                time.sleep(0.3 * 2**attempt)
    raise FetchError(f"fetch failed for {url}: {last}") from last


def get_tiff_from_http(backend_url: str, location: GeoLocation, timeout: float = 60.0) -> bytes | None:
    """`background_runner.rs:170-184`."""
    return _get(f"{backend_url}/dem?{location.to_request_params()}", timeout)


def get_peaks_from_http(backend_url: str, location: GeoLocation, timeout: float = 60.0) -> bytes | None:
    """`background_runner.rs:186-199`."""
    return _get(f"{backend_url}/peaks?{location.to_request_params()}", timeout)
