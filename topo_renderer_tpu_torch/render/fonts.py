"""Per-script runtime font acquisition for peak labels.

Copy of `topo_renderer_tpu/render/fonts.py` for the PyTorch port, with the
same script -> URL table, cache, operator directory and switches.

Parity with the reference's Google-Fonts pipeline
(`topo-renderer/src/render/text_renderer.rs:28-48,160-196`): labels are
shaped with a bundled default face, and when a label's leading character
belongs to a non-Latin script the matching Noto font is fetched at runtime
and registered for subsequent shaping/drawing. This port keeps the exact
script -> URL table and adds two deployment affordances the reference lacks:

  * an on-disk cache (``~/.cache/topo_renderer_tpu/fonts``) so each font
    downloads once per machine, not once per process;
  * an operator font directory (``TOPO_FONT_DIR``) whose ``.ttf``/``.otf``
    files are indexed by codepoint coverage and used without any network —
    the air-gapped deployment answer.

Network fetching is off by default (``TOPO_FONT_FETCH=1`` opts in) because
render servers often run with no egress; with fetching disabled and no
operator fonts, non-Latin labels fall back to the bundled face's coverage,
as round 1 did.
"""

from __future__ import annotations

import hashlib
import os
import threading
import urllib.request
from pathlib import Path

from topo_renderer_tpu_torch.render.text import _default_font

# Script tag -> Noto URLs, verbatim from `text_renderer.rs:28-48`.
_CJ = [
    "https://fonts.gstatic.com/s/notosansjp/v54/-F6jfjtqLzI2JPCgQBnw7HFyzSD-AsregP8VFBEj75s.ttf",
    "https://fonts.gstatic.com/s/notosanssc/v38/k3kCo84MPvpLmixcA63oeAL7Iqp5IZJF9bmaG9_FnYw.ttf",
]
FONT_SOURCE_MAP: dict[str, list[str]] = {
    "Armn": ["https://fonts.gstatic.com/s/notosansarmenian/v47/ZgN0jOZKPa7CHqq0h37c7ReDUubm2SEdFXp7ig73qtTY5idb74R9UdM3y2nZLorxb50laSo.ttf"],
    "Hebr": ["https://fonts.gstatic.com/s/notosanshebrew/v50/or3HQ7v33eiDljA1IufXTtVf7V6RvEEdhQlk0LlGxCyaeNKYZC0sqk3xXGiXd4qdpShh.ttf"],
    "Arab": ["https://fonts.gstatic.com/s/notosansarabic/v29/nwpxtLGrOAZMl5nJ_wfgRg3DrWFZWsnVBJ_sS6tlqHHFlhQ5l3sQWIHPqzCfyGyvuw.ttf"],
    "Beng": ["https://fonts.gstatic.com/s/notosansbengali/v33/Cn-SJsCGWQxOjaGwMQ6fIiMywrNJIky6nvd8BjzVMvJx2mcSPVFpVEqE-6KmsolLideu9g.ttf"],
    "Taml": ["https://fonts.gstatic.com/s/notosanstamil/v31/ieVc2YdFI3GCY6SyQy1KfStzYKZgzN1z4LKDbeZce-0429tBManUktuex7vGo40WoqQ.ttf"],
    "Thai": ["https://fonts.gstatic.com/s/notosansthai/v29/iJWnBXeUZi_OHPqn4wq6hQ2_hbJ1xyN9wd43SofNWcd1MKVQt_So_9CdU5RtlzZ0RQ.ttf"],
    "Geor": ["https://fonts.gstatic.com/s/notosansgeorgian/v48/PlIaFke5O6RzLfvNNVSitxkr76PRHBC4Ytyq-Gof7PUs4S7zWn-8YDB09HFNdpvnzGj5dZE.ttf"],
    "Hang": ["https://fonts.gstatic.com/s/notosanskr/v37/PbyxFmXiEBPT4ITbgNA5Cgms3VYcOA-vvnIzzuoyeLQ.ttf"],
    "Kana": _CJ,
    "Hira": _CJ,
    "Hani": _CJ,
}

_DEFAULT_CACHE = Path.home() / ".cache" / "topo_renderer_tpu" / "fonts"
FONT_SIZE = 13


class FontLibrary:
    """Registered per-script fonts + coverage-based selection.

    Thread-safe; the background pipeline calls `load_additional_fonts` from
    worker threads (`background_runner.rs:250-254`) while render threads
    call `font_for_text`.
    """

    def __init__(
        self,
        *,
        cache_dir: str | os.PathLike | None = None,
        font_dir: str | os.PathLike | None = None,
        fetch_enabled: bool | None = None,
        source_map: dict[str, list[str]] | None = None,
        size: int = FONT_SIZE,
    ):
        if fetch_enabled is None:
            fetch_enabled = os.environ.get("TOPO_FONT_FETCH", "") not in ("", "0")
        if font_dir is None:
            font_dir = os.environ.get("TOPO_FONT_DIR") or None
        self.cache_dir = Path(cache_dir or _DEFAULT_CACHE)
        self.fetch_enabled = bool(fetch_enabled)
        self.source_map = dict(source_map or FONT_SOURCE_MAP)
        self.size = size
        self._lock = threading.Lock()
        self._loaded_urls: set[str] = set()
        self._fonts: list[tuple[frozenset, object]] = []  # (coverage, PIL font)
        self._measure_cache: dict[str, float] = {}
        if font_dir:
            for p in sorted(Path(font_dir).glob("*")):
                if p.suffix.lower() in (".ttf", ".otf"):
                    self._register_file(p)

    # -- registration ------------------------------------------------------

    def _register_file(self, path: Path) -> bool:
        """Index a font file by its cmap coverage and open it for drawing."""
        try:
            from fontTools.ttLib import TTFont
            from PIL import ImageFont

            cmap = TTFont(str(path), lazy=True).getBestCmap()
            pil = ImageFont.truetype(str(path), self.size)
        except Exception:
            return False
        with self._lock:
            self._fonts.append((frozenset(cmap.keys()), pil))
            self._measure_cache.clear()  # widths may change for covered texts
        return True

    def load_additional_fonts(self, scripts) -> int:
        """Fetch-and-register the fonts for ``scripts`` not yet loaded
        (`text_renderer.rs:160-196`). Returns the number of new fonts.

        Cache-first: a previously downloaded file registers even when
        fetching is disabled. Failures are silent per-URL — a missing font
        degrades that script's labels, never the render.
        """
        urls: list[str] = []
        with self._lock:
            for tag in sorted(set(scripts)):
                for url in self.source_map.get(tag, ()):
                    if url not in self._loaded_urls:
                        urls.append(url)
                        # Claimed up front so concurrent callers don't fetch
                        # the same URL twice; released again on failure below
                        # so transient network errors retry on a later call.
                        self._loaded_urls.add(url)
        n = 0
        for url in urls:
            path = self.cache_dir / (
                hashlib.sha256(url.encode()).hexdigest()[:24] + ".ttf"
            )
            ok = False
            try:
                if not path.exists():
                    if not self.fetch_enabled:
                        continue
                    self.cache_dir.mkdir(parents=True, exist_ok=True)
                    tmp = path.with_suffix(".part")
                    with urllib.request.urlopen(url, timeout=30) as r:
                        tmp.write_bytes(r.read())
                    tmp.replace(path)
                ok = self._register_file(path)
                if ok:
                    n += 1
            except Exception:
                ok = False
            finally:
                if not ok:
                    with self._lock:
                        self._loaded_urls.discard(url)
        return n

    # -- selection ---------------------------------------------------------

    def font_for_text(self, text: str):
        """First registered font covering the text's leading character; the
        bundled default face otherwise (the reference shapes with its full
        font database per label — first-char coverage is the same heuristic
        its script detection uses, `text_renderer.rs:143-155`)."""
        if text:
            cp = ord(text[0])
            with self._lock:
                for coverage, pil in self._fonts:
                    if cp in coverage:
                        return pil
        return _default_font(self.size)

    def measure(self, text: str) -> float:
        """Pixel width of ``text``; memoized — the label pass re-measures the
        same peak names every frame (PIL shaping costs ~0.1 ms/name)."""
        w = self._measure_cache.get(text)
        if w is not None:
            return w
        font = self.font_for_text(text)
        w = 7.0 * len(text) if font is None else float(font.getlength(text))
        if len(self._measure_cache) > 65536:
            self._measure_cache.clear()
        self._measure_cache[text] = w
        return w


_library: FontLibrary | None = None
_library_lock = threading.Lock()


def default_library() -> FontLibrary:
    global _library
    with _library_lock:
        if _library is None:
            _library = FontLibrary()
        return _library


def set_default_library(lib: FontLibrary | None) -> None:
    """Swap the process-wide library (tests / embedding apps)."""
    global _library
    with _library_lock:
        _library = lib
