"""Per-script font selection for peak labels (host-side).

Copy of the JAX package's `render/fonts.py` without its runtime download
path: labels are shaped with the bundled default face, and an operator font
directory (``TOPO_FONT_DIR``) whose ``.ttf``/``.otf`` files are indexed by
codepoint coverage supplies faces for other scripts, with no network. The
reference's Google-Fonts fetch (`text_renderer.rs:28-48,160-196`) belongs to
the host-runtime slice of the port.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

from topo_renderer_tpu_torch.render.text import _default_font

FONT_SIZE = 13


class FontLibrary:
    """Registered fonts + coverage-based selection (thread-safe)."""

    def __init__(self, *, font_dir: str | os.PathLike | None = None, size: int = FONT_SIZE):
        if font_dir is None:
            font_dir = os.environ.get("TOPO_FONT_DIR") or None
        self.size = size
        self._lock = threading.Lock()
        self._fonts: list[tuple[frozenset, object]] = []  # (coverage, PIL font)
        self._measure_cache: dict[str, float] = {}
        if font_dir:
            for p in sorted(Path(font_dir).glob("*")):
                if p.suffix.lower() in (".ttf", ".otf"):
                    self._register_file(p)

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

    def font_for_text(self, text: str):
        """First registered font covering the text's leading character; the
        bundled default face otherwise (`text_renderer.rs:143-155`)."""
        if text:
            cp = ord(text[0])
            with self._lock:
                for coverage, pil in self._fonts:
                    if cp in coverage:
                        return pil
        return _default_font(self.size)

    def measure(self, text: str) -> float:
        """Pixel width of ``text``; memoized (the label pass re-measures the
        same peak names every frame)."""
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
