"""Peak-label text: greedy multi-row collision-free layout + glyph measuring.

Parity with `topo-renderer/src/render/text_renderer.rs`:
  * constants LINE_HEIGHT=16, LINE_PADDING=4, LABEL_PADDING_LEFT=1,
    MAX_ROWS=8 (`text_renderer.rs:20-23`)
  * ``layout_labels`` — greedy row assignment over labels in BTreeMap order:
    a label goes to the first row whose occupied-interval set has no edge
    inside [x, x+width] and where the next edge to the right is not another
    label's right edge (i.e. the span is not inside an occupied interval)
    (`process_label_layout`, `text_renderer.rs:300-338`); row index >= 8
    drops the label; label_y = line_height * (0.5 + row)
    (`layout_labels`, `text_renderer.rs:340-372`).
  * script detection for font selection uses the first character
    (`text_renderer.rs:143-155`); `render/fonts.py` fetches the script's
    font at runtime (`text_renderer.rs:28-48,160-196`) when enabled.

Text rasterization itself is host-side (SURVEY §7: glyphs are inherently
host work); `render/overlay.py` draws the laid-out labels.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import unicodedata
from typing import Callable, Iterable, Mapping, Sequence

from topo_renderer_tpu_torch.geo import GeoLocation

LINE_HEIGHT = 16.0
LINE_PADDING = 4.0
LABEL_PADDING_LEFT = 1.0
MAX_ROWS = 8

LEFT = 0
RIGHT = 1


@dataclasses.dataclass(frozen=True)
class LabelLayout:
    location: GeoLocation
    id: int
    label_x: float
    label_y: float
    label_width: float
    peak_x: float
    peak_y: float


def _process_label_layout(rows: list[list[tuple[int, int]]], x: int, width: float):
    """Find (or open) a row for the span [x, x+width].

    ``rows`` holds per-row sorted lists of (position, side) edges with
    LEFT < RIGHT at equal positions — the ordering of the reference's
    BTreeSet<LabelEdge> (`text_renderer.rs:64-93`).
    """
    import math

    left_edge = (int(math.floor(x)), LEFT)
    right_edge = (int(math.ceil(x + width)), RIGHT)

    row_i = None
    for i, row in enumerate(rows):
        # any edge within [left_edge, right_edge]?
        lo = bisect.bisect_left(row, left_edge)
        if lo < len(row) and row[lo] <= right_edge:
            continue
        # first edge strictly beyond right_edge: if it's a Right edge, the
        # span sits inside an existing label's interval.
        hi = bisect.bisect_left(row, right_edge)
        if hi < len(row) and row[hi][1] == RIGHT:
            continue
        row_i = i
        break
    if row_i is None:
        rows.append([])
        row_i = len(rows) - 1
    if row_i < MAX_ROWS:
        bisect.insort(rows[row_i], left_edge)
        bisect.insort(rows[row_i], right_edge)
        return row_i
    return None


def layout_labels(
    peak_labels: Mapping[GeoLocation, Sequence[tuple[int, tuple[int, int]]]],
    widths: Callable[[GeoLocation, int], float | None],
    line_height: float = LINE_HEIGHT + LINE_PADDING,
) -> list[LabelLayout]:
    """Greedy multi-row layout (`text_renderer.rs:340-372`).

    ``peak_labels`` maps tile -> [(label_id, (x, y)), ...]; iteration follows
    the reference's BTreeMap key order (sort the mapping's keys).
    """
    rows: list[list[tuple[int, int]]] = []
    out: list[LabelLayout] = []
    for location in sorted(peak_labels.keys()):
        for label_id, (x, y) in peak_labels[location]:
            width = widths(location, label_id)
            if width is None:
                continue
            row_i = _process_label_layout(rows, x, width)
            if row_i is None:
                continue
            out.append(
                LabelLayout(
                    location=location,
                    id=label_id,
                    label_x=float(x),
                    label_y=line_height * (0.5 + row_i),
                    label_width=float(width),
                    peak_x=float(x),
                    peak_y=float(y),
                )
            )
    return out


def get_scripts(texts: Iterable[str]) -> set[str]:
    """First-character script per label (`text_renderer.rs:143-155`)."""
    scripts = set()
    for text in texts:
        if text:
            scripts.add(_char_script(text[0]))
    return scripts


def _char_script(ch: str) -> str:
    """Coarse script detection via unicodedata (stdlib; no unicode-script
    crate here). Returns an ISO-15924-ish tag for the scripts the reference
    maps to font downloads (`text_renderer.rs:28-48`)."""
    try:
        name = unicodedata.name(ch)
    except ValueError:
        return "Zzzz"
    for key, tag in (
        ("CJK", "Hani"),
        ("HIRAGANA", "Hira"),
        ("KATAKANA", "Kana"),
        ("HANGUL", "Hang"),
        ("ARABIC", "Arab"),
        ("HEBREW", "Hebr"),
        ("ARMENIAN", "Armn"),
        ("BENGALI", "Beng"),
        ("TAMIL", "Taml"),
        ("THAI", "Thai"),
        ("GEORGIAN", "Geor"),
        ("CYRILLIC", "Cyrl"),
        ("GREEK", "Grek"),
    ):
        if key in name:
            return tag
    return "Latn"


@functools.lru_cache(maxsize=8)
def _default_font(size: int = 13):
    """A bundled TrueType font (matplotlib's DejaVu Sans — same role as the
    bundled Roboto in `text_renderer.rs:52-63`)."""
    try:
        from PIL import ImageFont
        import matplotlib

        import os

        font_path = os.path.join(
            os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf",
            "DejaVuSans.ttf",
        )
        return ImageFont.truetype(font_path, size)
    except Exception:
        return None


def measure_text(text: str, font=None) -> float:
    """Pixel width of a label (glyphon's shaping-based width in the
    reference, `text_renderer.rs:216-241`). With no explicit font the
    process font library picks one by script coverage
    (`render/fonts.py` — runtime-acquired Noto faces for non-Latin)."""
    if font is None:
        from topo_renderer_tpu_torch.render.fonts import default_library

        return default_library().measure(text)
    return float(font.getlength(text))
