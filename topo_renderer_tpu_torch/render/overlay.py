"""Label overlay compositor: leader lines, rounded backgrounds, text.

Host-side equivalent of the reference's lyon + glyphon GPU passes:
  * leader line from (label_x, label_y) to the peak's screen position, black
    stroke (`topo-renderer/src/render/line_renderer.rs:97-121,171-181`);
  * white rounded label background [label_x, label_x+width] x
    [label_y, label_y+LINE_HEIGHT], corner radius 0.2 px
    (`line_renderer.rs:127-170`);
  * black text at (label_x + LABEL_PADDING_LEFT, label_y)
    (`text_renderer.rs:268-277`), drawn above lines/backgrounds (z layering
    via z_index/4096 in the reference, plain draw order here).

Label pixel rates are tiny compared to terrain pixels, so this stage is CPU
work by design (SURVEY §7); a native C++ compositor can replace the PIL path
transparently (a native compositor).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from topo_renderer_tpu_torch.render.text import (
    LABEL_PADDING_LEFT,
    LINE_HEIGHT,
    LabelLayout,
)


def composite_labels(
    image_u8: np.ndarray,
    layouts: Sequence[LabelLayout],
    names: dict,
    font=None,
) -> np.ndarray:
    """Draw label overlays onto an sRGB u8 image (returns a new array).

    ``names`` maps (location, label_id) -> text.
    """
    if not layouts:
        return image_u8
    try:
        from PIL import Image, ImageDraw
    except Exception:
        return _composite_fallback(image_u8, layouts)

    img = Image.fromarray(image_u8, "RGB")
    draw = ImageDraw.Draw(img)
    explicit_font = font
    if explicit_font is None:
        from topo_renderer_tpu_torch.render.fonts import default_library

        lib = default_library()

    # Pass 1: backgrounds + leader lines (lines drawn above rects, like the
    # reference's z order: rects z=1, lines z=2, text z=100).
    for lay in layouts:
        draw.rounded_rectangle(
            [lay.label_x, lay.label_y, lay.label_x + lay.label_width, lay.label_y + LINE_HEIGHT],
            radius=0.2,
            fill=(255, 255, 255),
        )
    for lay in layouts:
        draw.line(
            [(lay.label_x, lay.label_y), (lay.peak_x, lay.peak_y)],
            fill=(0, 0, 0),
            width=1,
        )
    for lay in layouts:
        text = names.get((lay.location, lay.id), "")
        if text:
            # Per-label face: script-covering runtime font when one is
            # registered (`text_renderer.rs:160-196` semantics).
            label_font = (
                explicit_font
                if explicit_font is not None
                else lib.font_for_text(text)
            )
            draw.text(
                (lay.label_x + LABEL_PADDING_LEFT, lay.label_y + 1),
                text,
                fill=(0, 0, 0),
                font=label_font,
            )
    return np.asarray(img)


def _composite_fallback(image_u8: np.ndarray, layouts) -> np.ndarray:
    """No-PIL fallback: plain white boxes so tests can assert presence."""
    out = image_u8.copy()
    h, w = out.shape[:2]
    for lay in layouts:
        x0 = int(max(0, lay.label_x))
        x1 = int(min(w, lay.label_x + lay.label_width))
        y0 = int(max(0, lay.label_y))
        y1 = int(min(h, lay.label_y + LINE_HEIGHT))
        out[y0:y1, x0:x1] = 255
    return out
