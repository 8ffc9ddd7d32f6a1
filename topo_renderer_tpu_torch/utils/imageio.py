"""Image output helpers (PNG/JPEG via PIL; raw PPM fallback).

Copy of `topo_renderer_tpu/utils/imageio.py` for the PyTorch port.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_image(path: str | Path, image_u8: np.ndarray) -> None:
    path = Path(path)
    try:
        from PIL import Image

        Image.fromarray(np.asarray(image_u8), "RGB").save(path)
    except ImportError:  # pragma: no cover
        if path.suffix.lower() not in (".ppm", ""):
            path = path.with_suffix(".ppm")
        h, w = image_u8.shape[:2]
        with open(path, "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode())
            f.write(np.asarray(image_u8, np.uint8).tobytes())


def encode_png(image_u8: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(image_u8), "RGB").save(buf, format="PNG")
    return buf.getvalue()


def encode_jpeg(image_u8: np.ndarray, quality: int = 85) -> bytes:
    """JPEG for the interactive frame stream: ~10x smaller and much faster
    to encode than PNG at streaming rates."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(image_u8), "RGB").save(
        buf, format="JPEG", quality=quality
    )
    return buf.getvalue()
