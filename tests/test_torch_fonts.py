"""The port's runtime font acquisition vs the JAX package
(`tests/test_fonts.py`): fetch, register, cache hit, disabled fetch and the
operator font directory, against a local HTTP server serving a TTF built
with fontTools. Each step must return the counts JAX's `FontLibrary`
returns, and a CJK label must draw glyphs, not tofu.
"""

import numpy as np
import pytest

from tests.test_fonts import CJK_NAME, font_server, mini_cjk_ttf  # noqa: F401 - pytest fixtures
from topo_renderer_tpu.render import fonts as jfonts
from topo_renderer_tpu_torch.geo import GeoLocation
from topo_renderer_tpu_torch.render import fonts
from topo_renderer_tpu_torch.render.overlay import composite_labels
from topo_renderer_tpu_torch.render.text import LabelLayout, get_scripts, measure_text


def _pair(**kw):
    """(port, JAX) libraries built alike; ``cache_dir`` gets one subfolder
    each so neither sees the other's downloads."""
    cache = kw.pop("cache_dir")
    return (fonts.FontLibrary(cache_dir=cache / "port", **kw), jfonts.FontLibrary(cache_dir=cache / "jax", **kw))


def test_tables_equal():
    assert fonts.FONT_SOURCE_MAP == jfonts.FONT_SOURCE_MAP and fonts.FONT_SIZE == jfonts.FONT_SIZE
    names = ["Matterhorn", CJK_NAME, "Арарат", "Ὄλυμπος", "ஊட்டி", "", "7"]
    assert get_scripts(names) == {"Latn", "Hani", "Cyrl", "Grek", "Taml"}


def test_fetch_register_and_render_cjk(font_server, tmp_path):  # noqa: F811
    lib, jlib = _pair(cache_dir=tmp_path, fetch_enabled=True, source_map={"Hani": [font_server]})
    assert lib.load_additional_fonts({"Hani"}) == jlib.load_additional_fonts({"Hani"}) == 1
    # A second call finds the URL registered: nothing new.
    assert lib.load_additional_fonts({"Hani", "Latn"}) == jlib.load_additional_fonts({"Hani", "Latn"}) == 0
    assert lib.font_for_text(CJK_NAME) is not lib.font_for_text("Matterhorn")
    assert lib.measure(CJK_NAME) == jlib.measure(CJK_NAME) > 0.0

    fonts.set_default_library(lib)
    try:
        img = np.full((64, 160, 3), 200, np.uint8)
        layouts = [LabelLayout(location=GeoLocation.from_coord(35, 138), id=0, label_x=8.0, label_y=8.0,
                               label_width=lib.measure(CJK_NAME), peak_x=100.0, peak_y=60.0)]
        names = {(layouts[0].location, 0): CJK_NAME}
        with_lib = composite_labels(img, layouts, names)
    finally:
        fonts.set_default_library(None)
    tofu = composite_labels(img, layouts, names)
    ink, ink_tofu = ((a < 100).any(axis=-1).sum() for a in (with_lib, tofu))
    assert ink > ink_tofu + 50, (ink, ink_tofu)


def test_cache_hit_without_fetch(font_server, tmp_path):  # noqa: F811
    lib, jlib = _pair(cache_dir=tmp_path, fetch_enabled=True, source_map={"Hani": [font_server]})
    assert lib.load_additional_fonts({"Hani"}) == jlib.load_additional_fonts({"Hani"}) == 1
    # A new library with fetching disabled registers from the cache.
    lib2, jlib2 = _pair(cache_dir=tmp_path, fetch_enabled=False, source_map={"Hani": [font_server]})
    assert lib2.load_additional_fonts({"Hani"}) == jlib2.load_additional_fonts({"Hani"}) == 1
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert lib2.measure(CJK_NAME) == jlib2.measure(CJK_NAME) > 0.0


@pytest.mark.parametrize("fetch", [False, True])
def test_unreachable_or_disabled_falls_back(tmp_path, fetch):
    """No font: 0 new fonts, the URL is released for a later retry, labels
    measure with the bundled face."""
    lib, jlib = _pair(cache_dir=tmp_path, fetch_enabled=fetch, source_map={"Hani": ["http://127.0.0.1:1/never"]})
    assert lib.load_additional_fonts({"Hani"}) == jlib.load_additional_fonts({"Hani"}) == 0
    assert lib._loaded_urls == jlib._loaded_urls == set()
    assert lib.measure("Matterhorn") == jlib.measure("Matterhorn") > 0.0


def test_environment_switches(monkeypatch, tmp_path):
    for value, enabled in (("", False), ("0", False), ("1", True)):
        monkeypatch.setenv("TOPO_FONT_FETCH", value)
        assert fonts.FontLibrary(cache_dir=tmp_path).fetch_enabled == jfonts.FontLibrary(cache_dir=tmp_path).fetch_enabled == enabled


def test_operator_font_dir(mini_cjk_ttf, tmp_path, monkeypatch):  # noqa: F811
    d = tmp_path / "fonts"
    d.mkdir()
    (d / "mini.ttf").write_bytes(mini_cjk_ttf.read_bytes())
    (d / "notes.txt").write_text("not a font")
    monkeypatch.setenv("TOPO_FONT_DIR", str(d))
    lib, jlib = _pair(cache_dir=tmp_path, fetch_enabled=False)
    assert len(lib._fonts) == len(jlib._fonts) == 1
    assert lib.font_for_text(CJK_NAME) is not lib.font_for_text("Alps")
    assert lib.measure(CJK_NAME) == jlib.measure(CJK_NAME) > 0.0


def test_measure_text_uses_library(mini_cjk_ttf, tmp_path):  # noqa: F811
    d = tmp_path / "fonts"
    d.mkdir()
    (d / "mini.ttf").write_bytes(mini_cjk_ttf.read_bytes())
    fonts.set_default_library(fonts.FontLibrary(cache_dir=tmp_path / "c", font_dir=d, fetch_enabled=False))
    try:
        w = measure_text(CJK_NAME)
    finally:
        fonts.set_default_library(None)
    assert w == pytest.approx(39.0, rel=0.2)
    assert fonts.default_library() is fonts.default_library() and fonts.default_library()._fonts == []
