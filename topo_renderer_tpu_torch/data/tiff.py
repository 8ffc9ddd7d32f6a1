"""Minimal GeoTIFF reader/writer for DEM tiles.

Copy of `topo_renderer_tpu/data/tiff.py` for the PyTorch port; it imports nothing
of the JAX package.

The reference decodes Copernicus GLO-90 GeoTIFFs with the Rust `tiff` crate
(`topo-renderer/src/control/background_runner.rs:111-136`): it reads
ModelPixelScale (tag 33550), ModelTiepoint (33922), rejects ModelTransformation
(34264), and decodes the image to an f32 heightfield. This module provides the
same capability with zero third-party dependencies:

  * classic TIFF, little- and big-endian
  * strip and tile organisation
  * compression: none (1), LZW (5), Deflate (8 / 32946 "old-style")
  * predictors: none (1), horizontal differencing (2), floating-point (3)
  * sample formats: unsigned/signed int (8/16/32 bit), IEEE float (32/64 bit)

A native C++ fast path (``topo_renderer_tpu_torch.native``) is used transparently for
the hot decode stage when the extension is built; this file is the always-on
reference implementation and the fallback.

``write_geotiff`` emits uncompressed single-plane GeoTIFFs — used for test
fixtures and for the hermetic tile backend, matching the byte layout the
reference's backend serves from disk (`topo-backend/src/main.rs:63-93`).
"""

from __future__ import annotations

import dataclasses
import io
import struct
import zlib

import numpy as np

# TIFF tag ids
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_SAMPLE_FORMAT = 339
TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_MODEL_TRANSFORMATION = 34264

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_TYPE_FORMATS = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}


class TiffError(ValueError):
    pass


@dataclasses.dataclass
class TiffInfo:
    width: int
    height: int
    dtype: np.dtype
    pixel_scale: list[float] | None
    tiepoint: list[float] | None
    model_transformation: list[float] | None


def _read_entries(data: bytes, bo: str, ifd_offset: int) -> dict[int, tuple[int, int, bytes]]:
    (count,) = struct.unpack_from(bo + "H", data, ifd_offset)
    entries: dict[int, tuple[int, int, bytes]] = {}
    for i in range(count):
        off = ifd_offset + 2 + 12 * i
        tag, typ, n = struct.unpack_from(bo + "HHI", data, off)
        size = _TYPE_SIZES.get(typ, 1) * n
        if size <= 4:
            raw = data[off + 8 : off + 8 + size]
        else:
            (value_off,) = struct.unpack_from(bo + "I", data, off + 8)
            raw = data[value_off : value_off + size]
        entries[tag] = (typ, n, raw)
    return entries


def _values(entries, tag, bo) -> list | None:
    if tag not in entries:
        return None
    typ, n, raw = entries[tag]
    fmt = _TYPE_FORMATS.get(typ)
    if fmt is None:
        raise TiffError(f"unsupported tag type {typ} for tag {tag}")
    return list(struct.unpack(bo + fmt * n, raw))


def _lzw_decode(data: bytes, max_out: int) -> bytes:
    """TIFF-variant LZW (MSB-first, early code-size change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    dictionary: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    code_bits = 9
    buffer = 0
    bits = 0
    prev: bytes | None = None
    for byte in data:
        buffer = (buffer << 8) | byte
        bits += 8
        while bits >= code_bits:
            bits -= code_bits
            code = (buffer >> bits) & ((1 << code_bits) - 1)
            if code == CLEAR:
                dictionary = [bytes([i]) for i in range(256)] + [b"", b""]
                code_bits = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if prev is None:
                entry = dictionary[code]
            elif code < len(dictionary):
                entry = dictionary[code]
                dictionary.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                dictionary.append(entry)
            out.extend(entry)
            if len(out) >= max_out:
                return bytes(out)
            prev = entry
            # TIFF uses "early change": bump width one code early.
            if len(dictionary) + 1 >= (1 << code_bits) and code_bits < 12:
                code_bits += 1
    return bytes(out)


def _decompress(raw: bytes, compression: int, expected: int) -> bytes:
    if compression == 1:
        return raw
    if compression in (8, 32946):
        return zlib.decompress(raw)
    if compression == 5:
        return _lzw_decode(raw, expected)
    raise TiffError(f"unsupported compression {compression}")


def _undo_predictor(arr: np.ndarray, predictor: int, dtype: np.dtype) -> np.ndarray:
    """``arr`` is [rows, row_bytes] uint8 for one strip/tile."""
    if predictor == 1:
        return arr
    if predictor == 2:
        itemsize = dtype.itemsize
        rows, row_bytes = arr.shape
        typed = arr.reshape(rows, row_bytes // itemsize, itemsize).view(dtype).reshape(rows, -1)
        np.cumsum(typed, axis=1, dtype=dtype, out=typed)
        return typed.view(np.uint8).reshape(rows, row_bytes)
    if predictor == 3:
        # Floating-point predictor: per row, bytes were split into itemsize
        # planes then horizontally differenced.
        itemsize = dtype.itemsize
        rows, row_bytes = arr.shape
        acc = np.cumsum(arr.astype(np.uint8), axis=1, dtype=np.uint8)
        width = row_bytes // itemsize
        planes = acc.reshape(rows, itemsize, width)
        # Recombine planes: big-endian byte order across planes.
        out = np.empty((rows, width, itemsize), np.uint8)
        for b in range(itemsize):
            out[:, :, b] = planes[:, b, :]
        flat = out.reshape(rows, row_bytes)
        # Bytes are now big-endian regardless of file byte order.
        return flat
    raise TiffError(f"unsupported predictor {predictor}")


def read_geotiff(data: bytes) -> tuple[np.ndarray, TiffInfo]:
    """Decode a (Geo)TIFF byte string into ``(heightfield [H, W], TiffInfo)``.

    Matches the reference decode path: first image only, single sample per
    pixel, returns float32 for float sources and the native integer dtype
    otherwise (`background_runner.rs:135-136` uses DecodingResult::F32).

    Uses the C++ fast path (`topo_renderer_tpu_torch.native`) when available and
    falls back to this module's pure-Python decoder transparently.
    """
    native = _try_native(data)
    if native is not None:
        return native
    if len(data) < 8:
        raise TiffError("not a TIFF: too short")
    magic = data[:2]
    if magic == b"II":
        bo = "<"
    elif magic == b"MM":
        bo = ">"
    else:
        raise TiffError("not a TIFF: bad byte-order mark")
    (version, ifd_offset) = struct.unpack_from(bo + "HI", data, 2)
    if version != 42:
        raise TiffError(f"unsupported TIFF version {version} (BigTIFF not supported)")

    entries = _read_entries(data, bo, ifd_offset)
    width = _values(entries, TAG_IMAGE_WIDTH, bo)[0]
    height = _values(entries, TAG_IMAGE_LENGTH, bo)[0]
    bits = (_values(entries, TAG_BITS_PER_SAMPLE, bo) or [1])[0]
    compression = (_values(entries, TAG_COMPRESSION, bo) or [1])[0]
    predictor = (_values(entries, TAG_PREDICTOR, bo) or [1])[0]
    sample_format = (_values(entries, TAG_SAMPLE_FORMAT, bo) or [1])[0]
    samples = (_values(entries, TAG_SAMPLES_PER_PIXEL, bo) or [1])[0]
    if samples != 1:
        raise TiffError(f"only single-sample DEMs supported, got {samples}")

    if sample_format == 3:
        base = {32: np.float32, 64: np.float64}.get(bits)
    elif sample_format == 2:
        base = {8: np.int8, 16: np.int16, 32: np.int32}.get(bits)
    else:
        base = {8: np.uint8, 16: np.uint16, 32: np.uint32}.get(bits)
    if base is None:
        raise TiffError(f"unsupported sample format {sample_format}/{bits}")
    dtype = np.dtype(base)
    file_dtype = dtype.newbyteorder("<" if bo == "<" else ">")

    out = np.zeros((height, width), dtype)
    itemsize = dtype.itemsize

    tile_w = _values(entries, TAG_TILE_WIDTH, bo)
    if tile_w is not None:
        tw = tile_w[0]
        th = _values(entries, TAG_TILE_LENGTH, bo)[0]
        offsets = _values(entries, TAG_TILE_OFFSETS, bo)
        counts = _values(entries, TAG_TILE_BYTE_COUNTS, bo)
        tiles_across = (width + tw - 1) // tw
        for idx, (off, cnt) in enumerate(zip(offsets, counts)):
            ty, tx = divmod(idx, tiles_across)
            raw = _decompress(data[off : off + cnt], compression, th * tw * itemsize)
            rows = np.frombuffer(raw[: th * tw * itemsize], np.uint8).reshape(th, tw * itemsize)
            rows = _undo_predictor(rows.copy(), predictor, dtype)
            if predictor == 3:
                block = rows.reshape(-1).view(np.dtype(base).newbyteorder(">")).reshape(th, tw)
            else:
                block = rows.reshape(-1).view(file_dtype).reshape(th, tw)
            y0, x0 = ty * th, tx * tw
            h = min(th, height - y0)
            w = min(tw, width - x0)
            out[y0 : y0 + h, x0 : x0 + w] = block[:h, :w]
    else:
        offsets = _values(entries, TAG_STRIP_OFFSETS, bo)
        if offsets is None:
            raise TiffError("no strip or tile offsets")
        counts = _values(entries, TAG_STRIP_BYTE_COUNTS, bo)
        rows_per_strip = (_values(entries, TAG_ROWS_PER_STRIP, bo) or [height])[0]
        row_bytes = width * itemsize
        for idx, (off, cnt) in enumerate(zip(offsets, counts)):
            y0 = idx * rows_per_strip
            nrows = min(rows_per_strip, height - y0)
            raw = _decompress(data[off : off + cnt], compression, nrows * row_bytes)
            rows = np.frombuffer(raw[: nrows * row_bytes], np.uint8).reshape(nrows, row_bytes)
            rows = _undo_predictor(rows.copy(), predictor, dtype)
            if predictor == 3:
                block = rows.reshape(-1).view(np.dtype(base).newbyteorder(">")).reshape(nrows, width)
            else:
                block = rows.reshape(-1).view(file_dtype).reshape(nrows, width)
            out[y0 : y0 + nrows] = block

    info = TiffInfo(
        width=width,
        height=height,
        dtype=dtype,
        pixel_scale=_values(entries, TAG_MODEL_PIXEL_SCALE, bo),
        tiepoint=_values(entries, TAG_MODEL_TIEPOINT, bo),
        model_transformation=_values(entries, TAG_MODEL_TRANSFORMATION, bo),
    )
    if dtype.kind == "f":
        out = out.astype(np.float32)
    return out, info


def _try_native(data: bytes):
    try:
        from topo_renderer_tpu_torch import native
    except Exception:  # pragma: no cover
        return None
    result = native.tiff_decode(data)
    if result is None:
        return None
    heights, meta = result
    info = TiffInfo(
        width=meta["width"],
        height=meta["height"],
        dtype=np.dtype(np.float32),
        pixel_scale=meta["pixel_scale"],
        tiepoint=meta["tiepoint"],
        model_transformation=[0.0] if meta["has_model_transform"] else None,
    )
    return heights, info


def write_geotiff(
    heights: np.ndarray,
    pixel_scale: tuple[float, float, float],
    tiepoint: tuple[float, float, float, float, float, float],
) -> bytes:
    """Encode a float32 heightfield as an uncompressed little-endian GeoTIFF.

    Produces files bit-compatible in semantics with what the reference backend
    serves (`topo-backend/src/main.rs:63-93`): single-plane float32 with
    ModelPixelScale and ModelTiepoint tags.
    """
    heights = np.ascontiguousarray(np.asarray(heights, np.float32))
    h, w = heights.shape
    pixel_bytes = heights.astype("<f4").tobytes()

    buf = io.BytesIO()
    # header: II, 42, ifd offset (8)
    buf.write(struct.pack("<2sHI", b"II", 42, 8))

    tags: list[bytes] = []
    n_entries = 12
    ifd_size = 2 + 12 * n_entries + 4
    data_start = 8 + ifd_size

    deferred_payloads: list[bytes] = []

    def add(tag, typ, count, packed: bytes):
        nonlocal tags
        if len(packed) <= 4:
            tags.append(struct.pack("<HHI", tag, typ, count) + packed.ljust(4, b"\0"))
        else:
            offset = data_start + sum(len(p) for p in deferred_payloads)
            deferred_payloads.append(packed)
            tags.append(struct.pack("<HHII", tag, typ, count, offset))

    add(TAG_IMAGE_WIDTH, 4, 1, struct.pack("<I", w))
    add(TAG_IMAGE_LENGTH, 4, 1, struct.pack("<I", h))
    add(TAG_BITS_PER_SAMPLE, 3, 1, struct.pack("<H", 32))
    add(TAG_COMPRESSION, 3, 1, struct.pack("<H", 1))
    add(TAG_PHOTOMETRIC, 3, 1, struct.pack("<H", 1))
    add(TAG_SAMPLES_PER_PIXEL, 3, 1, struct.pack("<H", 1))
    add(TAG_ROWS_PER_STRIP, 4, 1, struct.pack("<I", h))
    add(TAG_SAMPLE_FORMAT, 3, 1, struct.pack("<H", 3))
    add(TAG_MODEL_PIXEL_SCALE, 12, 3, struct.pack("<3d", *pixel_scale))
    add(TAG_MODEL_TIEPOINT, 12, 6, struct.pack("<6d", *tiepoint))
    # Strip offset comes after all deferred payloads; reserve placeholders.
    pixel_offset = data_start + sum(len(p) for p in deferred_payloads)
    add(TAG_STRIP_OFFSETS, 4, 1, struct.pack("<I", pixel_offset))
    add(TAG_STRIP_BYTE_COUNTS, 4, 1, struct.pack("<I", len(pixel_bytes)))

    assert len(tags) == n_entries
    buf.write(struct.pack("<H", n_entries))
    for t in sorted(tags, key=lambda b: struct.unpack_from("<H", b)[0]):
        buf.write(t)
    buf.write(struct.pack("<I", 0))  # next IFD
    for p in deferred_payloads:
        buf.write(p)
    buf.write(pixel_bytes)
    return buf.getvalue()
