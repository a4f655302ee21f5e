"""PNG/HDR round-trip tests for the image I/O layer."""

import numpy as np

from vulkan_raytracer.utils.image import (
    decode_texture,
    read_hdr,
    read_png,
    write_hdr,
    write_png,
)


def test_png_roundtrip_rgb(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (33, 47, 3), dtype=np.uint8)
    p = tmp_path / "x.png"
    write_png(p, img)
    back = read_png(p.read_bytes())
    np.testing.assert_array_equal(back, img)


def test_png_roundtrip_rgba_float(tmp_path):
    img = np.random.default_rng(1).uniform(0, 1, (16, 16, 4)).astype(np.float32)
    p = tmp_path / "x.png"
    write_png(p, img)
    back = read_png(p.read_bytes())
    np.testing.assert_allclose(back / 255.0, img, atol=1 / 255.0 + 1e-6)


def test_decode_texture_promotes_channels(tmp_path):
    grey = np.random.default_rng(2).integers(0, 256, (8, 8, 1), dtype=np.uint8)
    p = tmp_path / "g.png"
    write_png(p, grey.repeat(1, axis=2))
    tex = decode_texture(p.read_bytes())
    assert tex.shape == (8, 8, 4)
    np.testing.assert_allclose(tex[..., 3], 1.0)


def _encode_png_with_filters(img: np.ndarray, filter_types: list[int]) -> bytes:
    """Spec-exact PNG encoder applying the given per-row filter types.

    Independent forward implementation of RFC 2083 §6 filters (the decoder
    under test must invert it); mimics libpng's adaptive output so the
    decoder is exercised on Sub/Up/Average/Paeth rows, not just filter 0.
    """
    import struct
    import zlib

    h, w, c = img.shape
    bpp = c
    raw = bytearray()
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int32)
        ft = filter_types[y % len(filter_types)]
        raw.append(ft)
        for x in range(w * c):
            a = int(line[x - bpp]) if x >= bpp else 0
            b = int(prev[x])
            cc = int(prev[x - bpp]) if x >= bpp else 0
            if ft == 0:
                v = line[x]
            elif ft == 1:
                v = line[x] - a
            elif ft == 2:
                v = line[x] - b
            elif ft == 3:
                v = line[x] - ((a + b) >> 1)
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                v = line[x] - pred
            raw.append(v & 0xFF)
        prev = line

    def chunk(tag, data):
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(bytes(raw)))
        + chunk(b"IEND", b"")
    )


def test_png_adaptive_filters_decode():
    """Sub/Up/Average/Paeth rows must reconstruct exactly (ADVICE r1: the
    left neighbour must come from the reconstructed row, not raw bytes)."""
    rng = np.random.default_rng(7)
    for c in (1, 3, 4):
        img = rng.integers(0, 256, (12, 19, c), dtype=np.uint8)
        # smooth gradient content makes filters 1/3/4 non-trivial
        img = (img // 4 + np.arange(19, dtype=np.uint8)[None, :, None] * 3).astype(
            np.uint8
        )
        data = _encode_png_with_filters(img, [1, 2, 3, 4, 0])
        back = read_png(data)
        np.testing.assert_array_equal(back.reshape(img.shape), img)


def test_png_all_sub_filter_decode():
    img = np.tile(np.arange(64, dtype=np.uint8)[None, :, None] * 4, (4, 1, 3))
    data = _encode_png_with_filters(img, [1])
    np.testing.assert_array_equal(read_png(data), img)


def test_hdr_old_style_rle(tmp_path):
    """Old-style Radiance RLE: (1,1,1,n) records repeat the previous pixel."""
    w, h = 10, 2
    # row 0: pixel P then a run of 7 repeats, then 2 literal pixels
    px = bytes([40, 50, 60, 130])
    lit = bytes([10, 20, 30, 129, 70, 80, 90, 131])
    row0 = px + bytes([1, 1, 1, 7]) + lit
    # row 1: one literal then a 9-repeat
    row1 = bytes([5, 6, 7, 128]) + bytes([1, 1, 1, 9])
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    p = tmp_path / "old.hdr"
    p.write_bytes(header + row0 + row1)
    img = read_hdr(p)
    assert img.shape == (h, w, 3)

    def rgbe_to_f(r, g, b, e):
        s = np.ldexp(1.0, e - 136) if e > 0 else 0.0
        return np.array([r, g, b], np.float32) * s

    np.testing.assert_allclose(img[0, 0], rgbe_to_f(40, 50, 60, 130))
    np.testing.assert_allclose(img[0, 7], rgbe_to_f(40, 50, 60, 130))
    np.testing.assert_allclose(img[0, 8], rgbe_to_f(10, 20, 30, 129))
    np.testing.assert_allclose(img[0, 9], rgbe_to_f(70, 80, 90, 131))
    np.testing.assert_allclose(img[1, 3], rgbe_to_f(5, 6, 7, 128))


def test_hdr_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 1, (9, 13, 3)) * np.exp2(rng.integers(-6, 10, (9, 13, 1)))).astype(
        np.float32
    )
    p = tmp_path / "x.hdr"
    write_hdr(p, img)
    back = read_hdr(p)
    assert back.shape == img.shape
    # RGBE stores ~8 bits of mantissa per shared-exponent pixel
    scale = img.max(-1, keepdims=True)
    np.testing.assert_allclose(back / (scale + 1e-9), img / (scale + 1e-9), atol=1 / 128)
