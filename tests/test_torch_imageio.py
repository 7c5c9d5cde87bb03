"""The port's own readers, which need neither pyyaml nor opencv, held to both.

``utils/config.parse_flat_yaml`` against ``yaml.safe_load`` on every
``config/*.yaml`` and on the scalar forms YAML 1.1 resolves; the PNG codec
of ``utils/imageio.py`` (its row unfiltering in ``csrc/imageio.c``) against
``cv2.imread`` bit for bit under the three flags (files cv2 writes at
several compression levels, so that libpng's adaptive filtering puts every
row filter in them, and palette and grey-alpha files written here with
every filter, which cv2 cannot write; interlaced (Adam7) files of every
colour type and depth the port reads, at 1x1, 7x9 and 33x65, written here;
grey reads of colour and palette files, and the committed Adam7 fixtures);
cv2 reading back what the port writes, and the port's writer choosing
libpng's filter on every row; a JPEG request body through cv2; and the
INTER_LINEAR resize against ``cv2.resize`` bit for bit.
"""

import glob
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import yaml

from unopticalflow_tpu_torch.utils import imageio
from unopticalflow_tpu_torch.utils.config import load_yaml_config, parse_flat_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "config", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_flat_yaml_equals_pyyaml_on_every_config(path):
    with open(path) as f:
        text = f.read()
    assert parse_flat_yaml(text, path) == yaml.safe_load(text)


def test_flat_yaml_scalars_equal_pyyaml(monkeypatch, tmp_path):
    text = "\n".join([
        "# a comment", "a: 1   # trailing", "b: 'q # r'", 'c: "d"', "e: 1e-4", "f: 1.0e-4",
        "g: .5", "h: -3", "i: 010", "j: 0x1F", "k: yes", "l: off", "m: ~", "n:",
        "o: [1, 'a, b', 2.5, null, true]", "p: a#b", "q: [ ]", "r: +7", "s: 1_000",
        "t: hello world", "u: -.inf", '"v w": 3', "x: ''", "lr: 0.0001", "name: 'it''s'",
        "img_hw: [256, 832]",
    ]) + "\n"
    assert parse_flat_yaml(text) == yaml.safe_load(text)
    path = tmp_path / "c.yaml"
    path.write_text(text)
    want = load_yaml_config(str(path))
    monkeypatch.setitem(sys.modules, "yaml", None)  # as on a machine without pyyaml
    assert load_yaml_config(str(path)) == want and want["img_hw"] == (256, 832)


@pytest.mark.parametrize("text,match", [
    ("a:\n  b: 1\n", "2: indented"), ("a: 1\n- 2\n", "2: '- 2'"), ("a: &x 1\n", "1:"),
    ("a: *x\n", "1:"), ("a: !!str 1\n", "1:"), ("a: |\n  x\n", "1:"),
    ("a: [1, [2]]\n", "nested"), ("a: {b: 1}\n", "1:"), ("a: [1,\n  2]\n", "flow list"),
])
def test_flat_yaml_raises_on_what_it_does_not_read(text, match):
    with pytest.raises(ValueError, match=match):
        parse_flat_yaml(text)


# ---- PNG -------------------------------------------------------------------


def _smooth(h, w, ch, maxv, rng):
    """Smooth planes with a little noise: libpng picks every filter for them."""
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [((np.sin(xx / (5.0 + k)) + np.cos(yy / (4.0 + k))) * 0.23 + 0.5) * maxv
              + rng.randint(0, 4, (h, w)) for k in range(ch)]
    return np.clip(np.stack(planes, -1), 0, maxv)


CV2_CASES = [(1, np.uint8), (3, np.uint8), (4, np.uint8), (3, np.uint16), (1, np.uint16)]


@pytest.mark.parametrize("ch,dtype", CV2_CASES, ids=["gray8", "rgb8", "rgba8", "rgb16",
                                                      "gray16"])
def test_png_reads_equal_cv2_on_files_cv2_writes(ch, dtype, tmp_path):
    rng = np.random.RandomState(ch)
    maxv = np.iinfo(dtype).max
    for level in (0, 1, 3, 6, 9):
        for img in (_smooth(45, 67, ch, maxv, rng).astype(dtype),
                    rng.randint(0, maxv + 1, (23, 31, ch)).astype(dtype)):
            img = img[:, :, 0] if ch == 1 else img
            path = str(tmp_path / f"x{level}.png")
            assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            with open(path, "rb") as f:
                data = f.read()
            for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE):
                want = cv2.imread(path, flags)
                got = imageio.decode_png(data, flags)
                assert got.dtype == want.dtype and got.shape == want.shape, (level, flags)
                assert np.array_equal(got, want), (level, flags)


def test_cv2_files_hold_every_row_filter():
    """The files above exercise all five filters (libpng's adaptive choice)."""
    rng = np.random.RandomState(0)
    seen = set()
    for level in (0, 1, 3, 6, 9):
        img = rng.randint(0, 256, (23, 31, 3)).astype(np.uint8)
        ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        idat = b"".join(b for k, b, _ in imageio._png_chunks(buf.tobytes())[0] if k == b"IDAT")
        seen |= set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(23, -1)[:, 0])
    assert seen == {0, 1, 2, 3, 4}


def _filter_rows(px: np.ndarray, bpp: int, kinds) -> bytes:
    """PNG-filter each row of (h, row_bytes) uint8 with the given filter types."""
    h, n = px.shape
    x = px.astype(np.int32)
    prior = np.zeros(n, np.int32)
    out = []
    for r in range(h):
        a = np.concatenate([np.zeros(bpp, np.int32), x[r, :-bpp]])
        b = prior
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = [0, a, b, (a + b) >> 1,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))][kinds[r]]
        out.append(bytes([kinds[r]]) + ((x[r] - pred) & 255).astype(np.uint8).tobytes())
        prior = x[r]
    return b"".join(out)


def _png(w, h, depth, ctype, rows, extra=b""):
    return (imageio._PNG_MAGIC
            + imageio._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + extra + imageio._chunk(b"IDAT", zlib.compress(rows, 6))
            + imageio._chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["palette", "palette_trns", "gray_alpha", "rgb8", "rgba8"])
def test_png_reads_equal_cv2_on_every_filter_and_colour_type(kind, tmp_path):
    """Files with rows of all five filters, in an order that puts Average and
    Paeth rows after None, Sub and Up ones and the other way round."""
    rng = np.random.RandomState(len(kind))
    h, w = 19, 27
    kinds = [0, 1, 2, 3, 4] * 3 + [4, 3, 2, 1]
    extra = b""
    if kind.startswith("palette"):
        ctype, ch = 3, 1
        pal = rng.randint(0, 256, (37, 3)).astype(np.uint8)
        px = rng.randint(0, len(pal), (h, w, 1)).astype(np.uint8)
        extra = imageio._chunk(b"PLTE", pal.tobytes())
        if kind == "palette_trns":
            extra += imageio._chunk(b"tRNS", rng.randint(0, 256, 20).astype(np.uint8).tobytes())
    else:
        ctype, ch = {"gray_alpha": (4, 2), "rgb8": (2, 3), "rgba8": (6, 4)}[kind]
        px = _smooth(h, w, ch, 255, rng).astype(np.uint8)
    data = _png(w, h, 8, ctype, _filter_rows(px.reshape(h, -1), ch, kinds), extra)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(data)
    for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE):
        want = cv2.imread(path, flags)
        got = imageio.decode_png(data, flags)
        assert got.dtype == want.dtype and got.shape == want.shape, flags
        assert np.array_equal(got, want), flags


@pytest.mark.parametrize("shape,dtype", [((13, 17), np.uint8), ((13, 17, 3), np.uint8),
                                         ((13, 17, 4), np.uint8), ((13, 17, 3), np.uint16)],
                         ids=["gray8", "bgr8", "bgra8", "bgr16"])
def test_cv2_reads_back_what_the_port_writes(shape, dtype, tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "w.png")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        imageio.imwrite(path, img)  # the port's own writer
        assert np.array_equal(imageio.imread(path, imageio.IMREAD_UNCHANGED), img)
        assert imageio.imread(str(tmp_path / "missing.png")) is None
        (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(16))
        with pytest.raises(ValueError, match="corrupt JPEG"):  # a JPEG, broken
            imageio.imread(str(tmp_path / "x.jpg"))
        (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(16))  # a GIF of no pixels
        with pytest.raises(ValueError, match="cv2 reads no image from it"):
            imageio.imread(str(tmp_path / "x.gif"))
        (tmp_path / "x.bin").write_bytes(b"\x00\x01\x02\x03" * 8)
        with pytest.raises(ValueError, match="not an image format the port reads"):
            imageio.imread(str(tmp_path / "x.bin"))
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_COLOR),
                          imageio.decode_png(imageio.encode_png(img)))


def test_png_reader_refuses_what_it_does_not_read(monkeypatch):
    px = np.zeros((2, 3), np.uint8)

    def interlaced(nbytes, method=1):
        return (imageio._PNG_MAGIC
                + imageio._chunk(b"IHDR", struct.pack(">IIBBBBB", 3, 2, 8, 0, 0, 0, method))
                + imageio._chunk(b"IDAT", zlib.compress(b"\0" * nbytes))
                + imageio._chunk(b"IEND", b""))

    # a 3x2 Adam7 file has passes 1, 4, 6 and 7: 2 + 2 + 2 + 4 bytes, filters
    # included; it decodes as cv2 decodes it, and short data raises
    for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED):
        want = cv2.imdecode(np.frombuffer(interlaced(10), np.uint8), flags)
        assert np.array_equal(imageio.decode_png(interlaced(10), flags), want)
    with pytest.raises(ValueError, match="interlaced PNG data holds 8 bytes"):
        imageio.decode_png(interlaced(8))
    with pytest.raises(ValueError, match="interlace method 2"):
        imageio.decode_png(interlaced(10, 2))
    with pytest.raises(ValueError, match="not a PNG"):
        imageio.decode_png(b"GIF89a")
    # RGB at 4 bits: libpng refuses the combination (cv2 gives None)
    rgb4 = _png(3, 2, 4, 2, _filter_rows(np.zeros((2, 5), np.uint8), 1, [0, 0]))
    assert cv2.imdecode(np.frombuffer(rgb4, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="colour type"):
        imageio.decode_png(rgb4)
    # a colour file in grey as cv2 converts it; with a gAMA or sRGB chunk,
    # which sends libpng's conversion through gamma tables, as libpng does it
    colour = np.random.RandomState(1).randint(0, 256, (2, 3, 3)).astype(np.uint8)
    data = imageio.encode_png(colour)
    assert np.array_equal(imageio.decode_png(data, imageio.IMREAD_GRAYSCALE),
                          cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))
    for kind in (b"gAMA", b"sRGB"):
        body = struct.pack(">I", 45455) if kind == b"gAMA" else b"\0"
        managed = data[:33] + imageio._chunk(kind, body) + data[33:]
        want = cv2.imdecode(np.frombuffer(managed, np.uint8), cv2.IMREAD_GRAYSCALE)
        # what libpng does differs from the plain conversion
        assert not np.array_equal(want, imageio.decode_png(data, imageio.IMREAD_GRAYSCALE))
        assert np.array_equal(imageio.decode_png(managed, imageio.IMREAD_GRAYSCALE), want)
        assert np.array_equal(imageio.decode_png(managed), imageio.decode_png(data))
    bad_filter = _png(3, 2, 8, 0, b"\0" + bytes(3) + b"\5" + bytes(3))
    with pytest.raises(ValueError, match="row filter 5 does not exist"):
        imageio.decode_png(bad_filter)
    ok, jpg = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
    want = cv2.imdecode(jpg, cv2.IMREAD_COLOR)
    monkeypatch.setitem(sys.modules, "cv2", None)  # a JPEG body needs no opencv
    assert np.array_equal(imageio.imdecode(jpg.tobytes()), want)
    assert np.array_equal(imageio.imdecode(imageio.encode_png(px)), np.zeros((2, 3, 3)))
    assert imageio.imdecode(b"GIF89a") is None


def test_jpeg_body_decodes_through_cv2():
    rng = np.random.RandomState(4)
    ok, jpg = cv2.imencode(".jpg", rng.randint(0, 256, (16, 24, 3)).astype(np.uint8))
    want = cv2.imdecode(jpg, cv2.IMREAD_COLOR)
    assert np.array_equal(imageio.imdecode(jpg.tobytes()), want)


@pytest.mark.parametrize("shape,dtype", [((45, 67, 3), np.uint8), ((45, 67), np.uint8),
                                         ((30, 20, 4), np.uint8), ((33, 41, 3), np.uint16)],
                         ids=["bgr8", "gray8", "bgra8", "bgr16"])
def test_writer_filters_rows_as_libpng(shape, dtype):
    """``encode_png`` picks cv2's (libpng's) filter on every row,
    Paeth among them, and both readers read the file back."""
    rng = np.random.RandomState(len(shape))
    maxv = np.iinfo(dtype).max
    img = _smooth(shape[0], shape[1], shape[2] if len(shape) == 3 else 1, maxv, rng)
    img = img.astype(dtype).reshape(shape)

    def kinds(data):
        idat = b"".join(b for k, b, _ in imageio._png_chunks(data)[0] if k == b"IDAT")
        return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], -1)[:, 0]

    seen = set()
    for level in (1, 6, 9):
        data = imageio.encode_png(img, level)
        ok, want = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        assert np.array_equal(kinds(data), kinds(want.tobytes())), level
        assert np.array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), -1), img)
        assert np.array_equal(imageio.decode_png(data, -1), img)
        seen |= set(kinds(data).tolist())
    assert 4 in seen


# ---- resize ----------------------------------------------------------------

RESIZE_CASES = [((375, 1242), (256, 832), 3), ((100, 150), (256, 320), 3),
                ((128, 192), (64, 96), 3), ((37, 53), (20, 71), 3), ((37, 53), (91, 17), 1),
                ((5, 7), (3, 2), 4), ((64, 96), (128, 192), 3)]


@pytest.mark.parametrize("src,dst,ch", RESIZE_CASES,
                         ids=["kitti_down", "up", "exact_2x_down", "ragged", "ragged_gray",
                              "tiny", "exact_2x_up"])
def test_resize_equals_cv2(src, dst, ch):
    rng = np.random.RandomState(sum(src))
    img = rng.randint(0, 256, src + ((ch,) if ch > 1 else ())).astype(np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]))
    got = imageio.resize(img, (dst[1], dst[0]))
    assert got.shape == want.shape and np.array_equal(got, want)


# ---- interlaced (Adam7) PNG and grey reads of colour PNG -------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
# (colour type, bit depth): every pair the port reads
PNG_KINDS = [(0, 8), (0, 16), (2, 8), (2, 16), (3, 8), (4, 8), (6, 8)]
FLAGS3 = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)


def _samples(h, w, ctype, depth, rng):
    """A PNG's samples (h, w, channels) and the chunks its colour type needs."""
    if ctype == 3:
        pal = rng.randint(0, 256, (23, 3)).astype(np.uint8)
        extra = (imageio._chunk(b"PLTE", pal.tobytes())
                 + imageio._chunk(b"tRNS", rng.randint(0, 256, 11).astype(np.uint8).tobytes()))
        return rng.randint(0, 23, (h, w, 1)).astype(np.uint8), extra
    ch = imageio._CHANNELS[ctype]
    dtype = np.uint16 if depth == 16 else np.uint8
    maxv = np.iinfo(dtype).max
    px = _smooth(h, w, ch, maxv, rng) if min(h, w) > 1 else rng.randint(0, maxv + 1, (h, w, ch))
    return px.astype(dtype), b""


def _rows(px):
    """(h, w, ch) samples -> (h, row_bytes) bytes as the PNG stores them."""
    raw = px.astype(">u2") if px.dtype == np.uint16 else px
    return np.ascontiguousarray(raw).view(np.uint8).reshape(px.shape[0], -1)


def _adam7(px, depth, ctype, extra):
    """An interlaced PNG of the samples, each pass's rows filtered with the
    five filters in turn (cv2 writes no interlaced file)."""
    h, w, ch = px.shape
    bpp = ch * depth // 8
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = px[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_rows(sub), bpp, [k % 5 for k in range(sub.shape[0])])
    return (imageio._PNG_MAGIC
            + imageio._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
            + extra + imageio._chunk(b"IDAT", zlib.compress(raw, 6))
            + imageio._chunk(b"IEND", b""))


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (33, 65)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ctype,depth", PNG_KINDS, ids=[f"ct{c}_{d}" for c, d in PNG_KINDS])
def test_adam7_reads_equal_cv2(ctype, depth, size):
    rng = np.random.RandomState(ctype * 100 + depth + size[1])
    px, extra = _samples(*size, ctype, depth, rng)
    data = _adam7(px, depth, ctype, extra)
    plain = _png(size[1], size[0], depth, ctype,
                 _filter_rows(_rows(px), px.shape[2] * depth // 8, [0] * size[0]), extra)
    for flags in FLAGS3:
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
        got = imageio.decode_png(data, flags)
        assert got.dtype == want.dtype and got.shape == want.shape, flags
        assert np.array_equal(got, want), flags
        assert np.array_equal(got, imageio.decode_png(plain, flags)), flags  # same pixels


@pytest.mark.parametrize("ctype,depth", [(2, 8), (2, 16), (3, 8), (6, 8)],
                         ids=["rgb8", "rgb16", "palette", "rgba8"])
def test_grey_reads_of_colour_files_equal_cv2(ctype, depth):
    """cv2 asks libpng for (9797 R + 19234 G + 3737 B) >> 15 (rounded at 16
    bits, then cut to the high byte); grey pixels among colour ones, and
    saturated and zero channels, included."""
    rng = np.random.RandomState(ctype + depth)
    px, extra = _samples(40, 56, ctype, depth, rng)
    if ctype != 3:
        maxv = np.iinfo(px.dtype).max
        px[:3] = px[:3, :, :1]  # grey rows: R = G = B
        px[3:6, :, :3] = rng.choice([0, maxv], (3, px.shape[1], 3))
    data = _png(56, 40, depth, ctype,
                _filter_rows(_rows(px), px.shape[2] * depth // 8, [4, 3, 2, 1, 0] * 8), extra)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    got = imageio.decode_png(data, imageio.IMREAD_GRAYSCALE)
    assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_committed_adam7_fixtures_decode_to_cv2s(ctype):
    folder = os.path.join(REPO, "tests", "torch_fixtures", "png")
    path = os.path.join(folder, f"adam7_ct{ctype}.png")
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    fixture = imageio.imread(os.path.join(folder, f"adam7_ct{ctype}_cv2.png"),
                             imageio.IMREAD_UNCHANGED)
    assert np.array_equal(fixture, want)  # the fixture is still cv2's decode
    for flags in FLAGS3:
        assert np.array_equal(imageio.imread(path, flags), cv2.imread(path, flags)), flags
