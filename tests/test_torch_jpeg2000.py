"""The port's JPEG 2000 reader (``utils/jpeg2000.py``, ``csrc/jpeg2000.c``)
against ``cv2.imdecode`` (OpenCV 5.0 with OpenJPEG 2.5), every value equal,
under ``IMREAD_COLOR``, ``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED``: the
committed fixtures of ``tests/torch_fixtures/jpeg2000/`` (against cv2 live
and against the digests of cv2's decodes committed beside them; where cv2
gives None the port gives None or raises); JP2 and J2K files that PIL and
OpenJPEG's encoder write at odd sizes with each of their coding options
(5/3 and 9/7, every progression order, code-block styles, precincts,
tiles, layers, POC, ROI, SOP/EPH, tile-parts, PPM/PPT); every prefix of a
file and a seeded pass of corrupted bodies, where cv2 giving no image and
the port giving none go together; ``imread`` of a ``.jp2``; and the served
pair, whose ``.flo`` reply equals the reply to the PNG of its pixels."""

import hashlib
import io
import json
import os
import threading
import time
import types
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from tests.torch_fixtures import fuzz_jpeg2000 as fuzz
from tests.torch_fixtures.make_fixtures import (cdef_box, cmap_box, enumcs, jp2_wrap, opj_encode,
                                                packed_headers, pclr_box)
from unopticalflow_tpu_torch.utils import imageio

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "jpeg2000")
with open(os.path.join(FIXTURES, "expected.json")) as _f:
    EXPECTED = json.load(_f)
FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)


def digest(a) -> str:
    h = hashlib.sha256()
    a = np.ascontiguousarray(a)
    h.update(str(a.dtype.str).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def _cv2(data, flags):
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    except cv2.error:
        return None


def _port(data, flags):
    """The port's decode, or None where it gives none or raises naming a
    JPEG 2000 fault."""
    try:
        return imageio.imdecode(data, flags)
    except ValueError as e:
        assert str(e).startswith("JPEG 2000: "), e
        return None


def _as_cv2(data, flags=FLAGS):
    """The port decodes ``data`` as cv2 does under each of ``flags``; where
    cv2 gives no image, it gives none either (None or a raise)."""
    for f in flags:
        want, got = _cv2(data, f), _port(data, f)
        if want is None:
            assert got is None, f
            continue
        assert got is not None, f
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f
        assert got.flags.writeable


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_decodes_as_cv2(name):
    data = _read(name)
    _as_cv2(data)
    for f in FLAGS:  # the committed digest of cv2's decode, which the card's machine checks
        got = _port(data, f)
        assert (digest(got) if got is not None else "none") == EXPECTED[name][str(f)], f


def test_fixtures_cover_the_codestream_features():
    """The fixtures hold each marker segment and box the reader takes, and
    cv2 refuses the ones named bad (and the CMYK colour space)."""
    joined = b"".join(_read(n) for n in EXPECTED)
    for marker in (b"\xff\x52", b"\xff\x5c", b"\xff\x5f", b"\xff\x5e", b"\xff\x55", b"\xff\x58",
                   b"\xff\x60", b"\xff\x61", b"\xff\x64", b"\xff\x91", b"\xff\x92"):
        assert marker in joined, marker
    for box in (b"ihdr", b"colr", b"pclr", b"cmap", b"cdef", b"jp2c"):
        assert box in joined, box
    for name, entry in EXPECTED.items():
        if name.startswith("bad_") or name == "jp2_cmyk_colr.jp2":
            assert set(entry.values()) == {"none"}, name
        elif name != "jp2_palette_without_cmap.jp2" and name != "pil_la.jp2":
            assert "none" not in entry.values(), name


def test_pair_decodes_to_its_pixels():
    """The served 512x832 pair: its lossless JP2 decodes to the pair's
    pixels, its irreversible J2K to what cv2 decodes."""
    pair = cv2.imread(os.path.join(FIXTURES, "..", "jpeg", "pair_512x832.png"))
    got = imageio.imdecode(_read("pair_512x832_lossless.jp2"))
    assert got.shape == (512, 832, 3) and np.array_equal(got, pair)
    _as_cv2(_read("pair_512x832_irreversible.j2k"), (cv2.IMREAD_COLOR,))


def _smooth(rng, h, w, ch):
    img = rng.randint(0, 256, (h, w, ch)).astype(np.uint8)
    return cv2.GaussianBlur(img, (0, 0), 2).reshape(h, w, ch).astype(np.int32)


_CODINGS = {
    "lossless": dict(),
    "97": dict(irreversible=True),
    "layers_97": dict(irreversible=True, layers=[40, 12, 4]),
    "rlcp_layers": dict(prog="RLCP", layers=[30, 10, 0]),
    "rpcl_precincts": dict(prog="RPCL", precincts=[(16, 16), (8, 8), (4, 4)], cblk=(8, 8)),
    "pcrl_tiles": dict(prog="PCRL", tile=(24, 16), precincts=[(32, 32), (16, 16)]),
    "cprl_97": dict(prog="CPRL", irreversible=True, cblk=(4, 16), layers=[10]),
    "styles": dict(mode=0x3F, layers=[25, 8, 0]),
    "styles_97": dict(mode=0x3F, irreversible=True, layers=[25, 8]),
    "bypass_termall": dict(mode=0x05, cblk=(16, 16)),
    "vsc_segsym_97": dict(mode=0x28, irreversible=True),
    "sop_eph": dict(sop=True, eph=True, layers=[20, 0]),
    "roi": dict(roi=(0, 5), layers=[12]),
    "tileparts": dict(tile=(16, 16), tp="R", layers=[20, 0]),
    "mct0_97": dict(mct=0, irreversible=True),
}


@pytest.mark.parametrize("hw", [(1, 1), (1, 37), (29, 1), (5, 3), (33, 65), (64, 48)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("coding", sorted(_CODINGS))
def test_written_codestreams_decode_as_cv2(coding, hw):
    """OpenJPEG's encoder at sizes that are no multiple of a code-block,
    precinct or tile, 1 to 4 components, each coding option, J2K and JP2."""
    h, w = hw
    rng = np.random.RandomState(h * 1000 + w)
    kw = dict(_CODINGS[coding])
    kw["numres"] = max(1, min(4, int(np.log2(min(h, w))) + 1))
    if "precincts" in kw:
        kw["precincts"] = kw["precincts"][:kw["numres"]]
    for ch in (1, 3, 4):
        if ch < 3 and kw.get("mct") == 0:
            continue
        img = _smooth(rng, h, w, ch)
        space = "gray" if ch == 1 else "srgb"
        try:
            data = opj_encode([img[:, :, k] for k in range(ch)], space=space,
                              jp2=bool(ch % 2), **kw)
        except RuntimeError:
            continue  # options OpenJPEG's encoder refuses at this size
        _as_cv2(data)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_pil_files_decode_as_cv2(mode):
    from PIL import Image

    rng = np.random.RandomState(3)
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    arr = _smooth(rng, 27, 45, ch)
    im = (Image.fromarray((arr[:, :, 0] * 251).astype(np.uint16)) if mode == "I;16"
          else Image.fromarray(arr.astype(np.uint8).squeeze(), mode))
    for kw in (dict(), dict(irreversible=True, no_jp2=True), dict(progression="CPRL",
                                                                  num_resolutions=3),
               dict(quality_mode="rates", quality_layers=[30, 10], tile_size=(16, 16))):
        buf = io.BytesIO()
        im.save(buf, "JPEG2000", **kw)
        _as_cv2(buf.getvalue())


def test_colour_boxes_decode_as_cv2():
    """sYCC (cv2's YUV2BGR of the components), greyscale, unknown and ICC
    colour specifications, a palette with and without cmap, cdef swaps,
    4-, 10-, 12- and 16-bit samples, and 2 components."""
    rng = np.random.RandomState(5)
    img = _smooth(rng, 21, 34, 4)
    planes = [img[:, :, k] for k in range(4)]
    cs3 = opj_encode(planes[:3], jp2=False, numres=3)
    idx = rng.randint(0, 300, (21, 34))
    cs1 = opj_encode([idx], prec=9, jp2=False, space="gray", numres=3)
    pal = rng.randint(0, 65536, (300, 3))
    bodies = [jp2_wrap(cs3, enumcs(18)), jp2_wrap(cs3, enumcs(17)), jp2_wrap(cs3, enumcs(24)),
              jp2_wrap(cs3, b"\3\0\0" + bytes(60)),
              jp2_wrap(cs3, extra=cdef_box([(0, 0, 2), (1, 0, 1), (2, 0, 3)])),
              jp2_wrap(cs3, extra=cdef_box([(0, 1, 0), (1, 0, 1)])),
              jp2_wrap(cs1, extra=pclr_box(pal, [15, 15, 15])
                       + cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)])),
              jp2_wrap(cs1, extra=pclr_box(pal[:, :1] & 0xFF, [0x87])  # signed 8-bit entries
                       + cmap_box([(0, 1, 0)])),
              opj_encode(planes[:2], space="gray", numres=2),
              opj_encode(planes[:2], numres=2),
              opj_encode([p >> 4 for p in planes[:3]], prec=4, numres=2)]
    for prec in (10, 12, 16):
        scaled = [p.astype(np.int64) * ((1 << prec) - 1) // 255 for p in planes]
        bodies += [opj_encode(scaled, prec=prec, numres=3),
                   opj_encode(scaled[:3], prec=prec, space="sycc", mct=0, numres=3),
                   opj_encode(scaled[:1], prec=prec, space="gray", irreversible=True, numres=3)]
    for data in bodies:
        _as_cv2(data)


def test_packet_headers_in_ppm_and_ppt_decode_as_cv2():
    rng = np.random.RandomState(6)
    img = _smooth(rng, 40, 50, 3)
    for kw in (dict(), dict(tile=(16, 24), irreversible=True, layers=[20, 5]),
               dict(eph=True, prog="RPCL", precincts=[(16, 16), (8, 8), (4, 4)])):
        cs = opj_encode([img[:, :, k] for k in range(3)], jp2=False, numres=3, **kw)
        for where in ("ppm", "ppt"):
            packed = packed_headers(cs, where)
            assert np.array_equal(_cv2(packed, cv2.IMREAD_UNCHANGED),
                                  _cv2(cs, cv2.IMREAD_UNCHANGED))
            _as_cv2(packed)


def test_poc_in_the_main_header_decodes_as_cv2():
    """OpenJPEG writes its POC in the tile-part header; moved to the main
    header it applies to the tile as before (a tile inherits the main
    header's POCs)."""
    import struct

    from unopticalflow_tpu_torch.utils import jpeg2000

    cs = _read("opj_poc.j2k")
    pos = jpeg2000._main_header(cs)[3]
    at = cs.index(b"\xff\x5f", pos)
    poc = cs[at:at + 2 + struct.unpack(">H", cs[at + 2:at + 4])[0]]
    psot = struct.unpack(">I", cs[pos + 6:pos + 10])[0]
    moved = (cs[:pos] + poc + cs[pos:pos + 6] + struct.pack(">I", psot - len(poc))
             + cs[pos + 10:at] + cs[at + len(poc):])
    assert np.array_equal(_cv2(moved, cv2.IMREAD_UNCHANGED), _cv2(cs, cv2.IMREAD_UNCHANGED))
    _as_cv2(moved)


@pytest.mark.parametrize("kind", ["jp2", "j2k_layers"])
def test_every_prefix_gives_no_image_where_cv2_gives_none(kind):
    rng = np.random.RandomState(7)
    img = _smooth(rng, 9, 13, 3)
    data = opj_encode([img[:, :, k] for k in range(3)], jp2=kind == "jp2", numres=2,
                      layers=[0] if kind == "jp2" else [15, 0])
    for n in range(1, len(data) + 1):
        _as_cv2(data[:n], (cv2.IMREAD_COLOR,))


@pytest.mark.parametrize("seed", range(4))
def test_corrupted_bodies_decode_or_give_no_image_as_cv2(seed):
    """A seeded pass of 80 bodies a seed (``tests/torch_fixtures/
    fuzz_jpeg2000.py``'s generator: bytes cut, set or flipped): the port
    decodes each as cv2 does, and gives no image where cv2 gives none."""
    start = time.perf_counter()
    rng = np.random.RandomState(100 + seed)
    files = fuzz.bases(rng)
    for _ in range(80):
        data = fuzz.corrupt(rng, files[rng.randint(len(files))])
        if imageio._decoder(data) is not None:
            assert fuzz.outcome(data, cv2.IMREAD_COLOR) in ("equal", "both none")
    assert time.perf_counter() - start < 60


def test_imread_reads_jpeg2000(tmp_path):
    for name in ("pil_rgb.jp2", "opj_lrcp.j2k"):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(_read(name))
        for flags in FLAGS:
            want = cv2.imread(path, flags)
            got = imageio.imread(path, flags)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    path = str(tmp_path / "bad.j2k")
    with open(path, "wb") as f:
        f.write(_read("bad_truncated.j2k"))
    assert cv2.imread(path) is None
    with pytest.raises(ValueError, match="JPEG 2000: "):
        imageio.imread(path)


def test_server_answers_jp2_and_j2k_as_the_png_of_their_pixels(monkeypatch):
    """A stacked pair as lossless JP2 and irreversible J2K: the port's
    ``_decode_pair`` as the JAX server's (cv2's), and the HTTP reply the
    reply to the PNG of the decoded pixels."""
    import sys
    from http.server import ThreadingHTTPServer

    from PIL import Image

    from serve import _decode_pair as jax_decode_pair
    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
    from unopticalflow_tpu_torch.serve import FlowServer, _decode_pair, make_handler

    rng = np.random.RandomState(8)
    pair = _smooth(rng, 96, 80, 3).astype(np.uint8)
    bodies = []
    for kw in (dict(), dict(irreversible=True, no_jp2=True, quality_mode="rates",
                            quality_layers=[8])):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(pair[:, :, ::-1])).save(buf, "JPEG2000", **kw)
        bodies.append(buf.getvalue())
    wants = [jax_decode_pair(b, (32, 64)) for b in bodies]
    pngs = [imageio.encode_png(_cv2(b, cv2.IMREAD_COLOR)) for b in bodies]
    monkeypatch.setitem(sys.modules, "cv2", None)  # the port's decode needs no opencv
    for body, want in zip(bodies, wants):
        got = _decode_pair(body, (32, 64))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    h, w = 64, 128
    model = FlowModel(FlowModelConfig(), device="cpu", scheme="pwc",
                      generator=torch.Generator().manual_seed(0))
    cfg = types.SimpleNamespace(img_hw=(h, w))
    engine = FlowServer(cfg, model, max_batch=2, max_wait_ms=5)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine, cfg))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/flow"

    def post(body):
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()

    try:
        for body, png in zip(bodies, pngs):
            assert post(body) == post(png)
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        engine.close()
    assert not t.is_alive()
