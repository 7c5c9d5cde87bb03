"""Writes the fixtures of ``chip_smoke.py`` phase 17 and the port's image
tests: JPEG and PNG files with cv2's decodes, the JPEG PIL writes of a
magma disparity, the SHA-256 of the JAX package's drawings, and a
MATLAB-layout NYUv2 labeled set with what the JAX package reads from it.

    python tests/torch_fixtures/make_fixtures.py

It needs cv2, PIL, h5py, scipy and the JAX package (the card's machine
has none of them, so the files are committed): OpenCV 5.0.0 with
libjpeg-turbo 3.1.2 and libpng 1.6.58 wrote and decoded the JPEGs and
PNGs, Pillow 12.1 the JPEGs it writes, h5py 3.14 the ``.mat``.  Every file
is made from a seed.

* ``jpeg/<name>.jpg``: baseline JPEGs (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and
  grey, qualities 10 to 100, a restart interval, optimised Huffman tables,
  an odd size, an Exif orientation), each beside ``<name>.png``, cv2's
  ``IMREAD_COLOR`` decode written by the port's ``encode_png``; a 512x832
  stacked pair and its two 256x832 frames (4:2:0, quality 90).
* ``jpeg/prog_<name>.jpg``: progressive JPEGs, each beside cv2's decode:
  4:4:4, 4:2:2 and 4:2:0 from cv2, one with a restart interval, one from
  PIL (``progressive=True``), an odd size, and ``prog_cut3.jpg``, a cv2
  progressive file cut after its third scan and ended with EOI (libjpeg
  smooths its blocks; the port raises).  ``pair_512x832_progressive.jpg``
  holds the pixels of ``pair_512x832.jpg`` at its quality; cv2 decodes both
  to the same pixels, so ``pair_512x832.png`` serves both.
* ``png/adam7_ct<k>.png``: interlaced (Adam7) PNGs of colour types 0, 2,
  3 (with ``tRNS``), 4 and 6, each pass filtered with all five row
  filters in turn, written by ``tests/test_torch_imageio.py``'s writer (cv2
  writes no interlaced PNG), each beside
  ``adam7_ct<k>_cv2.png``, cv2's ``IMREAD_UNCHANGED`` decode.
* ``jpeg/disp_magma.png`` (BGR) and ``jpeg/disp_magma_q75.jpg``: the magma
  pixels the JAX package's ``save_disp_color_img`` hands PIL for a seeded
  disparity, and the JPEG PIL writes of them.
* ``formats/<name>.<ext>``: BMP (cv2's and PIL's, hand-packed RLE8 and
  RLE4 with end-of-line, delta and end-of-bitmap codes, 1- and 4-bit and
  short palettes, 555 and 565, OS/2, V4 and V5 headers, top-down rows),
  PNM (ASCII with comments, binary, 16-bit, maxvals 100 and 1000), PAM
  (the four tuple types), PFM (both byte orders, a scale of 0.5), Sun
  raster (cv2's, 1-, 8- and 32-bit, with and without a colour map,
  ``RT_OLD``), Radiance HDR (cv2's RLE, flat, narrow, ``#?RGBE``) and TIFF
  (none, PackBits, LZW with Predictor 2, Deflate, JPEG from PIL, big-endian,
  BigTIFF, tiled, planar, 16-bit, 1-bit white-is-zero, palettes, alpha
  associated and not, an Orientation), each beside ``<name>_cv2.png``,
  cv2's ``IMREAD_COLOR`` decode; ``formats/expected.json``: the SHA-256 of
  cv2's decode of each under each of the three flags (or why the port
  raises where cv2's output is undefined); ``formats/pair_512x832_jpeg.tif``,
  the stacked pair's pixels as PIL's JPEG-compressed TIFF.  Written with
  ``chip_smoke.py``'s writers, cv2 and PIL.
* ``jpeg/cmyk_<name>.jpg``: PIL's CMYK JPEGs (Adobe's inverted CMYK,
  4:4:4 and 4:2:0, one progressive), each beside cv2's decode.
* ``drawing/expected.json``: the SHA-256 of the pixels of the PNGs the JAX
  package's ``show_corres`` and ``show_epipolar_line`` write on
  ``chip_smoke.drawing_inputs(17)`` (``np.random`` seeded with 17 before
  the epipolar lines).
* ``nyu/nyu_depth_v2_labeled.mat``: a 512-byte MATLAB user block; chunked,
  deflated ``images`` (3, 3, 640, 480) uint8 and ``depths`` (3, 640, 480)
  float32 of smooth content; ``scenes`` (1, 3) references to (L, 1) uint16
  char datasets under ``#refs#``.  ``nyu/splits.mat`` (scipy, MATLAB v5).
  ``nyu/expected.json``: the SHA-256 of the arrays the JAX package's
  ``load_nyu_test_data`` returns, its ``eval_depth`` and ``eval_mask`` on
  ``chip_smoke.depth_mask_inputs(17)``, and the SHA-256 of the pixels of
  ``eval_mask``'s PNGs.
* ``jpeg2000/<name>.jp2|j2k`` (``python tests/torch_fixtures/make_fixtures.py
  jpeg2000``): PIL's JP2 and J2K files and OpenJPEG's (``opj_encode``, the
  libopenjp2 2.5 PIL ships, through ctypes): 5/3 and 9/7, each progression,
  code-block style, POC, ROI, tile-parts, PLT/TLM, precisions 10-16, sYCC,
  colour, palette and channel-definition boxes, PPM and PPT
  (``packed_headers``), bodies cv2 refuses, the stacked pair as lossless
  JP2 and irreversible J2K and the demo's frames as JP2;
  ``jpeg2000/expected.json``: the SHA-256 of cv2's decode of each under
  each flag ("none" where it gives none).  ``grey/``: colour PNGs with
  gAMA, sRGB and cHRM chunks (libpng's gamma grey reads), grey-and-alpha
  TIFF tiles and a Predictor 2 TIFF without compression, with cv2's
  digests (or the port's raise).
* ``png/<name>.png`` (``python tests/torch_fixtures/make_fixtures.py
  png_gif``): PNGs at every depth libpng reads, ``tRNS``, ``eXIf`` and
  APNGs (``png_depth_files``); ``gif/<name>.gif``: PIL's, cv2's and
  ``chip_smoke.write_gif``'s GIFs and bodies cv2 refuses (``gif_files``);
  each directory's ``expected.json``: the SHA-256 of cv2's decode of each
  under each flag ("none" where it gives none, or the port's refusal).
"""

import hashlib
import io
import json
import os
import struct
import sys
import tempfile
import types
import zlib

import cv2
import h5py
import numpy as np
import scipy.io
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

from chip_smoke import (bmp_rows, depth_mask_inputs, drawing_inputs, write_bmp,  # noqa: E402
                        write_hdr, write_sun, write_tiff)
from tests.test_torch_imageio import _adam7  # noqa: E402
from tests.test_torch_jpeg_progressive import _scans  # noqa: E402
from unopticalflow_tpu_torch.utils import imageio  # noqa: E402

SEED = 17
NYU_SCENES = ["bedroom_0001", "kitchen_0002", "office_0003"]


def smooth(rng, h, w, ch=3, blur=9):
    img = rng.randint(0, 256, (h, w, ch)).astype(np.uint8)
    return cv2.GaussianBlur(img, (0, 0), blur).reshape(h, w, ch)


def exif_segment(orientation: int) -> bytes:
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def jpeg_fixtures(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(SEED)
    img = smooth(rng, 48, 64, blur=3)
    noise = rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
    sf = {k: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{k}") for k in
          ("444", "422", "420", "440", "411")}
    q, s = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    cases = {
        "s444_q90": (img, [q, 90, s, sf["444"]]),
        "s422_q75": (img, [q, 75, s, sf["422"]]),
        "s420_q50": (img, [q, 50, s, sf["420"]]),
        "s440_q95": (img, [q, 95, s, sf["440"]]),
        "s411_q60": (img, [q, 60, s, sf["411"]]),
        "grey_q85": (img[:, :, 1], [q, 85]),
        "s420_q10": (img, [q, 10, s, sf["420"]]),
        "s444_q100_noise": (noise, [q, 100, s, sf["444"]]),
        "s420_rst2": (img, [q, 80, s, sf["420"], cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
        "s422_optimized": (img, [q, 70, s, sf["422"], cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
        "odd_17x31_420": (img[:17, :31], [q, 85, s, sf["420"]]),
    }
    files = {}
    for name, (src, params) in cases.items():
        files[name] = cv2.imencode(".jpg", src, params)[1].tobytes()
    base = cv2.imencode(".jpg", img[:, :40], [q, 90, s, sf["420"]])[1].tobytes()
    files["exif6_420"] = base[:2] + exif_segment(6) + base[2:]
    # the served pair and the demo's frames: a smooth scene and the same
    # scene moved 3 px right and 2 px down
    scene = smooth(rng, 262, 840, blur=6)
    a, b = scene[2:258, 3:835], scene[:256, :832]
    files["frame_a"] = cv2.imencode(".jpg", a, [q, 90, s, sf["420"]])[1].tobytes()
    files["frame_b"] = cv2.imencode(".jpg", b, [q, 90, s, sf["420"]])[1].tobytes()
    files["pair_512x832"] = cv2.imencode(".jpg", np.concatenate([a, b], 0),
                                         [q, 90, s, sf["420"]])[1].tobytes()
    prog = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    prog_cases = {
        "prog_s444_q90": (img, [q, 90, s, sf["444"], *prog]),
        "prog_s422_q75": (img, [q, 75, s, sf["422"], *prog]),
        "prog_s420_q50": (img, [q, 50, s, sf["420"], *prog]),
        "prog_s420_rst2": (img, [q, 80, s, sf["420"], cv2.IMWRITE_JPEG_RST_INTERVAL, 2, *prog]),
        "prog_odd_17x31_420": (img[:17, :31], [q, 85, s, sf["420"], *prog]),
    }
    for name, (src, params) in prog_cases.items():
        files[name] = cv2.imencode(".jpg", src, params)[1].tobytes()
    pil = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[:, :, ::-1])).save(pil, "JPEG", progressive=True)
    files["prog_pil_s420"] = pil.getvalue()
    # ended after its third scan: the fourth scan header goes, and the rest
    files["prog_cut3"] = files["prog_s420_q50"][:_scans(files["prog_s420_q50"])[3]] + b"\xff\xd9"
    for name, data in files.items():
        with open(os.path.join(out, name + ".jpg"), "wb") as f:
            f.write(data)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        imageio.imwrite(os.path.join(out, name + ".png"), want)
    pair_prog = cv2.imencode(".jpg", np.concatenate([a, b], 0),
                             [q, 90, s, sf["420"], *prog])[1].tobytes()
    assert np.array_equal(cv2.imdecode(np.frombuffer(pair_prog, np.uint8), cv2.IMREAD_COLOR),
                          cv2.imdecode(np.frombuffer(files["pair_512x832"], np.uint8),
                                       cv2.IMREAD_COLOR))
    with open(os.path.join(out, "pair_512x832_progressive.jpg"), "wb") as f:
        f.write(pair_prog)


# (fixture, flag) pairs where cv2 leaves part of its output unset, or reads
# the file wrongly, and the port raises: the message's words
UNDEFINED = {
    ("pam_rgba", 1): "leaves the rest", ("pam_rgba", 0): "leaves the rest",
}


def cmyk_fixtures(out: str) -> None:
    rng = np.random.RandomState(SEED + 4)
    img = smooth(rng, 24, 40, ch=4, blur=3)
    cases = {"cmyk_q90": {"quality": 90}, "cmyk_s420_q60": {"quality": 60, "subsampling": 2},
             "cmyk_prog": {"quality": 80, "progressive": True}}
    for name, kwargs in cases.items():
        buf = io.BytesIO()
        Image.frombytes("CMYK", img.shape[1::-1], img.tobytes()).save(buf, "JPEG", **kwargs)
        with open(os.path.join(out, name + ".jpg"), "wb") as f:
            f.write(buf.getvalue())
        want = cv2.imdecode(np.frombuffer(buf.getvalue(), np.uint8), cv2.IMREAD_COLOR)
        imageio.imwrite(os.path.join(out, name + ".png"), want)


def _pnm_ascii(magic: bytes, img: np.ndarray, maxval) -> bytes:
    h, w = img.shape[:2]
    head = magic + b"\n# a comment\n%d %d\n" % (w, h)
    if maxval is not None:
        head += b"# another\n%d\n" % maxval
    rows = [b" ".join(b"%d" % v for v in r.ravel()) for r in img]
    return head + b"\n".join(rows) + b"\n"


def format_files() -> dict:
    """{name: file bytes} of the format fixtures."""
    rng = np.random.RandomState(SEED + 5)
    h, w = 23, 37
    bgr = smooth(rng, h, w, blur=2)
    bgr[::5, ::3] = rng.randint(0, 256, bgr[::5, ::3].shape)  # some edges
    grey = np.ascontiguousarray(bgr[:, :, 1])
    rgb = np.ascontiguousarray(bgr[:, :, ::-1])
    files = {}
    # BMP
    files["bmp_cv2_24.bmp"] = cv2.imencode(".bmp", bgr)[1].tobytes()
    files["bmp_cv2_grey.bmp"] = cv2.imencode(".bmp", grey)[1].tobytes()
    pil = io.BytesIO()
    Image.fromarray(rgb).quantize(40).save(pil, "BMP")
    files["bmp_pil_p8.bmp"] = pil.getvalue()
    pil = io.BytesIO()
    Image.fromarray(rgb).convert("RGBA").save(pil, "BMP")
    files["bmp_pil_32.bmp"] = pil.getvalue()
    idx4 = rng.randint(0, 16, (h, w)).astype(np.uint8)
    pad = np.zeros((h, w + 1), np.uint8)
    pad[:, :w] = idx4
    rows4 = [((r[0::2] << 4) | r[1::2]).astype(np.uint8).tobytes() for r in pad]
    files["bmp_p4_short.bmp"] = write_bmp(w, h, 4, bmp_rows(rows4),
                                          rng.randint(0, 256, (5, 3)))  # indices past 5: black
    bits = rng.randint(0, 2, (h, w)).astype(np.uint8)
    files["bmp_p1.bmp"] = write_bmp(w, h, 1, bmp_rows([np.packbits(r).tobytes() for r in bits]),
                                    [(10, 200, 30), (250, 240, 5)])
    v16 = rng.randint(0, 65536, (h, w)).astype("<u2")
    rows16 = [r.tobytes() for r in v16]
    files["bmp_555.bmp"] = write_bmp(w, h, 16, bmp_rows(rows16))
    files["bmp_565.bmp"] = write_bmp(w, h, 16, bmp_rows(rows16), rle=3,
                                     masks=(0xF800, 0x7E0, 0x1F))
    pal8 = rng.randint(0, 256, (256, 3))
    idx8 = rng.randint(0, 256, (h, w)).astype(np.uint8)
    files["bmp_os2_p8.bmp"] = write_bmp(w, h, 8, bmp_rows([r.tobytes() for r in idx8]), pal8,
                                        hsize=12)
    files["bmp_os2_24.bmp"] = write_bmp(w, h, 24, bmp_rows([r.tobytes() for r in bgr]),
                                        hsize=12)
    bgra = np.dstack([bgr, rng.randint(0, 256, (h, w))]).astype(np.uint8)
    files["bmp_v4_32_masks.bmp"] = write_bmp(w, h, 32, bmp_rows([r.tobytes() for r in bgra]),
                                             rle=3, hsize=108,
                                             masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    files["bmp_v5_24_topdown.bmp"] = write_bmp(w, h, 24, bmp_rows(
        [r.tobytes() for r in bgr[::-1]]), hsize=124, topdown=True)
    # RLE8: runs, an absolute run, end of line early, a delta, end of bitmap early
    rle8 = bytearray()
    for y in range(h - 4):
        if y % 4 == 1:
            rle8 += bytes((0, 9)) + bytes(rng.randint(0, 256, 9).tolist()) + b"\0"  # absolute
            rle8 += bytes((5, 17, 0, 0))  # 5 pixels, end of line
        elif y % 4 == 2:
            rle8 += bytes((7, 3, 0, 2, 4, 1, 20, 200, 0, 0))  # delta: 4 right, 1 down
        else:
            rle8 += bytes((20, rng.randint(0, 256), w - 20, rng.randint(0, 256)))
    rle8 += bytes((0, 1))
    files["bmp_rle8.bmp"] = write_bmp(w, h, 8, bytes(rle8), pal8, rle=1)
    rle4 = bytearray()
    for y in range(h - 3):
        if y % 3 == 0:
            rle4 += bytes((0, 11)) + bytes(rng.randint(0, 256, 6).tolist()) + bytes((14, 0x5A))
            rle4 += bytes((0, 0))
        elif y % 3 == 1:
            rle4 += bytes((w, 0x3C))
            rle4 += bytes((0, 0))
        else:
            rle4 += bytes((6, 0x12, 0, 2, 3, 0, 9, 0x77, 0, 0))  # a delta along the row
    rle4 += bytes((0, 0)) * 3 + bytes((0, 1))
    files["bmp_rle4.bmp"] = write_bmp(w, h, 4, bytes(rle4), rng.randint(0, 256, (16, 3)), rle=2)
    # PNM, PAM, PFM
    files["pbm_p1_comments.pbm"] = _pnm_ascii(b"P1", bits, None)
    files["pbm_p4.pbm"] = b"P4\n# odd width\n%d %d\n" % (w, h) + np.packbits(
        bits, axis=1).tobytes()
    files["pgm_p2_mv100.pgm"] = _pnm_ascii(b"P2", (grey.astype(int) * 100) // 255, 100)
    files["pgm_p5.pgm"] = cv2.imencode(".pgm", grey)[1].tobytes()
    g16 = rng.randint(0, 65536, (h, w)).astype(np.uint16)
    files["pgm_p5_16.pgm"] = cv2.imencode(".pgm", g16)[1].tobytes()
    files["pgm_p5_mv1000.pgm"] = b"P5\n%d %d\n1000\n" % (w, h) + (
        g16.astype(int) * 1000 // 65535).astype(">u2").tobytes()
    files["ppm_p3_comments.ppm"] = _pnm_ascii(b"P3", rgb, 255)
    files["ppm_p6.ppm"] = cv2.imencode(".ppm", bgr)[1].tobytes()
    files["ppm_p6_16.ppm"] = cv2.imencode(".ppm", rng.randint(0, 65536, (h, w, 3)).astype(
        np.uint16))[1].tobytes()

    def pam(depth, maxval, tupl, body):
        return (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\nTUPLTYPE %s\nENDHDR\n"
                % (w, h, depth, maxval, tupl) + body)

    files["pam_bw.pam"] = pam(1, 1, b"BLACKANDWHITE", rng.randint(0, 256, (h, w)).astype(
        np.uint8).tobytes())
    files["pam_grey.pam"] = pam(1, 255, b"GRAYSCALE", grey.tobytes())
    files["pam_rgb.pam"] = pam(3, 255, b"RGB", rgb.tobytes())
    files["pam_rgba.pam"] = pam(4, 255, b"RGB_ALPHA", np.dstack([rgb, grey]).tobytes())
    fl = (rgb.astype(np.float32) / 40.0) ** 2  # 0 to 40: 8-bit reads saturate
    files["pfm_rgb_le.pfm"] = b"PF\n%d %d\n-1.0\n" % (w, h) + fl[::-1].astype("<f4").tobytes()
    files["pfm_grey_be_half.pfm"] = b"Pf\n%d %d\n0.5\n" % (w, h) + fl[::-1, :, 1].astype(
        ">f4").tobytes()
    # Sun raster
    files["ras_cv2_24.ras"] = cv2.imencode(".ras", bgr)[1].tobytes()
    files["ras_cv2_8.ras"] = cv2.imencode(".ras", grey)[1].tobytes()
    files["ras_24.ras"] = write_sun(bgr)
    rows32 = np.zeros((h, w, 4), np.uint8)  # X, B, G, R
    rows32[:, :, 1:] = bgr
    files["ras_32.ras"] = struct.pack(">8I", 0x59A66A95, w, h, 32, rows32.size, 1, 0, 0) \
        + rows32.tobytes()
    cmap = rng.randint(0, 256, (3, 100)).astype(np.uint8)  # R, G, B planes; indices past 100
    rows8 = np.zeros((h, w + 1), np.uint8)
    rows8[:, :w] = idx8
    files["ras_8_map.ras"] = struct.pack(">8I", 0x59A66A95, w, h, 8, rows8.size, 1, 1, 300) \
        + cmap.tobytes() + rows8.tobytes()
    files["ras_8_old.ras"] = struct.pack(">8I", 0x59A66A95, w, h, 8, 0, 0, 0, 0) + rows8.tobytes()
    rows1 = np.zeros((h, (w + 15) // 16 * 2), np.uint8)
    packed = np.packbits(bits, axis=1)
    rows1[:, :packed.shape[1]] = packed
    files["ras_1_map.ras"] = struct.pack(">8I", 0x59A66A95, w, h, 1, rows1.size, 1, 1, 6) \
        + bytes((250, 10, 128, 40, 60, 220)) + rows1.tobytes()
    # Radiance HDR
    hdr = rgb.astype(np.float32)[:, :, ::-1] / 64.0
    files["hdr_cv2_rle.hdr"] = cv2.imencode(".hdr", hdr)[1].tobytes()
    files["hdr_writer_rle.hdr"] = write_hdr(hdr)
    files["hdr_narrow.hdr"] = cv2.imencode(".hdr", hdr[:, :7])[1].tobytes()  # under 8: flat
    files["hdr_flat_rgbe.hdr"] = (b"#?RGBE\n# flat pixels\nFORMAT=32-bit_rle_rgbe\n\n"
                                  b"-Y %d +X %d\n" % (h, w)
                                  + rng.randint(100, 140, (h, w, 4)).astype(np.uint8).tobytes())
    # TIFF
    files["tif_cv2_lzw_pred.tif"] = cv2.imencode(".tiff", bgr)[1].tobytes()
    files["tif_rgb_none.tif"] = write_tiff(rgb, 2, rows_per_strip=5)
    files["tif_rgb_packbits_be.tif"] = write_tiff(rgb, 2, order=">", compression=32773,
                                                  rows_per_strip=8)
    files["tif_rgb_deflate_pred.tif"] = write_tiff(rgb, 2, compression=8, predictor=2,
                                                   rows_per_strip=7)
    files["tif_bigtiff_lzw.tif"] = write_tiff(rgb, 2, big=True, compression=5, rows_per_strip=6)
    files["tif_tiled_deflate.tif"] = write_tiff(rgb, 2, compression=8, tile=(16, 16))
    files["tif_planar_lzw.tif"] = write_tiff(rgb, 2, planar=2, compression=5, rows_per_strip=9)
    files["tif_grey16_be_pred.tif"] = write_tiff(g16, 1, bps=16, order=">", compression=8,
                                                 predictor=2)
    files["tif_rgb16_lzw.tif"] = write_tiff(rng.randint(0, 65536, (h, w, 3)).astype(np.uint16),
                                            2, bps=16, compression=5, rows_per_strip=4)
    files["tif_white1_packbits.tif"] = write_tiff(bits, 0, bps=1, compression=32773)
    files["tif_pal8.tif"] = write_tiff(idx8, 3, colormap=rng.randint(0, 65536, (256, 3)))
    files["tif_pal1.tif"] = write_tiff(bits, 3, bps=1, colormap=[(60000, 200, 9000),
                                                                 (300, 50000, 40000)])
    rgba = np.dstack([rgb, grey]).astype(np.uint8)
    files["tif_rgba_unassoc.tif"] = write_tiff(rgba, 2, extra=[2], compression=8)
    files["tif_rgba_assoc.tif"] = write_tiff(rgba, 2, extra=[1])
    files["tif_orient6.tif"] = write_tiff(rgb, 2, orientation=6, compression=5)
    for mode, comp in (("RGB", "jpeg"), ("L", "jpeg"), ("YCbCr", "jpeg")):
        buf = io.BytesIO()
        Image.fromarray(rgb).convert(mode).save(buf, "TIFF", compression=comp)
        files[f"tif_pil_{mode.lower()}_{comp}.tif"] = buf.getvalue()
    return files


def format_fixtures(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    files = format_files()
    expected = {}
    for name, data in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        stem = name.rsplit(".", 1)[0]
        entry = {}
        for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED):
            if (stem, flags) in UNDEFINED:
                entry[str(flags)] = "raises: " + UNDEFINED[stem, flags]
                continue
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
            entry[str(flags)] = digest(want)
            if flags == cv2.IMREAD_COLOR:
                imageio.imwrite(os.path.join(out, stem + "_cv2.png"), want)
        expected[name] = entry
    # the stacked pair as PIL's JPEG-compressed TIFF (served by chip_smoke.py phase 17)
    pair = cv2.imread(os.path.join(HERE, "jpeg", "pair_512x832.png"))
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(pair[:, :, ::-1])).save(buf, "TIFF", compression="jpeg")
    with open(os.path.join(out, "pair_512x832_jpeg.tif"), "wb") as f:
        f.write(buf.getvalue())
    expected["pair_512x832_jpeg.tif"] = {
        str(k): digest(cv2.imdecode(np.frombuffer(buf.getvalue(), np.uint8), k))
        for k in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)}
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


# ---------------------------------------------------------------------------
# WebP: writers of the files cv2 and PIL do not write, and the fixtures
# ---------------------------------------------------------------------------


def webp_chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk: tag, little-endian size, payload padded to even."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def webp_riff(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def vp8x_chunk(w: int, h: int, flags: int) -> bytes:
    """VP8X: the flags (0x10 alpha, 0x08 Exif, 0x02 animation) and the canvas."""
    return webp_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little"))


def alpha_filtered(alpha: np.ndarray, method: int) -> bytes:
    """An alpha plane's deltas under ALPH filter ``method`` (0 none, 1
    horizontal, 2 vertical, 3 gradient): each sample less its prediction,
    the first row predicted from the left (0 before it), the first column
    from above."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    elif method == 3:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    else:
        pred[:] = 0
    return ((a - pred) & 0xFF).astype(np.uint8).tobytes()


def webp_with_raw_alpha(lossy: bytes, alpha: np.ndarray, method: int, levels: int = 0) -> bytes:
    """An extended file: VP8X (alpha), ALPH stored raw (compression 0) with
    filter ``method`` and the level-reduction bit ``levels``, then the VP8
    chunk of the simple lossy file ``lossy``."""
    h, w = alpha.shape
    header = bytes([(levels << 4) | (method << 2)])
    return webp_riff(vp8x_chunk(w, h, 0x10) + webp_chunk(b"ALPH", header
                                                          + alpha_filtered(alpha, method))
                     + lossy[12:])


def webp_animation(canvas, frames, flags: int = 0x02) -> bytes:
    """An animation: ``frames`` of (x, y, w, h, simple file), each frame's
    image chunk taken from the simple file, x and y even."""
    body = vp8x_chunk(*canvas, flags) + webp_chunk(b"ANIM", bytes(4) + struct.pack("<H", 0))
    for x, y, w, h, f in frames:
        head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100))
        body += webp_chunk(b"ANMF", head + b"\0" + f[12:])
    return webp_riff(body)


def _webp_tables() -> dict:
    """The VP8 probability tables of ``csrc/webp.c`` (read from its source)."""
    import re

    with open(os.path.join(REPO, "unopticalflow_tpu_torch", "csrc", "webp.c")) as f:
        src = f.read()
    return {name: [int(v) for v in re.search(name + r"\[\d+\] = \{(.*?)\};", src, re.S)
                   .group(1).replace("\n", " ").split(",") if v.strip()]
            for name in ("kCoeffsUpdateProba", "kBModesProba")}


class BoolDecoder:
    """RFC 6386's boolean decoder, logging each (probability, bit)."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.count = data, 2, 0
        self.value = int.from_bytes(data[:2].ljust(2, b"\0"), "big")
        self.range, self.log = 255, []

    def bit(self, prob: int = 128) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            self.range -= split
            self.value -= split << 8
            b = 1
        else:
            self.range = split
            b = 0
        while self.range < 128:
            self.value, self.range, self.count = self.value << 1, self.range << 1, self.count + 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
        self.log.append((prob, b))
        return b

    def value_of(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def signed(self, n: int) -> int:
        v = self.value_of(n)
        return -v if self.bit() else v


class BoolEncoder:
    """RFC 6386's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def bit(self, b: int, prob: int = 128) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if b:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):  # carry into the bytes written
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if self.bit_count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value_of(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.bit((v >> k) & 1)

    def signed(self, v: int, n: int) -> None:
        self.value_of(abs(v), n)
        self.bit(int(v < 0))

    def flush(self) -> bytes:
        for _ in range(32):
            self.bit(0)
        return bytes(self.out)


def vp8_with_headers(simple_file: bytes, **fields) -> bytes:
    """A simple lossy file with its frame's segment and filter headers
    rewritten (``simple``, ``level``, ``sharpness``, ``ref_delta``,
    ``mode_delta``: the loop filter; ``relative``: segment quantisers and
    filter strengths (``strengths``) given relative to the frame's): the
    first partition is decoded, its header fields replaced and every other
    decision written back with its own probability (the token partitions,
    untouched, stay valid).  No writer on hand sets these fields."""
    tables = _webp_tables()
    payload = simple_file[20:]
    tag = int.from_bytes(payload[:3], "little")
    w = int.from_bytes(payload[6:8], "little") & 0x3FFF
    h = int.from_bytes(payload[8:10], "little") & 0x3FFF
    part0 = payload[10:10 + (tag >> 5)]
    br = BoolDecoder(part0)
    br.value_of(2)
    head_end = len(br.log)
    seg = {"use": br.bit(), "map": 0, "update": 0, "absolute": 1, "quant": [0] * 4,
           "filter": [0] * 4, "probs": [255] * 3}
    if seg["use"]:
        seg["map"] = br.bit()
        seg["update"] = br.bit()
        if seg["update"]:
            seg["absolute"] = br.bit()
            seg["quant"] = [br.signed(7) if br.bit() else 0 for _ in range(4)]
            seg["filter"] = [br.signed(6) if br.bit() else 0 for _ in range(4)]
        if seg["map"]:
            seg["probs"] = [br.value_of(8) if br.bit() else 255 for _ in range(3)]
    flt = {"simple": br.bit(), "level": br.value_of(6), "sharpness": br.value_of(3)}
    if br.bit() and br.bit():
        raise ValueError("loop filter deltas already present")
    tail_start = len(br.log)
    br.value_of(2)  # token partitions
    base_q = br.value_of(7)
    for _ in range(5):
        if br.bit():
            br.signed(4)
    br.bit()  # refresh
    for prob in tables["kCoeffsUpdateProba"]:
        if br.bit(prob):
            br.value_of(8)
    skip_proba = br.bit()
    skip_p = br.value_of(8) if skip_proba else 0
    modes = tables["kBModesProba"]
    top = [0] * (4 * ((w + 15) // 16))
    for _ in range((h + 15) // 16):
        left = [0] * 4
        for mb_x in range((w + 15) // 16):
            if seg["map"]:
                if not br.bit(seg["probs"][0]):
                    br.bit(seg["probs"][1])
                else:
                    br.bit(seg["probs"][2])
            if skip_proba:
                br.bit(skip_p)
            t = top[4 * mb_x:4 * mb_x + 4]
            if br.bit(145):  # 16x16
                ymode = (1 if br.bit(128) else 3) if br.bit(156) else (2 if br.bit(163) else 0)
                t, left = [ymode] * 4, [ymode] * 4
            else:
                for y in range(4):
                    ymode = left[y]
                    for x in range(4):
                        prob = modes[(t[x] * 10 + ymode) * 9:][:9]
                        # the tree of B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU
                        if not br.bit(prob[0]):
                            ymode = 0
                        elif not br.bit(prob[1]):
                            ymode = 1
                        elif not br.bit(prob[2]):
                            ymode = 2
                        elif not br.bit(prob[3]):
                            ymode = 3 if not br.bit(prob[4]) else (4 if not br.bit(prob[5]) else 5)
                        elif not br.bit(prob[6]):
                            ymode = 6
                        elif not br.bit(prob[7]):
                            ymode = 7
                        else:
                            ymode = 8 if not br.bit(prob[8]) else 9
                        t[x] = ymode
                    left[y] = ymode
            top[4 * mb_x:4 * mb_x + 4] = t
            if br.bit(142) and br.bit(114):
                br.bit(183)
    enc = BoolEncoder()
    for prob, b in br.log[:head_end]:
        enc.bit(b, prob)
    relative = fields.get("relative", False)
    level = fields.get("level", flt["level"])
    enc.bit(seg["use"])
    if seg["use"]:
        enc.bit(seg["map"])
        enc.bit(1)
        enc.bit(0 if relative else 1)
        quant = [q - base_q for q in seg["quant"]] if relative else seg["quant"]
        strengths = fields.get("strengths", seg["filter"])
        for v, n in [(q, 7) for q in quant] + [(f, 6) for f in strengths]:
            enc.bit(int(v != 0))
            if v:
                enc.signed(v, n)
        if seg["map"]:
            for prob in seg["probs"]:
                enc.bit(int(prob != 255))
                if prob != 255:
                    enc.value_of(prob, 8)
    enc.bit(fields.get("simple", flt["simple"]))
    enc.value_of(level, 6)
    enc.value_of(fields.get("sharpness", flt["sharpness"]), 3)
    ref, mode = fields.get("ref_delta"), fields.get("mode_delta")
    enc.bit(int(ref is not None or mode is not None))
    if ref is not None or mode is not None:
        enc.bit(1)
        for v in (ref, 0, 0, 0, mode, 0, 0, 0):
            enc.bit(int(bool(v)))
            if v:
                enc.signed(v, 6)
    for prob, b in br.log[tail_start:]:
        enc.bit(b, prob)
    new0 = enc.flush()
    frame = ((tag & 0x1F) | (len(new0) << 5)).to_bytes(3, "little") + payload[3:10] + new0 \
        + payload[10 + (tag >> 5):]
    return webp_riff(webp_chunk(b"VP8 ", frame))


def webp_files() -> dict:
    """{name: file bytes} of the WebP fixtures."""
    rng = np.random.RandomState(SEED + 21)
    h, w = 37, 53
    bgr = smooth(rng, h, w, blur=2)
    bgr[::5, ::3] = rng.randint(0, 256, bgr[::5, ::3].shape)
    rgb = np.ascontiguousarray(bgr[:, :, ::-1])
    alpha = smooth(rng, h, w, ch=1, blur=3)[:, :, 0]
    rgba = np.dstack([rgb, alpha])

    def cv2_webp(img, quality=None):
        params = [] if quality is None else [cv2.IMWRITE_WEBP_QUALITY, quality]
        return cv2.imencode(".webp", img, params)[1].tobytes()

    def pil_webp(img, mode, **kw):
        buf = io.BytesIO()
        Image.fromarray(img, mode).save(buf, "WEBP", **kw)
        return buf.getvalue()

    files = {f"vp8_q{q}.webp": cv2_webp(bgr, q) for q in (1, 50, 95, 100)}
    for hh, ww in ((1, 1), (17, 33)):
        files[f"vp8_{hh}x{ww}.webp"] = cv2_webp(smooth(rng, hh, ww, blur=1), 80)
    # flat and textured regions: libwebp gives them different segments
    seg = smooth(rng, 96, 128, blur=6)
    seg[:, 64:] = rng.randint(0, 256, (96, 64, 3))
    files["vp8_segments_96x128.webp"] = cv2_webp(seg, 40)
    files["vp8l_colour.webp"] = cv2_webp(bgr, 101)
    files["vp8l_grey.webp"] = cv2_webp(np.ascontiguousarray(bgr[:, :, 1]), 101)
    for n in (2, 4, 16, 200):  # colour indexing: 8, 4, 2 and 1 pixels a byte
        pal = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        files[f"vp8l_palette{n}.webp"] = cv2_webp(pal[rng.randint(0, n, (h, w))], 101)
    files["vp8l_noisy.webp"] = cv2_webp(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), 101)
    files["vp8l_smooth.webp"] = cv2_webp(smooth(rng, 64, 96, blur=8), 101)
    files["vp8l_bgra.webp"] = cv2_webp(np.ascontiguousarray(rgba[:, :, [2, 1, 0, 3]]))
    for name, kw in (("alpha_aq100", {"quality": 80, "alpha_quality": 100}),
                     ("alpha_aq50", {"quality": 80, "alpha_quality": 50}),
                     ("alpha_m0", {"quality": 60, "method": 0}),
                     ("alpha_m6", {"quality": 90, "method": 6})):
        files[f"pil_{name}.webp"] = pil_webp(rgba, "RGBA", **kw)
    files["pil_lossless_exact.webp"] = pil_webp(rgba, "RGBA", lossless=True, exact=True)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "WEBP", save_all=True, duration=100, quality=70,
                              append_images=[Image.fromarray(np.ascontiguousarray(rgb[::-1]))])
    files["pil_animation.webp"] = buf.getvalue()
    small = smooth(rng, 17, 21, blur=2)
    files["animation_offset_frame.webp"] = webp_animation(
        (w, h), [(4, 6, 21, 17, cv2_webp(small, 101)), (0, 0, w, h, cv2_webp(bgr, 80))],
        flags=0x12)
    lossy = cv2_webp(bgr, 75)
    # loop filter and segment fields no writer on hand sets (vp8_with_headers)
    seg_lossy = files["vp8_segments_96x128.webp"]
    for name, fields in (("simple_l20", {"simple": 1, "level": 20}),
                         ("simple_l40_sharp6", {"simple": 1, "level": 40, "sharpness": 6}),
                         ("normal_l30_sharp3", {"level": 30, "sharpness": 3}),
                         ("lf_deltas", {"level": 24, "ref_delta": 9, "mode_delta": -14}),
                         ("relative_segments", {"relative": True, "strengths": [-9, 3, 0, 20]})):
        files[f"vp8_{name}.webp"] = vp8_with_headers(seg_lossy, **fields)
    for m in range(4):
        files[f"alph_raw_filter{m}.webp"] = webp_with_raw_alpha(lossy, alpha, m)
    files["alph_raw_levels.webp"] = webp_with_raw_alpha(lossy, alpha & 0xF0, 3, levels=1)
    exif = Image.Exif()
    exif[0x0112] = 6
    files["pil_exif_orient6.webp"] = pil_webp(rgb, "RGB", quality=85, exif=exif.tobytes())
    from PIL import ImageCms

    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    files["pil_iccp_lossless.webp"] = pil_webp(rgb, "RGB", lossless=True, icc_profile=icc)
    # bodies cv2 refuses (imdecode gives None)
    files["bad_vp8_truncated.webp"] = lossy[:len(lossy) // 2]
    files["bad_vp8l_truncated.webp"] = files["vp8l_colour.webp"][:-40]
    riff_long = bytearray(lossy)
    riff_long[4:8] = struct.pack("<I", len(lossy))
    files["bad_riff_size.webp"] = bytes(riff_long)
    code = bytearray(lossy)
    code[20 + 3] ^= 0xFF
    files["bad_vp8_start_code.webp"] = bytes(code)
    alph = bytearray(files["alph_raw_filter1.webp"])
    alph[alph.index(b"ALPH") + 8] |= 0xC0  # reserved bits
    files["bad_alph_header.webp"] = bytes(alph)
    # the served 512x832 stacked pair (chip_smoke.py phase 17)
    pair = cv2.imread(os.path.join(HERE, "jpeg", "pair_512x832.png"))
    yy, xx = np.mgrid[0:512, 0:832]
    pair_alpha = ((xx // 8 + yy // 8) % 2 * 96 + 100 + xx * 59 // 832).astype(np.uint8)
    files["pair_512x832_lossy.webp"] = cv2_webp(pair, 90)
    files["pair_512x832_lossless.webp"] = cv2_webp(pair, 101)
    files["pair_512x832_alpha.webp"] = pil_webp(
        np.dstack([np.ascontiguousarray(pair[:, :, ::-1]), pair_alpha]), "RGBA", quality=90,
        alpha_quality=100)
    # the demo's two frames (chip_smoke.py phase 17 (c)), from the JPEG frames' pixels
    for k in ("a", "b"):
        files[f"frame_{k}.webp"] = cv2_webp(cv2.imread(os.path.join(HERE, "jpeg",
                                                                    f"frame_{k}.jpg")), 85)
    return files


def webp_fixtures(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    expected = {}
    for name, data in webp_files().items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        entry = {}
        for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED):
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
            entry[str(flags)] = "none" if want is None else digest(want)
        expected[name] = entry
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


# ---------------------------------------------------------------------------
# JPEG 2000: OpenJPEG's encoder (the libopenjp2 PIL ships), JP2 boxes, and
# codestreams whose packet headers move to PPM / PPT markers
# ---------------------------------------------------------------------------

_OPJ = None
_PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
_SPACE = {"unspecified": 0, "srgb": 1, "gray": 2, "sycc": 3}


def _openjp2():
    """The OpenJPEG 2.5 library PIL is built with, through ctypes: its
    encoder takes options (code-block styles, SOP/EPH, POC, ROI, tile-parts,
    PLT/TLM) that PIL's ``save`` does not pass on."""
    global _OPJ
    if _OPJ is None:
        import ctypes
        import glob

        import PIL

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libopenjp2*"))[0])
        p = ctypes.c_void_p
        for name, args, res in (
                ("opj_image_create", [ctypes.c_uint32, p, ctypes.c_int], p),
                ("opj_create_compress", [ctypes.c_int], p),
                ("opj_stream_create_default_file_stream", [ctypes.c_char_p, ctypes.c_int], p),
                ("opj_set_default_encoder_parameters", [p], None),
                ("opj_setup_encoder", [p, p, p], ctypes.c_int),
                ("opj_encoder_set_extra_options", [p, p], ctypes.c_int),
                ("opj_start_compress", [p, p, p], ctypes.c_int),
                ("opj_encode", [p, p], ctypes.c_int),
                ("opj_end_compress", [p, p], ctypes.c_int),
                ("opj_destroy_codec", [p], None), ("opj_stream_destroy", [p], None),
                ("opj_image_destroy", [p], None)):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = res
        _OPJ = lib
    return _OPJ


def opj_encode(planes, prec=8, jp2=True, space="srgb", irreversible=False, mct=None, numres=6,
               cblk=(64, 64), precincts=None, prog="LRCP", layers=None, tile=None,
               tile_offset=(0, 0), sop=False, eph=False, mode=0, roi=None, pocs=(), tp=None,
               extra=()) -> bytes:
    """A JPEG 2000 file (JP2, or a bare codestream) of ``planes`` (2-D int
    arrays of one size) from OpenJPEG's encoder: ``layers`` compression
    ratios (0 is lossless), code-blocks of ``cblk`` samples and style
    ``mode`` (1 BYPASS, 2 RESET, 4 TERMALL, 8 VSC, 16 PTERM, 32 SEGSYM),
    ``precincts`` (w, h) from the highest resolution down, a progression,
    ``tile`` (w, h) at ``tile_offset``, SOP / EPH markers, ``roi`` (component,
    shift), ``pocs`` (rs, cs, le, re, ce, order), tile-parts split by ``tp``
    ("R", "L" or "C") and ``extra`` options ("PLT=YES", "TLM=YES").  The
    offsets into ``opj_cparameters_t`` are OpenJPEG 2.5's (x86-64)."""
    import ctypes

    lib = _openjp2()
    n = len(planes)
    h, w = planes[0].shape
    cm = (ctypes.c_uint32 * (9 * n))()
    for k in range(n):
        cm[9 * k:9 * k + 9] = [1, 1, w, h, 0, 0, prec, prec, 0]
    img = lib.opj_image_create(n, cm, _SPACE[space])
    ctypes.memmove(img, struct.pack("<IIII", 0, 0, w, h), 16)
    comps = struct.unpack("<Q", ctypes.string_at(img + 24, 8))[0]
    for k, plane in enumerate(planes):
        dp = struct.unpack("<Q", ctypes.string_at(comps + 64 * k + 48, 8))[0]
        a = np.ascontiguousarray(plane, np.int32)
        ctypes.memmove(dp, a.ctypes.data, a.nbytes)
    par = ctypes.create_string_buffer(65536)
    lib.opj_set_default_encoder_parameters(par)

    def put(fmt, off, *v):
        struct.pack_into(fmt, par, off, *v)

    if tile:
        put("<iiiii", 0, 1, tile_offset[0], tile_offset[1], tile[0], tile[1])
    layers = layers or [0]
    put("<i", 20, 1)  # cp_disto_alloc: layers by compression ratio
    put("<i", 4796, len(layers))
    put(f"<{len(layers)}f", 4800, *layers)
    put("<ii", 48, (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0), _PROG[prog])
    put("<iiiii", 5600, numres, cblk[0], cblk[1], mode, int(irreversible))
    if roi:
        put("<ii", 5620, *roi)
    if precincts:
        put("<i", 5628, len(precincts))
        for k, (pw, ph) in enumerate(precincts):
            put("<i", 5632 + 4 * k, pw)
            put("<i", 5764 + 4 * k, ph)
    for k, (rs, cs, le, re_, ce, order) in enumerate(pocs):
        base = 56 + 148 * k  # opj_poc_t
        put("<IIIII", base, rs, cs, le, re_, ce)
        put("<ii", base + 32, _PROG[order], _PROG[order])
        par[base + 40:base + 44] = order.encode()
        put("<I", base + 48, 1)  # the (1-based) tile it applies to
    if pocs:
        put("<I", 4792, len(pocs))
    par[18698] = (1 if n >= 3 else 0) if mct is None else mct
    if tp:
        par[18696] = 1
        par[18697] = ord(tp)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    if extra:
        opts = (ctypes.c_char_p * (len(extra) + 1))(*[e.encode() for e in extra], None)
        lib.opj_encoder_set_extra_options(codec, opts)
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    try:
        if not lib.opj_setup_encoder(codec, par, img):
            raise RuntimeError("opj_setup_encoder refused the parameters")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (lib.opj_start_compress(codec, img, stream) and lib.opj_encode(codec, stream)
              and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        if not ok:
            raise RuntimeError("OpenJPEG failed to encode")
        with open(path, "rb") as f:
            return f.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        os.unlink(path)


def jp2_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_wrap(cs: bytes, colr: bytes = None, extra: bytes = b"") -> bytes:
    """A JP2 file around a codestream: signature, ftyp, jp2h (ihdr from SIZ,
    ``colr`` (default: enumerated sRGB), ``extra`` boxes), jp2c."""
    x1, y1, x0, y0 = struct.unpack(">IIII", cs[8:24])
    nc = struct.unpack(">H", cs[40:42])[0]
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", y1 - y0, x1 - x0, nc, cs[42], 7, 0, 0))
    colr = b"\1\0\0" + struct.pack(">I", 16) if colr is None else colr
    return (jp2_box(b"jP  ", b"\r\n\x87\n") + jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + jp2_box(b"jp2h", ihdr + jp2_box(b"colr", colr) + extra) + jp2_box(b"jp2c", cs))


def enumcs(code: int) -> bytes:
    return b"\1\0\0" + struct.pack(">I", code)


def pclr_box(entries: np.ndarray, bits) -> bytes:
    body = struct.pack(">HB", *entries.shape) + bytes(bits)
    for row in entries:
        for v, b in zip(row, bits):
            body += int(v).to_bytes(((b & 0x7F) + 8) // 8, "big")
    return jp2_box(b"pclr", body)


def cmap_box(maps) -> bytes:
    return jp2_box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in maps))


def cdef_box(defs) -> bytes:
    return jp2_box(b"cdef", struct.pack(">H", len(defs))
                   + b"".join(struct.pack(">HHH", *d) for d in defs))


def packed_headers(cs: bytes, where: str) -> bytes:
    """A codestream of one tile-part a tile (no SOP markers) rewritten with
    its packet headers in PPM (``where`` "ppm") or PPT ("ppt") markers and
    only the packet bodies after each SOD: the headers split from the bodies
    where the port's decoder finds them."""
    from unopticalflow_tpu_torch.utils import jpeg2000

    packets = []
    jpeg2000._decode_components(cs, packets=packets)
    _, _, _, pos = jpeg2000._main_header(cs)
    main, parts, headers = cs[:pos], [], []
    for bounds in packets:
        body, tpsot = jpeg2000._segment(cs, pos)[1], cs[pos:pos + 12]
        psot = struct.unpack(">I", tpsot[6:10])[0]
        end = pos + psot if psot else len(cs) - 2
        sod = cs.index(b"\xff\x93", body)
        data = cs[sod + 2:end]
        headers.append(b"".join(data[s:b] for s, b, _ in bounds))
        tail = cs[body:sod]
        if where == "ppt":
            tail += b"\xff\x61" + struct.pack(">HB", 3 + len(headers[-1]), 0) + headers[-1]
        bodies = b"".join(data[b:e] for _, b, e in bounds)
        part = tail + b"\xff\x93" + bodies
        parts.append(tpsot[:6] + struct.pack(">I", 12 + len(part)) + tpsot[10:] + part)
        pos = end
    if where == "ppm":
        ppm = b"\0" + b"".join(struct.pack(">I", len(h)) + h for h in headers)
        main += b"\xff\x60" + struct.pack(">H", 2 + len(ppm)) + ppm
    return main + b"".join(parts) + b"\xff\xd9"


def jpeg2000_files() -> dict:
    rng = np.random.RandomState(SEED + 5)
    rgb = smooth(rng, 37, 53, blur=2).astype(np.int32)
    planes = [rgb[:, :, k] for k in range(3)]
    grey = [rgb[:, :, 1]]
    files = {}

    def pil(arr, mode, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "JPEG2000", **kw)
        return buf.getvalue()

    u8 = rgb.astype(np.uint8)
    rgba = np.dstack([u8, (np.arange(53)[None, :] * 4 + np.arange(37)[:, None]).astype(np.uint8)])
    files["pil_rgb.jp2"] = pil(u8, "RGB")
    files["pil_rgb_irreversible.jp2"] = pil(u8, "RGB", irreversible=True)
    files["pil_rgb.j2k"] = pil(u8, "RGB", no_jp2=True)
    files["pil_rgb_irreversible.j2k"] = pil(u8, "RGB", irreversible=True, no_jp2=True)
    files["pil_grey.jp2"] = pil(u8[:, :, 1], "L")
    files["pil_grey16.jp2"] = pil((rgb[:, :, 1] * 257 + rgb[:, :, 0]).astype(np.uint16), "I;16")
    files["pil_rgba.jp2"] = pil(rgba, "RGBA")
    files["pil_la.jp2"] = pil(rgba[:, :, 2:], "LA")
    files["pil_mct0.jp2"] = pil(u8, "RGB", mct=0)
    files["pil_layers.jp2"] = pil(u8, "RGB", quality_mode="rates", quality_layers=[40, 20, 10])
    files["pil_layers_irreversible.j2k"] = pil(u8, "RGB", irreversible=True, no_jp2=True,
                                               quality_mode="rates", quality_layers=[30, 8])
    files["pil_tiles.j2k"] = pil(u8, "RGB", no_jp2=True, tile_size=(16, 24))
    # an image offset (its tiles offset too), which cv2 refuses
    files["bad_image_offset.j2k"] = pil(u8, "RGB", no_jp2=True, tile_size=(16, 24),
                                        offset=(5, 3), tile_offset=(2, 1))
    files["pil_plt.jp2"] = pil(u8, "RGB", plt=True, comment="a comment")
    big = smooth(rng, 130, 140, blur=3)
    for nr in (1, 2, 8):
        files[f"pil_res{nr}.j2k"] = pil(big if nr == 8 else u8, "RGB", num_resolutions=nr,
                                        irreversible=nr == 8, no_jp2=True,
                                        quality_mode="rates", quality_layers=[12 if nr == 8 else 0])
    for order in _PROG:
        files[f"opj_{order.lower()}.j2k"] = opj_encode(
            planes, jp2=False, numres=4, cblk=(16, 8), prog=order, layers=[30, 10, 0],
            precincts=[(32, 32), (16, 16), (16, 8), (8, 8)], tile=(32, 24))
    for name, mode in (("bypass", 1), ("reset", 2), ("termall", 4), ("vsc", 8), ("pterm", 16),
                       ("segsym", 32), ("all", 63)):
        for irr in (False, True):
            files[f"opj_cblk_{name}{'_97' if irr else ''}.j2k"] = opj_encode(
                planes, jp2=False, numres=3, cblk=(16, 16), mode=mode, irreversible=irr,
                layers=[20, 5, 0] if not irr else [20, 5])
    files["opj_sop_eph.j2k"] = opj_encode(planes, jp2=False, numres=3, sop=True, eph=True,
                                          layers=[20, 0])
    files["opj_poc.j2k"] = opj_encode(planes, jp2=False, numres=4, layers=[30, 10, 0],
                                      pocs=[(0, 0, 2, 2, 3, "LRCP"), (0, 0, 3, 4, 3, "RPCL")])
    for tp in ("R", "L", "C"):
        files[f"opj_tileparts_{tp}.j2k"] = opj_encode(planes, jp2=False, numres=3,
                                                      layers=[20, 0], tile=(32, 32), tp=tp)
    files["opj_roi.j2k"] = opj_encode(planes, jp2=False, numres=3, roi=(1, 4), layers=[15])
    files["opj_plt_tlm.j2k"] = opj_encode(planes, jp2=False, numres=3, tile=(24, 24),
                                          extra=("PLT=YES", "TLM=YES"))
    files["opj_cblk4x64.j2k"] = opj_encode(planes, jp2=False, numres=2, cblk=(4, 64))
    files["opj_cblk64x4.j2k"] = opj_encode(planes, jp2=False, numres=2, cblk=(64, 4),
                                           irreversible=True, layers=[6])
    files["opj_prec_cprl_97.j2k"] = opj_encode(
        planes, jp2=False, numres=5, cblk=(8, 8), prog="CPRL", irreversible=True,
        precincts=[(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)], layers=[25, 6])
    for prec in (10, 12, 16):
        scaled = [p.astype(np.int64) * ((1 << prec) - 1) // 255 for p in planes]
        files[f"opj_rgb{prec}.jp2"] = opj_encode(scaled, prec=prec, numres=3)
        files[f"opj_grey{prec}_97.jp2"] = opj_encode(scaled[1:2], prec=prec, space="gray",
                                                     numres=3, irreversible=True, layers=[4])
    files["opj_sycc.jp2"] = opj_encode(planes, space="sycc", mct=0, numres=3)
    files["opj_sycc12_97.jp2"] = opj_encode([p * 16 for p in planes], prec=12, space="sycc",
                                            mct=0, numres=3, irreversible=True)
    # colour boxes around one codestream each
    cs3 = opj_encode(planes, jp2=False, numres=3)
    files["jp2_grey_colr_3comp.jp2"] = jp2_wrap(cs3, enumcs(17))
    files["jp2_unknown_enumcs.jp2"] = jp2_wrap(cs3, enumcs(99))
    files["jp2_icc_colr.jp2"] = jp2_wrap(cs3, b"\2\0\0" + bytes(132))
    files["jp2_cmyk_colr.jp2"] = jp2_wrap(cs3, enumcs(12))  # cv2 converts no CMYK
    files["jp2_cdef_swap.jp2"] = jp2_wrap(cs3, extra=cdef_box([(0, 0, 3), (1, 0, 2), (2, 0, 1)]))
    idx = rng.randint(0, 40, (37, 53))
    cs1 = opj_encode([idx], jp2=False, space="gray", numres=3)
    pal = rng.randint(0, 256, (40, 3))
    files["jp2_palette.jp2"] = jp2_wrap(cs1, extra=pclr_box(pal, [7, 7, 7])
                                        + cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)]))
    files["jp2_palette_grey_colr.jp2"] = jp2_wrap(cs1, enumcs(17), pclr_box(pal, [7, 7, 7])
                                                  + cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)]))
    files["jp2_palette_without_cmap.jp2"] = jp2_wrap(cs1, extra=pclr_box(pal, [7, 7, 7]))
    # packet headers in PPM and PPT markers
    lay = opj_encode(planes, jp2=False, numres=3, layers=[20, 0], tile=(32, 24), eph=True)
    files["opj_ppm.j2k"] = packed_headers(lay, "ppm")
    files["opj_ppt.j2k"] = packed_headers(lay, "ppt")
    # bodies cv2 gives None for
    files["bad_truncated.j2k"] = files["pil_rgb.j2k"][:len(files["pil_rgb.j2k"]) * 2 // 3]
    files["bad_truncated.jp2"] = files["pil_rgb.jp2"][:-2]
    sop = bytearray(files["opj_sop_eph.j2k"])
    sop[sop.index(b"\xff\x92", sop.index(b"\xff\x93"))] = 0  # an EPH marker broken
    files["bad_eph.j2k"] = bytes(sop)
    signed = bytearray(cs3)
    signed[42] |= 0x80  # the first component's Ssiz: signed samples
    files["bad_signed.j2k"] = bytes(signed)
    no_qcd = bytearray(cs3)
    q = no_qcd.index(b"\xff\x5c")
    no_qcd[q + 1] = 0x6F  # QCD -> an unknown marker
    files["bad_no_qcd.j2k"] = bytes(no_qcd)
    files["bad_stub.jp2"] = b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40)
    files["bad_stub.j2k"] = b"\xff\x4f\xff\x51" + bytes(40)
    # the served 512x832 stacked pair (chip_smoke.py phase 17): lossless JP2
    # and irreversible J2K; the demo's frames as JP2
    pair = cv2.imread(os.path.join(HERE, "jpeg", "pair_512x832.png"))
    prgb = np.ascontiguousarray(pair[:, :, ::-1])
    files["pair_512x832_lossless.jp2"] = pil(prgb, "RGB")
    files["pair_512x832_irreversible.j2k"] = pil(prgb, "RGB", irreversible=True, no_jp2=True,
                                                 quality_mode="rates", quality_layers=[12])
    for k in ("a", "b"):
        frame = cv2.imread(os.path.join(HERE, "jpeg", f"frame_{k}.jpg"))
        files[f"frame_{k}.jp2"] = pil(np.ascontiguousarray(frame[:, :, ::-1]), "RGB",
                                      irreversible=True, quality_mode="rates",
                                      quality_layers=[10])
    return files


def jpeg2000_fixtures(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    expected = {}
    for name, data in jpeg2000_files().items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        entry = {}
        for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED):
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
            entry[str(flags)] = "none" if want is None else digest(want)
        expected[name] = entry
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


def grey_files() -> dict:
    """Colour PNGs read as grey through libpng's gamma tables (or not), and
    grey-and-alpha TIFF tiles: {name: (bytes, {flags: the port's expected
    raise, where it raises by design})}."""
    rng = np.random.RandomState(SEED + 6)
    files = {}

    def png_with(img, chunks):
        data = imageio.encode_png(img)
        return data[:33] + b"".join(imageio._chunk(k, b) for k, b in chunks) + data[33:]

    rgb = smooth(rng, 29, 43, blur=1)
    rgba = np.dstack([rgb, smooth(rng, 29, 43, 1, blur=1)])
    rgb16 = rng.randint(0, 65536, (29, 43, 3)).astype(np.uint16)
    rgb16[:4] = rgb16[:4, :, :1]
    gama = lambda g: [(b"gAMA", struct.pack(">I", g))]  # noqa: E731
    files["gamma_45455_rgb.png"] = png_with(rgb, gama(45455))
    files["gamma_50000_rgba.png"] = png_with(rgba, gama(50000))
    files["gamma_100000_rgb.png"] = png_with(rgb, gama(100000))
    files["gamma_45455_rgb16.png"] = png_with(rgb16, gama(45455))
    files["srgb_rgb.png"] = png_with(rgb, [(b"sRGB", b"\0")])
    files["chrm_rgb.png"] = png_with(rgb, [(b"cHRM", struct.pack(
        ">8I", 31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000))])
    pal = rng.randint(0, 256, (30, 3)).astype(np.uint8)
    rows = imageio._filter_rows(rng.randint(0, 30, (29, 43)).astype(np.uint8), 1)
    files["gamma_30000_palette.png"] = (
        imageio._PNG_MAGIC + imageio._chunk(b"IHDR", struct.pack(">IIBBBBB", 43, 29, 8, 3, 0, 0, 0))
        + imageio._chunk(b"gAMA", struct.pack(">I", 30000)) + imageio._chunk(b"PLTE", pal.tobytes())
        + imageio._chunk(b"IDAT", zlib.compress(rows.tobytes())) + imageio._chunk(b"IEND", b""))
    files = {k: (v, {}) for k, v in files.items()}
    for name, hw, tile, comp, extra in (("tiles_ga_clipped", (40, 24), (32, 32), 1, 2),
                                        ("tiles_ga_lzw", (17, 33), (32, 16), 5, 1),
                                        ("tiles_ga_deflate", (70, 50), (48, 48), 8, 0)):
        arr = rng.randint(0, 256, hw + (2,)).astype(np.uint8)
        files[name + ".tif"] = (write_tiff(arr, 1, tile=tile, compression=comp, extra=[extra]), {})
    arr = rng.randint(0, 256, (17, 33, 2)).astype(np.uint8)
    files["tiles_ga_mirrored.tif"] = (write_tiff(arr, 1, tile=(32, 16), extra=[2], orientation=3),
                                      {k: "mirrors the columns" for k in (1, 0, -1)})
    arr = rng.randint(0, 256, (9, 14, 3)).astype(np.uint8)
    files["predictor_uncompressed.tif"] = (write_tiff(arr, 2, predictor=2, rows_per_strip=4), {})
    return files


def grey_fixtures(out: str) -> None:
    """``grey/``: the files of ``grey_files`` and the SHA-256 of cv2's
    decode of each under each flag (or the port's raise)."""
    os.makedirs(out, exist_ok=True)
    expected = {}
    for name, (data, raises) in grey_files().items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        expected[name] = {str(k): ("raises: " + raises[k] if k in raises else
                                   digest(cv2.imdecode(np.frombuffer(data, np.uint8), k)))
                          for k in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)}
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


def png_fixtures(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(SEED + 2)
    h, w = 33, 65
    for ctype in (0, 2, 3, 4, 6):
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        extra = b""
        if ctype == 3:
            pal = rng.randint(0, 256, (37, 3)).astype(np.uint8)
            px = rng.randint(0, 37, (h, w, 1)).astype(np.uint8)
            extra = (imageio._chunk(b"PLTE", pal.tobytes())
                     + imageio._chunk(b"tRNS", rng.randint(0, 256, 20).astype(np.uint8).tobytes()))
        else:
            px = smooth(rng, h, w, ch, blur=2)
        data = _adam7(px, 8, ctype, extra)
        with open(os.path.join(out, f"adam7_ct{ctype}.png"), "wb") as f:
            f.write(data)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        imageio.imwrite(os.path.join(out, f"adam7_ct{ctype}_cv2.png"), want)


def png_depth_files() -> dict:
    """``png/``: every colour type and depth libpng reads besides Adam7's
    8-bit files (grey at 1, 2, 4 and 16 bits, palettes at 1, 2 and 4,
    grey-and-alpha and RGBA at 16, interlaced at 1 and 16 bits), ``tRNS``
    on RGB at 8 and 16 bits and on a 4-bit palette, ``eXIf`` orientations
    (before and after IDAT, of type LONG), a tRNS failing its CRC, and APNGs
    (chip_smoke's, PIL's with a default image, a 16-bit RGBA IDAT frame
    smaller than its canvas, an interlaced palette with tRNS, one whose
    next frame control is past the canvas and one cut after IDAT, which cv2
    gives None for, and a grey one, which the port refuses): {name: (bytes,
    the port's refusal or None)}."""
    from chip_smoke import write_apng
    from tests.test_torch_png_depths import _exif, apng, chunk, png, samples

    rng = np.random.RandomState(SEED + 25)
    h, w = 24, 32
    files = {}

    def plain(name, ctype, depth, interlace=0, pre=b"", post=b"", top=None):
        files[name] = (png(w, h, depth, ctype, samples(rng, h, w, ctype, depth, top), rng,
                           interlace, pre, post), None)

    for depth in (1, 2, 4, 16):
        plain(f"grey{depth}.png", 0, depth)
    plain("grey1_adam7.png", 0, 1, interlace=1)
    for depth in (1, 2, 4):
        n = 1 << depth
        plain(f"palette{depth}.png", 3, depth,
              pre=chunk(b"PLTE", rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()))
    plain("palette4_trns.png", 3, 4, pre=chunk(b"PLTE", rng.randint(0, 256, 42).astype(
        np.uint8).tobytes()) + chunk(b"tRNS", bytes([0, 64, 128, 200, 255])), top=14)
    plain("grey_alpha16.png", 4, 16)
    plain("rgba16.png", 6, 16)
    plain("rgba16_adam7.png", 6, 16, interlace=1)
    for depth in (8, 16):
        s = samples(rng, h, w, 2, depth)
        s[rng.rand(h, w) < 0.3] = s[0, 0]
        files[f"rgb{depth}_trns.png"] = (png(w, h, depth, 2, s, rng, 0, chunk(
            b"tRNS", struct.pack(">HHH", *(int(v) for v in s[0, 0]))), b""), None)
    trns = chunk(b"tRNS", struct.pack(">HHH", 1, 2, 3))
    plain("rgb8_trns_bad_crc.png", 2, 8, pre=trns[:-1] + bytes([trns[-1] ^ 1]))
    plain("exif_orient6.png", 2, 8, pre=chunk(b"eXIf", _exif(6)))
    plain("exif_orient3_after_idat.png", 2, 8, post=chunk(b"eXIf", _exif(3, ">")))
    plain("exif_orient8_long.png", 6, 16, pre=chunk(b"eXIf", _exif(8, "<", 4)))
    a, b = (smooth(rng, h, w, 3, blur=2) for _ in range(2))
    files["apng_idat_frame.png"] = (write_apng([(a, 0, 0), (b[:9, :7], 5, 3)]), None)
    files["apng_default_image.png"] = (write_apng([(b[:15, :20], 7, 4), (a, 0, 0)], default=a),
                                       None)
    pil = io.BytesIO()
    frames = [Image.fromarray(x[:, :, ::-1]) for x in (a, b, a[::-1])]
    frames[0].save(pil, "PNG", save_all=True, append_images=frames[1:], default_image=True)
    files["apng_pil_default_image.png"] = (pil.getvalue(), None)
    s16 = [samples(rng, 17, 21, 6, 16), samples(rng, 5, 6, 6, 16)]
    idat16 = apng((w, h, 16, 6), [(samples(rng, h, w, 6, 16), 0, 0, 0, 1), (s16[1], 1, 1, 0, 0)],
                  rng)
    files["apng_rgba16_small_idat_frame.png"] = (idat16.replace(
        chunk(b"fcTL", struct.pack(">IIIIIHHBB", 0, w, h, 0, 0, 1, 10, 0, 1)),
        chunk(b"fcTL", struct.pack(">IIIIIHHBB", 0, 21, 17, 9, 5, 1, 10, 0, 1))), None)
    pal = chunk(b"PLTE", rng.randint(0, 256, 48).astype(np.uint8).tobytes()) \
        + chunk(b"tRNS", bytes([0, 100, 255, 7]))
    files["apng_palette4_trns_adam7.png"] = (apng(
        (w, h, 4, 3), [(samples(rng, h, w, 3, 4), 0, 0, 1, 0), (samples(rng, 4, 4, 3, 4), 0, 0,
                                                               0, 0)],
        rng, extra=pal, interlace=1), None)
    good = files["apng_idat_frame.png"][0]
    next_fctl = good.index(b"fcTL", good.index(b"IDAT")) - 4
    past = chunk(b"fcTL", struct.pack(">IIIIIHHBB", 1, 7, 9, 30, 3, 1, 10, 0, 0))
    files["apng_bad_next_fctl.png"] = (good[:next_fctl] + past + good[next_fctl + 38:], None)
    files["apng_cut_after_idat.png"] = (good[:next_fctl], None)
    files["apng_grey.png"] = (apng((w, h, 8, 0), [(samples(rng, h, w, 0, 8), 0, 0, 0, 0)] * 2,
                                   rng), "APNG of grey samples")
    return files


def gif_files() -> dict:
    """``gif/``: PIL's GIFs (plain, interlaced, transparent, animated with
    a transparent index, 1-bit, grey), cv2's, ``chip_smoke.write_gif``'s
    (a small image at an offset on a larger screen with a background and a
    local table over the global one; GIF87a), a transparent index used only
    in a later frame's Graphic Control Extension (BGRA from cv2), and bodies
    cv2 reads no image from (a disposal method of 4, a truncated file, no
    trailer): {name: (bytes, None)}."""
    from chip_smoke import write_gif

    rng = np.random.RandomState(SEED + 26)
    h, w = 24, 40
    img = smooth(rng, h, w, 3, blur=3)
    files = {}

    def pil(name, im, **kw):
        buf = io.BytesIO()
        im.save(buf, "GIF", **kw)
        files[name] = (buf.getvalue(), None)

    rgb = Image.fromarray(img[:, :, ::-1])
    pil("pil_plain.gif", rgb)
    pil("pil_interlaced.gif", rgb, interlace=True)
    p = rgb.convert("P")
    pil("pil_transparent.gif", p, transparency=int(np.array(p)[3, 5]))
    frames = [Image.fromarray(smooth(rng, h, w, 3, blur=3)).convert("P") for _ in range(3)]
    pil("pil_animated.gif", frames[0], save_all=True, append_images=frames[1:], duration=40,
        loop=0, transparency=int(np.array(frames[0])[0, 0]), disposal=2)
    pil("pil_1bit.gif", Image.fromarray(((img[:, :, 1] > 128) * 255).astype(np.uint8)).convert("1"))
    pil("pil_grey.gif", Image.fromarray(img[:, :, 1]))
    files["cv2.gif"] = (cv2.imencode(".gif", img)[1].tobytes(), None)
    palette = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    idx = rng.randint(0, 16, (11, 13)).astype(np.uint8)
    files["screen_offset_local_table.gif"] = (write_gif(
        idx, palette, screen=(w, h), at=(9, 6), local=rng.randint(0, 256, (4, 3)).astype(
            np.uint8), bg=5, min_code=4), None)
    files["screen_transparent_interlaced.gif"] = (write_gif(
        idx, palette, screen=(20, 16), at=(3, 2), transparent=int(idx[0, 0]), bg=2,
        interlace=True, min_code=4), None)
    files["gif87a.gif"] = (write_gif(idx, palette, min_code=4, version=b"GIF87a"), None)
    two = write_gif(idx, palette, min_code=4)
    later = write_gif(idx, palette, transparent=int(idx[1, 1]), min_code=4)
    files["transparent_in_later_frame.gif"] = (two[:-1] + later[13 + 48:], None)
    bad = write_gif(idx, palette, transparent=3, min_code=4)
    gce = bad.index(b"\x21\xf9\x04") + 3
    files["bad_disposal4.gif"] = (bad[:gce] + bytes([bad[gce] | 0x10]) + bad[gce + 1:], None)
    files["truncated.gif"] = (two[:len(two) // 2], None)
    files["no_trailer.gif"] = (two[:-1], None)
    return files


def _sha_fixtures(out: str, files: dict) -> None:
    """Each file of ``files`` and the SHA-256 of cv2's decode under each
    flag ("none" where it gives none, the port's refusal where cv2's output
    is undefined, without asking cv2) in ``expected.json``."""
    os.makedirs(out, exist_ok=True)
    expected = {}
    for name, (data, raises) in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        entry = {}
        for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED):
            if raises:
                entry[str(flags)] = "raises: " + raises
                continue
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
            entry[str(flags)] = "none" if want is None else digest(want)
        expected[name] = entry
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


def magma_fixtures(out: str) -> None:
    from unopticalflow_tpu.utils.visualizer import VisualizerDebug

    rng = np.random.RandomState(SEED + 3)
    yy, xx = np.mgrid[0:96, 0:160].astype(np.float64)
    disp = 0.05 + 0.3 * (yy / 96) ** 2 + 0.02 * np.sin(xx / 9.0) + 0.01 * rng.rand(96, 160)
    handed = []
    real = Image.fromarray
    Image.fromarray = lambda arr, *a, **k: handed.append(np.array(arr)) or real(arr, *a, **k)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            VisualizerDebug(tmp).save_disp_color_img(disp, "disp")
            with open(os.path.join(tmp, "disp_depth.jpg"), "rb") as f:
                jpg = f.read()
    finally:
        Image.fromarray = real
    buf = io.BytesIO()
    Image.fromarray(handed[0]).save(buf, "JPEG")
    assert buf.getvalue() == jpg
    imageio.imwrite(os.path.join(out, "disp_magma.png"), handed[0][:, :, ::-1])
    with open(os.path.join(out, "disp_magma_q75.jpg"), "wb") as f:
        f.write(jpg)


def drawing_fixtures(out: str) -> None:
    from unopticalflow_tpu.utils.visualizer import VisualizerDebug

    os.makedirs(out, exist_ok=True)
    img1, img2, match, fundamental = drawing_inputs(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        vis = VisualizerDebug(tmp)
        vis.show_corres(img1, img2, match, "draw")
        np.random.seed(SEED)
        vis.show_epipolar_line(img1, img2, match, fundamental, "draw")
        pixels = {name: digest(cv2.imread(os.path.join(tmp, name), cv2.IMREAD_UNCHANGED))
                  for name in sorted(os.listdir(tmp))}
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump({"png_pixels_sha256": pixels}, f, indent=1)
        f.write("\n")


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype.str).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def nyu_fixtures(out: str) -> None:
    from unopticalflow_tpu.evaluation import depth_harness, eval_depth, eval_mask

    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(SEED + 1)
    n = len(NYU_SCENES)
    yy, xx = np.mgrid[0:640, 0:480].astype(np.float64)
    images = np.stack([np.transpose(smooth(rng, 640, 480, blur=12), (2, 0, 1))
                       for _ in range(n)])
    depths = np.stack([np.round((3.0 + np.sin(xx / 60.0 + k) + 0.5 * np.cos(yy / 45.0)) * 64)
                       / 64 for k in range(n)]).astype(np.float32)
    path = os.path.join(out, "nyu_depth_v2_labeled.mat")
    with h5py.File(path, "w", userblock_size=512) as f:
        f.create_dataset("images", data=images, chunks=(1, 3, 160, 120), compression="gzip",
                         compression_opts=9)
        f.create_dataset("depths", data=depths, chunks=(1, 160, 120), compression="gzip",
                         compression_opts=9)
        grp = f.create_group("#refs#")
        refs = [grp.create_dataset(f"s{k}", data=np.array([[ord(c)] for c in nm], np.uint16)).ref
                for k, nm in enumerate(NYU_SCENES)]
        scenes = f.create_dataset("scenes", (1, n), dtype=h5py.ref_dtype)
        scenes[0, :] = refs
    with open(path, "r+b") as fh:
        fh.write(b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created by: make_fixtures.py "
                 b"HDF5 schema 1.00 .".ljust(128, b" "))
    scipy.io.savemat(os.path.join(out, "splits.mat"),
                     {"trainNdxs": np.array([[1], [2]]), "testNdxs": np.array([[3]])})
    test_images, test_depths = depth_harness.load_nyu_test_data(out)

    gts, preds, masks, gt_masks = depth_mask_inputs(SEED)
    depth_res = [float(v) for v in eval_depth(gts, preds)]
    depth_res_nyu = [float(v) for v in eval_depth(gts, preds, nyu=True)]
    with tempfile.TemporaryDirectory() as tmp:
        mask_res = eval_mask(masks, gt_masks, types.SimpleNamespace(trace=tmp))
        pngs = {}
        for name in sorted(os.listdir(os.path.join(tmp, "pred_mask"))):
            px = cv2.imread(os.path.join(tmp, "pred_mask", name), cv2.IMREAD_UNCHANGED)
            pngs[name] = digest(px)
    expected = {
        "train_scenes": NYU_SCENES[:2],
        "test_scenes": NYU_SCENES[2:],
        "test_images_sha256": digest(test_images),
        "test_depths_sha256": digest(test_depths),
        "test_shapes": [list(test_images.shape), list(test_depths.shape)],
        "eval_depth": depth_res,
        "eval_depth_nyu": depth_res_nyu,
        "eval_mask": [float(v) for v in mask_res[:4]] + [[float(v) for v in mask_res[4]]],
        "eval_mask_png_pixels_sha256": pngs,
    }
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["formats"]:  # the format and CMYK fixtures only
        cmyk_fixtures(os.path.join(HERE, "jpeg"))
        format_fixtures(os.path.join(HERE, "formats"))
        sys.exit(0)
    if sys.argv[1:] == ["webp"]:  # the WebP fixtures only
        webp_fixtures(os.path.join(HERE, "webp"))
        sys.exit(0)
    if sys.argv[1:] == ["png_gif"]:  # the PNG depth, APNG and GIF fixtures only
        _sha_fixtures(os.path.join(HERE, "png"), png_depth_files())
        _sha_fixtures(os.path.join(HERE, "gif"), gif_files())
        sys.exit(0)
    if sys.argv[1:] == ["jpeg2000"]:  # the JPEG 2000 and grey-read fixtures only
        jpeg2000_fixtures(os.path.join(HERE, "jpeg2000"))
        grey_fixtures(os.path.join(HERE, "grey"))
        sys.exit(0)
    jpeg_fixtures(os.path.join(HERE, "jpeg"))
    png_fixtures(os.path.join(HERE, "png"))
    magma_fixtures(os.path.join(HERE, "jpeg"))
    drawing_fixtures(os.path.join(HERE, "drawing"))
    nyu_fixtures(os.path.join(HERE, "nyu"))
    cmyk_fixtures(os.path.join(HERE, "jpeg"))
    format_fixtures(os.path.join(HERE, "formats"))
    webp_fixtures(os.path.join(HERE, "webp"))
    jpeg2000_fixtures(os.path.join(HERE, "jpeg2000"))
    grey_fixtures(os.path.join(HERE, "grey"))
    _sha_fixtures(os.path.join(HERE, "png"), png_depth_files())
    _sha_fixtures(os.path.join(HERE, "gif"), gif_files())
