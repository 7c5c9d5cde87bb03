"""The port's GIF reader (``utils/gif.py``, its LZW in ``csrc/gif.c``)
against ``cv2.imdecode`` (OpenCV 5.0's own GIF reader), every value equal,
under ``IMREAD_COLOR``, ``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED``:
PIL's and cv2's GIFs; the first image on its logical screen (offsets, the
background colour, local tables over the global one, transparency and the
channel count cv2 picks from the last Graphic Control Extension); LZW
streams at every code size, with a full table, end codes and data past the
image; the bodies cv2 gives None for (the port gives None) and those whose
output cv2 leaves undefined (the port raises); the committed fixtures of
``tests/torch_fixtures/gif/`` against cv2 live and their digests; and a
short fuzz on fixed seeds, whole and damaged."""

import hashlib
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest

from chip_smoke import write_gif
from unopticalflow_tpu_torch.utils import gif, imageio

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "gif")
with open(os.path.join(FIXTURES, "expected.json")) as _f:
    EXPECTED = json.load(_f)
FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)


def digest(a) -> str:
    h = hashlib.sha256()
    a = np.ascontiguousarray(a)
    h.update(str(a.dtype.str).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def _cv2(data, flags):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flags)


def _same(data, flags) -> bool:
    want, got = _cv2(data, flags), imageio.imdecode(data, flags)
    if want is None:
        return got is None
    return got is not None and got.dtype == want.dtype and got.shape == want.shape \
        and np.array_equal(got, want)


def lzw_codes(idx, min_code, clear_first=True, clear_when_full=True, end=True):
    """A GIF LZW encoder: [(code, width)] of the indices ``idx``, a clear
    code first (or not), a clear code when the table fills (or not: the
    "deferred clear" some encoders write), an end code last (or not)."""
    clear = 1 << min_code
    codes = []

    def reset():
        return {(i,): i for i in range(clear)}, clear + 2, min_code + 1

    table, nxt, width = reset()
    if clear_first:
        codes.append((clear, width))
    cur = ()
    for v in np.asarray(idx).ravel():
        c = (int(v),)
        if cur + c in table:
            cur += c
            continue
        codes.append((table[cur], width))
        if nxt < 4096:
            table[cur + c] = nxt
            nxt += 1
            if nxt > 1 << width and width < 12:
                width += 1
        elif clear_when_full:
            codes.append((clear, width))
            table, nxt, width = reset()
        cur = c
    if cur:
        codes.append((table[cur], width))
    if end:
        codes.append((clear + 1, width))
    return codes


def pack(codes, min_code, extra_bits=0) -> bytes:
    """Codes packed LSB first into sub-blocks after the min code size."""
    acc = nbits = 0
    for code, width in codes:
        acc |= code << nbits
        nbits += width
    data = acc.to_bytes((nbits + extra_bits + 7) // 8, "little")
    return bytes([min_code]) + b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                                        for i in range(0, len(data), 255)) + b"\0"


def gif_of(w, h, lzw, palette, screen=None, at=(0, 0), ext=b"", trailer=b"\x3b"):
    """A GIF89a of one w x h image of LZW data ``lzw`` (``pack``'s) and a
    global table ``palette``."""
    sw, sh = screen or (w, h)
    size = palette.shape[0].bit_length() - 2
    return (b"GIF89a" + struct.pack("<HHBBB", sw, sh, 0xF0 | size, 0, 0) + palette.tobytes()
            + ext + b"\x2c" + struct.pack("<HHHHB", at[0], at[1], w, h, 0) + lzw + trailer)


PALETTE = np.random.RandomState(0).randint(0, 256, (256, 3)).astype(np.uint8)


def test_pil_and_cv2_gifs_as_cv2():
    from PIL import Image

    rng = np.random.RandomState(1)
    bodies = []
    for h, w in ((1, 1), (7, 13), (33, 40)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        runs = (img // 64) * 64  # few colours: long LZW strings
        bodies.append(cv2.imencode(".gif", img)[1].tobytes())
        for src in (img, runs):
            for kw in ({}, {"interlace": True}, {"optimize": True}):
                buf = io.BytesIO()
                Image.fromarray(src).save(buf, "GIF", **kw)
                bodies.append(buf.getvalue())
        p = Image.fromarray(img).convert("P")
        buf = io.BytesIO()
        p.save(buf, "GIF", transparency=int(np.array(p)[0, 0]))
        bodies.append(buf.getvalue())
        frames = [Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
                  for _ in range(3)]
        buf = io.BytesIO()
        frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=40,
                       loop=0, transparency=0, disposal=2)
        bodies.append(buf.getvalue())
        for mode in ("1", "L"):
            buf = io.BytesIO()
            Image.fromarray(img[:, :, 0]).convert(mode).save(buf, "GIF")
            bodies.append(buf.getvalue())
    for data in bodies:
        for flags in FLAGS:
            assert _same(data, flags), flags


def test_screen_background_tables_and_transparency_as_cv2():
    """The screen takes the global table's background colour (black without
    one), alpha 0; a local table is read over the global one's first
    entries; transparent pixels leave the screen; UNCHANGED gives BGRA when
    the last Graphic Control Extension in the file sets transparency, even
    one after the first image, and BGR when it does not."""
    rng = np.random.RandomState(2)
    idx = rng.randint(0, 16, (9, 11)).astype(np.uint8)
    pal = PALETTE[:16]
    local = PALETTE[100:104]
    cases = {
        "offset": write_gif(idx, pal, screen=(20, 14), at=(5, 3), bg=7, min_code=4),
        "local": write_gif(idx % 4, pal, local=local, min_code=2),
        "local_past": write_gif(idx, pal, local=local, min_code=4),  # global colours past 4
        "no_global": write_gif(idx % 4, None, local=local, screen=(15, 12), at=(2, 2), bg=9,
                               min_code=2),
        "transparent": write_gif(idx, pal, screen=(14, 10), at=(1, 1), bg=3,
                                 transparent=int(idx[2, 2]), min_code=4),
        "transparent_unused": write_gif(idx % 8, pal, transparent=12, min_code=4),
        "interlaced": write_gif(np.tile(idx, (3, 1)), pal, interlace=True, min_code=4),
        "gif87a": write_gif(idx, pal, version=b"GIF87a", min_code=4),
    }
    plain = write_gif(idx, pal, min_code=4)
    later = write_gif(idx, pal, transparent=int(idx[0, 0]), min_code=4)
    cases["transparent_later"] = plain[:-1] + later[13 + 48:]
    cases["transparent_then_not"] = (later[:-1] + b"\x21\xf9\x04\x00\x00\x00\x00\x00"
                                     + plain[13 + 48:])
    for name, data in cases.items():
        for flags in FLAGS:
            assert _same(data, flags), (name, flags)
    screen = imageio.imdecode(cases["offset"])
    assert (screen[0, 0] == pal[7][::-1]).all() and screen.shape == (14, 20, 3)
    assert (imageio.imdecode(cases["no_global"])[0, 0] == 0).all()
    channels = {name: imageio.imdecode(data, cv2.IMREAD_UNCHANGED).shape[2]
                for name, data in cases.items()}
    assert channels["transparent_later"] == 4 and channels["transparent_then_not"] == 3
    assert channels["transparent_unused"] == 4 and channels["offset"] == 3


@pytest.mark.parametrize("min_code", [2, 3, 5, 8, 11])
def test_lzw_at_every_code_size_as_cv2(min_code):
    """Real LZW (strings up to 12-bit codes) at each minimum code size,
    with and without a first clear code, an end code and a clear code at a
    full table (the deferred clear)."""
    rng = np.random.RandomState(min_code)
    colours = min(256, 1 << min_code)
    for h, w, kinds in ((40, 60, colours), (64, 128, min(colours, 4)), (1, 1, 2)):
        idx = rng.randint(0, kinds, (h, w)).astype(np.uint8)
        pal = PALETTE[:max(2, colours)]
        for kw in ({}, {"clear_first": False}, {"end": False}, {"clear_when_full": False}):
            data = gif_of(w, h, pack(lzw_codes(idx, min_code, **kw), min_code), pal)
            for flags in FLAGS:
                assert _same(data, flags), (kw, flags)
            assert np.array_equal(imageio.imdecode(data), pal[idx][:, :, ::-1])


def test_lzw_past_the_image_and_end_codes_as_cv2():
    """cv2's rules at the image's end: codes once the image is full are not
    looked at (even a bad one) until a data byte follows them, which fails
    the image; a string running past the image fails it; decoding goes on
    after an end code (a clear code then restarts the table); too few
    pixels fail.  Codes after an end code before the image is full read a
    table cv2 has freed: the port raises."""
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 4, (6, 8)).astype(np.uint8)
    body = lzw_codes(idx, 8)[:-1]  # every code 9 bits wide
    half = lzw_codes(idx.ravel()[:24], 8)
    ones = np.zeros((6, 8), np.uint8)
    strings = lzw_codes(ones, 8)[:-1]
    cases = {
        "end": (body + [(257, 9)], 0, True),
        "one past": (body + [(0, 9)], 0, True),
        "bad code past": (body + [(511, 9)], 0, True),
        "end, one past": (body + [(257, 9), (0, 9)], 0, True),
        "end, clear": (body + [(257, 9), (256, 9)], 0, True),
        "two past": (body + [(0, 9), (0, 9)], 0, False),
        "one past, a byte after": (body + [(0, 9)], 8, False),
        "past, end": (body + [(0, 9), (257, 9)], 0, False),
        "string past": (strings[:-1] + [(strings[-2][0], 9)], 0, False),
        "string at the end past": (strings + [(262, 9)], 0, True),
        "short": (body[:-1] + [(257, 9)], 0, False),
        "end then clear and more": (half + lzw_codes(idx.ravel()[24:], 8), 0, True),
        "bad first code": ([(256, 9), (258, 9)] + body[1:], 0, False),
        "code past the table": (body[:5] + [(400, 9)] + body[5:], 0, False),
    }
    for name, (codes, extra, decodes) in cases.items():
        data = gif_of(8, 6, pack(codes, 8, extra), PALETTE)
        for flags in FLAGS:
            assert _cv2(data, flags) is not None if decodes else _cv2(data, flags) is None, name
            assert _same(data, flags), (name, flags)
    undefined = gif_of(8, 6, pack(half + [(int(v), 9) for v in idx.ravel()[24:]], 8), PALETTE)
    with pytest.raises(ValueError, match="after an end code"):
        imageio.imdecode(undefined)


def test_bodies_cv2_reads_no_image_from_give_none():
    rng = np.random.RandomState(4)
    idx = rng.randint(0, 16, (5, 7)).astype(np.uint8)
    good = write_gif(idx, PALETTE[:16], transparent=2, min_code=4)
    gce = good.index(b"\x21\xf9\x04")
    lzw = pack(lzw_codes(idx, 4), 4)
    nones = {
        "no pixels": b"GIF89a" + bytes(7) + b"\x3b",
        "background past the table": good[:11] + b"\x20" + good[12:],
        "no trailer": good[:-1],
        "cut": good[:len(good) - 9],
        "unknown block": good[:-1] + b"\x99\x3b",
        "extension length 5": good[:gce + 2] + b"\x05\x01\x00\x00\x02\x00\x00" + good[gce + 8:],
        "disposal 4": good[:gce + 3] + b"\x11" + good[gce + 4:],
        "image past the screen": gif_of(7, 5, lzw, PALETTE[:16], screen=(8, 5), at=(2, 0)),
        "min code size 12": gif_of(7, 5, b"\x0c" + lzw[1:], PALETTE[:16]),
        "min code size 1": gif_of(7, 5, b"\x01" + lzw[1:], PALETTE[:16]),
        "index past the tables": gif_of(7, 5, lzw, PALETTE[:8]),
        "GIF88a": b"GIF88a" + good[6:],
        "NETSCAPE misread": good[:13 + 48] + b"\x21\xff\x0bNETSCAPE2\xa60\x03\x01\x00\x00\x00"
                            + good[13 + 48:],
    }
    for name, data in nones.items():
        for flags in FLAGS:
            assert _cv2(data, flags) is None, name
            assert imageio.imdecode(data, flags) is None, name
    assert _same(good[:13 + 48] + b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
                 + good[13 + 48:], cv2.IMREAD_UNCHANGED)
    # a transparent index past the tables is not looked up
    hidden = np.where(idx < 8, idx, 15).astype(np.uint8)
    data = gif_of(7, 5, pack(lzw_codes(hidden, 4), 4), PALETTE[:8],
                  ext=b"\x21\xf9\x04\x01\x00\x00\x0f\x00")
    for flags in FLAGS:
        assert _cv2(data, flags) is not None and _same(data, flags)
    with pytest.raises(ValueError, match="without a colour table"):
        gif.decode_gif(write_gif(idx % 4, None, min_code=2))


def test_imread_reads_gif_as_cv2(tmp_path):
    img = np.random.RandomState(5).randint(0, 256, (12, 20, 3)).astype(np.uint8)
    path = str(tmp_path / "frame.gif")
    assert cv2.imwrite(path, img)
    for flags in FLAGS:
        want, got = cv2.imread(path, flags), imageio.imread(path, flags)
        assert got.dtype == want.dtype and np.array_equal(got, want), flags


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_decodes_as_cv2(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    for flags in FLAGS:
        want = EXPECTED[name][str(flags)]
        cv2_out = _cv2(data, flags)
        assert (digest(cv2_out) if cv2_out is not None else "none") == want  # still cv2's
        got = imageio.imdecode(data, flags)
        assert (digest(got) if got is not None else "none") == want, flags


def _fuzz_file(rng):
    """A random GIF: a screen, global and local tables of random sizes, up
    to three images at random offsets with Graphic Control, comment and
    NETSCAPE extensions, interlaced or not, real or literal LZW."""
    w0, h0 = int(rng.randint(1, 24)), int(rng.randint(1, 18))
    gn = int(rng.choice([2, 4, 16, 256]))
    out = (b"GIF89a" + struct.pack("<HHBBB", w0, h0, 0xF0 | (gn.bit_length() - 2),
                                   int(rng.randint(0, gn)), 0)
           + rng.randint(0, 256, 3 * gn).astype(np.uint8).tobytes())
    for _ in range(int(rng.randint(1, 4))):
        for _ in range(int(rng.randint(0, 3))):
            r = rng.rand()
            if r < 0.6:
                out += b"\x21\xf9\x04" + bytes([(int(rng.randint(0, 4)) << 2) | int(
                    rng.rand() < 0.5), 10, 0, int(rng.randint(0, gn)), 0])
            elif r < 0.8:
                out += b"\x21\xfe\x03abc\x00"
            else:
                out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
        w, h = int(rng.randint(1, w0 + 1)), int(rng.randint(1, h0 + 1))
        ln = int(rng.choice([0, 0, 4, 16]))
        size = max(gn, ln)
        min_code = max(2, (size - 1).bit_length())
        idx = rng.randint(0, size, (h, w)).astype(np.uint8)
        interlace = rng.rand() < 0.3
        if interlace:
            rows = idx[np.concatenate([np.arange(s, h, d) for s, d in
                                       ((0, 8), (4, 8), (2, 4), (1, 2))])]
        else:
            rows = idx
        out += b"\x2c" + struct.pack("<HHHHB", int(rng.randint(0, w0 - w + 1)),
                                     int(rng.randint(0, h0 - h + 1)), w, h,
                                     (0x80 | (ln.bit_length() - 2) if ln else 0)
                                     | (0x40 if interlace else 0))
        if ln:
            out += rng.randint(0, 256, 3 * ln).astype(np.uint8).tobytes()
        out += pack(lzw_codes(rows, min_code, clear_first=rng.rand() < 0.8,
                              end=rng.rand() < 0.9), min_code)
    return out + b"\x3b"


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_gif_as_cv2(seed):
    """Generated GIFs on fixed seeds, a third of them with bytes changed or
    cut: equal to cv2's decode, None where cv2 gives None; the undefined
    cases raise."""
    rng = np.random.RandomState(200 + seed)
    for _ in range(200):
        data = _fuzz_file(rng)
        if rng.rand() < 0.35:
            b = bytearray(data)
            if rng.rand() < 0.5:
                b = b[:int(rng.randint(6, len(b)))]
            else:
                for _ in range(int(rng.randint(1, 3))):
                    b[int(rng.randint(6, len(b)))] = int(rng.randint(0, 256))
            data = bytes(b)
        for flags in FLAGS:
            want = _cv2(data, flags)
            try:
                got = imageio.imdecode(data, flags)
            except ValueError:
                continue  # cv2's output undefined
            if want is None:
                assert got is None
            else:
                assert got is not None and got.shape == want.shape and np.array_equal(got, want)
