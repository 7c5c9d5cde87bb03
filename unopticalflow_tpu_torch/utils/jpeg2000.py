"""JPEG 2000 (ITU-T T.800 Part 1: a JP2 file or a bare J2K codestream),
read as ``cv2.imdecode`` (OpenCV 5.0 with OpenJPEG 2.5) reads it, every
value equal.

The JP2 boxes (signature, ``ftyp``, ``jp2h`` with ``ihdr``, ``colr``,
``pclr``, ``cmap``, ``cdef`` and ``res ``, then ``jp2c``) and the
codestream's marker segments (SIZ, COD, COC, QCD, QCC, RGN, POC, PPM, PPT,
TLM, PLM, PLT, CRG, COM, SOT, SOD, EOC) are read here; ``csrc/jpeg2000.c``
decodes each tile (packets, code-blocks, dequantisation, the inverse DWT,
the inverse RCT or ICT, the DC level shift) as OpenJPEG does.  The tiles'
components are then taken through OpenJPEG's palette (``pclr`` with
``cmap``) and channel definitions (``cdef``), and into cv2's array as cv2's
JPEG 2000 reader builds it:

* cv2 reads the header's components (1 to 4, none signed, the deepest of 8
  bits or more): 8 bits give uint8, 9 to 16 bits uint16 under
  ``IMREAD_UNCHANGED``; ``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE`` give
  uint8, each component shifted right by the deepest precision less 8.
* The colour space is the ``colr`` box's (enumerated sRGB, greyscale or
  sYCC; an ICC profile, a bare codestream or no box read as sRGB).  sRGB:
  the first three components as BGR, a fourth as alpha under
  ``IMREAD_UNCHANGED``, one or two components as grey (repeated under
  ``IMREAD_COLOR``), three or more to grey by ``cv2.cvtColor``'s BGR2GRAY.
  Greyscale: the first component, repeated under ``IMREAD_COLOR``.
* Where cv2 gives None (a signed or subsampled component, an image offset,
  two channels under ``IMREAD_UNCHANGED``, precision below 8 bits, a
  decode OpenJPEG fails), ``decode_jpeg2000`` gives None where the
  codestream decodes and cv2 refuses its shape, and raises ``ValueError``
  naming the fault where the codestream itself does not decode.
"""

from __future__ import annotations

import struct

import numpy as np

from unopticalflow_tpu_torch.utils.imageio import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                                   IMREAD_UNCHANGED, _check_flags)

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"

# csrc/jpeg2000.c's parameter block
_P_POC, _P_COMP, _C_SIZE = 16, 16 + 32 * 6, 16 + 66 + 194
_C_PRC, _C_STEP = 16, 16 + 66
_MAXRES, _MAXBANDS = 33, 97
_CBLK_HT = 0x40
# cv2's CV_IO_MAX_IMAGE_WIDTH / HEIGHT / PIXELS: past them it reads no image
_CV_MAX_SIDE, _CV_MAX_PIXELS = 1 << 20, 1 << 30
# the largest image the port decodes (4096 x 4096): its planes and tiles are
# held whole, as OpenJPEG holds them, and a corrupt SIZ can claim any size
_MAX_PIXELS = 1 << 24


def is_jpeg2000(data: bytes) -> bool:
    """Whether ``data`` opens as a JP2 file or a J2K codestream does (as cv2
    tells them apart)."""
    return data.startswith((JP2_SIGNATURE, J2K_SIGNATURE))


def _lib():
    """``csrc/jpeg2000.c``, built with the host's C compiler at first use."""
    import ctypes

    from unopticalflow_tpu_torch.ops import _build

    i64, p = ctypes.c_int64, _build.P
    return _build.load("jpeg2000", {
        "j2k_decode_tile": [p, p, i64, p, i64, p, p, p, i64, p, _build.I],
    })


class _Fault(ValueError):
    def __init__(self, what: str):
        super().__init__(f"JPEG 2000: {what}")


def _u(data: bytes, pos: int, n: int) -> int:
    if pos + n > len(data):
        raise _Fault("truncated marker segment")
    return int.from_bytes(data[pos:pos + n], "big")


# ---------------------------------------------------------------------------
# the JP2 boxes
# ---------------------------------------------------------------------------


def _boxes(data: bytes, pos: int, end: int):
    """(type, payload start, payload end) of each box in data[pos:end]."""
    while pos < end:
        if end - pos < 8:
            raise _Fault("truncated box header")
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            if end - pos < 16:
                raise _Fault("truncated box header")
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head:
            raise _Fault(f"box {kind!r} of {size} bytes")
        if pos + size > end:
            if kind == b"jp2c":  # the codestream may run to the end of the file
                size = end - pos
            else:
                raise _Fault(f"box {kind!r} runs past the end of the file")
        yield kind, pos + head, pos + size
        pos += size


def _read_jp2(data: bytes):
    """The codestream and the colour boxes of a JP2 file."""
    info = {"enumcs": 0, "pclr": None, "cmap": None, "cdef": None, "ihdr": None}
    seen = []
    stream = None
    for kind, start, end in _boxes(data, 0, len(data)):
        body = data[start:end]
        if not seen:
            if kind != b"jP  " or body != b"\r\n\x87\n":
                raise _Fault("no JP2 signature box")
        elif len(seen) == 1 and kind != b"ftyp":
            raise _Fault("the second box is not ftyp")
        seen.append(kind)
        if kind == b"ftyp":
            if len(body) < 8 or len(body) % 4:
                raise _Fault("bad ftyp box")
        elif kind == b"jp2h":
            _read_jp2h(data, start, end, info)
        elif kind == b"jp2c":
            if info["ihdr"] is None:
                raise _Fault("the codestream comes before the jp2h box")
            stream = data[start:]  # OpenJPEG reads on to EOC, whatever the box's length
            break
    if stream is None:
        raise _Fault("no codestream box")
    return stream, info


def _read_jp2h(data: bytes, start: int, end: int, info: dict) -> None:
    colr = False
    for kind, s, e in _boxes(data, start, end):
        body = data[s:e]
        if kind == b"ihdr":
            if len(body) != 14:
                raise _Fault("bad ihdr box")
            h, w, nc, bpc = struct.unpack(">IIHB", body[:11])
            if h == 0 or w == 0 or not 0 < nc <= 16384:
                raise _Fault("bad ihdr box")
            info["ihdr"] = (h, w, nc, bpc)
        elif kind == b"colr" and not colr:
            if len(body) < 3:
                raise _Fault("bad colr box")
            colr = True
            meth = body[0]
            if meth == 1:
                if len(body) < 7:
                    raise _Fault("bad colr box")
                info["enumcs"] = struct.unpack(">I", body[3:7])[0]
        elif kind == b"pclr":
            if len(body) < 3:
                raise _Fault("bad pclr box")
            ne, npc = struct.unpack(">HB", body[:3])
            if ne == 0 or ne > 1024 or npc == 0:
                raise _Fault("bad pclr box")
            bits = body[3:3 + npc]
            if len(bits) < npc:
                raise _Fault("bad pclr box")
            sizes = [(b & 0x7F) + 1 for b in bits]
            pos, entries = 3 + npc, np.zeros((ne, npc), np.int32)
            for i in range(ne):
                for j in range(npc):
                    n = (sizes[j] + 7) // 8
                    if n > 4 or pos + n > len(body):
                        raise _Fault("bad pclr box")
                    entries[i, j] = int.from_bytes(body[pos:pos + n], "big")
                    pos += n
            info["pclr"] = entries
        elif kind == b"cmap":
            if len(body) % 4:
                raise _Fault("bad cmap box")
            info["cmap"] = [struct.unpack(">HBB", body[k:k + 4]) for k in range(0, len(body), 4)]
        elif kind == b"cdef":
            if len(body) < 2:
                raise _Fault("bad cdef box")
            n = struct.unpack(">H", body[:2])[0]
            if n == 0 or len(body) < 2 + 6 * n:
                raise _Fault("bad cdef box")
            info["cdef"] = [struct.unpack(">HHH", body[2 + 6 * k:8 + 6 * k]) for k in range(n)]
    if info["ihdr"] is None:
        raise _Fault("no ihdr box in jp2h")


# ---------------------------------------------------------------------------
# the codestream's markers
# ---------------------------------------------------------------------------


class _Coding:
    """The coding parameters of the main header or of a tile (COD, COC, QCD,
    QCC, RGN, POC, PPT)."""

    def __init__(self, ncomp: int):
        self.csty = 0
        self.prog = 0
        self.layers = 1
        self.mct = 0
        self.pocs = []
        self.comps = [dict(numres=6, cbw=6, cbh=6, sty=0, qmfbid=0, prc=[(15, 15)] * _MAXRES,
                           qntsty=0, guard=2, steps=[(0, 0)] * _MAXBANDS, roishift=0)
                      for _ in range(ncomp)]

    def copy(self) -> "_Coding":
        """A tile's parameters: the main header's, its POCs included (a
        tile's own POC markers add to them, as in OpenJPEG)."""
        c = _Coding(0)
        c.csty, c.prog, c.layers, c.mct = self.csty, self.prog, self.layers, self.mct
        c.pocs = list(self.pocs)
        c.comps = [dict(d) for d in self.comps]
        return c


def _spcod(body: bytes, pos: int, precincts: bool, comp: dict) -> None:
    numres = _u(body, pos, 1) + 1
    if numres > _MAXRES:
        raise _Fault(f"{numres - 1} decomposition levels")
    cbw, cbh = _u(body, pos + 1, 1) + 2, _u(body, pos + 2, 1) + 2
    if cbw > 10 or cbh > 10 or cbw + cbh > 12:
        raise _Fault(f"code-blocks of 2^{cbw} x 2^{cbh}")
    sty, qmfbid = _u(body, pos + 3, 1), _u(body, pos + 4, 1)
    if sty & 0x80:
        raise _Fault("mixed high-throughput code-blocks")
    if sty & _CBLK_HT:
        raise _Fault("high-throughput (Part 15) code-blocks are not read")
    if qmfbid > 1:
        raise _Fault(f"wavelet transform {qmfbid}")
    prc = [(15, 15)] * _MAXRES
    end = pos + 5
    if precincts:
        for r in range(numres):
            b = _u(body, pos + 5 + r, 1)
            prc[r] = (b & 15, b >> 4)
            if r and (prc[r][0] == 0 or prc[r][1] == 0):
                raise _Fault("a precinct of size 1 above the lowest resolution")
        end += numres
    if end != len(body):
        raise _Fault("a COD or COC marker of the wrong length")
    comp.update(numres=numres, cbw=cbw, cbh=cbh, sty=sty, qmfbid=qmfbid, prc=prc)


def _sqcd(body: bytes, pos: int, comp: dict) -> None:
    s = _u(body, pos, 1)
    style, guard = s & 31, s >> 5
    rest = body[pos + 1:]
    if style == 0:
        steps = [(b >> 3, 0) for b in rest]
    else:  # OpenJPEG reads any style but 0 and 1 as expounded
        if len(rest) != 2 if style == 1 else len(rest) % 2:
            raise _Fault("a QCD or QCC marker of the wrong length")
        vals = [int.from_bytes(rest[k:k + 2], "big") for k in range(0, len(rest), 2)]
        steps = [(v >> 11, v & 0x7FF) for v in vals]
    steps = steps[:_MAXBANDS]
    if style == 1:  # derived: the others from the LL band's, a level at a time
        e0, m0 = steps[0]
        steps += [(max(e0 - (b - 1) // 3, 0), m0) for b in range(1, _MAXBANDS)]
    steps = (steps + [(0, 0)] * _MAXBANDS)[:_MAXBANDS]
    comp.update(qntsty=style, guard=guard, steps=steps)


def _comp_index(body: bytes, ncomp: int):
    n = 1 if ncomp <= 256 else 2
    c = _u(body, 0, n)
    if c >= ncomp:
        raise _Fault(f"a marker for component {c} of {ncomp}")
    return c, n


def _coding_marker(code: int, body: bytes, cod: _Coding, ncomp: int) -> None:
    if code == 0xFF52:  # COD
        scod = _u(body, 0, 1)
        if scod & ~7:
            raise _Fault(f"COD style {scod:#x}")
        cod.csty = scod
        cod.prog = _u(body, 1, 1)
        cod.layers = _u(body, 2, 2)
        cod.mct = _u(body, 4, 1)
        if cod.prog > 4:
            raise _Fault(f"progression order {cod.prog}")
        if cod.layers == 0:
            raise _Fault("no quality layers")
        if cod.mct > 1:
            raise _Fault(f"multiple-component transform {cod.mct}")
        first = dict(cod.comps[0])
        _spcod(body, 5, bool(scod & 1), first)
        for comp in cod.comps:
            comp.update({k: first[k] for k in ("numres", "cbw", "cbh", "sty", "qmfbid", "prc")})
    elif code == 0xFF53:  # COC
        c, n = _comp_index(body, ncomp)
        _spcod(body, n + 1, bool(_u(body, n, 1) & 1), cod.comps[c])
    elif code == 0xFF5C:  # QCD
        first = dict(cod.comps[0])
        _sqcd(body, 0, first)
        for comp in cod.comps:
            comp.update({k: first[k] for k in ("qntsty", "guard", "steps")})
    elif code == 0xFF5D:  # QCC
        c, n = _comp_index(body, ncomp)
        _sqcd(body, n, cod.comps[c])
    elif code == 0xFF5E:  # RGN
        c, n = _comp_index(body, ncomp)
        if _u(body, n, 1) != 0:
            raise _Fault("ROI style other than 0")
        cod.comps[c]["roishift"] = _u(body, n + 1, 1)
    elif code == 0xFF5F:  # POC
        n = 1 if ncomp <= 256 else 2
        step = 5 + 2 * n
        if len(body) % step or not body:
            raise _Fault("bad POC marker")
        for k in range(0, len(body), step):
            rs, cs = _u(body, k, 1), _u(body, k + 1, n)
            le, re_ = _u(body, k + 1 + n, 2), _u(body, k + 3 + n, 1)
            ce, prg = _u(body, k + 4 + n, n), _u(body, k + 4 + 2 * n, 1)
            if prg > 4:
                raise _Fault(f"POC progression order {prg}")
            cod.pocs.append((rs, cs, le, re_, min(ce, ncomp), prg))
        if len(cod.pocs) > 32:
            raise _Fault("more than 32 progression order changes")


def _siz(body: bytes):
    if len(body) < 36:
        raise _Fault("truncated SIZ marker")
    (_, x1, y1, x0, y0, tw, th, tx0, ty0, nc) = struct.unpack(">HIIIIIIIIH", body[:36])
    if nc == 0 or len(body) != 36 + 3 * nc:
        raise _Fault("a SIZ marker of the wrong length for its components")
    comps = []
    for k in range(nc):
        s, dx, dy = body[36 + 3 * k:39 + 3 * k]
        comps.append(dict(prec=(s & 0x7F) + 1, sgnd=s >> 7, dx=dx, dy=dy))
        if dx == 0 or dy == 0:
            raise _Fault("a component sampled every 0 samples")
        if comps[-1]["prec"] > 31:
            raise _Fault(f"{comps[-1]['prec']}-bit samples")
    if x0 >= x1 or y0 >= y1 or tw == 0 or th == 0:
        raise _Fault("bad image or tile size in SIZ")
    if tx0 > x0 or ty0 > y0 or tx0 + tw <= x0 or ty0 + th <= y0:
        raise _Fault("the first tile does not cover the image's origin")
    return dict(x0=x0, y0=y0, x1=x1, y1=y1, tw=tw, th=th, tx0=tx0, ty0=ty0, comps=comps)


_SOT, _SOD, _EOC, _SIZ = 0xFF90, 0xFF93, 0xFFD9, 0xFF51
_MH, _TPH = 1, 2
# the marker segments OpenJPEG knows and the headers it takes each in (SIZ
# only first); any other is unknown
_STATES = {0xFF52: _MH | _TPH, 0xFF53: _MH | _TPH, 0xFF5E: _MH | _TPH, 0xFF5C: _MH | _TPH,
           0xFF5D: _MH | _TPH, 0xFF5F: _MH | _TPH, 0xFF55: _MH, 0xFF57: _MH, 0xFF58: _TPH,
           0xFF60: _MH, 0xFF61: _TPH, 0xFF91: 0, 0xFF63: _MH, 0xFF64: _MH | _TPH,
           0xFF74: _MH | _TPH, 0xFF78: _MH, 0xFF50: _MH, 0xFF59: _MH, 0xFF75: _MH | _TPH,
           0xFF77: _MH | _TPH, _SOT: _MH}
_CODING = (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F)


def _u16(cs: bytes, pos: int) -> int:
    if pos + 2 > len(cs):
        raise _Fault("the codestream is too short")
    return int.from_bytes(cs[pos:pos + 2], "big")


def _segment(cs: bytes, pos: int):
    """The body of the marker segment at ``pos`` and the position after it."""
    n = _u16(cs, pos + 2)
    if n < 2:
        raise _Fault(f"marker {_u16(cs, pos):#06x} of length {n}")
    if pos + 2 + n > len(cs):
        raise _Fault("the codestream is too short")
    return cs[pos + 4:pos + 2 + n], pos + 2 + n


def _main_header(cs: bytes):
    """OpenJPEG's walk of the main header: (SIZ, coding, PPM bodies, position
    of the first SOT).  An unknown marker is skipped two bytes at a time up
    to the next marker OpenJPEG knows."""
    siz, main, ppm, found = None, None, [], set()
    pos = 2
    while True:
        code = _u16(cs, pos)
        if code == _SOT and siz is not None:
            break
        if code < 0xFF00:
            raise _Fault(f"expected a marker at byte {pos}, found {code:#06x}")
        known = code == _SIZ or code in _STATES
        if not known:  # OpenJPEG's opj_j2k_read_unk
            pos += 2
            while True:
                code = _u16(cs, pos)
                if code >= 0xFF00 and (code == _SIZ or code in _STATES):
                    break
                pos += 2
            if code == _SOT and siz is not None:
                break
        if (code == _SIZ) != (siz is None) or (code != _SIZ and not _STATES[code] & _MH):
            raise _Fault(f"marker {code:#06x} out of its place in the main header")
        body, after = _segment(cs, pos)
        found.add(code)
        if code == _SIZ:
            siz = _siz(body)
            main = _Coding(len(siz["comps"]))
        elif code in _CODING:
            _coding_marker(code, body, main, len(siz["comps"]))
        elif code == 0xFF60:  # PPM
            ppm.append((body[0] if body else 0, body[1:]))
        pos = after
    for code, name in ((0xFF52, "COD"), (0xFF5C, "QCD")):
        if code not in found:
            raise _Fault(f"no {name} marker in the main header")
    return siz, main, ppm, pos


def _read_codestream(cs: bytes):
    """The SIZ header, the main coding parameters, the PPM bodies and each
    tile's (coding, data, PPT bodies), walked as OpenJPEG walks them."""
    if not cs.startswith(J2K_SIGNATURE):
        raise _Fault("the codestream does not open with SOC and SIZ")
    siz, main, ppm, pos = _main_header(cs)
    ncomp = len(siz["comps"])
    ntx = -(-(siz["x1"] - siz["tx0"]) // siz["tw"])
    nty = -(-(siz["y1"] - siz["ty0"]) // siz["th"])
    if ntx * nty > 65535:
        raise _Fault(f"{ntx} x {nty} tiles, more than 65535")
    tiles, order, done = {}, [], 0
    while True:
        code = _u16(cs, pos)
        if code == _EOC or len(cs) - pos == 2 and tiles:  # nothing after the marker: the end
            break
        if code != _SOT:
            raise _Fault(f"marker {code:#06x} where a tile-part should start")
        body, hpos = _segment(cs, pos)
        if len(body) != 8:
            raise _Fault("bad SOT marker")
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", body)
        if isot >= ntx * nty:
            raise _Fault(f"tile {isot} of {ntx * nty}")
        tile = tiles.get(isot)
        if tile is None:
            tile = tiles[isot] = dict(cod=main.copy(), data=[], ppt=[], parts=0, total=0)
            order.append(isot)
        if tpsot != tile["parts"]:
            raise _Fault(f"tile-part {tpsot} of tile {isot} where {tile['parts']} was expected")
        if tnsot:
            if tile["total"] and tpsot >= tile["total"] or tpsot >= tnsot:
                raise _Fault(f"tile-part {tpsot} of tile {isot}, which has {tnsot}")
            tile["total"] = tnsot
        tile["parts"] += 1
        if psot and psot < 14:
            raise _Fault(f"a tile-part of {psot} bytes")
        end = pos + psot if psot else len(cs) - 2
        if end > len(cs):
            raise _Fault(f"a tile-part of tile {isot} runs past the end of the codestream")
        pos = hpos
        while True:  # the tile-part header: known markers only, up to SOD
            code = _u16(cs, pos)
            if code == _SOD:
                break
            if code not in _STATES or not _STATES[code] & _TPH:
                raise _Fault(f"marker {code:#06x} in a tile-part header")
            body, after = _segment(cs, pos)
            if after > end - 2 and psot:
                raise _Fault("a tile-part header longer than its tile-part")
            if code in _CODING:
                _coding_marker(code, body, tile["cod"], ncomp)
            elif code == 0xFF61:  # PPT
                tile["ppt"].append((body[0] if body else 0, body[1:]))
            pos = after
        tile["data"].append(cs[pos + 2:max(end, pos + 2)])
        pos = max(end, pos + 2)
        # after a tile's last tile-part OpenJPEG reads the next marker: EOC
        # ends the codestream (whatever follows), two last bytes end it too
        code = _u16(cs, pos)
        if tile["total"] == tile["parts"]:
            if code not in (_SOT, _EOC):
                if len(cs) - pos == 2:
                    break
                raise _Fault(f"marker {code:#06x} after tile {isot}")
            done += 1
            if done == ntx * nty:  # every tile read: OpenJPEG reads no further
                break
    if ppm and any(t["ppt"] for t in tiles.values()):
        raise _Fault("PPT and PPM in one codestream")
    return siz, main, ppm, tiles, order, (ntx, nty)


def _ppm_headers(ppm) -> bytes:
    """The packet headers of PPM markers as OpenJPEG merges them: the
    markers in Zppm order (each once), each an Nppm count of 4 bytes and
    that many bytes of headers, which may run on into the next marker; a
    count that the markers do not fill is a fault."""
    if len({z for z, _ in ppm}) != len(ppm):
        raise _Fault("two PPM markers of one Zppm")
    out, remaining = bytearray(), 0
    for _, body in sorted(ppm, key=lambda z: z[0]):
        take = min(remaining, len(body))
        out += body[:take]
        remaining -= take
        pos = take
        while pos < len(body):
            if pos + 4 > len(body):
                raise _Fault("a PPM marker too short for its Nppm count")
            n = int.from_bytes(body[pos:pos + 4], "big")
            chunk = body[pos + 4:pos + 4 + n]
            out += chunk
            remaining = n - len(chunk)
            pos += 4 + n
    if remaining:
        raise _Fault("PPM markers shorter than their Nppm counts")
    return bytes(out)


def _params(siz, cod: _Coding, tile_box, comp_geom) -> np.ndarray:
    prm = np.zeros(_P_COMP + _C_SIZE * len(siz["comps"]), np.int32)
    tx0, ty0, tx1, ty1 = tile_box
    prm[:10] = [len(siz["comps"]), tx0, ty0, tx1, ty1, cod.prog, cod.layers, cod.mct,
                cod.csty, len(cod.pocs)]
    for k, poc in enumerate(cod.pocs):
        prm[_P_POC + 6 * k:_P_POC + 6 * k + 6] = poc
    for c, (sc, cc) in enumerate(zip(siz["comps"], cod.comps)):
        b = _P_COMP + _C_SIZE * c
        prm[b:b + 16] = [sc["dx"], sc["dy"], sc["prec"], sc["sgnd"], cc["numres"], cc["cbw"],
                         cc["cbh"], cc["sty"], cc["qmfbid"], cc["qntsty"], cc["guard"],
                         cc["roishift"], *comp_geom[c]]
        prm[b + _C_PRC:b + _C_PRC + 2 * _MAXRES] = np.asarray(cc["prc"], np.int32).ravel()
        prm[b + _C_STEP:b + _C_STEP + 2 * _MAXBANDS] = np.asarray(cc["steps"], np.int32).ravel()
    return prm


def _decode_components(cs: bytes, ihdr=None, packets=None):
    """The codestream's components, each an int32 (h, w) plane, and SIZ.
    ``packets``: a list to receive each tile's (start, body, end) packet
    offsets in its data (the test fixtures move packet headers by them)."""
    import ctypes

    siz, main, ppm, tiles, order, (ntx, nty) = _read_codestream(cs)
    w, h = siz["x1"] - siz["x0"], siz["y1"] - siz["y0"]
    if w > _CV_MAX_SIDE or h > _CV_MAX_SIDE or w * h > _CV_MAX_PIXELS:
        raise _Fault(f"an image of {w}x{h} pixels, past cv2's limits")
    if w * h > _MAX_PIXELS:
        raise _Fault(f"an image of {w}x{h} pixels: the port decodes up to {_MAX_PIXELS} pixels")
    if ihdr is not None and (ihdr[0], ihdr[1]) != (siz["y1"] - siz["y0"], siz["x1"] - siz["x0"]):
        raise _Fault("the ihdr box and SIZ disagree on the image size")
    geom = []
    for sc in siz["comps"]:
        cx0, cy0 = -(-siz["x0"] // sc["dx"]), -(-siz["y0"] // sc["dy"])
        cx1, cy1 = -(-siz["x1"] // sc["dx"]), -(-siz["y1"] // sc["dy"])
        geom.append((cx0, cy0, cx1 - cx0, cy1 - cy0))
    planes = [np.zeros((g[3], g[2]), np.int32) for g in geom]
    ptrs = (ctypes.c_void_p * len(planes))(*[p.ctypes.data for p in planes])
    lib = _lib()
    err = ctypes.create_string_buffer(256)
    hdr = np.frombuffer(_ppm_headers(ppm), np.uint8) if ppm else None
    hpos = np.zeros(1, np.int64)
    if not order:
        raise _Fault("no tile in the codestream")
    for isot in order:
        tile = tiles[isot]
        cod = tile["cod"]
        p, q = isot % ntx, isot // ntx
        box = (max(siz["tx0"] + p * siz["tw"], siz["x0"]), max(siz["ty0"] + q * siz["th"], siz["y0"]),
               min(siz["tx0"] + (p + 1) * siz["tw"], siz["x1"]),
               min(siz["ty0"] + (q + 1) * siz["th"], siz["y1"]))
        prm = _params(siz, cod, box, geom)
        data = np.frombuffer(b"".join(tile["data"]) or b"\0", np.uint8)
        length = sum(len(d) for d in tile["data"])
        thdr = hdr
        tpos = hpos
        if tile["ppt"]:
            thdr = np.frombuffer(b"".join(b for _, b in sorted(tile["ppt"], key=lambda z: z[0]))
                                 or b"\0", np.uint8)
            tpos = np.zeros(1, np.int64)
        bounds = None if packets is None else np.zeros(1 + 3 * 65536, np.int64)
        rc = lib.j2k_decode_tile(prm.ctypes.data, data.ctypes.data, length,
                                 None if thdr is None else thdr.ctypes.data,
                                 0 if thdr is None else thdr.size, tpos.ctypes.data, ptrs,
                                 None if bounds is None else bounds.ctypes.data, 65536, err,
                                 len(err))
        if rc:
            raise _Fault(err.value.decode() or "tile decode failed")
        if packets is not None:
            packets.append(bounds[1:1 + 3 * int(bounds[0])].reshape(-1, 3))
    return planes, siz


# ---------------------------------------------------------------------------
# OpenJPEG's palette and channel definitions, then cv2's array
# ---------------------------------------------------------------------------


def _check_color(ncomp: int, info: dict) -> None:
    """OpenJPEG's ``opj_jp2_check_color``: every ``cdef`` channel and
    association in range and every channel defined; a ``cmap`` that maps
    each palette column once (a single component's cmap is repaired to map
    column i to channel i)."""
    pclr, cmap, cdef = info["pclr"], info["cmap"], info["cdef"]
    channels = ncomp if pclr is None or cmap is None else pclr.shape[1]
    if cdef:
        for cn, _, asoc in cdef:
            if cn >= channels or asoc not in (0, 65535) and asoc - 1 >= channels:
                raise _Fault("a cdef channel out of range")
        if not set(range(channels)) <= {cn for cn, _, _ in cdef}:
            raise _Fault("incomplete channel definitions in cdef")
    if pclr is None or cmap is None:
        return
    if len(cmap) < channels:
        raise _Fault("cmap and pclr disagree on the number of channels")
    used, sane = [False] * channels, True
    for i, (cmp, mtyp, pcol) in enumerate(cmap[:channels]):
        if cmp >= ncomp or mtyp > 1 or pcol >= channels or used[pcol] and mtyp == 1 or (
                mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
            sane = False
        else:
            used[pcol] = True
    if any(not u and m[1] != 0 for u, m in zip(used, cmap)):
        sane = False
    if sane and ncomp == 1 and not all(used):
        info["cmap"] = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(cmap[:channels])]
    elif not sane:
        raise _Fault("bad component mapping in cmap")


def _apply_pclr(planes, info):
    """OpenJPEG's ``opj_jp2_apply_pclr``: each ``cmap`` channel a component
    used directly or mapped through a palette column (indices clamped to
    the palette).  A palette without ``cmap`` is dropped."""
    if info["pclr"] is None or info["cmap"] is None:
        return planes
    entries = info["pclr"]
    return [planes[cmp].copy() if mtyp == 0 else
            entries[np.clip(planes[cmp], 0, len(entries) - 1), pcol]
            for cmp, mtyp, pcol in info["cmap"][:entries.shape[1]]]


def _apply_cdef(planes, cdef):
    """OpenJPEG's ``opj_jp2_apply_cdef``: a colour channel associated with
    another colour's place swaps with it."""
    planes = list(planes)
    defs = [list(d) for d in cdef]
    for i, (cn, typ, asoc) in enumerate(defs):
        if cn >= len(planes) or asoc in (0, 65535):
            continue
        acn = asoc - 1
        if acn >= len(planes):
            continue
        if cn != acn and typ == 0:
            planes[cn], planes[acn] = planes[acn], planes[cn]
            for d in defs[i + 1:]:
                if d[0] == cn:
                    d[0] = acn
                elif d[0] == acn:
                    d[0] = cn
    return planes


def _grey(b, g, r):
    """``cv2.cvtColor``'s BGR2GRAY of uint8 or uint16 planes (its 15-bit
    weights at both depths)."""
    y = (b.astype(np.int64) * 3735 + g.astype(np.int64) * 19235 + r.astype(np.int64) * 9798
         + 16384) >> 15
    return y.astype(b.dtype)


def _yuv_to_bgr(y, u, v, top):
    """``cv2.cvtColor``'s YUV2BGR of uint8 or uint16 planes (14-bit fixed
    point, saturated), which cv2 applies to an sYCC image's components."""
    y, u, v = (a.astype(np.int64) for a in (y, u, v))
    half = (top + 1) // 2
    u, v = u - half, v - half
    out = np.empty(y.shape + (3,), np.uint8 if top == 255 else np.uint16)
    for k, t in enumerate((u * 33292, v * -9519 + u * -6472, v * 18678)):
        out[:, :, k] = np.clip(y + ((t + 8192) >> 14), 0, top)
    return out


def _stack(planes):
    out = np.empty(planes[0].shape + (len(planes),), planes[0].dtype)
    for k, p in enumerate(planes):
        out[:, :, k] = p
    return out


def decode_jpeg2000(data: bytes, flags: int = IMREAD_COLOR):
    """JP2 or J2K bytes -> the array ``cv2.imdecode(data, flags)`` gives, or
    None where cv2 gives None (see the module)."""
    _check_flags(flags)
    info = None
    if data.startswith(JP2_SIGNATURE):
        cs, info = _read_jp2(data)
    else:
        cs = data
    planes, siz = _decode_components(cs, info["ihdr"] if info else None)
    # cv2 reads the codestream header's components ...
    comps = siz["comps"]
    if not 1 <= len(comps) <= 4 or any(c["sgnd"] for c in comps):
        return None
    maxprec = max(c["prec"] for c in comps)
    if maxprec < 8:
        return None
    if flags == IMREAD_COLOR:
        top, nch = 255, 3
    elif flags == IMREAD_GRAYSCALE:
        top, nch = 255, 1
    else:
        if maxprec > 16:
            return None  # cv2 asks for float samples it cannot fill
        top, nch = (255 if maxprec == 8 else 65535), len(comps)
    enumcs = info["enumcs"] if info else 0
    if enumcs in (12, 24):  # CMYK, e-sYCC: cv2 converts neither
        return None
    # ... and OpenJPEG's decoded image, after its palette and channel definitions
    if info is not None:
        _check_color(len(planes), info)
        planes = _apply_pclr(planes, info)
        if info["cdef"]:
            planes = _apply_cdef(planes, info["cdef"])
    if nch == 2:
        return None
    if siz["x0"] or siz["y0"] or any(c["dx"] != 1 or c["dy"] != 1 for c in comps):
        return None
    h, w = siz["y1"], siz["x1"]
    if any(p.shape != (h, w) for p in planes):
        return None
    shift = max(maxprec - (8 if top == 255 else 16), 0)
    depth = np.uint8 if top == 255 else np.uint16

    def conv(p):  # cv2 casts each sample to its type: the low bits, no saturation
        return ((p >> shift if shift else p) & top).astype(depth)

    n = len(planes)
    if enumcs == 17:  # greyscale
        if nch == 4:
            return None
        g = conv(planes[0])
        return g if nch == 1 else _stack([g, g, g])
    if enumcs == 18:  # sYCC
        if nch == 1:
            return conv(planes[0])
        if nch != 3 or n < 3:
            return None
        return _yuv_to_bgr(*(conv(p) for p in planes[:3]), top)
    # sRGB, or a colour space cv2 takes for sRGB
    if nch == 1:
        if n <= 2:
            return conv(planes[0])
        return _grey(conv(planes[2]), conv(planes[1]), conv(planes[0]))
    if n < 3:
        return None
    return _stack([conv(planes[c]) for c in ([2, 1, 0, 3] if nch == 4 else [2, 1, 0])])
