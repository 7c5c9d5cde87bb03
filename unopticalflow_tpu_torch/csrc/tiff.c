// Host code of utils/tiff.py: the TIFF strip and tile codecs whose loops
// run a byte (or a code) at a time: PackBits (compression 32773) and LZW
// (compression 5, TIFF 6.0's MSB-first codes with the early change of the
// code width, as libtiff's tif_lzw.c decodes them).  Deflate goes through
// Python's zlib and JPEG through csrc/jpeg.c.
//
// Built with the host's C compiler by ops/_build.py (cc -O2 -shared -fPIC)
// and called through ctypes.

#include <stdint.h>
#include <string.h>

enum { TIFF_OK = 0, TIFF_SHORT = 1, TIFF_LZW_PAST_TABLE = 2, TIFF_LZW_OLD_STYLE = 3 };

// PackBits: a count byte n, then n + 1 literal bytes (n < 128) or 257 - n
// copies of the next byte (n > 128); 128 is a no-op.  Fills out[0, need);
// a run past the end is cut, as libtiff cuts it.  Returns TIFF_OK or
// TIFF_SHORT when the data ends first.
int packbits_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t need) {
    int64_t i = 0, o = 0;
    while (o < need) {
        if (i >= n) return TIFF_SHORT;
        int c = in[i++];
        if (c < 128) {
            int64_t k = c + 1;
            if (i + k > n) return TIFF_SHORT;
            if (k > need - o) k = need - o;
            memcpy(out + o, in + i, (size_t)k);
            i += c + 1;
            o += k;
        } else if (c > 128) {
            if (i >= n) return TIFF_SHORT;
            int64_t k = 257 - c;
            if (k > need - o) k = need - o;
            memset(out + o, in[i++], (size_t)k);
            o += k;
        }
    }
    return TIFF_OK;
}

#define LZW_CLEAR 256
#define LZW_EOI 257

// LZW, as tif_lzw.c's LZWDecode: codes of 9 to 12 bits, high bits first;
// the width grows when the next free entry reaches 2**width - 1.  Decodes
// until out[0, need) is full (the rest of the data is ignored); a code past
// the table is corrupt; the data or an EOI code ending before `need` bytes
// is short.
int lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t need) {
    static __thread uint16_t prefix[4096];
    static __thread uint8_t suffix[4096], first[4096];
    static __thread uint16_t length[4096];
    if (n >= 2 && in[0] == 0 && (in[1] & 1)) return TIFF_LZW_OLD_STYLE;
    for (int k = 0; k < 256; ++k) {
        suffix[k] = first[k] = (uint8_t)k;
        length[k] = 1;
    }
    int width = 9, next = 258, prev = -1;
    uint64_t buf = 0;
    int nbits = 0;
    int64_t i = 0, o = 0;
    while (o < need) {
        while (nbits < width) {
            if (i >= n) return TIFF_SHORT;
            buf = (buf << 8) | in[i++];
            nbits += 8;
        }
        int code = (int)((buf >> (nbits - width)) & ((1u << width) - 1));
        nbits -= width;
        if (code == LZW_EOI) return TIFF_SHORT;
        if (code == LZW_CLEAR) {
            width = 9;
            next = 258;
            prev = -1;
            continue;
        }
        if (prev < 0) {  // the first code after a clear: a literal
            if (code > 255) return TIFF_LZW_PAST_TABLE;
            out[o++] = (uint8_t)code;
            prev = code;
            continue;
        }
        if (code > next || next >= 4096) return TIFF_LZW_PAST_TABLE;
        // the new entry: prev's string and the first byte of code's (of
        // prev's own when code is the entry being made)
        prefix[next] = (uint16_t)prev;
        suffix[next] = first[code == next ? prev : code];
        first[next] = first[prev];
        length[next] = (uint16_t)(length[prev] + 1);
        ++next;
        if (next >= (1 << width) - 1 && width < 12) ++width;
        int len = length[code];
        int64_t end = o + len;
        // write the string backwards, keeping only what fits
        int c = code;
        for (int64_t p = end - 1; p >= o; --p) {
            if (p < need) out[p] = suffix[c];
            c = prefix[c];
        }
        o = end < need ? end : need;
        prev = code;
    }
    return TIFF_OK;
}
