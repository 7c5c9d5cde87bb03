// Host code of utils/gif.py: a GIF image's LZW data, as OpenCV 5.0's own
// GIF reader (grfmt_gif.cpp) decodes it.  GIF's codes are packed LSB
// first into sub-blocks (a length byte, then that many bytes; a zero length
// ends the data); a clear code (1 << min_code) and the end code after it
// both reset the table and the code width (min_code + 1), and the decoding
// goes on after an end code up to the sub-blocks' end; the width grows by
// one when the next free code reaches 1 << width, up to 12 bits, and a full
// table (4096 codes) takes no more strings.
//
// cv2's rules past the image, read off its decodes: a string that runs
// past the image fails it; once the image is full, a code (other than
// clear and end) is not looked at, and a data byte read after such a code
// fails the image; a code after an end code, before a clear code and while
// the image is not full, reads the table cv2 freed at the end code (its
// output is undefined).
//
// Built with the host's C compiler by ops/_build.py (cc -O2 -shared -fPIC)
// and called through ctypes.

#include <stdint.h>

enum {
    GIF_OK = 0,
    GIF_TRUNCATED = 1,      // the file ends inside the sub-blocks
    GIF_BAD_CODE = 2,       // a code past the next free one, or a string code first
    GIF_SHORT = 3,          // fewer pixels than the image holds
    GIF_PAST_IMAGE = 4,     // a string past the image, or data after a code past it
    GIF_AFTER_END = 5,      // a code after an end code, the image not full
};

enum { MAX_CODES = 4096 };

// Decodes the sub-blocks at data[*pos] (after the min code size byte) into
// out[0, npix) and sets *pos past the terminating zero-length block.
// Codes past the next free one are faults while the image is not full.
int gif_lzw(const uint8_t* data, int64_t n, int64_t* pos, int min_code, uint8_t* out,
            int64_t npix) {
    static const int kMaxWidth = 12;
    uint16_t prefix[MAX_CODES];
    uint8_t suffix[MAX_CODES], first[MAX_CODES];
    uint16_t length[MAX_CODES];
    const int clear = 1 << min_code, end = clear + 1;
    for (int c = 0; c < clear; ++c) {
        prefix[c] = 0;
        suffix[c] = first[c] = (uint8_t)c;
        length[c] = 1;
    }
    int width = min_code + 1, next = clear + 2, prev = -1, after_end = 0;
    uint32_t bits = 0;
    int nbits = 0;
    int64_t idx = 0, p = *pos;
    for (;;) {
        if (p >= n) return GIF_TRUNCATED;
        int block = data[p++];
        if (block == 0) break;
        if (p + block > n) return GIF_TRUNCATED;
        for (int b = 0; b < block; ++b) {
            if (idx > npix) return GIF_PAST_IMAGE;
            bits |= (uint32_t)data[p++] << nbits;
            nbits += 8;
            while (nbits >= width) {
                int code = (int)(bits & ((1u << width) - 1));
                bits >>= width;
                nbits -= width;
                if (code == clear || code == end) {
                    width = min_code + 1;
                    next = clear + 2;
                    prev = -1;
                    after_end = code == end;
                    continue;
                }
                if (idx >= npix) {  // the image is full: the code is not looked at
                    ++idx;
                    continue;
                }
                if (after_end) return GIF_AFTER_END;
                if (prev < 0) {
                    if (code >= clear) return GIF_BAD_CODE;
                } else {
                    if (code > next) return GIF_BAD_CODE;
                    if (next < MAX_CODES) {  // the previous string and this one's first byte
                        prefix[next] = (uint16_t)prev;
                        suffix[next] = code < next ? first[code] : first[prev];
                        first[next] = first[prev];
                        length[next] = (uint16_t)(length[prev] + 1);
                        ++next;
                        if (next == (1 << width) && width < kMaxWidth) ++width;
                    }
                }
                int len = length[code];
                if (idx + len > npix) return GIF_PAST_IMAGE;
                int c = code;  // the string of code, written back to front
                for (int k = len - 1; k >= 0; --k) {
                    out[idx + k] = suffix[c];
                    c = prefix[c];
                }
                idx += len;
                prev = code;
            }
        }
    }
    *pos = p;
    return idx < npix ? GIF_SHORT : GIF_OK;
}
