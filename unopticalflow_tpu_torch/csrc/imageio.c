// Host code of utils/imageio.py: PNG row unfiltering and cv2's INTER_LINEAR
// resize of uint8 images.
//
// Not kernels: each pixel of a PNG row filtered Sub, Average or Paeth needs
// its left neighbour's result, a chain that runs byte by byte, and the
// resize's fixed-point sums take numpy a few passes over large temporaries.
// Built with the host's C compiler by ops/_build.py (cc -O2 -shared -fPIC)
// and called through ctypes, which lets go of Python's interpreter lock, so
// the loader's threads decode and resize in parallel.

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

// Without branches: which of a, b, c it picks depends on the data.
static inline int paeth(int a, int b, int c) {
    int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
    int bc = pb <= pc ? b : c;
    return ((pa <= pb) & (pa <= pc)) ? a : bc;
}

// raw: h rows of 1 + row_bytes bytes (the filter type, then the filtered
// bytes); out: h rows of row_bytes.  bpp: bytes per whole pixel (at least 1).
// Returns 0, 1 + the index of the first row whose filter type is unknown, or
// -1 when memory runs out.
int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h, int64_t row_bytes, int bpp) {
    uint8_t* zeros = calloc((size_t)row_bytes + 1, 1);  // the row above the first
    if (zeros == NULL) return -1;
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t kind = raw[r * (row_bytes + 1)];
        const uint8_t* in = raw + r * (row_bytes + 1) + 1;
        uint8_t* cur = out + r * row_bytes;
        const uint8_t* up = r > 0 ? cur - row_bytes : zeros;
        const int64_t lead = bpp < row_bytes ? bpp : row_bytes;  // bytes with no left pixel
        int64_t x;
        switch (kind) {
            case 0:  // None
                memcpy(cur, in, (size_t)row_bytes);
                break;
            case 1:  // Sub
                memcpy(cur, in, (size_t)lead);
                for (x = lead; x < row_bytes; ++x) cur[x] = (uint8_t)(in[x] + cur[x - bpp]);
                break;
            case 2:  // Up
                for (x = 0; x < row_bytes; ++x) cur[x] = (uint8_t)(in[x] + up[x]);
                break;
            case 3:  // Average
                for (x = 0; x < lead; ++x) cur[x] = (uint8_t)(in[x] + (up[x] >> 1));
                for (; x < row_bytes; ++x) cur[x] = (uint8_t)(in[x] + ((cur[x - bpp] + up[x]) >> 1));
                break;
            case 4:  // Paeth: with no left pixel, the prediction is the byte above
                for (x = 0; x < lead; ++x) cur[x] = (uint8_t)(in[x] + up[x]);
                for (; x < row_bytes; ++x)
                    cur[x] = (uint8_t)(in[x] + paeth(cur[x - bpp], up[x], up[x - bpp]));
                break;
            default:
                free(zeros);
                return (int)(r + 1);
        }
    }
    free(zeros);
    return 0;
}

// cv2.resize(src, (dw, dh), interpolation=INTER_LINEAR) of uint8 (sh, sw, ch)
// into (dh, dw, ch), with the taps and 11-bit weights utils/imageio.py works
// out as cv2 does: output column x reads source columns x0[x], x1[x] with
// weights a0[x], a1[x]; output row y reads source rows y0[y], y1[y] with
// weights b0[y], b1[y].  The horizontal sums, each below 255 * 2048, are
// shifted right by 4, and the vertical pass rounds as cv2's vector code:
// ((S0 * b0) >> 16) + ((S1 * b1) >> 16), plus 2, shifted right by 2.  Returns 0.
int resize_linear_u8(const uint8_t* src, int64_t sw, int ch, uint8_t* dst, int64_t dh,
                      int64_t dw, const int32_t* x0, const int32_t* x1, const int32_t* a0,
                      const int32_t* a1, const int32_t* y0, const int32_t* y1,
                      const int32_t* b0, const int32_t* b1) {
    for (int64_t y = 0; y < dh; ++y) {
        const uint8_t* r0 = src + (int64_t)y0[y] * sw * ch;
        const uint8_t* r1 = src + (int64_t)y1[y] * sw * ch;
        uint8_t* out = dst + y * dw * ch;
        for (int64_t x = 0; x < dw; ++x) {
            const int64_t p0 = (int64_t)x0[x] * ch, p1 = (int64_t)x1[x] * ch;
            for (int c = 0; c < ch; ++c) {
                int32_t s0 = (r0[p0 + c] * a0[x] + r0[p1 + c] * a1[x]) >> 4;
                int32_t s1 = (r1[p0 + c] * a0[x] + r1[p1 + c] * a1[x]) >> 4;
                int32_t v = (((s0 * b0[y]) >> 16) + ((s1 * b1[y]) >> 16) + 2) >> 2;
                out[x * ch + c] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
            }
        }
    }
    return 0;
}
