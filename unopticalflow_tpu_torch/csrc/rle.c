// Host code of utils/rasters.py: the run-length loops of BMP (RLE8, RLE4)
// and Radiance HDR (the scanline RLE of Greg Ward's rgbe.c), each walked as
// OpenCV's reader walks it, so a file decodes to what cv2.imdecode gives.
//
// Each byte of these streams says how the next ones are read, a chain that
// numpy cannot take in bulk.  Built with the host's C compiler by
// ops/_build.py (cc -O2 -shared -fPIC) and called through ctypes.

#include <stdint.h>
#include <string.h>

enum { RLE_OK = 0, RLE_TRUNCATED = 1, RLE_PAST_ROW = 2, RLE_BAD_SCANLINE = 3 };

typedef struct {
    const uint8_t* d;
    int64_t n, pos;
    uint8_t* out;  // h rows of w palette indices, in the file's row order
    int64_t w, h, x, y;
} Bmp;

static int get_byte(Bmp* s, int* v) {
    if (s->pos >= s->n) return 0;
    *v = s->d[s->pos++];
    return 1;
}

// OpenCV's FillUniColor: `count` pixels of `v` from the cursor on, moving
// to the next row whenever one is full; stops after the last row.
static void fill_uni(Bmp* s, int64_t count, uint8_t v) {
    do {
        int64_t end = s->x + count;
        if (end > s->w) end = s->w;
        count -= end - s->x;
        if (s->y < s->h) memset(s->out + s->y * s->w + s->x, v, (size_t)(end - s->x));
        s->x = end;
        if (s->x >= s->w) {
            s->x = 0;
            if (++s->y >= s->h) break;
        }
    } while (count > 0);
}

// BMP RLE8 (rle4 = 0) or RLE4 (rle4 = 1) data from d[pos] on, as OpenCV's
// BmpDecoder::readData decodes it: an encoded run may not cross the row's
// end (RLE4: may not reach past it; RLE8: a run that fills the row moves on
// to the next, and an end-of-line code right after it is then ignored), an
// absolute run may not pass it, and the pixels an end-of-line, delta or
// end-of-bitmap code skips take palette index 0 (RLE4: the rest of the row
// only; the decode goes on after a code that leaves rows unfilled).  Returns RLE_OK, or
// RLE_TRUNCATED / RLE_PAST_ROW.
int bmp_rle(const uint8_t* d, int64_t n, int64_t pos, int rle4, int64_t w, int64_t h,
            uint8_t* out) {
    Bmp s = {d, n, pos, out, w, h, 0, 0};
    int line_end_flag = 0;
    for (;;) {
        int len, code;
        if (!get_byte(&s, &len) || !get_byte(&s, &code)) return RLE_TRUNCATED;
        if (len != 0) {  // encoded mode: len pixels
            if (s.x + len > w) return RLE_PAST_ROW;
            if (rle4) {  // the two nibbles in turn
                for (int k = 0; k < len; ++k)
                    s.out[s.y * w + s.x + k] = (uint8_t)(k & 1 ? code & 15 : code >> 4);
                s.x += len;
            } else {
                int64_t prev_y = s.y;
                fill_uni(&s, len, (uint8_t)code);
                line_end_flag = (int)(s.y - prev_y);
                if (s.y >= h) break;
            }
        } else if (code > 2) {  // absolute mode: code pixels, padded to 16 bits
            if (s.x + code > w) return RLE_PAST_ROW;
            int64_t sz = rle4 ? ((((code + 1) >> 1) + 1) & ~1) : ((code + 1) & ~1);
            if (s.pos + sz > n) return RLE_TRUNCATED;
            const uint8_t* src = d + s.pos;
            for (int k = 0; k < code; ++k)
                s.out[s.y * w + s.x + k] =
                    rle4 ? (uint8_t)(k & 1 ? src[k >> 1] & 15 : src[k >> 1] >> 4) : src[k];
            s.pos += sz;
            s.x += code;
            line_end_flag = 0;
            if (s.y >= h) break;
        } else {  // 0: end of line, 1: end of bitmap, 2: delta
            int64_t shift = w - s.x, y_shift = h - s.y;
            if (rle4 || code || !line_end_flag || shift < w) {
                if (code == 2) {
                    int dx, dy;
                    if (!get_byte(&s, &dx) || !get_byte(&s, &dy)) return RLE_TRUNCATED;
                    shift = dx;
                    y_shift = dy;
                }
                // OpenCV's RLE4 loop passes on the columns only: a delta's
                // rows and the rows after an end-of-bitmap code are not filled
                if (code != 0 && !rle4) shift += y_shift * w;
                if (s.y >= h) break;
                fill_uni(&s, shift, 0);
                if (s.y >= h) break;
            }
            line_end_flag = 0;
            if (s.y >= h) break;
        }
    }
    return RLE_OK;
}

// Radiance RGBE pixels from d[pos] on, as rgbe.c's RGBE_ReadPixels_RLE
// reads them: rows narrower than 8 or wider than 32767 pixels, or a first
// row that does not open with 2, 2, are flat RGBE quadruples to the end;
// else each row is four planes of runs (a count above 128: that many
// copies of the next byte; else that many literal bytes).  out: h * w * 4
// RGBE bytes.  Returns RLE_OK, RLE_TRUNCATED or RLE_BAD_SCANLINE.
int hdr_rle(const uint8_t* d, int64_t n, int64_t pos, int64_t w, int64_t h, uint8_t* out) {
    const int64_t total = w * h * 4;
    if (w < 8 || w > 0x7fff) {
        if (pos + total > n) return RLE_TRUNCATED;
        memcpy(out, d + pos, (size_t)total);
        return RLE_OK;
    }
    for (int64_t row = 0; row < h; ++row) {
        uint8_t* o = out + row * w * 4;
        if (pos + 4 > n) return RLE_TRUNCATED;
        const uint8_t* q = d + pos;
        if (q[0] != 2 || q[1] != 2 || (q[2] & 0x80)) {  // flat from here on
            int64_t rest = total - row * w * 4;
            if (pos + rest > n) return RLE_TRUNCATED;
            memcpy(o, q, (size_t)rest);
            return RLE_OK;
        }
        if (((int64_t)q[2] << 8 | q[3]) != w) return RLE_BAD_SCANLINE;
        pos += 4;
        for (int c = 0; c < 4; ++c) {
            int64_t x = 0;
            while (x < w) {
                if (pos + 2 > n) return RLE_TRUNCATED;
                int count = d[pos], v = d[pos + 1];
                pos += 2;
                if (count > 128) {
                    count -= 128;
                    if (count > w - x) return RLE_BAD_SCANLINE;
                    for (int k = 0; k < count; ++k) o[(x + k) * 4 + c] = (uint8_t)v;
                } else {
                    if (count == 0 || count > w - x) return RLE_BAD_SCANLINE;
                    if (pos + count - 1 > n) return RLE_TRUNCATED;
                    o[x * 4 + c] = (uint8_t)v;
                    for (int k = 1; k < count; ++k) o[(x + k) * 4 + c] = d[pos + k - 1];
                    pos += count - 1;
                }
                x += count;
            }
        }
    }
    return RLE_OK;
}
