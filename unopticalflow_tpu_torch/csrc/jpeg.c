// Host code of utils/imageio.py: a baseline JPEG decoder that gives what
// cv2.imdecode gives, bit for bit, where OpenCV decodes with libjpeg-turbo.
//
// Sequential DCT with Huffman coding, 8-bit samples (SOF0 and SOF1), one or
// three components (grey, YCbCr), any size, restart intervals, and several
// scans.  Each step follows libjpeg's default decompression arithmetic:
// the integer "islow" IDCT of jidctint.c with its range-limit table,
// jdsample.c's fancy upsampling (h2v1 and h2v2 triangle filters, and
// libjpeg-turbo's h1v2 for 4:4:0; plain replication where libjpeg falls
// back to it, as for 4:1:1 or a chroma plane at most 2 samples wide), the
// edge rows libjpeg repeats at the top and bottom of a component, and
// jdcolor.c's fixed-point YCbCr -> BGR tables.  Progressive, lossless,
// hierarchical, arithmetic-coded and 12-bit files, CMYK and RGB-coded
// files, and a truncated or corrupt file are refused with a message that
// names the mode or the fault.  The Exif orientation is applied by
// utils/imageio.py.
//
// Built with the host's C compiler by ops/_build.py (cc -O2 -shared -fPIC)
// and called through ctypes, which lets go of Python's interpreter lock.

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

// zigzag index -> natural (row-major) index; 16 extra entries so a corrupt
// run cannot index past the block, as in libjpeg
static const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define LOOK_BITS 9

typedef struct {
    int present;
    uint8_t vals[256];
    int32_t maxcode[17];  // largest code of each length, -1 where none
    int32_t valoff[17];   // vals index of a length's first code, less that code
    uint8_t look_len[1 << LOOK_BITS];  // codes of at most LOOK_BITS bits
    uint8_t look_val[1 << LOOK_BITS];
} Huff;

typedef struct {
    int id, h, v, tq;
    int dw, dh;        // downsampled width and height (samples)
    int bw, bh;        // blocks allocated: whole MCUs
    int16_t* coef;     // bw * bh blocks of 64, natural order
    int dc, ac, pred;  // the scan's tables and the DC prediction
    int seen;          // in a scan yet
    uint8_t* plane;    // bw * 8 x bh * 8 samples after the IDCT
} Comp;

typedef struct {
    const uint8_t* d;
    int64_t n, pos;
    uint16_t q[4][64];  // natural order
    int qset[4];
    Huff dc[4], ac[4];
    int width, height, ncomp, hmax, vmax, mcusx, mcusy, sof;
    Comp c[4];
    int restart, jfif, adobe, adobe_transform;
    uint64_t buf;  // bit reader
    int nbits, padded, marker;
    char* err;
    int errlen;
    jmp_buf jb;
} Dec;

static void fail(Dec* d, const char* fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(d->err, (size_t)d->errlen, fmt, ap);
    va_end(ap);
    longjmp(d->jb, 1);
}

static int byte_at(Dec* d) {
    if (d->pos >= d->n) fail(d, "truncated JPEG file (data ends at byte %lld)", (long long)d->n);
    return d->d[d->pos++];
}

static int u16_at(Dec* d) {
    int hi = byte_at(d);
    return (hi << 8) | byte_at(d);
}

// ---------------------------------------------------------------------------
// markers
// ---------------------------------------------------------------------------

static void read_dqt(Dec* d, int64_t end) {
    while (d->pos < end) {
        int pq = byte_at(d), tq = pq & 15;
        if (tq > 3) fail(d, "corrupt JPEG: quantisation table %d", tq);
        for (int i = 0; i < 64; ++i) d->q[tq][kNatural[i]] = (uint16_t)((pq >> 4) ? u16_at(d) : byte_at(d));
        d->qset[tq] = 1;
    }
}

static void build_huff(Dec* d, Huff* t, const uint8_t* counts, int nvals) {
    // canonical codes (JPEG Annex C): codes of each length count up from
    // twice the last length's next code
    int code = 0, k = 0;
    memset(t->look_len, 0, sizeof t->look_len);
    for (int l = 1; l <= 16; ++l) {
        t->valoff[l] = k - code;
        for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
            // no code may be all ones, nor run past its length (libjpeg's
            // check, made before the code indexes the lookup table)
            if (code + 1 >= (1 << l)) fail(d, "corrupt JPEG: bad Huffman table");
            if (l <= LOOK_BITS) {
                int shift = LOOK_BITS - l;
                for (int j = 0; j < (1 << shift); ++j) {
                    t->look_len[(code << shift) | j] = (uint8_t)l;
                    t->look_val[(code << shift) | j] = t->vals[k];
                }
            }
        }
        t->maxcode[l] = counts[l] ? code - 1 : -1;
        code <<= 1;
    }
    if (k != nvals) fail(d, "corrupt JPEG: bad Huffman table");
    t->present = 1;
}

static void read_dht(Dec* d, int64_t end) {
    while (d->pos < end) {
        int tc_th = byte_at(d), tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3) fail(d, "corrupt JPEG: Huffman table class %d slot %d", tc, th);
        uint8_t counts[17] = {0};
        int total = 0;
        for (int l = 1; l <= 16; ++l) total += counts[l] = (uint8_t)byte_at(d);
        if (total > 256) fail(d, "corrupt JPEG: bad Huffman table");
        Huff* t = tc ? &d->ac[th] : &d->dc[th];
        for (int i = 0; i < total; ++i) t->vals[i] = (uint8_t)byte_at(d);
        build_huff(d, t, counts, total);
    }
}

static void read_sof(Dec* d, int marker) {
    if (d->sof) fail(d, "corrupt JPEG: a second frame header");
    int precision = byte_at(d);
    if (precision != 8)
        fail(d, "%d-bit JPEG (SOF%d) is not supported: the port reads 8-bit samples", precision,
             marker - 0xC0);
    d->height = u16_at(d);
    d->width = u16_at(d);
    d->ncomp = byte_at(d);
    if (d->height == 0) fail(d, "JPEG with its height in a DNL marker is not supported");
    if (d->width == 0) fail(d, "corrupt JPEG: width 0");
    if ((int64_t)d->width * d->height > ((int64_t)1 << 30))  // cv2's CV_IO_MAX_IMAGE_PIXELS
        fail(d, "JPEG of %dx%d pixels is larger than 2**30 pixels", d->width, d->height);
    if (d->ncomp == 4) fail(d, "CMYK/YCCK (4-component) JPEG is not supported");
    if (d->ncomp != 1 && d->ncomp != 3)
        fail(d, "%d-component JPEG is not supported: the port reads grey and YCbCr", d->ncomp);
    for (int i = 0; i < d->ncomp; ++i) {
        Comp* c = &d->c[i];
        c->id = byte_at(d);
        int hv = byte_at(d);
        c->h = hv >> 4;
        c->v = hv & 15;
        c->tq = byte_at(d);
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
            fail(d, "corrupt JPEG: component %d sampling %dx%d, table %d", i, c->h, c->v, c->tq);
        if (c->h > d->hmax) d->hmax = c->h;
        if (c->v > d->vmax) d->vmax = c->v;
    }
    d->mcusx = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
    d->mcusy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
    for (int i = 0; i < d->ncomp; ++i) {
        Comp* c = &d->c[i];
        c->dw = (int)(((int64_t)d->width * c->h + d->hmax - 1) / d->hmax);
        c->dh = (int)(((int64_t)d->height * c->v + d->vmax - 1) / d->vmax);
        c->bw = d->mcusx * c->h;
        c->bh = d->mcusy * c->v;
    }
    d->sof = marker;
}

static void read_app(Dec* d, int marker, int64_t end) {
    const uint8_t* p = d->d + d->pos;
    int64_t len = end - d->pos;
    if (marker == 0xE0 && len >= 5 && memcmp(p, "JFIF\0", 5) == 0) d->jfif = 1;
    if (marker == 0xEE && len >= 12 && memcmp(p, "Adobe", 5) == 0) {
        d->adobe = 1;
        d->adobe_transform = p[11];
    }
}

// ---------------------------------------------------------------------------
// entropy-coded data
// ---------------------------------------------------------------------------

// At least `need` (<= 32) bits in the buffer.  A marker ends the segment: the
// bits after it read as zeros, counted in `padded`, which the data must not
// reach (checked after each block).
static void fill(Dec* d, int need) {
    while (d->nbits < need) {
        int b = 0;
        if (!d->marker) {
            if (d->pos >= d->n) fail(d, "truncated JPEG file (data ends inside a scan)");
            b = d->d[d->pos];
            if (b == 0xFF) {
                int64_t p = d->pos + 1;
                while (p < d->n && d->d[p] == 0xFF) ++p;  // fill bytes
                if (p >= d->n) fail(d, "truncated JPEG file (data ends inside a scan)");
                if (d->d[p] == 0) {
                    d->pos = p + 1;
                } else {
                    d->marker = d->d[p];  // pos stays on the marker's 0xFF
                    b = 0;
                }
            } else {
                d->pos++;
            }
        }
        if (d->marker) d->padded += 8;
        d->buf = (d->buf << 8) | (uint64_t)b;
        d->nbits += 8;
    }
}

static inline int get_bits(Dec* d, int n) {
    if (n == 0) return 0;
    fill(d, n);
    d->nbits -= n;
    return (int)((d->buf >> d->nbits) & ((1u << n) - 1));
}

static inline int extend(int v, int n) { return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v; }

static int decode_huff(Dec* d, const Huff* t) {
    fill(d, 16);
    uint32_t look = (uint32_t)(d->buf >> (d->nbits - 16)) & 0xFFFF;
    int l = t->look_len[look >> (16 - LOOK_BITS)];
    if (l) {
        d->nbits -= l;
        return t->look_val[look >> (16 - LOOK_BITS)];
    }
    for (l = LOOK_BITS + 1; l <= 16; ++l) {
        int32_t code = (int32_t)(look >> (16 - l));
        if (code <= t->maxcode[l]) {
            d->nbits -= l;
            return t->vals[t->valoff[l] + code];
        }
    }
    fail(d, "corrupt JPEG: bad Huffman code");
    return 0;
}

static void decode_block(Dec* d, Comp* c, int16_t* blk) {
    const Huff* dc = &d->dc[c->dc];
    const Huff* ac = &d->ac[c->ac];
    int s = decode_huff(d, dc);
    if (s > 15) fail(d, "corrupt JPEG: DC magnitude %d", s);
    int diff = s ? extend(get_bits(d, s), s) : 0;
    c->pred += diff;
    blk[0] = (int16_t)c->pred;
    for (int k = 1; k < 64; ++k) {
        int rs = decode_huff(d, ac), r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            blk[kNatural[k]] = (int16_t)extend(get_bits(d, s), s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    if (d->nbits < d->padded)
        fail(d, "corrupt or truncated JPEG: a marker inside the data of a block");
}

// The marker that ends an entropy-coded segment: 0xFF, fill bytes, the code.
static int next_marker(Dec* d) {
    for (;;) {
        int b = byte_at(d);
        if (b != 0xFF) continue;  // bytes before a marker are skipped, as libjpeg does
        do b = byte_at(d); while (b == 0xFF);
        if (b != 0) return b;
    }
}

static void restart(Dec* d, int* next_rst) {
    d->buf = 0;
    d->nbits = d->padded = 0;
    d->marker = 0;
    int m = next_marker(d);
    if (m != 0xD0 + *next_rst)
        fail(d, "corrupt JPEG: expected restart marker RST%d, found 0x%02X", *next_rst, m);
    *next_rst = (*next_rst + 1) & 7;
}

// The scan header up to `end`, then its entropy-coded data; leaves pos on
// the marker after the data.
static void read_sos(Dec* d, int64_t end) {
    if (!d->sof) fail(d, "corrupt JPEG: scan before the frame header");
    int ns = byte_at(d);
    if (ns < 1 || ns > d->ncomp) fail(d, "corrupt JPEG: %d components in a scan", ns);
    Comp* sc[4];
    int blocks = 0;
    for (int i = 0; i < ns; ++i) {
        int id = byte_at(d), tables = byte_at(d);
        sc[i] = NULL;
        for (int j = 0; j < d->ncomp; ++j)
            if (d->c[j].id == id) sc[i] = &d->c[j];
        if (sc[i] == NULL) fail(d, "corrupt JPEG: scan names component %d", id);
        sc[i]->dc = tables >> 4;
        sc[i]->ac = tables & 15;
        if (sc[i]->dc > 3 || sc[i]->ac > 3 || !d->dc[sc[i]->dc].present ||
            !d->ac[sc[i]->ac].present)
            fail(d, "corrupt JPEG: scan uses an undefined Huffman table");
        if (!d->qset[sc[i]->tq]) fail(d, "corrupt JPEG: undefined quantisation table");
        sc[i]->pred = 0;
        sc[i]->seen = 1;
        blocks += sc[i]->h * sc[i]->v;
        if (sc[i]->coef == NULL) {
            sc[i]->coef = calloc((size_t)sc[i]->bw * sc[i]->bh * 64, sizeof(int16_t));
            if (sc[i]->coef == NULL) fail(d, "out of memory");
        }
    }
    int ss = byte_at(d), se = byte_at(d), a = byte_at(d);
    if (ss != 0 || se != 63 || a != 0)
        fail(d, "corrupt JPEG: sequential scan with spectral range %d..%d", ss, se);
    if (ns > 1 && blocks > 10) fail(d, "corrupt JPEG: %d blocks in an MCU", blocks);
    if (d->pos != end) fail(d, "corrupt JPEG: scan header of the wrong length");

    d->buf = 0;
    d->nbits = d->padded = d->marker = 0;
    int next_rst = 0, todo = d->restart;
    if (ns == 1) {  // non-interleaved: one block an MCU over the component's own blocks
        Comp* c = sc[0];
        int nx = (c->dw + 7) / 8, ny = (c->dh + 7) / 8;
        for (int by = 0; by < ny; ++by)
            for (int bx = 0; bx < nx; ++bx) {
                if (d->restart) {
                    if (todo == 0) {
                        restart(d, &next_rst);
                        c->pred = 0;
                        todo = d->restart;
                    }
                    --todo;
                }
                decode_block(d, c, c->coef + ((int64_t)by * c->bw + bx) * 64);
            }
    } else {
        for (int my = 0; my < d->mcusy; ++my)
            for (int mx = 0; mx < d->mcusx; ++mx) {
                if (d->restart) {
                    if (todo == 0) {
                        restart(d, &next_rst);
                        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
                        todo = d->restart;
                    }
                    --todo;
                }
                for (int i = 0; i < ns; ++i) {
                    Comp* c = sc[i];
                    for (int v = 0; v < c->v; ++v)
                        for (int h = 0; h < c->h; ++h) {
                            int64_t b = (int64_t)(my * c->v + v) * c->bw + mx * c->h + h;
                            decode_block(d, c, c->coef + b * 64);
                        }
                }
            }
    }
    d->buf = 0;
    d->nbits = d->padded = d->marker = 0;
}

// ---------------------------------------------------------------------------
// jidctint.c: the integer IDCT, and the range limit that follows it
// ---------------------------------------------------------------------------

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

// libjpeg's post-IDCT table: limit[x & 1023] is x + 128 clamped to 0..255
// for -512 <= x < 512, and wraps as libjpeg's does beyond
static uint8_t kLimit[1024];

static void init_limit(void) {
    for (int i = 0; i < 1024; ++i)
        kLimit[i] = (uint8_t)(i < 128 ? i + 128 : (i < 512 ? 255 : (i < 896 ? 0 : i - 896)));
}

// One 1-D pass of jidctint.c on 8 dequantised values: out[] before descaling.
static inline void idct_1d(const int64_t* t, int64_t* out) {
    int64_t z2 = t[2], z3 = t[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (t[0] + t[4]) * ((int64_t)1 << CONST_BITS);
    int64_t tmp1 = (t[0] - t[4]) * ((int64_t)1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = t[7];
    tmp1 = t[5];
    tmp2 = t[3];
    tmp3 = t[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    out[0] = tmp10 + tmp3;
    out[7] = tmp10 - tmp3;
    out[1] = tmp11 + tmp2;
    out[6] = tmp11 - tmp2;
    out[2] = tmp12 + tmp1;
    out[5] = tmp12 - tmp1;
    out[3] = tmp13 + tmp0;
    out[4] = tmp13 - tmp0;
}

static void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int64_t stride) {
    int ws[64];
    int64_t t[8], o[8];
    for (int col = 0; col < 8; ++col) {  // pass 1: columns, scaled by 2**PASS1_BITS
        const int16_t* in = coef + col;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            int dc = (int)((int32_t)in[0] * q[col]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dc;
            continue;
        }
        for (int r = 0; r < 8; ++r) t[r] = (int64_t)((int32_t)in[r * 8] * q[r * 8 + col]);
        idct_1d(t, o);
        for (int r = 0; r < 8; ++r) ws[r * 8 + col] = (int)DESCALE(o[r], CONST_BITS - PASS1_BITS);
    }
    for (int row = 0; row < 8; ++row) {  // pass 2: rows, descaled by 8 and PASS1_BITS
        const int* w = ws + row * 8;
        uint8_t* dst = out + row * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t dc = kLimit[(int)DESCALE((int64_t)w[0], PASS1_BITS + 3) & 1023];
            memset(dst, dc, 8);
            continue;
        }
        for (int k = 0; k < 8; ++k) t[k] = w[k];
        idct_1d(t, o);
        for (int k = 0; k < 8; ++k)
            dst[k] = kLimit[(int)DESCALE(o[k], CONST_BITS + PASS1_BITS + 3) & 1023];
    }
}

// ---------------------------------------------------------------------------
// jdsample.c: upsampling of a component plane to (H, W), cropped
// ---------------------------------------------------------------------------

static void upsample(const Dec* d, const Comp* c, uint8_t* out, uint8_t* row) {
    const int W = d->width, H = d->height, dw = c->dw, dh = c->dh;
    const int64_t ps = (int64_t)c->bw * 8;
    const uint8_t* p = c->plane;
    const int he = d->hmax / c->h, ve = d->vmax / c->v;
    // libjpeg's choice: fancy filters for 2x1 and 2x2 wider than 2 samples,
    // and 1x2; replication otherwise
    const int h2v1 = he == 2 && ve == 1 && dw > 2, h2v2 = he == 2 && ve == 2 && dw > 2;
    const int h1v2 = he == 1 && ve == 2;
    for (int y = 0; y < H; ++y) {
        uint8_t* dst = out + (int64_t)y * W;
        if (he == 1 && ve == 1) {
            memcpy(dst, p + y * ps, (size_t)W);
        } else if (h2v1) {
            const uint8_t* in = p + y * ps;
            row[0] = in[0];
            row[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
            for (int x = 1; x < dw - 1; ++x) {
                int v = in[x] * 3;
                row[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
                row[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
            }
            row[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
            row[2 * dw - 1] = in[dw - 1];
            memcpy(dst, row, (size_t)W);
        } else if (h2v2 || h1v2) {
            // the nearer input row, and the next nearer one above (even output
            // rows) or below (odd), repeated at the component's edges
            int r = y / 2, odd = y & 1;
            int r1 = odd ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
            const uint8_t* in0 = p + r * ps;
            const uint8_t* in1 = p + r1 * ps;
            if (h1v2) {
                int bias = odd ? 2 : 1;
                for (int x = 0; x < W; ++x) dst[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
            } else {
                int this = in0[0] * 3 + in1[0], next = in0[1] * 3 + in1[1], last;
                row[0] = (uint8_t)((this * 4 + 8) >> 4);
                row[1] = (uint8_t)((this * 3 + next + 7) >> 4);
                last = this;
                this = next;
                for (int x = 1; x < dw - 1; ++x) {
                    next = in0[x + 1] * 3 + in1[x + 1];
                    row[2 * x] = (uint8_t)((this * 3 + last + 8) >> 4);
                    row[2 * x + 1] = (uint8_t)((this * 3 + next + 7) >> 4);
                    last = this;
                    this = next;
                }
                row[2 * dw - 2] = (uint8_t)((this * 3 + last + 8) >> 4);
                row[2 * dw - 1] = (uint8_t)((this * 4 + 7) >> 4);
                memcpy(dst, row, (size_t)W);
            }
        } else {  // int_upsample: each sample repeated he x ve times
            const uint8_t* in = p + (y / ve) * ps;
            for (int x = 0; x < W; ++x) dst[x] = in[x / he];
        }
    }
}

// ---------------------------------------------------------------------------
// the entry points
// ---------------------------------------------------------------------------

static void free_dec(Dec* d) {
    for (int i = 0; i < 4; ++i) {
        free(d->c[i].coef);
        free(d->c[i].plane);
    }
}

// Reads the markers up to EOI, decoding every scan when `decode` is set.
static void parse(Dec* d, int decode) {
    if (d->n < 2 || d->d[0] != 0xFF || d->d[1] != 0xD8) fail(d, "not a JPEG file (no SOI marker)");
    d->pos = 2;
    for (;;) {
        int m = next_marker(d);
        if (m == 0xD9) break;  // EOI
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // no length
        if (m == 0xD8) fail(d, "corrupt JPEG: a second SOI marker");
        int64_t start = d->pos, len = u16_at(d);
        if (len < 2) fail(d, "corrupt JPEG: marker 0x%02X of length %lld", m, (long long)len);
        int64_t end = start + len;
        if (end > d->n) fail(d, "truncated JPEG file (marker 0x%02X runs past the end)", m);
        switch (m) {
            case 0xC0:
            case 0xC1:
                read_sof(d, m);
                if (!decode) return;
                break;
            case 0xC2:
                fail(d, "progressive JPEG (SOF2) is not supported: the port reads baseline JPEG");
            case 0xC3:
                fail(d, "lossless JPEG (SOF3) is not supported: the port reads baseline JPEG");
            case 0xC5:
            case 0xC6:
            case 0xC7:
                fail(d, "hierarchical JPEG (SOF%d) is not supported: the port reads baseline JPEG",
                     m - 0xC0);
            case 0xC9:
            case 0xCA:
            case 0xCB:
            case 0xCD:
            case 0xCE:
            case 0xCF:
                fail(d, "arithmetic-coded JPEG (SOF%d) is not supported: the port reads "
                     "Huffman-coded baseline JPEG", m - 0xC0);
            case 0xC4:
                read_dht(d, end);
                break;
            case 0xDB:
                read_dqt(d, end);
                break;
            case 0xDD:
                d->restart = u16_at(d);
                break;
            case 0xDA:
                read_sos(d, end);
                continue;  // pos is on the marker after the scan's data
            default:
                if (m >= 0xE0 && m <= 0xEF) read_app(d, m, end);
                break;
        }
        if (d->pos > end) fail(d, "corrupt JPEG: marker 0x%02X overruns its length", m);
        d->pos = end;
    }
    if (!d->sof) fail(d, "corrupt JPEG: no frame header");
}

// info = [width, height, components]; returns 0, or 1 with a message in err.
int jpeg_info(const uint8_t* data, int64_t n, int64_t* info, char* err, int errlen) {
    Dec* d = calloc(1, sizeof(Dec));
    if (d == NULL) return 1;
    d->d = data;
    d->n = n;
    d->err = err;
    d->errlen = errlen;
    int rc = 0;
    if (setjmp(d->jb) == 0) {
        parse(d, 0);
        if (!d->sof) fail(d, "corrupt JPEG: no frame header");
        info[0] = d->width;
        info[1] = d->height;
        info[2] = d->ncomp;
    } else {
        rc = 1;
    }
    free_dec(d);
    free(d);
    return rc;
}

// Decodes into out: (H, W, 3) BGR when grey == 0 (a grey file repeated), or
// (H, W) when grey == 1 (a colour file's Y).  Returns 0, or 1 with a message.
int jpeg_decode(const uint8_t* data, int64_t n, int grey, uint8_t* out, char* err, int errlen) {
    static int limit_ready = 0;
    if (!limit_ready) {  // idempotent: a race only writes the same bytes twice
        init_limit();
        limit_ready = 1;
    }
    Dec* d = calloc(1, sizeof(Dec));
    if (d == NULL) return 1;
    d->d = data;
    d->n = n;
    d->err = err;
    d->errlen = errlen;
    uint8_t *planes = NULL, *row = NULL;
    int rc = 0;
    if (setjmp(d->jb) == 0) {
        parse(d, 1);
        if (d->ncomp == 3) {
            int rgb_ids = d->c[0].id == 82 && d->c[1].id == 71 && d->c[2].id == 66;
            if (!d->jfif && ((d->adobe && d->adobe_transform == 0) || (!d->adobe && rgb_ids)))
                fail(d, "RGB-coded JPEG (no YCbCr transform) is not supported");
        }
        const int W = d->width, H = d->height, nout = (grey || d->ncomp == 1) ? 1 : 3;
        for (int i = 0; i < d->ncomp; ++i) {
            Comp* c = &d->c[i];
            if (!c->seen) fail(d, "corrupt JPEG: component %d is in no scan", c->id);
            if (d->hmax % c->h || d->vmax % c->v)
                fail(d, "JPEG sampling %dx%d of %dx%d is not supported", c->h, c->v, d->hmax,
                     d->vmax);
            if (i >= nout) continue;
            c->plane = malloc((size_t)c->bw * 8 * c->bh * 8);
            if (c->plane == NULL) fail(d, "out of memory");
            const int64_t ps = (int64_t)c->bw * 8;
            for (int by = 0; by < c->bh; ++by)
                for (int bx = 0; bx < c->bw; ++bx)
                    idct_islow(c->coef + ((int64_t)by * c->bw + bx) * 64, d->q[c->tq],
                               c->plane + (int64_t)by * 8 * ps + bx * 8, ps);
        }
        planes = malloc((size_t)W * H * nout);
        row = malloc((size_t)W * 2 + 16 + (size_t)d->hmax * 8);
        if (planes == NULL || row == NULL) fail(d, "out of memory");
        for (int i = 0; i < nout; ++i) upsample(d, &d->c[i], planes + (int64_t)i * W * H, row);
        const int64_t np = (int64_t)W * H;
        if (nout == 1 && grey) {
            memcpy(out, planes, (size_t)np);
        } else if (nout == 1) {
            for (int64_t i = 0; i < np; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = planes[i];
        } else {
            // jdcolor.c: R = Y + Cr_r[Cr], B = Y + Cb_b[Cb], G = Y + (Cb_g[Cb] +
            // Cr_g[Cr]) >> 16, from tables rounded as libjpeg rounds them
            int cr_r[256], cb_b[256];
            int64_t cr_g[256], cb_g[256];
            const int64_t half = (int64_t)1 << 15;
            for (int i = 0; i < 256; ++i) {
                int64_t x = i - 128;
                cr_r[i] = (int)((91881 * x + half) >> 16);    // FIX(1.40200)
                cb_b[i] = (int)((116130 * x + half) >> 16);   // FIX(1.77200)
                cr_g[i] = -46802 * x;                         // FIX(0.71414)
                cb_g[i] = -22554 * x + half;                  // FIX(0.34414)
            }
            const uint8_t *py = planes, *pb = planes + np, *pr = planes + 2 * np;
            for (int64_t i = 0; i < np; ++i) {
                int y = py[i], cb = pb[i], cr = pr[i];
                int r = y + cr_r[cr], g = y + (int)((cb_g[cb] + cr_g[cr]) >> 16), b = y + cb_b[cb];
                out[3 * i] = (uint8_t)(b < 0 ? 0 : (b > 255 ? 255 : b));
                out[3 * i + 1] = (uint8_t)(g < 0 ? 0 : (g > 255 ? 255 : g));
                out[3 * i + 2] = (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
            }
        }
    } else {
        rc = 1;
    }
    free(planes);
    free(row);
    free_dec(d);
    free(d);
    return rc;
}
