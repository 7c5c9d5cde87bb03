// Host code of utils/imageio.py: a JPEG decoder that gives what cv2.imdecode
// gives, bit for bit, where OpenCV decodes with libjpeg-turbo.
//
// Sequential and progressive DCT with Huffman coding, 8-bit samples (SOF0,
// SOF1 and SOF2), one, three or four components (grey, YCbCr, and CMYK as
// Adobe's APP14 marker with transform 0 names it, or as a 4-component file
// without the marker), any size, restart intervals, and several scans.  A
// progressive file's scans (DC first and refinement, AC first and
// refinement with end-of-band runs, as jdphuff.c decodes them) fill a
// coefficient buffer of the whole image; once the file has ended, that
// buffer goes through the same output steps as a sequential file's, with
// the block smoothing of jdcoefct.c decompress_smooth_data (libjpeg-turbo
// 2.1 and later: AC estimates from a 5x5 neighbourhood of DC values) where
// the scans leave a low-frequency coefficient unrefined, as in a
// progression cut short.  Each step follows libjpeg's default decompression
// arithmetic: the integer "islow" IDCT of jidctint.c with its range-limit
// table, jdsample.c's fancy upsampling (h2v1 and h2v2 triangle filters, and
// libjpeg-turbo's h1v2 for 4:4:0; plain replication where libjpeg falls
// back to it, as for 4:1:1 or a chroma plane at most 2 samples wide), the
// edge rows libjpeg repeats at the top and bottom of a component, jdcolor.c's
// fixed-point YCbCr -> BGR tables, and OpenCV's CMYK -> BGR and CMYK -> grey
// conversions of libjpeg's CMYK samples.  Lossless, hierarchical,
// arithmetic-coded and 12-bit files, YCCK and RGB-coded files, and a
// truncated or corrupt file are refused with a message that names the mode
// or the fault.  The Exif orientation is applied by utils/imageio.py.
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
    uint16_t q[64];    // the quantisation table, latched at the first scan
    int coef_bits[64];  // progressive: the last scan's Al of each coefficient
                        // (zigzag order), -1 before its first scan
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
    int ss, se, ah, al;  // the scan's spectral band and successive approximation
    int eobrun;          // progressive AC: blocks left in an end-of-band run
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
    if (d->ncomp != 1 && d->ncomp != 3 && d->ncomp != 4)
        fail(d, "%d-component JPEG is not supported: the port reads grey, YCbCr and CMYK",
             d->ncomp);
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
        for (int k = 0; k < 64; ++k) c->coef_bits[k] = -1;
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

// Fills the buffer to more than 56 bits, a byte at a time.  A marker ends
// the segment: the bits after it read as zeros, counted in `padded`, which
// the data must not reach (checked after each MCU).
static void fill(Dec* d) {
    while (d->nbits <= 56) {
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
    if (d->nbits < n) fill(d);
    d->nbits -= n;
    return (int)((d->buf >> d->nbits) & ((1u << n) - 1));
}

static inline int extend(int v, int n) { return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v; }

static int decode_huff(Dec* d, const Huff* t) {
    if (d->nbits < 16) fill(d);
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
}

// jdphuff.c decode_mcu_DC_first: the DC's high bits, from Al up.
static void decode_dc_first(Dec* d, Comp* c, int16_t* blk) {
    int s = decode_huff(d, &d->dc[c->dc]);
    if (s > 15) fail(d, "corrupt JPEG: DC magnitude %d", s);
    c->pred += s ? extend(get_bits(d, s), s) : 0;
    blk[0] = (int16_t)(int)((unsigned)c->pred << d->al);
}

// jdphuff.c decode_mcu_DC_refine: one more bit of the DC, at Al.
static void decode_dc_refine(Dec* d, Comp* c, int16_t* blk) {
    (void)c;
    if (get_bits(d, 1)) blk[0] = (int16_t)(blk[0] | (1 << d->al));
}

// jdphuff.c decode_mcu_AC_first: the band Ss..Se's high bits, from Al up;
// an end-of-band run covers this block and EOBRUN - 1 more.
static void decode_ac_first(Dec* d, Comp* c, int16_t* blk) {
    if (d->eobrun > 0) {
        d->eobrun--;
        return;
    }
    const Huff* ac = &d->ac[c->ac];
    for (int k = d->ss; k <= d->se; ++k) {
        int rs = decode_huff(d, ac), r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            blk[kNatural[k]] = (int16_t)(int)((unsigned)extend(get_bits(d, s), s) << d->al);
        } else if (r == 15) {  // ZRL: 16 zeros
            k += 15;
        } else {  // EOBr: a run of 2**r + r appended bits blocks, this one included
            d->eobrun = (1 << r) + (r ? get_bits(d, r) : 0) - 1;
            break;
        }
    }
}

// jdphuff.c decode_mcu_AC_refine: a bit at Al for each coefficient that is
// already nonzero (1: its magnitude grows by 2**Al), and the coefficients
// that become nonzero (+-2**Al), in libjpeg's order.
static void decode_ac_refine(Dec* d, Comp* c, int16_t* blk) {
    const int p1 = 1 << d->al, m1 = -p1;
    int k = d->ss;
    if (d->eobrun == 0) {
        const Huff* ac = &d->ac[c->ac];
        for (; k <= d->se; ++k) {
            int rs = decode_huff(d, ac), r = rs >> 4, s = rs & 15;
            if (s) {
                s = get_bits(d, 1) ? p1 : m1;  // libjpeg takes any size as 1
            } else if (r != 15) {
                d->eobrun = (1 << r) + (r ? get_bits(d, r) : 0);
                break;  // the rest of the block is the run's
            }
            // pass the nonzero coefficients, each with its correction bit,
            // and r zero ones; the next zero is the new coefficient's place
            do {
                int16_t* t = blk + kNatural[k];
                if (*t != 0) {
                    if (get_bits(d, 1) && (*t & p1) == 0) *t = (int16_t)(*t + (*t >= 0 ? p1 : m1));
                } else if (--r < 0) {
                    break;
                }
                ++k;
            } while (k <= d->se);
            if (s) blk[kNatural[k]] = (int16_t)s;
        }
    }
    if (d->eobrun > 0) {  // in an end-of-band run: correction bits only
        for (; k <= d->se; ++k) {
            int16_t* t = blk + kNatural[k];
            if (*t != 0 && get_bits(d, 1) && (*t & p1) == 0) *t = (int16_t)(*t + (*t >= 0 ? p1 : m1));
        }
        d->eobrun--;
    }
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

typedef void (*BlockFn)(Dec*, Comp*, int16_t*);

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
        if (sc[i]->dc > 3 || sc[i]->ac > 3) fail(d, "corrupt JPEG: Huffman table slot %d", tables);
        blocks += sc[i]->h * sc[i]->v;
    }
    d->ss = byte_at(d);
    d->se = byte_at(d);
    int a = byte_at(d);
    d->ah = a >> 4;
    d->al = a & 15;
    if (ns > 1 && blocks > 10) fail(d, "corrupt JPEG: %d blocks in an MCU", blocks);
    if (d->pos != end) fail(d, "corrupt JPEG: scan header of the wrong length");
    BlockFn fn = decode_block;
    int need_dc = 1, need_ac = 1;
    if (d->sof != 0xC2) {
        if (d->ss != 0 || d->se != 63 || a != 0)
            fail(d, "corrupt JPEG: sequential scan with spectral range %d..%d", d->ss, d->se);
    } else {
        // jdphuff.c start_pass_phuff_decoder's checks
        int dc_band = d->ss == 0;
        if ((dc_band && d->se != 0) || (!dc_band && (d->se < d->ss || d->se > 63 || ns != 1)) ||
            (d->ah != 0 && d->al != d->ah - 1) || d->al > 13)
            fail(d, "corrupt JPEG: progressive scan Ss %d, Se %d, Ah %d, Al %d", d->ss, d->se,
                 d->ah, d->al);
        fn = dc_band ? (d->ah ? decode_dc_refine : decode_dc_first)
                     : (d->ah ? decode_ac_refine : decode_ac_first);
        need_dc = dc_band && d->ah == 0;
        need_ac = !dc_band;
        for (int i = 0; i < ns; ++i)  // libjpeg only warns when Ah is not the last Al
            for (int k = d->ss; k <= d->se; ++k) sc[i]->coef_bits[k] = d->al;
    }
    for (int i = 0; i < ns; ++i) {
        Comp* c = sc[i];
        if ((need_dc && !d->dc[c->dc].present) || (need_ac && !d->ac[c->ac].present))
            fail(d, "corrupt JPEG: scan uses an undefined Huffman table");
        if (!c->seen) {  // jdinput.c latch_quant_tables
            if (!d->qset[c->tq]) fail(d, "corrupt JPEG: undefined quantisation table");
            memcpy(c->q, d->q[c->tq], sizeof c->q);
        }
        c->pred = 0;
        c->seen = 1;
        if (c->coef == NULL) {
            c->coef = calloc((size_t)c->bw * c->bh * 64, sizeof(int16_t));
            if (c->coef == NULL) fail(d, "out of memory");
        }
    }

    d->buf = 0;
    d->nbits = d->padded = d->marker = 0;
    d->eobrun = 0;
    int next_rst = 0, todo = d->restart;
    // a scan of one component codes its own blocks, one an MCU; a scan of
    // several codes whole MCUs
    const int one = ns == 1;
    const int64_t nx = one ? (sc[0]->dw + 7) / 8 : d->mcusx;
    const int64_t ny = one ? (sc[0]->dh + 7) / 8 : d->mcusy;
    for (int64_t my = 0; my < ny; ++my)
        for (int64_t mx = 0; mx < nx; ++mx) {
            if (d->restart) {
                if (todo == 0) {  // a restart resets the predictions and any run
                    restart(d, &next_rst);
                    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
                    d->eobrun = 0;
                    todo = d->restart;
                }
                --todo;
            }
            for (int i = 0; i < ns; ++i) {
                Comp* c = sc[i];
                const int bv = one ? 1 : c->v, bh = one ? 1 : c->h;
                for (int v = 0; v < bv; ++v)
                    for (int h = 0; h < bh; ++h) {
                        int64_t b = (my * bv + v) * c->bw + mx * bh + h;
                        fn(d, c, c->coef + b * 64);
                    }
            }
            if (d->nbits < d->padded)
                fail(d, "corrupt or truncated JPEG: a marker inside the data of a block");
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

// jdcoefct.c smoothing_ok (libjpeg-turbo 2.1 and later): whether libjpeg
// would smooth the blocks of this progressive file.  It does when every
// component's DC is at least partly known and one of its first ten
// coefficients (zigzag order) is not fully refined.
static int smoothing(const Dec* d) {
    int useful = 0;
    for (int i = 0; i < d->ncomp; ++i) {
        const Comp* c = &d->c[i];
        for (int k = 0; k < 10; ++k)
            if (c->q[kNatural[k]] == 0) return 0;
        if (c->coef_bits[0] < 0) return 0;
        for (int k = 1; k < 10; ++k) useful |= c->coef_bits[k] != 0;
    }
    return useful;
}

// An AC estimate of jdcoefct.c: num / (128 q) rounded half away from zero,
// kept below 2**Al in magnitude where the coefficient's next Al bits are
// unknown (Al < 0: none of it is).
static int smooth_pred(int64_t num, int64_t q, int al) {
    int neg = num < 0;
    int pred = (int)(((q << 7) + (neg ? -num : num)) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return neg ? -pred : pred;
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later) for one
// component: each block's first nine AC coefficients (zigzag 1-9), where
// still zero and not fully refined, estimated from the DC values of the
// 5 x 5 blocks around it (edges repeated); with no AC data at all the DC
// too is re-estimated, from a smoother kernel.  The rows are walked as
// libjpeg walks them, an iMCU row of v_samp block rows at a time, with its
// row-index arithmetic: in the last iMCU row, which may hold fewer block
// rows, the neighbour tests use that smaller count.  Writes the IDCT of
// the visible blocks into the component's plane.
static void smooth_component(const Dec* d, const Comp* c) {
    const int* bits = c->coef_bits;
    const int64_t Q00 = c->q[0], Q01 = c->q[1], Q10 = c->q[8], Q20 = c->q[16], Q11 = c->q[9],
                  Q02 = c->q[2], Q03 = c->q[3], Q12 = c->q[10], Q21 = c->q[17], Q30 = c->q[24];
    int change_dc = 1;
    for (int k = 1; k < 10; ++k) change_dc &= bits[k] == -1;
    const int wib = (c->dw + 7) / 8, hib = (c->dh + 7) / 8, total = d->mcusy;
    const int64_t ps = (int64_t)c->bw * 8;
    int16_t ws[64];
    for (int r = 0; r < total; ++r) {
        int block_rows = c->v;
        if (r == total - 1 && hib % c->v) block_rows = hib % c->v;
        const int image_rows = block_rows * total;
        for (int br = 0; br < block_rows; ++br) {
            const int ibr = r * block_rows + br, row = r * c->v + br;
            const int prow = ibr > 0 ? row - 1 : row, pprow = ibr > 1 ? row - 2 : prow;
            const int nrow = ibr < image_rows - 1 ? row + 1 : row;
            const int nnrow = ibr < image_rows - 2 ? row + 2 : nrow;
#define DC_AT(rr, x) ((int)c->coef[((int64_t)(rr) * c->bw + (x)) * 64])
            int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13;
            int DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
            DC01 = DC02 = DC03 = DC04 = DC05 = DC_AT(pprow, 0);
            DC06 = DC07 = DC08 = DC09 = DC10 = DC_AT(prow, 0);
            DC11 = DC12 = DC13 = DC14 = DC15 = DC_AT(row, 0);
            DC16 = DC17 = DC18 = DC19 = DC20 = DC_AT(nrow, 0);
            DC21 = DC22 = DC23 = DC24 = DC25 = DC_AT(nnrow, 0);
            const int last = wib - 1;
            for (int bn = 0; bn <= last; ++bn) {
                memcpy(ws, c->coef + ((int64_t)row * c->bw + bn) * 64, sizeof ws);
                if (bn == 0 && bn < last) {
                    DC04 = DC05 = DC_AT(pprow, 1);
                    DC09 = DC10 = DC_AT(prow, 1);
                    DC14 = DC15 = DC_AT(row, 1);
                    DC19 = DC20 = DC_AT(nrow, 1);
                    DC24 = DC25 = DC_AT(nnrow, 1);
                }
                if (bn + 1 < last) {
                    DC05 = DC_AT(pprow, bn + 2);
                    DC10 = DC_AT(prow, bn + 2);
                    DC15 = DC_AT(row, bn + 2);
                    DC20 = DC_AT(nrow, bn + 2);
                    DC25 = DC_AT(nnrow, bn + 2);
                }
#undef DC_AT
                int al;
                if ((al = bits[1]) != 0 && ws[1] == 0)  // AC01
                    ws[1] = (int16_t)smooth_pred(
                        Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                            13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                                            38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                                            13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                                         : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
                        Q01, al);
                if ((al = bits[2]) != 0 && ws[8] == 0)  // AC10
                    ws[8] = (int16_t)smooth_pred(
                        Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                            13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                            13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                            3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                         : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
                        Q10, al);
                if ((al = bits[3]) != 0 && ws[16] == 0)  // AC20
                    ws[16] = (int16_t)smooth_pred(
                        Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                            14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                                            2 * DC19 + DC23)
                                         : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
                        Q20, al);
                if ((al = bits[4]) != 0 && ws[9] == 0)  // AC11
                    ws[9] = (int16_t)smooth_pred(
                        Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                                            9 * DC19 + DC21 - DC25)
                                         : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                                            DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)),
                        Q11, al);
                if ((al = bits[5]) != 0 && ws[2] == 0)  // AC02
                    ws[2] = (int16_t)smooth_pred(
                        Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                                            14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                                            2 * DC19)
                                         : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
                        Q02, al);
                if (change_dc) {
                    if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
                        ws[3] = (int16_t)smooth_pred(
                            Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
                    if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
                        ws[10] = (int16_t)smooth_pred(
                            Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
                    if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
                        ws[17] = (int16_t)smooth_pred(
                            Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
                    if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
                        ws[24] = (int16_t)smooth_pred(
                            Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
                    ws[0] = (int16_t)smooth_pred(
                        Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                               6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                               152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 +
                               42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 -
                               6 * DC24 - 2 * DC25),
                        Q00, 0);
                }
                idct_islow(ws, c->q, c->plane + (int64_t)row * 8 * ps + bn * 8, ps);
                DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
            }
        }
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
            case 0xC2:
                read_sof(d, m);
                if (!decode) return;
                break;
            case 0xC3:
                fail(d, "lossless JPEG (SOF3) is not supported: the port reads sequential and "
                     "progressive DCT JPEG");
            case 0xC5:
            case 0xC6:
            case 0xC7:
                fail(d, "hierarchical JPEG (SOF%d) is not supported: the port reads sequential "
                     "and progressive DCT JPEG", m - 0xC0);
            case 0xC9:
            case 0xCA:
            case 0xCB:
            case 0xCD:
            case 0xCE:
            case 0xCF:
                fail(d, "arithmetic-coded JPEG (SOF%d) is not supported: the port reads "
                     "Huffman-coded JPEG", m - 0xC0);
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

// Decodes into out: (H, W, 3) BGR when mode == 0 (a grey file repeated),
// (H, W) when mode == 1 (a YCbCr file's Y, a CMYK file's weighted sum), or
// (H, W, components) when mode == 2: each component upsampled and left as
// stored, as libjpeg gives a JCS_UNKNOWN file (TIFF's JPEG strips of RGB
// data).  Returns 0, or 1 with a message.
int jpeg_decode(const uint8_t* data, int64_t n, int mode, uint8_t* out, char* err, int errlen) {
    const int grey = mode == 1, raw = mode == 2;
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
        if (d->ncomp == 3 && !raw) {
            int rgb_ids = d->c[0].id == 82 && d->c[1].id == 71 && d->c[2].id == 66;
            if (!d->jfif && ((d->adobe && d->adobe_transform == 0) || (!d->adobe && rgb_ids)))
                fail(d, "RGB-coded JPEG (no YCbCr transform) is not supported");
        }
        // jdapimin.c: 4 components are CMYK without an Adobe marker or with
        // its transform 0, else YCCK
        if (d->ncomp == 4 && d->adobe && d->adobe_transform != 0 && !raw)
            fail(d, "YCCK JPEG (Adobe transform %d) is not supported: the port reads CMYK",
                 d->adobe_transform);
        const int W = d->width, H = d->height;
        const int nout = (raw || d->ncomp == 4) ? d->ncomp : ((grey || d->ncomp == 1) ? 1 : 3);
        for (int i = 0; i < d->ncomp; ++i)
            if (!d->c[i].seen) fail(d, "corrupt JPEG: component %d is in no scan", d->c[i].id);
        const int smooth = d->sof == 0xC2 && smoothing(d);
        for (int i = 0; i < d->ncomp; ++i) {
            Comp* c = &d->c[i];
            if (d->hmax % c->h || d->vmax % c->v)
                fail(d, "JPEG sampling %dx%d of %dx%d is not supported", c->h, c->v, d->hmax,
                     d->vmax);
            if (i >= nout) continue;
            c->plane = malloc((size_t)c->bw * 8 * c->bh * 8);
            if (c->plane == NULL) fail(d, "out of memory");
            const int64_t ps = (int64_t)c->bw * 8;
            if (smooth) {
                smooth_component(d, c);
                continue;
            }
            for (int by = 0; by < c->bh; ++by)
                for (int bx = 0; bx < c->bw; ++bx)
                    idct_islow(c->coef + ((int64_t)by * c->bw + bx) * 64, c->q,
                               c->plane + (int64_t)by * 8 * ps + bx * 8, ps);
        }
        planes = malloc((size_t)W * H * nout);
        row = malloc((size_t)W * 2 + 16 + (size_t)d->hmax * 8);
        if (planes == NULL || row == NULL) fail(d, "out of memory");
        for (int i = 0; i < nout; ++i) upsample(d, &d->c[i], planes + (int64_t)i * W * H, row);
        const int64_t np = (int64_t)W * H;
        if (raw) {
            for (int64_t i = 0; i < np; ++i)
                for (int k = 0; k < nout; ++k) out[i * nout + k] = planes[k * np + i];
        } else if (nout == 4) {
            // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R and icvCvt_CMYK2Gray_8u_C4C1R on
            // libjpeg's (Adobe-inverted) CMYK samples: each of C, M, Y becomes
            // K - (255 - x) * K / 256, then B, G, R are Y, M, C; grey is their
            // sum with 14-bit weights, rounded
            const uint8_t *pc = planes, *pm = planes + np, *pyl = planes + 2 * np,
                          *pk = planes + 3 * np;
            for (int64_t i = 0; i < np; ++i) {
                int k = pk[i];
                int r = k - ((255 - pc[i]) * k >> 8), g = k - ((255 - pm[i]) * k >> 8),
                    b = k - ((255 - pyl[i]) * k >> 8);
                if (grey) {
                    out[i] = (uint8_t)((b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14);
                } else {
                    out[3 * i] = (uint8_t)b;
                    out[3 * i + 1] = (uint8_t)g;
                    out[3 * i + 2] = (uint8_t)r;
                }
            }
        } else if (nout == 1 && grey) {
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
