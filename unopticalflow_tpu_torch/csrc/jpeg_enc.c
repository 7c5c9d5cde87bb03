// Host code of utils/imageio.py: a baseline JPEG encoder whose file is the
// one libjpeg(-turbo) writes with its defaults, byte for byte: what
// cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, q]) writes for an 8-bit
// BGR image, and at q 75 Pillow's Image.save(f, "JPEG") of the RGB one.
//
// libjpeg's default compression, step by step: jccolor.c's fixed-point
// RGB -> YCbCr; 4:2:0 sampling by jcsample.c's h2v2 average with its
// alternating 1, 2 rounding bias, the image's right edge repeated before
// the average and the last chroma row after it (jcprepct.c); the luma
// blocks of an MCU that lie past the image's blocks coded as "dummy"
// blocks, each the DC of the block before it (jccoefct.c); the integer
// "islow" forward DCT of jfdctint.c; quantisation by libjpeg-turbo's
// reciprocal multiply (jcdctmgr.c compute_reciprocal and quantize); the
// quality scaling of the Annex K tables (jcparam.c); the Annex K Huffman
// tables, not optimised; and the markers jcmarker.c writes: SOI, JFIF 1.01
// APP0 (no units, density 1:1), one DQT a table, SOF0, one DHT a table,
// SOS, the entropy-coded data (0xFF stuffed, the last byte padded with
// ones), EOI.
//
// Built with the host's C compiler by ops/_build.py (cc -O2 -shared -fPIC)
// and called through ctypes, which lets go of Python's interpreter lock.

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c: the Annex K.1 tables, natural order
static const int kLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const int kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// the Annex K.3 Huffman tables: code counts of lengths 1..16, then values
static const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
    uint16_t code[256];
    uint8_t len[256];
} Codes;

typedef struct {
    uint16_t recip, corr;  // libjpeg-turbo's reciprocal and rounding correction
    int shift;             // the product's right shift
} Divisor;

typedef struct {
    uint8_t* out;
    int64_t n, cap;
    uint32_t acc;  // pending bits, the oldest first
    int nacc;
} Writer;

static void put(Writer* w, int byte) {
    if (w->n < w->cap) w->out[w->n] = (uint8_t)byte;
    w->n++;  // counted past the end, so the caller learns the size it needs
}

static void put16(Writer* w, int v) {
    put(w, v >> 8);
    put(w, v & 255);
}

// Appends n (<= 16) bits; a whole 0xFF byte is followed by a stuffed 0x00.
static void bits(Writer* w, uint32_t v, int n) {
    w->acc = (w->acc << n) | (v & ((1u << n) - 1));
    w->nacc += n;
    while (w->nacc >= 8) {
        int b = (int)((w->acc >> (w->nacc - 8)) & 255);
        put(w, b);
        if (b == 0xFF) put(w, 0);
        w->nacc -= 8;
    }
}

static void build_codes(const uint8_t* counts, const uint8_t* vals, Codes* c) {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
            c->code[vals[k]] = (uint16_t)code;
            c->len[vals[k]] = (uint8_t)l;
        }
        code <<= 1;
    }
}

// jcdctmgr.c compute_reciprocal, with libjpeg-turbo's 16-bit DCTELEM
static Divisor reciprocal(int divisor) {
    int b = 0;
    while ((2 << b) <= divisor) ++b;  // floor(log2(divisor))
    int r = 16 + b;
    uint32_t fq = (uint32_t)((1u << r) / (uint32_t)divisor);
    uint32_t fr = (uint32_t)((1u << r) % (uint32_t)divisor);
    uint32_t c = (uint32_t)divisor / 2;
    if (fr == 0) {  // a power of two
        fq >>= 1;
        r--;
    } else if (fr <= (uint32_t)divisor / 2) {
        c++;
    } else {
        fq++;
    }
    Divisor d = {(uint16_t)fq, (uint16_t)c, r};
    return d;
}

#define CONST_BITS 13
#define PASS1_BITS 2
#define DESCALE(x, n) (((x) + ((int32_t)1 << ((n)-1))) >> (n))

// jfdctint.c on one block of level-shifted samples, in place (natural order)
static void fdct_islow(int32_t* data) {
    for (int pass = 0; pass < 2; ++pass) {
        const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
        for (int i = 0; i < 8; ++i) {
            int32_t* p = data + i * stride;
            int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
            int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
            int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
            int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
            int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            const int sh = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
            if (pass) {
                p[0] = DESCALE(tmp10 + tmp11, PASS1_BITS);
                p[4 * step] = DESCALE(tmp10 - tmp11, PASS1_BITS);
            } else {
                p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
                p[4 * step] = (tmp10 - tmp11) * (1 << PASS1_BITS);
            }
            int32_t z1 = (tmp12 + tmp13) * 4433;                // FIX_0_541196100
            p[2 * step] = DESCALE(z1 + tmp13 * 6270, sh);       // FIX_0_765366865
            p[6 * step] = DESCALE(z1 + tmp12 * -15137, sh);     // FIX_1_847759065
            z1 = tmp4 + tmp7;
            int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
            int32_t z5 = (z3 + z4) * 9633;  // FIX_1_175875602
            tmp4 *= 2446;                   // FIX_0_298631336
            tmp5 *= 16819;                  // FIX_2_053119869
            tmp6 *= 25172;                  // FIX_3_072711026
            tmp7 *= 12299;                  // FIX_1_501321110
            z1 *= -7373;                    // FIX_0_899976223
            z2 *= -20995;                   // FIX_2_562915447
            z3 *= -16069;                   // FIX_1_961570560
            z4 *= -3196;                    // FIX_0_390180644
            z3 += z5;
            z4 += z5;
            p[7 * step] = DESCALE(tmp4 + z1 + z3, sh);
            p[5 * step] = DESCALE(tmp5 + z2 + z4, sh);
            p[3 * step] = DESCALE(tmp6 + z2 + z3, sh);
            p[step] = DESCALE(tmp7 + z1 + z4, sh);
        }
    }
}

// One 8x8 block of a plane (row stride `ps`) -> quantised coefficients, natural order.
static void forward(const uint8_t* px, int64_t ps, const Divisor* div, int16_t* coef) {
    int32_t data[64];
    for (int r = 0; r < 8; ++r)
        for (int k = 0; k < 8; ++k) data[r * 8 + k] = (int32_t)px[r * ps + k] - 128;
    fdct_islow(data);
    for (int i = 0; i < 64; ++i) {
        int32_t t = data[i], a = t < 0 ? -t : t;
        uint32_t q = ((uint32_t)(uint16_t)(a + div[i].corr) * div[i].recip) >> div[i].shift;
        coef[i] = (int16_t)(t < 0 ? -(int32_t)q : (int32_t)q);
    }
}

static int nbits(int v) {
    int n = 0;
    for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
    return n;
}

// jchuff.c encode_one_block
static void encode_block(Writer* w, const int16_t* coef, int* last_dc, const Codes* dc,
                         const Codes* ac) {
    int diff = coef[0] - *last_dc;
    *last_dc = coef[0];
    int n = nbits(diff);
    bits(w, dc->code[n], dc->len[n]);
    if (n) bits(w, (uint32_t)(diff < 0 ? diff - 1 : diff), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        int v = coef[kNatural[k]];
        if (v == 0) {
            ++run;
            continue;
        }
        for (; run > 15; run -= 16) bits(w, ac->code[0xF0], ac->len[0xF0]);
        n = nbits(v);
        int rs = (run << 4) | n;
        bits(w, ac->code[rs], ac->len[rs]);
        bits(w, (uint32_t)(v < 0 ? v - 1 : v), n);
        run = 0;
    }
    if (run) bits(w, ac->code[0], ac->len[0]);
}

static void put_dqt(Writer* w, int id, const int* q) {
    put16(w, 0xFFDB);
    put16(w, 67);
    put(w, id);
    for (int k = 0; k < 64; ++k) put(w, q[kNatural[k]]);
}

static void put_dht(Writer* w, int id, const uint8_t* counts, const uint8_t* vals, int nvals) {
    put16(w, 0xFFC4);
    put16(w, 2 + 1 + 16 + nvals);
    put(w, id);
    for (int l = 0; l < 16; ++l) put(w, counts[l]);
    for (int i = 0; i < nvals; ++i) put(w, vals[i]);
}

// img: (h, w, 3) uint8 in B, G, R order.  Writes the file into out (cap
// bytes) and its size into *size; returns 0, or 1 when the file needs more
// than cap bytes (*size is then what it needs), or -1 when memory runs out.
int jpeg_encode(const uint8_t* img, int64_t h, int64_t w, int quality, uint8_t* out, int64_t cap,
                int64_t* size) {
    // jcparam.c jpeg_quality_scaling and jpeg_add_quant_table (baseline)
    if (quality <= 0) quality = 1;
    if (quality > 100) quality = 100;
    const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    int qt[2][64];
    Divisor div[2][64];
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) {
            long v = ((long)(t ? kChromaQ : kLumaQ)[i] * scale + 50L) / 100L;
            qt[t][i] = (int)(v <= 0 ? 1 : (v > 255 ? 255 : v));
            div[t][i] = reciprocal(qt[t][i] << 3);  // the islow FDCT scales by 8
        }

    // the planes: luma to whole blocks, chroma to whole MCUs of 16x16 pixels
    const int64_t mx = (w + 15) / 16, my = (h + 15) / 16;
    const int64_t ybw = (w + 7) / 8, ybh = (h + 7) / 8;  // luma blocks inside the image
    const int64_t yw = ybw * 8, yh = ybh * 8, cw = mx * 8, ch = my * 8;
    uint8_t* yp = malloc((size_t)(yw * yh));
    uint8_t* cp = malloc((size_t)(cw * ch * 2));
    int32_t* row = malloc(sizeof(int32_t) * (size_t)(cw * 2) * 4);
    if (yp == NULL || cp == NULL || row == NULL) {
        free(yp);
        free(cp);
        free(row);
        return -1;
    }
    // jccolor.c rgb_ycc_convert: FIX(x) = x * 2**16 rounded; Cb and Cr round
    // by 0.5 - 2**-16 and are offset by 128
    const int32_t one_half = 1 << 15, cbcr = (128 << 16) + one_half - 1;
    int32_t* ccb = row;                // Cb and Cr of two input rows, the right
    int32_t* ccr = row + cw * 2 * 2;  // edge repeated out to 2 * cw columns
    const int64_t crows = (h + 1) / 2;  // chroma rows the image's rows make
    for (int64_t cy = 0; cy < crows; ++cy) {
        for (int k = 0; k < 2; ++k) {
            // jcprepct.c repeats the last row to fill the last pair
            const int64_t y = 2 * cy + k < h ? 2 * cy + k : h - 1;
            const uint8_t* src = img + y * w * 3;
            for (int64_t x = 0; x < 2 * cw; ++x) {
                const uint8_t* p = src + (x < w ? x : w - 1) * 3;
                const int32_t r = p[2], g = p[1], b = p[0];
                if (x < yw && y < yh && 2 * cy + k < yh)
                    yp[(2 * cy + k) * yw + x] = (uint8_t)((19595 * r + 38470 * g + 7471 * b +
                                                           one_half) >> 16);
                ccb[k * 2 * cw + x] = (-11059 * r - 21709 * g + 32768 * b + cbcr) >> 16;
                ccr[k * 2 * cw + x] = (32768 * r - 27439 * g - 5329 * b + cbcr) >> 16;
            }
        }
        // jcsample.c h2v2_downsample: bias 1, 2, 1, 2, ... along each row
        for (int64_t cx = 0; cx < cw; ++cx) {
            const int bias = (cx & 1) ? 2 : 1;
            const int64_t a = 2 * cx, b = 2 * cx + 1, n = 2 * cw;
            cp[cy * cw + cx] = (uint8_t)((ccb[a] + ccb[b] + ccb[n + a] + ccb[n + b] + bias) >> 2);
            cp[ch * cw + cy * cw + cx] =
                (uint8_t)((ccr[a] + ccr[b] + ccr[n + a] + ccr[n + b] + bias) >> 2);
        }
    }
    // the rows past the image: luma repeats its last row, and chroma its last
    // downsampled row (jcprepct.c expand_bottom_edge)
    for (int64_t y = h; y < yh; ++y) memcpy(yp + y * yw, yp + (h - 1) * yw, (size_t)yw);
    for (int p = 0; p < 2; ++p)
        for (int64_t cy = crows; cy < ch; ++cy)
            memcpy(cp + p * ch * cw + cy * cw, cp + p * ch * cw + (crows - 1) * cw, (size_t)cw);

    Codes dcl, dcc, acl, acc;
    build_codes(kDcLumaBits, kDcVals, &dcl);
    build_codes(kDcChromaBits, kDcVals, &dcc);
    build_codes(kAcLumaBits, kAcLumaVals, &acl);
    build_codes(kAcChromaBits, kAcChromaVals, &acc);

    Writer wr = {out, 0, cap, 0, 0};
    Writer* o = &wr;
    static const uint8_t kJfif[18] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1,
                                      0, 1, 0, 0};
    put16(o, 0xFFD8);
    for (int i = 0; i < 18; ++i) put(o, kJfif[i]);
    put_dqt(o, 0, qt[0]);
    put_dqt(o, 1, qt[1]);
    put16(o, 0xFFC0);
    put16(o, 17);
    put(o, 8);
    put16(o, (int)h);
    put16(o, (int)w);
    put(o, 3);
    static const uint8_t kComps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    for (int i = 0; i < 9; ++i) put(o, kComps[i]);
    put_dht(o, 0x00, kDcLumaBits, kDcVals, 12);
    put_dht(o, 0x10, kAcLumaBits, kAcLumaVals, 162);
    put_dht(o, 0x01, kDcChromaBits, kDcVals, 12);
    put_dht(o, 0x11, kAcChromaBits, kAcChromaVals, 162);
    static const uint8_t kSos[12] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0};
    for (int i = 0; i < 12; ++i) put(o, kSos[i]);
    put(o, 63);
    put(o, 0);

    int last[3] = {0, 0, 0};
    int16_t blk[4][64], cb[64];
    for (int64_t my_ = 0; my_ < my; ++my_)
        for (int64_t mx_ = 0; mx_ < mx; ++mx_) {
            // jccoefct.c compress_data: a luma block past the image's blocks
            // is all zero but its DC, that of the block before it in the MCU
            for (int v = 0; v < 2; ++v) {
                const int64_t by = 2 * my_ + v;
                for (int u = 0; u < 2; ++u) {
                    const int64_t bx = 2 * mx_ + u;
                    int16_t* b = blk[v * 2 + u];
                    if (by < ybh && bx < ybw) {
                        forward(yp + by * 8 * yw + bx * 8, yw, div[0], b);
                    } else {
                        memset(b, 0, sizeof blk[0]);
                        b[0] = by < ybh ? blk[v * 2 + u - 1][0] : blk[1][0];
                    }
                }
            }
            for (int i = 0; i < 4; ++i) encode_block(o, blk[i], &last[0], &dcl, &acl);
            for (int p = 0; p < 2; ++p) {
                forward(cp + p * ch * cw + my_ * 8 * cw + mx_ * 8, cw, div[1], cb);
                encode_block(o, cb, &last[1 + p], &dcc, &acc);
            }
        }
    if (o->nacc) bits(o, 0x7F, 8 - o->nacc);  // jchuff.c flush_bits: pad with ones
    put16(o, 0xFFD9);
    free(yp);
    free(cp);
    free(row);
    *size = o->n;
    return o->n > cap ? 1 : 0;
}
