// Host code of utils/jpeg2000.py: a tile of a JPEG 2000 codestream (ITU-T
// T.800, Part 1) decoded as OpenJPEG 2.5 decodes it for cv2.imdecode, every
// sample equal.
//
// * Tier 2: packets in the five progression orders (LRCP, RLCP, RPCL, PCRL,
//   CPRL) and under POC changes, each packet once; packet headers from the
//   tile's data or from PPM / PPT; SOP and EPH markers; tag trees for
//   inclusion and zero bit-planes, the pass count, Lblock, the codeword
//   segments of each code-block style.
// * Tier 1: the MQ decoder and the raw (bypass) bit reader; the
//   significance, refinement and cleanup passes with their context models
//   (run-length and uniform contexts, the segmentation symbol), the styles
//   BYPASS, RESET, TERMALL, VSC, PTERM and SEGSYM.  Coefficients carry one
//   bit below their last decoded bit-plane, as OpenJPEG's do, so a
//   truncated code-block reconstructs at the middle of its interval.
// * Then, as OpenJPEG orders them: the ROI shift, dequantisation (integer
//   halving for 5/3, OpenJPEG's float step for 9/7), the inverse DWT by
//   lifting with symmetric extension (integer 5/3; 9/7 in float, with
//   OpenJPEG's constants and its 2/K high-pass gain), rows before columns,
//   the inverse RCT or ICT, the DC level shift and clipping to the
//   component's precision (9/7: lrintf, round half to even).
//
// The JP2 boxes and the marker segments are read by utils/jpeg2000.py,
// which hands each tile here with its coding parameters.  Built with the
// host's C compiler by ops/_build.py (cc -O2 -shared -fPIC) and called
// through ctypes.  The 9/7 arithmetic is float32 throughout, never fused:
// a fused multiply-add would change the last bit where OpenJPEG's does not.

#pragma GCC optimize("fp-contract=off")

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

// --- the parameter block utils/jpeg2000.py fills (int32 words) -------------
enum {
    P_NCOMP = 0, P_TX0, P_TY0, P_TX1, P_TY1, P_PROG, P_LAYERS, P_MCT, P_CSTY, P_NPOC,
    P_POC = 16,             // 32 entries of (rs, cs, le, re, ce, prg)
    P_COMP = 16 + 32 * 6,   // per component, C_SIZE words each
};
enum {
    C_DX = 0, C_DY, C_PREC, C_SGND, C_NUMRES, C_CBW, C_CBH, C_CBLKSTY, C_QMFBID, C_QNTSTY,
    C_GUARD, C_ROISHIFT, C_X0, C_Y0, C_W, C_H,
    C_PRC = 16,             // (pdx, pdy) per resolution, 33 of them
    C_STEP = 16 + 66,       // (expn, mant) per band, 97 of them
    C_SIZE = 16 + 66 + 194,
};

#define MAXRES 33
#define CBLK_BYPASS 0x01
#define CBLK_RESET 0x02
#define CBLK_TERMALL 0x04
#define CBLK_VSC 0x08
#define CBLK_SEGSYM 0x20

static int ceildiv(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }
static int ceildivpow2(int64_t a, int b) { return (int)((a + ((int64_t)1 << b) - 1) >> b); }
static int floordivpow2(int64_t a, int b) { return (int)(a >> b); }

// --- errors ---------------------------------------------------------------

typedef struct {
    char* msg;
    int len;
} err_t;

static int fail(err_t* e, const char* what) {
    if (e->msg && e->len > 0 && !e->msg[0]) snprintf(e->msg, (size_t)e->len, "%s", what);
    return 1;
}

// --- the packet header bit reader (OpenJPEG's opj_bio) --------------------

typedef struct {
    const uint8_t *start, *bp, *end;
    uint32_t buf;
    int ct;
} bio_t;

static void bio_init(bio_t* b, const uint8_t* p, int64_t len) {
    b->start = b->bp = p;
    b->end = p + len;
    b->buf = 0;
    b->ct = 0;
}

static void bio_bytein(bio_t* b) {
    b->buf = (b->buf << 8) & 0xffff;
    b->ct = b->buf == 0xff00 ? 7 : 8;  // a bit stuffed after 0xFF
    if (b->bp < b->end) b->buf |= *b->bp++;
}

static uint32_t bio_read(bio_t* b, int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) {
        if (b->ct == 0) bio_bytein(b);
        b->ct--;
        v |= ((b->buf >> b->ct) & 1u) << i;
    }
    return v;
}

static void bio_inalign(bio_t* b) {
    if ((b->buf & 0xff) == 0xff) bio_bytein(b);
    b->ct = 0;
}

// --- tag trees -------------------------------------------------------------

typedef struct {
    int value, low;
    int parent;  // index, -1 at the root
} tnode_t;

typedef struct {
    tnode_t* nodes;
    int n;
} tgt_t;

static int tgt_create(tgt_t* t, int w, int h) {
    int lw[32], lh[32], levels = 0, total = 0;
    t->nodes = NULL;
    t->n = 0;
    if (w <= 0 || h <= 0) return 0;
    lw[0] = w;
    lh[0] = h;
    for (;;) {
        int n = lw[levels] * lh[levels];
        total += n;
        lw[levels + 1] = (lw[levels] + 1) / 2;
        lh[levels + 1] = (lh[levels] + 1) / 2;
        ++levels;
        if (n <= 1) break;
    }
    t->nodes = malloc(sizeof(tnode_t) * (size_t)total);
    if (!t->nodes) return -1;
    t->n = total;
    int off = 0;
    for (int l = 0; l < levels; ++l) {
        int next = off + lw[l] * lh[l];
        for (int y = 0; y < lh[l]; ++y)
            for (int x = 0; x < lw[l]; ++x) {
                tnode_t* nd = &t->nodes[off + y * lw[l] + x];
                nd->value = 999;
                nd->low = 0;
                nd->parent = l + 1 < levels ? next + (y >> 1) * lw[l + 1] + (x >> 1) : -1;
            }
        off = next;
    }
    return 0;
}

// 1 when the leaf's value is below the threshold
static int tgt_decode(bio_t* b, tgt_t* t, int leaf, int threshold) {
    int stk[32], sp = 0, node = leaf;
    while (t->nodes[node].parent >= 0) {
        stk[sp++] = node;
        node = t->nodes[node].parent;
    }
    int low = 0;
    for (;;) {
        tnode_t* nd = &t->nodes[node];
        if (low > nd->low) nd->low = low;
        else low = nd->low;
        while (low < threshold && low < nd->value) {
            if (bio_read(b, 1)) nd->value = low;
            else ++low;
        }
        nd->low = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return t->nodes[node].value < threshold;
}

// --- the tile's structure ---------------------------------------------------

typedef struct {
    int len, numpasses, maxpasses, newpasses, newlen;
} seg_t;

typedef struct {
    const uint8_t* data;
    int len;
} chunk_t;

typedef struct {
    int x0, y0, x1, y1;
    int numbps, numlenbits, numsegs, numnewpasses;
    seg_t* segs;
    int segcap;
    chunk_t* chunks;
    int nchunks, chunkcap;
} cblk_t;

typedef struct {
    int x0, y0, x1, y1, cw, ch;
    cblk_t* cblks;
    tgt_t incl, imsb;
} prec_t;

typedef struct {
    int x0, y0, x1, y1, bandno, numbps;
    float stepsize;
    prec_t* precs;
} band_t;

typedef struct {
    int x0, y0, x1, y1, pw, ph, pdx, pdy, nbands;
    band_t bands[3];
} res_t;

typedef struct {
    const int32_t* p;  // the component's parameter words
    int x0, y0, x1, y1, numres;
    res_t res[MAXRES];
    int32_t* idata;  // 5/3: integers
    float* fdata;    // 9/7: floats
} tcomp_t;

typedef struct {
    int ncomp;
    tcomp_t* comps;
    int tx0, ty0, tx1, ty1;
} tile_t;

static void tile_free(tile_t* t) {
    if (!t->comps) return;
    for (int c = 0; c < t->ncomp; ++c) {
        tcomp_t* tc = &t->comps[c];
        for (int r = 0; r < tc->numres; ++r) {
            res_t* rs = &tc->res[r];
            for (int b = 0; b < rs->nbands; ++b) {
                band_t* bd = &rs->bands[b];
                if (!bd->precs) continue;
                for (int p = 0; p < rs->pw * rs->ph; ++p) {
                    prec_t* pr = &bd->precs[p];
                    if (pr->cblks) {
                        for (int k = 0; k < pr->cw * pr->ch; ++k) {
                            free(pr->cblks[k].segs);
                            free(pr->cblks[k].chunks);
                        }
                    }
                    free(pr->cblks);
                    free(pr->incl.nodes);
                    free(pr->imsb.nodes);
                }
                free(bd->precs);
            }
        }
        free(tc->idata);
        free(tc->fdata);
    }
    free(t->comps);
    t->comps = NULL;
}

// OpenJPEG's opj_tcd_init_tile: resolutions, bands, precincts, code-blocks
// precincts and code-blocks a tile may hold: a corrupt header can ask for
// billions (4096 x 4096 samples in 64 x 64 blocks are 4096 a component)
#define MAX_BLOCKS (1 << 22)

static int tile_init(tile_t* t, const int32_t* prm, err_t* e) {
    int64_t blocks = 0;
    t->ncomp = prm[P_NCOMP];
    t->tx0 = prm[P_TX0];
    t->ty0 = prm[P_TY0];
    t->tx1 = prm[P_TX1];
    t->ty1 = prm[P_TY1];
    t->comps = calloc((size_t)t->ncomp, sizeof(tcomp_t));
    if (!t->comps) return fail(e, "out of memory");
    for (int c = 0; c < t->ncomp; ++c) {
        tcomp_t* tc = &t->comps[c];
        const int32_t* cp = prm + P_COMP + c * C_SIZE;
        tc->p = cp;
        tc->x0 = ceildiv(t->tx0, cp[C_DX]);
        tc->y0 = ceildiv(t->ty0, cp[C_DY]);
        tc->x1 = ceildiv(t->tx1, cp[C_DX]);
        tc->y1 = ceildiv(t->ty1, cp[C_DY]);
        tc->numres = cp[C_NUMRES];
        size_t n = (size_t)(tc->x1 - tc->x0) * (size_t)(tc->y1 - tc->y0);
        if (cp[C_QMFBID] == 1) tc->idata = calloc(n ? n : 1, sizeof(int32_t));
        else tc->fdata = calloc(n ? n : 1, sizeof(float));
        if (!tc->idata && !tc->fdata) return fail(e, "out of memory");
        const int32_t* step = cp + C_STEP;
        for (int r = 0; r < tc->numres; ++r) {
            res_t* rs = &tc->res[r];
            int level = tc->numres - 1 - r;
            rs->x0 = ceildivpow2(tc->x0, level);
            rs->y0 = ceildivpow2(tc->y0, level);
            rs->x1 = ceildivpow2(tc->x1, level);
            rs->y1 = ceildivpow2(tc->y1, level);
            int pdx = cp[C_PRC + 2 * r], pdy = cp[C_PRC + 2 * r + 1];
            rs->pdx = pdx;
            rs->pdy = pdy;
            int tlx = floordivpow2(rs->x0, pdx) << pdx, tly = floordivpow2(rs->y0, pdy) << pdy;
            int brx = ceildivpow2(rs->x1, pdx) << pdx, bry = ceildivpow2(rs->y1, pdy) << pdy;
            rs->pw = rs->x0 == rs->x1 ? 0 : (brx - tlx) >> pdx;
            rs->ph = rs->y0 == rs->y1 ? 0 : (bry - tly) >> pdy;
            int cbgx, cbgy, cbgw, cbgh;
            if (r == 0) {
                cbgx = tlx;
                cbgy = tly;
                cbgw = pdx;
                cbgh = pdy;
                rs->nbands = 1;
            } else {
                cbgx = ceildivpow2(tlx, 1);
                cbgy = ceildivpow2(tly, 1);
                cbgw = pdx - 1;
                cbgh = pdy - 1;
                rs->nbands = 3;
            }
            int cbw = cp[C_CBW] < cbgw ? cp[C_CBW] : cbgw;
            int cbh = cp[C_CBH] < cbgh ? cp[C_CBH] : cbgh;
            for (int b = 0; b < rs->nbands; ++b, step += 2) {
                band_t* bd = &rs->bands[b];
                if (r == 0) {
                    bd->bandno = 0;
                    bd->x0 = rs->x0;
                    bd->y0 = rs->y0;
                    bd->x1 = rs->x1;
                    bd->y1 = rs->y1;
                } else {
                    bd->bandno = b + 1;
                    int xo = bd->bandno & 1, yo = bd->bandno >> 1;
                    bd->x0 = ceildivpow2((int64_t)tc->x0 - ((int64_t)xo << level), level + 1);
                    bd->y0 = ceildivpow2((int64_t)tc->y0 - ((int64_t)yo << level), level + 1);
                    bd->x1 = ceildivpow2((int64_t)tc->x1 - ((int64_t)xo << level), level + 1);
                    bd->y1 = ceildivpow2((int64_t)tc->y1 - ((int64_t)yo << level), level + 1);
                }
                // the decoder's gain is 0 for 9/7: its 2/K high-pass makes up for it
                int gain = cp[C_QMFBID] == 0 ? 0 : (bd->bandno == 0 ? 0 : bd->bandno == 3 ? 2 : 1);
                int rb = cp[C_PREC] + gain;
                bd->stepsize = (float)((1.0 + step[1] / 2048.0) * pow(2.0, rb - step[0]));
                bd->numbps = step[0] + cp[C_GUARD] - 1;
                int64_t np64 = (int64_t)rs->pw * rs->ph;
                blocks += np64;
                if (blocks > MAX_BLOCKS) return fail(e, "too many precincts in a tile");
                int np = (int)np64;
                bd->precs = calloc(np ? (size_t)np : 1, sizeof(prec_t));
                if (!bd->precs) return fail(e, "out of memory");
                for (int p = 0; p < np; ++p) {
                    prec_t* pr = &bd->precs[p];
                    int sx = cbgx + (p % rs->pw) * (1 << cbgw), sy = cbgy + (p / rs->pw) * (1 << cbgh);
                    int ex = sx + (1 << cbgw), ey = sy + (1 << cbgh);
                    pr->x0 = sx > bd->x0 ? sx : bd->x0;
                    pr->y0 = sy > bd->y0 ? sy : bd->y0;
                    pr->x1 = ex < bd->x1 ? ex : bd->x1;
                    pr->y1 = ey < bd->y1 ? ey : bd->y1;
                    int cx = floordivpow2(pr->x0, cbw) << cbw, cy = floordivpow2(pr->y0, cbh) << cbh;
                    int cex = ceildivpow2(pr->x1, cbw) << cbw, cey = ceildivpow2(pr->y1, cbh) << cbh;
                    pr->cw = (cex - cx) >> cbw;
                    pr->ch = (cey - cy) >> cbh;
                    if (pr->cw < 0 || pr->ch < 0) {
                        pr->cw = pr->ch = 0;
                    }
                    int64_t nb64 = (int64_t)pr->cw * pr->ch;
                    blocks += nb64;
                    if (blocks > MAX_BLOCKS) return fail(e, "too many code-blocks in a tile");
                    int nb = (int)nb64;
                    if (nb == 0) continue;
                    pr->cblks = calloc((size_t)nb, sizeof(cblk_t));
                    if (!pr->cblks || tgt_create(&pr->incl, pr->cw, pr->ch) ||
                        tgt_create(&pr->imsb, pr->cw, pr->ch))
                        return fail(e, "out of memory");
                    for (int k = 0; k < nb; ++k) {
                        cblk_t* cb = &pr->cblks[k];
                        int bx = cx + (k % pr->cw) * (1 << cbw), by = cy + (k / pr->cw) * (1 << cbh);
                        int bex = bx + (1 << cbw), bey = by + (1 << cbh);
                        cb->x0 = bx > pr->x0 ? bx : pr->x0;
                        cb->y0 = by > pr->y0 ? by : pr->y0;
                        cb->x1 = bex < pr->x1 ? bex : pr->x1;
                        cb->y1 = bey < pr->y1 ? bey : pr->y1;
                    }
                }
            }
        }
    }
    return 0;
}

// --- tier 2 -------------------------------------------------------------------

static int seg_init(cblk_t* cb, int index, int sty, int first) {
    if (index >= cb->segcap) {
        int cap = cb->segcap ? cb->segcap * 2 : 8;
        while (cap <= index) cap *= 2;
        seg_t* s = realloc(cb->segs, sizeof(seg_t) * (size_t)cap);
        if (!s) return -1;
        memset(s + cb->segcap, 0, sizeof(seg_t) * (size_t)(cap - cb->segcap));
        cb->segs = s;
        cb->segcap = cap;
    }
    seg_t* s = &cb->segs[index];
    memset(s, 0, sizeof(*s));
    if (sty & CBLK_TERMALL) s->maxpasses = 1;
    else if (sty & CBLK_BYPASS) {
        if (first) s->maxpasses = 10;
        else s->maxpasses = (s[-1].maxpasses == 1 || s[-1].maxpasses == 10) ? 2 : 1;
    } else s->maxpasses = 109;
    return 0;
}

static int getnumpasses(bio_t* b) {
    if (!bio_read(b, 1)) return 1;
    if (!bio_read(b, 1)) return 2;
    uint32_t n = bio_read(b, 2);
    if (n != 3) return 3 + (int)n;
    n = bio_read(b, 5);
    if (n != 31) return 6 + (int)n;
    return 37 + (int)bio_read(b, 7);
}

static int floorlog2(uint32_t v) {
    int l = 0;
    while (v > 1) {
        v >>= 1;
        ++l;
    }
    return l;
}

typedef struct {
    const uint8_t* hdr;  // PPM / PPT packet headers, or NULL: in the data
    int64_t hlen, hpos;
} hdrsrc_t;

static int add_chunk(cblk_t* cb, const uint8_t* p, int len) {
    if (cb->nchunks == cb->chunkcap) {
        int cap = cb->chunkcap ? cb->chunkcap * 2 : 4;
        chunk_t* c = realloc(cb->chunks, sizeof(chunk_t) * (size_t)cap);
        if (!c) return -1;
        cb->chunks = c;
        cb->chunkcap = cap;
    }
    cb->chunks[cb->nchunks].data = p;
    cb->chunks[cb->nchunks].len = len;
    cb->nchunks++;
    return 0;
}

static int band_empty(const band_t* b) { return b->x1 - b->x0 == 0 || b->y1 - b->y0 == 0; }

// one packet: its header (from the data or the PPM/PPT headers) and its body
static int decode_packet(tile_t* t, const int32_t* prm, int compno, int resno, int precno,
                         int layno, const uint8_t* data, int64_t len, int64_t* pos,
                         int64_t* body, hdrsrc_t* hs, err_t* e) {
    tcomp_t* tc = &t->comps[compno];
    res_t* rs = &tc->res[resno];
    int sty = tc->p[C_CBLKSTY];
    int csty = prm[P_CSTY];
    const uint8_t* cur = data + *pos;
    int64_t left = len - *pos;
    if (csty & 2) {  // SOP: skipped where present
        if (left >= 6 && cur[0] == 0xff && cur[1] == 0x91) {
            cur += 6;
            left -= 6;
        }
    }
    const uint8_t* hp;
    int64_t hleft;
    if (hs->hdr) {
        hp = hs->hdr + hs->hpos;
        hleft = hs->hlen - hs->hpos;
    } else {
        hp = cur;
        hleft = left;
    }
    bio_t b;
    bio_init(&b, hp, hleft);
    int present = (int)bio_read(&b, 1);
    if (present) {
        for (int bn = 0; bn < rs->nbands; ++bn) {
            band_t* bd = &rs->bands[bn];
            if (band_empty(bd)) continue;
            prec_t* pr = &bd->precs[precno];
            int nb = pr->cw * pr->ch;
            for (int k = 0; k < nb; ++k) {
                cblk_t* cb = &pr->cblks[k];
                int inc;
                if (!cb->numsegs) inc = tgt_decode(&b, &pr->incl, k, layno + 1);
                else inc = (int)bio_read(&b, 1);
                if (!inc) {
                    cb->numnewpasses = 0;
                    continue;
                }
                if (!cb->numsegs) {
                    int i = 0;
                    // ends by i = 1000 at the latest (a leaf starts at 999); a block with
                    // more zero bit-planes than the band has decodes to zeros
                    while (!tgt_decode(&b, &pr->imsb, k, i)) ++i;
                    cb->numbps = bd->numbps + 1 - i;
                    cb->numlenbits = 3;
                }
                cb->numnewpasses = getnumpasses(&b);
                int inc_bits = 0;
                while (bio_read(&b, 1)) {
                    ++inc_bits;
                    if (inc_bits > 32) return fail(e, "bad Lblock increment");
                }
                cb->numlenbits += inc_bits;
                int segno = 0;
                if (!cb->numsegs) {
                    if (seg_init(cb, 0, sty, 1)) return fail(e, "out of memory");
                } else {
                    segno = cb->numsegs - 1;
                    if (cb->segs[segno].numpasses == cb->segs[segno].maxpasses) {
                        ++segno;
                        if (seg_init(cb, segno, sty, 0)) return fail(e, "out of memory");
                    }
                }
                int n = cb->numnewpasses;
                do {
                    seg_t* s = &cb->segs[segno];
                    int room = s->maxpasses - s->numpasses;
                    s->newpasses = room < n ? room : n;
                    int bits = cb->numlenbits + floorlog2((uint32_t)s->newpasses);
                    if (bits > 32) return fail(e, "bad codeword segment length");
                    s->newlen = (int)bio_read(&b, bits);
                    n -= s->newpasses;
                    if (n > 0) {
                        ++segno;
                        if (seg_init(cb, segno, sty, 0)) return fail(e, "out of memory");
                    }
                } while (n > 0);
            }
        }
    }
    bio_inalign(&b);
    const uint8_t* hend = b.bp;
    if (csty & 4) {  // EPH: required after every packet header
        int64_t room = (hs->hdr ? hs->hdr + hs->hlen : data + len) - hend;
        if (room < 2) return fail(e, "no room for a required EPH marker");
        if (hend[0] != 0xff || hend[1] != 0x92) return fail(e, "expected an EPH marker");
        hend += 2;
    }
    if (hs->hdr) hs->hpos = hend - hs->hdr;
    else cur = hend;
    *body = cur - data;
    if (present) {
        const uint8_t* end = data + len;
        for (int bn = 0; bn < rs->nbands; ++bn) {
            band_t* bd = &rs->bands[bn];
            if (band_empty(bd)) continue;
            prec_t* pr = &bd->precs[precno];
            int nb = pr->cw * pr->ch;
            for (int k = 0; k < nb; ++k) {
                cblk_t* cb = &pr->cblks[k];
                if (!cb->numnewpasses) continue;
                int segno;
                if (!cb->numsegs) {
                    segno = 0;
                    cb->numsegs = 1;
                } else {
                    segno = cb->numsegs - 1;
                    if (cb->segs[segno].numpasses == cb->segs[segno].maxpasses) {
                        ++segno;
                        cb->numsegs++;
                    }
                }
                do {
                    seg_t* s = &cb->segs[segno];
                    if (s->newlen < 0 || s->newlen > end - cur)
                        return fail(e, "a code-block's segment runs past the tile's data");
                    if (s->newlen && add_chunk(cb, cur, s->newlen)) return fail(e, "out of memory");
                    cur += s->newlen;
                    s->len += s->newlen;
                    s->numpasses += s->newpasses;
                    cb->numnewpasses -= s->newpasses;
                    if (cb->numnewpasses > 0) {
                        ++segno;
                        cb->numsegs++;
                    }
                } while (cb->numnewpasses > 0);
            }
        }
    }
    *pos = cur - data;
    return 0;
}

// the packets of the tile in OpenJPEG's order (opj_pi_next_*), each once
typedef struct {
    tile_t* t;
    const int32_t* prm;
    const uint8_t* data;
    int64_t len, pos;
    hdrsrc_t* hs;
    uint8_t* include;
    int step_l, step_r, step_c;
    int64_t* bounds;  // or NULL: (start, body, end) of each packet in the data
    int64_t nbounds, cap;
    err_t* e;
} pi_t;

static int packet(pi_t* pi, int l, int r, int c, int p) {
    size_t idx = (size_t)l * pi->step_l + (size_t)r * pi->step_r + (size_t)c * pi->step_c + (size_t)p;
    if (pi->include[idx]) return 0;
    pi->include[idx] = 1;
    int64_t start = pi->pos, body = 0;
    int rc = decode_packet(pi->t, pi->prm, c, r, p, l, pi->data, pi->len, &pi->pos, &body, pi->hs,
                           pi->e);
    if (!rc && pi->bounds && pi->nbounds < pi->cap) {
        pi->bounds[3 * pi->nbounds] = start;
        pi->bounds[3 * pi->nbounds + 1] = body;
        pi->bounds[3 * pi->nbounds + 2] = pi->pos;
        pi->nbounds++;
    }
    return rc;
}

// the precinct of (x, y) in component c, resolution r, or -1 (RPCL, PCRL, CPRL)
static int position_precinct(pi_t* pi, int c, int r, uint32_t x, uint32_t y) {
    tcomp_t* tc = &pi->t->comps[c];
    if (r >= tc->numres) return -1;
    res_t* rs = &tc->res[r];
    uint32_t dx = (uint32_t)tc->p[C_DX], dy = (uint32_t)tc->p[C_DY];
    int level = tc->numres - 1 - r;
    uint64_t cdx = (uint64_t)dx << level, cdy = (uint64_t)dy << level;
    uint32_t tx0 = (uint32_t)pi->t->tx0, ty0 = (uint32_t)pi->t->ty0;
    uint32_t trx0 = (uint32_t)((tx0 + cdx - 1) / cdx), try0 = (uint32_t)((ty0 + cdy - 1) / cdy);
    uint32_t trx1 = (uint32_t)(((uint64_t)pi->t->tx1 + cdx - 1) / cdx);
    uint32_t try1 = (uint32_t)(((uint64_t)pi->t->ty1 + cdy - 1) / cdy);
    int rpx = rs->pdx + level, rpy = rs->pdy + level;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!((uint64_t)y % ((uint64_t)dy << rpy) == 0 ||
          (y == ty0 && (((uint64_t)try0 << level) % ((uint64_t)1 << rpy)))))
        return -1;
    if (!((uint64_t)x % ((uint64_t)dx << rpx) == 0 ||
          (x == tx0 && (((uint64_t)trx0 << level) % ((uint64_t)1 << rpx)))))
        return -1;
    if (rs->pw == 0 || rs->ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    uint32_t prci = (uint32_t)(((x + cdx - 1) / cdx) >> rs->pdx) - (trx0 >> rs->pdx);
    uint32_t prcj = (uint32_t)(((y + cdy - 1) / cdy) >> rs->pdy) - (try0 >> rs->pdy);
    return (int)(prci + prcj * (uint32_t)rs->pw);
}

// the least precinct step on the reference grid over the components [c0, c1)
static void position_steps(pi_t* pi, int c0, int c1, uint32_t* sx, uint32_t* sy) {
    *sx = *sy = 0;
    for (int c = c0; c < c1; ++c) {
        tcomp_t* tc = &pi->t->comps[c];
        for (int r = 0; r < tc->numres; ++r) {
            int ex = tc->res[r].pdx + tc->numres - 1 - r, ey = tc->res[r].pdy + tc->numres - 1 - r;
            if (ex < 32) {
                uint64_t d = (uint64_t)tc->p[C_DX] << ex;
                if (d <= 0xffffffffu && (!*sx || d < *sx)) *sx = (uint32_t)d;
            }
            if (ey < 32) {
                uint64_t d = (uint64_t)tc->p[C_DY] << ey;
                if (d <= 0xffffffffu && (!*sy || d < *sy)) *sy = (uint32_t)d;
            }
        }
    }
}

static int progression(pi_t* pi, int prg, int l1, int r0, int r1, int c0, int c1) {
    tile_t* t = pi->t;
    uint32_t tx0 = (uint32_t)t->tx0, ty0 = (uint32_t)t->ty0, tx1 = (uint32_t)t->tx1,
             ty1 = (uint32_t)t->ty1;
    uint32_t sx, sy;
    if (prg == 0) {  // LRCP
        for (int l = 0; l < l1; ++l)
            for (int r = r0; r < r1; ++r)
                for (int c = c0; c < c1; ++c) {
                    tcomp_t* tc = &t->comps[c];
                    if (r >= tc->numres) continue;
                    for (int p = 0; p < tc->res[r].pw * tc->res[r].ph; ++p)
                        if (packet(pi, l, r, c, p)) return 1;
                }
        return 0;
    }
    if (prg == 1) {  // RLCP
        for (int r = r0; r < r1; ++r)
            for (int l = 0; l < l1; ++l)
                for (int c = c0; c < c1; ++c) {
                    tcomp_t* tc = &t->comps[c];
                    if (r >= tc->numres) continue;
                    for (int p = 0; p < tc->res[r].pw * tc->res[r].ph; ++p)
                        if (packet(pi, l, r, c, p)) return 1;
                }
        return 0;
    }
    if (prg == 2 || prg == 3) {  // RPCL, PCRL
        position_steps(pi, 0, t->ncomp, &sx, &sy);
        if (!sx || !sy) return 0;
        if (prg == 2) {
            for (int r = r0; r < r1; ++r)
                for (uint32_t y = ty0; y < ty1; y += sy - (y % sy))
                    for (uint32_t x = tx0; x < tx1; x += sx - (x % sx))
                        for (int c = c0; c < c1; ++c) {
                            int p = position_precinct(pi, c, r, x, y);
                            if (p < 0) continue;
                            for (int l = 0; l < l1; ++l)
                                if (packet(pi, l, r, c, p)) return 1;
                        }
        } else {
            for (uint32_t y = ty0; y < ty1; y += sy - (y % sy))
                for (uint32_t x = tx0; x < tx1; x += sx - (x % sx))
                    for (int c = c0; c < c1; ++c) {
                        int rend = r1 < t->comps[c].numres ? r1 : t->comps[c].numres;
                        for (int r = r0; r < rend; ++r) {
                            int p = position_precinct(pi, c, r, x, y);
                            if (p < 0) continue;
                            for (int l = 0; l < l1; ++l)
                                if (packet(pi, l, r, c, p)) return 1;
                        }
                    }
        }
        return 0;
    }
    // CPRL: the steps of each component alone
    for (int c = c0; c < c1; ++c) {
        position_steps(pi, c, c + 1, &sx, &sy);
        if (!sx || !sy) return 0;
        int rend = r1 < t->comps[c].numres ? r1 : t->comps[c].numres;
        for (uint32_t y = ty0; y < ty1; y += sy - (y % sy))
            for (uint32_t x = tx0; x < tx1; x += sx - (x % sx))
                for (int r = r0; r < rend; ++r) {
                    int p = position_precinct(pi, c, r, x, y);
                    if (p < 0) continue;
                    for (int l = 0; l < l1; ++l)
                        if (packet(pi, l, r, c, p)) return 1;
                }
    }
    return 0;
}

// --- tier 1: the MQ decoder ---------------------------------------------------

static const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
    0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
    0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
    0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
static const uint8_t NMPS[47] = {
    1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
static const uint8_t NLPS[47] = {
    1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21,
    22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
static const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19 };

typedef struct {
    const uint8_t* bp;  // within a buffer that ends with 0xFF 0xFF after the segment
    uint32_t a, c;
    int ct;
    uint8_t state[NCTX], mps[NCTX];
} mqc_t;

static void mqc_reset(mqc_t* m) {
    memset(m->state, 0, sizeof(m->state));
    memset(m->mps, 0, sizeof(m->mps));
    m->state[CTX_UNI] = 46;
    m->state[CTX_AGG] = 3;
    m->state[CTX_ZC] = 4;
}

static void mqc_bytein(mqc_t* m) {
    if (m->bp[0] == 0xff) {
        if (m->bp[1] > 0x8f) {
            m->c += 0xff00;
            m->ct = 8;
        } else {
            m->bp++;
            m->c += (uint32_t)m->bp[0] << 9;
            m->ct = 7;
        }
    } else {
        m->bp++;
        m->c += (uint32_t)m->bp[0] << 8;
        m->ct = 8;
    }
}

static void mqc_init(mqc_t* m, const uint8_t* bp, int len) {
    m->bp = bp;
    m->c = len == 0 ? 0xffu << 16 : (uint32_t)bp[0] << 16;
    mqc_bytein(m);
    m->c <<= 7;
    m->ct -= 7;
    m->a = 0x8000;
}

static inline void mqc_renorm(mqc_t* m) {
    do {
        if (m->ct == 0) mqc_bytein(m);
        m->a <<= 1;
        m->c <<= 1;
        m->ct--;
    } while (m->a < 0x8000);
}

static inline int mqc_decode(mqc_t* m, int cx) {
    int s = m->state[cx], d;
    uint32_t qe = QE[s];
    m->a -= qe;
    if ((m->c >> 16) < qe) {  // the LPS sub-interval, or the MPS by conditional exchange
        if (m->a < qe) {
            d = m->mps[cx];
            m->state[cx] = NMPS[s];
        } else {
            d = !m->mps[cx];
            if (SWITCH[s]) m->mps[cx] = (uint8_t)!m->mps[cx];
            m->state[cx] = NLPS[s];
        }
        m->a = qe;
        mqc_renorm(m);
    } else {
        m->c -= qe << 16;
        if ((m->a & 0x8000) == 0) {
            if (m->a < qe) {
                d = !m->mps[cx];
                if (SWITCH[s]) m->mps[cx] = (uint8_t)!m->mps[cx];
                m->state[cx] = NLPS[s];
            } else {
                d = m->mps[cx];
                m->state[cx] = NMPS[s];
            }
            mqc_renorm(m);
        } else {
            d = m->mps[cx];
        }
    }
    return d;
}

// the raw (bypass) bits
static void raw_init(mqc_t* m, const uint8_t* bp) {
    m->bp = bp;
    m->c = 0;
    m->ct = 0;
}

static inline int raw_decode(mqc_t* m) {
    if (m->ct == 0) {
        if (m->c == 0xff) {
            if (m->bp[0] > 0x8f) {
                m->c = 0xff;
                m->ct = 8;
            } else {
                m->c = m->bp[0];
                m->bp++;
                m->ct = 7;
            }
        } else {
            m->c = m->bp[0];
            m->bp++;
            m->ct = 8;
        }
    }
    m->ct--;
    return (int)((m->c >> m->ct) & 1u);
}

// --- tier 1: the coding passes ---------------------------------------------

// a sample's flags: its significant neighbours, counted as they become
// significant (bits 0-1 west + east, 2 north, 3 south, 4-5 north-west +
// north-east, 6-7 south-west + south-east), then its own state
enum { NB = 0xFF, NB_ABOVE = 0x37, SIG = 1 << 8, PI = 1 << 9, MU = 1 << 10, NEG = 1 << 11 };

typedef struct {
    int w, h, stride;  // stride: w + 2 (a border of one sample)
    uint16_t* f;       // the flags above
    int32_t* data;
    int vsc, orient;
    mqc_t mq;
} t1_t;

// the neighbours' significance; vertically causal: the last row of a stripe
// does not see the next stripe
static inline int neighbour_bits(const t1_t* t, int i, int y) {
    return t->f[i] & (t->vsc && (y & 3) == 3 ? NB_ABOVE : NB);
}

static inline int zc_context(const t1_t* t, int i, int y) {
    int n = neighbour_bits(t, i, y);
    int h = n & 3, v = ((n >> 2) & 1) + ((n >> 3) & 1), d = ((n >> 4) & 3) + (n >> 6);
    if (t->orient == 3) {
        int hv = h + v;
        if (d == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
        if (d == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
        if (d == 2) return hv == 0 ? 6 : 7;
        return 8;
    }
    if (t->orient == 1) {  // HL: the vertical neighbours lead
        int s = h;
        h = v;
        v = s;
    }
    if (h == 0) {
        if (v == 0) return d == 0 ? 0 : d == 1 ? 1 : 2;
        return v == 1 ? 3 : 4;
    }
    if (h == 1) return v ? 7 : (d ? 6 : 5);
    return 8;
}

static inline int any_neighbour(const t1_t* t, int i, int y) {
    return neighbour_bits(t, i, y) != 0;
}

// the sign's context and the bit it is XORed with
static inline int sc_context(const t1_t* t, int i, int y, int* xorbit) {
    const uint16_t* f = t->f + i;
    int below = !(t->vsc && (y & 3) == 3);
#define SIGN(g) ((g) & SIG ? ((g) & NEG ? -1 : 1) : 0)
    int hc = SIGN(f[-1]) + SIGN(f[1]);
    int vc = SIGN(f[-t->stride]) + (below ? SIGN(f[t->stride]) : 0);
#undef SIGN
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    if (hc < 0) {
        hc = -hc;
        vc = -vc;
        *xorbit = 1;
    } else if (hc == 0 && vc < 0) {
        vc = -vc;
        *xorbit = 1;
    } else {
        *xorbit = 0;
    }
    if (hc == 0) return CTX_SC + (vc ? 1 : 0);  // 9 or 10
    return CTX_SC + (vc == 1 ? 4 : vc == 0 ? 3 : 2);  // 13, 12, 11
}

static inline void set_significant(t1_t* t, int i, int negative) {
    int s = t->stride;
    uint16_t* f = t->f;
    f[i] |= SIG | (negative ? NEG : 0);
    f[i - 1] += 1;
    f[i + 1] += 1;
    f[i - s] += 8;
    f[i + s] += 4;
    f[i - s - 1] += 64;
    f[i - s + 1] += 64;
    f[i + s - 1] += 16;
    f[i + s + 1] += 16;
}

static void sigpass(t1_t* t, int bpno, int raw) {
    int one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < t->h; k += 4)
        for (int x = 0; x < t->w; ++x)
            for (int y = k; y < k + 4 && y < t->h; ++y) {
                int i = (y + 1) * t->stride + x + 1;
                if ((t->f[i] & SIG) || !any_neighbour(t, i, y)) continue;
                int v;
                if (raw) {
                    if (raw_decode(&t->mq)) {
                        v = raw_decode(&t->mq);
                        t->data[y * t->w + x] = v ? -oneplushalf : oneplushalf;
                        set_significant(t, i, v);
                    }
                } else if (mqc_decode(&t->mq, zc_context(t, i, y))) {
                    int xb, cx = sc_context(t, i, y, &xb);
                    v = mqc_decode(&t->mq, cx) ^ xb;
                    t->data[y * t->w + x] = v ? -oneplushalf : oneplushalf;
                    set_significant(t, i, v);
                }
                t->f[i] |= PI;
            }
}

static void refpass(t1_t* t, int bpno, int raw) {
    int poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < t->h; k += 4)
        for (int x = 0; x < t->w; ++x)
            for (int y = k; y < k + 4 && y < t->h; ++y) {
                int i = (y + 1) * t->stride + x + 1;
                if ((t->f[i] & (SIG | PI)) != SIG) continue;
                int v;
                if (raw) v = raw_decode(&t->mq);
                else {
                    int cx = CTX_MAG + (t->f[i] & MU ? 2 : any_neighbour(t, i, y) ? 1 : 0);
                    v = mqc_decode(&t->mq, cx);
                }
                int32_t* d = &t->data[y * t->w + x];
                *d += (v ^ (*d < 0)) ? poshalf : -poshalf;
                t->f[i] |= MU;
            }
}

static void cln_step(t1_t* t, int x, int y, int oneplushalf, int skip_zc) {
    int i = (y + 1) * t->stride + x + 1;
    if (!skip_zc && !mqc_decode(&t->mq, zc_context(t, i, y))) return;
    int xb, cx = sc_context(t, i, y, &xb);
    int v = mqc_decode(&t->mq, cx) ^ xb;
    t->data[y * t->w + x] = v ? -oneplushalf : oneplushalf;
    set_significant(t, i, v);
}

static void clnpass(t1_t* t, int bpno, int segsym) {
    int one = 1 << bpno, oneplushalf = one | (one >> 1);
    int full = t->h & ~3;
    for (int k = 0; k < t->h; k += 4)
        for (int x = 0; x < t->w; ++x) {
            int y0 = k;
            if (k < full) {  // run-length mode where the column is quiet
                int quiet = 1;
                for (int y = k; y < k + 4 && quiet; ++y) {
                    int i = (y + 1) * t->stride + x + 1;
                    if ((t->f[i] & (SIG | PI)) || any_neighbour(t, i, y)) quiet = 0;
                }
                if (quiet) {
                    if (!mqc_decode(&t->mq, CTX_AGG)) {
                        for (int y = k; y < k + 4; ++y) t->f[(y + 1) * t->stride + x + 1] &= ~PI;
                        continue;
                    }
                    int run = mqc_decode(&t->mq, CTX_UNI);
                    run = (run << 1) | mqc_decode(&t->mq, CTX_UNI);
                    cln_step(t, x, k + run, oneplushalf, 1);
                    y0 = k + run + 1;
                    for (int y = y0; y < k + 4; ++y) cln_step(t, x, y, oneplushalf, 0);
                    for (int y = k; y < k + 4; ++y) t->f[(y + 1) * t->stride + x + 1] &= ~PI;
                    continue;
                }
            }
            for (int y = k; y < k + 4 && y < t->h; ++y) {
                int i = (y + 1) * t->stride + x + 1;
                if (!(t->f[i] & (SIG | PI))) cln_step(t, x, y, oneplushalf, 0);
                t->f[i] &= ~PI;
            }
        }
    if (segsym) {
        for (int n = 0; n < 4; ++n) mqc_decode(&t->mq, CTX_UNI);
    }
}

// a code-block's coefficients, doubled (one bit below the last bit-plane)
static int t1_decode(t1_t* t, const cblk_t* cb, int orient, int sty, int roishift,
                     uint8_t** buf, int* bufcap, err_t* e) {
    int w = cb->x1 - cb->x0, h = cb->y1 - cb->y0;
    t->w = w;
    t->h = h;
    t->stride = w + 2;
    size_t nf = (size_t)(w + 2) * (size_t)(h + 2);
    memset(t->f, 0, nf * sizeof(uint16_t));
    memset(t->data, 0, sizeof(int32_t) * (size_t)w * (size_t)h);
    t->vsc = (sty & CBLK_VSC) != 0;
    t->orient = orient;
    if (!cb->numsegs) return 0;
    int bpno1 = roishift + cb->numbps;
    if (bpno1 >= 31) return fail(e, "a code-block with 31 or more bit-planes");
    // the chunks in one buffer, followed by 0xFF 0xFF
    int total = 0;
    for (int k = 0; k < cb->nchunks; ++k) total += cb->chunks[k].len;
    if (total + 2 > *bufcap) {
        uint8_t* nb = realloc(*buf, (size_t)total + 2);
        if (!nb) return fail(e, "out of memory");
        *buf = nb;
        *bufcap = total + 2;
    }
    uint8_t* data = *buf;
    int at = 0;
    for (int k = 0; k < cb->nchunks; ++k) {
        memcpy(data + at, cb->chunks[k].data, (size_t)cb->chunks[k].len);
        at += cb->chunks[k].len;
    }
    mqc_reset(&t->mq);
    int passtype = 2, index = 0;
    uint8_t saved[2];
    for (int s = 0; s < cb->numsegs; ++s) {
        const seg_t* sg = &cb->segs[s];
        int raw = bpno1 <= cb->numbps - 4 && passtype < 2 && (sty & CBLK_BYPASS);
        // the end of the segment reads as a marker, 0xFF 0xFF
        memcpy(saved, data + index + sg->len, 2);
        data[index + sg->len] = 0xff;
        data[index + sg->len + 1] = 0xff;
        if (raw) raw_init(&t->mq, data + index);
        else mqc_init(&t->mq, data + index, sg->len);
        for (int p = 0; p < sg->numpasses && bpno1 >= 1; ++p) {
            if (passtype == 0) sigpass(t, bpno1, raw);
            else if (passtype == 1) refpass(t, bpno1, raw);
            else clnpass(t, bpno1, (sty & CBLK_SEGSYM) != 0);
            if ((sty & CBLK_RESET) && !raw) mqc_reset(&t->mq);
            if (++passtype == 3) {
                passtype = 0;
                bpno1--;
            }
        }
        memcpy(data + index + sg->len, saved, 2);
        index += sg->len;
    }
    if (roishift) {
        if (roishift >= 31) {
            memset(t->data, 0, sizeof(int32_t) * (size_t)w * (size_t)h);
        } else {
            int32_t thresh = 1 << roishift;
            for (int k = 0; k < w * h; ++k) {
                int32_t v = t->data[k], mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                    mag >>= roishift;
                    t->data[k] = v < 0 ? -mag : mag;
                }
            }
        }
    }
    return 0;
}

// every code-block of a component, dequantised into the component's samples
static int tier1(tcomp_t* tc, err_t* e) {
    int sty = tc->p[C_CBLKSTY], roishift = tc->p[C_ROISHIFT];
    int tw = tc->x1 - tc->x0;
    int maxw = 1 << tc->p[C_CBW], maxh = 1 << tc->p[C_CBH];
    size_t nf = (size_t)(maxw + 2) * (size_t)(maxh + 2);
    t1_t t;
    memset(&t, 0, sizeof(t));
    t.f = calloc(nf, sizeof(uint16_t));
    t.data = calloc((size_t)maxw * (size_t)maxh, sizeof(int32_t));
    uint8_t* buf = NULL;
    int bufcap = 0, rc = 0;
    if (!t.f || !t.data) rc = fail(e, "out of memory");
    for (int r = 0; r < tc->numres && !rc; ++r) {
        res_t* rs = &tc->res[r];
        for (int b = 0; b < rs->nbands && !rc; ++b) {
            band_t* bd = &rs->bands[b];
            if (band_empty(bd)) continue;
            for (int p = 0; p < rs->pw * rs->ph && !rc; ++p) {
                prec_t* pr = &bd->precs[p];
                for (int k = 0; k < pr->cw * pr->ch && !rc; ++k) {
                    cblk_t* cb = &pr->cblks[k];
                    int w = cb->x1 - cb->x0, h = cb->y1 - cb->y0;
                    if (w <= 0 || h <= 0) continue;
                    rc = t1_decode(&t, cb, bd->bandno, sty, roishift, &buf, &bufcap, e);
                    if (rc) break;
                    // the block's place among the component's samples (LL | HL over LH | HH)
                    int x = cb->x0 - bd->x0, y = cb->y0 - bd->y0;
                    if (bd->bandno & 1) x += tc->res[r - 1].x1 - tc->res[r - 1].x0;
                    if (bd->bandno & 2) y += tc->res[r - 1].y1 - tc->res[r - 1].y0;
                    if (tc->idata) {
                        for (int j = 0; j < h; ++j)
                            for (int i = 0; i < w; ++i)
                                tc->idata[(size_t)(y + j) * tw + x + i] = t.data[j * w + i] / 2;
                    } else {
                        float step = 0.5f * bd->stepsize;
                        for (int j = 0; j < h; ++j)
                            for (int i = 0; i < w; ++i)
                                tc->fdata[(size_t)(y + j) * tw + x + i] = (float)t.data[j * w + i] * step;
                    }
                }
            }
        }
    }
    free(t.f);
    free(t.data);
    free(buf);
    return rc;
}

// --- the inverse DWT ------------------------------------------------------------

// The inverse DWT of a resolution: each of n lines (rows, then columns),
// stored as its sn low-pass then its high-pass coefficients, the first at an
// even (cas 0) or odd (cas 1) position, is interleaved and lifted with
// symmetric extension (a sample past either end is its mirror inside).  The
// columns are lifted m at a time: m lines side by side, every sample of a
// row of them at once, as the arithmetic of each sample is the same.

// the interleaved position k of a line's coefficient: its index in storage
static inline int stored(int k, int sn, int cas) {
    return ((k + cas) & 1) == 0 ? (cas ? (k - 1) / 2 : k / 2) : sn + (cas ? k / 2 : (k - 1) / 2);
}

// x: n interleaved positions of m samples each (position k at x + k * m)
static void lift53(int32_t* x, int n, size_t m, int parity) {
    for (int k = parity; k < n; k += 2) {
        const int32_t* a = x + (size_t)(k > 0 ? k - 1 : k + 1) * m;
        const int32_t* b = x + (size_t)(k + 1 < n ? k + 1 : k - 1) * m;
        int32_t* v = x + (size_t)k * m;
        if (parity == 0)  // the low-pass positions of an even-first line: the update step
            for (size_t i = 0; i < m; ++i) v[i] -= (a[i] + b[i] + 2) >> 2;
        else
            for (size_t i = 0; i < m; ++i) v[i] += (a[i] + b[i]) >> 1;
    }
}

static void idwt53(int32_t* x, int n, size_t m, int cas) {
    if (n == 1) {  // one sample: kept, or halved where it is high-pass
        if (cas)
            for (size_t i = 0; i < m; ++i) x[i] /= 2;
        return;
    }
    if (cas) {  // low-pass at odd positions: the same steps on the other parity
        for (int k = 1; k < n; k += 2) {
            const int32_t* a = x + (size_t)(k - 1) * m;
            const int32_t* b = x + (size_t)(k + 1 < n ? k + 1 : k - 1) * m;
            int32_t* v = x + (size_t)k * m;
            for (size_t i = 0; i < m; ++i) v[i] -= (a[i] + b[i] + 2) >> 2;
        }
        for (int k = 0; k < n; k += 2) {
            const int32_t* a = x + (size_t)(k > 0 ? k - 1 : k + 1) * m;
            const int32_t* b = x + (size_t)(k + 1 < n ? k + 1 : k - 1) * m;
            int32_t* v = x + (size_t)k * m;
            for (size_t i = 0; i < m; ++i) v[i] += (a[i] + b[i]) >> 1;
        }
        return;
    }
    lift53(x, n, m, 0);
    lift53(x, n, m, 1);
}

static const float K97 = 1.230174105f, TWO_INV_K97 = 1.625732422f;
static const float ALPHA = -1.586134342f, BETA = -0.052980118f, GAMMA = 0.882911075f,
                   DELTA = 0.443506852f;

static void lift97(float* x, int n, size_t m, int parity, float c) {
    for (int k = parity; k < n; k += 2) {
        const float* a = x + (size_t)(k > 0 ? k - 1 : k + 1) * m;
        const float* b = x + (size_t)(k + 1 < n ? k + 1 : k - 1) * m;
        float* v = x + (size_t)k * m;
        for (size_t i = 0; i < m; ++i) v[i] = v[i] + (a[i] + b[i]) * c;
    }
}

// OpenJPEG's: the low-pass scaled by K, the high-pass by 2/K, then the four
// lifting steps; one sample is left as it is
static void idwt97(float* x, int n, size_t m, int cas) {
    if (n <= 1) return;
    for (int k = 0; k < n; ++k) {
        float c = ((k + cas) & 1) == 0 ? K97 : TWO_INV_K97;
        float* v = x + (size_t)k * m;
        for (size_t i = 0; i < m; ++i) v[i] = v[i] * c;
    }
    lift97(x, n, m, cas, -DELTA);
    lift97(x, n, m, !cas, -GAMMA);
    lift97(x, n, m, cas, -BETA);
    lift97(x, n, m, !cas, -ALPHA);
}

static int idwt(tcomp_t* tc, err_t* e) {
    int w = tc->x1 - tc->x0, h = tc->y1 - tc->y0;
    size_t area = (size_t)w * (size_t)h;
    size_t size = tc->idata ? sizeof(int32_t) : sizeof(float);
    char* tmp = malloc(size * (area > (size_t)w ? area : (size_t)w + 1));
    if (!tmp) return fail(e, "out of memory");
    char* data = tc->idata ? (char*)tc->idata : (char*)tc->fdata;
    for (int r = 1; r < tc->numres; ++r) {
        res_t* lo = &tc->res[r - 1];
        res_t* rs = &tc->res[r];
        int rw = rs->x1 - rs->x0, rh = rs->y1 - rs->y0;
        int snw = lo->x1 - lo->x0, snh = lo->y1 - lo->y0;
        int casx = rs->x0 & 1, casy = rs->y0 & 1;
        // rows, each interleaved into tmp and lifted there
        for (int j = 0; j < rh && rw > 0; ++j) {
            char* row = data + (size_t)j * w * size;
            for (int k = 0; k < rw; ++k)
                memcpy(tmp + (size_t)k * size, row + (size_t)stored(k, snw, casx) * size, size);
            if (tc->idata) idwt53((int32_t*)tmp, rw, 1, casx);
            else idwt97((float*)tmp, rw, 1, casx);
            memcpy(row, tmp, (size_t)rw * size);
        }
        // columns: the rows interleaved into tmp, all columns lifted together
        if (rh <= 0 || rw <= 0) continue;
        for (int k = 0; k < rh; ++k)
            memcpy(tmp + (size_t)k * rw * size, data + (size_t)stored(k, snh, casy) * w * size,
                   (size_t)rw * size);
        if (tc->idata) idwt53((int32_t*)tmp, rh, (size_t)rw, casy);
        else idwt97((float*)tmp, rh, (size_t)rw, casy);
        for (int k = 0; k < rh; ++k)
            memcpy(data + (size_t)k * w * size, tmp + (size_t)k * rw * size, (size_t)rw * size);
    }
    free(tmp);
    return 0;
}

// --- the whole tile ---------------------------------------------------------------

// Decodes one tile into the components' planes.  prm: the parameter block
// above; data: the tile's bytes (its tile-parts' bodies, in order); hdr: the
// packet headers of PPM / PPT, or NULL, read from *hpos on; out: one
// int32 plane a component (its C_W x C_H samples); bounds: NULL, or room for
// cap triples (start, body, end) of the packets in the data, bounds[0] on
// return their count (the test fixtures move packet headers with them).
// Returns 0, or 1 with the fault in err.
int j2k_decode_tile(const int32_t* prm, const uint8_t* data, int64_t len, const uint8_t* hdr,
                    int64_t hlen, int64_t* hpos, int32_t** out, int64_t* bounds, int64_t cap,
                    char* err, int errlen) {
    err_t e = {err, errlen};
    if (err && errlen > 0) err[0] = 0;
    tile_t t;
    memset(&t, 0, sizeof(t));
    int rc = tile_init(&t, prm, &e);
    // packets
    if (!rc) {
        int maxres = 0, maxprec = 0;
        for (int c = 0; c < t.ncomp; ++c) {
            tcomp_t* tc = &t.comps[c];
            if (tc->numres > maxres) maxres = tc->numres;
            for (int r = 0; r < tc->numres; ++r)
                if (tc->res[r].pw * tc->res[r].ph > maxprec) maxprec = tc->res[r].pw * tc->res[r].ph;
        }
        int layers = prm[P_LAYERS];
        pi_t pi;
        hdrsrc_t hs = {hdr, hlen, hpos ? *hpos : 0};
        pi.t = &t;
        pi.prm = prm;
        pi.data = data;
        pi.len = len;
        pi.pos = 0;
        pi.hs = &hs;
        pi.e = &e;
        pi.bounds = bounds ? bounds + 1 : NULL;
        pi.nbounds = 0;
        pi.cap = cap;
        pi.step_c = maxprec;
        pi.step_r = t.ncomp * pi.step_c;
        pi.step_l = maxres * pi.step_r;
        size_t n = (size_t)layers * (size_t)pi.step_l;
        pi.include = n <= ((size_t)1 << 28) ? calloc(n ? n : 1, 1) : NULL;
        if (!pi.include) rc = fail(&e, "too many packets in a tile");
        int npoc = prm[P_NPOC];
        if (!rc && npoc == 0) {
            rc = progression(&pi, prm[P_PROG], layers, 0, maxres, 0, t.ncomp);
        }
        for (int k = 0; k < npoc && !rc; ++k) {
            const int32_t* q = prm + P_POC + 6 * k;
            int le = q[2] < layers ? q[2] : layers;
            int ce = q[4] < t.ncomp ? q[4] : t.ncomp;
            if (q[1] >= t.ncomp) {
                rc = fail(&e, "a POC's first component is past the last");
                break;
            }
            rc = progression(&pi, q[5], le, q[0], q[3], q[1], ce);
        }
        if (hpos) *hpos = hs.hpos;
        if (bounds) bounds[0] = pi.nbounds;
        free(pi.include);
    }
    for (int c = 0; c < t.ncomp && !rc; ++c) rc = tier1(&t.comps[c], &e);
    for (int c = 0; c < t.ncomp && !rc; ++c) rc = idwt(&t.comps[c], &e);
    // the inverse multiple-component transform: RCT (5/3) or ICT (9/7)
    if (!rc && prm[P_MCT] && t.ncomp >= 3) {
        tcomp_t *a = &t.comps[0], *b = &t.comps[1], *c = &t.comps[2];
        size_t n = (size_t)(a->x1 - a->x0) * (size_t)(a->y1 - a->y0);
        if ((size_t)(b->x1 - b->x0) * (size_t)(b->y1 - b->y0) != n ||
            (size_t)(c->x1 - c->x0) * (size_t)(c->y1 - c->y0) != n)
            rc = fail(&e, "the multiple-component transform over components of other sizes");
        else if (a->idata && b->idata && c->idata) {
            for (size_t i = 0; i < n; ++i) {
                int32_t y = a->idata[i], u = b->idata[i], v = c->idata[i];
                int32_t g = y - ((u + v) >> 2);
                a->idata[i] = v + g;
                b->idata[i] = g;
                c->idata[i] = u + g;
            }
        } else if (a->fdata && b->fdata && c->fdata) {
            for (size_t i = 0; i < n; ++i) {
                float y = a->fdata[i], u = b->fdata[i], v = c->fdata[i];
                float r = y + (v * 1.402f);
                float g = y - (u * 0.34413f) - (v * (0.71414f));
                float bb = y + (u * 1.772f);
                a->fdata[i] = r;
                b->fdata[i] = g;
                c->fdata[i] = bb;
            }
        } else {
            rc = fail(&e, "the multiple-component transform over 5/3 and 9/7 components");
        }
    }
    // the DC level shift, clipped to the precision, into the component's plane
    for (int c = 0; c < t.ncomp && !rc; ++c) {
        tcomp_t* tc = &t.comps[c];
        const int32_t* cp = tc->p;
        int prec = cp[C_PREC], sgnd = cp[C_SGND];
        int64_t lo = sgnd ? -((int64_t)1 << (prec - 1)) : 0;
        int64_t hi = sgnd ? ((int64_t)1 << (prec - 1)) - 1 : ((int64_t)1 << prec) - 1;
        int64_t shift = sgnd ? 0 : (int64_t)1 << (prec - 1);
        int w = tc->x1 - tc->x0, h = tc->y1 - tc->y0;
        int ox = tc->x0 - cp[C_X0], oy = tc->y0 - cp[C_Y0];
        for (int j = 0; j < h; ++j) {
            int32_t* dst = out[c] + (size_t)(oy + j) * cp[C_W] + ox;
            for (int i = 0; i < w; ++i) {
                int64_t v;
                if (tc->idata) v = (int64_t)tc->idata[(size_t)j * w + i] + shift;
                else {
                    float f = tc->fdata[(size_t)j * w + i];
                    if (f > (float)INT32_MAX) v = hi;
                    else if (f < (float)INT32_MIN) v = lo;
                    else v = (int64_t)lrintf(f) + shift;
                }
                dst[i] = (int32_t)(v < lo ? lo : v > hi ? hi : v);
            }
        }
    }
    tile_free(&t);
    return rc;
}
