/* Host C of the port's decoder: the CAVLC slice-data parser.
 *
 * Copied from openh264_tpu/native/parse_cavlc.c, which is host code there
 * too. Built with the host compiler by openh264_tpu_torch/_build.py and
 * bound with ctypes by openh264_tpu_torch/decoder/cbind.py
 * (parse_cavlc_slice_native). Nothing here runs on the card. Its MB
 * prediction core (grids, neighbours, MV prediction) is csrc/mb_pred.h,
 * shared with csrc/parse_cabac.c.
 *
 * The decoder's one routing rule (decoder/slice_dec.py c_parses) routes
 * as the JAX package does: I and P CAVLC slices without FMO or the 8x8
 * transform come here, the rest (B, FMO, transform_8x8_mode) go to the
 * per-MB Python parser, and the binding refuses them with
 * NotImplementedError; this parser never falls back to Python. The
 * original note follows.
 *
 * Native CAVLC slice-data parser: bitstream -> FrameSymbols tensors.
 *
 * The decoder's entropy phase is intrinsically serial per slice (SURVEY
 * §7 "decoder entropy is serial per slice => lean host parser emitting
 * symbol tensors"); this is that lean parser. It mirrors the Python
 * parser in decoder/slice_dec.py (itself the conformance-tested parity
 * twin of decode_slice.cpp WelsDecodeMbCavlc{I,P}Slice) instruction for
 * instruction, writing into the same numpy arrays via raw pointers.
 * The VLC tables are passed in from tables/cavlc.py so both parsers
 * decode from the identical LUTs.
 *
 * Scope: I- and P-slice CAVLC without 8x8 transform (the Python parser
 * remains the general path; the dispatcher falls back per slice).
 * B slices, CABAC and transform_8x8 streams take the Python path.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#include "mb_pred.h"

/* ---------- bit reader (MSB first over the unescaped RBSP) ---------- */
typedef struct {
    const uint8_t *buf;
    long nbits;
    long pos;
    long stop_pos;      /* index of the rbsp_stop_one_bit */
    int err;            /* 0 ok, 1 EOF, 2 invalid */
} BR;

static inline uint64_t br_window(BR *b, long pos) {
    long byte = pos >> 3;
    long nbytes = (b->nbits + 7) >> 3;
    uint64_t w = 0;
    for (int i = 0; i < 8; i++) {
        long bi = byte + i;
        w = (w << 8) | (bi < nbytes ? b->buf[bi] : 0);
    }
    return w;
}

static inline uint32_t br_peek(BR *b, int n) {
    if (n == 0) return 0;
    uint64_t w = br_window(b, b->pos);
    int off = b->pos & 7;
    return (uint32_t)((w >> (64 - off - n)) & ((n == 32) ? 0xFFFFFFFFu
                                               : ((1u << n) - 1)));
}

static inline void br_skip(BR *b, int n) {
    b->pos += n;
    if (b->pos > b->nbits) b->err = 1;
}

static inline uint32_t br_u(BR *b, int n) {
    if (n == 0) return 0;
    if (b->pos + n > b->nbits) { b->err = 1; return 0; }
    uint32_t v = br_peek(b, n);
    b->pos += n;
    return v;
}

static inline uint32_t br_ue(BR *b) {
    int lz = 0;
    for (;;) {
        uint32_t chunk = br_peek(b, 32);
        if (chunk == 0) {
            if (b->pos + lz + 32 >= b->nbits + 64) { b->err = 1; return 0; }
            br_skip(b, 32);
            lz += 32;
            continue;
        }
        int z = 0;
        while (!(chunk & (0x80000000u >> z))) z++;
        lz += z;
        br_skip(b, z);
        if (lz > 30) { b->err = 2; return 0; }
        /* read 1+lz bits: the marker one and lz suffix bits */
        uint32_t v = br_u(b, lz + 1);
        return v - 1;
    }
}

static inline int32_t br_se(BR *b) {
    uint32_t k = br_ue(b);
    return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
}

static inline int br_more_rbsp(BR *b) {
    return b->pos < b->stop_pos;
}

/* ---------- parser context ---------- */
typedef struct {
    /* tables */
    const uint32_t *ct_luts;      /* [5][65536] */
    const uint32_t *tz_luts;      /* [16][512] */
    const uint32_t *tzc_luts;     /* [4][8] */
    const uint32_t *rb_luts;      /* [8][2048] */
    const int32_t *cbp_inter;     /* [48] */
    const int32_t *cbp_intra;     /* [48] */
    const int32_t *cbp_i16;      /* [6] */
    const int64_t *dq4;           /* [6][52][16] effective (see glue) */
    const int32_t *chroma_qp;     /* [52] */
    const int32_t *zigzag;        /* [16] */
    MbGrid g;                     /* the grids of csrc/mb_pred.h */
    /* outputs */
    int32_t *i16_mode;
    int32_t *i4_modes;            /* [n][16] */
    int32_t *chroma_mode;
    int32_t *cbp;
    int32_t *qp;
    int32_t *nzc_l;               /* [H4*W4] */
    int32_t *nzc_c;               /* [2][H2*W2] */
    int32_t *coeffs_l;            /* [n][16][16] */
    int32_t *coeffs_c;            /* [n][2][4][16] */
    uint8_t *mb_correct;
    uint8_t *ipcm_buf;            /* [n][384] */
    uint8_t *ipcm_flag;           /* [n] */
    uint8_t *transform8;          /* [n] (always 0 here) */
    /* params */
    int slice_type, first_mb;
    int num_ref_l0, coff0, coff1;
    int cur_qp;
    BR br;
} PC;

enum { I_SLICE_T = 2, P_SLICE_T = 0 };
enum { T_I4 = 0, T_I16 = 1, T_IPCM = 2,
       T_P16 = 4, T_P168 = 5, T_P816 = 6, T_P88 = 7, T_PSKIP = 8 };

/* ---------- helpers ---------- */
static inline int nzc_at(PC *c, int bx, int by, int luma, int comp) {
    int scale = luma ? 4 : 2;
    if (bx < 0 || by < 0) return -1;
    if (!mb_avail(&c->g, bx / scale, by / scale)) return -1;
    if (luma) return c->nzc_l[by * c->g.mb_w * 4 + bx];
    return c->nzc_c[comp * (c->g.mb_w * 2) * (c->g.mb_h * 2)
                    + by * c->g.mb_w * 2 + bx];
}

static inline int comb_nc(int na, int nb) {
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
}

static inline int nc_luma(PC *c, int gx, int gy) {
    return comb_nc(nzc_at(c, gx - 1, gy, 1, 0), nzc_at(c, gx, gy - 1, 1, 0));
}

static inline int nc_chroma(PC *c, int comp, int cx, int cy) {
    return comb_nc(nzc_at(c, cx - 1, cy, 0, comp),
                   nzc_at(c, cx, cy - 1, 0, comp));
}

/* ---------- residual block (§9.2, mirrors decoder/cavlc.py) ---------- */
static int parse_residual(PC *c, int nc, int max_coeff, int32_t *coeffs,
                          int *total_out) {
    BR *b = &c->br;
    int cls = nc < 0 ? 4 : nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
    uint32_t v = c->ct_luts[cls * 65536 + br_peek(b, 16)];
    if (v == 0) { b->err = 2; return -1; }
    br_skip(b, v & 31);
    int total = v >> 10, t1 = (v >> 7) & 7;
    memset(coeffs, 0, sizeof(int32_t) * max_coeff);
    *total_out = total;
    if (total == 0) return 0;
    if (total > max_coeff || t1 > 3) { b->err = 2; return -1; }

    int64_t levels[16];
    for (int i = 0; i < t1; i++)
        levels[i] = br_u(b, 1) ? -1 : 1;
    int sl = (total > 10 && t1 < 3) ? 1 : 0;
    for (int i = t1; i < total; i++) {
        /* level_prefix */
        int lz = 0;
        for (;;) {
            uint32_t chunk = br_peek(b, 32);
            if (chunk == 0) {
                br_skip(b, 32);
                lz += 32;
                if (lz > 64) { b->err = 2; return -1; }
                continue;
            }
            int z = 0;
            while (!(chunk & (0x80000000u >> z))) z++;
            br_skip(b, z + 1);
            lz += z;
            break;
        }
        int prefix = lz;
        int ssize = sl;
        if (prefix == 14 && sl == 0) ssize = 4;
        else if (prefix >= 15) ssize = prefix - 3;
        if (ssize > 32) { b->err = 2; return -1; }
        int64_t code = (int64_t)(prefix < 15 ? prefix : 15) << sl;
        if (ssize > 0) code += br_u(b, ssize);
        if (prefix >= 15 && sl == 0) code += 15;
        if (prefix >= 16) code += (1ll << (prefix - 3)) - 4096;
        if (i == t1 && t1 < 3) code += 2;
        levels[i] = (code & 1) ? -((code + 1) >> 1) : ((code + 2) >> 1);
        if (sl == 0) sl = 1;
        int64_t al = levels[i] < 0 ? -levels[i] : levels[i];
        if (al > (3 << (sl - 1)) && sl < 6) sl++;
        if (b->err) return -1;
    }

    int zeros_left = 0;
    if (total < max_coeff) {
        uint32_t tv;
        if (max_coeff == 4)
            tv = c->tzc_luts[total * 8 + br_peek(b, 3)];
        else
            tv = c->tz_luts[total * 512 + br_peek(b, 9)];
        if (tv == 0) { b->err = 2; return -1; }
        br_skip(b, tv & 31);
        zeros_left = tv >> 5;
    }
    if (zeros_left + total > max_coeff) { b->err = 2; return -1; }

    int runs[16];
    memset(runs, 0, sizeof(runs));
    int zl = zeros_left;
    for (int i = 0; i < total - 1; i++) {
        if (zl <= 0) break;
        int zi = zl < 7 ? zl : 7;
        uint32_t rv = c->rb_luts[zi * 2048 + br_peek(b, 11)];
        if (rv == 0) { b->err = 2; return -1; }
        br_skip(b, rv & 31);
        runs[i] = rv >> 5;
        zl -= runs[i];
        if (zl < 0) { b->err = 2; return -1; }
    }
    runs[total - 1] = zl > 0 ? zl : 0;

    int pos = -1;
    for (int i = total - 1; i >= 0; i--) {
        pos += runs[i] + 1;
        if (pos >= max_coeff) { b->err = 2; return -1; }
        coeffs[pos] = (int32_t)levels[i];
    }
    return b->err ? -1 : 0;
}

/* ---------- MB residual (mirrors parse_mb_residual_cavlc) ---------- */
static int mb_residual(PC *c, int mb_idx, int cbp, int is_i16) {
    BR *b = &c->br;
    int mbx = mb_idx % c->g.mb_w, mby = mb_idx / c->g.mb_w;
    int w4 = c->g.mb_w * 4, w2 = c->g.mb_w * 2;
    if (is_i16 || cbp) {
        int32_t delta = br_se(b);
        if (b->err) return -1;
        if (delta) c->cur_qp = (c->cur_qp + delta + 52) % 52;
    }
    c->qp[mb_idx] = c->cur_qp;
    int qp = c->cur_qp;
    int t = c->g.mb_type[mb_idx];
    int intra = (t == 0 || t == 1 || t == 3);
    int qp_c[2];
    for (int k = 0; k < 2; k++) {
        int q = qp + (k == 0 ? c->coff0 : c->coff1);
        q = q < 0 ? 0 : (q > 51 ? 51 : q);
        qp_c[k] = c->chroma_qp[q];
    }
    const int64_t *dq_l = c->dq4 + (intra ? 0 : 3) * 52 * 16 + qp * 16;
    int32_t scan[16];
    int tc;

    if (is_i16) {
        int nc = nc_luma(c, mbx * 4, mby * 4);
        if (parse_residual(c, nc, 16, scan, &tc)) return -1;
        /* zigzag place then IHadamard + qmul (luma_dc_dequant_ihadamard) */
        int64_t dc[16];
        memset(dc, 0, sizeof(dc));
        for (int k = 0; k < 16; k++) dc[c->zigzag[k]] = scan[k];
        int64_t tmp[16];
        /* rows then cols of the 4x4 Hadamard */
        for (int r = 0; r < 4; r++) {
            int64_t a = dc[r * 4], bq = dc[r * 4 + 1], cc = dc[r * 4 + 2],
                    d = dc[r * 4 + 3];
            tmp[r * 4] = a + bq + cc + d;
            tmp[r * 4 + 1] = a + bq - cc - d;
            tmp[r * 4 + 2] = a - bq - cc + d;
            tmp[r * 4 + 3] = a - bq + cc - d;
        }
        int64_t qmul = c->dq4[0 * 52 * 16 + qp * 16 + 0];
        for (int col = 0; col < 4; col++) {
            int64_t a = tmp[col], bq = tmp[4 + col], cc = tmp[8 + col],
                    d = tmp[12 + col];
            int64_t o0 = a + bq + cc + d, o1 = a + bq - cc - d,
                    o2 = a - bq - cc + d, o3 = a - bq + cc - d;
            c->coeffs_l[(mb_idx * 16 + 0 * 4 + col) * 16] =
                wrap16((o0 * qmul + 32) >> 6);
            c->coeffs_l[(mb_idx * 16 + 1 * 4 + col) * 16] =
                wrap16((o1 * qmul + 32) >> 6);
            c->coeffs_l[(mb_idx * 16 + 2 * 4 + col) * 16] =
                wrap16((o2 * qmul + 32) >> 6);
            c->coeffs_l[(mb_idx * 16 + 3 * 4 + col) * 16] =
                wrap16((o3 * qmul + 32) >> 6);
        }
    }

    for (int k = 0; k < 16; k++) {
        int raster = ZS2R[k];
        int bx = raster % 4, by = raster / 4;
        int gx = mbx * 4 + bx, gy = mby * 4 + by;
        int blk8 = (by >> 1) * 2 + (bx >> 1);
        if (!(cbp & (1 << blk8))) {
            c->nzc_l[gy * w4 + gx] = 0;
            continue;
        }
        int nc = nc_luma(c, gx, gy);
        int32_t *dst = c->coeffs_l + (mb_idx * 16 + raster) * 16;
        if (is_i16) {
            if (parse_residual(c, nc, 15, scan, &tc)) return -1;
            for (int j = 0; j < 15; j++) {
                int p = c->zigzag[j + 1];
                dst[p] = (int32_t)(((int64_t)scan[j] * dq_l[p] + 8) >> 4);
            }
        } else {
            if (parse_residual(c, nc, 16, scan, &tc)) return -1;
            for (int j = 0; j < 16; j++) {
                int p = c->zigzag[j];
                dst[p] = (int32_t)(((int64_t)scan[j] * dq_l[p] + 8) >> 4);
            }
        }
        c->nzc_l[gy * w4 + gx] = tc;
    }

    if (cbp & 0x30) {
        for (int comp = 0; comp < 2; comp++) {
            if (parse_residual(c, -1, 4, scan, &tc)) return -1;
            /* 2x2 Hadamard then (v * dq[0]) >> 5 (eff table), wrap16 */
            int64_t a = scan[0], bq = scan[1], cc = scan[2], d = scan[3];
            int64_t h0 = a + bq + cc + d, h1 = a - bq + cc - d,
                    h2 = a + bq - cc - d, h3 = a - bq - cc + d;
            int prop = intra ? (1 + comp) : (4 + comp);
            int64_t qm = c->dq4[prop * 52 * 16 + qp_c[comp] * 16 + 0];
            int32_t *dstc = c->coeffs_c + ((mb_idx * 2 + comp) * 4) * 16;
            dstc[0 * 16] = wrap16((h0 * qm) >> 5);
            dstc[1 * 16] = wrap16((h1 * qm) >> 5);
            dstc[2 * 16] = wrap16((h2 * qm) >> 5);
            dstc[3 * 16] = wrap16((h3 * qm) >> 5);
        }
    }
    if (cbp & 0x20) {
        for (int comp = 0; comp < 2; comp++) {
            int prop = intra ? (1 + comp) : (4 + comp);
            const int64_t *dq_c = c->dq4 + prop * 52 * 16 + qp_c[comp] * 16;
            for (int k = 0; k < 4; k++) {
                int bx = k % 2, by = k / 2;
                int cx = mbx * 2 + bx, cy = mby * 2 + by;
                int nc = nc_chroma(c, comp, cx, cy);
                if (parse_residual(c, nc, 15, scan, &tc)) return -1;
                int32_t *dstc = c->coeffs_c + ((mb_idx * 2 + comp) * 4 + k) * 16;
                for (int j = 0; j < 15; j++) {
                    int p = c->zigzag[j + 1];
                    dstc[p] = (int32_t)(((int64_t)scan[j] * dq_c[p] + 8) >> 4);
                }
                c->nzc_c[comp * (c->g.mb_h * 2) * w2 + cy * w2 + cx] = tc;
            }
        }
    } else {
        for (int comp = 0; comp < 2; comp++)
            for (int dy = 0; dy < 2; dy++)
                for (int dx = 0; dx < 2; dx++)
                    c->nzc_c[comp * (c->g.mb_h * 2) * w2 + (mby * 2 + dy) * w2
                             + mbx * 2 + dx] = 0;
    }
    return 0;
}

/* ---------- ref_idx (te(v) over list 0) ---------- */
static int read_ref_idx(PC *c) {
    if (c->num_ref_l0 <= 1) return 0;
    int r;
    if (c->num_ref_l0 - 1 == 1)
        r = 1 - (int)br_u(&c->br, 1);
    else
        r = (int)br_ue(&c->br);
    if (!(r >= 0 && r < c->g.n_l0 && c->g.l0_pic_ids[r] >= 0))
        return 0;
    return r;
}

/* ---------- intra MB ---------- */
static int decode_i_mb(PC *c, int mb_idx, int raw) {
    BR *b = &c->br;
    int mbx = mb_idx % c->g.mb_w, mby = mb_idx / c->g.mb_w;
    int w4 = c->g.mb_w * 4, w2 = c->g.mb_w * 2;
    for (int q = 0; q < 4; q++) c->g.pred_mode[mb_idx * 4 + q] = -1;

    if (raw == 25) {   /* IPCM */
        c->g.mb_type[mb_idx] = 2;
        while (b->pos & 7) br_u(b, 1);
        uint8_t *dst = c->ipcm_buf + (size_t)mb_idx * 384;
        for (int i = 0; i < 384; i++) dst[i] = (uint8_t)br_u(b, 8);
        if (b->err) return -1;
        c->ipcm_flag[mb_idx] = 1;
        c->qp[mb_idx] = 0;
        for (int y = mby * 4; y < mby * 4 + 4; y++)
            for (int x = mbx * 4; x < mbx * 4 + 4; x++) {
                c->nzc_l[y * w4 + x] = 16;
                c->g.i4_grid[y * w4 + x] = 2;
            }
        for (int comp = 0; comp < 2; comp++)
            for (int dy = 0; dy < 2; dy++)
                for (int dx = 0; dx < 2; dx++)
                    c->nzc_c[comp * (c->g.mb_h * 2) * w2 + (mby * 2 + dy) * w2
                             + mbx * 2 + dx] = 16;
        return 0;
    }

    if (raw > 25) { b->err = 2; return -1; }
    int cbp;
    if (raw == 0) {    /* I4x4 (transform8 rejected by the dispatcher) */
        c->g.mb_type[mb_idx] = 0;
        for (int k = 0; k < 16; k++) {
            int raster = ZS2R[k];
            int bx = raster % 4, by = raster / 4;
            int gx = mbx * 4 + bx, gy = mby * 4 + by;
            int pred = pred_i4_mode(&c->g, gx, gy);
            int mode;
            if (br_u(b, 1)) mode = pred;
            else {
                int rem = (int)br_u(b, 3);
                mode = rem < pred ? rem : rem + 1;
            }
            c->g.i4_grid[gy * w4 + gx] = mode;
            c->i4_modes[mb_idx * 16 + raster] = mode;
        }
        c->chroma_mode[mb_idx] = (int)br_ue(b);
        uint32_t code = br_ue(b);
        if (b->err || code >= 48) { b->err = 2; return -1; }
        cbp = c->cbp_intra[code];
    } else {           /* I16x16 */
        c->g.mb_type[mb_idx] = 1;
        int mt = raw - 1;
        c->i16_mode[mb_idx] = mt & 3;
        cbp = c->cbp_i16[mt >> 2];
        for (int y = mby * 4; y < mby * 4 + 4; y++)
            for (int x = mbx * 4; x < mbx * 4 + 4; x++)
                c->g.i4_grid[y * w4 + x] = 2;
        c->chroma_mode[mb_idx] = (int)br_ue(b);
    }
    if (b->err) return -1;
    c->cbp[mb_idx] = cbp;
    return mb_residual(c, mb_idx, cbp, c->g.mb_type[mb_idx] == 1);
}

/* ---------- P MBs ---------- */
static void decode_p_skip(PC *c, int mb_idx) {
    mb_common_init(&c->g, mb_idx);
    int mbx = mb_idx % c->g.mb_w, mby = mb_idx / c->g.mb_w;
    int gx = mbx * 4, gy = mby * 4;
    c->g.mb_type[mb_idx] = T_PSKIP;
    int32_t mv[2];
    pred_skip_mv(&c->g, gx, gy, mb_idx, mv);
    set_partition(&c->g, gx, gy, 4, 4, 0, 0, mv[0], mv[1]);
    set_partition(&c->g, gx, gy, 4, 4, 1, -1, 0, 0);
    c->cbp[mb_idx] = 0;
    c->qp[mb_idx] = c->cur_qp;
    finish_inter_mb(&c->g, mb_idx);
    int w4 = c->g.mb_w * 4, w2 = c->g.mb_w * 2;
    for (int y = gy; y < gy + 4; y++)
        for (int x = gx; x < gx + 4; x++)
            c->nzc_l[y * w4 + x] = 0;
    for (int comp = 0; comp < 2; comp++)
        for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++)
                c->nzc_c[comp * (c->g.mb_h * 2) * w2 + (mby * 2 + dy) * w2
                         + mbx * 2 + dx] = 0;
}

static int decode_p_mb(PC *c, int mb_idx, int raw) {
    BR *b = &c->br;
    if (raw >= 5) {
        mb_common_init(&c->g, mb_idx);
        if (decode_i_mb(c, mb_idx, raw - 5)) return -1;
        mark_intra_grids(&c->g, mb_idx);
        return 0;
    }
    mb_common_init(&c->g, mb_idx);
    for (int q = 0; q < 4; q++) c->g.pred_mode[mb_idx * 4 + q] = 0;
    int mbx = mb_idx % c->g.mb_w, mby = mb_idx / c->g.mb_w;
    int gx = mbx * 4, gy = mby * 4;
    int sub_types[4] = {0, 0, 0, 0};

    if (raw == 0) {
        c->g.mb_type[mb_idx] = T_P16;
        int ref = read_ref_idx(c);
        int32_t mvd0 = br_se(b), mvd1 = br_se(b);
        int32_t mvp[2];
        pred_mv(&c->g, gx, gy, 4, 4, 0, ref, mb_idx, mvp);
        set_partition(&c->g, gx, gy, 4, 4, 0, ref, mvp[0] + mvd0,
                      mvp[1] + mvd1);
    } else if (raw == 1 || raw == 2) {
        c->g.mb_type[mb_idx] = raw == 1 ? T_P168 : T_P816;
        int refs[2];
        refs[0] = read_ref_idx(c);
        refs[1] = read_ref_idx(c);
        for (int part = 0; part < 2; part++) {
            int px = gx, py = gy, pw, ph;
            if (raw == 1) { py += part * 2; pw = 4; ph = 2; }
            else { px += part * 2; pw = 2; ph = 4; }
            int32_t mvd0 = br_se(b), mvd1 = br_se(b);
            int32_t mvp[2];
            pred_mv(&c->g, px, py, pw, ph, 0, refs[part], mb_idx, mvp);
            set_partition(&c->g, px, py, pw, ph, 0, refs[part],
                          mvp[0] + mvd0, mvp[1] + mvd1);
        }
    } else if (raw == 3 || raw == 4) {
        c->g.mb_type[mb_idx] = T_P88;
        for (int q = 0; q < 4; q++) {
            sub_types[q] = (int)br_ue(b);
            if (b->err || sub_types[q] > 3) { b->err = 2; return -1; }
        }
        int refs[4] = {0, 0, 0, 0};
        if (raw == 3)
            for (int q = 0; q < 4; q++) refs[q] = read_ref_idx(c);
        for (int q = 0; q < 4; q++) {
            int q_gx = gx + (q % 2) * 2, q_gy = gy + (q / 2) * 2;
            int st = sub_types[q];
            int n_parts = st == 0 ? 1 : (st == 3 ? 4 : 2);
            int pw = st == 0 ? 2 : (st == 1 ? 2 : 1);
            int ph = st == 0 ? 2 : (st == 1 ? 1 : (st == 2 ? 2 : 1));
            if (st == 3) { pw = 1; ph = 1; }
            for (int part = 0; part < n_parts; part++) {
                int px = q_gx, py = q_gy;
                if (st == 1) py += part;
                else if (st == 2) px += part;
                else if (st == 3) { px += part % 2; py += part / 2; }
                int32_t mvd0 = br_se(b), mvd1 = br_se(b);
                int32_t mvp[2];
                pred_mv(&c->g, px, py, pw, ph, 0, refs[q], mb_idx, mvp);
                set_partition(&c->g, px, py, pw, ph, 0, refs[q],
                              mvp[0] + mvd0, mvp[1] + mvd1);
            }
        }
    } else {
        b->err = 2;
        return -1;
    }
    set_partition(&c->g, gx, gy, 4, 4, 1, -1, 0, 0);
    finish_inter_mb(&c->g, mb_idx);
    if (b->err) return -1;

    uint32_t code = br_ue(b);
    if (b->err || code >= 48) { b->err = 2; return -1; }
    int cbp = c->cbp_inter[code];
    c->cbp[mb_idx] = cbp;
    if (cbp) {
        if (mb_residual(c, mb_idx, cbp, 0)) return -1;
    } else {
        c->qp[mb_idx] = c->cur_qp;
        int w4 = c->g.mb_w * 4, w2 = c->g.mb_w * 2;
        for (int y = gy; y < gy + 4; y++)
            for (int x = gx; x < gx + 4; x++)
                c->nzc_l[y * w4 + x] = 0;
        for (int comp = 0; comp < 2; comp++)
            for (int dy = 0; dy < 2; dy++)
                for (int dx = 0; dx < 2; dx++)
                    c->nzc_c[comp * (c->g.mb_h * 2) * w2 + (mby * 2 + dy) * w2
                             + mbx * 2 + dx] = 0;
    }
    return 0;
}

/* ---------- entry ---------- */
/* ptrs / params layouts in decoder/cbind.py (parse_cavlc_slice_native).
 * Returns 0 on success; out[0]=end_mb, out[1]=end_bit, out[2]=err
 * (0 ok, 1 EOF, 2 invalid). */
int parse_cavlc_slice(const void **ptrs, const int32_t *params,
                      int32_t *out) {
    PC c;
    memset(&c, 0, sizeof(c));
    int i = 0;
    const uint8_t *rbsp = (const uint8_t *)ptrs[i++];
    c.ct_luts = (const uint32_t *)ptrs[i++];
    c.tz_luts = (const uint32_t *)ptrs[i++];
    c.tzc_luts = (const uint32_t *)ptrs[i++];
    c.rb_luts = (const uint32_t *)ptrs[i++];
    c.cbp_inter = (const int32_t *)ptrs[i++];
    c.cbp_intra = (const int32_t *)ptrs[i++];
    c.cbp_i16 = (const int32_t *)ptrs[i++];
    c.dq4 = (const int64_t *)ptrs[i++];
    c.chroma_qp = (const int32_t *)ptrs[i++];
    c.zigzag = (const int32_t *)ptrs[i++];
    c.g.mb_type = (int32_t *)ptrs[i++];
    c.g.slice_id = (int32_t *)ptrs[i++];
    c.g.i4_grid = (int32_t *)ptrs[i++];
    c.i16_mode = (int32_t *)ptrs[i++];
    c.i4_modes = (int32_t *)ptrs[i++];
    c.chroma_mode = (int32_t *)ptrs[i++];
    c.cbp = (int32_t *)ptrs[i++];
    c.qp = (int32_t *)ptrs[i++];
    c.nzc_l = (int32_t *)ptrs[i++];
    c.nzc_c = (int32_t *)ptrs[i++];
    c.coeffs_l = (int32_t *)ptrs[i++];
    c.coeffs_c = (int32_t *)ptrs[i++];
    c.g.mv = (int32_t *)ptrs[i++];
    c.g.refidx = (int8_t *)ptrs[i++];
    c.g.ref_pic = (int32_t *)ptrs[i++];
    c.g.pred_mode = (int8_t *)ptrs[i++];
    c.g.gmv = (int32_t *)ptrs[i++];
    c.g.gref = (int32_t *)ptrs[i++];
    c.g.gwritten = (uint8_t *)ptrs[i++];
    c.g.grefw = (uint8_t *)ptrs[i++];
    c.g.l0_pic_ids = (const int32_t *)ptrs[i++];
    c.g.disable_deblock = (int32_t *)ptrs[i++];
    c.g.alpha_off = (int32_t *)ptrs[i++];
    c.g.beta_off = (int32_t *)ptrs[i++];
    c.mb_correct = (uint8_t *)ptrs[i++];
    c.ipcm_buf = (uint8_t *)ptrs[i++];
    c.ipcm_flag = (uint8_t *)ptrs[i++];
    c.transform8 = (uint8_t *)ptrs[i++];

    i = 0;
    long nbits = params[i++];
    long start_bit = params[i++];
    c.slice_type = params[i++];
    c.first_mb = params[i++];
    c.g.mb_w = params[i++];
    c.g.mb_h = params[i++];
    c.g.slice_idx = params[i++];
    c.cur_qp = params[i++];
    c.num_ref_l0 = params[i++];
    c.g.constrained = params[i++];
    c.g.ddb_idc = params[i++];
    c.g.a_off = params[i++];
    c.g.b_off = params[i++];
    c.coff0 = params[i++];
    c.coff1 = params[i++];
    c.g.n_l0 = params[i++];
    c.g.w4 = c.g.mb_w * 4;
    c.g.h4 = c.g.mb_h * 4;          /* list 1 stays empty: n_l1 = 0 */

    c.br.buf = rbsp;
    c.br.nbits = nbits;
    c.br.pos = start_bit;
    c.br.err = 0;
    /* rbsp_stop_one_bit = last set bit in the stream */
    {
        long nbytes = (nbits + 7) >> 3;
        long sp = -1;
        for (long bidx = nbytes - 1; bidx >= 0; bidx--) {
            if (rbsp[bidx]) {
                uint8_t v = rbsp[bidx];
                int bit = 0;
                while (!(v & 1)) { v >>= 1; bit++; }
                sp = bidx * 8 + (7 - bit);
                break;
            }
        }
        c.br.stop_pos = sp;
    }

    int mb_idx = c.first_mb;
    long n_mb = (long)c.g.mb_w * c.g.mb_h;
    int rc = 0;

    if (c.slice_type == I_SLICE_T) {
        for (;;) {
            uint32_t raw = br_ue(&c.br);
            if (c.br.err) { rc = -1; break; }
            mb_common_init(&c.g, mb_idx);
            if (decode_i_mb(&c, mb_idx, (int)raw)) { rc = -1; break; }
            c.mb_correct[mb_idx] = 1;
            mb_idx++;
            if (mb_idx >= n_mb || !br_more_rbsp(&c.br)) break;
        }
    } else if (c.slice_type == P_SLICE_T) {
        while (mb_idx < n_mb) {
            uint32_t skip_run = br_ue(&c.br);
            if (c.br.err) { rc = -1; break; }
            for (uint32_t s = 0; s < skip_run; s++) {
                if (mb_idx >= n_mb) { c.br.err = 2; rc = -1; break; }
                decode_p_skip(&c, mb_idx);
                c.mb_correct[mb_idx] = 1;
                mb_idx++;
            }
            if (rc) break;
            if (mb_idx >= n_mb || !br_more_rbsp(&c.br)) break;
            uint32_t raw = br_ue(&c.br);
            if (c.br.err) { rc = -1; break; }
            if (decode_p_mb(&c, mb_idx, (int)raw)) { rc = -1; break; }
            c.mb_correct[mb_idx] = 1;
            mb_idx++;
        }
    } else {
        c.br.err = 2;
        rc = -1;
    }
    (void)rc;
    out[0] = mb_idx;
    out[1] = (int32_t)c.br.pos;
    out[2] = c.br.err;
    return c.br.err;
}
