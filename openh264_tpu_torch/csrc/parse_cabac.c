/* Host C of the port's decoder: the CABAC slice-data parser of I, P and
 * B slices, with the 8x8 transform and B direct prediction.
 *
 * Built with the host compiler by openh264_tpu_torch/_build.py and bound
 * with ctypes by openh264_tpu_torch/decoder/cbind.py
 * (parse_cabac_slice_native). Nothing here runs on the card. Its MB
 * prediction core (grids, neighbours, MV prediction) is csrc/mb_pred.h,
 * shared with csrc/parse_cavlc.c.
 *
 * It parses one whole CABAC slice, from the end of its header to
 * end_of_slice_flag, into the FrameSymbols arrays, and mirrors the
 * per-MB Python parser (decoder/slice_dec_cabac.py: decode_slice_mbs_cabac
 * and its helpers, with the MV prediction of decoder/mvpred.py and the
 * direct prediction of slice_dec.apply_direct over decoder/direct.py)
 * statement for statement, as csrc/parse_cavlc.c mirrors
 * decoder/slice_dec.py: the same arrays get the same values in the same
 * order, so a slice that fails leaves what the Python parser leaves, and
 * the engine ends at the same bit. The arithmetic engine is the spec's
 * (9.3.3.2) bit for bit, the residual block loop that of
 * csrc/cabac_residual.c, copied here so that one engine counts every bin.
 *
 * Scope: I, P and B slices, with or without transform_8x8_mode, spatial
 * and temporal direct, in raster order. FMO slices go to the Python
 * parser (decoder/slice_dec.py c_parses routes them). The B and 8x8 syntax
 * runs only where the slice type and the PPS ask for it.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* the grids, neighbours, MV prediction and per-MB grid updates shared
 * with parse_cavlc.c, and ALWAYS_INLINE, with which the engine's bins
 * are inlined too */
#include "mb_pred.h"

/* ctxIdx offsets (decoder/cabac.py, the spec's ctxIdx space) */
enum {
    CTX_MB_TYPE_I = 3, CTX_SKIP = 11, CTX_SUBMB_TYPE = 21, CTX_B_SKIP = 24,
    CTX_MB_TYPE_B = 27, CTX_MB_TYPE_B_INTRA = 32, CTX_B_SUBMB_TYPE = 36,
    CTX_MVD = 40, CTX_REF_NO = 54, CTX_DELTA_QP = 60, CTX_CIPR = 64,
    CTX_IPR = 68, CTX_CBP = 73, CTX_CBF = 85, CTX_MAP = 105, CTX_LAST = 166,
    CTX_ONE = 227, CTX_ABS = 232, CTX_TS8 = 399, CTX_MAP_8x8 = 402,
    CTX_LAST_8x8 = 417, CTX_ONE_8x8 = 426, CTX_ABS_8x8 = 431, N_CTX = 460
};

/* residual categories and their tables (decoder/cabac.py) */
enum { I16_DC = 1, I16_AC = 2, LUMA_4x4 = 3, CHROMA_DC = 4, CHROMA_AC = 5,
       LUMA_8x8 = 6 };
static const int MAX_POS[7] = {0, 15, 14, 15, 3, 14, 63};
static const int MAX_C2[7] = {0, 4, 4, 4, 3, 4, 4};
static const int OFF_CBF[6] = {0, 0, 4, 8, 12, 16};
static const int OFF_MAP[6] = {0, 0, 15, 29, 44, 47};
static const int OFF_ONE[6] = {0, 0, 10, 20, 30, 39};

/* Table 9-43 frame-coded 8x8 significance / last contexts */
static const int SIG8[64] = {
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12, 14};
static const int LAST8[64] = {
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8, 8};

/* mb_type classes (decoder/framedata.py) */
enum { T_I4 = 0, T_I16 = 1, T_IPCM = 2, T_I8 = 3, T_P16 = 4, T_P168 = 5,
       T_P816 = 6, T_P88 = 7, T_PSKIP = 8, T_B16 = 9, T_B168 = 10,
       T_B816 = 11, T_B88 = 12, T_BSKIP = 13, T_BDIRECT = 14 };

/* two-partition B mb_type 4..21: the modes (0 L0, 1 L1, 2 BI) of its
 * partitions (slice_dec._B_TWOPART_MODES) */
static const int B_TWOPART[9][2] = {{0, 0}, {1, 1}, {0, 1}, {1, 0}, {0, 2},
                                    {1, 2}, {2, 0}, {2, 1}, {2, 2}};
/* B sub_mb_type 0..12: mode (-1 direct), partitions, pw, ph in 4x4
 * blocks (slice_dec._B_SUB) */
static const int B_SUB[13][4] = {
    {-1, 4, 1, 1}, {0, 1, 2, 2}, {1, 1, 2, 2}, {2, 1, 2, 2}, {0, 2, 2, 1},
    {0, 2, 1, 2}, {1, 2, 2, 1}, {1, 2, 1, 2}, {2, 2, 2, 1}, {2, 2, 1, 2},
    {0, 4, 1, 1}, {1, 4, 1, 1}, {2, 4, 1, 1}};

/* ---------- arithmetic engine (decoder/cabac.py CabacEngine) ----------
 * The Python engine's offset is a Python int: a stream that breaks the
 * engine's invariant (offset below range) makes it grow without bound,
 * and handing it to csrc/cabac_residual.c, whose state is int64, then
 * raises OverflowError. So the offset is kept here in 128 bits, exact
 * while its magnitude is below OFF_SAT; beyond, where it only grows, its
 * sign is all that decides a bin. Residual blocks run on a copy of the
 * state in int64, as cabac_residual.c runs them. */
typedef __int128 i128;
#define OFF_SAT ((i128)1 << 120)

typedef struct {
    const uint8_t *data;
    long long nbits, pos, range;
    i128 offset;
    long long bins;             /* decisions, bypass and terminate bins */
    int32_t state[N_CTX], mps[N_CTX];
    const int32_t *range_lps;   /* [64*4] */
    const int32_t *state_trans; /* [64*2] (LPS, MPS) */
} Eng;

static ALWAYS_INLINE int rd_bit(const uint8_t *data, long long nbits,
                         long long *pos) {
    int b = 0;
    if (*pos < nbits)   /* past-the-end bits read as 0 */
        b = (data[*pos >> 3] >> (7 - (*pos & 7))) & 1;
    (*pos)++;
    return b;
}

/* offset = (offset << 1) | the next bit, as a Python int */
static ALWAYS_INLINE void shift_in(Eng *e) {
    int b = rd_bit(e->data, e->nbits, &e->pos);
    if (e->offset < OFF_SAT && e->offset > -OFF_SAT)
        e->offset = e->offset * 2 + b;
}

/* CabacEngine(data, bitpos): cabac_alignment_one_bit, then 9 bits */
static void eng_start(Eng *e, long long bitpos) {
    e->pos = bitpos;
    while (e->pos & 7) e->pos++;
    e->range = 510;
    e->offset = 0;
    for (int i = 0; i < 9; i++) shift_in(e);
}

/* CabacContexts: the m,n initialisation of every context */
static void ctx_init(Eng *e, const int32_t *init_mn, int is_i, int idc,
                     int qp) {
    int model = is_i ? 0 : idc + 1;
    for (int i = 0; i < N_CTX; i++) {
        int m = init_mn[(i * 4 + model) * 2], n = init_mn[(i * 4 + model) * 2 + 1];
        int pre = ((m * qp) >> 4) + n;
        pre = pre < 1 ? 1 : (pre > 126 ? 126 : pre);
        e->mps[i] = pre > 63;
        e->state[i] = pre <= 63 ? 63 - pre : pre - 64;
    }
}

static ALWAYS_INLINE int decision(Eng *e, int idx) {
    int state = e->state[idx];
    long long lps = e->range_lps[state * 4 + ((e->range >> 6) & 3)];
    int bit;
    e->bins++;
    e->range -= lps;
    if (e->offset >= e->range) {
        bit = 1 - e->mps[idx];
        e->offset -= e->range;
        e->range = lps;
        if (state == 0) e->mps[idx] ^= 1;
        e->state[idx] = e->state_trans[state * 2 + 0];
    } else {
        bit = e->mps[idx];
        e->state[idx] = e->state_trans[state * 2 + 1];
    }
    while (e->range < 256) {
        e->range <<= 1;
        shift_in(e);
    }
    return bit;
}

static ALWAYS_INLINE int bypass(Eng *e) {
    e->bins++;
    shift_in(e);
    if (e->offset >= e->range) {
        e->offset -= e->range;
        return 1;
    }
    return 0;
}

static ALWAYS_INLINE int terminate(Eng *e) {
    e->bins++;
    e->range -= 2;
    if (e->offset >= e->range) return 1;   /* pos stays at the flush */
    while (e->range < 256) {
        e->range <<= 1;
        shift_in(e);
    }
    return 0;
}

/* Exp-Golomb suffix of order k in bypass bins; -1 on a runaway code */
static int exp_bypass(Eng *e, int k) {
    int v = 0;
    while (bypass(e)) {
        v += 1 << k;
        k++;
        if (k > 16) return -1;
    }
    for (int i = k - 1; i >= 0; i--) v += bypass(e) << i;
    return v;
}

/* The residual engine: csrc/cabac_residual.c's, whose int64 offset
 * wraps (its shifts are done unsigned here, to the same bits). */
typedef struct {
    Eng *e;
    long long pos, range, offset;
} REng;

static ALWAYS_INLINE long long r_shift_in(REng *r) {
    int b = rd_bit(r->e->data, r->e->nbits, &r->pos);
    return (long long)(((unsigned long long)r->offset << 1) | (unsigned)b);
}

static ALWAYS_INLINE int r_decision(REng *r, int idx) {
    Eng *e = r->e;
    int state = e->state[idx];
    long long lps = e->range_lps[state * 4 + ((r->range >> 6) & 3)];
    int bit;
    e->bins++;
    r->range -= lps;
    if (r->offset >= r->range) {
        bit = 1 - e->mps[idx];
        r->offset -= r->range;
        r->range = lps;
        if (state == 0) e->mps[idx] ^= 1;
        e->state[idx] = e->state_trans[state * 2 + 0];
    } else {
        bit = e->mps[idx];
        e->state[idx] = e->state_trans[state * 2 + 1];
    }
    while (r->range < 256) {
        r->range <<= 1;
        r->offset = r_shift_in(r);
    }
    return bit;
}

static ALWAYS_INLINE int r_bypass(REng *r) {
    r->e->bins++;
    r->offset = r_shift_in(r);
    if (r->offset >= r->range) {
        r->offset -= r->range;
        return 1;
    }
    return 0;
}

static int r_exp_bypass(REng *r, int k) {
    int v = 0;
    while (r_bypass(r)) {
        v += 1 << k;
        k++;
        if (k > 16) return -1;
    }
    for (int i = k - 1; i >= 0; i--) v += r_bypass(r) << i;
    return v;
}

/* ---------- parser context ---------- */
typedef struct {
    Eng e;
    MbGrid g;                     /* the grids of csrc/mb_pred.h */
    /* tables */
    const int64_t *dq4;           /* [6][52][16] effective (DequantTables.eff4) */
    const int64_t *dq8;           /* [2][52][64] effective (DequantTables.eff8) */
    const int32_t *chroma_qp;     /* [52] */
    const int32_t *zigzag;        /* [16] */
    const int32_t *zigzag8;       /* [64] */
    const int32_t *cbp_i16;       /* [6] */
    /* FrameSymbols */
    uint8_t *transform8;
    int32_t *i16_mode, *chroma_mode, *i4_modes, *cbp, *qp;
    int32_t *coeffs_l;            /* [n][16][16] */
    int32_t *coeffs_c;            /* [n][2][4][16] */
    int32_t *coeffs8;             /* [n][4][64] */
    int32_t *nzc_l;               /* [H4][W4] */
    int32_t *nzc_c;               /* [2][H2][W2] */
    uint8_t *mb_correct;
    uint8_t *mb16, *sub_direct, *ibs_mode;   /* [n] */
    int32_t *cbf_dc;              /* [n] bits 0..2: I16 DC, Cb DC, Cr DC */
    int32_t *gmvd;                /* [2][H4][W4][2] */
    int8_t *gdirect;              /* [H4][W4] */
    uint8_t *ipcm_buf;            /* [n][384] */
    uint8_t *ipcm_flag;           /* [n] */
    /* the colocated picture (direct.py DirectContext.col), its grids
     * [col_h4][col_w4] */
    const int32_t *col_mv0, *col_mv1;        /* [.][.][2] */
    const int32_t *col_ref0, *col_ref1, *col_refpic0, *col_refpic1;
    const uint8_t *col_intra;
    const uint8_t *col_mb16;      /* [col_n16], NULL when it has none */
    const int32_t *dsf;           /* [n_l0] DistScaleFactor per L0 index */
    /* params */
    int first_mb, num_ref_l0, num_ref_l1, coff0, coff1;
    int t8_mode, spatial, direct_8x8, compat;
    int has_col, col_long_term, col_w4, col_h4, col_n16;
    int cur_qp, last_dqp;
    int err;                      /* 0 ok, 2 invalid (ValueError), 3 an
                                     index outside a table (IndexError),
                                     4 an offset past int64, 6 a temporal
                                     direct MV past int32 (OverflowError),
                                     5 temporal direct without a
                                     colocated picture (AttributeError) */
    int residual_seen;            /* an MB reached its residual's QP */
    int used8;                    /* an MB reached the 8x8 residual */
    /* spatial direct's refs and MVs of MB sd_mb (SliceDecodeContext.
     * spatial_direct_mb) */
    int sd_mb, sd_ref[2], sd_use[2];
    int32_t sd_mv[2][2];
} PC;

/* ---------- neighbours ---------- */
static inline void left_top(PC *c, int mb, int *left, int *top) {
    int mbx = mb % c->g.mb_w, mby = mb / c->g.mb_w;
    *left = mb_avail(&c->g, mbx - 1, mby) ? mb - 1 : -1;
    *top = mb_avail(&c->g, mbx, mby - 1) ? mb - c->g.mb_w : -1;
}

/* ---------- the CABAC parser's own per-MB grids ---------- */
static void set_nzc_l(PC *c, int mb, int v) {
    int mbx = mb % c->g.mb_w, mby = mb / c->g.mb_w;
    for (int y = mby * 4; y < mby * 4 + 4; y++)
        for (int x = mbx * 4; x < mbx * 4 + 4; x++)
            c->nzc_l[y * c->g.w4 + x] = v;
}

static void set_nzc_c(PC *c, int mb, int v) {
    int mbx = mb % c->g.mb_w, mby = mb / c->g.mb_w, w2 = c->g.mb_w * 2;
    for (int comp = 0; comp < 2; comp++)
        for (int y = mby * 2; y < mby * 2 + 2; y++)
            for (int x = mbx * 2; x < mbx * 2 + 2; x++)
                c->nzc_c[comp * (c->g.mb_h * 2) * w2 + y * w2 + x] = v;
}

static void fill_gdirect(PC *c, int gx, int gy, int n, int v) {
    for (int y = gy; y < gy + n; y++)
        for (int x = gx; x < gx + n; x++)
            c->gdirect[y * c->g.w4 + x] = (int8_t)v;
}

/* ---------- syntax elements (CabacSliceDecoder) ---------- */
static int skip_flag(PC *c, int mb, int is_b) {
    int left, top, inc = 0;
    left_top(c, mb, &left, &top);
    if (left >= 0 && c->g.mb_type[left] != T_PSKIP && c->g.mb_type[left] != T_BSKIP)
        inc++;
    if (top >= 0 && c->g.mb_type[top] != T_PSKIP &&
        c->g.mb_type[top] != T_BSKIP)
        inc++;
    return decision(&c->e, (is_b ? CTX_B_SKIP : CTX_SKIP) + inc);
}

/* raw intra mb_type 0..25 of an I slice */
static int mb_type_i_slice(PC *c, int mb) {
    Eng *e = &c->e;
    int left, top, inc = 0;
    left_top(c, mb, &left, &top);
    if (left >= 0 && c->g.mb_type[left] != T_I4 && c->g.mb_type[left] != T_I8)
        inc++;
    if (top >= 0 && c->g.mb_type[top] != T_I4 && c->g.mb_type[top] != T_I8)
        inc++;
    int base = CTX_MB_TYPE_I;
    if (!decision(e, base + inc)) return 0;
    if (terminate(e)) return 25;
    int v = 1 + 12 * decision(e, base + 3);
    if (decision(e, base + 4)) {
        v += 4;
        if (decision(e, base + 5)) v += 4;
    }
    v += decision(e, base + 6) << 1;
    v += decision(e, base + 7);
    return v;
}

/* the intra suffix inside a P or B mb_type */
static int intra_mb_type_suffix(PC *c, int base) {
    Eng *e = &c->e;
    if (!decision(e, base)) return 0;
    if (terminate(e)) return 25;
    int v = 1 + 12 * decision(e, base + 1);
    if (decision(e, base + 2)) {
        v += 4;
        if (decision(e, base + 2)) v += 4;
    }
    v += decision(e, base + 3) << 1;
    v += decision(e, base + 3);
    return v;
}

/* raw P mb_type: 0..3 inter, 5 + the intra mb_type */
static int mb_type_p_slice(PC *c) {
    Eng *e = &c->e;
    if (decision(e, CTX_SKIP + 3))
        return 5 + intra_mb_type_suffix(c, CTX_SKIP + 6);
    if (decision(e, CTX_SKIP + 4))
        return decision(e, CTX_SKIP + 6) ? 1 : 2;
    return decision(e, CTX_SKIP + 5) ? 3 : 0;
}

/* raw B mb_type: 0..22 inter, 23 + the intra mb_type */
static int mb_type_b_slice(PC *c, int mb) {
    Eng *e = &c->e;
    int left, top, inc = 0;
    left_top(c, mb, &left, &top);
    if (left >= 0 && c->g.mb_type[left] != T_BSKIP &&
        c->g.mb_type[left] != T_BDIRECT)
        inc++;
    if (top >= 0 && c->g.mb_type[top] != T_BSKIP &&
        c->g.mb_type[top] != T_BDIRECT)
        inc++;
    if (!decision(e, CTX_MB_TYPE_B + inc)) return 0;
    if (!decision(e, CTX_MB_TYPE_B + 3))
        return 1 + decision(e, CTX_MB_TYPE_B + 5);
    int v = decision(e, CTX_MB_TYPE_B + 4) << 3;
    v |= decision(e, CTX_MB_TYPE_B + 5) << 2;
    v |= decision(e, CTX_MB_TYPE_B + 5) << 1;
    v |= decision(e, CTX_MB_TYPE_B + 5);
    if (v < 8) return v + 3;
    if (v == 13) return 23 + intra_mb_type_suffix(c, CTX_MB_TYPE_B_INTRA);
    if (v == 14) return 11;
    if (v == 15) return 22;
    v = (v << 1) | decision(e, CTX_MB_TYPE_B + 5);
    return v - 4;
}

static int sub_mb_type_p(PC *c) {
    Eng *e = &c->e;
    if (decision(e, CTX_SUBMB_TYPE)) return 0;
    if (decision(e, CTX_SUBMB_TYPE + 1))
        return 3 - decision(e, CTX_SUBMB_TYPE + 2);
    return 1;
}

static int sub_mb_type_b(PC *c) {
    Eng *e = &c->e;
    if (!decision(e, CTX_B_SUBMB_TYPE)) return 0;
    if (!decision(e, CTX_B_SUBMB_TYPE + 1))
        return 1 + decision(e, CTX_B_SUBMB_TYPE + 3);
    int v = 3;
    if (decision(e, CTX_B_SUBMB_TYPE + 2)) {
        if (decision(e, CTX_B_SUBMB_TYPE + 3))
            return 11 + decision(e, CTX_B_SUBMB_TYPE + 3);
        v += 4;
    }
    v += 2 * decision(e, CTX_B_SUBMB_TYPE + 3);
    v += decision(e, CTX_B_SUBMB_TYPE + 3);
    return v;
}

static int transform8_flag(PC *c, int mb) {
    int left, top, inc = 0;
    left_top(c, mb, &left, &top);
    if (left >= 0 && c->transform8[left]) inc++;
    if (top >= 0 && c->transform8[top]) inc++;
    return decision(&c->e, CTX_TS8 + inc);
}

/* -1: use the predicted mode, else rem 0..7 */
static int intra4x4_pred_mode(PC *c) {
    Eng *e = &c->e;
    if (decision(e, CTX_IPR)) return -1;
    int v = decision(e, CTX_IPR + 1);
    v |= decision(e, CTX_IPR + 1) << 1;
    v |= decision(e, CTX_IPR + 1) << 2;
    return v;
}

static int chroma_ctx_ok(PC *c, int n) {
    int t = c->g.mb_type[n];
    return t != T_IPCM && is_intra_type(t) && c->chroma_mode[n] > 0 &&
           c->chroma_mode[n] <= 3;
}

static int intra_chroma_pred_mode(PC *c, int mb) {
    Eng *e = &c->e;
    int left, top, inc = 0;
    left_top(c, mb, &left, &top);
    if (left >= 0 && chroma_ctx_ok(c, left)) inc++;
    if (top >= 0 && chroma_ctx_ok(c, top)) inc++;
    if (!decision(e, CTX_CIPR + inc)) return 0;
    if (!decision(e, CTX_CIPR + 3)) return 1;
    return 2 + decision(e, CTX_CIPR + 3);
}

/* a neighbour block's list-lx (ref_idx > 0) for the ref_idx context, and
 * in *dir its direct / skip flag */
static int ref_ngb(PC *c, int mb, int lx, int nx, int ny, int *dir) {
    *dir = 0;
    if (nx < 0 || ny < 0) return 0;
    int nmb = (ny / 4) * c->g.mb_w + (nx / 4);
    if (nmb == mb) {
        if (!c->g.grefw[GI(&c->g, lx, ny, nx)]) return 0;
    } else {
        if (c->g.slice_id[nmb] != c->g.slice_id[mb]) return 0;
        if (c->g.mb_type[nmb] == T_IPCM) return 0;
    }
    *dir = c->gdirect[ny * c->g.w4 + nx] != 0;
    return c->g.gref[GI(&c->g, lx, ny, nx)] > 0;
}

/* clamp a ref_idx to one of list lx's pictures, else ref 0 */
static int clamp_ref(PC *c, int lx, int r) {
    int n = lx ? c->g.n_l1 : c->g.n_l0;
    const int32_t *ids = lx ? c->g.l1_pic_ids : c->g.l0_pic_ids;
    return (r >= 0 && r < n && ids[r] >= 0) ? r : 0;
}

static int ref_idx(PC *c, int mb, int lx, int gx, int gy, int is_b) {
    Eng *e = &c->e;
    if ((lx ? c->num_ref_l1 : c->num_ref_l0) <= 1) return 0;
    int a_dir, b_dir;
    int a = ref_ngb(c, mb, lx, gx - 1, gy, &a_dir);
    int b = ref_ngb(c, mb, lx, gx, gy - 1, &b_dir);
    int inc = is_b ? 2 * (b && !b_dir) + (a && !a_dir) : a + 2 * b;
    if (!decision(e, CTX_REF_NO + inc)) return 0;
    if (!decision(e, CTX_REF_NO + 4)) return clamp_ref(c, lx, 1);
    int v = 2;
    while (decision(e, CTX_REF_NO + 5)) {
        v++;
        if (v > 32) { c->err = 2; return 0; }   /* runaway ref_idx */
    }
    return clamp_ref(c, lx, v);
}

static void note_ref(PC *c, int lx, int gx, int gy, int pw, int ph, int ref) {
    for (int y = gy; y < gy + ph; y++)
        for (int x = gx; x < gx + pw; x++) {
            c->g.gref[GI(&c->g, lx, y, x)] = ref;
            c->g.grefw[GI(&c->g, lx, y, x)] = 1;
        }
}

static long long amvd(PC *c, int mb, int lx, int comp, int nx, int ny) {
    if (nx < 0 || ny < 0) return 0;
    int nmb = (ny / 4) * c->g.mb_w + (nx / 4);
    if (nmb == mb) {
        if (!c->g.gwritten[ny * c->g.w4 + nx]) return 0;
    } else if (c->g.slice_id[nmb] != c->g.slice_id[mb]) {
        return 0;
    }
    if (c->g.gref[GI(&c->g, lx, ny, nx)] < 0) return 0;
    long long v = c->gmvd[GI(&c->g, lx, ny, nx) * 2 + comp];
    return v < 0 ? -v : v;
}

/* a list-lx mvd component; c->err on a runaway code */
static int32_t mvd(PC *c, int mb, int lx, int comp, int gx, int gy) {
    Eng *e = &c->e;
    int base = CTX_MVD + comp * 7;
    long long s = amvd(c, mb, lx, comp, gx - 1, gy) +
                  amvd(c, mb, lx, comp, gx, gy - 1);
    int inc = s < 3 ? 0 : (s > 32 ? 2 : 1);
    if (!decision(e, base + inc)) return 0;
    /* UEG3 of |mvd| - 1 (CabacEngine.ueg_mv at base + 3) */
    static const int BIN_CTX[8] = {0, 1, 2, 3, 3, 3, 3, 3};
    int v = 0;
    if (decision(e, base + 3)) {
        int cnt = 1, bit;
        for (;;) {
            bit = decision(e, base + 3 + BIN_CTX[cnt < 7 ? cnt : 7]);
            v++;
            cnt++;
            if (bit == 0 || cnt == 8) break;
        }
        if (bit != 0) {
            int g = exp_bypass(e, 3);
            if (g < 0) { c->err = 2; return 0; }
            v += g + 1;
        }
    }
    v += 1;
    if (bypass(e)) v = -v;
    return v;
}

static int cbp_ctx(PC *c, int mb) {
    Eng *e = &c->e;
    int left, top;
    left_top(c, mb, &left, &top);
    int lcbp = left >= 0 ? c->cbp[left] : 0;
    int tcbp = top >= 0 ? c->cbp[top] : 0;
    int lok = left >= 0 && c->g.mb_type[left] != T_IPCM;
    int tok = top >= 0 && c->g.mb_type[top] != T_IPCM;
    int btop0 = tok && (tcbp & 4) == 0, btop1 = tok && (tcbp & 8) == 0;
    int aleft0 = lok && (lcbp & 2) == 0, aleft1 = lok && (lcbp & 8) == 0;
    int b0, b1, b2, b3, cbp;
    b0 = decision(e, CTX_CBP + aleft0 + (btop0 << 1));
    b1 = decision(e, CTX_CBP + (!b0) + (btop1 << 1));
    b2 = decision(e, CTX_CBP + aleft1 + ((!b0) << 1));
    b3 = decision(e, CTX_CBP + (!b2) + ((!b1) << 1));
    cbp = b0 | (b1 << 1) | (b2 << 2) | (b3 << 3);
    int ib = top >= 0 && (c->g.mb_type[top] == T_IPCM || (c->cbp[top] >> 4));
    int ia = left >= 0 &&
             (c->g.mb_type[left] == T_IPCM || (c->cbp[left] >> 4));
    if (decision(e, CTX_CBP + 4 + ia + (ib << 1))) {
        ib = top >= 0 && (c->g.mb_type[top] == T_IPCM || (c->cbp[top] >> 4) == 2);
        ia = left >= 0 && (c->g.mb_type[left] == T_IPCM ||
                           (c->cbp[left] >> 4) == 2);
        cbp |= 1 << (4 + decision(e, CTX_CBP + 8 + ia + (ib << 1)));
    }
    return cbp;
}

/* mb_qp_delta; c->err on a runaway code */
static int delta_qp(PC *c) {
    Eng *e = &c->e;
    int dq = 0;
    if (decision(e, CTX_DELTA_QP + (c->last_dqp != 0))) {
        int u = 0;
        if (decision(e, CTX_DELTA_QP + 2)) {
            u = 1;
            while (decision(e, CTX_DELTA_QP + 3)) {
                u++;
                if (u > 104) { c->err = 2; return 0; }
            }
        }
        int v = u + 1;
        dq = (v + 1) >> 1;
        if ((v & 1) == 0) dq = -dq;
    }
    c->last_dqp = dq;
    return dq;
}

/* a luma (grid nzc_l, scale 4) or chroma (nzc_c[comp], scale 2) block's
 * coded state for coded_block_flag: -1 unavailable, else 0 or 1 */
static int blk_nz(PC *c, int mb, int luma, int comp, int nx, int ny) {
    if (nx < 0 || ny < 0) return -1;
    int scale = luma ? 4 : 2;
    int nmb = (ny / scale) * c->g.mb_w + (nx / scale);
    if (nmb != mb && c->g.slice_id[nmb] != c->g.slice_id[mb]) return -1;
    if (nmb != mb && c->g.mb_type[nmb] == T_IPCM) return 1;
    if (luma) return c->nzc_l[ny * c->g.w4 + nx] != 0;
    int w2 = c->g.mb_w * 2;
    return c->nzc_c[comp * (c->g.mb_h * 2) * w2 + ny * w2 + nx] != 0;
}

/* coded_block_flag; for the DC categories dc_bit 0 (I16 DC), 1, 2 (Cb,
 * Cr DC) */
static int cbf(PC *c, int mb, int prop, int gx, int gy, int comp,
               int dc_bit) {
    int left, top;
    left_top(c, mb, &left, &top);
    int na = is_intra_type(c->g.mb_type[mb]), nb = na;
    if (prop == I16_DC || prop == CHROMA_DC) {
        if (top >= 0)
            nb = c->g.mb_type[top] == T_IPCM ||
                 ((c->cbf_dc[top] >> dc_bit) & 1);
        if (left >= 0)
            na = c->g.mb_type[left] == T_IPCM || ((c->cbf_dc[left] >> dc_bit) & 1);
    } else {
        int luma = prop == I16_AC || prop == LUMA_4x4;
        int va = blk_nz(c, mb, luma, comp, gx - 1, gy);
        int vb = blk_nz(c, mb, luma, comp, gx, gy - 1);
        if (va >= 0) na = va;
        if (vb >= 0) nb = vb;
    }
    int bit = decision(&c->e, CTX_CBF + OFF_CBF[prop] + na + (nb << 1));
    if (bit && (prop == I16_DC || prop == CHROMA_DC))
        c->cbf_dc[mb] |= 1 << dc_bit;
    return bit;
}

/* the significance map and levels of one block of category prop, in
 * scan order (csrc/cabac_residual.c); returns the coefficient count, or
 * -1 with c->err: 2 on a runaway code, 4 on an offset that int64 does
 * not hold (where the Python parser's handoff raises OverflowError).
 * is8 (LUMA_8x8) is a constant at each call, so each category's loop
 * is compiled apart. */
static ALWAYS_INLINE int
residual_core(PC *c, int prop, int32_t *sig, const int is8) {
    Eng *e = &c->e;
    if (e->offset > INT64_MAX || e->offset < INT64_MIN) {
        c->err = 4;
        return -1;
    }
    REng r = {e, e->pos, e->range, (long long)e->offset};
    int n = MAX_POS[prop] + 1;
    int map_base = is8 ? CTX_MAP_8x8 : CTX_MAP + OFF_MAP[prop];
    int last_base = is8 ? CTX_LAST_8x8 : CTX_LAST + OFF_MAP[prop];
    int one_base = is8 ? CTX_ONE_8x8 : CTX_ONE + OFF_ONE[prop];
    int abs_base = is8 ? CTX_ABS_8x8 : CTX_ABS + OFF_ONE[prop];
    int maxc2 = MAX_C2[prop];
    int i, ncoef = 0, ended = 0;
    for (i = 0; i < n; i++) sig[i] = 0;
    for (i = 0; i < n - 1; i++) {
        if (r_decision(&r, map_base + (is8 ? SIG8[i] : i))) {
            sig[i] = 1;
            ncoef++;
            if (r_decision(&r, last_base + (is8 ? LAST8[i] : i))) {
                ended = 1;
                break;
            }
        }
    }
    if (!ended) {
        sig[n - 1] = 1;
        ncoef++;
    }
    int c1 = 1, c2 = 0;
    for (i = n - 1; i >= 0; i--) {
        if (!sig[i]) continue;
        int v = 1 + r_decision(&r, one_base + c1);
        if (v == 2) {
            /* UEG0 continuation of coeff_abs_level_minus1 */
            if (r_decision(&r, abs_base + c2)) {
                int add = 0, cnt = 1, bit;
                for (;;) {
                    bit = r_decision(&r, abs_base + c2);
                    add += 1;
                    cnt += 1;
                    if (bit == 0 || cnt == 13) break;
                }
                if (bit != 0) {
                    int g = r_exp_bypass(&r, 0);
                    if (g < 0) { c->err = 2; return -1; }
                    add += g + 1;
                }
                v += add;
            }
            c2 = c2 + 1 > maxc2 ? maxc2 : c2 + 1;
            c1 = 0;
        } else if (c1) {
            c1 = c1 + 1 > 4 ? 4 : c1 + 1;
        }
        if (r_bypass(&r)) v = -v;
        sig[i] = v;
    }
    e->pos = r.pos;
    e->range = r.range;
    e->offset = r.offset;
    return ncoef;
}

static int residual_levels(PC *c, int prop, int32_t *sig) {
    return residual_core(c, prop, sig, 0);
}

static int residual_levels8(PC *c, int32_t *sig) {
    return residual_core(c, LUMA_8x8, sig, 1);
}

/* a QP's row of numpy's table indexing: a negative QP counts from the
 * end, one outside -52..51 is c->err 3 */
static inline int qp_row(PC *c, int qp) {
    if (qp < -52 || qp > 51) { c->err = 3; return -1; }
    return qp < 0 ? qp + 52 : qp;
}

/* the luma dequant row of a QP */
static const int64_t *luma_dq(PC *c, int intra, int qp) {
    int row = qp_row(c, qp);
    if (row < 0) return NULL;
    return c->dq4 + (intra ? 0 : 3) * 52 * 16 + row * 16;
}

/* dequantise a 4x4 block of levels in raster order into dst (all 16
 * positions; position 0 keeps dst[0] when keep_dc) */
static void dequant4(const int64_t *dq, const int32_t *blkc, int32_t *dst,
                     int keep_dc) {
    for (int p = keep_dc; p < 16; p++)
        dst[p] = (int32_t)((blkc[p] * dq[p] + 8) >> 4);
}

/* DequantTables.luma8x8: an 8x8 block of levels in raster order into
 * dst; -1 with c->err 3 on a QP outside the tables */
static int dequant8(PC *c, int intra, int qp, const int32_t *lev,
                    int32_t *dst) {
    int row = qp_row(c, qp);
    if (row < 0) return -1;
    const int64_t *dq = c->dq8 + ((intra ? 0 : 1) * 52 + row) * 64;
    int q6 = qp >= 0 ? qp / 6 : -((-qp + 5) / 6);    /* Python's qp // 6 */
    for (int p = 0; p < 64; p++) {
        int64_t base = lev[p] * dq[p];
        int64_t v = qp >= 36 ? (int64_t)((uint64_t)base << (q6 - 6))
                             : (base + ((int64_t)1 << (5 - q6))) >> (6 - q6);
        dst[p] = (int32_t)v;
    }
    return 0;
}

/* the luma residual of an 8x8-transform MB: one LUMA_8x8 block per
 * coded 8x8 quadrant (no coded_block_flag). Kept out of store_residual,
 * whose 4x4 path the I/P slices without the 8x8 transform run. */
static __attribute__((noinline)) int
store_luma8x8(PC *c, int mb, int cbp, int intra, int qp) {
    int mbx = mb % c->g.mb_w, mby = mb / c->g.mb_w, w4 = c->g.w4;
    int32_t sig[64], blkc[64];
    c->used8 = 1;
    for (int blk8 = 0; blk8 < 4; blk8++) {
        int gx = mbx * 4 + (blk8 % 2) * 2, gy = mby * 4 + (blk8 / 2) * 2;
        int v = 0;
        if (cbp & (1 << blk8)) {
            int tc = residual_levels8(c, sig);
            if (tc < 0) return -1;
            for (int j = 0; j < 64; j++) blkc[c->zigzag8[j]] = sig[j];
            if (dequant8(c, intra, qp, blkc,
                         c->coeffs8 + (mb * 4 + blk8) * 64)) return -1;
            v = tc < 16 ? tc : 16;
        }
        c->nzc_l[gy * w4 + gx] = c->nzc_l[gy * w4 + gx + 1] = v;
        c->nzc_l[(gy + 1) * w4 + gx] = c->nzc_l[(gy + 1) * w4 + gx + 1] = v;
    }
    return 0;
}

/* the residual of one MB and its QP (_store_mb_residual_cabac) */
static int store_residual(PC *c, int mb, int cbp, int is_i16) {
    int mbx = mb % c->g.mb_w, mby = mb / c->g.mb_w;
    int w4 = c->g.w4, w2 = c->g.mb_w * 2;
    int t = c->g.mb_type[mb];
    int intra = t == T_I4 || t == T_I16 || t == T_I8;
    if (is_i16 || cbp) {
        int delta = delta_qp(c);
        if (c->err) return -1;
        if (delta) {
            int q = (c->cur_qp + delta + 52) % 52;
            c->cur_qp = q < 0 ? q + 52 : q;
        }
    } else {
        c->last_dqp = 0;
    }
    c->qp[mb] = c->cur_qp;
    c->residual_seen = 1;
    int qp = c->cur_qp, qp_c[2];
    for (int k = 0; k < 2; k++) {
        int q = qp + (k == 0 ? c->coff0 : c->coff1);
        qp_c[k] = c->chroma_qp[q < 0 ? 0 : (q > 51 ? 51 : q)];
    }
    int32_t sig[16], blkc[16];
    int tc;

    if (is_i16 && cbf(c, mb, I16_DC, 0, 0, 0, 0)) {
        if (residual_levels(c, I16_DC, sig) < 0) return -1;
        int64_t dc[16], tmp[16];
        for (int k = 0; k < 16; k++) dc[c->zigzag[k]] = sig[k];
        /* luma_dc_dequant_ihadamard: rows, then columns */
        for (int r = 0; r < 4; r++) {
            int64_t a = dc[r * 4], b = dc[r * 4 + 1], cc = dc[r * 4 + 2],
                    d = dc[r * 4 + 3];
            tmp[r * 4] = a + b + cc + d;
            tmp[r * 4 + 1] = a + b - cc - d;
            tmp[r * 4 + 2] = a - b - cc + d;
            tmp[r * 4 + 3] = a - b + cc - d;
        }
        const int64_t *dq_dc = luma_dq(c, 1, qp);
        if (!dq_dc) return -1;
        int64_t qmul = dq_dc[0];
        for (int col = 0; col < 4; col++) {
            int64_t a = tmp[col], b = tmp[4 + col], cc = tmp[8 + col],
                    d = tmp[12 + col];
            int64_t o[4] = {a + b + cc + d, a + b - cc - d, a - b - cc + d,
                            a - b + cc - d};
            for (int r = 0; r < 4; r++)
                c->coeffs_l[(mb * 16 + r * 4 + col) * 16] =
                    wrap16((o[r] * qmul + 32) >> 6);
        }
    }

    if (c->transform8[mb]) {
        if (store_luma8x8(c, mb, cbp, intra, qp)) return -1;
    } else {
        for (int k = 0; k < 16; k++) {
            int raster = ZS2R[k];
            int bx = raster % 4, by = raster / 4;
            int gx = mbx * 4 + bx, gy = mby * 4 + by;
            int blk8 = (by >> 1) * 2 + (bx >> 1);
            if (!(cbp & (1 << blk8))) {
                c->nzc_l[gy * w4 + gx] = 0;
                continue;
            }
            int prop = is_i16 ? I16_AC : LUMA_4x4;
            if (cbf(c, mb, prop, gx, gy, 0, 0)) {
                if ((tc = residual_levels(c, prop, sig)) < 0) return -1;
                const int64_t *dq_l = luma_dq(c, intra, qp);
                if (!dq_l) return -1;
                memset(blkc, 0, sizeof(blkc));
                if (is_i16)
                    for (int j = 0; j < 15; j++) blkc[c->zigzag[j + 1]] = sig[j];
                else
                    for (int j = 0; j < 16; j++) blkc[c->zigzag[j]] = sig[j];
                dequant4(dq_l, blkc, c->coeffs_l + (mb * 16 + raster) * 16,
                         is_i16);
                c->nzc_l[gy * w4 + gx] = tc;
            } else {
                c->nzc_l[gy * w4 + gx] = 0;    /* an I16 block keeps its DC */
            }
        }
    }

    if (cbp & 0x30) {
        for (int comp = 0; comp < 2; comp++) {
            if (!cbf(c, mb, CHROMA_DC, 0, 0, 0, 1 + comp)) continue;
            if (residual_levels(c, CHROMA_DC, sig) < 0) return -1;
            /* hadamard2x2, then chroma_dc's (v * dq[0]) >> 5, wrapped */
            int64_t a = sig[0], b = sig[1], cc = sig[2], d = sig[3];
            int64_t h[4] = {a + b + cc + d, a - b + cc - d, a + b - cc - d,
                            a - b - cc + d};
            int prop = intra ? (1 + comp) : (4 + comp);
            int64_t qm = c->dq4[prop * 52 * 16 + qp_c[comp] * 16];
            int32_t *dstc = c->coeffs_c + ((mb * 2 + comp) * 4) * 16;
            for (int k = 0; k < 4; k++) dstc[k * 16] = wrap16((h[k] * qm) >> 5);
        }
    }
    if (cbp & 0x20) {
        for (int comp = 0; comp < 2; comp++) {
            int prop = intra ? (1 + comp) : (4 + comp);
            const int64_t *dq_c = c->dq4 + prop * 52 * 16 + qp_c[comp] * 16;
            for (int k = 0; k < 4; k++) {
                int cx = mbx * 2 + k % 2, cy = mby * 2 + k / 2;
                int32_t *nz = c->nzc_c + comp * (c->g.mb_h * 2) * w2 + cy * w2 + cx;
                if (cbf(c, mb, CHROMA_AC, cx, cy, comp, 0)) {
                    if ((tc = residual_levels(c, CHROMA_AC, sig)) < 0) return -1;
                    memset(blkc, 0, sizeof(blkc));
                    for (int j = 0; j < 15; j++) blkc[c->zigzag[j + 1]] = sig[j];
                    dequant4(dq_c, blkc,
                             c->coeffs_c + ((mb * 2 + comp) * 4 + k) * 16, 1);
                    *nz = tc;
                } else {
                    *nz = 0;
                }
            }
        }
    } else {
        set_nzc_c(c, mb, 0);
    }
    return 0;
}

/* ---------- direct prediction (slice_dec.apply_direct, direct.py) ---- */
/* the colocated block that direct_8x8_inference samples: each 8x8 takes
 * its outermost corner 4x4 block */
static inline void corner(PC *c, int *bx, int *by) {
    if (!c->direct_8x8) return;
    int mbx = (*bx / 4) * 4, mby = (*by / 4) * 4;
    *bx = mbx + (*bx - mbx < 2 ? 0 : 3);
    *by = mby + (*by - mby < 2 ? 0 : 3);
}

/* the index of colocated block (bx, by), or -1 with c->err 3 where the
 * colocated picture's grids do not reach it */
static inline int col_at(PC *c, int bx, int by) {
    if (bx >= c->col_w4 || by >= c->col_h4) { c->err = 3; return -1; }
    return by * c->col_w4 + bx;
}

/* DirectContext.col_zero: colZeroFlag, or -1 with c->err */
static int col_zero(PC *c, int bx, int by) {
    if (!c->has_col || c->col_long_term) return 0;
    int i = col_at(c, bx, by);
    if (i < 0) return -1;
    if (c->col_intra[i]) return 0;
    corner(c, &bx, &by);
    if ((i = col_at(c, bx, by)) < 0) return -1;
    const int32_t *mv;
    int ref_is0;
    if (c->col_ref0[i] >= 0) {
        mv = c->col_mv0 + 2 * i;
        ref_is0 = c->col_ref0[i] == 0;
    } else {
        mv = c->col_mv1 + 2 * i;
        ref_is0 = c->col_ref1[i] == 0;
    }
    long long x = mv[0], y = mv[1];
    return ref_is0 && (x < 0 ? -x : x) <= 1 && (y < 0 ? -y : y) <= 1;
}

/* DirectContext.spatial_refs for MB mb, computed at its first direct
 * block: its neighbours lie outside it, so they are final by then */
static void spatial_mb(PC *c, int mb) {
    if (c->sd_mb == mb) return;
    int gx = (mb % c->g.mb_w) * 4, gy = (mb / c->g.mb_w) * 4;
    for (int lx = 0; lx < 2; lx++) {
        int aa, ab, ac, ra, rb, rc;
        int32_t mva[2], mvb[2], mvc[2];
        blk_info(&c->g, gx - 1, gy, lx, mb, &aa, &ra, mva);
        blk_info(&c->g, gx, gy - 1, lx, mb, &ab, &rb, mvb);
        blk_info(&c->g, gx + 4, gy - 1, lx, mb, &ac, &rc, mvc);
        if (!ac) blk_info(&c->g, gx - 1, gy - 1, lx, mb, &ac, &rc, mvc);
        int ref = -1;
        int cand[3] = {aa ? ra : -1, ab ? rb : -1, ac ? rc : -1};
        for (int k = 0; k < 3; k++)
            if (cand[k] >= 0 && (ref < 0 || cand[k] < ref)) ref = cand[k];
        c->sd_ref[lx] = ref;
        c->sd_mv[lx][0] = c->sd_mv[lx][1] = 0;
        if (ref >= 0) pred_mv(&c->g, gx, gy, 4, 4, lx, ref, mb, c->sd_mv[lx]);
    }
    if (c->sd_ref[0] < 0 && c->sd_ref[1] < 0) {
        c->sd_ref[0] = c->sd_ref[1] = 0;
        c->sd_use[0] = c->sd_use[1] = 1;
    } else {
        c->sd_use[0] = c->sd_ref[0] >= 0;
        c->sd_use[1] = c->sd_ref[1] >= 0;
    }
    c->sd_mb = mb;
}

/* DirectContext.temporal_direct of block (bx, by): ref0 and both MVs */
static int temporal(PC *c, int bx, int by, int *ref0, int32_t mv0[2],
                    int32_t mv1[2]) {
    if (!c->has_col) { c->err = 5; return -1; }
    corner(c, &bx, &by);
    int i = col_at(c, bx, by);
    if (i < 0) return -1;
    int32_t mvc[2] = {0, 0};
    int col_id = -1, intra = c->col_intra[i] != 0, from_l1 = 0;
    if (!intra) {
        if (c->col_ref0[i] >= 0) {
            mvc[0] = c->col_mv0[2 * i]; mvc[1] = c->col_mv0[2 * i + 1];
            col_id = c->col_refpic0[i];
        } else {
            mvc[0] = c->col_mv1[2 * i]; mvc[1] = c->col_mv1[2 * i + 1];
            col_id = c->col_refpic1[i];
            from_l1 = 1;
        }
    }
    int r = 0;
    if (!intra && !from_l1)     /* the lowest L0 index of the picture */
        for (int k = 0; k < c->g.n_l0; k++)
            if (c->g.l0_pic_ids[k] >= 0 && c->g.l0_pic_ids[k] == col_id) {
                r = k;
                break;
            }
    long long dsf = r < c->g.n_l0 ? c->dsf[r] : 256;
    for (int k = 0; k < 2; k++) {
        long long v = (dsf * mvc[k] + 128) >> 8;
        if (v > INT32_MAX || v < INT32_MIN) { c->err = 6; return -1; }
        mv0[k] = (int32_t)v;
    }
    for (int k = 0; k < 2; k++)
        mv1[k] = (int32_t)((uint32_t)mv0[k] - (uint32_t)mvc[k]);
    *ref0 = r;
    return 0;
}

/* the motion of a direct region: the whole MB (nblk 4) or one 8x8
 * (nblk 2) at block (gx0, gy0) */
static int apply_direct(PC *c, int mb, int gx0, int gy0, int nblk) {
    if (nblk == 4) {
        int promoted = 0;
        if (c->has_col && c->col_mb16) {
            if (mb >= c->col_n16) { c->err = 3; return -1; }
            promoted = c->col_mb16[mb] != 0;
        }
        c->mb16[mb] = (uint8_t)promoted;
        if (c->compat)
            c->ibs_mode[mb] = c->g.mb_type[mb] == T_BSKIP ? 2 : (promoted ? 1 : 0);
    } else {
        c->sub_direct[mb] = 1;
    }
    int step = c->direct_8x8 ? 2 : 1;
    if (c->spatial) spatial_mb(c, mb);
    for (int oy = 0; oy < nblk; oy += step)
        for (int ox = 0; ox < nblk; ox += step) {
            int bx = gx0 + ox, by = gy0 + oy;
            if (c->spatial) {
                int cz = col_zero(c, bx, by);
                if (cz < 0) return -1;
                for (int lx = 0; lx < 2; lx++) {
                    int use = c->sd_use[lx], ref = c->sd_ref[lx];
                    int zero = !use || (cz && ref == 0);
                    set_partition(&c->g, bx, by, step, step, lx,
                                  use ? ref : -1,
                                  zero ? 0 : c->sd_mv[lx][0],
                                  zero ? 0 : c->sd_mv[lx][1]);
                }
            } else {
                int r0;
                int32_t m0[2], m1[2];
                if (temporal(c, bx, by, &r0, m0, m1)) return -1;
                set_partition(&c->g, bx, by, step, step, 0, r0, m0[0], m0[1]);
                set_partition(&c->g, bx, by, step, step, 1, 0, m1[0], m1[1]);
            }
        }
    return 0;
}

/* ---------- MBs ---------- */
/* the intra MB after its mb_type (raw 0 I_NxN, 1..24 I16x16, 25 IPCM) */
static int decode_i_mb(PC *c, int mb, int raw) {
    int mbx = mb % c->g.mb_w, mby = mb / c->g.mb_w, w4 = c->g.w4;
    for (int q = 0; q < 4; q++) c->g.pred_mode[mb * 4 + q] = -1;

    if (raw == 25) {   /* IPCM: the samples start at the next byte */
        Eng *e = &c->e;
        c->g.mb_type[mb] = T_IPCM;
        long long bpos = (e->pos + 7) >> 3, nbytes = e->nbits >> 3;
        if (bpos + 384 > nbytes) { c->err = 2; return -1; }
        memcpy(c->ipcm_buf + (size_t)mb * 384, e->data + bpos, 384);
        c->ipcm_flag[mb] = 1;
        c->qp[mb] = 0;
        set_nzc_l(c, mb, 16);
        set_nzc_c(c, mb, 16);
        for (int y = mby * 4; y < mby * 4 + 4; y++)
            for (int x = mbx * 4; x < mbx * 4 + 4; x++)
                c->g.i4_grid[y * w4 + x] = 2;
        c->cbf_dc[mb] = 7;
        c->last_dqp = 0;
        eng_start(e, (bpos + 384) * 8);   /* the contexts carry on */
        return 0;
    }

    int cbp;
    if (raw == 0) {
        int t8 = c->t8_mode ? transform8_flag(c, mb) : 0;
        c->g.mb_type[mb] = t8 ? T_I8 : T_I4;
        c->transform8[mb] = (uint8_t)t8;
        int32_t modes[16] = {0};
        for (int k = 0; k < (t8 ? 4 : 16); k++) {
            int bx, by;
            if (t8) {
                bx = (k & 1) * 2;
                by = (k >> 1) * 2;
            } else {
                bx = ZS2R[k] % 4;
                by = ZS2R[k] / 4;
            }
            int gx = mbx * 4 + bx, gy = mby * 4 + by;
            int pred = pred_i4_mode(&c->g, gx, gy);
            int rem = intra4x4_pred_mode(c);
            int mode = rem < 0 ? pred : (rem < pred ? rem : rem + 1);
            if (t8) {
                c->g.i4_grid[gy * w4 + gx] = mode;
                c->g.i4_grid[gy * w4 + gx + 1] = mode;
                c->g.i4_grid[(gy + 1) * w4 + gx] = mode;
                c->g.i4_grid[(gy + 1) * w4 + gx + 1] = mode;
                modes[by * 4 + bx] = modes[by * 4 + bx + 1] = mode;
                modes[(by + 1) * 4 + bx] = modes[(by + 1) * 4 + bx + 1] = mode;
            } else {
                c->g.i4_grid[gy * w4 + gx] = mode;
                modes[by * 4 + bx] = mode;
            }
        }
        memcpy(c->i4_modes + mb * 16, modes, sizeof(modes));
        c->chroma_mode[mb] = intra_chroma_pred_mode(c, mb);
        cbp = cbp_ctx(c, mb);
    } else {
        c->g.mb_type[mb] = T_I16;
        int mt = raw - 1;
        c->i16_mode[mb] = mt & 3;
        cbp = c->cbp_i16[mt >> 2];
        for (int y = mby * 4; y < mby * 4 + 4; y++)
            for (int x = mbx * 4; x < mbx * 4 + 4; x++)
                c->g.i4_grid[y * w4 + x] = 2;
        c->chroma_mode[mb] = intra_chroma_pred_mode(c, mb);
    }
    c->cbp[mb] = cbp;
    return store_residual(c, mb, cbp, c->g.mb_type[mb] == T_I16);
}

/* a partition's list-lx mvd pair, its MV from the MVP, and its mvd */
static int set_part_with_mvd(PC *c, int mb, int lx, int px, int py, int pw,
                             int ph, int ref) {
    int32_t d0 = mvd(c, mb, lx, 0, px, py);
    if (c->err) return -1;
    int32_t d1 = mvd(c, mb, lx, 1, px, py);
    if (c->err) return -1;
    int32_t mvp[2];
    pred_mv(&c->g, px, py, pw, ph, lx, ref, mb, mvp);
    /* int32 sums wrap, as numpy's do */
    set_partition(&c->g, px, py, pw, ph, lx, ref,
                  (int32_t)((uint32_t)mvp[0] + (uint32_t)d0),
                  (int32_t)((uint32_t)mvp[1] + (uint32_t)d1));
    for (int y = py; y < py + ph; y++)
        for (int x = px; x < px + pw; x++) {
            c->gmvd[GI(&c->g, lx, y, x) * 2] = d0;
            c->gmvd[GI(&c->g, lx, y, x) * 2 + 1] = d1;
        }
    return 0;
}

static void clear_block_grids(PC *c, int mb, int direct) {
    int gx = (mb % c->g.mb_w) * 4, gy = (mb / c->g.mb_w) * 4;
    for (int lx = 0; lx < 2; lx++)
        for (int y = gy; y < gy + 4; y++)
            for (int x = gx; x < gx + 4; x++) {
                c->gmvd[GI(&c->g, lx, y, x) * 2] = 0;
                c->gmvd[GI(&c->g, lx, y, x) * 2 + 1] = 0;
            }
    fill_gdirect(c, gx, gy, 4, direct);
}

/* an inter MB's coded_block_pattern, transform_size_8x8_flag and
 * residual, after its motion */
static int inter_residual(PC *c, int mb, int t8_allowed) {
    int cbp = cbp_ctx(c, mb);
    c->cbp[mb] = cbp;
    if ((cbp & 15) && c->t8_mode && t8_allowed)
        c->transform8[mb] = (uint8_t)transform8_flag(c, mb);
    if (cbp) return store_residual(c, mb, cbp, 0);
    c->last_dqp = 0;
    c->qp[mb] = c->cur_qp;
    set_nzc_l(c, mb, 0);
    set_nzc_c(c, mb, 0);
    return 0;
}

static int decode_p_mb(PC *c, int mb) {
    int gx = (mb % c->g.mb_w) * 4, gy = (mb / c->g.mb_w) * 4;
    clear_block_grids(c, mb, 0);
    int raw = mb_type_p_slice(c);
    if (raw >= 5) {
        if (decode_i_mb(c, mb, raw - 5)) return -1;
        mark_intra_grids(&c->g, mb);
        return 0;
    }
    int t8_allowed = 1;
    for (int q = 0; q < 4; q++) c->g.pred_mode[mb * 4 + q] = 0;
    if (raw == 0) {
        c->g.mb_type[mb] = T_P16;
        int ref = ref_idx(c, mb, 0, gx, gy, 0);
        if (c->err) return -1;
        if (set_part_with_mvd(c, mb, 0, gx, gy, 4, 4, ref)) return -1;
    } else if (raw == 1 || raw == 2) {
        /* 16x8 (partitions stacked) or 8x16 (side by side) */
        c->g.mb_type[mb] = raw == 1 ? T_P168 : T_P816;
        int pw = raw == 1 ? 4 : 2, ph = raw == 1 ? 2 : 4;
        int px[2], py[2], refs[2];
        for (int p = 0; p < 2; p++) {
            px[p] = raw == 1 ? gx : gx + 2 * p;
            py[p] = raw == 1 ? gy + 2 * p : gy;
            refs[p] = ref_idx(c, mb, 0, px[p], py[p], 0);
            if (c->err) return -1;
            note_ref(c, 0, px[p], py[p], pw, ph, refs[p]);
        }
        for (int p = 0; p < 2; p++)
            if (set_part_with_mvd(c, mb, 0, px[p], py[p], pw, ph, refs[p]))
                return -1;
    } else {           /* P_8x8 (raw 3; the tree never gives P_8x8ref0) */
        c->g.mb_type[mb] = T_P88;
        int subs[4], refs[4];
        for (int q = 0; q < 4; q++) subs[q] = sub_mb_type_p(c);
        for (int q = 0; q < 4; q++) {
            int qx = gx + (q % 2) * 2, qy = gy + (q / 2) * 2;
            refs[q] = ref_idx(c, mb, 0, qx, qy, 0);
            if (c->err) return -1;
            note_ref(c, 0, qx, qy, 2, 2, refs[q]);
        }
        for (int q = 0; q < 4; q++) {
            int qx = gx + (q % 2) * 2, qy = gy + (q / 2) * 2, st = subs[q];
            int n_parts = st == 0 ? 1 : (st == 3 ? 4 : 2);
            int pw = (st == 0 || st == 1) ? 2 : 1;
            int ph = (st == 0 || st == 2) ? 2 : 1;
            for (int part = 0; part < n_parts; part++) {
                int px = qx, py = qy;
                if (st == 1) py += part;
                else if (st == 2) px += part;
                else if (st == 3) { px += part % 2; py += part / 2; }
                if (set_part_with_mvd(c, mb, 0, px, py, pw, ph, refs[q]))
                    return -1;
            }
            if (st != 0) t8_allowed = 0;
        }
    }
    set_partition(&c->g, gx, gy, 4, 4, 1, -1, 0, 0);
    finish_inter_mb(&c->g, mb);
    return inter_residual(c, mb, t8_allowed);
}

/* the partition (px, py) of part `part` of a B sub-MB of shape pw x ph
 * at (qx, qy) */
static inline void sub_part_pos(int qx, int qy, int pw, int ph, int part,
                                int *px, int *py) {
    *px = qx;
    *py = qy;
    if (pw == 2 && ph == 1) *py += part;
    else if (pw == 1 && ph == 2) *px += part;
    else if (pw == 1 && ph == 1) { *px += part % 2; *py += part / 2; }
}

static int decode_b_mb(PC *c, int mb) {
    int gx = (mb % c->g.mb_w) * 4, gy = (mb / c->g.mb_w) * 4;
    clear_block_grids(c, mb, 0);
    int raw = mb_type_b_slice(c, mb);
    if (raw >= 23) {
        if (decode_i_mb(c, mb, raw - 23)) return -1;
        mark_intra_grids(&c->g, mb);
        return 0;
    }
    int t8_allowed = 1;
    if (raw == 0) {
        c->g.mb_type[mb] = T_BDIRECT;
        if (apply_direct(c, mb, gx, gy, 4)) return -1;
        fill_gdirect(c, gx, gy, 4, 1);
    } else if (raw <= 3) {
        c->g.mb_type[mb] = T_B16;
        int mode = raw - 1, use[2] = {mode != 1, mode != 0}, refs[2] = {0, 0};
        for (int lx = 0; lx < 2; lx++)
            if (use[lx]) {
                refs[lx] = ref_idx(c, mb, lx, gx, gy, 1);
                if (c->err) return -1;
            }
        for (int lx = 0; lx < 2; lx++)
            if (!use[lx]) set_partition(&c->g, gx, gy, 4, 4, lx, -1, 0, 0);
        for (int lx = 0; lx < 2; lx++)
            if (use[lx] && set_part_with_mvd(c, mb, lx, gx, gy, 4, 4, refs[lx]))
                return -1;
    } else if (raw <= 21) {
        int t = raw - 4, is16x8 = (t % 2) == 0;
        const int *modes = B_TWOPART[t / 2];
        c->g.mb_type[mb] = is16x8 ? T_B168 : T_B816;
        int pw = is16x8 ? 4 : 2, ph = is16x8 ? 2 : 4;
        int px[2] = {gx, is16x8 ? gx : gx + 2};
        int py[2] = {gy, is16x8 ? gy + 2 : gy};
        int refs[2][2] = {{-1, -1}, {-1, -1}};
        for (int lx = 0; lx < 2; lx++)
            for (int p = 0; p < 2; p++) {
                if (modes[p] == lx || modes[p] == 2) {
                    refs[p][lx] = ref_idx(c, mb, lx, px[p], py[p], 1);
                    if (c->err) return -1;
                }
                note_ref(c, lx, px[p], py[p], pw, ph, refs[p][lx]);
            }
        for (int p = 0; p < 2; p++)
            for (int lx = 0; lx < 2; lx++)
                if (refs[p][lx] < 0)
                    set_partition(&c->g, px[p], py[p], pw, ph, lx, -1, 0, 0);
        for (int lx = 0; lx < 2; lx++)
            for (int p = 0; p < 2; p++)
                if (refs[p][lx] >= 0 &&
                    set_part_with_mvd(c, mb, lx, px[p], py[p], pw, ph,
                                      refs[p][lx]))
                    return -1;
    } else {           /* 22: B_8x8 */
        c->g.mb_type[mb] = T_B88;
        int subs[4], refs[4][2];
        for (int q = 0; q < 4; q++) {
            subs[q] = sub_mb_type_b(c);
            if (subs[q] > 3) t8_allowed = 0;
        }
        /* direct quadrants resolve their motion before the ref loop, so
         * that their refs and direct flags feed the later contexts */
        for (int q = 0; q < 4; q++)
            if (B_SUB[subs[q]][0] == -1) {
                int qx = gx + (q % 2) * 2, qy = gy + (q / 2) * 2;
                if (apply_direct(c, mb, qx, qy, 2)) return -1;
                fill_gdirect(c, qx, qy, 2, 1);
            }
        for (int q = 0; q < 4; q++) refs[q][0] = refs[q][1] = -1;
        for (int lx = 0; lx < 2; lx++)
            for (int q = 0; q < 4; q++) {
                int mode = B_SUB[subs[q]][0];
                if (mode == -1) continue;
                int qx = gx + (q % 2) * 2, qy = gy + (q / 2) * 2;
                if (mode == lx || mode == 2) {
                    refs[q][lx] = ref_idx(c, mb, lx, qx, qy, 1);
                    if (c->err) return -1;
                }
                note_ref(c, lx, qx, qy, 2, 2, refs[q][lx]);
            }
        for (int q = 0; q < 4; q++) {
            if (B_SUB[subs[q]][0] == -1) continue;
            int qx = gx + (q % 2) * 2, qy = gy + (q / 2) * 2;
            for (int lx = 0; lx < 2; lx++)
                if (refs[q][lx] < 0)
                    set_partition(&c->g, qx, qy, 2, 2, lx, -1, 0, 0);
        }
        for (int lx = 0; lx < 2; lx++)
            for (int q = 0; q < 4; q++) {
                const int *s = B_SUB[subs[q]];
                if (s[0] == -1 || (s[0] != lx && s[0] != 2)) continue;
                int qx = gx + (q % 2) * 2, qy = gy + (q / 2) * 2;
                for (int part = 0; part < s[1]; part++) {
                    int px, py;
                    sub_part_pos(qx, qy, s[2], s[3], part, &px, &py);
                    if (set_part_with_mvd(c, mb, lx, px, py, s[2], s[3],
                                          refs[q][lx]))
                        return -1;
                }
            }
    }
    finish_inter_mb(&c->g, mb);
    return inter_residual(c, mb, t8_allowed);
}

static void decode_p_skip(PC *c, int mb) {
    int gx = (mb % c->g.mb_w) * 4, gy = (mb / c->g.mb_w) * 4;
    clear_block_grids(c, mb, 1);
    c->g.mb_type[mb] = T_PSKIP;
    int32_t mv[2];
    pred_skip_mv(&c->g, gx, gy, mb, mv);
    set_partition(&c->g, gx, gy, 4, 4, 0, 0, mv[0], mv[1]);
    set_partition(&c->g, gx, gy, 4, 4, 1, -1, 0, 0);
    c->cbp[mb] = 0;
    c->qp[mb] = c->cur_qp;
    c->last_dqp = 0;
    finish_inter_mb(&c->g, mb);
}

static int decode_b_skip(PC *c, int mb) {
    int gx = (mb % c->g.mb_w) * 4, gy = (mb / c->g.mb_w) * 4;
    clear_block_grids(c, mb, 1);
    c->g.mb_type[mb] = T_BSKIP;
    if (apply_direct(c, mb, gx, gy, 4)) return -1;
    c->cbp[mb] = 0;
    c->qp[mb] = c->cur_qp;
    c->last_dqp = 0;
    finish_inter_mb(&c->g, mb);
    return 0;
}

/* ---------- entry ---------- */
/* ptrs / params layouts in decoder/cbind.py (parse_cabac_slice_native).
 * out: [0] one past the last MB, [1] the engine's end bit, [2] error
 * (PC.err), [3] bins decoded, [4] MBs marked correct, [5] 1 if an MB
 * reached its residual's QP, [6] 1 if an MB reached the 8x8 residual.
 * Returns out[2]. */
long long parse_cabac_slice(const void **ptrs, const int64_t *params,
                            int64_t *out) {
    PC c;
    memset(&c, 0, sizeof(c));
    int i = 0;
    c.e.data = (const uint8_t *)ptrs[i++];
    const int32_t *init_mn = (const int32_t *)ptrs[i++];
    c.e.range_lps = (const int32_t *)ptrs[i++];
    c.e.state_trans = (const int32_t *)ptrs[i++];
    c.dq4 = (const int64_t *)ptrs[i++];
    c.chroma_qp = (const int32_t *)ptrs[i++];
    c.zigzag = (const int32_t *)ptrs[i++];
    c.cbp_i16 = (const int32_t *)ptrs[i++];
    c.g.l0_pic_ids = (const int32_t *)ptrs[i++];
    c.g.mb_type = (int32_t *)ptrs[i++];
    c.g.slice_id = (int32_t *)ptrs[i++];
    c.transform8 = (uint8_t *)ptrs[i++];
    c.i16_mode = (int32_t *)ptrs[i++];
    c.chroma_mode = (int32_t *)ptrs[i++];
    c.i4_modes = (int32_t *)ptrs[i++];
    c.cbp = (int32_t *)ptrs[i++];
    c.qp = (int32_t *)ptrs[i++];
    c.g.mv = (int32_t *)ptrs[i++];
    c.g.refidx = (int8_t *)ptrs[i++];
    c.g.ref_pic = (int32_t *)ptrs[i++];
    c.g.pred_mode = (int8_t *)ptrs[i++];
    c.coeffs_l = (int32_t *)ptrs[i++];
    c.coeffs_c = (int32_t *)ptrs[i++];
    c.nzc_l = (int32_t *)ptrs[i++];
    c.nzc_c = (int32_t *)ptrs[i++];
    c.g.disable_deblock = (int32_t *)ptrs[i++];
    c.g.alpha_off = (int32_t *)ptrs[i++];
    c.g.beta_off = (int32_t *)ptrs[i++];
    c.mb_correct = (uint8_t *)ptrs[i++];
    c.g.i4_grid = (int32_t *)ptrs[i++];
    c.g.gmv = (int32_t *)ptrs[i++];
    c.g.gref = (int32_t *)ptrs[i++];
    c.g.gwritten = (uint8_t *)ptrs[i++];
    c.g.grefw = (uint8_t *)ptrs[i++];
    c.cbf_dc = (int32_t *)ptrs[i++];
    c.gmvd = (int32_t *)ptrs[i++];
    c.gdirect = (int8_t *)ptrs[i++];
    c.ipcm_buf = (uint8_t *)ptrs[i++];
    c.ipcm_flag = (uint8_t *)ptrs[i++];
    c.g.l1_pic_ids = (const int32_t *)ptrs[i++];
    c.dq8 = (const int64_t *)ptrs[i++];
    c.zigzag8 = (const int32_t *)ptrs[i++];
    c.coeffs8 = (int32_t *)ptrs[i++];
    c.mb16 = (uint8_t *)ptrs[i++];
    c.sub_direct = (uint8_t *)ptrs[i++];
    c.ibs_mode = (uint8_t *)ptrs[i++];
    c.col_mv0 = (const int32_t *)ptrs[i++];
    c.col_mv1 = (const int32_t *)ptrs[i++];
    c.col_ref0 = (const int32_t *)ptrs[i++];
    c.col_ref1 = (const int32_t *)ptrs[i++];
    c.col_refpic0 = (const int32_t *)ptrs[i++];
    c.col_refpic1 = (const int32_t *)ptrs[i++];
    c.col_intra = (const uint8_t *)ptrs[i++];
    c.col_mb16 = (const uint8_t *)ptrs[i++];
    c.dsf = (const int32_t *)ptrs[i++];

    i = 0;
    c.e.nbits = params[i++];
    long long start_bit = params[i++];
    int is_i = (int)params[i++];
    c.first_mb = (int)params[i++];
    c.g.mb_w = (int)params[i++];
    c.g.mb_h = (int)params[i++];
    c.g.slice_idx = (int)params[i++];
    c.cur_qp = (int)params[i++];
    int init_idc = (int)params[i++];
    c.num_ref_l0 = (int)params[i++];
    c.g.n_l0 = (int)params[i++];
    c.g.constrained = (int)params[i++];
    c.g.ddb_idc = (int)params[i++];
    c.g.a_off = (int)params[i++];
    c.g.b_off = (int)params[i++];
    c.coff0 = (int)params[i++];
    c.coff1 = (int)params[i++];
    int is_b = (int)params[i++];
    c.t8_mode = (int)params[i++];
    c.num_ref_l1 = (int)params[i++];
    c.g.n_l1 = (int)params[i++];
    c.spatial = (int)params[i++];
    c.direct_8x8 = (int)params[i++];
    c.has_col = (int)params[i++];
    c.col_long_term = (int)params[i++];
    c.col_w4 = (int)params[i++];
    c.col_h4 = (int)params[i++];
    c.col_n16 = (int)params[i++];
    c.compat = (int)params[i++];
    if (!c.col_n16) c.col_mb16 = NULL;
    c.g.w4 = c.g.mb_w * 4;
    c.g.h4 = c.g.mb_h * 4;
    c.sd_mb = -1;

    int init_qp = c.cur_qp < 0 ? 0 : (c.cur_qp > 51 ? 51 : c.cur_qp);
    ctx_init(&c.e, init_mn, is_i, init_idc, init_qp);
    eng_start(&c.e, start_bit);

    int mb = c.first_mb;
    long long n_mb = (long long)c.g.mb_w * c.g.mb_h, done = 0;
    while (mb < n_mb) {
        mb_common_init(&c.g, mb);
        int rc;
        if (is_i)
            rc = decode_i_mb(&c, mb, mb_type_i_slice(&c, mb));
        else if (skip_flag(&c, mb, is_b)) {
            if (is_b)
                rc = decode_b_skip(&c, mb);
            else {
                decode_p_skip(&c, mb);
                rc = 0;
            }
        } else
            rc = is_b ? decode_b_mb(&c, mb) : decode_p_mb(&c, mb);
        if (rc) break;
        c.mb_correct[mb] = 1;
        done++;
        mb++;
        if (terminate(&c.e)) break;   /* end_of_slice_flag */
    }
    out[0] = mb;
    out[1] = c.e.pos;
    out[2] = c.err;
    out[3] = c.e.bins;
    out[4] = done;
    out[5] = c.residual_seen;
    out[6] = c.used8;
    return c.err;
}
