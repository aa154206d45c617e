/* The MB-level prediction core of the decoder's two host-C slice parsers,
 * csrc/parse_cavlc.c and csrc/parse_cabac.c, which both include it: one
 * view of the FrameSymbols grids they share (MbGrid, embedded in each
 * parser's context as `g`), the neighbour availability, the intra 4x4
 * mode prediction, the MV prediction over the global motion grids of
 * both lists (decoder/mvpred.py; CAVLC calls it with list 0) and the
 * per-MB grid updates of decoder/slice_dec.py. Each parser keeps its own
 * syntax: bit reader or arithmetic engine, MB parsing and residuals.
 *
 * _build.py hashes this header with each source that includes it, so an
 * edit here rebuilds both parsers. Everything is static: each library
 * gets its own copy, and the hot lookups are inlined wherever they are
 * called (ALWAYS_INLINE), whatever the compiler's size heuristics make
 * of a unit as large as parse_cabac.c.
 */

#ifndef OPENH264_TPU_TORCH_MB_PRED_H
#define OPENH264_TPU_TORCH_MB_PRED_H

#include <stdint.h>

#define ALWAYS_INLINE inline __attribute__((always_inline))

/* the FrameSymbols arrays and the slice's parameters the core reads and
 * writes; n MBs, H4 x W4 4x4 blocks */
typedef struct {
    int mb_w, mb_h, w4, h4, slice_idx;
    int constrained;              /* constrained_intra_pred_flag */
    int ddb_idc, a_off, b_off;    /* the slice's deblocking controls */
    int n_l0, n_l1;               /* reference list lengths */
    const int32_t *l0_pic_ids;    /* [n_l0], -1 for a missing picture */
    const int32_t *l1_pic_ids;    /* [n_l1], -1 for a missing picture */
    int32_t *mb_type, *slice_id;  /* [n] */
    int32_t *disable_deblock, *alpha_off, *beta_off;   /* [n] */
    int32_t *mv;                  /* [n][2][16][2] */
    int8_t *refidx;               /* [n][2][4] */
    int32_t *ref_pic;             /* [n][2][4] */
    int8_t *pred_mode;            /* [n][4] */
    int32_t *i4_grid;             /* [H4][W4] */
    int32_t *gmv;                 /* [2][H4][W4][2] */
    int32_t *gref;                /* [2][H4][W4] */
    uint8_t *gwritten;            /* [H4][W4] */
    uint8_t *grefw;               /* [2][H4][W4] */
} MbGrid;

/* index of 4x4 block (x, y) of list lx in gref / grefw (gmv: twice it),
 * on a grid of h4 x w4 blocks */
#define GIX(h4, w4, lx, y, x) (((lx) * (h4) + (y)) * (w4) + (x))
#define GI(g, lx, y, x) GIX((g)->h4, (g)->w4, lx, y, x)

/* z-scan 4x4 block -> raster 4x4 block within an MB */
static const int ZS2R[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13,
                             10, 11, 14, 15};

static inline int32_t wrap16(int64_t x) {
    return (int32_t)(int16_t)(x & 0xFFFF);
}

static inline int is_intra_type(int t) { return t >= 0 && t <= 3; }

/* ---------- neighbours ---------- */
static inline int mb_avail(const MbGrid *g, int mbx, int mby) {
    if (mbx < 0 || mby < 0 || mbx >= g->mb_w || mby >= g->mb_h) return 0;
    return g->slice_id[mby * g->mb_w + mbx] == g->slice_idx;
}

static inline int i4_mode_at(const MbGrid *g, int bx, int by) {
    if (bx < 0 || by < 0) return -1;
    int mbx = bx / 4, mby = by / 4;
    if (!mb_avail(g, mbx, mby)) return -1;
    if (!is_intra_type(g->mb_type[mby * g->mb_w + mbx]))
        return g->constrained ? -1 : 2;
    int m = g->i4_grid[by * g->w4 + bx];
    return m < 0 ? 2 : m;
}

static inline int pred_i4_mode(const MbGrid *g, int gx, int gy) {
    int ma = i4_mode_at(g, gx - 1, gy);
    int mb = i4_mode_at(g, gx, gy - 1);
    if (ma < 0 || mb < 0) return 2;
    return ma < mb ? ma : mb;
}

/* ---------- MV prediction over the global grids (mvpred.py) ---------- */
static ALWAYS_INLINE void blk_info(const MbGrid *g, int bx, int by, int lx,
                                   int cur_mb, int *avail, int *ref,
                                   int32_t mvout[2]) {
    int w4 = g->w4, h4 = g->h4;
    mvout[0] = mvout[1] = 0;
    *avail = 0;
    *ref = -1;
    if (bx < 0 || by < 0 || bx >= w4 || by >= h4) return;
    int mb = (by / 4) * g->mb_w + (bx / 4);
    if (mb == cur_mb) {
        if (!g->gwritten[by * w4 + bx]) return;
    } else if (g->slice_id[mb] != g->slice_idx) {
        return;
    }
    *avail = 1;
    *ref = g->gref[GI(g, lx, by, bx)];
    mvout[0] = g->gmv[GI(g, lx, by, bx) * 2];
    mvout[1] = g->gmv[GI(g, lx, by, bx) * 2 + 1];
}

static inline int32_t med3(int32_t a, int32_t b, int32_t cc) {
    int32_t mx = a > b ? a : b, mn = a < b ? a : b;
    if (cc > mx) return mx;
    if (cc < mn) return mn;
    return cc;
}

static void pred_mv(const MbGrid *g, int gx, int gy, int pw, int ph, int lx,
                    int ref_idx, int cur_mb, int32_t out[2]) {
    int aa, ab, ac, ra, rb, rc;
    int32_t mva[2], mvb[2], mvc[2];
    blk_info(g, gx - 1, gy, lx, cur_mb, &aa, &ra, mva);
    blk_info(g, gx, gy - 1, lx, cur_mb, &ab, &rb, mvb);
    blk_info(g, gx + pw, gy - 1, lx, cur_mb, &ac, &rc, mvc);
    if (!ac) blk_info(g, gx - 1, gy - 1, lx, cur_mb, &ac, &rc, mvc);
    if (pw == 4 && ph == 2) {
        if ((gy & 3) == 0) {
            if (ab && rb == ref_idx) { out[0] = mvb[0]; out[1] = mvb[1]; return; }
        } else {
            if (aa && ra == ref_idx) { out[0] = mva[0]; out[1] = mva[1]; return; }
        }
    } else if (pw == 2 && ph == 4) {
        if ((gx & 3) == 0) {
            if (aa && ra == ref_idx) { out[0] = mva[0]; out[1] = mva[1]; return; }
        } else {
            if (ac && rc == ref_idx) { out[0] = mvc[0]; out[1] = mvc[1]; return; }
        }
    }
    int ma = aa && ra == ref_idx, mb = ab && rb == ref_idx,
        mc = ac && rc == ref_idx;
    if (ma + mb + mc == 1) {
        if (ma) { out[0] = mva[0]; out[1] = mva[1]; return; }
        if (mb) { out[0] = mvb[0]; out[1] = mvb[1]; return; }
        out[0] = mvc[0]; out[1] = mvc[1]; return;
    }
    if (!ab && !ac && aa) { out[0] = mva[0]; out[1] = mva[1]; return; }
    out[0] = med3(aa ? mva[0] : 0, ab ? mvb[0] : 0, ac ? mvc[0] : 0);
    out[1] = med3(aa ? mva[1] : 0, ab ? mvb[1] : 0, ac ? mvc[1] : 0);
}

static void pred_skip_mv(const MbGrid *g, int gx, int gy, int cur_mb,
                         int32_t out[2]) {
    int aa, ab, ra, rb;
    int32_t mva[2], mvb[2];
    blk_info(g, gx - 1, gy, 0, cur_mb, &aa, &ra, mva);
    blk_info(g, gx, gy - 1, 0, cur_mb, &ab, &rb, mvb);
    out[0] = out[1] = 0;
    if (!aa || !ab) return;
    if ((ra == 0 && mva[0] == 0 && mva[1] == 0) ||
        (rb == 0 && mvb[0] == 0 && mvb[1] == 0)) return;
    pred_mv(g, gx, gy, 4, 4, 0, 0, cur_mb, out);
}

/* The grid writers below read the grid's shape and pointers into locals
 * first: a store through an int32_t or uint8_t pointer may alias fields
 * of *g, which the compiler would otherwise load again after each store
 * (measured: ~5% of a CAVLC P slice's parse).
 *
 * set_partition is inlined at each call, so that the P path's calls take
 * their list as a constant. */
static ALWAYS_INLINE void
set_partition(MbGrid *g, int gx, int gy, int pw, int ph, int lx, int ref_idx,
              int32_t mv0, int32_t mv1) {
    const int w4 = g->w4, h4 = g->h4;
    int32_t *gmv = g->gmv, *gref = g->gref;
    uint8_t *gwritten = g->gwritten, *grefw = g->grefw;
    for (int y = gy; y < gy + ph; y++)
        for (int x = gx; x < gx + pw; x++) {
            int i = GIX(h4, w4, lx, y, x);
            gmv[i * 2] = mv0;
            gmv[i * 2 + 1] = mv1;
            gref[i] = ref_idx;
            gwritten[y * w4 + x] = 1;
            grefw[i] = 1;
        }
}

/* ---------- per-MB grid updates (slice_dec.py) ---------- */
static void mb_common_init(MbGrid *g, int mb) {
    const int mbx = mb % g->mb_w, mby = mb / g->mb_w, w4 = g->w4;
    uint8_t *gwritten = g->gwritten;
    g->slice_id[mb] = g->slice_idx;
    g->disable_deblock[mb] = g->ddb_idc;
    g->alpha_off[mb] = g->a_off;
    g->beta_off[mb] = g->b_off;
    for (int y = mby * 4; y < mby * 4 + 4; y++)
        for (int x = mbx * 4; x < mbx * 4 + 4; x++)
            gwritten[y * w4 + x] = 0;
}

/* an inter MB's MVs, refs, DPB pictures and prediction directions from
 * the grids (list 1 is empty in a P slice: n_l1 = 0) */
static void finish_inter_mb(MbGrid *g, int mb) {
    const int gy = (mb / g->mb_w) * 4, gx = (mb % g->mb_w) * 4;
    const int w4 = g->w4, h4 = g->h4, n_l0 = g->n_l0, n_l1 = g->n_l1;
    const int32_t *gmv = g->gmv, *gref = g->gref;
    const int32_t *l0_pic_ids = g->l0_pic_ids, *l1_pic_ids = g->l1_pic_ids;
    int32_t *mv = g->mv, *ref_pic = g->ref_pic;
    int8_t *refidx = g->refidx, *pred_mode = g->pred_mode;
    for (int lx = 0; lx < 2; lx++)
        for (int j = 0; j < 16; j++) {
            int i = GIX(h4, w4, lx, gy + j / 4, gx + j % 4);
            mv[((mb * 2 + lx) * 16 + j) * 2] = gmv[i * 2];
            mv[((mb * 2 + lx) * 16 + j) * 2 + 1] = gmv[i * 2 + 1];
        }
    for (int q = 0; q < 4; q++) {
        int qy = gy + (q / 2) * 2, qx = gx + (q % 2) * 2;
        int r0 = gref[GIX(h4, w4, 0, qy, qx)];
        int r1 = gref[GIX(h4, w4, 1, qy, qx)];
        int8_t s0 = (int8_t)r0, s1 = (int8_t)r1;
        refidx[(mb * 2 + 0) * 4 + q] = s0;
        refidx[(mb * 2 + 1) * 4 + q] = s1;
        ref_pic[(mb * 2 + 0) * 4 + q] =
            (r0 >= 0 && r0 < n_l0) ? l0_pic_ids[r0] : -1;
        ref_pic[(mb * 2 + 1) * 4 + q] =
            (r1 >= 0 && r1 < n_l1) ? l1_pic_ids[r1] : -1;
        pred_mode[mb * 4 + q] =
            (s0 >= 0 && s1 >= 0) ? 2 : (s1 >= 0 ? 1 : (s0 >= 0 ? 0 : -1));
    }
}

static void mark_intra_grids(MbGrid *g, int mb) {
    const int mbx = mb % g->mb_w, mby = mb / g->mb_w;
    const int w4 = g->w4, h4 = g->h4;
    int32_t *gmv = g->gmv, *gref = g->gref;
    uint8_t *gwritten = g->gwritten;
    for (int lx = 0; lx < 2; lx++)
        for (int y = mby * 4; y < mby * 4 + 4; y++)
            for (int x = mbx * 4; x < mbx * 4 + 4; x++) {
                int i = GIX(h4, w4, lx, y, x);
                gmv[i * 2] = 0;
                gmv[i * 2 + 1] = 0;
                gref[i] = -1;
            }
    for (int y = mby * 4; y < mby * 4 + 4; y++)
        for (int x = mbx * 4; x < mbx * 4 + 4; x++)
            gwritten[y * w4 + x] = 1;
}

#endif
