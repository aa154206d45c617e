/* CABAC residual-block decode (spec 9.3.3.1.3: significance map +
 * last flags + coeff_abs_level/UEG0 + signs), the decoder's hottest
 * bin loop. The arithmetic engine state (pos/range/offset) and the
 * 460-entry context arrays are shared with the Python engine
 * (decoder/cabac.py CabacEngine — bit-for-bit the same §9.3.3.2
 * decisions), so Python and C bins interleave freely within a slice.
 * Parity: cabac_decoder.cpp DecodeBinCabac / ParseResidualBlockCabac
 * (parse_mb_syn_cabac.cpp).
 *
 * Copied from openh264_tpu/native/cabac_residual.c; built on its own by
 * _build.py into libcabac_residual and bound in decoder/cbind.py. */

#include <stdint.h>

typedef struct {
    const uint8_t *data;
    long long nbits, pos;
    long long range, offset;
    int32_t *cstate;            /* [460] */
    int32_t *cmps;              /* [460] */
    const int32_t *range_lps;   /* [64*4] */
    const int32_t *state_trans; /* [64*2] (LPS, MPS) */
} CEng;

static inline int rd_bit(CEng *e) {
    int b = 0;
    if (e->pos < e->nbits)
        b = (e->data[e->pos >> 3] >> (7 - (e->pos & 7))) & 1;
    e->pos++;
    return b;
}

static inline int decision(CEng *e, int idx) {
    int state = e->cstate[idx];
    long long lps = e->range_lps[state * 4 + ((e->range >> 6) & 3)];
    int bit;
    e->range -= lps;
    if (e->offset >= e->range) {
        bit = 1 - e->cmps[idx];
        e->offset -= e->range;
        e->range = lps;
        if (state == 0) e->cmps[idx] ^= 1;
        e->cstate[idx] = e->state_trans[state * 2 + 0];
    } else {
        bit = e->cmps[idx];
        e->cstate[idx] = e->state_trans[state * 2 + 1];
    }
    while (e->range < 256) {
        e->range <<= 1;
        e->offset = (e->offset << 1) | rd_bit(e);
    }
    return bit;
}

static inline int bypass(CEng *e) {
    e->offset = (e->offset << 1) | rd_bit(e);
    if (e->offset >= e->range) {
        e->offset -= e->range;
        return 1;
    }
    return 0;
}

static int exp_bypass(CEng *e, int k) {
    int v = 0, i;
    while (bypass(e)) {
        v += 1 << k;
        k++;
        if (k > 16) return -1;
    }
    for (i = k - 1; i >= 0; i--) v += bypass(e) << i;
    return v;
}

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

/* params: n (coeff count), map_base, last_base, one_base, abs_base,
 *         maxc2, is8x8
 * st (in/out): pos, range, offset  (long long[3])
 * returns ncoef (>=0) or -1 on runaway exp-golomb. */
int cabac_residual(const uint8_t *data, long long nbits, long long *st,
                   int32_t *cstate, int32_t *cmps,
                   const int32_t *range_lps, const int32_t *state_trans,
                   const int32_t *params, int32_t *sig_out) {
    CEng e = {data, nbits, st[0], st[1], st[2],
              cstate, cmps, range_lps, state_trans};
    int n = params[0], map_base = params[1], last_base = params[2];
    int one_base = params[3], abs_base = params[4];
    int maxc2 = params[5], is8 = params[6];
    int i, ncoef = 0, ended = 0;
    for (i = 0; i < n; i++) sig_out[i] = 0;
    for (i = 0; i < n - 1; i++) {
        int ictx = is8 ? SIG8[i] : i;
        if (decision(&e, map_base + ictx)) {
            sig_out[i] = 1;
            ncoef++;
            int lctx = is8 ? LAST8[i] : i;
            if (decision(&e, last_base + lctx)) {
                ended = 1;
                break;
            }
        }
    }
    if (!ended) {
        sig_out[n - 1] = 1;
        ncoef++;
    }
    int c1 = 1, c2 = 0;
    for (i = n - 1; i >= 0; i--) {
        if (!sig_out[i]) continue;
        int v = 1 + decision(&e, one_base + c1);
        if (v == 2) {
            /* UEG0 continuation of coeff_abs_level_minus1 */
            if (decision(&e, abs_base + c2)) {
                int add = 0, cnt = 1, bit;
                for (;;) {
                    bit = decision(&e, abs_base + c2);
                    add += 1;
                    cnt += 1;
                    if (bit == 0 || cnt == 13) break;
                }
                if (bit != 0) {
                    int g = exp_bypass(&e, 0);
                    if (g < 0) return -1;
                    add += g + 1;
                }
                v += add;
            }
            c2 = c2 + 1 > maxc2 ? maxc2 : c2 + 1;
            c1 = 0;
        } else if (c1) {
            c1 = c1 + 1 > 4 ? 4 : c1 + 1;
        }
        if (bypass(&e)) v = -v;
        sig_out[i] = v;
    }
    st[0] = e.pos;
    st[1] = e.range;
    st[2] = e.offset;
    return ncoef;
}
