/* Host C of the port's host encoder and decoder: the I-frame intra mode
 * decision and encode (I16x16 vs I4x4 per MB), the MSB-first token bit
 * packer, and the decoder's intra reconstruction.
 *
 * Copied from the JAX package's host C, which is host code there too:
 *  - bitpack: openh264_tpu/native/codec_native.c;
 *  - pred4 (4x4 luma intra predictors) and clip255:
 *    openh264_tpu/native/recon_intra.c, made static here and shared by
 *    the encoder's I4x4 and the decoder's intra recon;
 *  - enc_intra_frame and its helpers: openh264_tpu/native/enc_intra.c;
 *  - recon_intra_mbs and idct4_add: openh264_tpu/native/recon_intra.c
 *    (its note is at recon_intra_mbs below).
 * Built with the host compiler by openh264_tpu_torch/_build.py and bound
 * with ctypes by openh264_tpu_torch/encoder/cbind.py (the encoder's) and
 * decoder/cbind.py (recon_intra_mbs). Nothing here runs on the card.
 *
 * The original enc_intra.c note follows.
 *
 * I-frame intra mode decision + encode (I16x16 vs I4x4), sequential C.
 *
 * The I4x4 search is inherently a 4x4-granular recon wavefront (each
 * block predicts from its causal neighbors' reconstruction) — ~680
 * serialized steps at 720p, a poor fit for the TPU's wide vector
 * units, so the host runs it natively while P frames stay on device.
 *
 * Parity anchors: WelsMdI16x16 (svc_base_layer_md.cpp:365), WelsMdI4x4
 * (:418) incl. the per-block lambda[pred==mode] mode-bit cost and the
 * running early-exit against the I16 cost, the +24*lambda JVT SATD0
 * offset (:546), WelsMdIntraChroma, and the spec 8.3.1 prediction
 * rules shared with the decoder twin (recon_intra.c pred4 — the SAME
 * function reconstructs here and in the decoder, so encoder recon is
 * bit-exact with decode by construction).
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

/* ---------------- bit packing ---------------- */

/* Append n (val,len) tokens MSB-first into out (must be zeroed),
 * starting at start_bit. Returns the new bit position. */
size_t bitpack(const uint32_t *vals, const uint8_t *lens, size_t n,
               uint8_t *out, size_t start_bit) {
    size_t bytepos = start_bit >> 3;
    int accbits = (int)(start_bit & 7);
    uint64_t acc = accbits ? (out[bytepos] >> (8 - accbits)) : 0;
    for (size_t i = 0; i < n; i++) {
        int len = lens[i];
        if (!len) continue;
        acc = (acc << len) | (vals[i] & ((len >= 32) ? 0xFFFFFFFFu
                                                     : ((1u << len) - 1)));
        accbits += len;
        while (accbits >= 8) {
            accbits -= 8;
            out[bytepos++] = (uint8_t)(acc >> accbits);
        }
    }
    if (accbits)
        out[bytepos] = (uint8_t)(acc << (8 - accbits));
    return (bytepos << 3) + (size_t)accbits;
}

/* ---------------- 4x4 luma predictors (oracle/intra.py predict_4x4) */

static inline int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

static void pred4(int mode, const int32_t t[8], const int32_t l[4],
                         int tl, int at, int al, uint8_t out[16]) {
    int32_t p[16];
#define LREF(i) ((i) < 0 ? tl : l[i])
#define TREF(i) ((i) < 0 ? tl : t[i])
    switch (mode) {
    case 2: {   /* DC */
        int dc;
        if (at && al) dc = (t[0] + t[1] + t[2] + t[3]
                            + l[0] + l[1] + l[2] + l[3] + 4) >> 3;
        else if (al) dc = (l[0] + l[1] + l[2] + l[3] + 2) >> 2;
        else if (at) dc = (t[0] + t[1] + t[2] + t[3] + 2) >> 2;
        else dc = 128;
        for (int i = 0; i < 16; i++) p[i] = dc;
        break;
    }
    case 0:     /* V */
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) p[y * 4 + x] = t[x];
        break;
    case 1:     /* H */
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) p[y * 4 + x] = l[y];
        break;
    case 3:     /* DDL */
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++)
                p[y * 4 + x] = (x == 3 && y == 3)
                    ? (t[6] + 3 * t[7] + 2) >> 2
                    : (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2;
        break;
    case 4: {   /* DDR: filtered diagonal line */
        int32_t ref[9] = {l[3], l[2], l[1], l[0], tl, t[0], t[1], t[2],
                          t[3]};
        int32_t f[7];
        for (int i = 0; i < 7; i++)
            f[i] = (ref[i] + 2 * ref[i + 1] + ref[i + 2] + 2) >> 2;
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) p[y * 4 + x] = f[3 + x - y];
        break;
    }
    case 5:     /* VR */
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                int z = 2 * x - y, i = x - (y >> 1);
                if (z >= 0 && (z & 1) == 0)
                    p[y * 4 + x] = (TREF(i - 1) + TREF(i) + 1) >> 1;
                else if (z >= 0)
                    p[y * 4 + x] =
                        (TREF(i - 2) + 2 * TREF(i - 1) + TREF(i) + 2) >> 2;
                else if (z == -1)
                    p[y * 4 + x] = (l[0] + 2 * tl + t[0] + 2) >> 2;
                else
                    p[y * 4 + x] = (l[y - 2 * x - 1] + 2 * l[y - 2 * x - 2]
                                    + LREF(y - 2 * x - 3) + 2) >> 2;
            }
        break;
    case 6:     /* HD */
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                int z = 2 * y - x, i = y - (x >> 1);
                if (z >= 0 && (z & 1) == 0)
                    p[y * 4 + x] = (LREF(i - 1) + LREF(i) + 1) >> 1;
                else if (z >= 0)
                    p[y * 4 + x] =
                        (LREF(i - 2) + 2 * LREF(i - 1) + LREF(i) + 2) >> 2;
                else if (z == -1)
                    p[y * 4 + x] = (l[0] + 2 * tl + t[0] + 2) >> 2;
                else
                    p[y * 4 + x] = (t[x - 2 * y - 1] + 2 * t[x - 2 * y - 2]
                                    + TREF(x - 2 * y - 3) + 2) >> 2;
            }
        break;
    case 7:     /* VL */
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                int i = x + (y >> 1);
                p[y * 4 + x] = (y & 1)
                    ? (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
                    : (t[i] + t[i + 1] + 1) >> 1;
            }
        break;
    case 8:     /* HU */
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                int z = x + 2 * y, i = y + (x >> 1);
                if (z < 5 && (z & 1) == 0)
                    p[y * 4 + x] = (l[i] + l[i + 1] + 1) >> 1;
                else if (z < 5)
                    p[y * 4 + x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2;
                else if (z == 5)
                    p[y * 4 + x] = (l[2] + 3 * l[3] + 2) >> 2;
                else
                    p[y * 4 + x] = l[3];
            }
        break;
    default:
        for (int i = 0; i < 16; i++) p[i] = 128;
    }
#undef LREF
#undef TREF
    for (int i = 0; i < 16; i++) out[i] = (uint8_t)clip255(p[i]);
}

/* ---------------- I-frame mode decision + encode ---------------- */

static inline int clip255i(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

/* z-scan <-> raster order of 4x4 blocks inside an MB */
static const int ZS2Re[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13,
                              10, 11, 14, 15};

static int ue_len(int v) {
    int n = 0;
    v += 1;
    while (v >> (n + 1)) n++;
    return 2 * n + 1;
}

/* ---- 4x4 transforms (twins of ops/transform.py, bit-exact) ---- */
static void dct4(const int32_t in[16], int32_t out[16]) {
    int32_t t[16];
    for (int i = 0; i < 4; i++) {       /* CF @ x */
        const int32_t *c = in + i;      /* column i */
        t[0 * 4 + i] = c[0] + c[4] + c[8] + c[12];
        t[1 * 4 + i] = 2 * c[0] + c[4] - c[8] - 2 * c[12];
        t[2 * 4 + i] = c[0] - c[4] - c[8] + c[12];
        t[3 * 4 + i] = c[0] - 2 * c[4] + 2 * c[8] - c[12];
    }
    for (int i = 0; i < 4; i++) {       /* (..) @ CF^T */
        const int32_t *r = t + i * 4;
        out[i * 4 + 0] = r[0] + r[1] + r[2] + r[3];
        out[i * 4 + 1] = 2 * r[0] + r[1] - r[2] - 2 * r[3];
        out[i * 4 + 2] = r[0] - r[1] - r[2] + r[3];
        out[i * 4 + 3] = r[0] - 2 * r[1] + 2 * r[2] - r[3];
    }
}

static void hadamard4(const int32_t in[16], int32_t out[16]) {
    int32_t t[16];
    for (int i = 0; i < 4; i++) {
        const int32_t *c = in + i;
        t[0 * 4 + i] = c[0] + c[4] + c[8] + c[12];
        t[1 * 4 + i] = c[0] + c[4] - c[8] - c[12];
        t[2 * 4 + i] = c[0] - c[4] - c[8] + c[12];
        t[3 * 4 + i] = c[0] - c[4] + c[8] - c[12];
    }
    for (int i = 0; i < 4; i++) {
        const int32_t *r = t + i * 4;
        out[i * 4 + 0] = (r[0] + r[1] + r[2] + r[3] + 1) >> 1;
        out[i * 4 + 1] = (r[0] + r[1] - r[2] - r[3] + 1) >> 1;
        out[i * 4 + 2] = (r[0] - r[1] - r[2] + r[3] + 1) >> 1;
        out[i * 4 + 3] = (r[0] - r[1] + r[2] - r[3] + 1) >> 1;
    }
}

static inline int32_t wrap16(int64_t x) {
    return (int32_t)(((x + 0x8000LL) & 0xFFFFLL) - 0x8000LL);
}

static void quant4(const int32_t c[16], const int32_t *mf, int64_t f,
                   int shift, int32_t out[16]) {
    for (int i = 0; i < 16; i++) {
        int64_t a = c[i] < 0 ? -(int64_t)c[i] : (int64_t)c[i];
        int64_t lev = (a * mf[i] + f) >> shift;
        out[i] = (int32_t)(c[i] < 0 ? -lev : lev);
    }
}

/* satd of a 4x4 difference (WelsSampleSatd4x4_c) */
static int satd4(const uint8_t *src, int sstride, const uint8_t *pred,
                 int pstride) {
    int32_t d[16], h[16];
    for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++)
            d[y * 4 + x] = (int32_t)src[y * sstride + x]
                           - (int32_t)pred[y * pstride + x];
    /* plain (unshifted) hadamard, then (sum+1)>>1 */
    int32_t t[16];
    for (int i = 0; i < 4; i++) {
        const int32_t *c = d + i;
        t[0 * 4 + i] = c[0] + c[4] + c[8] + c[12];
        t[1 * 4 + i] = c[0] + c[4] - c[8] - c[12];
        t[2 * 4 + i] = c[0] - c[4] - c[8] + c[12];
        t[3 * 4 + i] = c[0] - c[4] + c[8] - c[12];
    }
    for (int i = 0; i < 4; i++) {
        const int32_t *r = t + i * 4;
        h[i * 4 + 0] = r[0] + r[1] + r[2] + r[3];
        h[i * 4 + 1] = r[0] + r[1] - r[2] - r[3];
        h[i * 4 + 2] = r[0] - r[1] - r[2] + r[3];
        h[i * 4 + 3] = r[0] - r[1] + r[2] - r[3];
    }
    int s = 0;
    for (int i = 0; i < 16; i++) s += h[i] < 0 ? -h[i] : h[i];
    return (s + 1) >> 1;
}

static int satd_nxn(const uint8_t *src, int sstride, const uint8_t *pred,
                    int pstride, int n) {
    int s = 0;
    for (int y = 0; y < n; y += 4)
        for (int x = 0; x < n; x += 4)
            s += satd4(src + y * sstride + x, sstride,
                       pred + y * pstride + x, pstride);
    return s;
}

/* idct + add on recon plane (residual from dequantized coeffs) */
static void idct_add_plane(const int32_t coef[16], uint8_t *rec,
                           int rstride, const uint8_t *pred, int pstride) {
    int64_t h[16];
    int32_t r[16];
    for (int i = 0; i < 4; i++) {       /* rows */
        const int32_t *c = coef + i * 4;
        int64_t t0 = c[0] + c[2], t1 = c[0] - c[2];
        int64_t t2 = (c[1] >> 1) - c[3], t3 = c[1] + (c[3] >> 1);
        h[i * 4 + 0] = wrap16(t0 + t3);
        h[i * 4 + 1] = wrap16(t1 + t2);
        h[i * 4 + 2] = wrap16(t1 - t2);
        h[i * 4 + 3] = wrap16(t0 - t3);
    }
    for (int i = 0; i < 4; i++) {       /* cols */
        int64_t c0 = h[0 * 4 + i], c1 = h[1 * 4 + i],
                c2 = h[2 * 4 + i], c3 = h[3 * 4 + i];
        int64_t t0 = c0 + c2, t1 = c0 - c2;
        int64_t t2 = ((int32_t)c1 >> 1) - c3, t3 = c1 + ((int32_t)c3 >> 1);
        r[0 * 4 + i] = (int32_t)(t0 + t3);
        r[1 * 4 + i] = (int32_t)(t1 + t2);
        r[2 * 4 + i] = (int32_t)(t1 - t2);
        r[3 * 4 + i] = (int32_t)(t0 - t3);
    }
    for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++)
            rec[y * rstride + x] = (uint8_t)clip255i(
                pred[y * pstride + x] + ((r[y * 4 + x] + 32) >> 6));
}

static void pred16(int mode, const uint8_t *Y, int W, int x0, int y0,
                   int at, int al, int atl, uint8_t pred[256]) {
    int32_t top[16], left[16];
    int tl = atl ? Y[(y0 - 1) * W + x0 - 1] : 0;
    for (int x = 0; x < 16; x++)
        top[x] = at ? Y[(y0 - 1) * W + x0 + x] : 0;
    for (int y = 0; y < 16; y++)
        left[y] = al ? Y[(y0 + y) * W + x0 - 1] : 0;
    if (mode == 2) {
        int dc;
        long ts = 0, ls = 0;
        for (int x = 0; x < 16; x++) { ts += top[x]; ls += left[x]; }
        if (at && al) dc = (int)((ts + ls + 16) >> 5);
        else if (al) dc = (int)((ls + 8) >> 4);
        else if (at) dc = (int)((ts + 8) >> 4);
        else dc = 128;
        memset(pred, dc, 256);
    } else if (mode == 0) {
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++)
                pred[y * 16 + x] = (uint8_t)clip255i(top[x]);
    } else if (mode == 1) {
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++)
                pred[y * 16 + x] = (uint8_t)clip255i(left[y]);
    } else {
        long h = 0, v = 0;
        for (int x = 0; x < 8; x++)
            h += (x + 1) * (top[8 + x] - (6 - x >= 0 ? top[6 - x] : tl));
        for (int y = 0; y < 8; y++)
            v += (y + 1) * (left[8 + y] - (6 - y >= 0 ? left[6 - y] : tl));
        long a = 16 * (left[15] + top[15]);
        long b = (5 * h + 32) >> 6;
        long cc = (5 * v + 32) >> 6;
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++)
                pred[y * 16 + x] = (uint8_t)clip255i(
                    (int)((a + b * (x - 7) + cc * (y - 7) + 16) >> 5));
    }
}

/* chroma pred, 8x8, modes 0=DC 1=H 2=V 3=plane (decoder numbering) */
static void predc8(int mode, const uint8_t *P, int CW, int x0, int y0,
                   int at, int al, int atl, uint8_t pred[64]) {
    int32_t top[8], left[8];
    int tl = atl ? P[(y0 - 1) * CW + x0 - 1] : 0;
    for (int x = 0; x < 8; x++)
        top[x] = at ? P[(y0 - 1) * CW + x0 + x] : 0;
    for (int y = 0; y < 8; y++)
        left[y] = al ? P[(y0 + y) * CW + x0 - 1] : 0;
    if (mode == 0) {            /* DC per 4x4 quadrant */
        for (int qy = 0; qy < 2; qy++)
            for (int qx = 0; qx < 2; qx++) {
                long s = 0;
                int dc;
                /* spec 8.3.4.1: corner quadrants use both; (1,0)
                 * prefers top, (0,1) prefers left, with fallbacks */
                if (qx == 0 && qy == 0) {
                    if (at && al) {
                        for (int i = 0; i < 4; i++)
                            s += top[i] + left[i];
                        dc = (int)((s + 4) >> 3);
                    } else if (al) {
                        for (int i = 0; i < 4; i++) s += left[i];
                        dc = (int)((s + 2) >> 2);
                    } else if (at) {
                        for (int i = 0; i < 4; i++) s += top[i];
                        dc = (int)((s + 2) >> 2);
                    } else dc = 128;
                } else if (qx == 1 && qy == 0) {
                    if (at) {
                        for (int i = 4; i < 8; i++) s += top[i];
                        dc = (int)((s + 2) >> 2);
                    } else if (al) {
                        for (int i = 0; i < 4; i++) s += left[i];
                        dc = (int)((s + 2) >> 2);
                    } else dc = 128;
                } else if (qx == 0 && qy == 1) {
                    if (al) {
                        for (int i = 4; i < 8; i++) s += left[i];
                        dc = (int)((s + 2) >> 2);
                    } else if (at) {
                        for (int i = 0; i < 4; i++) s += top[i];
                        dc = (int)((s + 2) >> 2);
                    } else dc = 128;
                } else {
                    if (at && al) {
                        for (int i = 4; i < 8; i++) s += top[i] + left[i];
                        dc = (int)((s + 4) >> 3);
                    } else if (al) {
                        for (int i = 4; i < 8; i++) s += left[i];
                        dc = (int)((s + 2) >> 2);
                    } else if (at) {
                        for (int i = 4; i < 8; i++) s += top[i];
                        dc = (int)((s + 2) >> 2);
                    } else dc = 128;
                }
                for (int y = 0; y < 4; y++)
                    for (int x = 0; x < 4; x++)
                        pred[(qy * 4 + y) * 8 + qx * 4 + x] = (uint8_t)dc;
            }
    } else if (mode == 1) {
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++)
                pred[y * 8 + x] = (uint8_t)clip255i(left[y]);
    } else if (mode == 2) {
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++)
                pred[y * 8 + x] = (uint8_t)clip255i(top[x]);
    } else {
        long h = 0, v = 0;
        for (int x = 0; x < 4; x++)
            h += (x + 1) * (top[4 + x] - (2 - x >= 0 ? top[2 - x] : tl));
        for (int y = 0; y < 4; y++)
            v += (y + 1) * (left[4 + y] - (2 - y >= 0 ? left[2 - y] : tl));
        long a = 16 * (left[7] + top[7]);
        long b = (17 * h + 16) >> 5;
        long cc = (17 * v + 16) >> 5;
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++)
                pred[y * 8 + x] = (uint8_t)clip255i(
                    (int)((a + b * (x - 3) + cc * (y - 3) + 16) >> 5));
    }
}

/* ptrs (in): y, u, v, qmf(52*16), dq(52*16)
 * ptrs (out): kind(N), i16_mode(N), i4_modes(N*16 raster),
 *   i4_prev(N*16 zscan), i4_rem(N*16 zscan), cmode(N), luma_dc(N*16),
 *   luma_ac(N*16*16), chroma_dc(N*2*4), chroma_ac(N*2*4*16),
 *   recon y, u, v (in-out: pre-filled with source, overwritten)
 * params: mb_w, mb_h, qp, qp_c, lambda, enable_i4 */
void enc_intra_frame(const void **ptrs, const int32_t *params) {
    int i = 0;
    const uint8_t *SY = (const uint8_t *)ptrs[i++];
    const uint8_t *SU = (const uint8_t *)ptrs[i++];
    const uint8_t *SV = (const uint8_t *)ptrs[i++];
    const int32_t *QMF = (const int32_t *)ptrs[i++];
    const int32_t *DQT = (const int32_t *)ptrs[i++];
    int32_t *kind = (int32_t *)ptrs[i++];
    int32_t *i16m = (int32_t *)ptrs[i++];
    int32_t *i4m = (int32_t *)ptrs[i++];
    int32_t *i4prev = (int32_t *)ptrs[i++];
    int32_t *i4rem = (int32_t *)ptrs[i++];
    int32_t *cmode = (int32_t *)ptrs[i++];
    int32_t *ldc = (int32_t *)ptrs[i++];
    int32_t *lac = (int32_t *)ptrs[i++];
    int32_t *cdc = (int32_t *)ptrs[i++];
    int32_t *cac = (int32_t *)ptrs[i++];
    uint8_t *Y = (uint8_t *)ptrs[i++];
    uint8_t *U = (uint8_t *)ptrs[i++];
    uint8_t *V = (uint8_t *)ptrs[i++];
    int mb_w = params[0], mb_h = params[1];
    int qp = params[2], qp_c = params[3];
    int lam = params[4], enable_i4 = params[5];
    int W = mb_w * 16, CW = mb_w * 8;
    int n_mb = mb_w * mb_h;

    const int32_t *mf = QMF + qp * 16;
    const int32_t *dq = DQT + qp * 16;
    const int32_t *mfc = QMF + qp_c * 16;
    const int32_t *dqc = DQT + qp_c * 16;
    int qbits = 15 + qp / 6;
    int64_t f_i = (1LL << qbits) / 3;            /* intra deadzone */
    int qbits_c = 15 + qp_c / 6;
    int64_t f_ic = (1LL << qbits_c) / 3;

    /* per-4x4 I4 mode grid for MPM (non-I4 intra neighbors count as
     * DC=2, unavailable as -1; spec 8.3.1.1). Heap-allocated per call:
     * concurrent sessions (simulcast / GOP parallel) may encode
     * intra frames simultaneously. */
    int8_t *mg = (int8_t *)malloc((size_t)(mb_h * 4) * (mb_w * 4));
    if (!mg) return;
    memset(mg, -1, (size_t)(mb_h * 4) * (mb_w * 4));
    int G4 = mb_w * 4;

    for (int idx = 0; idx < n_mb; idx++) {
        int mbx = idx % mb_w, mby = idx / mb_w;
        int x0 = mbx * 16, y0 = mby * 16;
        int cx0 = mbx * 8, cy0 = mby * 8;
        int al = mbx > 0, at = mby > 0, atl = al && at,
            atr = at && (mbx + 1 < mb_w);

        /* ---------- I16x16 mode decision ---------- */
        uint8_t p16[4][256];
        int best16 = -1, cost16 = 1 << 30;
        for (int m = 0; m < 4; m++) {
            if (m == 0 && !at) continue;
            if (m == 1 && !al) continue;
            if (m == 3 && !(at && al && atl)) continue;
            pred16(m, Y, W, x0, y0, at, al, atl, p16[m]);
            int c = satd_nxn(SY + y0 * W + x0, W, p16[m], 16, 16)
                    + lam * ue_len(m);
            if (c < cost16) { cost16 = c; best16 = m; }
        }

        /* ---------- I4x4 mode decision + trial encode ---------- */
        int use_i4 = 0;
        int32_t lac4[16][16];
        int32_t modes4[16], prev4[16], rem4[16];
        if (enable_i4) {
            /* work on a scratch copy of the MB recon region */
            uint8_t save[16][16];
            for (int r = 0; r < 16; r++)
                memcpy(save[r], Y + (y0 + r) * W + x0, 16);
            int cost4 = 0;
            int ok = 1;
            for (int kz = 0; kz < 16 && ok; kz++) {
                int raster = ZS2Re[kz];
                int bx = raster % 4, by = raster / 4;
                int gx = x0 + bx * 4, gy = y0 + by * 4;
                int b_al = (bx > 0) || al;
                int b_at = (by > 0) || at;
                int b_atl = (bx > 0 && by > 0) || (bx > 0 && at)
                            || (by > 0 && al) || atl;
                int b_atr;
                if (by == 0) b_atr = (bx < 3) ? at : atr;
                else if (bx == 3) b_atr = 0;
                else {
                    /* in-MB: above-right block decoded earlier in zscan */
                    int zz = 0;
                    for (int q = 0; q < 16; q++)
                        if (ZS2Re[q] == (by - 1) * 4 + (bx + 1)) zz = q;
                    b_atr = zz < kz;
                }
                int32_t tb[8], lb[4];
                int tl = b_atl ? Y[(gy - 1) * W + gx - 1] : 0;
                if (b_at) {
                    for (int x = 0; x < 8; x++) {
                        int px = gx + x;
                        tb[x] = Y[(gy - 1) * W + (px < W ? px : W - 1)];
                    }
                    if (!b_atr)
                        for (int x = 4; x < 8; x++) tb[x] = tb[3];
                } else memset(tb, 0, sizeof(tb));
                if (b_al)
                    for (int yy = 0; yy < 4; yy++)
                        lb[yy] = Y[(gy + yy) * W + gx - 1];
                else memset(lb, 0, sizeof(lb));

                /* most probable mode (spec 8.3.1.1) */
                int ga = (gx / 4) - 1, gb = (gy / 4) - 1;
                int ma = b_al ? mg[(gy / 4) * G4 + ga] : -1;
                int mb2 = b_at ? mg[gb * G4 + gx / 4] : -1;
                int mpm = (ma < 0 || mb2 < 0) ? 2 : (ma < mb2 ? ma : mb2);

                int bestm = -1, bestc = 1 << 30;
                uint8_t bp[16], cp[16];
                for (int m = 0; m < 9; m++) {
                    if ((m == 0 || m == 3 || m == 7) && !b_at) continue;
                    if ((m == 1 || m == 8) && !b_al) continue;
                    if ((m == 4 || m == 5 || m == 6)
                        && !(b_at && b_al && b_atl)) continue;
                    pred4(m, tb, lb, tl, b_at, b_al, cp);
                    int c = satd4(SY + gy * W + gx, W, cp, 4)
                            + (m == mpm ? lam : 4 * lam);
                    if (c < bestc) {
                        bestc = c;
                        bestm = m;
                        memcpy(bp, cp, 16);
                    }
                }
                cost4 += bestc;
                if (cost4 >= cost16) { ok = 0; break; }
                modes4[raster] = bestm;
                prev4[kz] = bestm == mpm;
                rem4[kz] = bestm == mpm ? 0
                           : (bestm < mpm ? bestm : bestm - 1);
                mg[(gy / 4) * G4 + gx / 4] = (int8_t)bestm;

                /* encode the block: residual DCT -> Q -> IQ -> recon */
                int32_t res[16], cf[16], lev[16], deq[16];
                for (int yy = 0; yy < 4; yy++)
                    for (int xx = 0; xx < 4; xx++)
                        res[yy * 4 + xx] =
                            (int32_t)SY[(gy + yy) * W + gx + xx]
                            - (int32_t)bp[yy * 4 + xx];
                dct4(res, cf);
                quant4(cf, mf, f_i, qbits, lev);
                memcpy(lac4[raster], lev, sizeof(lev));
                for (int q = 0; q < 16; q++) deq[q] = lev[q] * dq[q];
                idct_add_plane(deq, Y + gy * W + gx, W, bp, 4);
            }
            if (ok) {
                cost4 += 24 * lam;      /* JVT SATD0 offset */
                if (cost4 < cost16) use_i4 = 1;
            }
            if (!use_i4) {
                /* restore recon scribbled by the trial */
                for (int r = 0; r < 16; r++)
                    memcpy(Y + (y0 + r) * W + x0, save[r], 16);
            }
        }

        if (use_i4) {
            kind[idx] = 0;
            i16m[idx] = 0;
            for (int b = 0; b < 16; b++) {
                i4m[idx * 16 + b] = modes4[b];
                i4prev[idx * 16 + b] = prev4[b];
                i4rem[idx * 16 + b] = rem4[b];
                memcpy(lac + ((size_t)idx * 16 + b) * 16, lac4[b],
                       16 * sizeof(int32_t));
            }
            memset(ldc + (size_t)idx * 16, 0, 16 * sizeof(int32_t));
        } else {
            kind[idx] = 1;
            i16m[idx] = best16;
            /* 4x4 cells of an I16 MB predict DC for later I4 neighbors */
            for (int by = 0; by < 4; by++)
                for (int bx = 0; bx < 4; bx++)
                    mg[(mby * 4 + by) * G4 + mbx * 4 + bx] = 2;
            const uint8_t *pp = p16[best16];
            int32_t dcs[16];
            int32_t ac_deq[16][16];
            for (int b = 0; b < 16; b++) {
                int bx = b % 4, by = b / 4;
                int32_t res[16], cf[16], lev[16];
                for (int yy = 0; yy < 4; yy++)
                    for (int xx = 0; xx < 4; xx++)
                        res[yy * 4 + xx] =
                            (int32_t)SY[(y0 + by * 4 + yy) * W + x0
                                        + bx * 4 + xx]
                            - (int32_t)pp[(by * 4 + yy) * 16 + bx * 4
                                          + xx];
                dct4(res, cf);
                dcs[b] = cf[0];
                quant4(cf, mf, f_i, qbits, lev);
                lev[0] = 0;
                memcpy(lac + ((size_t)idx * 16 + b) * 16, lev,
                       16 * sizeof(int32_t));
                for (int q = 0; q < 16; q++)
                    ac_deq[b][q] = lev[q] * dq[q];
            }
            /* luma DC: hadamard -> quant_dc -> store; recon DC path */
            int32_t hdc[16], dclev[16], mf0[16];
            hadamard4(dcs, hdc);
            for (int q = 0; q < 16; q++) mf0[q] = mf[0];
            quant4(hdc, mf0, 2 * f_i, qbits + 1, dclev);
            memcpy(ldc + (size_t)idx * 16, dclev, 16 * sizeof(int32_t));
            /* inverse: ihadamard(dclev) * (dq[0]<<4) >>6, wrap16 */
            int32_t ih[16], t[16];
            for (int c2 = 0; c2 < 4; c2++) {
                const int32_t *cl = dclev + c2;
                t[0 * 4 + c2] = cl[0] + cl[4] + cl[8] + cl[12];
                t[1 * 4 + c2] = cl[0] + cl[4] - cl[8] - cl[12];
                t[2 * 4 + c2] = cl[0] - cl[4] - cl[8] + cl[12];
                t[3 * 4 + c2] = cl[0] - cl[4] + cl[8] - cl[12];
            }
            for (int r2 = 0; r2 < 4; r2++) {
                const int32_t *rr = t + r2 * 4;
                ih[r2 * 4 + 0] = rr[0] + rr[1] + rr[2] + rr[3];
                ih[r2 * 4 + 1] = rr[0] + rr[1] - rr[2] - rr[3];
                ih[r2 * 4 + 2] = rr[0] - rr[1] - rr[2] + rr[3];
                ih[r2 * 4 + 3] = rr[0] - rr[1] + rr[2] - rr[3];
            }
            int32_t qmul = dq[0] << 4;
            for (int b = 0; b < 16; b++) {
                int64_t v = ((int64_t)ih[b] * qmul + 32) >> 6;
                ac_deq[b][0] = wrap16(v);
            }
            for (int b = 0; b < 16; b++) {
                int bx = b % 4, by = b / 4;
                idct_add_plane(ac_deq[b],
                               Y + (y0 + by * 4) * W + x0 + bx * 4, W,
                               pp + (by * 4) * 16 + bx * 4, 16);
            }
        }

        /* ---------- chroma MD + encode (shared by both kinds) ------- */
        uint8_t pu[4][64], pv[4][64];
        int bestc = 0, costc = 1 << 30;
        for (int m = 0; m < 4; m++) {
            if (m == 1 && !al) continue;
            if (m == 2 && !at) continue;
            if (m == 3 && !(at && al && atl)) continue;
            predc8(m, U, CW, cx0, cy0, at, al, atl, pu[m]);
            predc8(m, V, CW, cx0, cy0, at, al, atl, pv[m]);
            int c = satd_nxn(SU + cy0 * CW + cx0, CW, pu[m], 8, 8)
                    + satd_nxn(SV + cy0 * CW + cx0, CW, pv[m], 8, 8)
                    + lam * ue_len(m);
            if (c < costc) { costc = c; bestc = m; }
        }
        cmode[idx] = bestc;
        for (int comp = 0; comp < 2; comp++) {
            const uint8_t *SC = comp ? SV : SU;
            uint8_t *RC = comp ? V : U;
            const uint8_t *pc = comp ? pv[bestc] : pu[bestc];
            int32_t dc2[4], lev2[4], acq[4][16];
            for (int b = 0; b < 4; b++) {
                int bx = b % 2, by = b / 2;
                int32_t res[16], cf[16], lev[16];
                for (int yy = 0; yy < 4; yy++)
                    for (int xx = 0; xx < 4; xx++)
                        res[yy * 4 + xx] =
                            (int32_t)SC[(cy0 + by * 4 + yy) * CW + cx0
                                        + bx * 4 + xx]
                            - (int32_t)pc[(by * 4 + yy) * 8 + bx * 4
                                          + xx];
                dct4(res, cf);
                dc2[b] = cf[0];
                quant4(cf, mfc, f_ic, qbits_c, lev);
                lev[0] = 0;
                memcpy(cac + (((size_t)idx * 2 + comp) * 4 + b) * 16,
                       lev, 16 * sizeof(int32_t));
                for (int q = 0; q < 16; q++)
                    acq[b][q] = lev[q] * dqc[q];
            }
            /* 2x2 hadamard on DC, quant with doubled deadzone */
            int32_t h2[4] = {dc2[0] + dc2[1] + dc2[2] + dc2[3],
                             dc2[0] - dc2[1] + dc2[2] - dc2[3],
                             dc2[0] + dc2[1] - dc2[2] - dc2[3],
                             dc2[0] - dc2[1] - dc2[2] + dc2[3]};
            for (int b = 0; b < 4; b++) {
                int64_t a = h2[b] < 0 ? -(int64_t)h2[b] : (int64_t)h2[b];
                int64_t lv = (a * mfc[0] + 2 * f_ic) >> (qbits_c + 1);
                lev2[b] = (int32_t)(h2[b] < 0 ? -lv : lv);
            }
            memcpy(cdc + ((size_t)idx * 2 + comp) * 4, lev2,
                   4 * sizeof(int32_t));
            /* inverse 2x2: (h @ dc @ h) * dq[0] >> 1, wrap16 */
            int32_t ih2[4] = {lev2[0] + lev2[1] + lev2[2] + lev2[3],
                              lev2[0] - lev2[1] + lev2[2] - lev2[3],
                              lev2[0] + lev2[1] - lev2[2] - lev2[3],
                              lev2[0] - lev2[1] - lev2[2] + lev2[3]};
            for (int b = 0; b < 4; b++)
                acq[b][0] = wrap16(((int64_t)ih2[b] * dqc[0]) >> 1);
            for (int b = 0; b < 4; b++) {
                int bx = b % 2, by = b / 2;
                idct_add_plane(acq[b],
                               RC + (cy0 + by * 4) * CW + cx0 + bx * 4,
                               CW, pc + (by * 4) * 8 + bx * 4, 8);
            }
        }
    }
    free(mg);
}


/* ---------------- decoder intra reconstruction ----------------
 *
 * Native intra reconstruction: predict + IDCT-add for I4x4 / I16x16 /
 * IPCM macroblocks, walking the frame's intra MBs in raster order
 * (inter MBs are reconstructed batched on the device first; intra MBs
 * only ever read raster-earlier neighbors, so this split is exact).
 * Mirrors openh264_tpu/decoder/recon_oracle.py recon_intra_mb and
 * oracle/intra.py (the parity of rec_mb.cpp RecI16x16Mb / RecI4x4Mb /
 * RecChroma and get_intra_predictor.cpp), and I8x8 as
 * oracle/intra8.py predict_8x8 (reference filtering of 8.3.2.2.1, nine
 * modes) and idct8x8_add (int16 intermediates wrap) do.
 */

/* idct4x4_add parity with oracle/transform.py: horizontal pass stored
 * int16 (wraps), vertical accumulates int32, (x+32)>>6, add, clip. */
static void idct4_add(const int32_t *coef, const uint8_t *pred, int pstride,
                      uint8_t *dst, int dstride) {
    int32_t h[16];
    for (int r = 0; r < 4; r++) {
        int32_t c0 = coef[r * 4], c1 = coef[r * 4 + 1],
                c2 = coef[r * 4 + 2], c3 = coef[r * 4 + 3];
        int32_t t0 = c0 + c2, t1 = c0 - c2;
        int32_t t2 = (c1 >> 1) - c3, t3 = c1 + (c3 >> 1);
        h[r * 4 + 0] = (int16_t)(t0 + t3);
        h[r * 4 + 1] = (int16_t)(t1 + t2);
        h[r * 4 + 2] = (int16_t)(t1 - t2);
        h[r * 4 + 3] = (int16_t)(t0 - t3);
    }
    for (int col = 0; col < 4; col++) {
        int32_t h0 = h[col], h1 = h[4 + col], h2 = h[8 + col],
                h3 = h[12 + col];
        int32_t t0 = h0 + h2, t1 = h0 - h2;
        int32_t t2 = (h1 >> 1) - h3, t3 = h1 + (h3 >> 1);
        int32_t r0 = t0 + t3, r1 = t1 + t2, r2 = t1 - t2, r3 = t0 - t3;
        dst[0 * dstride + col] = (uint8_t)clip255(
            pred[0 * pstride + col] + ((r0 + 32) >> 6));
        dst[1 * dstride + col] = (uint8_t)clip255(
            pred[1 * pstride + col] + ((r1 + 32) >> 6));
        dst[2 * dstride + col] = (uint8_t)clip255(
            pred[2 * pstride + col] + ((r2 + 32) >> 6));
        dst[3 * dstride + col] = (uint8_t)clip255(
            pred[3 * pstride + col] + ((r3 + 32) >> 6));
    }
}

static const int ZS2R[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13,
                             10, 11, 14, 15};
static int R2Z[16];

/* oracle/intra8.py wrap16: the int16 value congruent to a */
static inline int64_t w16(int64_t a) {
    return ((a + 0x8000) & 0xFFFF) - 0x8000;
}

/* oracle/intra8.py _idct8_butterfly on one vector, op for op */
static void idct8_1d(const int64_t p[8], int64_t o[8]) {
    int64_t a0 = w16(p[0] + p[4]), a1 = w16(p[0] - p[4]);
    int64_t a2 = w16(p[6] - (p[2] >> 1)), a3 = w16(p[2] + (p[6] >> 1));
    int64_t b0 = w16(a0 + a3), b2 = w16(a1 - a2);
    int64_t b4 = w16(a1 + a2), b6 = w16(a0 - a3);
    a0 = w16(-p[3] + p[5] - p[7] - (p[7] >> 1));
    a1 = w16(p[1] + p[7] - p[3] - (p[3] >> 1));
    a2 = w16(-p[1] + p[7] + p[5] + (p[5] >> 1));
    a3 = w16(p[3] + p[5] + p[1] + (p[1] >> 1));
    int64_t b1 = w16(a0 + (a3 >> 2)), b3 = w16(a1 + (a2 >> 2));
    int64_t b5 = w16(a2 - (a1 >> 2)), b7 = w16(a3 - (a0 >> 2));
    o[0] = w16(b0 + b7); o[1] = w16(b2 - b5); o[2] = w16(b4 + b3);
    o[3] = w16(b6 + b1); o[4] = w16(b6 - b1); o[5] = w16(b4 - b3);
    o[6] = w16(b2 + b5); o[7] = w16(b0 - b7);
}

/* oracle/intra8.py idct8x8_add: rows, then columns, (x+32)>>6, add,
 * clip; coef raster [64] */
static void idct8_add(const int32_t *coef, const uint8_t pred[64],
                      uint8_t *dst, int dstride) {
    int64_t tmp[8][8], col[8], res[8][8];
    for (int r = 0; r < 8; r++) {
        int64_t row[8];
        for (int c = 0; c < 8; c++) row[c] = coef[r * 8 + c];
        idct8_1d(row, tmp[r]);
    }
    for (int c = 0; c < 8; c++) {
        for (int r = 0; r < 8; r++) col[r] = tmp[r][c];
        idct8_1d(col, res[c]);
    }
    for (int r = 0; r < 8; r++)
        for (int c = 0; c < 8; c++)
            dst[r * dstride + c] = (uint8_t)clip255(
                (int)(pred[r * 8 + c] + ((32 + res[c][r]) >> 6)));
}

/* oracle/intra8.py predict_8x8: top[16] raw (8..15 replaced by top[7]
 * where the top-right is missing), left[8], tl; mode 0..8 */
static void pred8(int mode, const int32_t top[16], const int32_t left[8],
                  int tl, int at, int al, int atl, int atr,
                  uint8_t out[64]) {
    int32_t t[16] = {0}, l[8] = {0}, raw[16];
    int q = 0;
    if (at) {
        for (int i = 0; i < 16; i++) raw[i] = (i >= 8 && !atr) ? top[7]
                                                                : top[i];
        t[0] = atl ? (tl + 2 * raw[0] + raw[1] + 2) >> 2
                   : (3 * raw[0] + raw[1] + 2) >> 2;
        for (int i = 1; i < 15; i++)
            t[i] = (raw[i - 1] + 2 * raw[i] + raw[i + 1] + 2) >> 2;
        t[15] = (raw[14] + 3 * raw[15] + 2) >> 2;
    }
    if (al) {
        l[0] = atl ? (tl + 2 * left[0] + left[1] + 2) >> 2
                   : (3 * left[0] + left[1] + 2) >> 2;
        for (int i = 1; i < 7; i++)
            l[i] = (left[i - 1] + 2 * left[i] + left[i + 1] + 2) >> 2;
        l[7] = (left[6] + 3 * left[7] + 2) >> 2;
    }
    if (atl) {
        if (at && al) q = (top[0] + 2 * tl + left[0] + 2) >> 2;
        else if (at) q = (3 * tl + top[0] + 2) >> 2;
        else if (al) q = (3 * tl + left[0] + 2) >> 2;
        else q = tl;
    }
    for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
            int v = 0;
            if (mode == 2) {
                int st = 0, sl = 0;
                for (int i = 0; i < 8; i++) { st += t[i]; sl += l[i]; }
                v = (at && al) ? (st + sl + 8) >> 4
                    : al ? (sl + 4) >> 3 : at ? (st + 4) >> 3 : 128;
            } else if (mode == 0) {
                v = t[x];
            } else if (mode == 1) {
                v = l[y];
            } else if (mode == 3) {
                int k = x + y;
                v = (x == 7 && y == 7) ? (t[14] + 3 * t[15] + 2) >> 2
                    : (t[k] + 2 * t[k + 1] + t[k + 2] + 2) >> 2;
            } else if (mode == 4) {
                /* ref = l[7..0], q, t[0..7]; centre 8 + x - y */
                int ref[17];
                for (int i = 0; i < 8; i++) ref[i] = l[7 - i];
                ref[8] = q;
                for (int i = 0; i < 8; i++) ref[9 + i] = t[i];
                int i = 8 + x - y;
                v = (ref[i - 1] + 2 * ref[i] + ref[i + 1] + 2) >> 2;
            } else if (mode == 5) {
                int z = 2 * x - y, i = x - (y >> 1);
#define TR(j) ((j) < 0 ? q : t[(j)])
                if (z >= 0 && z % 2 == 0) v = (TR(i - 1) + TR(i) + 1) >> 1;
                else if (z >= 0)
                    v = (TR(i - 2) + 2 * TR(i - 1) + TR(i) + 2) >> 2;
                else if (z == -1) v = (l[0] + 2 * q + t[0] + 2) >> 2;
                else {
                    int j = y - 2 * x;
                    v = (l[j - 1] + 2 * l[j - 2]
                         + (j - 3 >= 0 ? l[j - 3] : q) + 2) >> 2;
                }
#undef TR
            } else if (mode == 6) {
                int z = 2 * y - x, i = y - (x >> 1);
#define LR(j) ((j) < 0 ? q : l[(j)])
                if (z >= 0 && z % 2 == 0) v = (LR(i - 1) + LR(i) + 1) >> 1;
                else if (z >= 0)
                    v = (LR(i - 2) + 2 * LR(i - 1) + LR(i) + 2) >> 2;
                else if (z == -1) v = (l[0] + 2 * q + t[0] + 2) >> 2;
                else {
                    int j = x - 2 * y;
                    v = (t[j - 1] + 2 * t[j - 2]
                         + (j - 3 >= 0 ? t[j - 3] : q) + 2) >> 2;
                }
#undef LR
            } else if (mode == 7) {
                int i = x + (y >> 1);
                v = (y % 2 == 0) ? (t[i] + t[i + 1] + 1) >> 1
                    : (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2;
            } else {    /* 8: HU */
                int z = x + 2 * y, i = y + (x >> 1);
                if (z < 13 && z % 2 == 0) v = (l[i] + l[i + 1] + 1) >> 1;
                else if (z < 13)
                    v = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2;
                else if (z == 13) v = (l[6] + 3 * l[7] + 2) >> 2;
                else v = l[7];
            }
            out[y * 8 + x] = (uint8_t)clip255(v);
        }
}

static inline int intra_avail(const int32_t *mb_type,
                              const int32_t *slice_id, int mb_w, int mb_h,
                              int cur, int mbx, int mby, int constrained) {
    if (mbx < 0 || mby < 0 || mbx >= mb_w || mby >= mb_h) return 0;
    int idx = mby * mb_w + mbx;
    if (slice_id[idx] != slice_id[cur]) return 0;
    if (constrained) {
        int t = mb_type[idx];
        if (!(t >= 0 && t <= 3)) return 0;
    }
    return 1;
}

/* ptrs: y,u,v, mb_type, slice_id, i16_mode, i4_modes, chroma_mode,
 *       coeffs_l, coeffs_c, ipcm_buf, ipcm_flag, mb_list, coeffs8
 *       ([n_mb][4][64], read for I8x8 MBs only)
 * params: mb_w, mb_h, n_list, constrained */
void recon_intra_mbs(const void **ptrs, const int32_t *params) {
    int i = 0;
    uint8_t *Y = (uint8_t *)ptrs[i++];
    uint8_t *U = (uint8_t *)ptrs[i++];
    uint8_t *V = (uint8_t *)ptrs[i++];
    const int32_t *mb_type = (const int32_t *)ptrs[i++];
    const int32_t *slice_id = (const int32_t *)ptrs[i++];
    const int32_t *i16_mode = (const int32_t *)ptrs[i++];
    const int32_t *i4_modes = (const int32_t *)ptrs[i++];
    const int32_t *chroma_mode = (const int32_t *)ptrs[i++];
    const int32_t *coeffs_l = (const int32_t *)ptrs[i++];
    const int32_t *coeffs_c = (const int32_t *)ptrs[i++];
    const uint8_t *ipcm_buf = (const uint8_t *)ptrs[i++];
    const uint8_t *ipcm_flag = (const uint8_t *)ptrs[i++];
    const int32_t *mb_list = (const int32_t *)ptrs[i++];
    const int32_t *coeffs8 = (const int32_t *)ptrs[i++];
    int mb_w = params[0], mb_h = params[1], n_list = params[2],
        constrained = params[3];
    int W = mb_w * 16, CW = mb_w * 8;

    for (int k = 0; k < 16; k++) R2Z[ZS2R[k]] = k;

    for (int li = 0; li < n_list; li++) {
        int idx = mb_list[li];
        int mbx = idx % mb_w, mby = idx / mb_w;
        int x0 = mbx * 16, y0 = mby * 16;
        int cx0 = mbx * 8, cy0 = mby * 8;
        int t = mb_type[idx];

        if (t == 2) {   /* IPCM */
            if (!ipcm_flag[idx]) continue;
            const uint8_t *src = ipcm_buf + (size_t)idx * 384;
            for (int r = 0; r < 16; r++)
                memcpy(Y + (y0 + r) * W + x0, src + r * 16, 16);
            for (int r = 0; r < 8; r++)
                memcpy(U + (cy0 + r) * CW + cx0, src + 256 + r * 8, 8);
            for (int r = 0; r < 8; r++)
                memcpy(V + (cy0 + r) * CW + cx0, src + 320 + r * 8, 8);
            continue;
        }

        int al = intra_avail(mb_type, slice_id, mb_w, mb_h, idx,
                             mbx - 1, mby, constrained);
        int at = intra_avail(mb_type, slice_id, mb_w, mb_h, idx,
                             mbx, mby - 1, constrained);
        int atl = intra_avail(mb_type, slice_id, mb_w, mb_h, idx,
                              mbx - 1, mby - 1, constrained);
        int atr = intra_avail(mb_type, slice_id, mb_w, mb_h, idx,
                              mbx + 1, mby - 1, constrained);

        if (t == 1) {   /* I16x16 */
            int32_t top[16], left[16];
            int tl = atl ? Y[(y0 - 1) * W + x0 - 1] : 0;
            for (int x = 0; x < 16; x++)
                top[x] = at ? Y[(y0 - 1) * W + x0 + x] : 0;
            for (int y = 0; y < 16; y++)
                left[y] = al ? Y[(y0 + y) * W + x0 - 1] : 0;
            uint8_t pred[256];
            int mode = i16_mode[idx];
            if (mode == 2) {
                int dc;
                long ts = 0, ls = 0;
                for (int x = 0; x < 16; x++) { ts += top[x]; ls += left[x]; }
                if (at && al) dc = (int)((ts + ls + 16) >> 5);
                else if (al) dc = (int)((ls + 8) >> 4);
                else if (at) dc = (int)((ts + 8) >> 4);
                else dc = 128;
                memset(pred, dc, 256);
            } else if (mode == 0) {
                for (int y = 0; y < 16; y++)
                    for (int x = 0; x < 16; x++)
                        pred[y * 16 + x] = (uint8_t)clip255(top[x]);
            } else if (mode == 1) {
                for (int y = 0; y < 16; y++)
                    for (int x = 0; x < 16; x++)
                        pred[y * 16 + x] = (uint8_t)clip255(left[y]);
            } else {    /* plane */
                long h = 0, v = 0;
                for (int x = 0; x < 8; x++)
                    h += (x + 1) * (top[8 + x]
                                    - (6 - x >= 0 ? top[6 - x] : tl));
                for (int y = 0; y < 8; y++)
                    v += (y + 1) * (left[8 + y]
                                    - (6 - y >= 0 ? left[6 - y] : tl));
                long a = 16 * (left[15] + top[15]);
                long b = (5 * h + 32) >> 6;
                long cc = (5 * v + 32) >> 6;
                for (int y = 0; y < 16; y++)
                    for (int x = 0; x < 16; x++)
                        pred[y * 16 + x] = (uint8_t)clip255(
                            (int)((a + b * (x - 7) + cc * (y - 7) + 16)
                                  >> 5));
            }
            for (int blk = 0; blk < 16; blk++) {
                int bx = blk % 4, by = blk / 4;
                idct4_add(coeffs_l + ((size_t)idx * 16 + blk) * 16,
                          pred + (by * 4) * 16 + bx * 4, 16,
                          Y + (y0 + by * 4) * W + x0 + bx * 4, W);
            }
        } else if (t == 0) {   /* I4x4 */
            for (int kz = 0; kz < 16; kz++) {
                int raster = ZS2R[kz];
                int bx = raster % 4, by = raster / 4;
                int gx = x0 + bx * 4, gy = y0 + by * 4;
                int b_al = (bx > 0) || al;
                int b_at = (by > 0) || at;
                int b_atl = (bx > 0 && by > 0) || (bx > 0 && at)
                            || (by > 0 && al) || atl;
                int b_atr;
                if (by == 0) b_atr = (bx < 3) ? at : atr;
                else if (bx == 3) b_atr = 0;
                else b_atr = R2Z[(by - 1) * 4 + (bx + 1)] < kz;
                int32_t tb[8], lb[4];
                int tl = b_atl ? Y[(gy - 1) * W + gx - 1] : 0;
                if (b_at) {
                    for (int x = 0; x < 8; x++) {
                        int px = gx + x;
                        tb[x] = Y[(gy - 1) * W + (px < W ? px : W - 1)];
                    }
                    if (!b_atr)
                        for (int x = 4; x < 8; x++) tb[x] = tb[3];
                } else {
                    memset(tb, 0, sizeof(tb));
                }
                if (b_al)
                    for (int y = 0; y < 4; y++) lb[y] = Y[(gy + y) * W + gx - 1];
                else
                    memset(lb, 0, sizeof(lb));
                uint8_t pred[16];
                pred4(i4_modes[idx * 16 + raster], tb, lb, tl, b_at, b_al,
                      pred);
                idct4_add(coeffs_l + ((size_t)idx * 16 + raster) * 16,
                          pred, 4, Y + gy * W + gx, W);
            }
        } else if (t == 3) {   /* I8x8 */
            for (int b8 = 0; b8 < 4; b8++) {
                int b8x = b8 % 2, b8y = b8 / 2;
                int gx = x0 + b8x * 8, gy = y0 + b8y * 8;
                int b_at = b8y > 0 || at, b_al = b8x > 0 || al;
                int b_atl = b8 == 0 ? atl : b8 == 1 ? at : b8 == 2 ? al : 1;
                int b_atr = b8 == 0 ? at : b8 == 1 ? atr : b8 == 2;
                int32_t top[16] = {0}, left[8] = {0};
                if (b_at)
                    for (int x = 0; x < 16; x++) {
                        int px = gx + x;
                        top[x] = Y[(gy - 1) * W + (px < W ? px : W - 1)];
                    }
                if (b_al)
                    for (int y = 0; y < 8; y++)
                        left[y] = Y[(gy + y) * W + gx - 1];
                int tl = b_atl ? Y[(gy - 1) * W + gx - 1] : 0;
                uint8_t pred[64];
                pred8(i4_modes[idx * 16 + (b8y * 2) * 4 + b8x * 2], top,
                      left, tl, b_at, b_al, b_atl, b_atr, pred);
                idct8_add(coeffs8 + ((size_t)idx * 4 + b8) * 64, pred,
                          Y + gy * W + gx, W);
            }
        }

        /* ---- chroma (I4x4, I8x8, I16x16) ---- */
        if (t == 0 || t == 1 || t == 3) {
            int cmode = chroma_mode[idx];
            for (int comp = 0; comp < 2; comp++) {
                uint8_t *P = comp ? V : U;
                int32_t top[8], left[8];
                int tl = atl ? P[(cy0 - 1) * CW + cx0 - 1] : 0;
                for (int x = 0; x < 8; x++)
                    top[x] = at ? P[(cy0 - 1) * CW + cx0 + x] : 0;
                for (int y = 0; y < 8; y++)
                    left[y] = al ? P[(cy0 + y) * CW + cx0 - 1] : 0;
                uint8_t pred[64];
                if (cmode == 0) {       /* DC per quadrant */
                    for (int qy = 0; qy < 2; qy++)
                        for (int qx = 0; qx < 2; qx++) {
                            int ts = top[qx * 4] + top[qx * 4 + 1]
                                     + top[qx * 4 + 2] + top[qx * 4 + 3];
                            int ls = left[qy * 4] + left[qy * 4 + 1]
                                     + left[qy * 4 + 2] + left[qy * 4 + 3];
                            int dc;
                            if (qx == qy) {
                                if (at && al) dc = (ts + ls + 4) >> 3;
                                else if (at) dc = (ts + 2) >> 2;
                                else if (al) dc = (ls + 2) >> 2;
                                else dc = 128;
                            } else if (qx == 1) {
                                if (at) dc = (ts + 2) >> 2;
                                else if (al) dc = (ls + 2) >> 2;
                                else dc = 128;
                            } else {
                                if (al) dc = (ls + 2) >> 2;
                                else if (at) dc = (ts + 2) >> 2;
                                else dc = 128;
                            }
                            for (int y = 0; y < 4; y++)
                                for (int x = 0; x < 4; x++)
                                    pred[(qy * 4 + y) * 8 + qx * 4 + x] =
                                        (uint8_t)dc;
                        }
                } else if (cmode == 1) {
                    for (int y = 0; y < 8; y++)
                        for (int x = 0; x < 8; x++)
                            pred[y * 8 + x] = (uint8_t)clip255(left[y]);
                } else if (cmode == 2) {
                    for (int y = 0; y < 8; y++)
                        for (int x = 0; x < 8; x++)
                            pred[y * 8 + x] = (uint8_t)clip255(top[x]);
                } else {
                    long h = 0, v = 0;
                    for (int x = 0; x < 4; x++)
                        h += (x + 1) * (2 - x >= 0
                                        ? top[4 + x] - top[2 - x]
                                        : top[4 + x] - tl);
                    for (int y = 0; y < 4; y++)
                        v += (y + 1) * (left[4 + y]
                                        - (2 - y >= 0 ? left[2 - y] : tl));
                    long a = 16 * (left[7] + top[7]);
                    long b = (17 * h + 16) >> 5;
                    long cc = (17 * v + 16) >> 5;
                    for (int y = 0; y < 8; y++)
                        for (int x = 0; x < 8; x++)
                            pred[y * 8 + x] = (uint8_t)clip255(
                                (int)((a + b * (x - 3) + cc * (y - 3) + 16)
                                      >> 5));
                }
                for (int blk = 0; blk < 4; blk++) {
                    int bx = blk % 2, by = blk / 2;
                    idct4_add(coeffs_c + (((size_t)idx * 2 + comp) * 4
                                          + blk) * 16,
                              pred + (by * 4) * 8 + bx * 4, 8,
                              P + (cy0 + by * 4) * CW + cx0 + bx * 4, CW);
                }
            }
        }
    }
}
