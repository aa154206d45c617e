// H.264 in-loop deblocking of one frame (spec 8.7) as one persistent,
// row-pipelined launch, hand-written for Hopper (sm_90a). The encoders
// and the decoder send their frames here.
//
// Replaces the TPU kernel openh264_tpu/encoder/deblock_pallas.py
// (deblock_frame_pallas -> _kernel). It computes exactly what
// openh264_tpu/encoder/deblock_jax.py::deblock_frame_device computes;
// its plain PyTorch twin is openh264_tpu_torch/encoder/deblock_torch.py
// ::deblock_frame_device.
//
// What bounds it on the card: the latency of the dependency chain, not
// bytes or operations. The ~3.3 MB a 720p frame reads and writes move in
// about 1 us at 3.35 TB/s, and a step's arithmetic is a few hundred
// integer operations per pixel line; but MB (x, y) reads pixels last
// written by MBs (x-1, y), (x, y-1) and (x+1, y-1), so a frame is a
// chain of mb_w + 2*(mb_h-1) dependent MB steps (168 at 720p). What the
// kernel can cut is the time of one step.
//
// The design it replaces (first cut): one launch per knight diagonal
// d = x + 2y, 168 launches per 720p frame from one host loop, each step
// a chain of global-memory round trips (byte loads of the region, QP
// loads, a bS load before each of the 8 edge phases, the write-back):
// 1.5129 ms per 720p frame on NVIDIA H100 80GB HBM3, 700.00 W.
//
// Design: one launch per frame. The grid is min(mb_h, SMs) blocks of
// four warps. Each block takes its next MB row from an atomic ticket, in
// row order, and filters the row's MBs left to right. MB row y filters
// MB x only once row y-1 has finished MB x+1 (all of row y-1 when
// x + 1 = mb_w), read from a per-row progress counter.
//
// Why that order is right. MB (x, y) works on the luma region rows
// [16y-4, 16y+16) x columns [16x-4, 16x+16) (chroma: [8y-2, 8y+8) x
// [8x-2, 8x+8)). Its three producers (x-1, y), (x, y-1) and (x+1, y-1)
// have finished before it starts: the first by program order in the
// block, the other two by the counter. While row y filters MB x, row
// y-1 has finished x+1 and so works on MB x+2 or later, whose region
// starts at column 16x+28; row y+1 waits for row y to finish x+1 and so
// works on MB x-2 or earlier, whose region ends before column 16x-16.
// Regions of MBs that run at once are disjoint, as two MBs of one knight
// diagonal are, and the schedule is the diagonal order's critical path
// of mb_w + 2*(mb_h-1) steps with no launch between steps.
// (tests/test_torch_deblock_schedule.py runs the plain version in this
// order and in a too-early one.) A block waits only on a row whose
// ticket was taken before its own, by a block already running, so the
// pipeline cannot deadlock however few blocks are resident, and it
// needs no cooperative launch.
//
// Memory ordering. Publishing MB x: the filter warps store the MB's
// pixels and meet the release warp at a barrier, whose lane 0 then makes
// a release store of x + 1 to the row's counter. Waiting: lane 0 of the
// halo warp spins on acquire loads of row y-1's counter; its warp then
// reads the halo and meets the filter warps at a barrier. Barriers
// carry the other threads' writes into the release, and the acquire
// into the other threads' later loads (in the PTX memory model causality
// order is transitive through bar.sync and bar.warp.sync), so no further
// fence is needed. The halo warp keeps the last count it saw and polls
// only when that count is short. Other blocks write the planes during
// the launch, so the plane pointers are not __restrict__, and pixels are
// read with ld.global.cg (L2, coherent), never through __ldg's
// non-coherent path or L1.
//
// Step latency. One block runs a row, so every latency of an MB step
// shows. Every path through the chain to the last MB at 720p has 123
// steps along a row and 44 hand-offs from row to row, so both count.
// The design keeps global memory, fences and barriers off the step:
// - when a block takes a row it loads the row's bS (BSV and BSH rows
//   4y..4y+3) and the QPs of rows y and y-1 into shared memory, so no
//   edge reads global memory;
// - row y's own 16 luma and 2 x 8 chroma lines of MB x+1 are written by
//   no other MB before row y filters it, so each lane loads its line
//   (16 or 8 bytes) into registers while MB x is filtered;
// - the vertical edges touch only those own lines and the 4 luma / 2
//   chroma columns carried over from MB x-1 in shared memory, so they
//   run while the halo warp waits for row y-1 and loads MB x's halo
//   (double-buffered) into shared memory;
// - the release warp's fence overlaps the next MB's vertical edges;
// - luma and chroma lines run in warps of their own, and a lane filters
//   its line in registers, all edges of a pass in a row, and stores what
//   changed straight to the planes: two barriers per MB.
// The order is the reference's: vertical edges e = 0..3, then
// horizontal e = 0..3, chroma at e in {0, 2}, picture-border bS forced
// to 0. The TPU kernel's plane shear (a lane-alignment workaround) is
// gone: blocks address the plain planes.
//
// Beyond the TPU kernel, which served the encoder's frames only, two
// inputs serve the decoder's (openh264_tpu/oracle/deblock.py:235-263):
// per-MB alpha and beta offsets (the slice's FilterOffsetA/B), added to
// the QP average of an edge of MB q with q's own offsets, and a chroma
// QP per plane (the PPS's two chroma QP offsets). Both are optional: a
// null offset pointer reads as 0, a null Cr QP pointer as the Cb one,
// and the encoders pass nulls, so their frames move the bytes they
// moved before.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// H.264 Table 8-16 (indexA / indexB -> alpha', beta') and Table 8-17
// (indexA, bS -> tc0'); the same values as tables/core.py.
__constant__ int kAlpha[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6,
    7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45,
    50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
__constant__ int kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3,
    3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
    11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
__constant__ int kTc0[52][3] = {
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 1},
    {0, 0, 1}, {0, 0, 1}, {0, 0, 1}, {0, 1, 1}, {0, 1, 1}, {1, 1, 1},
    {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 2}, {1, 1, 2}, {1, 1, 2},
    {1, 1, 2}, {1, 2, 3}, {1, 2, 3}, {2, 2, 3}, {2, 2, 4}, {2, 3, 4},
    {2, 3, 4}, {3, 3, 5}, {3, 4, 6}, {3, 4, 6}, {4, 5, 7}, {4, 5, 8},
    {4, 6, 9}, {5, 7, 10}, {6, 8, 11}, {6, 8, 13}, {7, 10, 14},
    {8, 11, 16}, {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

__device__ __forceinline__ int clip3(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }

// Filter parameters of one edge line: the QP average of the two MBs
// (qa, qb) plus the current MB's alpha (ao) or beta (bo) offset indexes
// the tables; bS <= 0 turns the line off.
struct EdgeParams {
  int bs, alpha, beta, tc0;
};

__device__ __forceinline__ EdgeParams edge_params(int bs, int qa, int qb,
                                                  int ao, int bo) {
  const int qav = (qa + qb + 1) >> 1;
  const int ia = clip3(qav + ao, 0, 51), ib = clip3(qav + bo, 0, 51);
  EdgeParams p;
  p.bs = bs;
  p.alpha = kAlpha[ia];
  p.beta = kBeta[ib];
  p.tc0 = kTc0[ia][clip3(bs - 1, 0, 2)];
  return p;
}

// One luma line across an edge: s[k * step], k = 0..7 holds p3..q3;
// p2..q2 are rewritten (deblock_jax._luma_edge).
__device__ __forceinline__ void luma_line(int* s, int step, EdgeParams e) {
  const int p3 = s[0], p2 = s[step], p1 = s[2 * step], p0 = s[3 * step];
  const int q0 = s[4 * step], q1 = s[5 * step], q2 = s[6 * step],
            q3 = s[7 * step];
  const int d0 = p0 - q0;
  const bool act = e.bs > 0 && iabs(d0) < e.alpha &&
                   iabs(p1 - p0) < e.beta && iabs(q1 - q0) < e.beta;
  if (!act) return;
  const bool ap = iabs(p2 - p0) < e.beta;
  const bool aq = iabs(q2 - q0) < e.beta;
  if (e.bs == 4) {
    const bool strong = iabs(d0) < ((e.alpha >> 2) + 2);
    if (ap && strong) {
      s[3 * step] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      s[2 * step] = (p2 + p1 + p0 + q0 + 2) >> 2;
      s[step] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      s[3 * step] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && strong) {
      s[4 * step] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      s[5 * step] = (q2 + q1 + q0 + p0 + 2) >> 2;
      s[6 * step] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      s[4 * step] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  const int tc = e.tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
  const int delta = clip3((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
  s[3 * step] = clip3(p0 + delta, 0, 255);
  s[4 * step] = clip3(q0 - delta, 0, 255);
  const int avg = (p0 + q0 + 1) >> 1;
  if (ap) s[2 * step] = p1 + clip3((p2 + avg - 2 * p1) >> 1, -e.tc0, e.tc0);
  if (aq) s[5 * step] = q1 + clip3((q2 + avg - 2 * q1) >> 1, -e.tc0, e.tc0);
}

// One chroma line: s[k * step], k = 0..3 holds p1 p0 q0 q1; p0 and q0
// are rewritten (deblock_jax._chroma_edge, tc = tc0 + 1).
__device__ __forceinline__ void chroma_line(int* s, int step, EdgeParams e) {
  const int p1 = s[0], p0 = s[step], q0 = s[2 * step], q1 = s[3 * step];
  const bool act = e.bs > 0 && iabs(p0 - q0) < e.alpha &&
                   iabs(p1 - p0) < e.beta && iabs(q1 - q0) < e.beta;
  if (!act) return;
  if (e.bs == 4) {
    s[step] = (2 * p1 + p0 + q1 + 2) >> 2;
    s[2 * step] = (2 * q1 + q0 + p1 + 2) >> 2;
    return;
  }
  const int tc = e.tc0 + 1;
  const int delta = clip3((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
  s[step] = clip3(p0 + delta, 0, 255);
  s[2 * step] = clip3(q0 - delta, 0, 255);
}

using DeviceInt = cuda::atomic_ref<int, cuda::thread_scope_device>;

// The block's four warps and its two named barriers (0 is
// __syncthreads): kBarHalo joins the filter warps with the halo warp,
// kBarDone the filter warps with the release warp.
constexpr int kLumaWarp = 0, kChromaWarp = 1, kHaloWarp = 2,
              kReleaseWarp = 3, kThreads = 128;
constexpr int kBarHalo = 1, kBarDone = 2;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(96) : "memory");
}

__device__ __forceinline__ int byte_of(uint4 l, int k) {
  const uint32_t w = k < 4 ? l.x : k < 8 ? l.y : k < 12 ? l.z : l.w;
  return (w >> (8 * (k & 3))) & 255;
}

// Persistent row-pipelined deblock of one frame; see the note above.
// scratch: mb_h progress counters (MBs finished per row), then the row
// ticket, all zero at launch. Dynamic shared memory: the row's bS, its
// QPs and offsets, (8 * W4 + 8 * mb_w) ints. cqpv, aoff, boff may be
// null (see the note above).
//
// Roles. Lane l < 16 of the luma warp owns luma line l of the MB: row l
// in the vertical pass, column l in the horizontal one. Lane l < 16 of
// the chroma warp owns chroma line l % 8 of plane l / 8 the same way.
// A lane filters its line in registers and stores what changed straight
// to the planes. Shared memory holds the MB's own lines between the
// passes (R, C: 16x16 luma and 2 x 8x8 chroma, padded against bank
// conflicts), whose last 4 luma / 2 chroma columns are the next MB's
// left context, and the halo above in two buffers (HL, HC). The halo
// warp waits for row y-1 and loads the halo of MB x while the filter
// warps run MB x's vertical pass; the release warp publishes MB x while
// they run MB x+1's vertical pass.
__global__ void __launch_bounds__(kThreads)
deblock_rows(uint8_t* y, uint8_t* u, uint8_t* v,
             const int32_t* __restrict__ bsv, const int32_t* __restrict__ bsh,
             const int32_t* __restrict__ qp,
             const int32_t* __restrict__ cqpu,
             const int32_t* __restrict__ cqpv,
             const int32_t* __restrict__ aoff,
             const int32_t* __restrict__ boff,
             int* scratch, int mb_w, int mb_h) {
  __shared__ int R[16][17];
  __shared__ int C[2][8][9];
  __shared__ int HL[2][4][16];
  __shared__ int HC[2][2][2][8];
  __shared__ int row_s;
  extern __shared__ int dyn[];
  const int W4 = 4 * mb_w;
  int* bsv_s = dyn;                 // [4][W4]: BSV rows 4y..4y+3
  int* bsh_s = bsv_s + 4 * W4;      // [4][W4]: BSH rows 4y..4y+3
  // [mb_w] each: of row y the QP, the Cb and Cr QPs, the alpha and
  // beta offsets; of row y-1 the QP and the Cb and Cr QPs
  int* qp_s = bsh_s + 4 * W4;
  int* cqs = qp_s + mb_w;           // [2][mb_w]: Cb, Cr
  int* ao_s = cqs + 2 * mb_w;
  int* bo_s = ao_s + mb_w;
  int* qpt_s = bo_s + mb_w;
  int* cqts = qpt_s + mb_w;         // [2][mb_w]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int W = 16 * mb_w, Wc = 8 * mb_w;
  // chroma lanes: plane cp, line cl
  const int cp = (lane >> 3) & 1, cl = lane & 7;
  uint8_t* const cplane = cp ? v : u;
  const int* const cqp_s = cqs + cp * mb_w;
  const int* const cqpt_s = cqts + cp * mb_w;
  const int32_t* const cqpv_in = cqpv ? cqpv : cqpu;
  const bool active = lane < 16;

  for (;;) {
    if (t == 32 * kReleaseWarp)
      row_s = DeviceInt(scratch[mb_h]).fetch_add(
          1, cuda::std::memory_order_relaxed);
    __syncthreads();
    const int my = row_s;
    if (my >= mb_h) return;

    for (int i = t; i < 4 * W4; i += kThreads) {
      bsv_s[i] = bsv[4 * my * W4 + i];
      bsh_s[i] = bsh[4 * my * W4 + i];
    }
    for (int i = t; i < mb_w; i += kThreads) {
      const int k = my * mb_w + i, kt = k - mb_w;
      qp_s[i] = qp[k];
      cqs[i] = cqpu[k];
      cqs[mb_w + i] = cqpv_in[k];
      ao_s[i] = aoff ? aoff[k] : 0;
      bo_s[i] = boff ? boff[k] : 0;
      qpt_s[i] = my > 0 ? qp[kt] : 0;
      cqts[i] = my > 0 ? cqpu[kt] : 0;
      cqts[mb_w + i] = my > 0 ? cqpv_in[kt] : 0;
    }
    // left of the picture and above it pixels read as 0 (they only feed
    // edges whose bS is forced to 0)
    if (t < 64) R[t >> 2][12 + (t & 3)] = 0;
    if (t < 32) C[t >> 4][(t >> 1) & 7][6 + (t & 1)] = 0;
    if (my == 0) {
      for (int i = t; i < 2 * 4 * 16; i += kThreads) (&HL[0][0][0])[i] = 0;
      for (int i = t; i < 2 * 2 * 2 * 8; i += kThreads)
        (&HC[0][0][0][0])[i] = 0;
    }
    __syncthreads();

    if (warp == kLumaWarp) {
      uint8_t* const own = y + (16 * my + lane) * W;
      uint4 next = active ? __ldcg(reinterpret_cast<const uint4*>(own))
                          : make_uint4(0, 0, 0, 0);
      for (int mx = 0; mx < mb_w; ++mx) {
        const int qc = qp_s[mx], ql = mx > 0 ? qp_s[mx - 1] : qc;
        const int qt = my > 0 ? qpt_s[mx] : qc;
        const int ao = ao_s[mx], bo = bo_s[mx];
        int L[20];
        if (active) {         // vertical edges on row `lane`
#pragma unroll
          for (int c = 0; c < 4; ++c) L[c] = R[lane][12 + c];
#pragma unroll
          for (int c = 0; c < 16; ++c) L[4 + c] = byte_of(next, c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int bs = bsv_s[(lane >> 2) * W4 + 4 * mx + e];
            if (e == 0 && mx == 0) bs = 0;
            luma_line(&L[4 * e], 1,
                      edge_params(bs, qc, e == 0 ? ql : qc, ao, bo));
          }
#pragma unroll
          for (int c = 0; c < 16; ++c) R[lane][c] = L[4 + c];
          if (mx > 0) {       // the left MB's right columns
#pragma unroll
            for (int c = 1; c < 4; ++c) own[16 * mx - 4 + c] = L[c];
          }
          if (mx + 1 < mb_w)
            next = __ldcg(reinterpret_cast<const uint4*>(own + 16 * mx + 16));
        }
        bar_sync(kBarHalo);
        if (active) {         // horizontal edges on column `lane`
#pragma unroll
          for (int r = 0; r < 4; ++r) L[r] = HL[mx & 1][r][lane];
#pragma unroll
          for (int r = 0; r < 16; ++r) L[4 + r] = R[r][lane];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int bs = bsh_s[e * W4 + 4 * mx + (lane >> 2)];
            if (e == 0 && my == 0) bs = 0;
            luma_line(&L[4 * e], 1,
                      edge_params(bs, qc, e == 0 ? qt : qc, ao, bo));
          }
          uint8_t* col = y + (16 * my - 4) * W + 16 * mx + lane;
#pragma unroll
          for (int r = 1; r < 20; ++r)
            if (r >= 4 || my > 0) col[r * W] = L[r];
          if (lane >= 12) {   // the next MB's left context
#pragma unroll
            for (int r = 0; r < 16; ++r) R[r][lane] = L[4 + r];
          }
        }
        bar_sync(kBarDone);
      }
    } else if (warp == kChromaWarp) {
      uint8_t* const own = cplane + (8 * my + cl) * Wc;
      uint4 next = make_uint4(0, 0, 0, 0);
      if (active) {
        const uint2 c = __ldcg(reinterpret_cast<const uint2*>(own));
        next = make_uint4(c.x, c.y, 0, 0);
      }
      for (int mx = 0; mx < mb_w; ++mx) {
        const int qc = cqp_s[mx], ql = mx > 0 ? cqp_s[mx - 1] : qc;
        const int qt = my > 0 ? cqpt_s[mx] : qc;
        const int ao = ao_s[mx], bo = bo_s[mx];
        int L[10];
        if (active) {         // vertical edges e = 0, 2 on row cl
#pragma unroll
          for (int c = 0; c < 2; ++c) L[c] = C[cp][cl][6 + c];
#pragma unroll
          for (int c = 0; c < 8; ++c) L[2 + c] = byte_of(next, c);
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            int bs = bsv_s[(cl >> 1) * W4 + 4 * mx + e];
            if (e == 0 && mx == 0) bs = 0;
            chroma_line(&L[2 * e], 1,
                        edge_params(bs, qc, e == 0 ? ql : qc, ao, bo));
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) C[cp][cl][c] = L[2 + c];
          if (mx > 0) own[8 * mx - 1] = L[1];
          if (mx + 1 < mb_w) {
            const uint2 c =
                __ldcg(reinterpret_cast<const uint2*>(own + 8 * mx + 8));
            next = make_uint4(c.x, c.y, 0, 0);
          }
        }
        bar_sync(kBarHalo);
        if (active) {         // horizontal edges e = 0, 2 on column cl
#pragma unroll
          for (int r = 0; r < 2; ++r) L[r] = HC[mx & 1][cp][r][cl];
#pragma unroll
          for (int r = 0; r < 8; ++r) L[2 + r] = C[cp][r][cl];
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            int bs = bsh_s[e * W4 + 4 * mx + (cl >> 1)];
            if (e == 0 && my == 0) bs = 0;
            chroma_line(&L[2 * e], 1,
                        edge_params(bs, qc, e == 0 ? qt : qc, ao, bo));
          }
          uint8_t* col = cplane + (8 * my - 2) * Wc + 8 * mx + cl;
#pragma unroll
          for (int r = 1; r < 10; ++r)
            if (r >= 2 || my > 0) col[r * Wc] = L[r];
          if (cl >= 6) {
#pragma unroll
            for (int r = 0; r < 8; ++r) C[cp][r][cl] = L[2 + r];
          }
        }
        bar_sync(kBarDone);
      }
    } else if (warp == kHaloWarp) {
      int seen = 0;           // lane 0: row y-1's count at the last acquire
      for (int mx = 0; mx < mb_w; ++mx) {
        if (my > 0) {
          // wait for row y-1 to finish MB mx+1 (the whole row at its end)
          if (lane == 0) {
            const int need = mx + 2 < mb_w ? mx + 2 : mb_w;
            DeviceInt done(scratch[my - 1]);
            while (seen < need)
              seen = done.load(cuda::std::memory_order_acquire);
          }
          __syncwarp();
          // lanes 0-3: luma halo rows; lanes 4-7: 2 rows of each chroma
          // plane; the buffer H(mx-2) read, free since the last barrier
          if (lane < 4) {
            const uint4 l = __ldcg(reinterpret_cast<const uint4*>(
                y + (16 * my - 4 + lane) * W + 16 * mx));
#pragma unroll
            for (int c = 0; c < 16; ++c) HL[mx & 1][lane][c] = byte_of(l, c);
          } else if (lane < 8) {
            const int p = (lane - 4) >> 1, r = lane & 1;
            const uint2 l = __ldcg(reinterpret_cast<const uint2*>(
                (p ? v : u) + (8 * my - 2 + r) * Wc + 8 * mx));
#pragma unroll
            for (int c = 0; c < 8; ++c)
              HC[mx & 1][p][r][c] = byte_of(make_uint4(l.x, l.y, 0, 0), c);
          }
        }
        bar_sync(kBarHalo);
      }
    } else {                  // release warp
      for (int mx = 0; mx < mb_w; ++mx) {
        bar_sync(kBarDone);
        if (lane == 0)
          DeviceInt(scratch[my]).store(mx + 1,
                                       cuda::std::memory_order_release);
      }
    }
  }
}

}  // namespace

// Filters one frame in place on `stream` with one launch: y [16*mb_h,
// 16*mb_w], u and v [8*mb_h, 8*mb_w] uint8 (y 16-byte, u and v 8-byte
// aligned); bsv, bsh [4*mb_h, 4*mb_w] int32 (bS 0..4); qp, cqpu (Cb),
// cqpv (Cr, or null for the Cb QPs), aoff, boff (alpha / beta offsets,
// or null for 0) [mb_h*mb_w] int32; scratch [mb_h + 1] int32, zero. All
// row-major and contiguous. Returns the launch's error (cudaSuccess = 0).
extern "C" int deblock_frame(void* y, void* u, void* v, const void* bsv,
                             const void* bsh, const void* qp,
                             const void* cqpu, const void* cqpv,
                             const void* aoff, const void* boff,
                             void* scratch, int mb_w, int mb_h,
                             void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (8 * 4 * mb_w + 8 * mb_w) * sizeof(int);
  // past 48 KB of shared memory in all (the static part is ~2.4 KB, so
  // frames wider than ~4,600 pixels) a block needs this opt-in; every
  // launch sets it, so that all widths take the same path
  err = cudaFuncSetAttribute(deblock_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = mb_h < sms ? mb_h : sms;
  deblock_rows<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(y), static_cast<uint8_t*>(u),
      static_cast<uint8_t*>(v), static_cast<const int32_t*>(bsv),
      static_cast<const int32_t*>(bsh), static_cast<const int32_t*>(qp),
      static_cast<const int32_t*>(cqpu), static_cast<const int32_t*>(cqpv),
      static_cast<const int32_t*>(aoff), static_cast<const int32_t*>(boff),
      static_cast<int*>(scratch), mb_w, mb_h);
  return static_cast<int>(cudaGetLastError());
}
