// H.264 in-loop deblocking of one encoder frame (spec 8.7) as a knight
// wavefront, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel openh264_tpu/encoder/deblock_pallas.py
// (deblock_frame_pallas -> _kernel). It computes exactly what
// openh264_tpu/encoder/deblock_jax.py::deblock_frame_device computes;
// its plain PyTorch twin is openh264_tpu_torch/encoder/deblock_torch.py
// ::deblock_frame_device.
//
// What bounds it on the card: the dependency chain, not bytes or
// operations. MB (x, y) reads pixels last written by MBs (x-1, y),
// (x, y-1) and (x+1, y-1), so the frame takes nd = mb_w + 2*mb_h - 2
// ordered steps (168 at 720p), each with at most mb_h independent MBs.
// The ~2.8 MB the frame reads and writes move in under 1 us at
// 3.35 TB/s; a step's arithmetic is a few hundred integer operations
// per pixel line. What the card spends is the latency of 168 dependent
// steps.
//
// Design (first, simple cut): one launch per knight diagonal d = x + 2y,
// all issued from the host loop in deblock_frame() on the caller's
// stream, so the stream orders the diagonals and the Python side makes
// one ctypes call per frame. Each block owns one MB of the diagonal:
// it loads the MB's 20x20 luma region and two 10x10 chroma regions
// (4 / 2 rows and columns of top-left halo) into shared memory, filters
// one line per thread (16 luma lines and 2 x 8 chroma lines = one warp)
// in the reference order -- vertical edges e = 0..3, then horizontal
// e = 0..3, chroma at e in {0, 2} -- and writes the region back in place.
// Regions of two MBs on one diagonal are disjoint. alpha, beta and tc0
// come from the tables below, indexed inside the kernel. The TPU
// kernel's plane shear (a lane-alignment workaround) is gone: blocks
// address the plain planes. Later work can collapse the 168 launches
// into one persistent launch with per-row progress flags, or a CUDA
// graph.

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
// (qa, qb) indexes the tables; bS <= 0 turns the line off.
struct EdgeParams {
  int bs, alpha, beta, tc0;
};

__device__ __forceinline__ EdgeParams edge_params(int bs, int qa, int qb) {
  const int ia = clip3((qa + qb + 1) >> 1, 0, 51);
  EdgeParams p;
  p.bs = bs;
  p.alpha = kAlpha[ia];
  p.beta = kBeta[ia];
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

// One block per MB of diagonal d, 32 threads: t < 16 filters luma line
// t; t >= 16 filters chroma line (t - 16) % 8 of plane (t - 16) / 8.
__global__ void __launch_bounds__(32)
deblock_diagonal(uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                 uint8_t* __restrict__ v, const int32_t* __restrict__ bsv,
                 const int32_t* __restrict__ bsh,
                 const int32_t* __restrict__ qp,
                 const int32_t* __restrict__ cqp, int mb_w, int mb_h, int d,
                 int y_lo) {
  __shared__ int R[20][20];
  __shared__ int C[2][10][10];
  const int t = threadIdx.x;
  const int my = y_lo + blockIdx.x;
  const int mx = d - 2 * my;
  const int W = 16 * mb_w, H = 16 * mb_h, Wc = 8 * mb_w, Hc = 8 * mb_h;
  const int W4 = 4 * mb_w;
  const int mb = my * mb_w + mx;
  const int y0 = 16 * my - 4, x0 = 16 * mx - 4;
  const int cy0 = 8 * my - 2, cx0 = 8 * mx - 2;

  // load: pixels outside the picture read as 0; they only feed picture
  // border edges, whose bS is forced to 0 below
  for (int i = t; i < 400; i += 32) {
    const int r = i / 20, c = i % 20, py = y0 + r, px = x0 + c;
    R[r][c] = (py >= 0 && px >= 0 && py < H && px < W) ? y[py * W + px] : 0;
  }
  for (int i = t; i < 200; i += 32) {
    const int p = i / 100, r = (i / 10) % 10, c = i % 10;
    const int py = cy0 + r, px = cx0 + c;
    const uint8_t* src = p ? v : u;
    C[p][r][c] = (py >= 0 && px >= 0 && py < Hc && px < Wc)
                     ? src[py * Wc + px] : 0;
  }
  __syncthreads();

  const int qc = qp[mb], cqc = cqp[mb];
  const int ql = mx > 0 ? qp[mb - 1] : qc, cql = mx > 0 ? cqp[mb - 1] : cqc;
  const int qt = my > 0 ? qp[mb - mb_w] : qc;
  const int cqt = my > 0 ? cqp[mb - mb_w] : cqc;
  const bool luma = t < 16;
  const int cp = (t - 16) >> 3, cl = (t - 16) & 7;

  // vertical edges: luma line t is row 4 + t; chroma line cl is row 2 + cl
  for (int e = 0; e < 4; ++e) {
    if (luma) {
      int bs = bsv[(4 * my + (t >> 2)) * W4 + 4 * mx + e];
      if (e == 0 && mx == 0) bs = 0;
      luma_line(&R[4 + t][4 * e], 1,
                edge_params(bs, qc, e == 0 ? ql : qc));
    } else if ((e & 1) == 0) {
      int bs = bsv[(4 * my + (cl >> 1)) * W4 + 4 * mx + e];
      if (e == 0 && mx == 0) bs = 0;
      chroma_line(&C[cp][2 + cl][2 * e], 1,
                  edge_params(bs, cqc, e == 0 ? cql : cqc));
    }
    __syncthreads();
  }
  // horizontal edges: luma line t is column 4 + t; chroma column 2 + cl
  for (int e = 0; e < 4; ++e) {
    if (luma) {
      int bs = bsh[(4 * my + e) * W4 + 4 * mx + (t >> 2)];
      if (e == 0 && my == 0) bs = 0;
      luma_line(&R[4 * e][4 + t], 20,
                edge_params(bs, qc, e == 0 ? qt : qc));
    } else if ((e & 1) == 0) {
      int bs = bsh[(4 * my + e) * W4 + 4 * mx + (cl >> 1)];
      if (e == 0 && my == 0) bs = 0;
      chroma_line(&C[cp][2 * e][2 + cl], 10,
                  edge_params(bs, cqc, e == 0 ? cqt : cqc));
    }
    __syncthreads();
  }

  for (int i = t; i < 400; i += 32) {
    const int r = i / 20, c = i % 20, py = y0 + r, px = x0 + c;
    if (py >= 0 && px >= 0 && py < H && px < W)
      y[py * W + px] = (uint8_t)R[r][c];
  }
  for (int i = t; i < 200; i += 32) {
    const int p = i / 100, r = (i / 10) % 10, c = i % 10;
    const int py = cy0 + r, px = cx0 + c;
    uint8_t* dst = p ? v : u;
    if (py >= 0 && px >= 0 && py < Hc && px < Wc)
      dst[py * Wc + px] = (uint8_t)C[p][r][c];
  }
}

}  // namespace

// Filters one frame in place on `stream`: y [16*mb_h, 16*mb_w], u and v
// [8*mb_h, 8*mb_w] uint8; bsv, bsh [4*mb_h, 4*mb_w] int32 (bS 0..4);
// qp, cqp [mb_h*mb_w] int32. All row-major and contiguous. Returns the
// first launch error (cudaSuccess = 0 when every diagonal launched).
extern "C" int deblock_frame(void* y, void* u, void* v, const void* bsv,
                             const void* bsh, const void* qp,
                             const void* cqp, int mb_w, int mb_h,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nd = mb_w + 2 * (mb_h - 1);
  for (int d = 0; d < nd; ++d) {
    // rows whose MB x = d - 2*row lies in [0, mb_w)
    const int y_lo = d - mb_w + 1 > 0 ? (d - mb_w + 2) / 2 : 0;
    const int y_hi = d / 2 < mb_h - 1 ? d / 2 : mb_h - 1;
    if (y_hi < y_lo) continue;  // only when mb_w == 1 and d is odd
    deblock_diagonal<<<y_hi - y_lo + 1, 32, 0, s>>>(
        static_cast<uint8_t*>(y), static_cast<uint8_t*>(u),
        static_cast<uint8_t*>(v), static_cast<const int32_t*>(bsv),
        static_cast<const int32_t*>(bsh), static_cast<const int32_t*>(qp),
        static_cast<const int32_t*>(cqp), mb_w, mb_h, d, y_lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
