// Kernel B1's device code: the banded Cholesky factor of a half-bandwidth-4
// SPD system, its substitutions and the refined solve, for one warp that
// holds one system in shared memory. Included by banded_cholesky.cu (B1's
// two entries) and by fitpack_part2.cu (FITPACK's part 2, which solves its
// systems with the same arithmetic inside its own loop). The design and the
// arithmetic are described at the top of banded_cholesky.cu.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace banded {

constexpr int kHalf = 4;              // half-bandwidth w
constexpr int kBand = 2 * kHalf + 1;  // 9 stored band columns
constexpr int kThreads = 32;          // one warp, one system, per block
constexpr int kPad = 4;               // floats past the last array, for reads one row ahead

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Asynchronous copies global -> shared: they pass through no register, so a
// lane issues all of its copies and waits once.
__device__ __forceinline__ void copy_async_4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async_16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\n cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of n contiguous floats into shared memory: 16 bytes a lane,
// neighbouring lanes on neighbouring addresses, where both ends and n allow
// it, 4 bytes else.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n, int lane) {
  const bool by_16 = (n % 4 == 0) && ((reinterpret_cast<uintptr_t>(src) & 15) == 0) &&
                     ((__cvta_generic_to_shared(dst) & 15) == 0);
  if (by_16) {
    for (int e = 4 * lane; e < n; e += 4 * kThreads) copy_async_16(dst + e, src + e);
  } else {
    for (int e = lane; e < n; e += kThreads) copy_async_4(dst + e, src + e);
  }
}

// The last four rows of L and of y as the factorisation moves down the band.
struct Window {
  float l[kHalf][kHalf];  // l[t][d] = L[j-4+t, j-8+t+d]
  float inv[kHalf];       // 1 / L[j-4+t, j-4+t]
  float y[kHalf];         // y[j-4+t] of this lane's right-hand side
};

// Row j of the Cholesky factor and of the forward substitution L y = src.
// Entry L[j, k] sums its products over m = j-4..k-1 in ascending order, the
// pivot and y[j] over k = j-4..j-1, as the plain version does. kEdge rows
// (j < 4) test which of those exist. a[0..4] = A[j, j-4..j]. Of the results
// lane t < 4 stores L[j, j-4+t], lane 0 stores 1/diag (and, with kDiag, the
// diagonal itself in diag_out[j]), lane r < R stores y[j].
template <int R, bool kEdge, bool kDiag>
__device__ __forceinline__ void factor_row(int j, const float (&a)[kHalf + 1], float rhs_j, Window& w,
                                           float* __restrict__ l, float* __restrict__ inv,
                                           float* __restrict__ y, int lane, float* __restrict__ diag_out) {
  float cur[kHalf];  // cur[t] = L[j, j-4+t]
#pragma unroll
  for (int t = 0; t < kHalf; ++t) {
    float s = a[t];
#pragma unroll
    for (int u = 0; u < t; ++u) {
      if (!kEdge || j - kHalf + u >= 0) s = sub(s, mul(cur[u], w.l[t][u - t + kHalf]));
    }
    cur[t] = (!kEdge || j - kHalf + t >= 0) ? mul(s, w.inv[t]) : 0.0f;
  }
  float acc = a[kHalf], fwd = rhs_j;
#pragma unroll
  for (int t = 0; t < kHalf; ++t) {
    if (!kEdge || j - kHalf + t >= 0) {
      acc = sub(acc, mul(cur[t], cur[t]));
      fwd = sub(fwd, mul(cur[t], w.y[t]));
    }
  }
  const float diag = __fsqrt_rn(acc < 1e-20f ? 1e-20f : acc);
  const float inv_diag = __fdiv_rn(1.0f, diag);
  const float y_j = mul(fwd, inv_diag);

  if (lane < kHalf) l[j * kHalf + lane] = lane == 0 ? cur[0] : lane == 1 ? cur[1] : lane == 2 ? cur[2] : cur[3];
  if (lane == 0) inv[j] = inv_diag;
  if (kDiag && lane == 0) diag_out[j] = diag;
  if (lane < R) y[j * R + lane] = y_j;
#pragma unroll
  for (int t = 0; t + 1 < kHalf; ++t) {
    w.inv[t] = w.inv[t + 1];
    w.y[t] = w.y[t + 1];
#pragma unroll
    for (int d = 0; d < kHalf; ++d) w.l[t][d] = w.l[t + 1][d];
  }
  w.inv[kHalf - 1] = inv_diag;
  w.y[kHalf - 1] = y_j;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) w.l[kHalf - 1][d] = cur[d];
}

// Factor the band and solve L y = src in one pass over the rows. Every lane
// runs all of it on the same band (the same values in each) with the
// right-hand side column r of its own; the coming row is read ahead. With
// kDiag the diagonal of L is kept in diag_out as well.
template <int R, bool kDiag = false>
__device__ __forceinline__ void factor_and_forward(const float* __restrict__ band, const float* __restrict__ src,
                                                   float* __restrict__ l, float* __restrict__ inv,
                                                   float* __restrict__ y, int c, int lane, int r,
                                                   float* __restrict__ diag_out = nullptr) {
  Window w;
#pragma unroll
  for (int t = 0; t < kHalf; ++t) {
    w.inv[t] = 0.0f;
    w.y[t] = 0.0f;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) w.l[t][d] = 0.0f;
  }
  float a[kHalf + 1], rhs_j = src[r];
#pragma unroll
  for (int t = 0; t <= kHalf; ++t) a[t] = band[t];
  // each turn reads row j + 1 ahead; past the last row that is what follows
  // in shared memory, unused
  auto row = [&](int j, auto edge) {
    float next[kHalf + 1];
#pragma unroll
    for (int t = 0; t <= kHalf; ++t) next[t] = band[(j + 1) * kBand + t];
    const float rhs_next = src[(j + 1) * R + r];
    factor_row<R, decltype(edge)::value, kDiag>(j, a, rhs_j, w, l, inv, y, lane, diag_out);
#pragma unroll
    for (int t = 0; t <= kHalf; ++t) a[t] = next[t];
    rhs_j = rhs_next;
  };
  int j = 0;
  for (; j < kHalf && j < c; ++j) row(j, std::true_type{});
#pragma unroll 4
  for (; j < c; ++j) row(j, std::false_type{});  // four turns bring the window round: no register moves
}

// Forward substitution L y = src for column r, L read from shared memory.
template <int R>
__device__ __forceinline__ void forward(const float* __restrict__ l, const float* __restrict__ inv,
                                        const float* __restrict__ src, float* __restrict__ y, int c, int r) {
  float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f, w3 = 0.0f;  // y[i-4], y[i-3], y[i-2], y[i-1]
  const int edge = c < kHalf ? c : kHalf;
  for (int i = 0; i < edge; ++i) {
    const float* li = l + i * kHalf;
    float acc = src[i * R + r];
    if (i >= 4) acc = sub(acc, mul(li[0], w0));
    if (i >= 3) acc = sub(acc, mul(li[1], w1));
    if (i >= 2) acc = sub(acc, mul(li[2], w2));
    if (i >= 1) acc = sub(acc, mul(li[3], w3));
    const float v = mul(acc, inv[i]);
    y[i * R + r] = v;
    w0 = w1; w1 = w2; w2 = w3; w3 = v;
  }
  if (c <= kHalf) return;
  const float* ln = l + kHalf * kHalf;
  float n0 = ln[0], n1 = ln[1], n2 = ln[2], n3 = ln[3], ninv = inv[kHalf], nsrc = src[kHalf * R + r];
#pragma unroll 4
  for (int i = kHalf; i < c; ++i) {
    const float c0 = n0, c1 = n1, c2 = n2, c3 = n3, cinv = ninv, csrc = nsrc;
    ln = l + (i + 1) * kHalf;  // past the last row: what follows in shared memory, unused
    n0 = ln[0]; n1 = ln[1]; n2 = ln[2]; n3 = ln[3];
    ninv = inv[i + 1];
    nsrc = src[(i + 1) * R + r];
    const float v = mul(sub(sub(sub(sub(csrc, mul(c0, w0)), mul(c1, w1)), mul(c2, w2)), mul(c3, w3)), cinv);
    y[i * R + r] = v;
    w0 = w1; w1 = w2; w2 = w3; w3 = v;
  }
}

// Back substitution L^T x = y for column r; with kAdd the result is added to
// what dst holds (the refinement's correction).
template <int R, bool kAdd>
__device__ __forceinline__ void backward(const float* __restrict__ l, const float* __restrict__ inv,
                                         const float* __restrict__ y, float* __restrict__ dst, int c, int r) {
  float v1 = 0.0f, v2 = 0.0f, v3 = 0.0f, v4 = 0.0f;  // x[i+1], x[i+2], x[i+3], x[i+4]
  const int inner = c - kHalf - 1;  // the last row with four rows below it
  for (int i = c - 1; i > inner && i >= 0; --i) {
    float acc = y[i * R + r];
    if (i + 1 < c) acc = sub(acc, mul(l[(i + 1) * kHalf + 3], v1));
    if (i + 2 < c) acc = sub(acc, mul(l[(i + 2) * kHalf + 2], v2));
    if (i + 3 < c) acc = sub(acc, mul(l[(i + 3) * kHalf + 1], v3));
    if (i + 4 < c) acc = sub(acc, mul(l[(i + 4) * kHalf + 0], v4));
    const float v = mul(acc, inv[i]);
    dst[i * R + r] = kAdd ? __fadd_rn(dst[i * R + r], v) : v;
    v4 = v3; v3 = v2; v2 = v1; v1 = v;
  }
  if (inner < 0) return;
  // row i reads L[i+1, i], L[i+2, i], L[i+3, i], L[i+4, i]
  float m1 = l[(inner + 1) * kHalf + 3], m2 = l[(inner + 2) * kHalf + 2], m3 = l[(inner + 3) * kHalf + 1],
        m4 = l[(inner + 4) * kHalf + 0];
  float minv = inv[inner], my = y[inner * R + r], mdst = kAdd ? dst[inner * R + r] : 0.0f;
#pragma unroll 4
  for (int i = inner; i >= 0; --i) {
    const float e1 = m1, e2 = m2, e3 = m3, e4 = m4, cinv = minv, cy = my, cdst = mdst;
    // row i - 1; before the first row this reads what precedes in shared memory, unused
    m1 = l[i * kHalf + 3];
    m2 = l[(i + 1) * kHalf + 2];
    m3 = l[(i + 2) * kHalf + 1];
    m4 = l[(i + 3) * kHalf + 0];
    minv = inv[i - 1];
    my = y[(i - 1) * R + r];
    if (kAdd) mdst = dst[(i - 1) * R + r];
    const float v = mul(sub(sub(sub(sub(cy, mul(e1, v1)), mul(e2, v2)), mul(e3, v3)), mul(e4, v4)), cinv);
    dst[i * R + r] = kAdd ? __fadd_rn(cdst, v) : v;
    v4 = v3; v3 = v2; v2 = v1; v1 = v;
  }
}

// Solve band x = b for the system the warp holds in shared memory: factor
// and forward, back substitution; with kRefine the residual b - band x (the
// sum over d = 0..8 in that order, from 0), both substitutions again with the
// same factor and the correction added to x. l, inv, y and res are scratch.
// The substitutions read one row past either end of an array, so the arrays
// must lie as banded_cholesky_kernel lays them out, one after the other:
// band (9C), l (4C), inv (C), b, y, x, res (RC each), then kPad floats.
// Every lane of the warp calls it.
template <int R, bool kRefine>
__device__ __forceinline__ void solve(const float* __restrict__ band, const float* __restrict__ b,
                                      float* __restrict__ l, float* __restrict__ inv, float* __restrict__ y,
                                      float* __restrict__ x, float* __restrict__ res, int c, int lane) {
  const int r = lane < R ? lane : 0;
  factor_and_forward<R>(band, b, l, inv, y, c, lane, r);
  __syncwarp();
  if (lane < R) backward<R, false>(l, inv, y, x, c, lane);

  if (kRefine) {
    __syncwarp();
    for (int e = lane; e < c * R; e += kThreads) {
      const int i = e / R, col_r = e % R;
      float ax = 0.0f;
#pragma unroll
      for (int d = 0; d < kBand; ++d) {
        const int col = i - kHalf + d;
        if (col >= 0 && col < c) ax = __fadd_rn(ax, mul(band[i * kBand + d], x[col * R + col_r]));
      }
      res[e] = sub(b[e], ax);
    }
    __syncwarp();
    if (lane < R) {
      forward<R>(l, inv, res, y, c, lane);
      backward<R, true>(l, inv, y, x, c, lane);
    }
  }
  __syncwarp();
}

}  // namespace banded
