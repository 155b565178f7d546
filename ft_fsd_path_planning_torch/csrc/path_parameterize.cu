// The parameterization tail of path calculation, on Hopper: one launch a call.
//
// Replaces no TPU kernel: the JAX package runs it
// (ft_fsd_path_planning_tpu/models/pathing.py::_parameterize_path after its
// refit, with ops/curvature.py) as XLA ops. The port ran it as ~500 small
// eager launches a frame, and the curvature's circle fit read a flag back
// to the host once a Newton trip. This kernel is models/pathing.py::
// parameterize_tail_plain in one launch, with no host read: the refit
// spline sampled every predict_every, the count of samples within it, the
// signed curvature of a windowed hyper-fit circle at every sample, the
// clamped box filter over the curvatures and the horizon's rows.
//
// Design:
//
//   * one block a lane of the batch, one thread a sample (P <= 256 threads,
//     rounded up to whole warps);
//   * the full knot vector and the coefficients are staged in shared memory
//     once; each thread evaluates its sample from there and writes it to
//     shared memory, so a window of up to W points is read from there and
//     not from W rolled copies; __syncthreads_count of the valid flags gives
//     the count of samples;
//   * each thread fits its own window's circle: the masked moments, then the
//     Newton iteration on the characteristic polynomial run to that window's
//     own end. The plain version (ops/geometry.py::circle_fit) freezes each
//     window once it stops improving and leaves its loop when every window
//     of the batch has frozen: a frozen window keeps its root, so the root of
//     a window run alone to its own end is the same;
//   * the curvatures stay in shared memory for the filter; thread h < H
//     filters its horizon sample and writes the row. Three block barriers:
//     after staging, after sampling, before the filter.
//
// Arithmetic: this file is compiled with -fmad=false, so no product and sum
// is contracted, and every expression is evaluated in the order the plain
// version writes it, with correctly rounded division and square root. A
// division by a Python scalar runs on the card as a product with the
// scalar's float32 reciprocal, so the horizon's linspace multiplies by
// 1 / (H - 1) as the wrapper passes it. The sums are added in the order
// PyTorch's CUDA reduction (ATen/native/cuda/Reduce.cuh) adds them for the
// plain version's shapes: a window's mean, a sum over an axis that is not
// the fastest, by one thread with four accumulators in turn; the moments and
// the filter's box, sums over the fastest axis, by a tree of lanes
// (torch_sum_strided, torch_sum_last). So every output is the plain
// version's bit for bit. That matters: the float32 hyper-fit is chaotic on a
// nearly straight window, and moments added in slot order gave a 14.6 m
// radius where the plain version read 281 m (tests/param_check.py).
//
// What bounds it on an H100 (models/pathing.py::param_kernel_bytes and
// param_kernel_flops): a lane moves the fit in (24 knots and their count,
// 28 x 2 coefficients, the chord length, ok, predict_every: 333 B) and H
// rows of four floats, ok, the count and H indices out (H = 40: 809 B), and
// needs some 0.27 Mflop at P = 192, W = 31 (the basis and sum of a sample,
// ~60; the mean and six moments over a window's slots, ~27 a slot; up to 32
// Newton trips of ~15; the circle's centre; the filter). At B = 1 that is
// 0.34 ns of bytes and 4 ns of operations: neither bounds it. The time is
// the latency of one thread's serial chain: the sample, the passes over its
// window and its Newton trips, with the barriers between. What the design
// does about it: one launch and no host read in place of ~500 launches and
// ~4 syncs; nothing leaves the block but the rows.
//
// C interface: parameterize_tail_f32 returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a shape it does not
// take (models/pathing.py::kernel_supports): P outside [1, 256], W not odd
// in [1, 63], H outside [2, P].

#include <cuda_runtime.h>

namespace {

constexpr int K = 3;                      // cubic splines (ops/fitpack.py::K)
constexpr int MAX_INT = 24;               // interior-knot budget (MAX_INT)
constexpr int NC = MAX_INT + K + 1;       // coefficients (NC)
constexpr int NEST = MAX_INT + 2 * (K + 1);  // full knot vector (NEST)
constexpr int MAX_P = 256;
constexpr int MAX_W = 63;

// the shape and the constants of the plain version, filled by the wrapper
struct Shape {
  int p, w, h, max_iter;
  float radius_min, radius_max, inv_h1;
};

// torch.clamp(v, lo, hi): NaN passes through
__device__ __forceinline__ float clamp(float v, float lo, float hi) { return v < lo ? lo : (v > hi ? hi : v); }

// (x, y) of the spline at u: ops/fitpack.py::_basis4 and fitpack_eval
__device__ void spline_at(float u, const float* t, const float* coef, int n_int, float& x, float& y) {
  int span = K;
  for (int j = 0; j < MAX_INT; ++j) span += (j < n_int && u >= t[K + 1 + j]) ? 1 : 0;
  float tw[2 * K];
#pragma unroll
  for (int k = 0; k < 2 * K; ++k) tw[k] = t[span - K + 1 + k];
  // de Boor's basis_funs, degree 3
  float v[K + 1] = {1.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int deg = 1; deg <= K; ++deg) {
    float saved = 0.0f, nv[K + 1];
#pragma unroll
    for (int r = 0; r < deg; ++r) {
      const float rt = tw[K + r] - u;
      const float lf = u - tw[K - deg + r];
      float denom = rt + lf;
      denom = fabsf(denom) > 1e-30f ? denom : 1.0f;
      const float tmp = v[r] / denom;
      nv[r] = saved + rt * tmp;
      saved = lf * tmp;
    }
    nv[deg] = saved;
#pragma unroll
    for (int r = 0; r <= deg; ++r) v[r] = nv[r];
  }
  const float* c = coef + 2 * (span - K);
  x = v[0] * c[0];
  y = v[0] * c[1];
#pragma unroll
  for (int r = 1; r <= K; ++r) {
    x = x + v[r] * c[2 * r];
    y = y + v[r] * c[2 * r + 1];
  }
}

// the slot (i - W // 2 + d) mod P of ops/curvature.py::_rolled_windows
__device__ __forceinline__ int rolled(int i, int d, int sh, int p) {
  const int k = (i - sh + d) % p;
  return k < 0 ? k + p : k;
}

// torch.sum over the last axis of a contiguous (..., W) float tensor, added
// as PyTorch's CUDA reduction adds it (Reduce.cuh, W <= 63: one warp's WP
// lanes, WP the largest power of two <= W): lane t adds slots t and t + WP
// into the second of four accumulators, which it combines, then the lanes
// combine by shuffles of offset WP / 2 down to 1
template <typename F>
__device__ float torch_sum_last(int w, F value) {
  int wp = 1;
  while (wp * 2 <= w) wp *= 2;
  float part[32];
  for (int t = 0; t < wp; ++t) {
    const float a = 0.0f + value(t);
    const float b = t + wp < w ? 0.0f + value(t + wp) : 0.0f;
    part[t] = ((a + b) + 0.0f) + 0.0f;
  }
  for (int offset = wp / 2; offset > 0; offset /= 2) {
    for (int t = 0; t < offset; ++t) part[t] = part[t] + part[t + offset];
  }
  return part[0];
}

// torch.sum over the W axis of a contiguous (..., W, 2) float tensor, added
// as PyTorch's CUDA reduction adds it when the reduced axis is not the
// fastest: one thread an output, four accumulators taking slots d = j mod 4
// in turn, combined in order
template <typename F>
__device__ float torch_sum_strided(int w, F value) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int d = 0; d < w; ++d) acc[d % 4] = acc[d % 4] + value(d);
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

// ops/curvature.py::path_curvature at sample i < n of n samples: the signed
// curvature of the hyper-fit circle through the window (ops/geometry.py::
// circle_fit with its Newton run to this window's own end)
__device__ float curvature_at(int i, int n, int window, const float* sx, const float* sy, const Shape& s) {
  const int sh = s.w / 2, half = (window - 1) / 2;
  auto weight = [&](int d) {
    const int raw = i - sh + d;
    return (raw >= 0 && raw < n && abs(d - sh) <= half) ? 1.0f : 0.0f;
  };
  auto at = [&](int d) { return rolled(i, d, sh, s.p); };
  float cnt = 0.0f;
  int first = -1, count = 0;
  for (int d = 0; d < s.w; ++d) {
    const bool valid = weight(d) != 0.0f;
    cnt = cnt + weight(d);  // integers: exact in any order
    if (valid) {
      if (first < 0) first = d;
      ++count;
    }
  }
  const float nw = cnt < 1.0f ? 1.0f : cnt;
  const float mean_x = torch_sum_strided(s.w, [&](int d) { return sx[at(d)] * weight(d); }) / nw;
  const float mean_y = torch_sum_strided(s.w, [&](int d) { return sy[at(d)] * weight(d); }) / nw;
  auto xc = [&](int d) { return sx[at(d)] - mean_x; };
  auto yc = [&](int d) { return sy[at(d)] - mean_y; };
  auto zi = [&](int d) { return xc(d) * xc(d) + yc(d) * yc(d); };
  const float mxy = torch_sum_last(s.w, [&](int d) { return xc(d) * yc(d) * weight(d); }) / nw;
  const float mxx = torch_sum_last(s.w, [&](int d) { return xc(d) * xc(d) * weight(d); }) / nw;
  const float myy = torch_sum_last(s.w, [&](int d) { return yc(d) * yc(d) * weight(d); }) / nw;
  const float mxz = torch_sum_last(s.w, [&](int d) { return xc(d) * zi(d) * weight(d); }) / nw;
  const float myz = torch_sum_last(s.w, [&](int d) { return yc(d) * zi(d) * weight(d); }) / nw;
  const float mzz = torch_sum_last(s.w, [&](int d) { return zi(d) * zi(d) * weight(d); }) / nw;

  const float mz = mxx + myy;
  const float cov_xy = mxx * myy - mxy * mxy;
  const float var_z = mzz - mz * mz;
  const float a2 = 4.0f * cov_xy - 3.0f * mz * mz - mzz;
  const float a1 = var_z * mz + 4.0f * cov_xy * mz - mxz * mxz - myz * myz;
  const float a0 = mxz * (mxz * myy - myz * mxy) + myz * (myz * mxx - mxz * mxy) - var_z * cov_xy;
  const float a22 = a2 + a2;
  float x = 0.0f, y = a0;
  for (int it = 0; it < s.max_iter; ++it) {
    const float dy = a1 + x * (a22 + 16.0f * x * x);
    const float x_new = x - y / (dy == 0.0f ? 1.0f : dy);
    const float y_new = a0 + x_new * (a1 + x_new * (a2 + 4.0f * x_new * x_new));
    if (x_new == x || !isfinite(x_new) || fabsf(y_new) >= fabsf(y)) break;  // frozen from here on
    x = x_new;
    y = y_new;
  }
  float det = x * x - x * mz + cov_xy;
  const float det_sign = det < 0.0f ? -1.0f : 1.0f;
  const float det_abs = fabsf(det);
  det = det_sign * (det_abs < 1e-12f ? 1e-12f : det_abs);
  const float xc_center = (mxz * (myy - x) - myz * mxy) / det * 0.5f;
  const float yc_center = (myz * (mxx - x) - mxz * mxy) / det * 0.5f;
  const float r = sqrtf(fabsf(xc_center * xc_center + yc_center * yc_center + mz));
  const float curvature = 1.0f / clamp(r, s.radius_min, s.radius_max);

  // orientation: the determinant of the window's first, middle and last points
  const int first_off = first < 0 ? 0 : first;
  const int last_off = first_off + (count - 1 > 0 ? count - 1 : 0);
  const int mid_off = min(first_off + count / 2, last_off);
  const int k0 = rolled(i, first_off, sh, s.p), k1 = rolled(i, mid_off, sh, s.p), k2 = rolled(i, last_off, sh, s.p);
  const float orient = (sx[k1] - sx[k0]) * (sy[k2] - sy[k0]) - (sy[k1] - sy[k0]) * (sx[k2] - sx[k0]);
  const float sign = static_cast<float>((0.0f < orient) - (orient < 0.0f));
  return curvature * sign;
}

// ops/curvature.py::uniform_filter1d_nearest at sample c
__device__ float box_filter_at(int c, int n, int size, const float* curv, const Shape& s) {
  const int sh = s.w / 2, lo = sh - size / 2;
  const float body = torch_sum_last(s.w, [&](int d) {
    const int raw = c - sh + d;
    return d >= lo && d < lo + size && raw >= 0 && raw < n ? curv[rolled(c, d, sh, s.p)] : 0.0f;
  });
  const int n_below = min(max(size / 2 - c, 0), size);
  const int n_above = min(max(c - size / 2 + size - 1 - (n - 1), 0), size);
  const float v_first = curv[0];
  const float v_last = curv[min(max(n - 1, 0), s.p - 1)];
  const float out = (body + static_cast<float>(n_below) * v_first + static_cast<float>(n_above) * v_last) /
                    static_cast<float>(max(size, 1));
  return c < n ? out : 0.0f;
}

__global__ void __launch_bounds__(MAX_P) parameterize_tail_kernel(
    const float* __restrict__ t_int, const int* __restrict__ n_int, const float* __restrict__ coef,
    const float* __restrict__ u_max, const bool* __restrict__ fit_ok, const float* __restrict__ every, Shape s,
    float* __restrict__ out, bool* __restrict__ ok, long long* __restrict__ n_pts, int* __restrict__ indices) {
  __shared__ float t_full[NEST];
  __shared__ float cf[2 * NC];
  __shared__ float sx[MAX_P], sy[MAX_P], curv[MAX_P];
  const int lane = blockIdx.x, i = threadIdx.x;
  const int live = n_int[lane];
  const float um = u_max[lane];

  // ops/fitpack.py::_full_knots: [0 x 4 | live knots, then u_max | u_max x 4]
  for (int k = i; k < NEST; k += blockDim.x) {
    const int j = k - (K + 1);
    t_full[k] = k <= K ? 0.0f : (j < live ? t_int[lane * MAX_INT + j] : um);
  }
  for (int k = i; k < 2 * NC; k += blockDim.x) cf[k] = coef[lane * 2 * NC + k];
  __syncthreads();

  // fitpack_eval_every: u = i * predict_every, valid below u_max, zero past it
  const float pe = every[lane];
  bool valid = false;
  if (i < s.p) {
    const float u = static_cast<float>(i) * pe;
    valid = u < um;
    float x, y;
    spline_at(u, t_full, cf, live, x, y);
    sx[i] = valid ? x : 0.0f;
    sy[i] = valid ? y : 0.0f;
  }
  const int n = __syncthreads_count(valid);

  int window = min(n / 5, 30);
  window += window % 2 == 0 ? 1 : 0;
  if (i < s.p) curv[i] = i < n ? curvature_at(i, n, window, sx, sy, s) : 0.0f;
  __syncthreads();

  // the horizon: linspace(0, n - 1, H) truncated; n - 1 over H - 1 as a product
  if (i < s.h) {
    const float step = static_cast<float>(max(n - 1, 0)) * s.inv_h1;
    const int c = min(max(static_cast<int>(static_cast<float>(i) * step), 0), s.p - 1);
    const int size = max(window / 2, 2);
    float* row = out + (static_cast<long long>(lane) * s.h + i) * 4;
    row[0] = static_cast<float>(c) * pe;
    row[1] = sx[c];
    row[2] = sy[c];
    row[3] = box_filter_at(c, n, size, curv, s);
    indices[lane * s.h + i] = c;
  }
  if (i == 0) {
    ok[lane] = n >= s.h && fit_ok[lane];
    n_pts[lane] = n;
  }
}

}  // namespace

extern "C" int parameterize_tail_f32(const float* t_int, const int* n_int, const float* coef, const float* u_max,
                                     const bool* fit_ok, const float* every, int batch, int p, int w, int h,
                                     int max_iter, float radius_min, float radius_max, float inv_h1, float* out,
                                     bool* ok, long long* n_pts, int* indices, void* stream) {
  if (p < 1 || p > MAX_P || w < 1 || w > MAX_W || w % 2 == 0 || h < 2 || h > p || max_iter < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0) return 0;
  const Shape s{p, w, h, max_iter, radius_min, radius_max, inv_h1};
  const int threads = (max(p, NEST) + 31) / 32 * 32;
  parameterize_tail_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      t_int, n_int, coef, u_max, fit_ok, every, s, out, ok, n_pts, indices);
  return static_cast<int>(cudaGetLastError());
}
