// Cone matching of the planner, on Hopper: the whole stage in one launch.
//
// Replaces no TPU kernel: the JAX package runs matching
// (ft_fsd_path_planning_tpu/models/matching.py) as XLA ops. The port ran
// it as ~1,000 small eager launches a frame and two host reads of the
// insertion loop's trip count; this kernel is models/matching.py::
// run_cone_matching_plain in one launch, with no host read: the side-discard
// guard, the search directions, the candidate gates, the best matches, the
// virtual cones, their shift-insert merge into the other side, the removal
// of sharp kinks, the virtual flags, for both sides, and the final matches
// of the merged sides.
//
// Design:
//
//   * one warp a lane of the batch, four lanes to a block. Thread t holds
//     slot t + 32 q, q < P, of every side array in registers: P = 1 for S <=
//     32 and P = 2 for S <= 64 (a template parameter chosen from S). A
//     value of another slot comes by __shfl_sync (fetch: P shuffles, so
//     each thread may ask for a slot of its own);
//   * counts are __popc of __ballot_sync; a stable compaction finds, for its
//     output slot j, the j-th set bit of the 64-bit ballot of the kept slots
//     (or of the others after them); the insertion order (a stable argsort
//     of the insertees' least distance) is a rank: smaller keys, plus equal
//     keys at a lower index;
//   * a cone's candidates loop over the other side's S cones, each broadcast
//     by shuffle. The plain version keeps the two nearest gated candidates of
//     a cone, but only their any() reaches the result, so the kernel keeps
//     any() (a gated candidate at a finite distance) and the argmin of the
//     masked squared distances, lowest index on ties as torch.argmin;
//   * the sequential shift-insert runs to the last slot its own lane uses:
//     the plain version's loop runs to the last slot any lane uses, and each
//     trip past a lane's own last one has nothing to insert there and changes
//     nothing. The two nearest existing cones of a trip are two (distance,
//     index) warp minima, as the plain version's stable sort orders them.
//
// Arithmetic: this file is compiled with -fmad=false, so no product and sum
// is contracted, and every expression is evaluated in the order the plain
// version writes it, with the functions PyTorch's CUDA ops call: atan2f,
// acosf, sinf, cosf, sqrtf, correctly rounded division. A division by a
// Python scalar runs on the card as a product with the scalar's float32
// reciprocal, so the kernel multiplies where the plain version divides by
// the ellipse radii (the wrapper passes the reciprocals). The squared
// distance is a2 + b2 - 2 ab clamped at 0 as geometry.cdist_sq computes it;
// there ab comes from a matrix product (cuBLAS), here from fmaf(ay, by, ax *
// bx), which may round its last bit otherwise.
//
// What bounds it on an H100 (models/matching.py::kernel_bytes and
// kernel_flops): a lane moves 2 S (8 + 1) + 8 bytes in and 2 S (8 + 1 + 1 +
// 8) out, 1,736 B at S = 32 (0.5 ns at 3.35 TB/s), and needs some 0.34 Mflop
// (four passes of S^2 gated pairs with an atan2 and an acos each, two
// insertion loops of S trips; 5 ns at 67 TFLOP/s): neither bounds it. At one lane the time is the latency of the serial
// chain: the four candidate passes and the two insertion loops, one warp.
// What the design does about it: one launch and no host read in place of
// ~1,000 launches and two syncs; every intermediate stays in registers.
//
// C interface: cone_matching_f32 returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for a side length S outside
// [2, 64] (models/matching.py::kernel_supports).

#include <cuda_runtime.h>
#include <math_constants.h>

// the constants of the plain version, filled by the wrapper
// (models/matching.py::_Consts)
struct Consts {
  float inv_major, inv_minor, max_angle, track_width, half_pi, kink, virt_eps, eps;
  int monotonic;
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // lanes of the batch a block
#define INF CUDART_INF_F

template <int P>
struct Side {
  float x[P], y[P];
  bool m[P];
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp(float v, float lo, float hi) { return v < lo ? lo : (v > hi ? hi : v); }

// the value of slot i (0 <= i < 32 P), which may differ from thread to thread
template <int P, typename T>
__device__ __forceinline__ T fetch(const T (&a)[P], int i) {
  T out = __shfl_sync(FULL, a[0], i & 31);
#pragma unroll
  for (int q = 1; q < P; ++q) {
    const T v = __shfl_sync(FULL, a[q], i & 31);
    if ((i >> 5) == q) out = v;
  }
  return out;
}

template <int P>
__device__ __forceinline__ bool fetch_bool(const bool (&a)[P], int i) {
  int v[P];
#pragma unroll
  for (int q = 0; q < P; ++q) v[q] = a[q];
  return fetch<P>(v, i) != 0;
}

// the ballot of a flag over all 32 P slots, slot i at bit i
template <int P>
__device__ __forceinline__ unsigned long long ballot(const bool (&a)[P]) {
  unsigned long long bits = 0;
#pragma unroll
  for (int q = 0; q < P; ++q) bits |= static_cast<unsigned long long>(__ballot_sync(FULL, a[q])) << (32 * q);
  return bits;
}

template <int P>
__device__ __forceinline__ int count(const bool (&a)[P]) {
  return __popcll(ballot<P>(a));
}

// the index of the n-th (from 0) set bit of m
__device__ __forceinline__ int nth_set(unsigned long long m, int n) {
  for (int k = 0; k < n; ++k) m &= m - 1;
  return __ffsll(static_cast<long long>(m)) - 1;
}

// geometry.vec_angle_between
__device__ __forceinline__ float vec_angle(float ax, float ay, float bx, float by, const Consts& c) {
  const float dot = ax * bx + ay * by;
  const float na = sqrtf(clamp_min(ax * ax + ay * ay, 0.0f));
  const float nb = sqrtf(clamp_min(bx * bx + by * by, 0.0f));
  return acosf(clamp(dot / clamp_min(na * nb, c.eps), -1.0f, 1.0f));
}

// geometry.cdist_sq of one pair (see the note on ab above)
__device__ __forceinline__ float dist_sq(float ax, float ay, float bx, float by) {
  const float a2 = ax * ax + ay * ay;
  const float b2 = bx * bx + by * by;
  const float ab = __fmaf_rn(ay, by, ax * bx);
  return clamp_min(a2 + b2 - 2.0f * ab, 0.0f);
}

// (value, index) of the least value, lowest index on ties: the first two
// entries of a stable sort. An index of 1 << 30 stands for no entry.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// geometry.stable_compact and the gather through its order: the kept slots
// first, in order, then the others, in order. Returns the kept count.
template <int P>
__device__ __forceinline__ int compact(const bool (&keep)[P], int s, float (&x)[P], float (&y)[P]) {
  const unsigned long long all = s == 64 ? ~0ull : ((1ull << s) - 1);
  const unsigned long long kept = ballot<P>(keep) & all;
  const int n = __popcll(kept);
  float nx[P], ny[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int j = lane_id() + 32 * q;
    int src = j;
    if (j < s) src = j < n ? nth_set(kept, j) : nth_set(all & ~kept, j - n);
    nx[q] = fetch<P>(x, src);
    ny[q] = fetch<P>(y, src);
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    x[q] = nx[q];
    y[q] = ny[q];
  }
  return n;
}

// matching.match_search_directions, rotated by theta (+-pi/2)
template <int P>
__device__ void search_directions(const Side<P>& sd, int s, float theta, const Consts& c, float (&dx)[P],
                                  float (&dy)[P]) {
  const int n = count<P>(sd.m);
  const float cr = cosf(theta), sr = sinf(theta);
  const int i0 = max(0, min(n - 2, s - 1)), i1 = max(0, min(n - 1, s - 1)), i2 = max(0, min(min(n - 1, 1), s - 1));
  const float e0x = fetch<P>(sd.x, i0), e0y = fetch<P>(sd.y, i0);
  const float e1x = fetch<P>(sd.x, i1), e1y = fetch<P>(sd.y, i1);
  const float e2x = fetch<P>(sd.x, i2), e2y = fetch<P>(sd.y, i2);
  const float c0x = fetch<P>(sd.x, 0), c0y = fetch<P>(sd.y, 0);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = lane_id() + 32 * q;
    const int ip = max(i - 1, 0), in = min(i + 1, s - 1);
    const float px = fetch<P>(sd.x, ip), py = fetch<P>(sd.y, ip);
    const float nx = fetch<P>(sd.x, in), ny = fetch<P>(sd.y, in);
    const bool first = i == 0;
    const bool last = i == n - 1 && n >= 2;
    const float ax = first ? c0x : (last ? e0x : px), ay = first ? c0y : (last ? e0y : py);
    const float bx = first ? e2x : (last ? e1x : nx), by = first ? e2y : (last ? e1y : ny);
    const float tx = bx - ax, ty = by - ay;
    const float rx = cr * tx - sr * ty, ry = sr * tx + cr * ty;
    const float nrm = clamp_min(sqrtf(clamp_min(rx * rx + ry * ry, 0.0f)), c.eps);
    dx[q] = rx / nrm;
    dy[q] = ry / nrm;
  }
}

// matching._matches_for_side: the match of each cone of `cn` on `ot`, -1
// for none, and the search directions of `cn`. `right` says that `cn` is
// the right side.
template <int P>
__device__ void matches_for_side(const Side<P>& cn, const Side<P>& ot, int s, bool right, const Consts& c,
                                 int (&match)[P], float (&dx)[P], float (&dy)[P]) {
  search_directions<P>(cn, s, right ? c.half_pi : -c.half_pi, c, dx, dy);
  float odx[P], ody[P];
  search_directions<P>(ot, s, right ? -c.half_pi : c.half_pi, c, odx, ody);
  const int n_o = count<P>(ot.m);
  const int n_c = count<P>(cn.m);
  if (n_o <= 1) {  // the other side needs > 1 cones for directions, else zeros
#pragma unroll
    for (int q = 0; q < P; ++q) odx[q] = ody[q] = 0.0f;
  }
  float cr[P], sr[P], a2[P], dn[P], best[P];
  bool has[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const float na = -atan2f(dy[q], dx[q]);
    cr[q] = cosf(na);
    sr[q] = sinf(na);
    a2[q] = cn.x[q] * cn.x[q] + cn.y[q] * cn.y[q];
    dn[q] = sqrtf(clamp_min(dx[q] * dx[q] + dy[q] * dy[q], 0.0f));
    best[q] = INF;
    match[q] = 0;
    has[q] = false;
  }
  for (int n = 0; n < s; ++n) {
    const float ox = fetch<P>(ot.x, n), oy = fetch<P>(ot.y, n);
    const bool om = fetch_bool<P>(ot.m, n);
    const float onx = fetch<P>(odx, n), ony = fetch<P>(ody, n);
    const float b2 = ox * ox + oy * oy;
    const float on = sqrtf(clamp_min(onx * onx + ony * ony, 0.0f));
#pragma unroll
    for (int q = 0; q < P; ++q) {
      // potential_matches_mask: rotated ellipse, half-angle, opposition
      const float vx = ox - cn.x[q], vy = oy - cn.y[q];
      const float rx = cr[q] * vx - sr[q] * vy, ry = sr[q] * vx + cr[q] * vy;
      const float q1 = rx * c.inv_major, q2 = ry * c.inv_minor;
      const bool ellipse = q1 * q1 + q2 * q2 < 1.0f;
      const bool angle_ok = fabsf(atan2f(ry, rx) * 0.5f) <= c.max_angle;
      const float dot = dx[q] * onx + dy[q] * ony;
      const bool opposed = acosf(clamp(dot / clamp_min(dn[q] * on, c.eps), -1.0f, 1.0f)) >= c.half_pi;
      const bool gated = ellipse && angle_ok && opposed && cn.m[q] && om;
      has[q] = has[q] || (gated && sqrtf(vx * vx + vy * vy) < INF);
      // select_best_match: argmin of the masked squared distances
      const float d2 = om ? clamp_min(a2[q] + b2 - 2.0f * __fmaf_rn(cn.y[q], oy, cn.x[q] * ox), 0.0f) : INF;
      if (d2 < best[q]) {
        best[q] = d2;
        match[q] = n;
      }
    }
  }
  if (c.monotonic) {
    // matched >= the cummax of the slots before it
    int cm[P];
    int carry = -1;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      int v = match[q];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(FULL, v, off);
        if (lane_id() >= off) v = max(v, u);
      }
      cm[q] = max(v, carry);
      carry = __shfl_sync(FULL, cm[q], 31);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int prev = fetch<P>(cm, max(lane_id() + 32 * q - 1, 0));
      if (match[q] < prev) match[q] = -1;
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (!(cn.m[q] && has[q] && n_o != 0 && n_c > 1)) match[q] = -1;
  }
}

// matching._insert_virtual_cones: the insertees (ix, iy, im) into the
// trace (bx, by) of `cnt` cones, in place. Returns the new count.
template <int P>
__device__ int insert_cones(float (&bx)[P], float (&by)[P], int cnt, const float (&ix)[P], const float (&iy)[P],
                            const bool (&im)[P], int s, float px, float py, const Consts& c) {
  // insertion order: ascending least squared distance to the existing
  // cones, stable: the rank of each insertee
  float key[P];
#pragma unroll
  for (int q = 0; q < P; ++q) key[q] = INF;
  for (int n = 0; n < s; ++n) {
    const float ex = fetch<P>(bx, n), ey = fetch<P>(by, n);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float d2 = n < cnt ? dist_sq(ix[q], iy[q], ex, ey) : INF;
      if (d2 < key[q]) key[q] = d2;
    }
  }
  int rank[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (!im[q]) key[q] = INF;
    rank[q] = 0;
  }
  for (int u = 0; u < s; ++u) {
    const float ku = fetch<P>(key, u);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int v = lane_id() + 32 * q;
      rank[q] += (ku < key[q] || (ku == key[q] && u < v)) ? 1 : 0;
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (lane_id() + 32 * q >= s) rank[q] = -1;
  }

  for (int k = 0; k < s; ++k) {
    int src = 0;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const unsigned hit = __ballot_sync(FULL, rank[q] == k);
      if (hit) src = 32 * q + __ffs(hit) - 1;
    }
    if (!fetch_bool<P>(im, src)) continue;  // the same on the whole warp
    const float cx = fetch<P>(ix, src), cy = fetch<P>(iy, src);

    // the two nearest existing cones
    float v0 = INF;
    int i0 = 1 << 30;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = lane_id() + 32 * q;
      const float dxx = bx[q] - cx, dyy = by[q] - cy;
      const float d = i < cnt ? sqrtf(dxx * dxx + dyy * dyy) : INF;
      if (d < v0 || (d == v0 && i < i0)) {
        v0 = d;
        i0 = i;
      }
    }
    float v1 = v0;
    int closest = i0;
    warp_argmin(v1, closest);
    v1 = INF;
    int second = 1 << 30;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = lane_id() + 32 * q;
      if (i == closest) continue;
      const float dxx = bx[q] - cx, dyy = by[q] - cy;
      const float d = i < cnt ? sqrtf(dxx * dxx + dyy * dyy) : INF;
      if (d < v1 || (d == v1 && i < second)) {
        v1 = d;
        second = i;
      }
    }
    warp_argmin(v1, second);

    const float n0x = fetch<P>(bx, closest), n0y = fetch<P>(by, closest);
    const float n1x = fetch<P>(bx, second), n1y = fetch<P>(by, second);
    const float f0x = fetch<P>(bx, 0), f0y = fetch<P>(by, 0);
    // a single existing cone: insert by car distance
    const float dcx = cx - px, dcy = cy - py;
    const float dex = f0x - px, dey = f0y - py;
    const int idx_single = sqrtf(dcx * dcx + dcy * dcy) < sqrtf(dex * dex + dey * dey) ? 0 : 1;
    const bool adjacent = abs(closest - second) == 1;
    const bool between = vec_angle(n0x - cx, n0y - cy, n1x - cx, n1y - cy, c) > c.half_pi;
    const int idx_multi = between ? min(closest, second) + 1 : (closest < second ? closest : closest + 1);
    const int idx = cnt == 1 ? idx_single : idx_multi;
    if (!((cnt == 1 || adjacent) && cnt < s)) continue;

    float nx[P], ny[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = lane_id() + 32 * q;
      const float sx = fetch<P>(bx, max(i - 1, 0)), sy = fetch<P>(by, max(i - 1, 0));
      nx[q] = i == idx ? cx : (i > idx ? sx : bx[q]);
      ny[q] = i == idx ? cy : (i > idx ? sy : by[q]);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      bx[q] = nx[q];
      by[q] = ny[q];
    }
    ++cnt;
  }
  return cnt;
}

// matching.combine_and_sort_virtual_with_real: `ot` the real other side,
// `vt` the virtual cones; the result in `out` and `virt`
template <int P>
__device__ void combine(const Side<P>& ot, const Side<P>& vt, int s, float px, float py, const Consts& c,
                        Side<P>& out, bool (&virt)[P]) {
  const int n_o = count<P>(ot.m), n_v = count<P>(vt.m);
  // the larger array hosts, the smaller is inserted; ties host the virtuals
  const bool other_hosts = n_o > n_v;
  float mx[P], my[P], ix[P], iy[P];
  bool im[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    mx[q] = other_hosts ? ot.x[q] : vt.x[q];
    my[q] = other_hosts ? ot.y[q] : vt.y[q];
    ix[q] = other_hosts ? vt.x[q] : ot.x[q];
    iy[q] = other_hosts ? vt.y[q] : ot.y[q];
    im[q] = other_hosts ? vt.m[q] : ot.m[q];
  }
  const int mc = insert_cones<P>(mx, my, other_hosts ? n_o : n_v, ix, iy, im, s, px, py, c);

  // remove sharp kinks: interior angles < 85 deg
  bool keep[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = lane_id() + 32 * q;
    const float ax = fetch<P>(mx, max(i - 1, 0)), ay = fetch<P>(my, max(i - 1, 0));
    const float bx = fetch<P>(mx, min(i + 1, s - 1)), by = fetch<P>(my, min(i + 1, s - 1));
    const float nx = bx - mx[q], ny = by - my[q];  // to_next[i]
    const float tx = mx[q] - ax, ty = my[q] - ay;  // to_next[i - 1]
    const bool low = i >= 1 && i <= s - 2 && i < mc - 1 && mc >= 3 && vec_angle(nx, ny, -tx, -ty, c) < c.kink;
    keep[q] = i < mc && !low;
  }
  const int kc = compact<P>(keep, s, mx, my);

  // virtual flag: farther than epsilon from every real cone
  float near[P];
#pragma unroll
  for (int q = 0; q < P; ++q) near[q] = INF;
  for (int n = 0; n < s; ++n) {
    const float ox = fetch<P>(ot.x, n), oy = fetch<P>(ot.y, n);
    if (!fetch_bool<P>(ot.m, n)) continue;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float d2 = dist_sq(mx[q], my[q], ox, oy);
      if (d2 < near[q]) near[q] = d2;
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int j = lane_id() + 32 * q;
    const bool merged_m = j < kc;
    const bool is_virtual = merged_m && near[q] > c.virt_eps;
    // degenerate cases: no real cones, no virtual cones
    if (n_o == 0) {
      out.x[q] = vt.x[q];
      out.y[q] = vt.y[q];
      out.m[q] = vt.m[q];
      virt[q] = vt.m[q];
    } else if (n_v == 0) {
      out.x[q] = ot.x[q];
      out.y[q] = ot.y[q];
      out.m[q] = ot.m[q];
      virt[q] = false;
    } else {
      out.x[q] = mx[q];
      out.y[q] = my[q];
      out.m[q] = merged_m;
      virt[q] = is_virtual;
    }
  }
}

// matching._cones_for_other_side: the other side `ot` with the virtual
// cones of `cn`'s unmatched cones merged in
template <int P>
__device__ void cones_for_other_side(const Side<P>& cn, const Side<P>& ot, int s, bool right, float px, float py,
                                     const Consts& c, Side<P>& out, bool (&virt)[P]) {
  int match[P];
  float dx[P], dy[P];
  matches_for_side<P>(cn, ot, s, right, c, match, dx, dy);
  Side<P> vt;
  bool unmatched[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    unmatched[q] = match[q] == -1 && cn.m[q];
    vt.x[q] = cn.x[q] + dx[q] * c.track_width;
    vt.y[q] = cn.y[q] + dy[q] * c.track_width;
  }
  const int nv = compact<P>(unmatched, s, vt.x, vt.y);
#pragma unroll
  for (int q = 0; q < P; ++q) vt.m[q] = lane_id() + 32 * q < nv;
  combine<P>(ot, vt, s, px, py, c, out, virt);
  // < 2 combined -> keep the plain other side; this side needs >= 2 cones
  if (count<P>(out.m) < 2 || count<P>(cn.m) < 2) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      out.x[q] = ot.x[q];
      out.y[q] = ot.y[q];
      out.m[q] = ot.m[q];
      virt[q] = false;
    }
  }
}

template <int P>
__global__ void __launch_bounds__(32 * WARPS) cone_matching_kernel(
    const float* __restrict__ left, const bool* __restrict__ left_mask, const float* __restrict__ right,
    const bool* __restrict__ right_mask, const float* __restrict__ position, float* __restrict__ out_left,
    bool* __restrict__ out_left_mask, bool* __restrict__ out_left_virtual, float* __restrict__ out_right,
    bool* __restrict__ out_right_mask, bool* __restrict__ out_right_virtual, long long* __restrict__ out_l2r,
    long long* __restrict__ out_r2l, int batch, int s, Consts c) {
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= batch) return;  // the whole warp
  const long long base = static_cast<long long>(b) * s;
  Side<P> l, r;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = lane_id() + 32 * q;
    const bool in = i < s;
    l.x[q] = in ? left[2 * (base + i)] : 0.0f;
    l.y[q] = in ? left[2 * (base + i) + 1] : 0.0f;
    l.m[q] = in && left_mask[base + i];
    r.x[q] = in ? right[2 * (base + i)] : 0.0f;
    r.y[q] = in ? right[2 * (base + i) + 1] : 0.0f;
    r.m[q] = in && right_mask[base + i];
  }
  const float px = position[2 * b], py = position[2 * b + 1];

  // side-discard guard
  const int n_l = count<P>(l.m), n_r = count<P>(r.m);
  const int min_len = min(n_l, n_r), max_len = max(n_l, n_r);
  const bool discard = min_len == 0 || max_len > 2 * min_len;
  const bool drop_left = discard && n_l < n_r;
  const bool drop_right = discard && !(n_l < n_r);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    l.m[q] = l.m[q] && !drop_left;
    r.m[q] = r.m[q] && !drop_right;
  }

  Side<P> rw, lw;
  bool rv[P], lv[P];
  cones_for_other_side<P>(l, r, s, false, px, py, c, rw, rv);
  cones_for_other_side<P>(r, l, s, true, px, py, c, lw, lv);
  int l2r[P], r2l[P];
  float dx[P], dy[P];
  matches_for_side<P>(lw, rw, s, false, c, l2r, dx, dy);
  matches_for_side<P>(rw, lw, s, true, c, r2l, dx, dy);

  // both sides < 2 -> empty result
  const bool live = !(n_l < 2 && n_r < 2);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = lane_id() + 32 * q;
    if (i >= s) continue;
    out_left[2 * (base + i)] = lw.x[q];
    out_left[2 * (base + i) + 1] = lw.y[q];
    out_right[2 * (base + i)] = rw.x[q];
    out_right[2 * (base + i) + 1] = rw.y[q];
    out_left_mask[base + i] = live && lw.m[q];
    out_left_virtual[base + i] = live && lv[q];
    out_right_mask[base + i] = live && rw.m[q];
    out_right_virtual[base + i] = live && rv[q];
    out_l2r[base + i] = live ? l2r[q] : -1;
    out_r2l[base + i] = live ? r2l[q] : -1;
  }
}

}  // namespace

extern "C" int cone_matching_f32(const float* left, const bool* left_mask, const float* right,
                                 const bool* right_mask, const float* position, float* out_left,
                                 bool* out_left_mask, bool* out_left_virtual, float* out_right,
                                 bool* out_right_mask, bool* out_right_virtual, long long* out_l2r,
                                 long long* out_r2l, int batch, int s, const Consts* consts, void* stream) {
  if (s < 2 || s > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  const dim3 grid((batch + WARPS - 1) / WARPS), block(32 * WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 32) {
    cone_matching_kernel<1><<<grid, block, 0, st>>>(left, left_mask, right, right_mask, position, out_left,
                                                    out_left_mask, out_left_virtual, out_right, out_right_mask,
                                                    out_right_virtual, out_l2r, out_r2l, batch, s, *consts);
  } else {
    cone_matching_kernel<2><<<grid, block, 0, st>>>(left, left_mask, right, right_mask, position, out_left,
                                                    out_left_mask, out_left_virtual, out_right, out_right_mask,
                                                    out_right_virtual, out_l2r, out_r2l, batch, s, *consts);
  }
  return static_cast<int>(cudaGetLastError());
}
