// FITPACK's part 2 for the spline engine, on Hopper: one launch a fit.
//
// Replaces no TPU kernel. The JAX package runs this part as a vmapped
// lax.while_loop (ft_fsd_path_planning_tpu/ops/fitpack.py::_root_rati); the
// port's plain version (ops/fitpack.py::fitpack_part2_plain, the CPU's path)
// is a masked loop of eager PyTorch kernels whose condition the host reads
// every trip. Here every lane, one trace, runs the whole of it to its own
// end on the card:
//
//   * the gate: a lane with no interior knot, or whose least-squares spline
//     already sits within acc of s, returns c_lsq and makes no trip;
//   * the design on the final knots: the span and the four nonzero cubic
//     B-spline values of every live site (de Boor, as _basis4);
//   * the normal equations G = B^T B with _normal_eqs' jitter and padded
//     identity, and B^T y, as a band of half-bandwidth 4;
//   * the initial p = (n_int + 4) / sum(diag(chol(G))) over the live
//     coefficients, the factor from kernel B1's device code;
//   * the penalty D^T D from fpdisc's rows (_disc_matrix), as a band;
//   * FITPACK's p-iteration (fpcurf.f:229-330, _root_rati), up to kMaxIt
//     trips: A = G + D^T D / p^2, B1's refined solve, fp over the live sites
//     from the four basis terms, then the convergence test, branch 1, branch
//     2, the monotonicity stop and the rational step (fprati); a trial that
//     is not finite takes branch 2's step (too_small_p).
//
// The lane writes its coefficients and its trip count: the loop-condition
// checks its own loop makes, the one that ends it included (0 for a gated
// lane), which is what the plain version's masked loop counts for that lane.
//
// Arithmetic. float32 throughout, no tensor cores, built with -fmad=false, so
// it differs from its plain version only in the order of its sums (B^T B,
// B^T y, D^T D, the trace, fp) and in the initial p, which takes B1's factor
// (pivot clamped at 1e-20, rows scaled by the reciprocal of the diagonal)
// where the plain version factors on its own (clamped at 1e-30, rows
// divided by the diagonal). The solves are B1's refined solve operation for
// operation. A trial counts as not finite where the plain version's fp is
// not finite: fp itself, or any entry of the solution, since the plain
// version's dense product B c carries a non-finite coefficient into every
// site.
//
// Design. One warp a lane and a block a warp: the grid is the batch (1 on
// the facade, 256 on a sweep), so each lane ends on its own trip and not on
// the slowest lane's. The sites are spread over the 32 threads for the
// basis, the sums over sites and fp: each thread sums its own sites (m =
// lane, lane + 32, ...) into its own slice of shared memory, and the slices
// are added in thread order, or, for fp, by a butterfly of shuffles, which
// gives every thread the same bits. The scalar branch logic then runs in
// every thread on the same values, with no divergence and no broadcast.
// What is serial along the 28 band rows (the factor and the substitutions)
// is B1's code. The sites, their basis values and spans, the bands and the
// solver's scratch live in shared memory: (6,768 + 8 M) floats, 43 KB at
// M = 512; M is a run-time value up to kMaxSites. The inputs are staged
// with cp.async.
//
// What bounds it on an H100: a lane reads its M sites and points once
// (12 B a site) and does ~30 flop a site for the normal equations and ~20
// a site a trip for fp: at M = 512 and 9 trips ~0.12 Mflop and 6 KB, far
// below a microsecond of the card's peaks. The serial chain of B1's
// factorisation and substitutions in every trip and the launch bound it.
//
// C interface: fitpack_part2_f32 returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for M outside 1..kMaxSites.

#include <cuda_runtime.h>

#include "banded_cholesky.cuh"

namespace {

using namespace banded;

constexpr int kK = 3;                         // cubic splines
constexpr int kMaxInt = 24;                   // interior-knot budget (MAX_INT)
constexpr int kNc = kMaxInt + kK + 1;         // coefficient budget (NC, 28)
constexpr int kNest = kMaxInt + 2 * (kK + 1); // padded full knot vector (32)
constexpr int kMaxIt = 20;                    // FITPACK's maxit (MAXIT)
constexpr int kMaxSites = 4096;
constexpr float kCon1 = 0.1f, kCon4 = 0.04f, kCon9 = 0.9f;  // fprati constants (fpcurf.f:27)
constexpr float kEpsDiag = 1e-6f;
constexpr float kTiny = 1e-30f;

// per-thread partial sums: G's lower band (row * 4 + k holds G[row, row - k])
// then B^T y (kNc * 4 + row * 2 + d), padded against bank conflicts
constexpr int kPartial = kNc * 4 + kNc * 2;
constexpr int kPartialStride = kPartial + 1;

// shared memory, in floats: B1's solver block (band, l, inv, b, y, x, res,
// kPad, in B1's order), G's band, D^T D's band, diag(chol(G)), the best
// coefficients, the full knots, D's rows, the partial sums; then per site
// u, the points, the four basis values and the span
constexpr int kSolver = (kBand + kHalf + 1) * kNc + 4 * 2 * kNc + kPad;
constexpr int kFixed = kSolver + 2 * kBand * kNc + kNc + 2 * kNc + kNest + kMaxInt * (kK + 2) +
                       kThreads * kPartialStride;
static_assert(kFixed % 4 == 0, "the per-site arrays start 16-byte aligned");

__host__ __device__ inline int padded_sites(int m) { return (m + 3) / 4 * 4; }
__host__ __device__ inline int part2_floats(int m) { return kFixed + 8 * padded_sites(m); }

// fprati.f: the root of the rational interpolant r(p) = (u p + v) / (p + w)
// through (p1, f1), (p2, f2), (p3, f3); p3 = infinity where p3_inf.
__device__ float fprati(float p1, float f1, float p2, float f2, float p3, float f3, bool p3_inf) {
  const float h1 = f1 * (f2 - f3);
  const float h2 = f2 * (f3 - f1);
  const float h3 = f3 * (f1 - f2);
  const float d_inf = fabsf(h3) > kTiny ? h3 : kTiny;
  const float p_inf = -(p2 * h1 + p1 * h2) / d_inf;
  float den = p1 * h1 + p2 * h2 + p3 * h3;
  den = fabsf(den) > kTiny ? den : kTiny;
  const float p_fin = -(p1 * p2 * h3 + p2 * p3 * h1 + p1 * p3 * h2) / den;
  return p3_inf ? p_inf : p_fin;
}

// Branch 2's step, after a trial whose p was too small: a larger p that
// falls back inside the bracket where it would reach p3 (fpcurf.f:
// if(p.ge.p3)). A trial whose float32 factorisation broke down (its solution
// or fp not finite) takes it too, keeping its bracket and carry: D^T D / p^2
// shrinks and the system becomes solvable. The same rule as the plain
// version's p_b2 in _root_rati, and the one place to change it here.
__device__ float too_small_p(float p, float p3, bool p3_inf) {
  const float p_next = p / kCon4;
  return (!p3_inf && p_next >= p3) ? p * kCon1 + p3 * kCon9 : p_next;
}

__global__ void __launch_bounds__(kThreads)
fitpack_part2_kernel(const float* __restrict__ u, const float* __restrict__ pts,
                     const unsigned char* __restrict__ mask, const float* __restrict__ t_int,
                     const int* __restrict__ n_int, const float* __restrict__ u_max,
                     const float* __restrict__ c_lsq, const float* __restrict__ fp0,
                     const float* __restrict__ fp_lsq, float s, float acc, int m,
                     float* __restrict__ coef, int* __restrict__ trips_out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int sys = blockIdx.x;
  const int n = n_int[sys];
  const float fpms = fp_lsq[sys] - s;
  const float* c0 = c_lsq + static_cast<size_t>(sys) * kNc * 2;
  float* out = coef + static_cast<size_t>(sys) * kNc * 2;

  // the gate: FITPACK returns the least-squares spline
  if (n == 0 || fabsf(fpms) < acc) {
    for (int e = lane; e < kNc * 2; e += kThreads) out[e] = c0[e];
    if (lane == 0) trips_out[sys] = 0;
    return;
  }

  const int mp = padded_sites(m);
  float* band = smem;                    // B1's solver block: A's band ...
  float* l = band + kBand * kNc;
  float* inv = l + kHalf * kNc;
  float* rhs = inv + kNc;                // ... B^T y ...
  float* y = rhs + 2 * kNc;
  float* x = y + 2 * kNc;                // ... the solution
  float* res = x + 2 * kNc;
  float* gband = smem + kSolver;         // G + jitter, band[i * 9 + d] = G[i, i - 4 + d]
  float* dband = gband + kBand * kNc;    // D^T D
  float* gdiag = dband + kBand * kNc;    // diag(chol(G))
  float* best = gdiag + kNc;             // the coefficients the lane returns
  float* t = best + 2 * kNc;             // full knots [0 * 4 | t_int | u_max * rest]
  float* dv = t + kNest;                 // D[j, j + col] at j * 5 + col
  float* partial = dv + kMaxInt * (kK + 2);
  float* us = smem + kFixed;             // the sites' chord parameters
  float* ps = us + mp;                   // their points (x, y)
  float* vals = ps + 2 * mp;             // four basis values a site
  int* span = reinterpret_cast<int*>(vals + 4 * mp);  // knot interval, -1 for a padded site

  stage(us, u + static_cast<size_t>(sys) * m, m, lane);
  stage(ps, pts + static_cast<size_t>(sys) * 2 * m, 2 * m, lane);
  const float um = u_max[sys];
  {
    const int i = lane;  // kNest == kThreads: one knot a thread
    t[i] = i < kK + 1 ? 0.0f : (i < kK + 1 + kMaxInt ? (i - kK - 1 < n ? t_int[sys * kMaxInt + i - kK - 1] : um) : um);
  }
  for (int e = 0; e < kPartial; ++e) partial[lane * kPartialStride + e] = 0.0f;
  copy_async_wait();
  __syncwarp();

  // the design: span and basis values of each live site, summed into this
  // thread's G and B^T y
  const unsigned char* mk = mask + static_cast<size_t>(sys) * m;
  float* mine = partial + lane * kPartialStride;
  for (int i = lane; i < m; i += kThreads) {
    if (!mk[i]) {
      span[i] = -1;
      continue;
    }
    const float xs = us[i];
    int sp = kK;
    for (int j = 0; j < n; ++j) sp += xs >= t[kK + 1 + j];
    // de Boor's basis_funs, degree 3 (The NURBS Book A2.2), as _basis4
    float v[kK + 1] = {1.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int deg = 1; deg <= kK; ++deg) {
      float saved = 0.0f;
#pragma unroll
      for (int r = 0; r < deg; ++r) {
        const float rt = t[sp + r + 1] - xs;
        const float lf = xs - t[sp + 1 - deg + r];
        float den = rt + lf;
        den = fabsf(den) > kTiny ? den : 1.0f;
        const float tmp = v[r] / den;
        v[r] = saved + rt * tmp;
        saved = lf * tmp;
      }
      v[deg] = saved;
    }
    span[i] = sp;
#pragma unroll
    for (int r = 0; r <= kK; ++r) vals[i * 4 + r] = v[r];
    const float y0 = ps[2 * i], y1 = ps[2 * i + 1];
#pragma unroll
    for (int r = 0; r <= kK; ++r) {
      const int row = sp - kK + r;
#pragma unroll
      for (int q = 0; q <= r; ++q) mine[row * 4 + (r - q)] += v[r] * v[q];
      mine[kNc * 4 + row * 2] += v[r] * y0;
      mine[kNc * 4 + row * 2 + 1] += v[r] * y1;
    }
  }

  // D's rows (fpdisc.f, _disc_matrix): row j < n covers coefficients
  // j .. j + 4, with FITPACK's normalisation
  const float q = um / static_cast<float>(n + 1);
  const float scale = q * q * q;
  for (int e = lane; e < kMaxInt * (kK + 2); e += kThreads) {
    const int j = e / (kK + 2), i = j + e % (kK + 2), jk = j + kK + 1;
    float val = 0.0f;
    if (j < n) {
      float prod = 1.0f;
#pragma unroll
      for (int r = 0; r < kK + 2; ++r) prod = prod * (i + r == jk ? 1.0f : t[jk] - t[i + r]);
      prod = fabsf(prod) > kTiny ? prod : 1.0f;
      val = (t[i + kK + 1] - t[i]) / prod * scale;
    }
    dv[e] = val;
  }
  __syncwarp();

  // the threads' sums added in thread order: G's band (symmetric, offsets
  // up to 3) and B^T y; the entries outside both bands' reach stay 0
  for (int e = lane; e < kNc * kBand; e += kThreads) gband[e] = dband[e] = 0.0f;
  __syncwarp();
  for (int e = lane; e < kPartial; e += kThreads) {
    float acc_e = 0.0f;
    for (int th = 0; th < kThreads; ++th) acc_e += partial[th * kPartialStride + e];
    if (e < kNc * 4) {
      const int row = e / 4, k = e % 4;
      if (row - k >= 0) {
        gband[row * kBand + kHalf - k] = acc_e;
        gband[(row - k) * kBand + kHalf + k] = acc_e;
      }
    } else {
      rhs[e - kNc * 4] = acc_e;
    }
  }
  // D^T D's band: entry (a, a - k) sums D[j, a] D[j, a - k] over j ascending
  for (int e = lane; e < kNc * (kHalf + 1); e += kThreads) {
    const int a = e / (kHalf + 1), k = e % (kHalf + 1), b = a - k;
    if (b < 0) continue;
    float acc_e = 0.0f;
    const int j_hi = b < n - 1 ? b : n - 1;
    for (int j = a - kHalf > 0 ? a - kHalf : 0; j <= j_hi; ++j) acc_e += dv[j * (kK + 2) + a - j] * dv[j * (kK + 2) + b - j];
    dband[a * kBand + kHalf - k] = acc_e;
    if (k > 0) dband[b * kBand + kHalf + k] = acc_e;
  }
  __syncwarp();

  // _normal_eqs: the live diagonal gets 1e-6 of the mean trace, the padded
  // coefficients the mean trace itself
  const int nc_live = n + kK + 1;
  float tr = 0.0f;
  for (int i = 0; i < kNc; ++i) tr += gband[i * kBand + kHalf];
  tr = tr / static_cast<float>(nc_live);
  __syncwarp();
  if (lane < kNc) gband[lane * kBand + kHalf] += lane < nc_live ? kEpsDiag * tr : tr;
  __syncwarp();

  // the initial p from B1's factor of G
  for (int e = lane; e < kNc * kBand; e += kThreads) band[e] = gband[e];
  __syncwarp();
  factor_and_forward<2, true>(band, rhs, l, inv, y, kNc, lane, lane < 2 ? lane : 0, gdiag);
  __syncwarp();
  float diag_sum = 0.0f;
  for (int i = 0; i < nc_live; ++i) diag_sum += gdiag[i];
  float p = static_cast<float>(nc_live) / (diag_sum < kTiny ? kTiny : diag_sum);

  // the p-iteration: f1 at p = 0 (the polynomial), f3 at p = inf (the
  // least-squares spline on these knots)
  float p1 = 0.0f, f1 = fp0[sys] - s, p3 = 0.0f, f3 = fpms;
  bool p3_inf = true, ich1 = false, ich3 = false, done = false;
  for (int e = lane; e < kNc * 2; e += kThreads) best[e] = c0[e];
  int trips = 0;
  for (int it = 0; it < kMaxIt; ++it) {
    ++trips;
    if (done) break;
    const float pp = p * p;
    for (int e = lane; e < kNc * kBand; e += kThreads) band[e] = gband[e] + dband[e] / pp;
    __syncwarp();
    solve<2, true>(band, rhs, l, inv, y, x, res, kNc, lane);

    bool finite = true;
    for (int e = lane; e < kNc * 2; e += kThreads) {
      finite = finite && isfinite(x[e]);
      if (e >= 2 * nc_live) x[e] = x[e] * 0.0f;  // the padded coefficients
    }
    finite = __all_sync(0xffffffffu, finite);
    __syncwarp();
    float fp = 0.0f;
    for (int i = lane; i < m; i += kThreads) {
      const int sp = span[i];
      if (sp < 0) continue;
      const float* v = vals + i * 4;
      const float* c = x + (sp - kK) * 2;
      const float e0 = v[0] * c[0] + v[1] * c[2] + v[2] * c[4] + v[3] * c[6] - ps[2 * i];
      const float e1 = v[0] * c[1] + v[1] * c[3] + v[2] * c[5] + v[3] * c[7] - ps[2 * i + 1];
      fp += e0 * e0 + e1 * e1;
    }
#pragma unroll
    for (int o = kThreads / 2; o > 0; o /= 2) fp += __shfl_xor_sync(0xffffffffu, fp, o);
    const float f2 = fp - s;

    if (!finite || !isfinite(f2)) {
      p = too_small_p(p, p3, p3_inf);
      __syncwarp();
      continue;
    }
    for (int e = lane; e < kNc * 2; e += kThreads) best[e] = x[e];
    __syncwarp();
    if (fabsf(f2) < acc) {
      done = true;
      continue;
    }
    // branch 1: the initial p was too large (f2 barely above f3)
    const bool b1 = !ich3 && f2 - f3 <= acc;
    float p_b1 = p * kCon4;
    if (p_b1 <= p1) p_b1 = p1 * kCon9 + p * kCon1;
    const bool ich3_set = !ich3 && !b1 && f2 < 0.0f;
    // branch 2: the initial p was too small
    const bool b2 = !b1 && !ich1 && f1 - f2 <= acc;
    const bool ich1_set = !b1 && !ich1 && !b2 && f2 > 0.0f;
    // the monotonicity test fails: stop with this spline (FITPACK's ier = 2)
    const bool mono_bad = !b1 && !b2 && (f1 <= f2 || f2 <= f3);
    if (b1) {
      p3 = p;
      f3 = f2;
      p3_inf = false;
      p = p_b1;
    } else if (b2) {
      p1 = p;
      f1 = f2;
      p = too_small_p(p, p3, p3_inf);
    } else if (mono_bad) {
      done = true;
    } else {  // the rational step
      const float p_new = fprati(p1, f1, p, f2, p3, f3, p3_inf);
      if (f2 < 0.0f) {
        p3 = p;
        f3 = f2;
        p3_inf = false;
      } else {
        p1 = p;
        f1 = f2;
      }
      p = p_new;
    }
    ich1 = ich1 || ich1_set;
    ich3 = ich3 || ich3_set;
  }

  for (int e = lane; e < kNc * 2; e += kThreads) out[e] = best[e];
  if (lane == 0) trips_out[sys] = trips;
}

}  // namespace

extern "C" int fitpack_part2_f32(const float* u, const float* pts, const unsigned char* mask, const float* t_int,
                                 const int* n_int, const float* u_max, const float* c_lsq, const float* fp0,
                                 const float* fp_lsq, float s, float acc, int batch, int m, float* coef,
                                 int* trips, void* stream) {
  if (batch <= 0) return 0;
  if (m < 1 || m > kMaxSites) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = sizeof(float) * part2_floats(m);
  if (shared > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory has to be allowed first, on
    // the current device: allow what kMaxSites needs
    const cudaError_t err = cudaFuncSetAttribute(fitpack_part2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(sizeof(float) * part2_floats(kMaxSites)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fitpack_part2_kernel<<<batch, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      u, pts, mask, t_int, n_int, u_max, c_lsq, fp0, fp_lsq, s, acc, m, coef, trips);
  return static_cast<int>(cudaGetLastError());
}
