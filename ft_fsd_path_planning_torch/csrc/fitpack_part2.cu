// FITPACK's parts 1 and 2 for the spline engine, on Hopper: one launch a fit.
//
// Replaces no TPU kernel. The JAX package runs both parts as vmapped
// lax.while_loops (ft_fsd_path_planning_tpu/ops/fitpack.py::fitpack_fit and
// _root_rati); the port's plain version (ops/fitpack.py::fitpack_parts12_plain,
// the CPU's path) is a set of masked loops of eager PyTorch kernels whose
// conditions the host reads every trip: on the card some 500 launches and one
// host sync a trip of a fit. Here every lane, one trace, runs all of it to
// its own end on the card. The entry, fitpack_fit_f32, starts from iteration
// 0 of part 1, the least-squares polynomial on the empty knot set, which the
// caller solves eagerly (its coefficients c0, its SSR fp0 and its residual a
// site), and runs:
//
//   * the tiny-input closed form (_tiny_fit) for a lane with 4 live sites or
//     fewer: the interpolating polynomial as Bezier control points;
//   * part 1 (fpcurf.f:140-215): the done test on fp0, then the interval
//     statistics fpint/nrdata of the residuals (_interval_stats) and the
//     first knot insertion, then up to kOuter trips of: the design on the
//     current knots, the normal equations, the least-squares solve as the
//     plain version makes it (B1's refined solve, the residual against G and
//     B1's refined solve of that), the residuals and fp, the done and budget
//     tests, FITPACK's nplus update, the interval statistics and up to
//     min(nplus, kNplusMax) knot insertions (fpknot: the worst interval that
//     holds a site, the count-median site inside it, the sorted insert, the
//     proportional split of fpint/nrdata);
//   * part 2 on the final knots, as below, reusing the last trip's design and
//     normal equations (the knots of that trip are the final ones);
//
// and writes the knots, their count, the coefficients, budget_hit and the
// trips a lane (part 1's, part 2's).
//
// Part 2 (fpcurf.f:229-330):
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
//   * FITPACK's p-iteration (_root_rati), up to kMaxIt trips: A = G + D^T D
//     / p^2, B1's refined solve, fp over the live sites from the four basis
//     terms, then the convergence test, branch 1, branch 2, the monotonicity
//     stop and the rational step (fprati); a trial that is not finite takes
//     branch 2's step (too_small_p).
//
// A lane's trips are the loop-condition checks its own loop would make, the
// one that ends it included (0 for a gated lane) in part 2, and its
// least-squares solves after iteration 0 in part 1: what the plain version's
// masked loops count for that lane.
//
// Arithmetic. float32 throughout, no tensor cores, built with -fmad=false, so
// it differs from its plain version only in the order of its sums (B^T B,
// B^T y, B c, the residual G c, fp, fpint, D^T D, the trace, the tiny fit's
// 4 x 4 system) and in part 2's initial p, which takes B1's factor (pivot
// clamped at 1e-20, rows scaled by the reciprocal of the diagonal) where the
// plain version factors on its own (clamped at 1e-30, rows divided by the
// diagonal). The solves are B1's refined solve operation for operation. The
// knots are data sites, copied: both sides place the same knots wherever they
// take the same decisions, and a decision parts ways only on a near-tie
// (two intervals' fpint, fp against s, nplus's quotient at a whole number).
// A trial counts as not finite where the plain version's fp is not finite:
// fp itself, or any entry of the solution, since the plain version's dense
// product B c carries a non-finite coefficient into every site.
//
// Design. One warp a lane and a block a warp: the grid is the batch (1 on
// the facade, 256 on a sweep), so each lane ends on its own trip and not on
// the slowest lane's. The sites are spread over the 32 threads for the
// basis, the sums over sites, the residuals and the interval statistics:
// each thread sums its own sites (m = lane, lane + 32, ...) into its own
// slice of shared memory, and the slices are added in thread order, or, for
// fp, by a butterfly of shuffles, which gives every thread the same bits.
// The count-median site of an interval is found 32 sites at a time by a
// ballot in site order. The scalar logic (the tests, nplus, the argmax of
// fpint, fprati) runs in every thread on the same values, with no divergence
// and no broadcast. What is serial along the 28 band rows (the factor and
// the substitutions) is B1's code. The sites, their residuals, basis values
// and spans, the bands, the knots, the interval tables and the solver's
// scratch live in shared memory: (6,900 + 9 M) floats, 46 KB at M = 512,
// 175 KB at kMaxSites; M is a run-time value up to kMaxSites. The inputs are
// staged with cp.async.
//
// What bounds it on an H100: a lane reads its M sites, points and residuals
// once (16 B a site) and does ~80 flop a site a part-1 trip (the basis, the
// normal equations, the residuals, the statistics) and ~20 a site a part-2
// trip: at M = 512, 5 part-1 and 9 part-2 trips ~0.3 Mflop and 8 KB, far
// below a microsecond of the card's peaks. The serial chain of B1's
// factorisation and substitutions, two solves a part-1 trip and one a part-2
// trip, and the launch bound it.
//
// C interface: fitpack_fit_f32 returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for M outside 1..kMaxSites.

#include <cuda_runtime.h>

#include "banded_cholesky.cuh"

namespace {

using namespace banded;

constexpr int kK = 3;                         // cubic splines
constexpr int kMaxInt = 24;                   // interior-knot budget (MAX_INT)
constexpr int kNc = kMaxInt + kK + 1;         // coefficient budget (NC, 28)
constexpr int kNest = kMaxInt + 2 * (kK + 1); // padded full knot vector (32)
constexpr int kNi = kMaxInt + 1;              // knot-interval budget (NI)
constexpr int kOuter = 16;                    // part-1 trips (OUTER)
constexpr int kNplusMax = 8;                  // knot insertions a trip (NPLUS_MAX)
constexpr int kMaxIt = 20;                    // FITPACK's maxit (MAXIT)
constexpr int kMaxSites = 4096;
constexpr float kCon1 = 0.1f, kCon4 = 0.04f, kCon9 = 0.9f;  // fprati constants (fpcurf.f:27)
constexpr float kEpsDiag = 1e-6f;
constexpr float kTiny = 1e-30f;
constexpr float kBig = 3.0e38f;               // the pad of the interior knots (_BIG)
constexpr unsigned kAll = 0xffffffffu;

// per-thread partial sums: G's lower band (row * 4 + k holds G[row, row - k])
// then B^T y (kNc * 4 + row * 2 + d); the interval statistics reuse the
// first 2 * kNi (fpint, then nrdata). Padded against bank conflicts
constexpr int kPartial = kNc * 4 + kNc * 2;
constexpr int kPartialStride = kPartial + 1;
static_assert(2 * kNi <= kPartial, "the interval statistics fit in a thread's partial sums");

// shared memory, in floats: B1's solver block (band, l, inv, b, y, x, res,
// kPad, in B1's order), G's band, D^T D's band, diag(chol(G)), B^T y, the
// coefficients, the full knots, the interior knots, D's rows, fpint, nrdata,
// the partial sums; then per site u, the points, the four basis values, the
// span and the residual
constexpr int kSolver = (kBand + kHalf + 1) * kNc + 4 * 2 * kNc + kPad;
constexpr int kTables = 2 * kBand * kNc + kNc + 2 * kNc + 2 * kNc + kNest + kMaxInt + kMaxInt * (kK + 2) + 2 * kNi;
constexpr int kFixedRaw = kSolver + kTables + kThreads * kPartialStride;
constexpr int kFixed = (kFixedRaw + 3) / 4 * 4;
static_assert(kFixed % 4 == 0, "the per-site arrays start 16-byte aligned");

__host__ __device__ inline int padded_sites(int m) { return (m + 3) / 4 * 4; }
__host__ __device__ inline int fit_floats(int m) { return kFixed + 9 * padded_sites(m); }

// One lane's arrays in shared memory and its inputs.
struct Lane {
  float *band, *l, *inv, *rhs, *y, *x, *res;  // B1's solver block; rhs is the b it solves for
  float *gband;   // G + jitter, gband[i * 9 + d] = G[i, i - 4 + d]
  float *dband;   // D^T D
  float *gdiag;   // diag(chol(G))
  float *grhs;    // B^T y
  float *coef;    // the least-squares spline, then part 2's best coefficients
  float *t;       // full knots [0 * 4 | interior | u_max * rest]
  float *tint;    // interior knots, ascending, pad kBig
  float *dv;      // D[j, j + col] at j * 5 + col
  float *fpint;   // residual sum of each knot interval
  int *nrdata;    // sites strictly inside each knot interval
  float *partial;
  float *us, *ps, *vals, *resid;  // a site: chord parameter, point, basis values, squared residual
  int *span;      // a site's knot interval + kK, -1 for a padded site
  const unsigned char *mk;
  int m;
};

__device__ Lane lane_arrays(float* smem, const unsigned char* mask, int sys, int m) {
  Lane L;
  L.band = smem;
  L.l = L.band + kBand * kNc;
  L.inv = L.l + kHalf * kNc;
  L.rhs = L.inv + kNc;
  L.y = L.rhs + 2 * kNc;
  L.x = L.y + 2 * kNc;
  L.res = L.x + 2 * kNc;
  L.gband = smem + kSolver;
  L.dband = L.gband + kBand * kNc;
  L.gdiag = L.dband + kBand * kNc;
  L.grhs = L.gdiag + kNc;
  L.coef = L.grhs + 2 * kNc;
  L.t = L.coef + 2 * kNc;
  L.tint = L.t + kNest;
  L.dv = L.tint + kMaxInt;
  L.fpint = L.dv + kMaxInt * (kK + 2);
  L.nrdata = reinterpret_cast<int*>(L.fpint + kNi);
  L.partial = L.fpint + 2 * kNi;
  const int mp = padded_sites(m);
  L.us = smem + kFixed;
  L.ps = L.us + mp;
  L.vals = L.ps + 2 * mp;
  L.resid = L.vals + 4 * mp;
  L.span = reinterpret_cast<int*>(L.resid + mp);
  L.mk = mask + static_cast<size_t>(sys) * m;
  L.m = m;
  return L;
}

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

// float32 -> int32 truncation that saturates like XLA's convert, NaN -> 0
// (_f32_to_i32)
__device__ int f32_to_i32(float v) {
  if (isnan(v)) return 0;
  return static_cast<int>(fminf(fmaxf(v, -2147483648.0f), 2147483520.0f));
}

// The full knot vector of the n interior knots: one entry a thread.
__device__ void full_knots(const Lane& L, int n, float um, int lane) {
  static_assert(kNest == kThreads, "one full knot a thread");
  const int i = lane;
  L.t[i] = i < kK + 1 ? 0.0f : (i < kK + 1 + kMaxInt && i - kK - 1 < n ? L.tint[i - kK - 1] : um);
  __syncwarp();
}

// The design on the current knots (span and basis values of each live site,
// as _basis4) and the normal equations: gband = G + _normal_eqs' jitter and
// padded identity, grhs = B^T y.
__device__ void normal_equations(const Lane& L, int n, int lane) {
  float* mine = L.partial + lane * kPartialStride;
  for (int e = 0; e < kPartial; ++e) mine[e] = 0.0f;
  for (int i = lane; i < L.m; i += kThreads) {
    if (!L.mk[i]) {
      L.span[i] = -1;
      continue;
    }
    const float xs = L.us[i];
    int sp = kK;
    for (int j = 0; j < n; ++j) sp += xs >= L.t[kK + 1 + j];
    // de Boor's basis_funs, degree 3 (The NURBS Book A2.2), as _basis4
    float v[kK + 1] = {1.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int deg = 1; deg <= kK; ++deg) {
      float saved = 0.0f;
#pragma unroll
      for (int r = 0; r < deg; ++r) {
        const float rt = L.t[sp + r + 1] - xs;
        const float lf = xs - L.t[sp + 1 - deg + r];
        float den = rt + lf;
        den = fabsf(den) > kTiny ? den : 1.0f;
        const float tmp = v[r] / den;
        v[r] = saved + rt * tmp;
        saved = lf * tmp;
      }
      v[deg] = saved;
    }
    L.span[i] = sp;
#pragma unroll
    for (int r = 0; r <= kK; ++r) L.vals[i * 4 + r] = v[r];
    const float y0 = L.ps[2 * i], y1 = L.ps[2 * i + 1];
#pragma unroll
    for (int r = 0; r <= kK; ++r) {
      const int row = sp - kK + r;
#pragma unroll
      for (int q = 0; q <= r; ++q) mine[row * 4 + (r - q)] += v[r] * v[q];
      mine[kNc * 4 + row * 2] += v[r] * y0;
      mine[kNc * 4 + row * 2 + 1] += v[r] * y1;
    }
  }
  for (int e = lane; e < kNc * kBand; e += kThreads) L.gband[e] = 0.0f;
  __syncwarp();
  // the threads' sums added in thread order: G's band (symmetric, offsets up
  // to 3) and B^T y; the entries outside the band's reach stay 0
  for (int e = lane; e < kPartial; e += kThreads) {
    float acc_e = 0.0f;
    for (int th = 0; th < kThreads; ++th) acc_e += L.partial[th * kPartialStride + e];
    if (e < kNc * 4) {
      const int row = e / 4, k = e % 4;
      if (row - k >= 0) {
        L.gband[row * kBand + kHalf - k] = acc_e;
        L.gband[(row - k) * kBand + kHalf + k] = acc_e;
      }
    } else {
      L.grhs[e - kNc * 4] = acc_e;
    }
  }
  __syncwarp();
  // _normal_eqs: the live diagonal gets 1e-6 of the mean trace, the padded
  // coefficients the mean trace itself
  const int nc_live = n + kK + 1;
  float tr = 0.0f;
  for (int i = 0; i < kNc; ++i) tr += L.gband[i * kBand + kHalf];
  tr = tr / static_cast<float>(nc_live);
  __syncwarp();
  if (lane < kNc) L.gband[lane * kBand + kHalf] += lane < nc_live ? kEpsDiag * tr : tr;
  __syncwarp();
}

// The squared residual of every site for the coefficients x (0 for a padded
// site) into resid, and their sum, the same in every thread.
__device__ float residuals(const Lane& L, const float* x, int lane) {
  float fp = 0.0f;
  for (int i = lane; i < L.m; i += kThreads) {
    const int sp = L.span[i];
    float r = 0.0f;
    if (sp >= 0) {
      const float* v = L.vals + i * 4;
      const float* c = x + (sp - kK) * 2;
      const float e0 = v[0] * c[0] + v[1] * c[2] + v[2] * c[4] + v[3] * c[6] - L.ps[2 * i];
      const float e1 = v[0] * c[1] + v[1] * c[3] + v[2] * c[5] + v[3] * c[7] - L.ps[2 * i + 1];
      r = e0 * e0 + e1 * e1;
    }
    L.resid[i] = r;
    fp += r;
  }
#pragma unroll
  for (int o = kThreads / 2; o > 0; o /= 2) fp += __shfl_xor_sync(kAll, fp, o);
  __syncwarp();
  return fp;
}

// _lsq_solve on the normal equations in gband/grhs: c = solve(G, B^T y),
// c += solve(G, B^T y - G c), both B1's refined solve; the padded
// coefficients zeroed. Leaves c in coef and each site's squared residual in
// resid; returns fp.
__device__ float lsq_solve(const Lane& L, int n, int lane) {
  for (int e = lane; e < kNc * kBand; e += kThreads) L.band[e] = L.gband[e];
  for (int e = lane; e < kNc * 2; e += kThreads) L.rhs[e] = L.grhs[e];
  __syncwarp();
  solve<2, true>(L.band, L.rhs, L.l, L.inv, L.y, L.x, L.res, kNc, lane);
  for (int e = lane; e < kNc * 2; e += kThreads) L.coef[e] = L.x[e];
  __syncwarp();
  // the residual of the solution against G, the sum over d = 0..8 from 0
  for (int e = lane; e < kNc * 2; e += kThreads) {
    const int i = e / 2, col_r = e % 2;
    float ax = 0.0f;
#pragma unroll
    for (int d = 0; d < kBand; ++d) {
      const int col = i - kHalf + d;
      if (col >= 0 && col < kNc) ax = __fadd_rn(ax, mul(L.gband[i * kBand + d], L.coef[col * 2 + col_r]));
    }
    L.rhs[e] = sub(L.grhs[e], ax);
  }
  __syncwarp();
  solve<2, true>(L.band, L.rhs, L.l, L.inv, L.y, L.x, L.res, kNc, lane);
  const int nc_live = n + kK + 1;
  for (int e = lane; e < kNc * 2; e += kThreads) {
    const float c = __fadd_rn(L.coef[e], L.x[e]);
    L.coef[e] = e < 2 * nc_live ? c : c * 0.0f;
  }
  __syncwarp();
  return residuals(L, L.coef, lane);
}

// _interval_stats: fpint[j], the residual sum of interval j (a site on a
// knot gives half to the interval it closes and half to the one it opens),
// and nrdata[j], the sites strictly inside it and off both ends of the
// trace, for the knots of the last design (span) and the residuals in resid.
__device__ void interval_stats(const Lane& L, int n, int last, int lane) {
  float* mine = L.partial + lane * kPartialStride;
  for (int e = 0; e < 2 * kNi; ++e) mine[e] = 0.0f;
  for (int i = lane; i < L.m; i += kThreads) {
    const int sp = L.span[i];
    if (sp < 0) continue;
    const int iv = sp - kK;
    const bool cross = iv >= 1 && L.us[i] == L.tint[iv - 1];
    const float r = L.resid[i];
    mine[iv] += r * (cross ? 0.5f : 1.0f);
    if (cross) mine[iv - 1] += r * 0.5f;
    if (!cross && i != 0 && i != last) mine[kNi + iv] += 1.0f;
  }
  __syncwarp();
  if (lane < kNi) {
    float f = 0.0f, c = 0.0f;
    for (int th = 0; th < kThreads; ++th) {
      f += L.partial[th * kPartialStride + lane];
      c += L.partial[th * kPartialStride + kNi + lane];
    }
    L.fpint[lane] = lane <= n ? f : 0.0f;
    L.nrdata[lane] = lane <= n ? static_cast<int>(c) : 0;
  }
  __syncwarp();
}

// _insert_knot: one fpknot step on the n interior knots. Returns false, and
// changes nothing, where no interval holds a site with a positive residual
// sum.
__device__ bool insert_knot(const Lane& L, int& n, int last, int lane) {
  // the first interval with the largest fpint among those that hold a site
  int number = 0;
  float fpmax = (L.nrdata[0] > 0) ? L.fpint[0] : -1.0f;
  for (int j = 1; j < kNi; ++j) {
    const float score = (L.nrdata[j] > 0 && j <= n) ? L.fpint[j] : -1.0f;
    if (score > fpmax) {
      fpmax = score;
      number = j;
    }
  }
  if (!(fpmax > 0.0f)) return false;
  const int maxpt = L.nrdata[number];
  const int ihalf = maxpt / 2 + 1;

  // the ihalf-th site strictly inside interval `number`, in site order
  const bool has_lo = number > 0, has_hi = number < n;
  const float lo = has_lo ? L.tint[number - 1] : 0.0f, hi = has_hi ? L.tint[number] : 0.0f;
  float knot = 0.0f;
  int seen = 0;
  for (int base = 0; base < L.m && seen < ihalf; base += kThreads) {
    const int i = base + lane;
    bool inside = false;
    float xs = 0.0f;
    if (i < L.m && L.mk[i] && i != 0 && i != last) {
      xs = L.us[i];
      inside = (!has_lo || xs > lo) && (!has_hi || xs < hi);
    }
    const unsigned in_mask = __ballot_sync(kAll, inside);
    const int rank = seen + __popc(in_mask & ((1u << lane) - 1u)) + 1;
    const unsigned hit = __ballot_sync(kAll, inside && rank == ihalf);
    if (hit) knot = __shfl_sync(kAll, xs, __ffs(hit) - 1);
    seen += __popc(in_mask);
  }

  // the sorted insert, then the proportional split of interval `number`
  const float am = fmaxf(static_cast<float>(maxpt), 1.0f);
  const float f_lo = fpmax * static_cast<float>(ihalf - 1) / am;
  const float f_hi = fpmax * static_cast<float>(maxpt - ihalf) / am;
  int pos = 0;
  for (int j = 0; j < n; ++j) pos += L.tint[j] < knot;
  float t_new = 0.0f, f_new = 0.0f;
  int n_new = 0;
  if (lane < kMaxInt) t_new = lane < pos ? L.tint[lane] : (lane == pos ? knot : L.tint[lane - 1]);
  if (lane < kNi) {
    f_new = lane < number ? L.fpint[lane] : lane == number ? f_lo : lane == number + 1 ? f_hi : L.fpint[lane - 1];
    n_new = lane < number ? L.nrdata[lane] : lane == number ? ihalf - 1 : lane == number + 1 ? maxpt - ihalf : L.nrdata[lane - 1];
  }
  __syncwarp();
  if (lane < kMaxInt) L.tint[lane] = t_new;
  if (lane < kNi) {
    L.fpint[lane] = f_new;
    L.nrdata[lane] = n_new;
  }
  __syncwarp();
  ++n;
  return true;
}

// FITPACK's part 2 on the n final knots, whose design and normal equations
// gband/grhs and full knots t hold, from the least-squares spline in coef
// with SSR fp_lsq and the polynomial's fp0. Leaves the coefficients in coef;
// returns the trips.
__device__ int part2(const Lane& L, int n, float um, float fp0, float fp_lsq, float s, float acc, int lane) {
  const float fpms = fp_lsq - s;
  if (n == 0 || fabsf(fpms) < acc) return 0;  // the gate: FITPACK returns the least-squares spline

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
      for (int r = 0; r < kK + 2; ++r) prod = prod * (i + r == jk ? 1.0f : L.t[jk] - L.t[i + r]);
      prod = fabsf(prod) > kTiny ? prod : 1.0f;
      val = (L.t[i + kK + 1] - L.t[i]) / prod * scale;
    }
    L.dv[e] = val;
  }
  for (int e = lane; e < kNc * kBand; e += kThreads) L.dband[e] = 0.0f;
  __syncwarp();
  // D^T D's band: entry (a, a - k) sums D[j, a] D[j, a - k] over j ascending
  for (int e = lane; e < kNc * (kHalf + 1); e += kThreads) {
    const int a = e / (kHalf + 1), k = e % (kHalf + 1), b = a - k;
    if (b < 0) continue;
    float acc_e = 0.0f;
    const int j_hi = b < n - 1 ? b : n - 1;
    for (int j = a - kHalf > 0 ? a - kHalf : 0; j <= j_hi; ++j) acc_e += L.dv[j * (kK + 2) + a - j] * L.dv[j * (kK + 2) + b - j];
    L.dband[a * kBand + kHalf - k] = acc_e;
    if (k > 0) L.dband[b * kBand + kHalf + k] = acc_e;
  }

  // the initial p from B1's factor of G
  for (int e = lane; e < kNc * kBand; e += kThreads) L.band[e] = L.gband[e];
  for (int e = lane; e < kNc * 2; e += kThreads) L.rhs[e] = L.grhs[e];
  __syncwarp();
  factor_and_forward<2, true>(L.band, L.rhs, L.l, L.inv, L.y, kNc, lane, lane < 2 ? lane : 0, L.gdiag);
  __syncwarp();
  const int nc_live = n + kK + 1;
  float diag_sum = 0.0f;
  for (int i = 0; i < nc_live; ++i) diag_sum += L.gdiag[i];
  float p = static_cast<float>(nc_live) / (diag_sum < kTiny ? kTiny : diag_sum);

  // the p-iteration: f1 at p = 0 (the polynomial), f3 at p = inf (the
  // least-squares spline on these knots)
  float p1 = 0.0f, f1 = fp0 - s, p3 = 0.0f, f3 = fpms;
  bool p3_inf = true, ich1 = false, ich3 = false, done = false;
  int trips = 0;
  for (int it = 0; it < kMaxIt; ++it) {
    ++trips;
    if (done) break;
    const float pp = p * p;
    for (int e = lane; e < kNc * kBand; e += kThreads) L.band[e] = L.gband[e] + L.dband[e] / pp;
    __syncwarp();
    solve<2, true>(L.band, L.rhs, L.l, L.inv, L.y, L.x, L.res, kNc, lane);

    bool finite = true;
    for (int e = lane; e < kNc * 2; e += kThreads) {
      finite = finite && isfinite(L.x[e]);
      if (e >= 2 * nc_live) L.x[e] = L.x[e] * 0.0f;  // the padded coefficients
    }
    finite = __all_sync(kAll, finite);
    __syncwarp();
    float fp = 0.0f;
    for (int i = lane; i < L.m; i += kThreads) {
      const int sp = L.span[i];
      if (sp < 0) continue;
      const float* v = L.vals + i * 4;
      const float* c = L.x + (sp - kK) * 2;
      const float e0 = v[0] * c[0] + v[1] * c[2] + v[2] * c[4] + v[3] * c[6] - L.ps[2 * i];
      const float e1 = v[0] * c[1] + v[1] * c[3] + v[2] * c[5] + v[3] * c[7] - L.ps[2 * i + 1];
      fp += e0 * e0 + e1 * e1;
    }
#pragma unroll
    for (int o = kThreads / 2; o > 0; o /= 2) fp += __shfl_xor_sync(kAll, fp, o);
    const float f2 = fp - s;

    if (!finite || !isfinite(f2)) {
      p = too_small_p(p, p3, p3_inf);
      __syncwarp();
      continue;
    }
    for (int e = lane; e < kNc * 2; e += kThreads) L.coef[e] = L.x[e];
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
  return trips;
}

// _tiny_fit for a lane with n_valid <= 4 live sites: the interpolating
// polynomial of degree n_valid - 1 (at least 1) on t = u / u_max, least
// squares with a jitter of 1e-7 of the mean trace, as Bezier control points
// in the first four coefficients; the rest 0. Every thread computes it.
__device__ void tiny_fit(const Lane& L, int n_valid, float um, float* out, int lane) {
  const float den = um > 1e-9f ? um : 1e-9f;
  const int degree = min(max(n_valid - 1, 1), 3);
  float g[4][4] = {}, rhs[4][2] = {};
  for (int base = 0; base < L.m; base += kThreads) {
    const int i = base + lane;
    const bool live = i < L.m && L.mk[i];
    const float t = live ? L.us[i] / den : 1.0f;
    const float y0 = live ? L.ps[2 * i] : 0.0f, y1 = live ? L.ps[2 * i + 1] : 0.0f;
    unsigned left = __ballot_sync(kAll, live);
    while (left) {  // the live sites of these 32 in site order
      const int src = __ffs(left) - 1;
      left &= left - 1u;
      const float ts = __shfl_sync(kAll, t, src), z0 = __shfl_sync(kAll, y0, src), z1 = __shfl_sync(kAll, y1, src);
      const float pw[4] = {1.0f, ts, ts * ts, ts * ts * ts};
      float col[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) col[a] = pw[a] * (a <= degree ? 1.0f : 0.0f);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) g[a][b] += col[a] * col[b];
        rhs[a][0] += col[a] * z0;
        rhs[a][1] += col[a] * z1;
      }
    }
  }
  const float tr = g[0][0] + g[1][1] + g[2][2] + g[3][3];
  const float jitter = 1e-7f * tr / 4.0f + 1e-12f;
#pragma unroll
  for (int a = 0; a < 4; ++a) g[a][a] += jitter;
  // _solve_spd4: the unrolled 4 x 4 Cholesky solve
  auto sq = [](float v) { return sqrtf(v > 1e-30f ? v : 1e-30f); };
  const float l11 = sq(g[0][0]);
  const float l21 = g[1][0] / l11, l31 = g[2][0] / l11, l41 = g[3][0] / l11;
  const float l22 = sq(g[1][1] - l21 * l21);
  const float l32 = (g[2][1] - l31 * l21) / l22, l42 = (g[3][1] - l41 * l21) / l22;
  const float l33 = sq(g[2][2] - l31 * l31 - l32 * l32);
  const float l43 = (g[3][2] - l41 * l31 - l42 * l32) / l33;
  const float l44 = sq(g[3][3] - l41 * l41 - l42 * l42 - l43 * l43);
  float a[4][2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float z0 = rhs[0][d] / l11;
    const float z1 = (rhs[1][d] - l21 * z0) / l22;
    const float z2 = (rhs[2][d] - l31 * z0 - l32 * z1) / l33;
    const float z3 = (rhs[3][d] - l41 * z0 - l42 * z1 - l43 * z2) / l44;
    a[3][d] = z3 / l44;
    a[2][d] = (z2 - l43 * a[3][d]) / l33;
    a[1][d] = (z1 - l32 * a[2][d] - l42 * a[3][d]) / l22;
    a[0][d] = (z0 - l21 * a[1][d] - l31 * a[2][d] - l41 * a[3][d]) / l11;
  }
  // monomials on [0, 1] -> Bezier control points (_M_INV)
  const float third = 1.0f / 3.0f, two_thirds = 2.0f / 3.0f;
  for (int e = lane; e < kNc * 2; e += kThreads) {
    const int r = e / 2, d = e % 2;
    float v = 0.0f;
    if (r == 0) v = a[0][d];
    if (r == 1) v = a[0][d] + third * a[1][d];
    if (r == 2) v = a[0][d] + two_thirds * a[1][d] + third * a[2][d];
    if (r == 3) v = a[0][d] + a[1][d] + a[2][d] + a[3][d];
    out[e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
fitpack_fit_kernel(const float* __restrict__ u, const float* __restrict__ pts, const unsigned char* __restrict__ mask,
                   const float* __restrict__ u_max, const float* __restrict__ c0, const float* __restrict__ fp0_in,
                   const float* __restrict__ resid0, float s, float acc, int m, float* __restrict__ t_out,
                   int* __restrict__ n_out, float* __restrict__ coef_out, unsigned char* __restrict__ budget_out,
                   int* __restrict__ trips_out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int sys = blockIdx.x;
  const Lane L = lane_arrays(smem, mask, sys, m);
  float* out = coef_out + static_cast<size_t>(sys) * kNc * 2;

  stage(L.us, u + static_cast<size_t>(sys) * m, m, lane);
  stage(L.ps, pts + static_cast<size_t>(sys) * 2 * m, 2 * m, lane);
  stage(L.resid, resid0 + static_cast<size_t>(sys) * m, m, lane);
  const float um = u_max[sys];
  // before the first design every live site lies in interval 0
  int n_valid = 0;
  for (int i = lane; i < m; i += kThreads) {
    const bool live = L.mk[i];
    L.span[i] = live ? kK : -1;
    n_valid += live;
  }
  n_valid = __reduce_add_sync(kAll, n_valid);
  const int last = n_valid > 1 ? n_valid - 1 : 0;  // the trace's last site, by index
  if (lane < kMaxInt) L.tint[lane] = kBig;
  for (int e = lane; e < kNc * 2; e += kThreads) L.coef[e] = c0[static_cast<size_t>(sys) * kNc * 2 + e];
  copy_async_wait();
  __syncwarp();

  int n = 0, trips1 = 0, trips2 = 0;
  bool budget = false;
  if (n_valid <= 4) {
    tiny_fit(L, n_valid, um, out, lane);
  } else {
    // part 1, iteration 0 solved by the caller: the polynomial's fp0
    const float fp0 = fp0_in[sys];
    float fp_lsq = fp0;
    bool done = fabsf(fp0 - s) < acc || fp0 - s < 0.0f;
    if (!done) {
      // the first insertion round: nplus = 1 on the empty knot set (fpcurf.f:158)
      interval_stats(L, 0, last, lane);
      insert_knot(L, n, last, lane);
    }
    int nplus_prev = 1;
    for (int it = 1; !done && it <= kOuter; ++it) {
      ++trips1;
      full_knots(L, n, um, lane);
      normal_equations(L, n, lane);
      const float fp = lsq_solve(L, n, lane);
      const float fpms = fp - s;
      const bool newly = fabsf(fpms) < acc || fpms < 0.0f;
      // budget exhausted: this solve is the fall-through solve on the final set
      const bool budget_now = !newly && (n >= kMaxInt || it >= kOuter);
      // FITPACK's nplus update (fpcurf.f:150-160)
      const float delta = fp_lsq - fp;
      const bool big_delta = delta > acc;
      const float ratio = static_cast<float>(nplus_prev) * fpms / (big_delta ? delta : 1.0f);
      const int npl1 = big_delta ? f32_to_i32(ratio) : nplus_prev * 2;
      int nplus = min(nplus_prev * 2, max(max(npl1, nplus_prev / 2), 1));
      if (n == 0) nplus = 1;
      fp_lsq = fp;
      nplus_prev = nplus;
      budget = budget_now;
      done = newly || budget_now;
      if (done) break;  // the knots of this trip are the final ones
      interval_stats(L, n, last, lane);
      const int limit = min(nplus, kNplusMax);
      for (int j = 0; j < limit && n < kMaxInt; ++j) {
        if (!insert_knot(L, n, last, lane)) break;
      }
    }
    // part 2 on the last trip's design and normal equations (none where no
    // trip ran: n = 0 then, and part 2 is gated)
    trips2 = part2(L, n, um, fp0, fp_lsq, s, acc, lane);
    for (int e = lane; e < kNc * 2; e += kThreads) out[e] = L.coef[e];
  }
  if (lane < kMaxInt) t_out[static_cast<size_t>(sys) * kMaxInt + lane] = L.tint[lane];
  if (lane == 0) {
    n_out[sys] = n;
    budget_out[sys] = budget;
    trips_out[2 * sys] = trips1;
    trips_out[2 * sys + 1] = trips2;
  }
}

// Above 48 KB a block's dynamic shared memory has to be allowed first, on the
// current device: allow what kMaxSites needs.
cudaError_t allow_shared(size_t shared) {
  if (shared <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fitpack_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(float) * fit_floats(kMaxSites)));
}

}  // namespace

extern "C" int fitpack_fit_f32(const float* u, const float* pts, const unsigned char* mask, const float* u_max,
                               const float* c0, const float* fp0, const float* resid0, float s, float acc, int batch,
                               int m, float* t_int, int* n_int, float* coef, unsigned char* budget_hit, int* trips,
                               void* stream) {
  if (batch <= 0) return 0;
  if (m < 1 || m > kMaxSites) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = sizeof(float) * fit_floats(m);
  const cudaError_t err = allow_shared(shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  fitpack_fit_kernel<<<batch, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      u, pts, mask, u_max, c0, fp0, resid0, s, acc, m, t_int, n_int, coef, budget_hit, trips);
  return static_cast<int>(cudaGetLastError());
}
