// Fused beam search of the cone sorter, on Hopper.
//
// Replaces the Pallas TPU kernel ft_fsd_path_planning_tpu/ops/pallas/
// beam_search.py::_beam_kernel (called through fused_beam_search). Same
// function: for each of G independent (frame x side) searches, L - 1 steps
// of: expand the K beam fronts over the C neighbours of each tail cone (one
// row of the node table), apply the eight pruning gates, update the partial
// cost, rank the P = K + K*C pool entries by (score, pool index), keep the
// best K and repack their F = L + 16 feature rows.
//
// It is not the TPU kernel block by block. The TPU kernel batches 128
// searches in the lanes, reads the node table and gathers the survivors
// through one-hot contractions, and chunks by 32 to bound VMEM. Here:
//
//   * one block per search, eight lanes per beam (four beams to a warp,
//     8 K = 256 threads): lanes 0..C-1 of a group hold the beam's C children,
//     lane C its frozen parent, the rest hold nothing. A beam's lanes load
//     its table row themselves (__syncwarp), the any-over-C that freezes a
//     beam is a __ballot_sync, and parents and children work in the same
//     warps at the same time;
//   * the pool index that breaks ties stays that of the TPU kernel and of the
//     port's scan, whatever thread holds the entry: k for the parent of beam
//     k, K + j*K + k for its child over neighbour j;
//   * the tail's table row is indexed directly (a negative index reads an
//     all-zero row, which is what the one-hot sum gives);
//   * the exact top-K is a rank in O(P log P): (score, pool index) becomes
//     one 64-bit key of the same order, each warp sorts its 32 keys with a
//     bitonic network of shuffles and writes them to shared memory, and
//     every entry adds up, over the eight sorted lists, the keys below its
//     own (a five-step binary search each). Exactly one entry has each rank;
//   * each thread keeps its pool entry's F features in registers; the entry
//     whose rank is r < K writes itself to column r of the state in shared
//     memory, so the scatter has no race;
//   * two __syncthreads() per step: after the keys are written, after the
//     survivors are scattered.
//
// Layout: node_table (G, N, 4C) = [idx | ok | x | y] per neighbour, feats
// (G, F, K), alive (G, K), params (G, 6) = [car x, car y, dir x, dir y,
// side sign, target length]; all float32, contiguous, any G >= 1, N at run
// time. The state (F x K), the K table rows of the step and the sorted keys
// live in shared memory (8.4 KB at the default shape, 24 KB at K = 64 with
// the bounds below); the node table stays in global memory and is read
// through the read-only path, one row per beam per step.
//
// Shapes: the beam width K is a template parameter, K in {8, 16, 32, 64}
// (64 to 512 threads); the max length L and the neighbour count C are run-time
// values up to MAX_L = 32 and MAX_C = 7 (a beam's C children and its parent
// share one group of eight lanes). Arrays indexed by a config position are
// sized by the bound and their loops guarded by q < l, so they stay in
// registers. The sorter's default (K, L, C) = (32, 12, 5) has its own exact
// instantiation, in which L and C are compile-time constants.
//
// Arithmetic: this file is compiled with -fmad=false, so no product and sum
// is contracted into an FMA, and every expression below is evaluated in the
// order the plain PyTorch version (ops/beam_search.py::
// fused_beam_search_plain) writes it. Division and square root are the
// correctly rounded defaults; rsqrtf is the function torch.rsqrt calls on
// the device. Constants are written as double literals cast to float, the
// conversion PyTorch applies to a Python scalar.
//
// What bounds it on an H100 (counted by search_flops and search_bytes in
// ops/beam_search.py): a search moves N * 4C + 2 * (F + 1) * K + 6 floats
// (17.7 KB at N = 128) and needs about 0.79 Mflop: the gates, carries and
// scores, and a comparison top-K of P log2 P compares. At G = 512 that is
// 9.1 MB (2.7 us at 3.35 TB/s) against 0.41 Gflop (6.1 us at 67 TFLOP/s), so
// operations bound it. What the design does about the bound: one launch for
// all searches, state that never leaves the SM between steps, and a rank
// whose work is of the order the bound counts (32 * 15 compare-exchanges a
// warp and 40 probes an entry, where a pairwise rank reads all P scores in
// every thread). At G = 2 (one frame) the time is the latency of the serial
// chain of L - 1 steps. Several searches per block are left for later work.
//
// C interface: fused_beam_search_f32 returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a (K, L, C) outside the
// shapes above (ops/beam_search.py::kernel_supports says which those are).

#include <cuda_runtime.h>

// configuration constants of a search, filled by the wrapper (ops/beam_search.py::_Consts)
struct Consts {
  float w0, w1, w2, w3, w6;
  float ell_major, ell_minor, side_eps, cos_between, between_dist;
  float thr_abs, thr_dir, close_dist, car_half, car_size, under_angle;
};

namespace {

constexpr int kParams = 6;
constexpr float kBig = (float)1e30;
constexpr float kPi = (float)3.141592653589793;
constexpr float kHalfPi = (float)(0.5 * 3.141592653589793);
constexpr float kQuarterPi = (float)(0.25 * 3.141592653589793);
constexpr float kTanPi8 = (float)0.4142135623730950;
constexpr float kEps = (float)1e-6;

__device__ __forceinline__ float sign_of(float x) {  // sign(+-0) = 0
  return (x > 0.0f ? 1.0f : 0.0f) - (x < 0.0f ? 1.0f : 0.0f);
}

// Cephes-style float32 atan2 (about 1e-6 rad), as the TPU kernel's _atan2
__device__ __forceinline__ float atan2_cephes(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float big = fmaxf(ax, ay);
  const float small = fminf(ax, ay);
  const float t = small / fmaxf(big, (float)1e-30);
  const bool use_red = t > kTanPi8;
  const float u = use_red ? (t - 1.0f) / (t + 1.0f) : t;
  const float z = u * u;
  const float p =
      ((((float)8.05374449538e-2 * z - (float)1.38776856032e-1) * z + (float)1.99777106478e-1) * z -
       (float)3.33329491539e-1) * z * u + u;
  float a = use_red ? kQuarterPi + p : p;
  a = ay > ax ? kHalfPi - a : a;
  a = x < 0.0f ? kPi - a : a;
  a = y < 0.0f ? -a : a;
  return (ax == 0.0f && ay == 0.0f) ? 0.0f : a;
}

__device__ __forceinline__ float angle_between(float vx, float vy, float wx, float wy) {
  const float cross = vx * wy - vy * wx;
  const float dot = vx * wx + vy * wy;
  return atan2_cephes(fabsf(cross), dot);
}

__device__ __forceinline__ float orient(float px, float py, float qx, float qy, float rx, float ry) {
  return (qx - px) * (ry - py) - (qy - py) * (rx - px);
}

__device__ __forceinline__ bool on_seg(float px, float py, float qx, float qy, float rx, float ry) {
  const bool wx = (rx >= fminf(px, qx) - kEps) && (rx <= fmaxf(px, qx) + kEps);
  const bool wy = (ry >= fminf(py, qy) - kEps) && (ry <= fmaxf(py, qy) + kEps);
  return wx && wy;
}

__device__ __forceinline__ bool opposite(float a, float b) {
  return ((a > kEps) && (b < -kEps)) || ((a < -kEps) && (b > kEps));
}

__device__ __forceinline__ bool seg_intersect(float ax0, float ay0, float ax1, float ay1,
                                              float bx0, float by0, float bx1, float by1) {
  const float d1 = orient(bx0, by0, bx1, by1, ax0, ay0);
  const float d2 = orient(bx0, by0, bx1, by1, ax1, ay1);
  const float d3 = orient(ax0, ay0, ax1, ay1, bx0, by0);
  const float d4 = orient(ax0, ay0, ax1, ay1, bx1, by1);
  const bool proper = opposite(d1, d2) && opposite(d3, d4);
  const bool touch = ((fabsf(d1) <= kEps) && on_seg(bx0, by0, bx1, by1, ax0, ay0)) ||
                     ((fabsf(d2) <= kEps) && on_seg(bx0, by0, bx1, by1, ax1, ay1)) ||
                     ((fabsf(d3) <= kEps) && on_seg(ax0, ay0, ax1, ay1, bx0, by0)) ||
                     ((fabsf(d4) <= kEps) && on_seg(ax0, ay0, ax1, ay1, bx1, by1));
  return proper || touch;
}

__device__ __forceinline__ float partial_score(const Consts& cs, float length, float angle_sum,
                                               float n_under, float residual, float init_cost,
                                               float wrong_sum) {
  const float n_int = fmaxf(length - 2.0f, 1.0f);
  return cs.w0 * angle_sum / n_int * (n_under + 1.0f) + cs.w1 * residual +
         cs.w2 / fmaxf(length, 1.0f) + cs.w3 * init_cost +
         cs.w6 * fabsf(wrong_sum) * (length >= 4.0f ? 1.0f : 0.0f);
}

// (score, pool index) as one 64-bit key that orders as the pair does: the
// float's bits made monotone (negative values flipped, the sign bit set on the
// others) above the index. -0.0 and +0.0 compare equal as floats, so both map
// to the key of +0.0 and the index decides between them.
__device__ __forceinline__ unsigned long long rank_key(float score, int pool_index) {
  const unsigned int bits = __float_as_uint(score == 0.0f ? 0.0f : score);
  const unsigned int ordered = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<unsigned long long>(ordered) << 32) | static_cast<unsigned int>(pool_index);
}

constexpr unsigned long long kNoEntry = ~0ull;  // key of a lane that holds no pool entry
constexpr unsigned int kFullWarp = 0xffffffffu;
constexpr int kGroup = 8;                    // lanes per beam: C children, the parent, the rest idle
constexpr int kBeamsPerWarp = 32 / kGroup;
constexpr int MAX_L = 32;                    // bound of the run-time max length
constexpr int MAX_C = kGroup - 1;            // bound of the run-time neighbour count

// ascending bitonic sort of one key per lane across the warp
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long key, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFullWarp, key, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      key = (keep_min == (key < other)) ? key : other;
    }
  }
  return key;
}

// number of keys below `key` in a sorted list of 32. While C < 7 a group
// holds an idle lane, so the last key of every list is kNoEntry and five
// probes find the count (0..31); at C = 7 every lane holds an entry, and a
// sixth probe counts the last key too
template <bool kFullGroups>
__device__ __forceinline__ int count_below(const unsigned long long* sorted, unsigned long long key) {
  int n = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (sorted[n + step - 1] < key) n += step;
  }
  if constexpr (kFullGroups) n += sorted[n] < key ? 1 : 0;
  return n;
}

// LB and CB bound the run-time max length l and neighbour count c; with
// kExact they are l and c themselves, known when compiling
template <int K, int LB, int CB, bool kExact>
__global__ void __launch_bounds__(K * kGroup)
beam_search_kernel(const float* __restrict__ table, const float* __restrict__ feats0,
                   const float* __restrict__ alive0, const float* __restrict__ params,
                   float* __restrict__ out_feats, float* __restrict__ out_alive, int n, int l_arg,
                   int c_arg, const Consts cs) {
  constexpr int FB = LB + 16;
  constexpr int RB = 4 * CB;
  constexpr int T = K * kGroup;  // threads
  constexpr int W = T / 32;      // warps
  static_assert(CB + 1 <= kGroup, "a beam's children and its parent share one group of lanes");
  static_assert(K % kBeamsPerWarp == 0, "whole warps");
  const int L = kExact ? LB : l_arg;
  const int C = kExact ? CB : c_arg;
  const int F = L + 16;
  const int R = 4 * C;
  // feature rows after the configs
  const int LEN = L, DONE = L + 1, ANGLE = L + 2, UNDER = L + 3, RESID = L + 4, INIT = L + 5,
            WRONG = L + 6, LAST_IDX = L + 7, LAST_X = L + 8, LAST_Y = L + 9, PREV_X = L + 10,
            PREV_Y = L + 11, PREV2_X = L + 12, PREV2_Y = L + 13, FIRST_X = L + 14,
            FIRST_Y = L + 15;
  // the same rows as positions in a pool entry's `tail`, which holds them in registers
  constexpr int T_LEN = 0, T_DONE = 1, T_ANGLE = 2, T_UNDER = 3, T_RESID = 4, T_INIT = 5,
                T_WRONG = 6, T_LAST_IDX = 7, T_LAST_X = 8, T_LAST_Y = 9, T_PREV_X = 10,
                T_PREV_Y = 11, T_PREV2_X = 12, T_PREV2_Y = 13, T_FIRST_X = 14, T_FIRST_Y = 15;

  __shared__ float s_feats[FB][K];
  __shared__ float s_alive[K];
  __shared__ float s_row[K][RB + 1];  // one table row per beam, padded against bank conflicts
  __shared__ unsigned long long s_keys[W][32];  // each warp's keys, sorted

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int slot = lane % kGroup;                         // 0..C-1 child over neighbour `slot`, C parent
  const int kb = warp * kBeamsPerWarp + lane / kGroup;    // beam of this lane's group
  const bool is_child = slot < C;
  const bool is_parent = slot == C;
  const int j = slot;
  // the pool order of the plain version, whatever thread holds the entry:
  // parents first, then the children neighbour-major
  const int pool_index = is_parent ? kb : K + j * K + kb;
  const unsigned int group_shift = (lane / kGroup) * kGroup;

  const float* tbl = table + static_cast<size_t>(g) * n * R;
  const float* f0 = feats0 + static_cast<size_t>(g) * F * K;
  for (int i = tid; i < F * K; i += T) (&s_feats[0][0])[i] = f0[i];
  if (tid < K) s_alive[tid] = alive0[static_cast<size_t>(g) * K + tid];

  const float* prm = params + static_cast<size_t>(g) * kParams;
  const float car_x = __ldg(prm + 0), car_y = __ldg(prm + 1);
  const float dir_x = __ldg(prm + 2), dir_y = __ldg(prm + 3);
  const float side = __ldg(prm + 4), target_len = __ldg(prm + 5);

  // car body segment for gate 8
  const float dnrm = rsqrtf(fmaxf(dir_x * dir_x + dir_y * dir_y, (float)1e-30));
  const float cs_x = car_x - dir_x * dnrm * cs.car_half;
  const float cs_y = car_y - dir_y * dnrm * cs.car_half;
  const float ce_x = car_x + dir_x * dnrm * cs.car_size;
  const float ce_y = car_y + dir_y * dnrm * cs.car_size;
  __syncthreads();

  for (int step = 0; step < L - 1; ++step) {
    // ---- the node-table row of the beam's tail cone, loaded by the beam's
    // own group of lanes
    {
      const int idx = __float2int_rn(s_feats[LAST_IDX][kb]);
      const bool in_table = idx >= 0 && idx < n;
      for (int col = slot; col < R; col += kGroup) {
        s_row[kb][col] = in_table ? __ldg(tbl + static_cast<size_t>(idx) * R + col) : 0.0f;
      }
    }
    __syncwarp();

    // ---- every lane reads its beam's state; children apply the gates and
    // build their pool entry
    float cfg[LB];
#pragma unroll
    for (int q = 0; q < LB; ++q) cfg[q] = q < L ? s_feats[q][kb] : -1.0f;
    const float lengths = s_feats[LEN][kb];
    const bool done = s_feats[DONE][kb] > 0.5f;
    const float angle_sum = s_feats[ANGLE][kb], n_under = s_feats[UNDER][kb];
    const float residual = s_feats[RESID][kb], init_cost = s_feats[INIT][kb];
    const float wrong_sum = s_feats[WRONG][kb], last_idx = s_feats[LAST_IDX][kb];
    const float last_x = s_feats[LAST_X][kb], last_y = s_feats[LAST_Y][kb];
    const float prev_x = s_feats[PREV_X][kb], prev_y = s_feats[PREV_Y][kb];
    const float prev2_x = s_feats[PREV2_X][kb], prev2_y = s_feats[PREV2_Y][kb];
    const float first_x = s_feats[FIRST_X][kb], first_y = s_feats[FIRST_Y][kb];
    const float p = lengths - 1.0f;
    const bool expandable = (s_alive[kb] > 0.5f) && !done && (lengths < target_len);

    // this thread's pool entry: its configs are cfg, with the candidate at
    // position `lengths` for a child; `tail` holds the rows after them
    float tail[16];
    float cand_idx = -1.0f;
    float score = kBig;
    bool can = false;
    if (is_child) {
      const float* row = s_row[kb];
      cand_idx = row[j];
      const bool can0 = row[C + j] > 0.5f;
      const float cand_x = row[2 * C + j], cand_y = row[3 * C + j];

      // gate 1: not already in config
      bool in_cfg = false;
#pragma unroll
      for (int q = 0; q < LB; ++q) in_cfg = in_cfg || (q < L && cand_idx == cfg[q]);
      can = can0 && !in_cfg;

      // gate 2: ellipse (p >= 1)
      float mjx = last_x - prev_x, mjy = last_y - prev_y;
      const float inv = rsqrtf(fmaxf(mjx * mjx + mjy * mjy, (float)1e-24));
      mjx = mjx * inv;
      mjy = mjy * inv;
      const float relx = cand_x - last_x, rely = cand_y - last_y;
      const float xr = relx * mjx + rely * mjy;
      const float yr = mjx * rely - mjy * relx;
      const float qx = xr / cs.ell_major, qy = yr / cs.ell_minor;
      const bool ell = qx * qx + qy * qy < 1.0f;
      can = can && (ell || (p < 1.0f));

      // gate 3: second cone on the correct side (p == 0)
      const float ccx = cand_x - car_x, ccy = cand_y - car_y;
      const float dsign = atan2_cephes(dir_x * ccy - dir_y * ccx, dir_x * ccx + dir_y * ccy);
      const bool side_ok = (sign_of(dsign) == side) || (fabsf(dsign) < cs.side_eps);
      can = can && (side_ok || (p != 0.0f));

      // gate 4: no cone skipped between last and candidate; m runs over the
      // C neighbours of the same tail
      bool blocked = false;
#pragma unroll
      for (int m = 0; m < CB; ++m) {
        if (m >= C) break;
        const float mx = row[2 * C + m], my = row[3 * C + m];
        const float v_ml_x = last_x - mx, v_ml_y = last_y - my;
        const float d_ml = sqrtf(v_ml_x * v_ml_x + v_ml_y * v_ml_y);
        const float vmcx = cand_x - mx, vmcy = cand_y - my;
        const float d_mc = sqrtf(vmcx * vmcx + vmcy * vmcy);
        const float dots = v_ml_x * vmcx + v_ml_y * vmcy;
        const bool cos_gate = dots < cs.cos_between * d_ml * d_mc;
        const bool not_self = cand_idx != row[m];
        blocked = blocked || ((row[C + m] > 0.5f) && not_self && (d_mc < cs.between_dist) &&
                              (d_ml < cs.between_dist) && cos_gate);
      }
      can = can && !blocked;

      // gate 5: direction-change thresholds (p >= 1)
      const float spx = last_x - prev_x, spy = last_y - prev_y;
      const float snx = relx, sny = rely;
      const float diff = atan2_cephes(spx * sny - spy * snx, spx * snx + spy * sny);
      const float seg_len = sqrtf(snx * snx + sny * sny);
      const bool abs_ok = fabsf(diff) <= cs.thr_abs;
      const bool directional = (side * diff < cs.thr_dir) || (seg_len < cs.close_dist);
      can = can && ((abs_ok && directional) || (p < 1.0f));

      // gate 6: flip-kill (p >= 2)
      const float ppx = prev_x - prev2_x, ppy = prev_y - prev2_y;
      const float diff2 = atan2_cephes(ppx * spy - ppy * spx, ppx * spx + ppy * spy);
      const bool flip = (sign_of(diff) != sign_of(diff2)) && (fabsf(diff - diff2) > (float)1.3);
      can = can && (!flip || (p < 2.0f));

      // gate 7: offset from start (p == 1)
      const bool off_ok = dir_x * (cand_x - first_x) + dir_y * (cand_y - first_y) > 0.0f;
      can = can && (off_ok || (p != 1.0f));

      // gate 8: car-body crossing
      can = can && !seg_intersect(last_x, last_y, cand_x, cand_y, cs_x, cs_y, ce_x, ce_y);

      can = can && expandable;

      // carries of the extended config
      const float theta = angle_between(prev_x - last_x, prev_y - last_y, snx, sny);
      const bool add_int = p >= 1.0f;
      const float c_angle = angle_sum + (add_int ? (kPi - theta) / kPi : 0.0f);
      const float c_under = n_under + ((add_int && (theta < cs.under_angle)) ? 1.0f : 0.0f);
      const float c_resid = residual + fmaxf(seg_len - 3.0f, 0.0f);
      const float first_ang = angle_between(cand_x - first_x, cand_y - first_y, dir_x, dir_y);
      const float c_init = (p == 0.0f) ? first_ang : init_cost;
      const float wrong_inc =
          ((sign_of(diff) == side) && (fabsf(diff) > cs.under_angle)) ? diff : 0.0f;
      const float c_wrong = wrong_sum + (add_int ? wrong_inc : 0.0f);
      const float c_len = lengths + 1.0f;
      const float c_score = partial_score(cs, c_len, c_angle, c_under, c_resid, c_init, c_wrong);
      score = can ? c_score : kBig;

      tail[T_LEN] = c_len;
      tail[T_DONE] = 0.0f;
      tail[T_ANGLE] = c_angle;
      tail[T_UNDER] = c_under;
      tail[T_RESID] = c_resid;
      tail[T_INIT] = c_init;
      tail[T_WRONG] = c_wrong;
      tail[T_LAST_IDX] = cand_idx;
      tail[T_LAST_X] = cand_x;
      tail[T_LAST_Y] = cand_y;
      tail[T_PREV_X] = last_x;
      tail[T_PREV_Y] = last_y;
      tail[T_PREV2_X] = prev_x;
      tail[T_PREV2_Y] = prev_y;
      tail[T_FIRST_X] = first_x;
      tail[T_FIRST_Y] = first_y;
    }

    // ---- the parent freezes a beam that found no extension: the any-over-C
    // is a ballot over the beam's own lanes
    const unsigned int votes = __ballot_sync(kFullWarp, can);
    if (is_parent) {
      const bool any_can = ((votes >> group_shift) & ((1u << C) - 1u)) != 0u;
      const bool done2 = done || (expandable && !any_can);
      const bool frozen = (s_alive[kb] > 0.5f) && (done2 || !expandable);
      const float p_score =
          partial_score(cs, lengths, angle_sum, n_under, residual, init_cost, wrong_sum);
      score = frozen ? p_score : kBig;

      tail[T_LEN] = lengths;
      tail[T_DONE] = done2 ? 1.0f : 0.0f;
      tail[T_ANGLE] = angle_sum;
      tail[T_UNDER] = n_under;
      tail[T_RESID] = residual;
      tail[T_INIT] = init_cost;
      tail[T_WRONG] = wrong_sum;
      tail[T_LAST_IDX] = last_idx;
      tail[T_LAST_X] = last_x;
      tail[T_LAST_Y] = last_y;
      tail[T_PREV_X] = prev_x;
      tail[T_PREV_Y] = prev_y;
      tail[T_PREV2_X] = prev2_x;
      tail[T_PREV2_Y] = prev2_y;
      tail[T_FIRST_X] = first_x;
      tail[T_FIRST_Y] = first_y;
    }

    // ---- exact top-K in O(P log P). Each warp sorts its keys; an entry's
    // rank = #{q : (s_q, q) < (s_p, p)} is the sum over the warps of the
    // keys below its own, found by binary search in each sorted list
    const bool has_entry = is_child || is_parent;
    const unsigned long long key = has_entry ? rank_key(score, pool_index) : kNoEntry;
    s_keys[warp][lane] = warp_sort(key, lane);
    __syncthreads();  // barrier 1 of 2: the keys are written, the old state is read

    if (has_entry) {
      int rank = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) rank += count_below<CB + 1 == kGroup>(s_keys[w], key);
      // the entry of rank r < K becomes column r of the new state
      if (rank < K) {
        const bool valid = score < (float)0.5e30;
        // invalid slots: configs -1, length 0, done 0, last_idx -1
#pragma unroll
        for (int q = 0; q < LB; ++q) {
          if (q < L) {
            const float v = (is_child && lengths == static_cast<float>(q)) ? cand_idx : cfg[q];
            s_feats[q][rank] = valid ? v : -1.0f;
          }
        }
        s_feats[LEN][rank] = valid ? tail[T_LEN] : 0.0f;
        s_feats[DONE][rank] = valid ? tail[T_DONE] : 0.0f;
#pragma unroll
        for (int q = T_ANGLE; q < 16; ++q) s_feats[L + q][rank] = tail[q];
        if (!valid) s_feats[LAST_IDX][rank] = -1.0f;
        s_alive[rank] = valid ? 1.0f : 0.0f;
      }
    }
    __syncthreads();  // barrier 2 of 2: the survivors are scattered
  }

  float* of = out_feats + static_cast<size_t>(g) * F * K;
  for (int i = tid; i < F * K; i += T) of[i] = (&s_feats[0][0])[i];
  if (tid < K) out_alive[static_cast<size_t>(g) * K + tid] = s_alive[tid];
}

template <int K, int LB, int CB, bool kExact>
int launch(const float* table, const float* feats0, const float* alive0, const float* params,
           float* out_feats, float* out_alive, int g, int n, int l, int c, const Consts& cs,
           cudaStream_t stream) {
  beam_search_kernel<K, LB, CB, kExact><<<g, K * kGroup, 0, stream>>>(
      table, feats0, alive0, params, out_feats, out_alive, n, l, c, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_beam_search_f32(const float* table, const float* feats0, const float* alive0,
                                     const float* params, float* out_feats, float* out_alive,
                                     int g, int n, int k, int l, int c, const Consts* consts,
                                     void* stream) {
  if (l < 1 || l > MAX_L || c < 1 || c > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  if (g <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts& cs = *consts;
  if (k == 32 && l == 12 && c == 5) {  // the sorter's default, exact
    return launch<32, 12, 5, true>(table, feats0, alive0, params, out_feats, out_alive, g, n, l, c, cs, s);
  }
  switch (k) {
    case 8:
      return launch<8, MAX_L, MAX_C, false>(table, feats0, alive0, params, out_feats, out_alive, g, n, l, c, cs, s);
    case 16:
      return launch<16, MAX_L, MAX_C, false>(table, feats0, alive0, params, out_feats, out_alive, g, n, l, c, cs, s);
    case 32:
      return launch<32, MAX_L, MAX_C, false>(table, feats0, alive0, params, out_feats, out_alive, g, n, l, c, cs, s);
    case 64:
      return launch<64, MAX_L, MAX_C, false>(table, feats0, alive0, params, out_feats, out_alive, g, n, l, c, cs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
