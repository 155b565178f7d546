// Batched banded SPD solve A x = b for the FITPACK spline engine, on Hopper.
//
// Replaces the Pallas TPU kernel ft_fsd_path_planning_tpu/ops/pallas/
// banded_cholesky.py::_kernel (called through banded_cholesky_solve) and,
// in its fused entry, everything ft_fsd_path_planning_tpu/ops/spline.py::
// _banded_solve wraps around two calls of it. Two entries, one kernel:
//
//   * banded_cholesky_solve_f32, the TPU kernel's own function: band
//     (B, C, 9) with band[b, i, d] = A[i, i - 4 + d], rhs (B, C, R) -> x.
//     Cholesky factor of the half-bandwidth-4 band, forward then back
//     substitution, the pivot clamped as sqrt(max(acc, 1e-20)) and every row
//     scaled by the reciprocal of its diagonal.
//   * banded_refined_solve_dense_f32, what the spline engine needs from it:
//     the dense (B, C, C) matrix with its strides -> the refined solution.
//     The block reads the nine diagonals where they lie, factors the band
//     once, solves, forms rhs - A x from the band it holds (the sum over
//     d = 0..8 in that order, starting from 0), runs both substitutions again
//     with the same factor and adds the correction. One launch takes the
//     place of two solves and some fifty small PyTorch kernels around them.
//
// Products, sums and differences are written with the round-to-nearest
// intrinsics so that nvcc cannot contract them into FMAs, and every entry
// keeps the summation order of the plain PyTorch versions (ops/
// banded_cholesky.py::banded_cholesky_solve_plain and
// banded_refined_solve_plain): the kernel repeats them operation for
// operation.
//
// Design. One warp holds one system and a block is one warp, so a batch of
// 256 is 256 small blocks over all 132 SMs. A lone warp keeps only a few
// loads in flight, so what a warp has to fetch is kept small: it copies its
// system's band and right-hand sides into shared memory with asynchronous
// 16-byte copies (cp.async) by neighbouring lanes, all issued before the one
// wait (the dense entry gathers the nine diagonals, 36 contiguous bytes a
// row, 4 bytes a copy). What is serial stays in registers, what is
// independent goes to the lanes. The factorisation runs row by row with the
// last four rows of L in registers; a row waits for nothing but the previous
// row's reciprocal, its own last product, the pivot's square root and
// division. The forward substitution of the right-hand sides rides in the
// same loop (lane r carries column r) and fills the slots that chain leaves
// empty. The back substitution, and the refinement's two, keep the last four
// values in registers and read the coming row ahead; rows at the band's edge
// have their own guarded code, so the rows between carry no tests. The
// residual's C*R entries are independent and spread over the 32 lanes, as
// are the copies in and the stores out. There is no synchronisation inside a
// loop. C is a run-time value up to kMaxC; only R (1 or 2) is a template
// parameter.
//
// What bounds it on an H100: at C = 28, R = 2 a system moves
// (28 * 9 + 2 * 28 * 2) * 4 B = 1.46 KB, so a batch of 256 moves 373 KB,
// about 0.11 us at 3.35 TB/s, and does ~10 kflop per system (~0.04 us at
// 67 TFLOP/s). Neither bytes nor operations bound it: the cost of a launch
// and the serial chain of the row recurrence (a square root and a division
// in every row, each waiting for the previous row) do. banded_empty_launch
// launches an empty kernel on the same grid, the floor any single launch has.
//
// The device code (the staging copies, the factor, the substitutions and
// the refined solve) lives in banded_cholesky.cuh, which fitpack_part2.cu
// shares: FITPACK's part 2 solves its systems with this same arithmetic.
//
// C interface: each function returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for a shape the kernel does not
// take (C > kMaxC, R not 1 or 2).

#include <cuda_runtime.h>

#include "banded_cholesky.cuh"

namespace {

using namespace banded;

constexpr int kMaxC = 64;

// floats of shared memory a system needs: band, the four sub-diagonals of L,
// 1/diag, rhs, y, x, residual, padding (5.5 KB at C = 64, R = 2)
__host__ __device__ inline int system_floats(int c, int r) { return (kBand + kHalf + 1) * c + 4 * r * c + kPad; }

// kFused: `a` is the dense matrix (element strides sa0, sa1, sa2) and the
// solve is refined once; else `a` is the contiguous band and the solve is bare.
template <int R, bool kFused>
__global__ void __launch_bounds__(kThreads)
banded_cholesky_kernel(const float* __restrict__ a, long long sa0, long long sa1, long long sa2,
                       const float* __restrict__ rhs, float* __restrict__ out, int c) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int sys = blockIdx.x;
  float* band = smem;           // band[i * 9 + d] = A[i, i - 4 + d]
  float* l = band + kBand * c;  // l[i * 4 + d] = L[i, i - 4 + d], d = 0..3
  float* inv = l + kHalf * c;   // 1 / L[i, i]
  float* b = inv + c;
  float* y = b + R * c;
  float* x = y + R * c;
  float* res = x + R * c;

  if (kFused) {
    const float* from = a + sys * sa0;
    for (int e = lane; e < kBand * c; e += kThreads) {
      const int i = e / kBand, col = i - kHalf + e % kBand;
      if (col >= 0 && col < c) {
        copy_async_4(band + e, from + i * sa1 + col * sa2);
      } else {
        band[e] = 0.0f;
      }
    }
  } else {
    stage(band, a + static_cast<size_t>(sys) * kBand * c, kBand * c, lane);
  }
  stage(b, rhs + static_cast<size_t>(sys) * R * c, R * c, lane);
  copy_async_wait();
  __syncwarp();

  solve<R, kFused>(band, b, l, inv, y, x, res, c, lane);

  float* dst = out + static_cast<size_t>(sys) * R * c;
  for (int e = lane; e < R * c; e += kThreads) dst[e] = x[e];
}

__global__ void empty_kernel() {}

template <bool kFused>
int launch(const float* a, long long sa0, long long sa1, long long sa2, const float* rhs, float* out,
           int batch, int c, int r, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (c < 1 || c > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = sizeof(float) * system_floats(c, r);
  if (r == 1) {
    banded_cholesky_kernel<1, kFused><<<batch, kThreads, shared, stream>>>(a, sa0, sa1, sa2, rhs, out, c);
  } else if (r == 2) {
    banded_cholesky_kernel<2, kFused><<<batch, kThreads, shared, stream>>>(a, sa0, sa1, sa2, rhs, out, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int banded_cholesky_solve_f32(const float* band, const float* rhs, float* out,
                                         int batch, int n_coef, int n_rhs, void* stream) {
  return launch<false>(band, 0, 0, 0, rhs, out, batch, n_coef, n_rhs, static_cast<cudaStream_t>(stream));
}

extern "C" int banded_refined_solve_dense_f32(const float* a, long long stride_sys, long long stride_row,
                                              long long stride_col, const float* rhs, float* out,
                                              int batch, int n_coef, int n_rhs, void* stream) {
  return launch<true>(a, stride_sys, stride_row, stride_col, rhs, out, batch, n_coef, n_rhs,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int banded_empty_launch(int batch, void* stream) {
  if (batch <= 0) return 0;
  empty_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
