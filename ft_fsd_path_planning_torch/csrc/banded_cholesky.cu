// Batched banded SPD solve A x = b for the FITPACK spline engine, on Hopper.
//
// Replaces the Pallas TPU kernel ft_fsd_path_planning_tpu/ops/pallas/
// banded_cholesky.py::_kernel (called through banded_cholesky_solve). Same
// arithmetic: Cholesky factor of the half-bandwidth-4 band, forward then
// back substitution, the pivot clamped as sqrt(max(acc, 1e-20)) and every
// row scaled by the reciprocal of its diagonal. Products and differences are
// written with the round-to-nearest intrinsics so that nvcc cannot contract
// them into FMAs: the kernel then repeats the plain PyTorch version
// (ops/banded_cholesky.py::banded_cholesky_solve_plain) operation for
// operation.
//
// Layout: band (B, C, 9) with band[b, i, d] = A[i, i - 4 + d], rhs and out
// (B, C, R), all float32 and contiguous. One thread solves one system; C and
// R are template parameters, so the row recurrence unrolls at compile time
// and the 5-wide rows of L stay in registers, as the TPU kernel unrolls it
// at trace time. The TPU's 128-lane batch tile has no counterpart here: no
// padding, no transposes.
//
// What bounds it on an H100: at C = 28, R = 2 a system moves
// (28 * 9 + 2 * 28 * 2) * 4 B = 1.46 KB, so a batch of 256 moves 374 KB,
// about 0.11 us at 3.35 TB/s, and does ~10 kFLOP per system. Neither bytes
// nor operations bound it: launch latency and the serial dependency chain of
// the row recurrence (each row waits for the previous one) do. The design
// answers that with the least it can: one launch per solve, no
// synchronisation, and the whole recurrence in registers. Coalesced loads (a
// (C, 9, B) layout or staging through shared memory) and several threads per
// system are left for later work.
//
// C interface: banded_cholesky_solve_f32 returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for a shape that has
// no instantiation.

#include <cuda_runtime.h>

namespace {

constexpr int kHalf = 4;           // half-bandwidth w
constexpr int kBand = 2 * kHalf + 1;  // 9 stored band columns
constexpr int kThreads = 128;

template <int C, int R>
__global__ void __launch_bounds__(kThreads)
banded_cholesky_kernel(const float* __restrict__ band, const float* __restrict__ rhs,
                       float* __restrict__ out, int batch) {
  const int sys = blockIdx.x * blockDim.x + threadIdx.x;
  if (sys >= batch) return;
  const float* a = band + static_cast<size_t>(sys) * C * kBand;
  const float* b = rhs + static_cast<size_t>(sys) * C * R;
  float* x = out + static_cast<size_t>(sys) * C * R;

  // l[i][d] = L[i, i - w + d], d = 0..w (d = w is the diagonal)
  float l[C][kHalf + 1];
  float inv_diag[C];

#pragma unroll
  for (int i = 0; i < C; ++i) {
    float acc = a[i * kBand + kHalf];
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      if (i - kHalf + d >= 0) acc = __fsub_rn(acc, __fmul_rn(l[i][d], l[i][d]));
    }
    const float diag = __fsqrt_rn(acc < 1e-20f ? 1e-20f : acc);
    l[i][kHalf] = diag;
    inv_diag[i] = __fdiv_rn(1.0f, diag);
#pragma unroll
    for (int j = i + 1; j < i + kHalf + 1; ++j) {
      if (j < C) {
        float s = a[j * kBand + kHalf - (j - i)];  // A[j, i]
#pragma unroll
        for (int k = (j - kHalf > 0 ? j - kHalf : 0); k < i; ++k) {
          s = __fsub_rn(s, __fmul_rn(l[j][k - (j - kHalf)], l[i][k - (i - kHalf)]));
        }
        l[j][i - (j - kHalf)] = __fmul_rn(s, inv_diag[i]);
      }
    }
  }

  // forward substitution L y = b (y kept in yx)
  float yx[C][R];
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = b[i * R + r];
#pragma unroll
      for (int k = (i - kHalf > 0 ? i - kHalf : 0); k < i; ++k) {
        acc = __fsub_rn(acc, __fmul_rn(l[i][k - (i - kHalf)], yx[k][r]));
      }
      yx[i][r] = __fmul_rn(acc, inv_diag[i]);
    }
  }

  // back substitution L^T x = y (overwrites yx from the last row up)
#pragma unroll
  for (int i = C - 1; i >= 0; --i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = yx[i][r];
#pragma unroll
      for (int j = i + 1; j < i + kHalf + 1; ++j) {
        if (j < C) acc = __fsub_rn(acc, __fmul_rn(l[j][i - (j - kHalf)], yx[j][r]));
      }
      yx[i][r] = __fmul_rn(acc, inv_diag[i]);
    }
  }

#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) x[i * R + r] = yx[i][r];
  }
}

template <int C, int R>
int launch(const float* band, const float* rhs, float* out, int batch, cudaStream_t stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  banded_cholesky_kernel<C, R><<<blocks, kThreads, 0, stream>>>(band, rhs, out, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int banded_cholesky_solve_f32(const float* band, const float* rhs, float* out,
                                         int batch, int n_coef, int n_rhs, void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_coef == 28 && n_rhs == 2) return launch<28, 2>(band, rhs, out, batch, s);
  if (n_coef == 51 && n_rhs == 2) return launch<51, 2>(band, rhs, out, batch, s);
  if (n_coef == 20 && n_rhs == 1) return launch<20, 1>(band, rhs, out, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
