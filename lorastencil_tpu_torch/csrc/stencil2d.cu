// One dirichlet0 timestep of a 2-D low-rank stencil on the port's internal
// layout, in float32 or float64, on CUDA cores.
//
// Replaces two TPU kernels, one instance each:
//   * float32: lorastencil_tpu/ops/pallas_2d.py::_stencil2d_kernel (driven by
//     pallas_2d.stencil2d_step) at fused_steps=1;
//   * float64: lorastencil_tpu/ops/pallas_df64.py::_df64_kernel (driven by
//     pallas_df64.df64_step), the fp64-grade step the TPU computes on
//     error-free (hi, lo) fp32 pairs because it has no fp64 unit.  The H100
//     has one, so this instance computes in native double; it also serves
//     dtype float64 (pallas_2d.stencil2d_step in float64).
// For every interior cell of every tile,
//
//     out = sum_terms rowconv(colconv(in)) + sum_residue w * in[p + o]
//
// with tile round-up cells beyond the true interior (m, n) written as zeros
// (pallas_2d.py mask_to_interior) and the guard ring never touched, so the
// zero-ringed output buffer carries the reference's halo decay.
//
// What bounds it: device-memory bytes.  A step reads and writes 4 B (fp32)
// or 8 B (fp64) per cell and does ~25 operations per cell (star2d1r), below
// the card's fp32 and fp64 rates, so the only goal is to touch each cell's
// bytes once.  The design:
//   * one block per (kTileRows x kTileCols) output tile stages its halo'd
//     window in shared memory with coalesced row loads (a warp per window
//     row, neighbouring lanes on neighbouring addresses), so each input
//     cell comes from device memory about (1 + 2r/kTileRows)(1 + 2r/128)
//     times;
//   * per separable term, the column conv goes into a shared intermediate
//     2r rows taller than the tile, the row conv reads it back, and the
//     sparse residue reads the window, in the tap order of the plain twin
//     (ops/band_gemm.py).  fp32 fuses each multiply-add (fmaf), so integer
//     data agrees with the twin bit for bit; fp64 rounds each product and
//     sum on its own (__dmul_rn, __dadd_rn: no FMA), so it agrees with the
//     twin bit for bit on any data;
//   * each thread keeps kRowsPerThread outputs of one column in registers
//     and stores them once, masked to the rounded interior.
// kTileRows is 32 in fp32 and 16 in fp64: the 8-byte window of a 32-row
// tile would take 70 KB of shared memory at r = 1 (3 blocks per SM); at 16
// rows it takes 37 KB (6 blocks per SM), for 2r/16 in place of 2r/32 extra
// window rows.
// The TPU's split-bf16 matmuls and its double-float pair arithmetic have no
// use here: tensor cores would not lift a byte-bound step, and their
// accumulation order could break the bit-exactness the tests hold the
// kernel to.
//
// Taps and residue come from a small device table in the state's dtype
// (ops/band_gemm.py plan_array), staged into shared memory by every block.
//
// C interface, loaded with ctypes: ls_stencil2d_step (float) and
// ls_stencil2d_step_f64 (double) launch on the given stream, allocate
// nothing and return cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileCols = 128;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTileCols;  // rows per sweep: 2
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadius = 16;
constexpr int kMaxPlan = 4096;  // entries of tap/residue table
constexpr int kMaxGridY = 65535;

static_assert(kThreads % kTileCols == 0, "tile columns must divide threads");

// Output rows per block (see the header).
template <typename T>
constexpr int tile_rows() {
  return sizeof(T) == sizeof(float) ? 32 : 16;
}

// w * x + y: fused in fp32, rounded step by step in fp64.
__device__ __forceinline__ float mad(float w, float x, float y) {
  return fmaf(w, x, y);
}
__device__ __forceinline__ double mad(double w, double x, double y) {
  return __dadd_rn(y, __dmul_rn(w, x));
}

template <typename T, int kTileRows>
__global__ void __launch_bounds__(kThreads)
stencil2d_kernel(const T* __restrict__ in, T* __restrict__ out,
                 const T* __restrict__ plan, int plan_len, int n_terms,
                 int radius, int n_res, int rows, int pitch, int r0, int c0,
                 int m, int n, int mr, int nr) {
  constexpr int kRowsPerThread = kTileRows / kRowStep;  // outputs/thread
  static_assert(kTileRows % kRowStep == 0, "row sweep must divide tile rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int R = radius;
  const int W = 2 * R + 1;
  const int win_rows = kTileRows + 2 * R;
  const int win_cols = kTileCols + 2 * R;
  T* s_win = smem;                           // win_rows x win_cols
  T* s_col = s_win + win_rows * win_cols;    // win_rows x kTileCols
  T* s_plan = s_col + win_rows * kTileCols;  // plan_len

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kTileRows;  // tile origin, interior coords
  const int j0 = blockIdx.x * kTileCols;

  for (int p = tid; p < plan_len; p += kThreads) s_plan[p] = plan[p];

  // Window rows [i0 - R, i0 + kTileRows + R), cols [j0 - R, j0 + kTileCols
  // + R) of the interior; the guard (>= R, checked by the host) keeps the
  // start in bounds, and a tile past the rounded interior reads zeros
  // beyond the buffer's end.
  {
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int gr0 = r0 + i0 - R;
    const int gc0 = c0 + j0 - R;
    for (int wr = warp; wr < win_rows; wr += kWarps) {
      const int gr = gr0 + wr;
      T* dst = s_win + wr * win_cols;
      if (gr < rows) {
        const T* src = in + static_cast<size_t>(gr) * pitch;
        for (int wc = lane; wc < win_cols; wc += 32) {
          const int gc = gc0 + wc;
          dst[wc] = gc < pitch ? src[gc] : T(0);
        }
      } else {
        for (int wc = lane; wc < win_cols; wc += 32) dst[wc] = T(0);
      }
    }
  }
  __syncthreads();

  const int tx = tid % kTileCols;
  const int ty = tid / kTileCols;
  T acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = T(0);

  const T* term = s_plan;
  for (int t = 0; t < n_terms; ++t, term += 2 + 2 * W) {
    // flags are block-uniform: the barriers below are reached by all
    const bool has_col = term[0] != T(0);
    const bool has_row = term[1] != T(0);
    const T* ct = term + 2;
    const T* rt = ct + W;
    const T* src;
    int src_pitch;
    if (has_col) {
      __syncthreads();  // the previous term's row conv is done with s_col
      for (int wr = ty; wr < win_rows; wr += kRowStep) {
        const T* x = s_win + wr * win_cols + tx;
        T y = T(0);
        for (int k = 0; k < W; ++k) {
          const T w = ct[k];
          if (w != T(0)) y = mad(w, x[k], y);
        }
        s_col[wr * kTileCols + tx] = y;
      }
      __syncthreads();
      src = s_col + tx;
      src_pitch = kTileCols;
    } else {
      src = s_win + tx + R;  // identity column axis
      src_pitch = win_cols;
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const T* y = src + (ty + q * kRowStep) * src_pitch;
      T z;
      if (has_row) {
        z = T(0);
        for (int k = 0; k < W; ++k) {
          const T w = rt[k];
          if (w != T(0)) z = mad(w, y[k * src_pitch], z);
        }
      } else {
        z = y[R * src_pitch];  // identity row axis
      }
      acc[q] += z;
    }
  }

  const T* res = s_plan + n_terms * (2 + 2 * W);
  for (int p = 0; p < n_res; ++p) {
    const int dr = static_cast<int>(res[3 * p]);
    const int dc = static_cast<int>(res[3 * p + 1]);
    const T w = res[3 * p + 2];
    const T* x = s_win + (R + dr + ty) * win_cols + R + dc + tx;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
      acc[q] = mad(w, x[q * kRowStep * win_cols], acc[q]);
  }

  const int j = j0 + tx;
  if (j >= nr) return;
  T* dst = out + static_cast<size_t>(r0) * pitch + c0 + j;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int i = i0 + ty + q * kRowStep;
    if (i < mr)
      dst[static_cast<size_t>(i) * pitch] = (i < m && j < n) ? acc[q] : T(0);
  }
}

template <typename T>
int launch(const T* in, T* out, const T* plan, int plan_len, int n_terms,
           int radius, int n_res, int rows, int pitch, int r0, int c0, int m,
           int n, int mr, int nr, void* stream) {
  constexpr int kTileRows = tile_rows<T>();
  const int W = 2 * radius + 1;
  if (radius < 0 || radius > kMaxRadius || n_terms < 0 || n_res < 0 ||
      plan_len > kMaxPlan || plan_len != n_terms * (2 + 2 * W) + 3 * n_res ||
      r0 < radius || c0 < radius || m < 0 || n < 0 || mr < m || nr < n ||
      r0 + mr + radius > rows || c0 + nr + radius > pitch ||
      (mr + kTileRows - 1) / kTileRows > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mr == 0 || nr == 0) return 0;
  const int win_rows = kTileRows + 2 * radius;
  const size_t smem =
      sizeof(T) * (static_cast<size_t>(win_rows) *
                       (kTileCols + 2 * radius + kTileCols) +
                   plan_len);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(stencil2d_kernel<T, kTileRows>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nr + kTileCols - 1) / kTileCols,
                  (mr + kTileRows - 1) / kTileRows);
  stencil2d_kernel<T, kTileRows><<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      in, out, plan, plan_len, n_terms, radius, n_res, rows, pitch, r0, c0, m,
      n, mr, nr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ls_stencil2d_step(const float* in, float* out,
                                 const float* plan, int plan_len,
                                 int n_terms, int radius, int n_res,
                                 int rows, int pitch, int r0, int c0, int m,
                                 int n, int mr, int nr, void* stream) {
  return launch(in, out, plan, plan_len, n_terms, radius, n_res, rows, pitch,
                r0, c0, m, n, mr, nr, stream);
}

extern "C" int ls_stencil2d_step_f64(const double* in, double* out,
                                     const double* plan, int plan_len,
                                     int n_terms, int radius, int n_res,
                                     int rows, int pitch, int r0, int c0,
                                     int m, int n, int mr, int nr,
                                     void* stream) {
  return launch(in, out, plan, plan_len, n_terms, radius, n_res, rows, pitch,
                r0, c0, m, n, mr, nr, stream);
}
