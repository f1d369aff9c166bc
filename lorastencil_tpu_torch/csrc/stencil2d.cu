// One dirichlet0 timestep of a 2-D low-rank stencil on the port's internal
// layout, float32, on CUDA cores.
//
// Replaces the TPU kernel lorastencil_tpu/ops/pallas_2d.py::_stencil2d_kernel
// (driven by pallas_2d.stencil2d_step) at fused_steps=1: for every interior
// cell of every tile,
//
//     out = sum_terms rowconv(colconv(in)) + sum_residue w * in[p + o]
//
// with tile round-up cells beyond the true interior (m, n) written as zeros
// (pallas_2d.py mask_to_interior) and the guard ring never touched, so the
// zero-ringed output buffer carries the reference's halo decay.
//
// What bounds it: device-memory bytes.  A step reads and writes 4 B per
// cell and does ~25 flops per cell (star2d1r), far below the card's fp32
// rate, so the only goal is to touch each cell's bytes once.  The design:
//   * one block per (kTileRows x kTileCols) output tile stages its halo'd
//     window in shared memory with coalesced row loads (a warp per window
//     row, neighbouring lanes on neighbouring addresses), so each input
//     cell comes from device memory about (1 + 2r/32)(1 + 2r/128) times;
//   * per separable term, the column conv goes into a shared intermediate
//     2r rows taller than the tile, the row conv reads it back, and the
//     sparse residue reads the window; all in fp32 FMA, in the tap order
//     of the plain twin (ops/band_gemm.py), so integer data agrees bit for
//     bit;
//   * each thread keeps kRowsPerThread outputs of one column in registers
//     and stores them once, masked to the rounded interior.
// The TPU's split-bf16 matmul trick has no use here: tensor cores would
// not lift a byte-bound step, and their accumulation order could break
// the bit-exactness the tests hold the kernel to.
//
// Taps and residue come from a small device table (ops/band_gemm.py
// plan_array), staged into shared memory by every block.
//
// C interface, loaded with ctypes: ls_stencil2d_step launches on the given
// stream, allocates nothing and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileRows = 32;
constexpr int kTileCols = 128;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTileCols;        // rows per sweep: 2
constexpr int kRowsPerThread = kTileRows / kRowStep;  // outputs/thread: 16
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadius = 16;
constexpr int kMaxPlan = 4096;  // floats of tap/residue table
constexpr int kMaxGridY = 65535;

static_assert(kThreads % kTileCols == 0, "tile columns must divide threads");
static_assert(kTileRows % kRowStep == 0, "row sweep must divide tile rows");

__global__ void __launch_bounds__(kThreads)
stencil2d_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const float* __restrict__ plan, int plan_len, int n_terms,
                 int radius, int n_res, int rows, int pitch, int r0, int c0,
                 int m, int n, int mr, int nr) {
  extern __shared__ float smem[];
  const int R = radius;
  const int W = 2 * R + 1;
  const int win_rows = kTileRows + 2 * R;
  const int win_cols = kTileCols + 2 * R;
  float* s_win = smem;                             // win_rows x win_cols
  float* s_col = s_win + win_rows * win_cols;      // win_rows x kTileCols
  float* s_plan = s_col + win_rows * kTileCols;    // plan_len

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
      float* dst = s_win + wr * win_cols;
      if (gr < rows) {
        const float* src = in + static_cast<size_t>(gr) * pitch;
        for (int wc = lane; wc < win_cols; wc += 32) {
          const int gc = gc0 + wc;
          dst[wc] = gc < pitch ? src[gc] : 0.f;
        }
      } else {
        for (int wc = lane; wc < win_cols; wc += 32) dst[wc] = 0.f;
      }
    }
  }
  __syncthreads();

  const int tx = tid % kTileCols;
  const int ty = tid / kTileCols;
  float acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.f;

  const float* term = s_plan;
  for (int t = 0; t < n_terms; ++t, term += 2 + 2 * W) {
    // flags are block-uniform: the barriers below are reached by all
    const bool has_col = term[0] != 0.f;
    const bool has_row = term[1] != 0.f;
    const float* ct = term + 2;
    const float* rt = ct + W;
    const float* src;
    int src_pitch;
    if (has_col) {
      __syncthreads();  // the previous term's row conv is done with s_col
      for (int wr = ty; wr < win_rows; wr += kRowStep) {
        const float* x = s_win + wr * win_cols + tx;
        float y = 0.f;
        for (int k = 0; k < W; ++k) {
          const float w = ct[k];
          if (w != 0.f) y = fmaf(w, x[k], y);
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
      const float* y = src + (ty + q * kRowStep) * src_pitch;
      float z;
      if (has_row) {
        z = 0.f;
        for (int k = 0; k < W; ++k) {
          const float w = rt[k];
          if (w != 0.f) z = fmaf(w, y[k * src_pitch], z);
        }
      } else {
        z = y[R * src_pitch];  // identity row axis
      }
      acc[q] += z;
    }
  }

  const float* res = s_plan + n_terms * (2 + 2 * W);
  for (int p = 0; p < n_res; ++p) {
    const int dr = static_cast<int>(res[3 * p]);
    const int dc = static_cast<int>(res[3 * p + 1]);
    const float w = res[3 * p + 2];
    const float* x = s_win + (R + dr + ty) * win_cols + R + dc + tx;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
      acc[q] = fmaf(w, x[q * kRowStep * win_cols], acc[q]);
  }

  const int j = j0 + tx;
  if (j >= nr) return;
  float* dst = out + static_cast<size_t>(r0) * pitch + c0 + j;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int i = i0 + ty + q * kRowStep;
    if (i < mr)
      dst[static_cast<size_t>(i) * pitch] = (i < m && j < n) ? acc[q] : 0.f;
  }
}

}  // namespace

extern "C" int ls_stencil2d_step(const float* in, float* out,
                                 const float* plan, int plan_len,
                                 int n_terms, int radius, int n_res,
                                 int rows, int pitch, int r0, int c0, int m,
                                 int n, int mr, int nr, void* stream) {
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
      sizeof(float) * (static_cast<size_t>(win_rows) *
                           (kTileCols + 2 * radius + kTileCols) +
                       plan_len);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stencil2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nr + kTileCols - 1) / kTileCols,
                  (mr + kTileRows - 1) / kTileRows);
  stencil2d_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      in, out, plan, plan_len, n_terms, radius, n_res, rows, pitch, r0, c0, m,
      n, mr, nr);
  return static_cast<int>(cudaGetLastError());
}
