// Dirichlet0 timesteps of a 1-D stencil on the port's flat internal layout
// (ops/layout.py Layout1D), in float32 or float64, on CUDA cores.
//
// Replaces the four TPU kernels of lorastencil_tpu/ops/pallas_1d.py with two
// kernels, each in a narrow and a wide instantiation:
//   * a pass of k fused steps (ls_stencil1d_pass):
//       narrow -> _stencil1d_lanes_kernel (stencil1d_lanes_step),
//       wide   -> _stencil1d_kernel (stencil1d_step);
//   * a whole run in one cooperative launch (ls_stencil1d_resident):
//       narrow, halo reload every min(8, 32 / r) steps
//              -> _stencil1d_resident_lanes_kernel (stencil1d_resident_lanes),
//       wide, a grid sync every step
//              -> _stencil1d_resident_kernel (stencil1d_resident).
// Their float64 instances (the *_f64 entries) replace the fp64-grade TPU
// kernels of lorastencil_tpu/ops/pallas_df64_1d.py, which compute on
// error-free (hi, lo) fp32 pairs because the TPU has no fp64 unit; here the
// arithmetic is native double:
//       narrow pass -> _df64_1d_lanes_kernel (df64_1d_step),
//       wide pass   -> _df64_1d_flat_kernel (df64_1d_flat_step),
//       narrow run  -> the kernel of stencil1d_resident_pair;
// and the wide run serves dtype float64 (pallas_1d.stencil1d_resident in
// float64).
// Every substep computes out[f] = sum_{|d| <= r} taps[r + d] * in[f + d] (r
// the effective radius: the taps come trimmed of their zero ends) and zeroes
// every cell outside the interior [0, n), the reference's halo decay.
//
// The order of each sum, which the plain twins in ops/stencil1d.py repeat:
// the centre, then d = 1..r; narrow adds an equal pair taps[r+d] == taps[r-d]
// as one product of the pair's sum (pallas_1d._conv_lanes), wide adds +d then
// -d (pallas_1d._conv_flat); zero taps are skipped.  Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn; __dmul_rn, __dadd_rn in fp64: no
// FMA contraction), so a kernel agrees with its twin bit for bit on any data.
//
// What bounds it: a pass reads and writes 4 B (fp32) or 8 B (fp64) per cell
// and does ~r+2 to 2r+1 operations per cell and substep, below the card's
// fp32 and fp64 rates, so device memory bytes at large n; at n ~ 1M an fp32
// pass moves 8 MB (2.4 us at 3.35 TB/s) and the host's work per launch
// dominates.  At small n and wide radii (r = 40 x 100,000 in fp64: 1.6 MB,
// 0.5 us of bytes) a pass is bound by latency: how many cells the card has
// in flight, and the chain of 2r+1 dependent sums per cell.  The designs:
//   * a wide pass (wide_kernel) gives each block a tile of 2048, 1024, 512
//     or 256 cells, the largest that still gives the grid two blocks per SM
//     (the host's choice, ops/stencil1d.py pass_tile), so a short grid
//     fills the card; the block stages the tile and k*r cells each side in
//     shared memory with 16-byte cp.async copies where the buffer's
//     alignment allows, runs the k substeps between two shared buffers with
//     the extent shrinking by r per substep, and writes the last substep
//     straight to the donor (whose guard the host keeps zero).  The nonzero
//     taps come as (offset, weight) pairs in the twin's order in a
//     __grid_constant__ parameter (WideTaps), so every product reads its
//     weight from the constant bank: no tap load and no zero test in the
//     loop.  Each thread carries chains<T>() cells a block's width apart as
//     independent sums, interleaved tap by tap, each in its own order;
//   * a narrow pass (pass_kernel) keeps the radius at compile time and the
//     taps in registers, one cell per thread and sweep.  The TPU's
//     overlapped lanes, duplicated cells that make a shift one lane roll,
//     have no use here: a shift is an address offset;
//   * a run is one cooperative launch for all steps: each block owns a chunk
//     of the interior, runs `refresh` steps from the chunk plus refresh*r
//     cells each side, writes the chunk to one of two global buffers, syncs
//     the grid and reloads.  The input is read and never written.  Loads in
//     a run bypass L1 (__ldcg): other blocks wrote the buffer since.
// The TPU's split-bf16 matmuls only emulated exact fp32 on its matrix unit;
// CUDA cores do exact fp32 directly.
//
// Narrow instantiations have the radius as a template parameter (1..8, taps
// in registers, loops unrolled) and one runtime-radius instantiation for
// 9..32; the wide run takes the radius at run time with the tap loop kept
// rolled (a fully unrolled wide-radius loop makes ptxas very slow), as the
// wide pass's loop over its tap pairs is.  Shared memory holds twice the
// bytes per cell in fp64, so a fp64 pass's reach k*r and a fp64 run's chunk
// per block reach about half their fp32 caps: the launch refuses what does
// not fit (and a run whose blocks cannot all be resident, checked on the
// fp64 instantiation itself).
//
// C interface, loaded with ctypes: the four functions (float and double)
// launch on the given stream, allocate nothing and return a cudaError_t
// (0 = launched).  A pass also takes, after the stream, a wide pass's
// nonzero taps on the host (offsets, weights, count) and its tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;      // cells per block of a pass (TILE_1D)
constexpr int kMaxRadius = 127;  // pallas_1d._dense_taps
constexpr int kTapSlots = 2 * kMaxRadius + 2;
constexpr int kMaxK = 64;        // fused steps per pass
constexpr int kMinChunk = 256;   // cells per block of a run, at least
constexpr size_t kMaxSmem = 232448;
constexpr int kWideMaxTaps = 2 * kMaxRadius + 1;  // nonzero taps, at most
// Cells a wide-pass thread carries at once: 4 in fp32, 2 in fp64 (on the
// H100, 2 fp64 chains a thread ran the r = 40 passes faster than 4, at
// 100,000 cells and at 16,777,216).
template <typename T>
__host__ __device__ constexpr int chains() {
  return sizeof(T) == 8 ? 2 : 4;
}

// A wide pass's nonzero taps in the twin's order (the centre, then +d, -d
// for d = 1..r), passed by value: 3,064 bytes in fp64 at the cap, within
// the 4 KB of a launch's parameters.
template <typename T>
struct WideTaps {
  int n;
  int off[kWideMaxTaps];
  T w[kWideMaxTaps];
};
static_assert(sizeof(WideTaps<double>) + 64 <= 4096,
              "a wide pass's parameters must fit in 4 KB");

// Products and sums rounded on their own, in either precision.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T, int R, bool kPairs>
__device__ __forceinline__ T tap_sum(const T* x, const T* t, int r) {
  const int rr = R > 0 ? R : r;
  const T c = t[rr];
  T acc = c != T(0) ? mul_rn(c, x[0]) : T(0);
  auto add = [&](int d) {
    const T wp = t[rr + d];
    const T wm = t[rr - d];
    if (kPairs && wp != T(0) && wp == wm) {
      acc = add_rn(acc, mul_rn(wp, add_rn(x[d], x[-d])));
    } else {
      if (wp != T(0)) acc = add_rn(acc, mul_rn(wp, x[d]));
      if (wm != T(0)) acc = add_rn(acc, mul_rn(wm, x[-d]));
    }
  };
  if constexpr (R > 0) {
#pragma unroll
    for (int d = 1; d <= R; ++d) add(d);
  } else {
#pragma unroll 1
    for (int d = 1; d <= r; ++d) add(d);
  }
  return acc;
}

// `steps` masked substeps on shared buffers a -> b -> a ...: `a` holds
// interior cells [f0 - steps*r, f0 + len + steps*r) on entry; returns the
// buffer holding cells [f0, f0 + len) at offset steps*r.
template <typename T, int R, bool kPairs>
__device__ __forceinline__ T* substeps(T* a, T* b, const T* t, int r,
                                       int steps, int f0, int len, int n) {
  const int H = steps * r;
  for (int s = 1; s <= steps; ++s) {
    const int e = (steps - s) * r;  // this level's extent beyond the cells
    for (int i = H - e + threadIdx.x; i < H + len + e; i += kThreads) {
      const int f = f0 - H + i;
      const T v = tap_sum<T, R, kPairs>(a + i, t, r);
      b[i] = (f >= 0 && f < n) ? v : T(0);
    }
    __syncthreads();
    T* tmp = a;
    a = b;
    b = tmp;
  }
  return a;
}

template <typename T, int R, bool kPairs>
__global__ void __launch_bounds__(kThreads)
pass_kernel(const T* __restrict__ in, T* __restrict__ out,
            const T* __restrict__ taps, int r, int k, int len, int origin,
            int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int H = k * r;
  const int W = kTile + 2 * H;
  T* s_taps = smem;
  T* a = smem + kTapSlots;
  T* b = a + W;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTile;  // tile origin, interior coordinates

  for (int p = tid; p < 2 * r + 1; p += kThreads) s_taps[p] = taps[p];
  const int g0 = origin + t0 - H;  // buffer index of window cell 0
  for (int i = tid; i < W; i += kThreads) {
    const int g = g0 + i;
    a[i] = (g >= 0 && g < len) ? in[g] : T(0);
  }
  __syncthreads();

  T* res;
  if constexpr (R > 0) {
    T t[2 * R + 1];
#pragma unroll
    for (int p = 0; p < 2 * R + 1; ++p) t[p] = s_taps[p];
    res = substeps<T, R, kPairs>(a, b, t, r, k, t0, kTile, n);
  } else {
    res = substeps<T, 0, kPairs>(a, b, s_taps, r, k, t0, kTile, n);
  }
  T* dst = out + origin + t0;
  for (int i = tid; i < kTile; i += kThreads) dst[i] = res[H + i];
}

// 16 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The sums of K cells at x + idx[c]: the first nonzero tap's product, then
// each further product added, every one rounded on its own; the chains
// interleave tap by tap.  No nonzero tap: zeros, as the twin's.
template <typename T, int K>
__device__ __forceinline__ void wide_sums(const T* x, const int (&idx)[K],
                                          const WideTaps<T>& tp,
                                          T (&acc)[K]) {
  if (tp.n == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = T(0);
    return;
  }
  {
    const int o = tp.off[0];
    const T w = tp.w[0];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = mul_rn(w, x[idx[c] + o]);
  }
#pragma unroll 4
  for (int e = 1; e < tp.n; ++e) {
    const int o = tp.off[e];
    const T w = tp.w[e];
#pragma unroll
    for (int c = 0; c < K; ++c)
      acc[c] = add_rn(acc[c], mul_rn(w, x[idx[c] + o]));
  }
}

// Shared memory of a wide pass, in cells: the staged window (its start
// moved down to a 16-byte boundary) and, for k > 1, a second buffer.
template <typename T>
__host__ __device__ constexpr int wide_cells(int tile, int H, int k) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int W = tile + 2 * H;
  return (W + 2 * V - 1) / V * V + (k > 1 ? (W + V - 1) / V * V : 0);
}

// k masked substeps over a tile of `tile` cells (blockDim.x * chains<T>());
// the last one written to `out`.
template <typename T>
__global__ void __launch_bounds__(kTile / chains<T>())
wide_kernel(const T* __restrict__ in, T* __restrict__ out,
            const __grid_constant__ WideTaps<T> taps, int r, int k, int len,
            int origin, int n, int tile) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int K = chains<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int H = k * r;
  const int W = tile + 2 * H;
  const int t0 = blockIdx.x * tile;  // tile origin, interior coordinates
  const int g0 = origin + t0 - H;    // buffer index of window cell 0 (>= 0)
  const int shift = g0 % V;
  const int a_cells = (W + 2 * V - 1) / V * V;

  // window cell i at a[i]: 16-byte chunks from g0 - shift, whole chunks
  // inside the buffer by cp.async, the rest cell by cell (0 outside it)
  const bool vec = reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const int chunks = (shift + W + V - 1) / V;
  for (int c = tid; c < chunks; c += nt) {
    const int g = g0 - shift + c * V;
    T* dst = smem + c * V;
    if (vec && g + V <= len) {
      cp_async16(dst, in + g);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) dst[v] = g + v < len ? in[g + v] : T(0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const T* src = smem + shift;
  T* spare = smem + a_cells;
  for (int s = 1; s <= k; ++s) {
    const int e = (k - s) * r;  // this level's extent beyond the tile
    const int lo = H - e;
    const int cnt = tile + 2 * e;
    T* dst = spare;
    for (int base = 0; base < cnt; base += K * nt) {
      int idx[K];
#pragma unroll
      for (int c = 0; c < K; ++c)
        idx[c] = lo + min(base + c * nt + tid, cnt - 1);
      T acc[K];
      wide_sums(src, idx, taps, acc);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (base + c * nt + tid >= cnt) continue;
        const int f = t0 + idx[c] - H;  // interior coordinate
        const T v = (f >= 0 && f < n) ? acc[c] : T(0);
        if (s == k) {
          out[origin + f] = v;
        } else {
          dst[idx[c]] = v;
        }
      }
    }
    if (s < k) {
      __syncthreads();
      spare = const_cast<T*>(src);
      src = dst;
    }
  }
}

template <typename T, int R, bool kPairs>
__global__ void __launch_bounds__(kThreads)
resident_kernel(const T* in, T* out0, T* out1, const T* __restrict__ taps,
                int r, int steps, int refresh, int len, int origin, int n,
                int rounded, int chunk) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int HM = refresh * r;
  T* s_taps = smem;
  T* a = smem + kTapSlots;
  T* b = a + chunk + 2 * HM;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * chunk;  // chunk origin, interior coordinates
  const int C = min(chunk, rounded - c0);

  for (int p = tid; p < 2 * r + 1; p += kThreads) s_taps[p] = taps[p];
  __syncthreads();
  T t[R > 0 ? 2 * R + 1 : 1];
  if constexpr (R > 0) {
#pragma unroll
    for (int p = 0; p < 2 * R + 1; ++p) t[p] = s_taps[p];
  }

  const T* src = in;
  int phase = 0;
  for (int done = 0; done < steps; ++phase) {
    const int ks = min(refresh, steps - done);
    const int H = ks * r;
    const int g0 = origin + c0 - H;
    for (int i = tid; i < C + 2 * H; i += kThreads) {
      const int g = g0 + i;
      a[i] = (g >= 0 && g < len) ? __ldcg(src + g) : T(0);
    }
    __syncthreads();
    T* res;
    if constexpr (R > 0) {
      res = substeps<T, R, kPairs>(a, b, t, r, ks, c0, C, n);
    } else {
      res = substeps<T, 0, kPairs>(a, b, s_taps, r, ks, c0, C, n);
    }
    T* dst = (phase & 1) ? out1 : out0;
    for (int i = tid; i < C; i += kThreads) dst[origin + c0 + i] = res[H + i];
    done += ks;
    if (done < steps) {
      src = dst;
      grid.sync();  // every chunk written, every halo read done
    }
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int R, bool kPairs>
int launch_pass(const T* in, T* out, const T* taps, int r, int k, int len,
                int origin, int n, int rounded, cudaStream_t stream) {
  const size_t halo = 2 * static_cast<size_t>(k) * r;
  const size_t smem = sizeof(T) * (kTapSlots + 2 * (kTile + halo));
  const int e = set_smem(reinterpret_cast<const void*>(
                             pass_kernel<T, R, kPairs>), smem);
  if (e != 0) return e;
  pass_kernel<T, R, kPairs><<<rounded / kTile, kThreads, smem, stream>>>(
      in, out, taps, r, k, len, origin, n);
  return static_cast<int>(cudaGetLastError());
}

// A wide pass: the host's nonzero taps (off[i], w[i]), i < n_taps, copied
// into the launch's parameters; tiles of `tile` cells.
template <typename T>
int launch_wide(const T* in, T* out, const int* off, const T* w, int n_taps,
                int r, int k, int len, int origin, int n, int rounded,
                int tile, cudaStream_t stream) {
  if (n_taps < 0 || n_taps > 2 * r + 1 || (n_taps > 0 && (!off || !w)) ||
      (tile != 256 && tile != 512 && tile != 1024 && tile != kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  WideTaps<T> taps = {};
  taps.n = n_taps;
  for (int i = 0; i < n_taps; ++i) {
    if (off[i] < -r || off[i] > r)
      return static_cast<int>(cudaErrorInvalidValue);
    taps.off[i] = off[i];
    taps.w[i] = w[i];
  }
  const size_t smem = sizeof(T) * wide_cells<T>(tile, k * r, k);
  const int e =
      set_smem(reinterpret_cast<const void*>(wide_kernel<T>), smem);
  if (e != 0) return e;
  wide_kernel<T><<<rounded / tile, tile / chains<T>(), smem, stream>>>(
      in, out, taps, r, k, len, origin, n, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R, bool kPairs>
int launch_resident(const T* in, T* out0, T* out1, const T* taps, int r,
                    int steps, int refresh, int len, int origin, int n,
                    int rounded, cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(resident_kernel<T, R, kPairs>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // a chunk per SM, in whole thread sweeps, at least kMinChunk cells
  int chunk = (rounded + sms - 1) / sms;
  chunk = (chunk + kThreads - 1) / kThreads * kThreads;
  if (chunk < kMinChunk) chunk = kMinChunk;
  const int blocks = (rounded + chunk - 1) / chunk;
  const size_t smem =
      sizeof(T) *
      (kTapSlots + 2 * (chunk + 2 * static_cast<size_t>(refresh) * r));
  const int se = set_smem(kernel, smem);
  if (se != 0) return se;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks > per_sm * sms)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&in,  &out0,   &out1,   &taps, &r,       &steps,
                  &refresh, &len, &origin, &n,    &rounded, &chunk};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                  smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The narrow instantiation for (T, r): radii 1..8 at compile time, 9..32 at
// run time.
#define LS_NARROW(FN, T, ...)                          \
  switch (r) {                                         \
    case 1: return FN<T, 1, true>(__VA_ARGS__);        \
    case 2: return FN<T, 2, true>(__VA_ARGS__);        \
    case 3: return FN<T, 3, true>(__VA_ARGS__);        \
    case 4: return FN<T, 4, true>(__VA_ARGS__);        \
    case 5: return FN<T, 5, true>(__VA_ARGS__);        \
    case 6: return FN<T, 6, true>(__VA_ARGS__);        \
    case 7: return FN<T, 7, true>(__VA_ARGS__);        \
    case 8: return FN<T, 8, true>(__VA_ARGS__);        \
    default: return FN<T, 0, true>(__VA_ARGS__);       \
  }

// k fused steps over the rounded interior [0, rounded) of a buffer of `len`
// cells whose interior starts at `origin`; `rounded` is whole 2048-cell
// tiles.  Narrow takes the taps from `taps` (device); wide from the host's
// nonzero pairs (wide_off, wide_w), in tiles of `tile` cells.
template <typename T>
int pass(const T* in, T* out, const T* taps, const int* wide_off,
         const T* wide_w, int wide_n, int r, int k, int narrow, int len,
         int origin, int n, int rounded, int tile, void* stream) {
  if (r < 0 || r > kMaxRadius || k < 1 || k > kMaxK || n < 0 ||
      rounded < n || rounded % kTile != 0 || origin < k * r ||
      origin + rounded > len)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rounded == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!narrow)
    return launch_wide(in, out, wide_off, wide_w, wide_n, r, k, len, origin,
                       n, rounded, tile, s);
  LS_NARROW(launch_pass, T, in, out, taps, r, k, len, origin, n, rounded, s);
}

// All `steps` steps, the halo reloaded every `refresh` steps, into out0 and
// out1 by turns: the result is in out0 when ceil(steps / refresh) is odd.
template <typename T>
int resident(const T* in, T* out0, T* out1, const T* taps, int r, int steps,
             int refresh, int narrow, int len, int origin, int n, int rounded,
             void* stream) {
  if (r < 0 || r > kMaxRadius || steps < 1 || refresh < 1 || n < 0 ||
      rounded < n || origin < 0 || origin + rounded > len)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rounded == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!narrow)
    return launch_resident<T, 0, false>(in, out0, out1, taps, r, steps,
                                        refresh, len, origin, n, rounded, s);
  LS_NARROW(launch_resident, T, in, out0, out1, taps, r, steps, refresh, len,
            origin, n, rounded, s);
}

}  // namespace

extern "C" int ls_stencil1d_pass(const float* in, float* out,
                                 const float* taps, int r, int k, int narrow,
                                 int len, int origin, int n, int rounded,
                                 void* stream, const int* wide_off,
                                 const float* wide_w, int wide_n, int tile) {
  return pass(in, out, taps, wide_off, wide_w, wide_n, r, k, narrow, len,
              origin, n, rounded, tile, stream);
}

extern "C" int ls_stencil1d_pass_f64(const double* in, double* out,
                                     const double* taps, int r, int k,
                                     int narrow, int len, int origin, int n,
                                     int rounded, void* stream,
                                     const int* wide_off,
                                     const double* wide_w, int wide_n,
                                     int tile) {
  return pass(in, out, taps, wide_off, wide_w, wide_n, r, k, narrow, len,
              origin, n, rounded, tile, stream);
}

extern "C" int ls_stencil1d_resident(const float* in, float* out0,
                                     float* out1, const float* taps, int r,
                                     int steps, int refresh, int narrow,
                                     int len, int origin, int n, int rounded,
                                     void* stream) {
  return resident(in, out0, out1, taps, r, steps, refresh, narrow, len,
                  origin, n, rounded, stream);
}

extern "C" int ls_stencil1d_resident_f64(const double* in, double* out0,
                                         double* out1, const double* taps,
                                         int r, int steps, int refresh,
                                         int narrow, int len, int origin,
                                         int n, int rounded, void* stream) {
  return resident(in, out0, out1, taps, r, steps, refresh, narrow, len,
                  origin, n, rounded, stream);
}
