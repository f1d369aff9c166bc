// Dirichlet0 timesteps of a 1-D stencil on the port's flat internal layout
// (ops/layout.py Layout1D), in float32 or float64, on CUDA cores.
//
// Replaces the four TPU kernels of lorastencil_tpu/ops/pallas_1d.py:
//   * a pass of k fused steps:
//       narrow, float32 -> _stencil1d_lanes_kernel (stencil1d_lanes_step):
//              lanes_kernel (ls_stencil1d_lanes);
//       wide   -> _stencil1d_kernel (stencil1d_step): wide_kernel
//              (ls_stencil1d_pass);
//   * a whole run in one cooperative launch, both on run_kernel (the state
//     resident in shared memory, neighbour-only exchanges every m steps):
//       narrow -> _stencil1d_resident_lanes_kernel (stencil1d_resident_lanes):
//              its narrow instances (ls_stencil1d_run_lanes);
//       wide   -> _stencil1d_resident_kernel (stencil1d_resident):
//              its wide instances (ls_stencil1d_run).
// Their float64 instances (the *_f64 entries) replace the fp64-grade TPU
// kernels of lorastencil_tpu/ops/pallas_df64_1d.py, which compute on
// error-free (hi, lo) fp32 pairs because the TPU has no fp64 unit; here the
// arithmetic is native double:
//       narrow pass -> _df64_1d_lanes_kernel (df64_1d_step): pass_kernel,
//       wide pass   -> _df64_1d_flat_kernel (df64_1d_flat_step),
//       narrow run  -> the kernel of stencil1d_resident_pair;
// and the wide run serves dtype float64 (pallas_1d.stencil1d_resident in
// float64).  pass_kernel<float> and resident_kernel (every instance: the
// grid-synced runs of the first port) are on no path: they stay as what
// chip_smoke.py and the card tests hold lanes_kernel and run_kernel against.
// Every substep computes out[f] = sum_{|d| <= r} taps[r + d] * in[f + d] (r
// the effective radius: the taps come trimmed of their zero ends) and zeroes
// every cell outside the interior [0, n), the reference's halo decay; under
// a ghost boundary (periodic, reflect) a pass's substeps before the last keep
// [lo, hi), the interior and the ring the host refilled (the JAX kernels'
// `bounds`).
//
// The order of each sum, which the plain twins in ops/stencil1d.py repeat:
// the centre, then d = 1..r; narrow (passes and runs) adds an equal pair
// taps[r+d] == taps[r-d] as one product of the pair's sum
// (pallas_1d._conv_lanes), wide adds +d then -d (pallas_1d._conv_flat); zero
// taps are skipped.  Every product and sum is
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
//   * the float32 narrow pass (lanes_kernel) is a register window: each
//     thread owns kLanesV = 8 contiguous cells, and per substep reads the
//     8 + 2P cells around them (P = r rounded up to 4) from shared memory
//     as 16-byte words into registers and computes its 8 sums there, the
//     window indexed only by constants (the radius is a template parameter
//     1..8; 9..32 take one instance that reads each tap's cells from shared
//     memory).  About 2 shared loads a cell instead of 2r + 1.  The taps
//     come as a host plan by value (TapPlan: the centre, then per d a
//     pair, one tap or both, in the twin's order), so no cell tests a tap
//     for zero or for its pair.  The tile and its k*r halo, rounded up to
//     whole groups of 8, are staged by 16-byte cp.async and the last
//     substep is written with 16-byte stores; tiles of 2048 to 256 cells
//     (ops/stencil1d.py lanes_tile) keep 1,000,000 cells in one even wave
//     and a 16,777,216-cell grid's halo small.  The TPU's overlapped
//     lanes, duplicated cells that make a shift one lane roll, have no use
//     here: a shift is an address offset;
//   * the float64 narrow pass (pass_kernel<double>) keeps the radius at
//     compile time and the taps in registers, one cell per thread and sweep;
//   * both runs (run_kernel; a template parameter picks the wide or the
//     narrow sum order, the narrow one without lanes_kernel's branch per d:
//     window_sums) keep the state in shared memory for the whole run, as
//     the TPU kernels keep it in VMEM: B blocks each own a
//     chunk of the rounded interior (B = 1 where the grid fits one block
//     and its steps are short, ops/stencil1d.py run_plan) and hold it twice
//     (ping-pong windows) with m*r cells each side.  A block computes m
//     steps on a trapezoid that shrinks by r a step, then swaps m*r border
//     cells with its two neighbours only, as tagged 8-byte words (the
//     cell's bits beside the step's number, one relaxed store each; two
//     parities, as csrc/resident2d.cu's): no grid barrier, and global
//     memory only for the first load, the exchanges and the last store.
//     The TPU's narrow run reloads its lane halo every min(8, 32 / r)
//     steps; here nothing is reloaded: a halo comes from the neighbours;
//   * resident_kernel, the first port's run and now only a comparison, is
//     one cooperative launch that runs `refresh` steps of each chunk from
//     global memory, writes the chunk to one of two buffers and syncs the
//     grid before it reloads (__ldcg: other blocks wrote the buffer since).
// The TPU's split-bf16 matmuls only emulated exact fp32 on its matrix unit;
// CUDA cores do exact fp32 directly.
//
// The narrow kernels and both runs have the radius as a template
// parameter (1..8, loops unrolled) and one runtime-radius instantiation
// (the narrow ones for 9..32, the wide run for the rest); the wide pass
// keeps its loop over its tap pairs rolled (a fully unrolled wide-radius
// loop makes ptxas very slow).  Shared memory holds twice the
// bytes per cell in fp64, so a fp64 pass's reach k*r and a fp64 run's chunk
// per block reach about half their fp32 caps: the launch refuses what does
// not fit (and a run whose blocks cannot all be resident, checked on the
// fp64 instantiation itself).
//
// C interface, loaded with ctypes: every function launches on the given
// stream, allocates nothing and returns a cudaError_t (0 = launched).  A
// pass also takes, after the stream, a wide pass's nonzero taps on the host
// (offsets, weights, count) and its tile; ls_stencil1d_lanes the narrow
// plan's host arrays; ls_stencil1d_run(_f64) the wide taps, the zeroed
// exchange words and the host's (B, m) plan; ls_stencil1d_run_lanes(_f64)
// the same with the narrow plan's host arrays in place of the wide taps.

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
// buffer holding cells [f0, f0 + len) at offset steps*r.  Every substep keeps
// the interior [0, n); with kBox those before the last keep [lo, hi) instead
// (the interior and, under a ghost boundary, the ring the host refilled: the
// JAX kernels' `bounds`): the ring the last would keep is refilled before
// the next pass reads it.
template <typename T, int R, bool kPairs, bool kBox>
__device__ __forceinline__ T* substeps(T* a, T* b, const T* t, int r,
                                       int steps, int f0, int len, int n,
                                       int lo, int hi) {
  const int H = steps * r;
  for (int s = 1; s <= steps; ++s) {
    const int e = (steps - s) * r;  // this level's extent beyond the cells
    const bool box = kBox && s < steps;
    for (int i = H - e + threadIdx.x; i < H + len + e; i += kThreads) {
      const int f = f0 - H + i;
      const T v = tap_sum<T, R, kPairs>(a + i, t, r);
      const bool in = box ? f >= lo && f < hi : f >= 0 && f < n;
      b[i] = in ? v : T(0);
    }
    __syncthreads();
    T* tmp = a;
    a = b;
    b = tmp;
  }
  return a;
}

template <typename T, int R, bool kPairs, bool kBox>
__global__ void __launch_bounds__(kThreads)
pass_kernel(const T* __restrict__ in, T* __restrict__ out,
            const T* __restrict__ taps, int r, int k, int len, int origin,
            int n, int lo, int hi) {
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
    res = substeps<T, R, kPairs, kBox>(a, b, t, r, k, t0, kTile, n, lo, hi);
  } else {
    res = substeps<T, 0, kPairs, kBox>(a, b, s_taps, r, k, t0, kTile, n, lo,
                                       hi);
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
// the last one, masked to [0, n), written to `out`, the others masked to
// [lo, hi) (see substeps).
template <typename T>
__global__ void __launch_bounds__(kTile / chains<T>())
wide_kernel(const T* __restrict__ in, T* __restrict__ out,
            const __grid_constant__ WideTaps<T> taps, int r, int k, int len,
            int origin, int n, int tile, int lo, int hi) {
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
    const int first = H - e;
    const int cnt = tile + 2 * e;
    const int a_lo = s == k ? 0 : lo, a_hi = s == k ? n : hi;
    T* dst = spare;
    for (int base = 0; base < cnt; base += K * nt) {
      int idx[K];
#pragma unroll
      for (int c = 0; c < K; ++c)
        idx[c] = first + min(base + c * nt + tid, cnt - 1);
      T acc[K];
      wide_sums(src, idx, taps, acc);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (base + c * nt + tid >= cnt) continue;
        const int f = t0 + idx[c] - H;  // interior coordinate
        const T v = (f >= a_lo && f < a_hi) ? acc[c] : T(0);
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

// ---- register windows: the float32 narrow pass and the wide run ---------

constexpr int kLanesV = 8;          // contiguous cells a lanes thread owns
constexpr int kLanesMaxReach = 32;  // r and k * r (MAX_LANES_REACH)
constexpr int kLanesMaxThreads = kTile / kLanesV;

// What a substep adds for one d, decided on the host: bit 0 the +d tap's
// product, bit 1 then the -d tap's, or kPair alone, one product of the
// pair's sum (the narrow twin's pairs; ops/stencil1d.py lanes_plan).  The
// wide run's plan has no pairs: +d then -d, the wide twin's order.
constexpr int kPlus = 1;
constexpr int kMinus = 2;
constexpr int kPair = 4;

// A tap plan by value: the centre's product first where its tap is nonzero,
// then per d = 1..r its kind and weights (a pair's in wp).
template <typename T>
struct TapPlan {
  int centre;
  T c;
  int kind[kMaxRadius + 1];  // index d
  T wp[kMaxRadius + 1];
  T wm[kMaxRadius + 1];
};
static_assert(sizeof(TapPlan<double>) + 128 <= 4096,
              "a tap plan and the other parameters must fit in 4 KB");

// Cells of one 16-byte word, and the cells a window reaches beyond its
// group on each side: the radius in whole words.
template <typename T>
__host__ __device__ constexpr int vec_cells() {
  return 16 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int window_pad(int r) {
  return (r + vec_cells<T>() - 1) / vec_cells<T>() * vec_cells<T>();
}

__device__ __forceinline__ void load16(const float* p, float* w) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  w[0] = q.x;
  w[1] = q.y;
  w[2] = q.z;
  w[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double* w) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  w[0] = q.x;
  w[1] = q.y;
}
// 16 bytes to shared or global memory (p 16-byte aligned).
__device__ __forceinline__ void store16(float* p, const float* w) {
  *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store16(double* p, const double* w) {
  *reinterpret_cast<double2*>(p) = make_double2(w[0], w[1]);
}

// acc + p where `on`, else acc: a predicated add, so that a tap the plan
// leaves out costs no branch (its product, computed anyway, is dropped).
__device__ __forceinline__ float add_if(float acc, float p, int on) {
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q add.rn.f32 %0, %0, %1;\n\t}"
      : "+f"(acc)
      : "f"(p), "r"(on));
  return acc;
}
__device__ __forceinline__ double add_if(double acc, double p, int on) {
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q add.rn.f64 %0, %0, %1;\n\t}"
      : "+d"(acc)
      : "d"(p), "r"(on));
  return acc;
}

// The forms of a cell's sums (window_sums), a template parameter: the wide
// order (+d then -d); the narrow order (an equal pair as one product of its
// sum) by a uniform branch per d on its kind (the narrow pass); and, without
// a branch, for a narrow plan whose every d is a pair or nothing (every
// registry shape), or for any narrow plan (the narrow run).
constexpr int kWideSums = 0;
constexpr int kPairBranch = 1;
constexpr int kPairSums = 2;
constexpr int kMixedSums = 3;

// The sums of the V cells x[0 .. V) (x in shared memory, 16-byte aligned,
// window_pad(r) cells readable on each side), the plan's terms in order,
// every product and sum rounded on its own.  Without a centre the first term
// is added to -0, which leaves it as it is.  R > 0: the window first into
// registers by 16-byte loads, indexed only by constants, about 1 + 2R / V
// cells loaded a cell instead of a load a tap; R == 0 (any radius): each
// term's cells read from shared memory.  Without a branch, every product a
// form can need is computed and added where the plan has its term
// (add_if): kWideSums the +d and the -d tap's, kPairSums the pair's,
// kMixedSums the pair's, then the +d and the -d tap's.  No branch between
// the d, whose chains then overlap.  kPairBranch computes only what the
// kind of d asks for, behind a uniform branch: fewer operations, which the
// narrow pass (bound by bytes) keeps; in the runs (bound by a step's chain
// of latencies) the branches cost more than the products they save.
// kPairSums with R > 0 runs the cells in the outer loop: fewer window cells
// live at once (with the d outside, two float64 instances spilled).
template <typename T, int R, int V, int kForm>
__device__ __forceinline__ void window_sums(const T* x, const TapPlan<T>& pl,
                                            int r, T (&acc)[V]) {
  constexpr bool kAddPair = kForm == kPairSums || kForm == kMixedSums;
  constexpr bool kAddTaps = kForm == kWideSums || kForm == kMixedSums;
  if constexpr (R > 0) {
    constexpr int P = window_pad<T>(R);
    T w[V + 2 * P];
#pragma unroll
    for (int j = 0; j < V + 2 * P; j += vec_cells<T>())
      load16(x - P + j, w + j);
#pragma unroll
    for (int c = 0; c < V; ++c)
      acc[c] = pl.centre ? mul_rn(pl.c, w[P + c]) : T(-0.0);
    if constexpr (kForm == kPairSums) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
#pragma unroll
        for (int d = 1; d <= R; ++d)
          acc[c] = add_if(acc[c],
                          mul_rn(pl.wp[d], add_rn(w[P + c + d], w[P + c - d])),
                          pl.kind[d] == kPair);
      }
      return;
    }
    if constexpr (kForm != kPairBranch) {
#pragma unroll
      for (int d = 1; d <= R; ++d) {
        const int pair = pl.kind[d] == kPair;
        const int plus = pl.kind[d] & kPlus;
        const int minus = pl.kind[d] & kMinus;
        const T wp = pl.wp[d];
        const T wm = pl.wm[d];
#pragma unroll
        for (int c = 0; c < V; ++c) {
          if constexpr (kForm == kMixedSums)
            acc[c] = add_if(acc[c],
                            mul_rn(wp, add_rn(w[P + c + d], w[P + c - d])),
                            pair);
          if constexpr (kAddTaps) {
            acc[c] = add_if(acc[c], mul_rn(wp, w[P + c + d]), plus);
            acc[c] = add_if(acc[c], mul_rn(wm, w[P + c - d]), minus);
          }
        }
      }
      return;
    }
#pragma unroll
    for (int d = 1; d <= R; ++d) {
      const int kind = pl.kind[d];
      const T wp = pl.wp[d];
      const T wm = pl.wm[d];
      if (kind & kPair) {
#pragma unroll
        for (int c = 0; c < V; ++c)
          acc[c] = add_rn(acc[c],
                          mul_rn(wp, add_rn(w[P + c + d], w[P + c - d])));
      } else {
        if (kind & kPlus) {
#pragma unroll
          for (int c = 0; c < V; ++c)
            acc[c] = add_rn(acc[c], mul_rn(wp, w[P + c + d]));
        }
        if (kind & kMinus) {
#pragma unroll
          for (int c = 0; c < V; ++c)
            acc[c] = add_rn(acc[c], mul_rn(wm, w[P + c - d]));
        }
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c)
      acc[c] = pl.centre ? mul_rn(pl.c, x[c]) : T(-0.0);
#pragma unroll 1
    for (int d = 1; d <= r; ++d) {
      const int kind = pl.kind[d];
      const T wp = pl.wp[d];
      const T wm = pl.wm[d];
      const T* xp = x + d;
      const T* xm = x - d;
      if constexpr (kAddPair) {
        const int pair = kind == kPair;
        const int plus = kind & kPlus;
        const int minus = kind & kMinus;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          acc[c] = add_if(acc[c], mul_rn(wp, add_rn(xp[c], xm[c])), pair);
          if constexpr (kAddTaps) {
            acc[c] = add_if(acc[c], mul_rn(wp, xp[c]), plus);
            acc[c] = add_if(acc[c], mul_rn(wm, xm[c]), minus);
          }
        }
        continue;
      }
      if (kind & kPair) {
#pragma unroll
        for (int c = 0; c < V; ++c)
          acc[c] = add_rn(acc[c], mul_rn(wp, add_rn(xp[c], xm[c])));
      } else {
        if (kind & kPlus) {
#pragma unroll
          for (int c = 0; c < V; ++c)
            acc[c] = add_rn(acc[c], mul_rn(wp, xp[c]));
        }
        if (kind & kMinus) {
#pragma unroll
          for (int c = 0; c < V; ++c)
            acc[c] = add_rn(acc[c], mul_rn(wm, xm[c]));
        }
      }
    }
  }
}

// 0 for the cells of the group at interior cell f0 outside [lo, hi).
__device__ __forceinline__ void lanes_mask(float (&acc)[kLanesV], int f0,
                                           int lo, int hi) {
  if (f0 >= lo && f0 + kLanesV <= hi) return;
#pragma unroll
  for (int c = 0; c < kLanesV; ++c)
    if (f0 + c < lo || f0 + c >= hi) acc[c] = 0.0f;
}

// k masked substeps over a tile of `tile` = blockDim.x * kLanesV cells.  The
// tile and E = k*r rounded up to whole groups on each side are staged at
// a[P + i] (staged cell i: interior cell t0 - E + i); substep s computes
// the groups that cover the tile and (k - s) * r cells each side, a -> b
// -> a ..., masked to [lo, hi); the last one, masked to [0, n), goes to
// `out` (see substeps).  Cells a group computes beyond what
// its substep needs read the unwritten ends of a window: their values are
// never read by a cell that is kept.
template <int R>
__global__ void __launch_bounds__(kLanesMaxThreads)
lanes_kernel(const float* __restrict__ in, float* __restrict__ out,
             const __grid_constant__ TapPlan<float> pl, int r, int k,
             int len, int origin, int n, int tile, int vec, int lo, int hi) {
  constexpr int V = kLanesV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int P = window_pad<float>(R > 0 ? R : r);
  const int E = (k * r + V - 1) / V * V;
  const int S = tile + 2 * E;  // staged cells
  float* a = reinterpret_cast<float*>(smem_raw);
  float* b = a + S + 2 * P;
  const int t0 = blockIdx.x * tile;  // tile origin, interior coordinates
  const int g0 = origin + t0 - E;    // buffer index of staged cell 0

  // 16-byte chunks: whole ones inside the buffer by cp.async where the
  // buffer is aligned, the rest cell by cell (0 outside the buffer)
  for (int c = tid; c < S / 4; c += nt) {
    const int g = g0 + 4 * c;
    float* dst = a + P + 4 * c;
    if (vec && g >= 0 && g + 4 <= len) {
      cp_async16(dst, in + g);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        dst[v] = (g + v >= 0 && g + v < len) ? in[g + v] : 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const float* src = a;
  float* dst = b;
  for (int s = 1; s < k; ++s) {
    const int e = (k - s) * r;  // this substep's extent beyond the tile
    const int q_end = (E + tile + e + V - 1) / V;
    for (int q = (E - e) / V + tid; q < q_end; q += nt) {
      float acc[V];
      window_sums<float, R, V, kPairBranch>(src + P + q * V, pl, r, acc);
      lanes_mask(acc, t0 - E + q * V, lo, hi);
      store16(dst + P + q * V, acc);
      store16(dst + P + q * V + 4, acc + 4);
    }
    __syncthreads();
    float* const spare = const_cast<float*>(src);
    src = dst;
    dst = spare;
  }
  // the last substep: the tile, one group a thread
  float acc[V];
  window_sums<float, R, V, kPairBranch>(src + P + E + tid * V, pl, r, acc);
  const int f0 = t0 + tid * V;
  lanes_mask(acc, f0, 0, n);
  float* o = out + origin + f0;
  if (vec) {
    store16(o, acc);
    store16(o + 4, acc + 4);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) o[c] = acc[c];
  }
}

// ---- both runs: state resident in shared memory (run_kernel) -------------

constexpr int kRunMaxThreads = 1024;
// a wait's limit in SM clock cycles: seconds at any clock the card runs
constexpr long long kSpinLimitCycles = 8000000000ll;
constexpr int kHaloLoads = 4;  // halo cells whose loads a thread has out

// The exchange words (csrc/resident2d.cu's): 8-byte words of 32 bits of a
// cell beside the number of the state it belongs to, two a float64 cell,
// stored and polled with relaxed device-scope accesses.
__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A wait that outlasts kSpinLimitCycles traps (the launch fails).
__device__ __forceinline__ void check_spin(long long& t0) {
  if (t0 == 0) {
    t0 = clock64();
  } else if (clock64() - t0 > kSpinLimitCycles) {
    __trap();
  }
}

template <typename T>
__device__ __forceinline__ void store_tagged(unsigned long long* p, T v,
                                             unsigned tag) {
  const unsigned long long hi = static_cast<unsigned long long>(tag) << 32;
  if constexpr (sizeof(T) == 4) {
    store_word(p, hi | __float_as_uint(v));
  } else {
    const unsigned long long b = __double_as_longlong(v);
    store_word(p, hi | (b & 0xffffffffull));
    store_word(p + 1, hi | (b >> 32));
  }
}

// The cell whose words `lo` (and `hi`, float64) were loaded from `p`, once
// both carry `tag`: reloaded until they do.
template <typename T>
__device__ __forceinline__ T settle_tagged(const unsigned long long* p,
                                           unsigned long long lo,
                                           unsigned long long hi,
                                           unsigned tag) {
  long long t0 = 0;
  while (static_cast<unsigned>(lo >> 32) != tag) {
    check_spin(t0);
    lo = load_word(p);
  }
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(static_cast<unsigned>(lo));
  } else {
    while (static_cast<unsigned>(hi >> 32) != tag) {
      check_spin(t0);
      hi = load_word(p + 1);
    }
    return __longlong_as_double(static_cast<long long>(
        (hi << 32) | (lo & 0xffffffffull)));
  }
}

// A run's shape and the host's plan: B blocks, each owning the interior
// cells of groups [b * G / B, (b + 1) * G / B) (G = rounded / V groups of V
// = run_cells cells); m steps between exchanges; a window of `halo` (whole
// groups, >= m * r where B > 1, >= r) cells on each side.
struct RunGrid {
  int r, steps, blocks, m, halo;
  int len, origin, n, rounded;
};

// Contiguous cells a run thread owns: two 16-byte words where the radius
// has a register window (R > 0), else one, for more threads.
template <typename T, int R>
__host__ __device__ constexpr int run_cells() {
  return (R > 0 ? 2 : 1) * vec_cells<T>();
}

// The first cell of block b's chunk.
__host__ __device__ inline int run_chunk_start(const RunGrid& g, int V,
                                               int b) {
  return static_cast<int>(static_cast<long long>(b) * (g.rounded / V) /
                          g.blocks) * V;
}

// Shared cells of one of a run's two windows: the largest chunk, its halo
// and the window's reach.
template <typename T, int R>
__host__ __device__ inline int run_window(const RunGrid& g, int P) {
  constexpr int V = run_cells<T, R>();
  const int cmax = (g.rounded / V + g.blocks - 1) / g.blocks * V;
  return cmax + 2 * g.halo + 2 * P;
}

// All `steps` steps.  Window index i of a block holds interior cell c0 -
// halo + i, P cells into its window.  Phase p runs mp = min(m, steps
// left) steps: step j computes the chunk and (mp - j) * r cells on each
// side that has a neighbour, so the chunk is whole after mp steps; on a
// side without one the r cells beyond the chunk are the guard's halo for
// step 1 and 0 after it.  A thread computes groups of V cells from a
// register window (window_sums); a group's cells beyond what a step needs
// are masked to 0 where they lie outside [0, n), else read only by cells
// that are not kept.  The last step of a phase sends the chunk's first and
// last m' * r cells (m' the next phase's steps) to the exchange, parity
// p % 2, tagged with the state's number; the next phase first polls its
// halo from the neighbours' words.  Two parities suffice: a block
// overwrites parity p % 2 after phase p + 2, which needs its neighbours'
// phase p + 1 borders, which they send only after reading its phase p
// border.  The launch is cooperative, so every block is resident; a wait
// traps after kSpinLimitCycles.  kForm: the sums' form, kWideSums for the
// wide run, kPairSums or kMixedSums for the narrow run; nothing else
// differs.
template <typename T, int R, int kForm>
__global__ void __launch_bounds__(kRunMaxThreads)
run_kernel(const T* __restrict__ in, T* __restrict__ out,
           unsigned long long* xch, const __grid_constant__ TapPlan<T> pl,
           RunGrid g) {
  constexpr int V = run_cells<T, R>();
  constexpr int KW = sizeof(T) / 4;  // exchange words a cell
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int bx = blockIdx.x;
  const int r = g.r;
  const int HW = g.halo;
  const int P = window_pad<T>(R > 0 ? R : r);
  const int c0 = run_chunk_start(g, V, bx);
  const int C = run_chunk_start(g, V, bx + 1) - c0;
  const bool has_l = bx > 0;
  const bool has_r = bx + 1 < g.blocks;
  T* const win0 = reinterpret_cast<T*>(smem_raw) + P;  // window index 0
  T* const win1 = win0 + run_window<T, R>(g, P);
  const long long slot_words = static_cast<long long>(g.m) * r * KW;
  auto slot = [&](int par, int blk, int side) {
    return xch + ((static_cast<long long>(par) * g.blocks + blk) * 2 + side) *
                     slot_words;
  };

  {  // the chunk and the first phase's halo from `in`; win1's outer r cells 0
    const int m0 = min(g.m, g.steps);
    const int hl = has_l ? m0 * r : r;
    const int hr = has_r ? m0 * r : r;
#pragma unroll 4
    for (int i = HW - hl + tid; i < HW + C + hr; i += nt) {
      const int gi = g.origin + c0 - HW + i;
      win0[i] = (gi >= 0 && gi < g.len) ? in[gi] : T(0);
    }
    if (!has_l)
      for (int i = tid; i < r; i += nt) win1[HW - r + i] = T(0);
    if (!has_r)
      for (int i = tid; i < r; i += nt) win1[HW + C + i] = T(0);
  }
  __syncthreads();

  int done = 0;  // steps done: the state's number
  int cur = 0;   // the window holding it
  for (int p = 0;; ++p) {
    const int mp = min(g.m, g.steps - done);
    if (p > 0) {
      // state `done`'s halo: the neighbours' borders at parity (p - 1) % 2,
      // kHaloLoads cells a thread at a time, their loads out together
      T* const w = cur ? win1 : win0;
      const int hc = mp * r;
      const int nl = has_l ? hc : 0;
      const int total = nl + (has_r ? hc : 0);
      const int par = (p - 1) & 1;
      for (int i0 = tid; i0 < total; i0 += kHaloLoads * nt) {
        int cell[kHaloLoads];
        const unsigned long long* wp[kHaloLoads];
        unsigned long long lo[kHaloLoads], hi[kHaloLoads];
#pragma unroll
        for (int i = 0; i < kHaloLoads; ++i) {
          const int idx = i0 + i * nt;
          cell[i] = -1;
          wp[i] = nullptr;
          lo[i] = hi[i] = 0;
          if (idx >= total) continue;
          if (idx < nl) {  // the left neighbour's last hc cells
            cell[i] = HW - hc + idx;
            wp[i] = slot(par, bx - 1, 1) + static_cast<long long>(idx) * KW;
          } else {  // the right neighbour's first hc cells
            cell[i] = HW + C + idx - nl;
            wp[i] = slot(par, bx + 1, 0) +
                    static_cast<long long>(idx - nl) * KW;
          }
          lo[i] = load_word(wp[i]);
          if (KW == 2) hi[i] = load_word(wp[i] + 1);
        }
#pragma unroll
        for (int i = 0; i < kHaloLoads; ++i)
          if (cell[i] >= 0)
            w[cell[i]] = settle_tagged<T>(wp[i], lo[i], hi[i], done);
      }
      __syncthreads();
    }
    const int bc = min(g.m, g.steps - done - mp) * r;  // border cells to send
    for (int j = 1; j <= mp; ++j) {
      const T* src = cur ? win1 : win0;
      T* dst = cur ? win0 : win1;
      const int lo = HW - (has_l ? (mp - j) * r : 0);
      const int hi = HW + C + (has_r ? (mp - j) * r : 0);
      const bool send = j == mp && bc > 0;
      const unsigned tag = done + j;
      for (int q = lo / V + tid; q * V < hi; q += nt) {
        T acc[V];
        window_sums<T, R, V, kForm>(src + q * V, pl, r, acc);
        const int u0 = q * V - HW;  // chunk coordinate of the group's cell 0
        if (c0 + u0 < 0 || c0 + u0 + V > g.n) {
#pragma unroll
          for (int c = 0; c < V; ++c)
            if (c0 + u0 + c < 0 || c0 + u0 + c >= g.n) acc[c] = T(0);
        }
        if (send && u0 + V > 0 && u0 < C &&
            ((has_l && u0 < bc) || (has_r && u0 + V > C - bc))) {
#pragma unroll
          for (int c = 0; c < V; ++c) {
            const int u = u0 + c;
            if (u < 0 || u >= C) continue;
            if (has_l && u < bc)
              store_tagged(slot(p & 1, bx, 0) + static_cast<long long>(u) * KW,
                           acc[c], tag);
            if (has_r && u >= C - bc)
              store_tagged(slot(p & 1, bx, 1) +
                               static_cast<long long>(u - (C - bc)) * KW,
                           acc[c], tag);
          }
        }
#pragma unroll
        for (int c = 0; c < V; c += vec_cells<T>())
          store16(dst + q * V + c, acc + c);
      }
      if (done + j == 2) {
        // win0's outer cells held the guard for step 1; nothing reads win0
        // in step 2, and step 3 reads them as 0
        if (!has_l)
          for (int i = tid; i < r; i += nt) win0[HW - r + i] = T(0);
        if (!has_r)
          for (int i = tid; i < r; i += nt) win0[HW + C + i] = T(0);
      }
      __syncthreads();
      cur ^= 1;
    }
    done += mp;
    if (done == g.steps) break;
  }
  const T* res = cur ? win1 : win0;
  for (int i = tid; i < C; i += nt) out[g.origin + c0 + i] = res[HW + i];
  // the guard of `out` (not zeroed by the host): before and after the
  // rounded interior
  if (!has_l)
    for (int i = tid; i < g.origin; i += nt) out[i] = T(0);
  if (!has_r)
    for (int i = g.origin + g.rounded + tid; i < g.len; i += nt) out[i] = T(0);
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
      res = substeps<T, R, kPairs, false>(a, b, t, r, ks, c0, C, n, 0, n);
    } else {
      res = substeps<T, 0, kPairs, false>(a, b, s_taps, r, ks, c0, C, n, 0,
                                          n);
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

template <typename T, int R, bool kPairs, bool kBox>
int launch_pass_box(const T* in, T* out, const T* taps, int r, int k,
                    int len, int origin, int n, int rounded, int lo, int hi,
                    cudaStream_t stream) {
  const size_t halo = 2 * static_cast<size_t>(k) * r;
  const size_t smem = sizeof(T) * (kTapSlots + 2 * (kTile + halo));
  const int e = set_smem(reinterpret_cast<const void*>(
                             pass_kernel<T, R, kPairs, kBox>), smem);
  if (e != 0) return e;
  pass_kernel<T, R, kPairs, kBox>
      <<<rounded / kTile, kThreads, smem, stream>>>(in, out, taps, r, k, len,
                                                    origin, n, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// A box that is not the interior (a ghost boundary's ring, at k >= 2) takes
// the kBox instance.
template <typename T, int R, bool kPairs>
int launch_pass(const T* in, T* out, const T* taps, int r, int k, int len,
                int origin, int n, int rounded, int lo, int hi,
                cudaStream_t stream) {
  if (k > 1 && (lo != 0 || hi != n))
    return launch_pass_box<T, R, kPairs, true>(in, out, taps, r, k, len,
                                               origin, n, rounded, lo, hi,
                                               stream);
  return launch_pass_box<T, R, kPairs, false>(in, out, taps, r, k, len, origin,
                                              n, rounded, lo, hi, stream);
}

// A wide pass: the host's nonzero taps (off[i], w[i]), i < n_taps, copied
// into the launch's parameters; tiles of `tile` cells.
template <typename T>
int launch_wide(const T* in, T* out, const int* off, const T* w, int n_taps,
                int r, int k, int len, int origin, int n, int rounded,
                int tile, int lo, int hi, cudaStream_t stream) {
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
      in, out, taps, r, k, len, origin, n, tile, lo, hi);
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

template <int R>
int launch_lanes(const float* in, float* out, const TapPlan<float>& pl,
                 int r,
                 int k, int len, int origin, int n, int rounded, int tile,
                 int lo, int hi, cudaStream_t stream) {
  const int E = (k * r + kLanesV - 1) / kLanesV * kLanesV;
  const size_t smem =
      sizeof(float) * 2 * (tile + 2 * E + 2 * window_pad<float>(R > 0 ? R : r));
  const int e =
      set_smem(reinterpret_cast<const void*>(lanes_kernel<R>), smem);
  if (e != 0) return e;
  const int vec = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0 && origin % 4 == 0;
  lanes_kernel<R><<<rounded / tile, tile / kLanesV, smem, stream>>>(
      in, out, pl, r, k, len, origin, n, tile, vec, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// A float32 narrow pass: the host's plan (kinds[d - 1], wp[d - 1], wm[d - 1]
// for d = 1..r; the centre's weight c where `centre`), tiles of `tile` cells.
int lanes(const float* in, float* out, const int* kinds, const float* wp,
          const float* wm, int centre, float c, int r, int k, int len,
          int origin, int n, int rounded, int tile, int lo, int hi,
          void* stream) {
  if (r < 1 || r > kLanesMaxReach || k < 1 || k * r > kLanesMaxReach ||
      n < 0 || rounded < n || rounded % kTile != 0 || origin < k * r ||
      lo > 0 || hi < n ||
      origin + rounded > len || !kinds || !wp || !wm ||
      (tile != 256 && tile != 512 && tile != 1024 && tile != kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  TapPlan<float> pl = {};
  pl.centre = centre != 0;
  pl.c = c;
  for (int d = 1; d <= r; ++d) {
    const int kind = kinds[d - 1];
    if (kind != 0 && kind != kPlus && kind != kMinus &&
        kind != (kPlus | kMinus) && kind != kPair)
      return static_cast<int>(cudaErrorInvalidValue);
    pl.kind[d] = kind;
    pl.wp[d] = wp[d - 1];
    pl.wm[d] = wm[d - 1];
  }
  if (rounded == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1: return launch_lanes<1>(in, out, pl, r, k, len, origin, n, rounded, tile, lo, hi, s);
    case 2: return launch_lanes<2>(in, out, pl, r, k, len, origin, n, rounded, tile, lo, hi, s);
    case 3: return launch_lanes<3>(in, out, pl, r, k, len, origin, n, rounded, tile, lo, hi, s);
    case 4: return launch_lanes<4>(in, out, pl, r, k, len, origin, n, rounded, tile, lo, hi, s);
    case 5: return launch_lanes<5>(in, out, pl, r, k, len, origin, n, rounded, tile, lo, hi, s);
    case 6: return launch_lanes<6>(in, out, pl, r, k, len, origin, n, rounded, tile, lo, hi, s);
    case 7: return launch_lanes<7>(in, out, pl, r, k, len, origin, n, rounded, tile, lo, hi, s);
    case 8: return launch_lanes<8>(in, out, pl, r, k, len, origin, n, rounded, tile, lo, hi, s);
    default: return launch_lanes<0>(in, out, pl, r, k, len, origin, n, rounded, tile, lo, hi, s);
  }
}

template <typename T, int R, int kForm>
int launch_run_r(const T* in, T* out, unsigned long long* xch,
                 const TapPlan<T>& pl, RunGrid g, int threads,
                 cudaStream_t stream) {
  constexpr int V = run_cells<T, R>();
  // whole groups, and chunks that give a neighbour its border alone
  if (g.rounded % V != 0 || g.halo % V != 0 ||
      (g.blocks > 1 && static_cast<long long>(g.rounded / V / g.blocks) * V <
                           static_cast<long long>(g.m) * g.r))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel =
      reinterpret_cast<const void*>(run_kernel<T, R, kForm>);
  const size_t smem =
      2 * sizeof(T) * run_window<T, R>(g, window_pad<T>(R > 0 ? R : g.r));
  int e = set_smem(kernel, smem);
  if (e != 0) return e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce == cudaSuccess)
    ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  if (g.blocks > per_sm * sms)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  TapPlan<T> plan = pl;
  void* args[] = {&in, &out, &xch, &plan, &g};
  ce = cudaLaunchCooperativeKernel(kernel, dim3(g.blocks), dim3(threads), args,
                                   smem, stream);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  return static_cast<int>(cudaGetLastError());
}

// A run's instance for (T, r, kForm): radii 1..8 at compile time, the
// rest at run time.
template <typename T, int kForm>
int launch_run_plan(const T* in, T* out, unsigned long long* xch,
                    const TapPlan<T>& pl, RunGrid g, int threads,
                    void* stream) {
  if (g.rounded == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g.r) {
    case 1: return launch_run_r<T, 1, kForm>(in, out, xch, pl, g, threads, s);
    case 2: return launch_run_r<T, 2, kForm>(in, out, xch, pl, g, threads, s);
    case 3: return launch_run_r<T, 3, kForm>(in, out, xch, pl, g, threads, s);
    case 4: return launch_run_r<T, 4, kForm>(in, out, xch, pl, g, threads, s);
    case 5: return launch_run_r<T, 5, kForm>(in, out, xch, pl, g, threads, s);
    case 6: return launch_run_r<T, 6, kForm>(in, out, xch, pl, g, threads, s);
    case 7: return launch_run_r<T, 7, kForm>(in, out, xch, pl, g, threads, s);
    case 8: return launch_run_r<T, 8, kForm>(in, out, xch, pl, g, threads, s);
    default: return launch_run_r<T, 0, kForm>(in, out, xch, pl, g, threads, s);
  }
}

// What every run refuses: a plan whose borders do not come from the
// neighbours alone, too few exchange words (none are read where one phase
// takes every step), a bad block size.
template <typename T>
bool run_grid_ok(const RunGrid& g, int threads,
                 const unsigned long long* xch, long long n_xch) {
  constexpr int KW = sizeof(T) / 4;
  const long long mr = static_cast<long long>(g.m) * g.r;
  return !(g.r < 0 || g.r > kMaxRadius || g.steps < 1 || g.blocks < 1 ||
           g.m < 1 || g.n < 0 || g.rounded < g.n || g.origin < g.r ||
           g.origin + g.rounded > g.len || g.halo < g.r ||
           (g.blocks > 1 && g.halo < mr) ||
           threads < 32 || threads > kRunMaxThreads || threads % 32 != 0 ||
           (g.blocks > 1 && g.steps > g.m &&
            (n_xch < 4LL * g.blocks * mr * KW || !xch)));
}

// A wide run: the host's nonzero taps (off[i], w[i]), i < n_taps, in the
// twin's order (the centre, then +d, -d for d = 1..r), turned into a
// TapPlan by value; the plan in g, `threads` a block; `xch` holds n_xch
// zeroed words; `out` is written whole, its guard zeroed.  Refused: taps
// out of that order, what run_grid_ok refuses, windows beyond shared
// memory, blocks the card cannot hold at once.
template <typename T>
int launch_run(const T* in, T* out, unsigned long long* xch, long long n_xch,
               const int* off, const T* w, int n_taps, RunGrid g, int threads,
               void* stream) {
  if (!run_grid_ok<T>(g, threads, xch, n_xch) || n_taps < 0 ||
      n_taps > 2 * g.r + 1 || (n_taps > 0 && (!off || !w)))
    return static_cast<int>(cudaErrorInvalidValue);
  TapPlan<T> pl = {};
  int i = 0;
  if (i < n_taps && off[i] == 0) {
    pl.centre = 1;
    pl.c = w[i++];
  }
  for (int d = 1; d <= g.r; ++d) {
    if (i < n_taps && off[i] == d) {
      pl.kind[d] |= kPlus;
      pl.wp[d] = w[i++];
    }
    if (i < n_taps && off[i] == -d) {
      pl.kind[d] |= kMinus;
      pl.wm[d] = w[i++];
    }
  }
  if (i != n_taps) return static_cast<int>(cudaErrorInvalidValue);
  return launch_run_plan<T, kWideSums>(in, out, xch, pl, g, threads, stream);
}

// A narrow run: the host's narrow plan (kinds[d - 1], wp[d - 1], wm[d - 1]
// for d = 1..r; the centre's weight c where `centre`), as a float32 narrow
// pass takes it, in the state's precision; the kPairSums instance where
// every d is a pair or nothing, else kMixedSums.  Refused besides: r outside
// [1, kLanesMaxReach], a kind outside {0, kPlus, kMinus, both, kPair}, a
// pair whose two weights differ.
template <typename T>
int launch_run_lanes(const T* in, T* out, unsigned long long* xch,
                     long long n_xch, const int* kinds, const T* wp,
                     const T* wm, int centre, T c, RunGrid g, int threads,
                     void* stream) {
  if (!run_grid_ok<T>(g, threads, xch, n_xch) || g.r < 1 ||
      g.r > kLanesMaxReach || !kinds || !wp || !wm)
    return static_cast<int>(cudaErrorInvalidValue);
  TapPlan<T> pl = {};
  pl.centre = centre != 0;
  pl.c = c;
  bool pairs_only = true;
  for (int d = 1; d <= g.r; ++d) {
    const int kind = kinds[d - 1];
    if ((kind != 0 && kind != kPlus && kind != kMinus &&
         kind != (kPlus | kMinus) && kind != kPair) ||
        (kind == kPair && wp[d - 1] != wm[d - 1]))
      return static_cast<int>(cudaErrorInvalidValue);
    pairs_only = pairs_only && (kind == 0 || kind == kPair);
    pl.kind[d] = kind;
    pl.wp[d] = wp[d - 1];
    pl.wm[d] = wm[d - 1];
  }
  return pairs_only
             ? launch_run_plan<T, kPairSums>(in, out, xch, pl, g, threads,
                                             stream)
             : launch_run_plan<T, kMixedSums>(in, out, xch, pl, g, threads,
                                              stream);
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
// tiles; the substeps before the last keep [lo, hi).  Narrow takes the taps
// from `taps` (device); wide from the host's nonzero pairs (wide_off,
// wide_w), in tiles of `tile` cells.
template <typename T>
int pass(const T* in, T* out, const T* taps, const int* wide_off,
         const T* wide_w, int wide_n, int r, int k, int narrow, int len,
         int origin, int n, int rounded, int tile, int lo, int hi,
         void* stream) {
  if (r < 0 || r > kMaxRadius || k < 1 || k > kMaxK || n < 0 ||
      rounded < n || rounded % kTile != 0 || origin < k * r ||
      origin + rounded > len || lo > 0 || hi < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rounded == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!narrow)
    return launch_wide(in, out, wide_off, wide_w, wide_n, r, k, len, origin,
                       n, rounded, tile, lo, hi, s);
  LS_NARROW(launch_pass, T, in, out, taps, r, k, len, origin, n, rounded, lo,
            hi, s);
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

// The passes' entries end with the cells [lo, hi) that the substeps before
// the last keep (the interior [0, n), or it and a ghost ring).
extern "C" int ls_stencil1d_pass(const float* in, float* out,
                                 const float* taps, int r, int k, int narrow,
                                 int len, int origin, int n, int rounded,
                                 void* stream, const int* wide_off,
                                 const float* wide_w, int wide_n, int tile,
                                 int lo, int hi) {
  return pass(in, out, taps, wide_off, wide_w, wide_n, r, k, narrow, len,
              origin, n, rounded, tile, lo, hi, stream);
}

extern "C" int ls_stencil1d_pass_f64(const double* in, double* out,
                                     const double* taps, int r, int k,
                                     int narrow, int len, int origin, int n,
                                     int rounded, void* stream,
                                     const int* wide_off,
                                     const double* wide_w, int wide_n,
                                     int tile, int lo, int hi) {
  return pass(in, out, taps, wide_off, wide_w, wide_n, r, k, narrow, len,
              origin, n, rounded, tile, lo, hi, stream);
}

extern "C" int ls_stencil1d_lanes(const float* in, float* out,
                                  const int* kinds, const float* wp,
                                  const float* wm, int centre, float c, int r,
                                  int k, int len, int origin, int n,
                                  int rounded, int tile, void* stream, int lo,
                                  int hi) {
  return lanes(in, out, kinds, wp, wm, centre, c, r, k, len, origin, n,
               rounded, tile, lo, hi, stream);
}

// The input, the zeroed output buffer, the zeroed exchange words and their
// number, the nonzero taps, then the radius, steps, blocks, m, the window's
// cells each side, threads a block, the buffer's length, the origin, the
// interior, the rounded interior and the stream.
#define LS_RUN(NAME, T)                                                      \
  extern "C" int NAME(const T* in, T* out, unsigned long long* xch,         \
                      long long n_xch, const int* off, const T* w,          \
                      int n_taps, int r, int steps, int blocks, int m,      \
                      int halo, int threads, int len, int origin, int n,    \
                      int rounded, void* stream) {                          \
    return launch_run<T>(in, out, xch, n_xch, off, w, n_taps,               \
                         RunGrid{r, steps, blocks, m, halo, len, origin, n, \
                                 rounded},                                  \
                         threads, stream);                                  \
  }
LS_RUN(ls_stencil1d_run, float)
LS_RUN(ls_stencil1d_run_f64, double)

// As LS_RUN, with the narrow plan (kinds, wp, wm, centre flag, centre
// weight) in place of the nonzero taps.
#define LS_RUN_LANES(NAME, T)                                                \
  extern "C" int NAME(const T* in, T* out, unsigned long long* xch,         \
                      long long n_xch, const int* kinds, const T* wp,       \
                      const T* wm, int centre, T c, int r, int steps,       \
                      int blocks, int m, int halo, int threads, int len,    \
                      int origin, int n, int rounded, void* stream) {       \
    return launch_run_lanes<T>(in, out, xch, n_xch, kinds, wp, wm, centre,  \
                               c,                                           \
                               RunGrid{r, steps, blocks, m, halo, len,      \
                                       origin, n, rounded},                 \
                               threads, stream);                            \
  }
LS_RUN_LANES(ls_stencil1d_run_lanes, float)
LS_RUN_LANES(ls_stencil1d_run_lanes_f64, double)

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
