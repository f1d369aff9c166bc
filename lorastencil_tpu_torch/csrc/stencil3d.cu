// K fused dirichlet0 timesteps of a 3-D low-rank stencil on the port's
// internal layout, in float32 or float64, on CUDA cores: one pass over device
// memory.  Two kernels share this contract: the march kernel (march_kernel,
// below), which takes every pass the engine launches for the 3-D registry,
// and the general kernel (stencil3d_kernel), which takes the rest.
//
// The float32 instances (ls_stencil3d_march, ls_stencil3d_step) replace the
// TPU kernel lorastencil_tpu/ops/pallas_3d.py::_stencil3d_kernel (:118,
// driven by pallas_3d.stencil3d_step).  The float64 instances
// (ls_stencil3d_march_f64, ls_stencil3d_step_f64) serve the fp64-grade tier:
// they replace lorastencil_tpu/ops/pallas_df64_3d.py::_df64_3d_kernel (:79,
// df64_3d_step), which computes one fp64-grade step on error-free (hi, lo)
// fp32 pairs because the TPU has no fp64 unit; the H100 has one, so these
// instances compute in native double, and they also run dtype float64 with
// fused steps, as the JAX engine runs pallas_3d's kernel in float64 off the
// TPU.  Level L = 1..K of the pass turns level L-1 into level L at in-plane
// extent (K-L)*r around the block tile; each level-L plane z sums, in order
// (ops/band_gemm.py apply_spec_3d):
//
//     the centre terms' plane convs of plane z
//   + each buffered term's plane convs of planes z-r..z+r times its z taps
//   + each identity term's planes z-r..z+r times its z taps
//   + the residue,
//
// and every level is masked to the global interior in z and in-plane, so
// the halo decays exactly as the reference's step-by-step semantics
// require (under a ghost boundary, periodic or reflect, the levels before
// the last keep the interior and the ring the host refilled instead: Pass's
// box, the JAX kernels' `bounds`).  Level K is the output: the rounded interior of every plane,
// with cells beyond the true interior written as zeros; the guard ring is
// never written.  Sums follow the plain twin's order (ops/band_gemm.py):
// fp32 fuses each multiply-add (fmaf), so integer data agree bit for bit,
// and so does any data when every tap is a power of two; fp64 rounds each
// product and sum on its own (__dmul_rn, __dadd_rn: no FMA), so it agrees
// bit for bit on any data.  Both kernels keep that order, so they agree
// with each other bit for bit on any fill.
//
// The float32 instances also serve the bfloat16 state tier (the *_bf16
// entries, built apart as csrc/stencil3d_bf16.cu: this source with
// LS_STENCIL3D_BF16 defined): the kernels are templated on the state's cell
// type, computing in Compute<cell> (float for bfloat16), so a cell is
// widened as it is staged (cp.async cannot widen: a plain load, then a
// shared store) and rounded to nearest even once, at the pass's store; the
// fused levels stay fp32 in shared memory and registers, as the JAX kernel's
// level buffer.  So a bf16 pass equals the float32 pass of the widened input,
// rounded.  Shared memory, registers and the plan hold the compute type:
// a bf16 launch has float32's tiles and rings.
//
// What bounds a pass: device-memory bytes.  It must read and write 4 B
// (float32) or 8 B (float64) per interior cell and does ~10-25 operations
// per cell per level, below the card's fp32 and fp64 rates; at 256^3 the
// byte bound is 0.0401 ms (float32) or 0.0801 ms (float64) over 3.35 TB/s.
// Neither kernel keeps an intermediate in device memory: a block owns an
// in-plane tile and a z chunk, marches z one input plane at a time, starts
// K*r planes early and recomputes that lookback, because blocks run in no
// order and cannot inherit it (the TPU's sequential slab carry has no
// counterpart).
//
// The general kernel (stencil3d_kernel) keeps every intermediate in shared
// memory: per level a ring of the last 2r+1 planes, per buffered term and
// level a ring of 2r+1 plane convs (the reference artifact's rotating conv
// buffer, src/3d/gpu_box.cu), with a block barrier between phases, the
// plan read from shared memory at run time and one 4- or 8-byte cp.async
// per cell.  Its time goes to that work inside the SM (PERF.md: ~10% of
// the byte bound in float32), not to device-memory bytes.  It takes any
// radius <= 8 (0 too: a centre tap and z taps of one plane), residue, any
// term mix and K <= 8.
//
// The march kernel is its redesign for Hopper, for radius 1, K = 1 or 2,
// no residue and the registry's two term mixes (star3d1r's identity term
// and two centre terms, box3d1r's one buffered term: one term whose z taps
// sum planes, beside any centre terms):
//   * compile-time shape: R, K, the term count and each term's class and
//     in-plane axes (KINDS) are template parameters, so no loop over
//     classes, plan reads or axis tests remain at run time; the taps come
//     by value in a __grid_constant__ parameter, and a zero tap is a
//     predicated FMA in fp32 (mad_quad);
//   * z-sums in registers: each thread owns a fixed group of 2 rows x one
//     16-byte quad (4 float32 or 2 float64 cells) for the whole march, its
//     masks and copy addresses computed once a task.  When a level takes a
//     plane w, plane w's sum starts at once (the centre terms' convs of w,
//     then the z taps of the held values Y(w - r) .. Y(w - 1) and Y(w),
//     where Y is the buffered term's conv or the identity term's cells),
//     and the r sums still waiting each take their tap of Y(w): a level
//     keeps 2r value arrays of its cells in registers (level_step).  Level
//     L lags level L-1 by r planes.  Shared memory holds only the planes
//     whose in-plane neighbours are still to be read: the input planes in
//     flight and the one being read, and at K = 2 level 1's newest plane.
//     A plane costs one barrier at K = 1 and two at K = 2;
//   * wide copies and reads: input planes arrive by 16-byte cp.async, three
//     planes ahead (the layout's row pitch and origin are multiples of 16
//     bytes: ops/layout.py GUARD_ALIGN; a tile's window starts a quad left
//     of its cells, so it starts on the 16-byte grid).  TMA would take the
//     copy off the threads, but its tensor map comes from libcuda's
//     cuTensorMapEncodeTiled, outside the runtime the port links; the
//     copies are ~3 instructions a thread a plane here, so cp.async stays.
//     A layout off the 16-byte grid runs another instance, with one copy
//     and one store per cell.  A thread reads its window, 2 + 2r rows of
//     three quads, with 16-byte shared loads; the plane's row pitch in
//     quads is chosen so that a warp's loads spread over all banks;
//   * extents: the thread groups cover level 1's extent, the tile plus r
//     rows and one quad each side at K = 2, and every level runs on that
//     cell grid; the last level stores the tile.  Recomputed cells at K =
//     2: (34 x 72) / (32 x 64) = 1.195 on both levels (the general kernel:
//     1.096 on level 1, 1.0 on level 2); none at K = 1;
//   * tile, chunk and grid: a task is a (32 x 16-quad) tile -- (32, 64) in
//     float32, the layout's tile, (32, 32) in float64 -- and a z chunk; one
//     launch holds at most as many blocks as the card keeps resident, each
//     walking tasks, and the chunk is sized so that the tasks fill those
//     blocks once, with at least 16*K*r planes so that the lookback costs
//     at most 1/8 (tests/test_torch_march3d.py mirrors the plan).  The
//     launch bound asks for two blocks of 10 (K = 2) or 8 warps per SM,
//     which holds every instance without a spill (ptxas -v, chip_smoke
//     phase 20).
// Each input cell is read from device memory about (1 + 2Kr/zc)(1 +
// 2(K-1)r/32 + 2r/32)(1 + 2(K>1)/16 + 2/16) times at most (the halos of
// neighbouring tasks often meet in the L2), and each output cell written
// once.
//
// A pass may cover a window of the rounded plane only, whole layout tiles,
// every plane (the JAX kernel's `region`: the sharded engine's overlapped
// step computes its boundary frame first, then the inner window while the
// strips travel).  No kernel tests a window: the host moves the pass's
// origin to the window's first cell and its rounded plane to the window's
// (in_window), so the blocks and tasks start there, every store stays
// inside it, and a pass over the whole plane is the pass it was.
//
// C interface, loaded with ctypes: ls_stencil3d_smem_bytes sizes a launch
// of the general kernel (in either build), ls_stencil3d_step (float),
// ls_stencil3d_step_f64 (double) and ls_stencil3d_step_bf16 (bfloat16 cells,
// a float plan) launch it; ls_stencil3d_march, ls_stencil3d_march_f64 and
// ls_stencil3d_march_bf16 launch the march kernel with the tap table in host
// memory.  Each launches on the
// given stream, allocates nothing and returns cudaGetLastError() (0 =
// launched); each refuses what it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 10;  // cells of one level plane per thread, at most
constexpr int kMaxRadius = 8;
constexpr int kMaxK = 8;
constexpr int kMaxPlan = 4096;  // entries of tap/residue table
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int kMaxGrid = 65535;
enum { kCentre = 0, kIdentityZ = 1, kBuffered = 2 };  // band_gemm.term_class

// The order in which a plane sums its terms (band_gemm.apply_spec_3d):
// centre, buffered, identity.
__host__ __device__ constexpr int class_at(int o) {
  return o == 0 ? kCentre : o == 1 ? kBuffered : kIdentityZ;
}

struct Pass {
  int K, n_terms, n_res, plan_len, n_buf, ring;
  int nz, rows, pitch;  // buffer extents
  int z0, r0, c0;       // origin of interior cell (0, 0, 0)
  int h, m, n, mr, nr;  // interior and rounded plane
  int bm, bn, zc;       // block tile and z chunk
  // the box [zl, zh) x [rl, rh) x [cl, ch), interior coordinates, that the
  // levels before the last keep: the interior, or under a ghost boundary
  // the interior and its ring, which the host refilled (the JAX kernels'
  // `bounds`), or a shard's box.  The last level keeps the interior cut at
  // the box's ends, [0, hz) x [0, m) x [0, n) (in_window cuts m, n and
  // sets hz <= h; every level without a box keeps the same): the ring it
  // would keep is refilled before the next pass reads it.
  int zl, zh, rl, rh, cl, ch;
  int hz;  // planes the unboxed levels keep: h, or a shard's zh below it
};

__host__ __device__ inline int term_stride(int R) { return 3 + 3 * (2 * R + 1); }

// Plane extent of level L (0 = the input) around a (bm x bn) tile.
__host__ __device__ inline int level_ext(const Pass& p, int R, int L) {
  return (p.K - L) * R;
}
__host__ __device__ inline int level_cells(const Pass& p, int R, int L) {
  const int e = level_ext(p, R, L);
  return (p.bm + 2 * e) * (p.bn + 2 * e);
}
__host__ __device__ inline int plan_cells(const Pass& p) {
  return (p.plan_len + 3) / 4 * 4;
}
// Planes in the ring of level L: the input ring holds one more, the
// plane being fetched while the others are read.
__host__ __device__ inline int ring_slots(const Pass& p, int L) {
  return p.ring + (L == 0 ? 1 : 0);
}
// Element offsets into shared memory: the plan, then the level rings
// R_0..R_{K-1}, then the conv rings C_{L,b} for L = 1..K.
__host__ __device__ inline int ring_off(const Pass& p, int R, int L) {
  int off = plan_cells(p);
  for (int l = 0; l < L; ++l) off += ring_slots(p, l) * level_cells(p, R, l);
  return off;
}
__host__ __device__ inline int conv_off(const Pass& p, int R, int L, int b) {
  int off = ring_off(p, R, p.K);
  const int W = 2 * R + 1;
  for (int l = 1; l < L; ++l) off += W * p.n_buf * level_cells(p, R, l);
  return off + b * W * level_cells(p, R, L);
}
inline size_t smem_bytes(const Pass& p, int R, size_t itemsize) {
  return itemsize * static_cast<size_t>(conv_off(p, R, p.K + 1, 0));
}

// The cell types (csrc/stencil2d.cu's).  A state of S (float, double or
// __nv_bfloat16) computes in Compute<S>, float for bfloat16: widen at the
// load (exact), to_cell at the store (to nearest even).
template <typename S>
struct ComputeOf {
  using type = S;
};
template <>
struct ComputeOf<__nv_bfloat16> {
  using type = float;
};
template <typename S>
using Compute = typename ComputeOf<S>::type;
template <typename S>
constexpr bool kBf16 = std::is_same_v<S, __nv_bfloat16>;

template <typename S>
__device__ __forceinline__ S to_cell(Compute<S> x) {
  if constexpr (kBf16<S>) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}
// The float of a bfloat16's bits (the low 16 of `bits`).
__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// w * x + y: fused in fp32, rounded step by step in fp64.
__device__ __forceinline__ float mad(float w, float x, float y) {
  return fmaf(w, x, y);
}
__device__ __forceinline__ double mad(double w, double x, double y) {
  return __dadd_rn(y, __dmul_rn(w, x));
}

// A one-cell asynchronous copy from device to shared memory (sm_80+), 4 or 8
// bytes; when ok is false nothing is read and the destination is zeroed.
__device__ __forceinline__ void cp_async_cell(float* dst, const float* src,
                                              bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_cell(double* dst, const double* src,
                                              bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0));
}
// A bfloat16 cell is widened as it is copied, by a plain load and store
// (cp.async cannot widen): the wait and barrier after the copies order it
// as well.
__device__ __forceinline__ void cp_async_cell(float* dst,
                                              const __nv_bfloat16* src,
                                              bool ok) {
  *dst = ok ? bf16_bits_to_float(
                  __ldg(reinterpret_cast<const unsigned short*>(src)))
            : 0.0f;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Calls f(k) for a thread's cells k < n of a plane, and for small radii
// for every k < kPerThread: that loop is unrolled and branch-free, so the
// per-cell arrays indexed by k stay in registers and the cells' loads and
// sums interleave; cells k >= n read a valid cell and store nothing.  Wide
// radii keep the loop rolled, which keeps their build to seconds.
template <int R, typename F>
__device__ __forceinline__ void for_cells(int n, F&& f) {
  if constexpr (R <= 2) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) f(k);
  } else {
#pragma unroll 1
    for (int k = 0; k < n; ++k) f(k);
  }
}

// A term's in-plane taps, staged in registers for one phase.
template <typename T, int R>
struct PlaneTaps {
  T ct[2 * R + 1], rt[2 * R + 1];
  bool has_col, has_row;
  __device__ explicit PlaneTaps(const T* term) {
    constexpr int W = 2 * R + 1;
    has_col = term[1] != T(0);
    has_row = term[2] != T(0);
#pragma unroll
    for (int a = 0; a < W; ++a) {
      ct[a] = term[3 + W + a];
      rt[a] = has_row ? term[3 + 2 * W + a] : T(a == R ? 1 : 0);
    }
  }
  // The conv at the cell whose centre is x in a plane of width win: the
  // column conv of each row the row conv reads, then the row conv; taps
  // ascending, zero taps skipped, a missing axis the identity.
  __device__ T at(const T* x, int win) const {
    constexpr int W = 2 * R + 1;
    T z = T(0);
#pragma unroll
    for (int a = 0; a < W; ++a) {
      if (rt[a] == T(0)) continue;
      const T* row = x + (a - R) * win;
      T y;
      if (has_col) {
        y = T(0);
#pragma unroll
        for (int b = 0; b < W; ++b)
          if (ct[b] != T(0)) y = mad(ct[b], row[b - R], y);
      } else {
        y = row[0];
      }
      z = has_row ? mad(rt[a], y, z) : y;
    }
    return z;
  }
};

// BOX: the levels before the last keep Pass's box, not the interior (a
// ghost boundary's ring); the instance without it is the dirichlet0 pass's,
// unchanged by the box.
// S: the state's cell type (a bfloat16 state computes in float, see the
// header).
template <typename S, int R, bool BOX, typename T = Compute<S>>
__global__ void __launch_bounds__(kThreads)
stencil3d_kernel(const S* __restrict__ in, S* __restrict__ out,
                 const T* __restrict__ plan, const Pass p) {
  constexpr int W = 2 * R + 1;
  // Dynamic shared memory: one float-typed symbol for both instances.  The
  // kernel has no static shared memory, so the region starts at the block's
  // shared-memory base, aligned for double.  (A byte-typed symbol, or one
  // symbol per type reached through a function, changed the float32 code
  // at r = 1 enough that ptxas spilled registers: ~10% of its time.)
  extern __shared__ float smem_words[];
  T* const smem = reinterpret_cast<T*>(smem_words);
  const int tid = threadIdx.x;
  const int K = p.K;
  const int i0 = blockIdx.y * p.bm;  // tile origin, interior coords
  const int j0 = blockIdx.x * p.bn;
  const int zs = blockIdx.z * p.zc;  // first output plane
  const int ze = min(zs + p.zc, p.h);
  const int nin = ze - zs + 2 * K * R;  // input planes, lookback included
  const size_t plane_stride = static_cast<size_t>(p.rows) * p.pitch;
  const int tstride = term_stride(R);

  T* s_plan = smem;
  for (int q = tid; q < p.plan_len; q += kThreads) s_plan[q] = plan[q];
  const T* s_res = s_plan + p.n_terms * tstride;

  // Level 0: input plane u (interior z = zs - K*R + u) at extent K*R,
  // copied into its ring slot with cp.async while the block computes on
  // the planes before it.
  const int n_in_slots = ring_slots(p, 0);
  auto fetch = [&](int u) {
    const int e = K * R;
    const int win = p.bn + 2 * e;
    const int hin = p.bm + 2 * e;
    T* dst = smem + ring_off(p, R, 0) + (u % n_in_slots) * hin * win;
    const int gz = p.z0 + zs - e + u;
    const bool zin = gz >= 0 && gz < p.nz;
    const S* src = in + static_cast<size_t>(zin ? gz : 0) * plane_stride;
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int ii = warp; ii < hin; ii += kWarps) {
      const int gr = p.r0 + i0 - e + ii;
      const bool rin = zin && gr >= 0 && gr < p.rows;
      const S* srow = src + static_cast<size_t>(rin ? gr : 0) * p.pitch;
      for (int jj = lane; jj < win; jj += 32) {
        const int gc = p.c0 + j0 - e + jj;
        const bool ok = rin && gc >= 0 && gc < p.pitch;
        cp_async_cell(dst + ii * win + jj, ok ? srow + gc : in, ok);
      }
    }
    cp_async_commit();
  };

  fetch(0);
  for (int u = 0; u < nin; ++u) {
    cp_async_wait_all();
    __syncthreads();  // plane u landed; the last iteration's reads are done
    if (u + 1 < nin) fetch(u + 1);

    for (int L = 1; L <= K; ++L) {
      const int w = u - (L - 1) * R;  // newest plane of level L-1
      const int e = level_ext(p, R, L);
      const int wout = p.bn + 2 * e;
      const int cells = (p.bm + 2 * e) * wout;
      const int win = wout + 2 * R;
      const int plane_in = (p.bm + 2 * e + 2 * R) * win;
      const T* prev = smem + ring_off(p, R, L - 1);  // ring of level L-1
      const int n_prev = ring_slots(p, L - 1);
      const T* conv0 = smem + conv_off(p, R, L, 0);
      const int conv_stride = W * cells;  // elements per buffered term

      // This thread's cells q = tid + k * kThreads of the level-L plane
      // (row-major, width wout), as offsets of their centres in a level
      // L-1 plane; the row step per k is found once, not divided per cell.
      const int n_mine = cells > tid ? (cells - tid + kThreads - 1) / kThreads
                                     : 0;
      const int di = kThreads / wout;
      const int dj = kThreads - di * wout;
      int cin[kPerThread];
      {
        int ii = tid / wout;
        int jj = tid - ii * wout;
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          cin[k] = k < n_mine ? (ii + R) * win + jj + R : R * win + R;
          ii += di;
          jj += dj;
          if (jj >= wout) {
            jj -= wout;
            ++ii;
          }
        }
      }

      // Conv rings: each buffered term's conv of plane w, computed once.
      if (p.n_buf > 0) {
        const T* X = prev + (w % n_prev) * plane_in;
        int b = 0;
        for (int t = 0; t < p.n_terms; ++t) {
          const T* term = s_plan + t * tstride;
          if (static_cast<int>(term[0]) != kBuffered) continue;
          const PlaneTaps<T, R> taps(term);
          T* C = smem + conv_off(p, R, L, b) + (w % W) * cells + tid;
          for_cells<R>(n_mine, [&](int k) {
            const T c = taps.at(X + cin[k], win);
            if (k < n_mine) C[k * kThreads] = c;
          });
          ++b;
        }
        __syncthreads();
      }

      const int v = w - R;  // the level-L plane this input completes
      if (v < L * R) break;  // levels >= L have nothing new yet
      T acc[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) acc[k] = T(0);
      int b = 0;
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const int want = class_at(o);
        for (int t = 0; t < p.n_terms; ++t) {
          const T* term = s_plan + t * tstride;
          if (static_cast<int>(term[0]) != want) continue;
          const T* zt = term + 3;
          if (want == kCentre) {
            const PlaneTaps<T, R> taps(term);
            const T* X = prev + (v % n_prev) * plane_in;
            for_cells<R>(n_mine,
                         [&](int k) { acc[k] += taps.at(X + cin[k], win); });
            continue;
          }
#pragma unroll
          for (int dz = -R; dz <= R; ++dz) {
            const T wz = zt[R + dz];
            if (wz == T(0)) continue;
            if (want == kBuffered) {
              const T* C =
                  conv0 + b * conv_stride + ((v + dz) % W) * cells + tid;
              for_cells<R>(n_mine, [&](int k) {
                // a cell k >= n_mine reads cell 0 of the plane
                acc[k] = mad(wz, C[k < n_mine ? k * kThreads : -tid], acc[k]);
              });
            } else {
              const T* X = prev + ((v + dz) % n_prev) * plane_in;
              for_cells<R>(n_mine, [&](int k) {
                acc[k] = mad(wz, X[cin[k]], acc[k]);
              });
            }
          }
          if (want == kBuffered) ++b;
        }
      }
      for (int r = 0; r < p.n_res; ++r) {
        const int dz = static_cast<int>(s_res[4 * r]);
        const int dr = static_cast<int>(s_res[4 * r + 1]);
        const int dc = static_cast<int>(s_res[4 * r + 2]);
        const T wr = s_res[4 * r + 3];
        const T* X = prev + ((v + dz) % n_prev) * plane_in + dr * win + dc;
        for_cells<R>(n_mine,
                     [&](int k) { acc[k] = mad(wr, X[cin[k]], acc[k]); });
      }

      // Mask to the box (levels before K) or the interior (level K); store
      // to the level ring, or for level K to the rounded interior of the
      // output.
      const int zv = zs - K * R + v;  // interior z of the plane
      const bool zok = BOX && L < K ? zv >= p.zl && zv < p.zh
                                    : zv >= 0 && zv < p.hz;
      T* dst = smem + ring_off(p, R, L) + (v % p.ring) * cells + tid;
      S* gdst = out + static_cast<size_t>(p.z0 + zv) * plane_stride +
                    static_cast<size_t>(p.r0) * p.pitch + p.c0;
      int gi = i0 - e + tid / wout;  // interior coords of cell k
      int gj = j0 - e + tid % wout;
      for_cells<R>(n_mine, [&](int k) {
        if (k < n_mine) {
          const bool ok =
              zok && (BOX && L < K ? gi >= p.rl && gi < p.rh && gj >= p.cl &&
                                         gj < p.ch
                                   : gi >= 0 && gi < p.m && gj >= 0 &&
                                         gj < p.n);
          if (L < K) {
            dst[k * kThreads] = ok ? acc[k] : T(0);
          } else if (gi < p.mr && gj < p.nr) {
            gdst[static_cast<size_t>(gi) * p.pitch + gj] =
                to_cell<S>(ok ? acc[k] : T(0));
          }
        }
        gi += di;
        gj += dj;
        if (gj >= j0 - e + wout) {
          gj -= wout;
          ++gi;
        }
      });
      __syncthreads();
    }
  }
}

// The box holds the (cut) interior.
bool box_valid(const Pass& p) {
  return p.hz >= 0 && p.hz <= p.h && p.zl <= 0 && p.zh >= p.hz &&
         p.rl <= 0 && p.rh >= p.m && p.cl <= 0 && p.ch >= p.n;
}

bool valid(const Pass& p, int R) {
  const int W = 2 * R + 1;
  return R >= 0 && R <= kMaxRadius && p.K >= 1 && p.K <= kMaxK &&
         p.n_terms >= 0 && p.n_res >= 0 && p.n_buf >= 0 &&
         (p.ring == 1 || p.ring == W) && p.plan_len <= kMaxPlan &&
         p.plan_len == p.n_terms * term_stride(R) + 4 * p.n_res &&
         p.bm >= 1 && p.bn >= 1 && p.zc >= 1 && p.h >= 0 && p.m >= 0 &&
         p.n >= 0 && p.mr >= p.m && p.nr >= p.n && p.z0 >= 0 &&
         p.z0 + p.h <= p.nz && p.r0 >= 0 && p.r0 + p.mr <= p.rows &&
         p.c0 >= 0 && p.c0 + p.nr <= p.pitch && box_valid(p) &&
         (p.mr + p.bm - 1) / p.bm <= kMaxGrid &&
         (p.h + p.zc - 1) / p.zc <= kMaxGrid;
}

template <typename S, int R, bool BOX>
int launch_box(const S* in, S* out, const Compute<S>* plan, const Pass& p,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(p, R, sizeof(Compute<S>));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stencil3d_kernel<S, R, BOX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.nr + p.bn - 1) / p.bn, (p.mr + p.bm - 1) / p.bm,
                  (p.h + p.zc - 1) / p.zc);
  stencil3d_kernel<S, R, BOX><<<grid, kThreads, smem, stream>>>(in, out, plan,
                                                                p);
  return static_cast<int>(cudaGetLastError());
}

// A box that is not the interior (a ghost boundary's ring, at K >= 2) takes
// the BOX instance.
bool has_box(const Pass& p) {
  return p.zl != 0 || p.zh != p.hz || p.rl != 0 || p.rh != p.m ||
         p.cl != 0 || p.ch != p.n;
}

template <typename S, int R>
int launch(const S* in, S* out, const Compute<S>* plan, const Pass& p,
           cudaStream_t stream) {
  return p.K > 1 && has_box(p) ? launch_box<S, R, true>(in, out, plan, p, stream)
                               : launch_box<S, R, false>(in, out, plan, p,
                                                         stream);
}

Pass make_pass(int plan_len, int n_terms, int n_res, int n_buf, int ring,
               int K, int nz, int rows, int pitch, int z0, int r0, int c0,
               int h, int m, int n, int mr, int nr, int bm, int bn, int zc) {
  Pass p;
  p.K = K;
  p.n_terms = n_terms;
  p.n_res = n_res;
  p.plan_len = plan_len;
  p.n_buf = n_buf;
  p.ring = ring;
  p.nz = nz;
  p.rows = rows;
  p.pitch = pitch;
  p.z0 = z0;
  p.r0 = r0;
  p.c0 = c0;
  p.h = h;
  p.m = m;
  p.n = n;
  p.mr = mr;
  p.nr = nr;
  p.bm = bm;
  p.bn = bn;
  p.zc = zc;
  p.zl = 0;  // the box: the interior, until with_box
  p.zh = h;
  p.rl = 0;
  p.rh = m;
  p.cl = 0;
  p.ch = n;
  p.hz = h;
  return p;
}

// `p` with the box [zl, zh) x [rl, rh) x [cl, ch).
Pass with_box(Pass p, int zl, int zh, int rl, int rh, int cl, int ch) {
  p.zl = zl;
  p.zh = zh;
  p.rl = rl;
  p.rh = rh;
  p.cl = cl;
  p.ch = ch;
  return p;
}

// The pass of `p` over the window rows [i0, i1) x columns [j0, j1) of the
// rounded plane, every plane (the whole plane for a pass without a
// region): the window's first cell becomes interior cell (0, 0) of each
// plane and its extent the rounded plane, so the blocks (or the march's
// tasks) start at the window's origin and store nothing outside it; the
// interior's ends and the box move with it.  The interior's ends are cut
// at the box's (zh, rh, ch) first, so that the last level keeps the box
// cut to the interior (a shard's box may end inside it: the padding of
// the last shard of an axis the mesh does not divide).  A window outside
// the rounded plane gives a pass that valid() refuses.
Pass in_window(Pass p, int i0, int i1, int j0, int j1) {
  if (i0 < 0 || i1 <= i0 || i1 > p.mr || j0 < 0 || j1 <= j0 || j1 > p.nr) {
    p.mr = -1;
    return p;
  }
  auto clamp = [](int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
  };
  const int hz = clamp(p.zh < p.h ? p.zh : p.h, 0, p.h);
  const int m = clamp((p.rh < p.m ? p.rh : p.m) - i0, 0, i1 - i0);
  const int n = clamp((p.ch < p.n ? p.ch : p.n) - j0, 0, j1 - j0);
  p.zh = p.zh > hz ? p.zh : hz;
  p.hz = hz;
  p.r0 += i0;
  p.c0 += j0;
  p.m = m;
  p.n = n;
  p.mr = i1 - i0;
  p.nr = j1 - j0;
  p.rl -= i0;
  p.rh = p.rh - i0 > m ? p.rh - i0 : m;
  p.cl -= j0;
  p.ch = p.ch - j0 > n ? p.ch - j0 : n;
  return p;
}

template <typename S>
int step(const S* in, S* out, const Compute<S>* plan, const Pass& p,
         int radius, void* stream) {
  if (!valid(p, radius) ||
      smem_bytes(p, radius, sizeof(Compute<S>)) > kMaxSmem ||
      level_cells(p, radius, 1) > kPerThread * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.h == 0 || p.mr == 0 || p.nr == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 0: return launch<S, 0>(in, out, plan, p, s);
    case 1: return launch<S, 1>(in, out, plan, p, s);
    case 2: return launch<S, 2>(in, out, plan, p, s);
    case 3: return launch<S, 3>(in, out, plan, p, s);
    case 4: return launch<S, 4>(in, out, plan, p, s);
    case 5: return launch<S, 5>(in, out, plan, p, s);
    case 6: return launch<S, 6>(in, out, plan, p, s);
    case 7: return launch<S, 7>(in, out, plan, p, s);
    case 8: return launch<S, 8>(in, out, plan, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- the march kernel --------------------------------------------------------
constexpr int kMarchMaxRadius = 1;
constexpr int kMarchMaxTerms = 3;
constexpr int kMarchRows = 2;        // rows of a thread's cell group
constexpr int kMarchTileRows = 32;   // output rows of a task
constexpr int kMarchTileQuads = 16;  // output quads (16 bytes) of a task row
constexpr int kMarchAhead = 3;       // input planes in flight
constexpr int kMarchMinBlocks = 2;   // launch bound: blocks per SM
constexpr int kBoxBit = 16;          // march_kernel: the box's flags in `keep`
constexpr int kSmemPerSM = 233472;   // bytes of shared memory an SM has
constexpr int kMaxDevices = 64;
// A term's kind, four bits a term in the kernel's KINDS (term t at bits
// 4t .. 4t + 3): its in-plane axes (plan_array's has_col, has_row) and, at
// bits 2-3, its class.
constexpr int kHasCol = 1;
constexpr int kHasRow = 2;
// The term mixes the march kernel is built for: star3d1r's (an identity
// term, a centre term with a row conv, a centre term with a column conv)
// and box3d1r's (one buffered term with both axes).
constexpr int kStarKinds = (kIdentityZ << 2) | ((kCentre << 2 | kHasRow) << 4) |
                           ((kCentre << 2 | kHasCol) << 8);
constexpr int kBoxKinds = kBuffered << 2 | kHasCol | kHasRow;

__host__ __device__ constexpr int kind_axes(int kinds, int t) {
  return (kinds >> (4 * t)) & 3;
}
__host__ __device__ constexpr int kind_class(int kinds, int t) {
  return (kinds >> (4 * t + 2)) & 3;
}
// Terms of class c among the first t: a term's index in its class.
__host__ __device__ constexpr int class_rank(int kinds, int t, int c) {
  int n = 0;
  for (int s = 0; s < t; ++s) n += kind_class(kinds, s) == c ? 1 : 0;
  return n;
}
// The row pitch of a shared plane in quads: at least `quads`, and such that
// the next cell group's row (kMarchRows rows on) continues the bank pattern
// of a warp's 16-byte loads, which cover gx cell groups a row.
__host__ __device__ constexpr int march_pitch(int quads, int gx) {
  int s = quads;
  while ((kMarchRows * s - gx) % 8 != 0) ++s;
  return s;
}
// The index of the term whose z taps sum planes (buffered or identity-z):
// the march kernel takes one, beside any number of centre terms.
__host__ __device__ constexpr int z_term(int kinds, int nt) {
  int z = -1;
  for (int t = 0; t < nt; ++t)
    if (kind_class(kinds, t) != kCentre) z = t;
  return z;
}

// The march kernel's cell grid and shared planes for cells of T, radius R
// and K levels.  A thread owns CH rows x one quad of V cells; the groups
// cover the tile, plus at K = 2 ER rows and one quad each side (level 1's
// extent).  A shared plane holds the cell grid with R rows and one quad
// each side, its rows ROW elements apart.
template <typename T, int R_, int K>
struct March {
  using type = T;
  static constexpr int R = R_;
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static constexpr int CH = kMarchRows;
  static constexpr int TM = kMarchTileRows;
  static constexpr int TN = kMarchTileQuads * V;
  static constexpr int ER = (K - 1) * R;
  static constexpr int EQ = K > 1 ? 1 : 0;
  static constexpr int GR = TM + 2 * ER;
  static constexpr int GX = kMarchTileQuads + 2 * EQ;
  static constexpr int GY = GR / CH;
  static constexpr int groups = GX * GY;
  static constexpr int threads = (groups + 31) / 32 * 32;
  static constexpr int PR = GR + 2 * R;
  static constexpr int PQ = GX + 2;
  static constexpr int ROW = march_pitch(PQ, GX) * V;
  static constexpr int plane = PR * ROW;
  // shared planes: the input planes in flight and the one being read, and
  // at K = 2 level 1's newest; with an identity z term, R more of each
  // (level_step reads the thread's cells of planes w - R .. w - 1 there)
  __host__ __device__ static constexpr int in_slots(bool id) {
    return kMarchAhead + 1 + id * R;
  }
  __host__ __device__ static constexpr int lv_slots(bool id) {
    return K > 1 ? 1 + id * R : 0;
  }
  // A thread's 16-byte copies of a plane: quad tid % PQ of plane rows
  // tid / PQ + k CR, CR rows a pass, so that one offset serves them all.
  static constexpr int CR = threads / PQ;
  static constexpr int NCP = (PR + CR - 1) / CR;
  static_assert(GR % CH == 0 && R <= V, "cell groups must tile the grid");
};

// plan_array's table for one R, by value: each term's z, column and row
// taps (its class and axes are the kernel's KINDS).
template <typename T, int R>
struct MarchPlan {
  T zt[kMarchMaxTerms][2 * R + 1];
  T ct[kMarchMaxTerms][2 * R + 1];
  T rt[kMarchMaxTerms][2 * R + 1];
};

__device__ __forceinline__ void ld_quad(const float* s, float* x) {
  const float4 f = *reinterpret_cast<const float4*>(s);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}
__device__ __forceinline__ void ld_quad(const double* s, double* x) {
  const double2 f = *reinterpret_cast<const double2*>(s);
  x[0] = f.x;
  x[1] = f.y;
}
__device__ __forceinline__ void st_quad(float* d, const float* x) {
  *reinterpret_cast<float4*>(d) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st_quad(double* d, const double* x) {
  *reinterpret_cast<double2*>(d) = make_double2(x[0], x[1]);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// a[c] = mad(w, x[c], a[c]) for a quad's cells where w != 0: a zero tap
// leaves the sums as they are, as PlaneTaps::at's skipped tap does.  In fp32
// as predicated FMAs, with no branch; in fp64 as a branch, which ptxas
// turns into fewer registers than the predicated multiply-adds (those
// took 255 registers and spilled, PERF.md).
__device__ __forceinline__ void mad_quad(float w, const float* x, float* a) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.neu.f32 p, %4, 0f00000000;\n\t"
      "@p fma.rn.f32 %0, %4, %5, %0;\n\t"
      "@p fma.rn.f32 %1, %4, %6, %1;\n\t"
      "@p fma.rn.f32 %2, %4, %7, %2;\n\t"
      "@p fma.rn.f32 %3, %4, %8, %3;\n\t}"
      : "+f"(a[0]), "+f"(a[1]), "+f"(a[2]), "+f"(a[3])
      : "f"(w), "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]));
}
__device__ __forceinline__ void mad_quad(double w, const double* x,
                                         double* a) {
  if (w != 0.0) {
    a[0] = __dadd_rn(a[0], __dmul_rn(w, x[0]));
    a[1] = __dadd_rn(a[1], __dmul_rn(w, x[1]));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
// A quad of cells into a shared plane: 16 bytes by cp.async (float32,
// float64), or a bfloat16 quad (8 bytes) by a plain load widened to a
// float4 (cp.async cannot widen; the wait and barrier after the copies order
// the store as well); zeros where !ok.
__device__ __forceinline__ void copy_quad(float* dst, const float* src,
                                          bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void copy_quad(double* dst, const double* src,
                                          bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void copy_quad(float* dst,
                                          const __nv_bfloat16* src, bool ok) {
  uint2 u = make_uint2(0u, 0u);
  if (ok) u = __ldg(reinterpret_cast<const uint2*>(src));
  *reinterpret_cast<float4*>(dst) =
      make_float4(bf16_bits_to_float(u.x & 0xffffu),
                  __uint_as_float(u.x & 0xffff0000u),
                  bf16_bits_to_float(u.y & 0xffffu),
                  __uint_as_float(u.y & 0xffff0000u));
}
// A quad of sums into device memory as cells: one 16-byte or (bfloat16)
// 8-byte store.
__device__ __forceinline__ void st_quad(__nv_bfloat16* d, const float* x) {
  *reinterpret_cast<uint2*>(d) =
      make_uint2(bf16_bits(x[0]) | bf16_bits(x[1]) << 16,
                 bf16_bits(x[2]) | bf16_bits(x[3]) << 16);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Term t's in-plane conv at the thread's cells, from its window at `win`
// in a shared plane: CH + 2R rows of three quads, its own cells the middle
// quad of rows R .. R + CH - 1.  Per cell PlaneTaps::at's order: the column
// conv of each row the row conv reads, then the row conv, taps ascending,
// zero taps skipped, a missing axis the identity.  Only the rows and quads
// the term reads are loaded.  Every array index here is a constant once
// the loops unroll, so z stays in registers (an index that depended on the
// term loop put a sum array in local memory, PERF.md).
template <typename S, int NT, int KINDS, typename T = typename S::type>
__device__ __forceinline__ void term_conv(const MarchPlan<T, S::R>& pl, int t,
                                          const T* win,
                                          T (&z)[S::CH][S::V]) {
  constexpr int R = S::R, V = S::V, CH = S::CH, W = 2 * R + 1;
  const int axes = kind_axes(KINDS, t);
#pragma unroll
  for (int h = 0; h < CH; ++h)
#pragma unroll
    for (int c = 0; c < V; ++c) z[h][c] = T(0);
#pragma unroll
  for (int wr = 0; wr < CH + 2 * R; ++wr) {
    const int h0 = wr - R;  // the output row this window row is, if any
    if (!(axes & kHasRow) && (h0 < 0 || h0 >= CH)) continue;
    T x[3 * V];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q == 1 || (axes & kHasCol))
        ld_quad(win + wr * S::ROW + q * V, x + q * V);
    T y[V];
    if (axes & kHasCol) {
#pragma unroll
      for (int c = 0; c < V; ++c) y[c] = T(0);
#pragma unroll
      for (int b = 0; b < W; ++b) mad_quad(pl.ct[t][b], x + V + b - R, y);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) y[c] = x[V + c];
    }
    if (axes & kHasRow) {
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        const int a = wr - h;
        if (a >= 0 && a < W) mad_quad(pl.rt[t][a], y, z[h]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) z[h0][c] = y[c];
    }
  }
}

// Level L takes level L-1's plane w (window `win` in its shared plane) and
// yields its plane w - R, unmasked, into `done`.  The z term's value of w,
// Y(w), is the buffered term's conv or the identity term's cells.  Plane
// w's sum starts here, in the twin's order: the centre terms' convs of w,
// then the z taps ascending -- Y(w - R) .. Y(w - 1), Y(w) -- and waits in
// `pend` for Y(w + 1) .. Y(w + R); each waiting sum takes its next tap
// from Y(w), and the oldest is complete.  Y(w - R) .. Y(w - 1) come from
// `held` (a buffered term's convs) or, for an identity term, from the
// thread's cells of those planes, still in shared memory at `back[d]`.  So
// a level keeps R (identity) or 2R (buffered) value arrays of its cells in
// registers.  (A ring of the last 2R + 1 Y in registers, and held cells at
// K = 2 in star3d1r's instance, spilled: PERF.md.)
template <typename S, int NT, int KINDS, typename T = typename S::type>
__device__ __forceinline__ void level_step(const MarchPlan<T, S::R>& pl,
                                           const T* win,
                                           const T* const (&back)[S::R],
                                           T (&pend)[S::R][S::CH][S::V],
                                           T (&held)[S::R][S::CH][S::V],
                                           T (&done)[S::CH][S::V]) {
  constexpr int R = S::R, V = S::V, CH = S::CH;
  constexpr int TZ = z_term(KINDS, NT);
  constexpr bool kId = kind_class(KINDS, TZ) == kIdentityZ;
  T y[CH][V];
  if (kind_class(KINDS, TZ) == kBuffered) {
    term_conv<S, NT, KINDS>(pl, TZ, win, y);
  } else {
#pragma unroll
    for (int h = 0; h < CH; ++h) ld_quad(win + (R + h) * S::ROW + V, y[h]);
  }
  T a[CH][V];  // plane w's sum: the first centre term's conv, or zero
  if constexpr (class_rank(KINDS, NT, kCentre) == 0) {
#pragma unroll
    for (int h = 0; h < CH; ++h)
#pragma unroll
      for (int c = 0; c < V; ++c) a[h][c] = T(0);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (kind_class(KINDS, t) != kCentre) continue;
    if (class_rank(KINDS, t, kCentre) == 0) {
      term_conv<S, NT, KINDS>(pl, t, win, a);
      continue;
    }
    T z[CH][V];
    term_conv<S, NT, KINDS>(pl, t, win, z);
#pragma unroll
    for (int h = 0; h < CH; ++h)
#pragma unroll
      for (int c = 0; c < V; ++c) a[h][c] = add_rn(a[h][c], z[h][c]);
  }
#pragma unroll
  for (int h = 0; h < CH; ++h) {
#pragma unroll
    for (int d = 0; d < R; ++d) {
      if constexpr (kId) {
        T x[V];
        ld_quad(back[d] + (R + h) * S::ROW + V, x);
        mad_quad(pl.zt[TZ][d], x, a[h]);
      } else {
        mad_quad(pl.zt[TZ][d], held[d][h], a[h]);
      }
    }
    mad_quad(pl.zt[TZ][R], y[h], a[h]);
#pragma unroll
    for (int k = 0; k < R; ++k)  // pend[k] is plane w - R + k's sum
      mad_quad(pl.zt[TZ][2 * R - k], y[h], pend[k][h]);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      done[h][c] = pend[0][h][c];
#pragma unroll
      for (int k = 0; k + 1 < R; ++k) {
        pend[k][h][c] = pend[k + 1][h][c];
        if constexpr (!kId) held[k][h][c] = held[k + 1][h][c];
      }
      pend[R - 1][h][c] = a[h][c];
      if constexpr (!kId) held[R - 1][h][c] = y[h][c];
    }
  }
}

// Whether the z term is an identity term (its held values in shared
// memory).
template <typename T, int R, int K, int NT, int KINDS>
__host__ __device__ constexpr bool z_identity() {
  return kind_class(KINDS, z_term(KINDS, NT)) == kIdentityZ;
}
// Shared memory of a block.
template <typename T, int R, int K, int NT, int KINDS>
__host__ __device__ constexpr int march_smem_bytes() {
  using S = March<T, R, K>;
  constexpr bool id = z_identity<T, R, K, NT, KINDS>();
  return static_cast<int>(sizeof(T)) * S::plane *
         (S::in_slots(id) + S::lv_slots(id));
}

// K = 1 or 2 fused steps per cell of a task's tile (32 rows x 16 quads)
// and z chunk, for each task of a block.  Input plane u of a task (interior
// z = zs - K R + u) arrives in shared memory three planes ahead; level 1
// takes it (level_step) and yields plane u - R, which at K = 2 goes to
// shared memory, where level 2 takes it and yields plane u - 2R.  The last
// level's planes are the task's output.  VEC: the buffers start on the
// 16-byte grid and so do the layout's row pitch and origin column (every
// layout the engine builds); the other instance copies and stores one cell
// at a time.  BOX (K = 2 only): level 1 keeps Pass's box, not the interior
// (a ghost boundary's ring); the instance without it is the dirichlet0
// pass's, unchanged by the box.  Cell: the state's cell type (a bfloat16
// state computes in float: its quads are 8 bytes in device memory and 16 in
// shared memory, see copy_quad).
template <typename Cell, int R, int K, int NT, int KINDS, bool VEC, bool BOX,
          typename T = Compute<Cell>>
__global__ void __launch_bounds__(March<T, R, K>::threads, kMarchMinBlocks)
march_kernel(const Cell* __restrict__ in, Cell* __restrict__ out,
             const __grid_constant__ MarchPlan<T, R> pl, const Pass p) {
  using S = March<T, R, K>;
  constexpr int V = S::V, CH = S::CH;
  static_assert(!BOX || K == 2, "a box is for the level before the last");
  static_assert(class_rank(KINDS, NT, kBuffered) +
                        class_rank(KINDS, NT, kIdentityZ) ==
                    1,
                "one term sums planes");
  // the launch bound's blocks fit the SM's shared memory (1 KB each more)
  static_assert(kMarchMinBlocks * (march_smem_bytes<T, R, K, NT, KINDS>() +
                                   1024) <= kSmemPerSM,
                "two blocks per SM");
  constexpr bool kId = z_identity<T, R, K, NT, KINDS>();
  constexpr int IN_SLOTS = S::in_slots(kId), LV_SLOTS = S::lv_slots(kId);
  extern __shared__ float4 march_smem[];
  T* const s_in = reinterpret_cast<T*>(march_smem);
  T* const s_lv = s_in + IN_SLOTS * S::plane;  // level 1's planes (K = 2)
  const int tid = threadIdx.x;
  const bool active = tid < S::groups;
  const int gy = active ? tid / S::GX : 0;
  const int gx = active ? tid % S::GX : 0;
  const int win = gy * CH * S::ROW + gx * V;  // the thread's window
  const int own = win + R * S::ROW + V;       // its first cell
  const size_t plane_stride = static_cast<size_t>(p.rows) * p.pitch;
  const int tiles_c = (p.nr + S::TN - 1) / S::TN;
  const int tiles = tiles_c * ((p.mr + S::TM - 1) / S::TM);
  const int tasks = tiles * ((p.h + p.zc - 1) / p.zc);
  for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
    const int i0 = task % tiles / tiles_c * S::TM;
    const int j0 = task % tiles % tiles_c * S::TN;
    const int zs = task / tiles * p.zc;
    const int nin = min(p.zc, p.h - zs) + 2 * K * R;
    const int zb = zs - K * R;  // interior z of input plane 0
    // the thread's cells: interior rows i + h, columns j + c
    const int i = i0 - S::ER + gy * CH;
    const int j = j0 - S::EQ * V + gx * V;
    // bit h V + c: the cell inside the interior plane, and with BOX bit
    // kBoxBit + h V + c: inside the box's plane (level 1's mask); bit h of
    // `rows_out`: a row of the tile, inside the rounded interior (bits, not
    // bools: the flags live through the march, and every register counts
    // at K = 2)
    static_assert(CH * V <= kBoxBit, "a plane's flags fit below the box's");
    unsigned keep = 0, rows_out = 0;
#pragma unroll
    for (int h = 0; h < CH; ++h) {
      if (active && gy * CH + h >= S::ER && gy * CH + h < S::ER + S::TM &&
          i + h < p.mr)
        rows_out |= 1u << h;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        if (i + h >= 0 && i + h < p.m && j + c >= 0 && j + c < p.n)
          keep |= 1u << (h * V + c);
        if (BOX && i + h >= p.rl && i + h < p.rh && j + c >= p.cl &&
            j + c < p.ch)
          keep |= 1u << (kBoxBit + h * V + c);
      }
    }
    const bool col_out = active && gx >= S::EQ && gx < S::GX - S::EQ;
    const bool quad_out = col_out && VEC && j + V <= p.nr;
    // the thread's copies: buffer row and column of its first, and whether
    // its column lies inside the buffer
    const int gr0 = p.r0 + i0 - S::ER - R;
    const int gc0 = p.c0 + j0 - (S::EQ + 1) * V;
    const int crow = gr0 + tid / S::PQ;
    const int ccol = gc0 + tid % S::PQ * V;
    const bool col_in = tid < S::CR * S::PQ && ccol >= 0 && ccol + V <= p.pitch;
    __syncthreads();  // the previous task's reads of shared memory are done

    // input plane u into its slot, zero outside the buffer; one commit
    // group per call, empty past the last plane
    auto fetch = [&](int u) {
      if (u < nin) {
        T* slot = s_in + (u % IN_SLOTS) * S::plane;
        const int gz = p.z0 + zb + u;
        const bool zin = gz >= 0 && gz < p.nz;
        const Cell* src =
            in + static_cast<size_t>(zin ? gz : 0) * plane_stride;
        if constexpr (VEC) {
          T* dst = slot + tid / S::PQ * S::ROW + tid % S::PQ * V;
#pragma unroll
          for (int k = 0; k < S::NCP; ++k) {
            const int gr = crow + k * S::CR;
            const bool ok = zin && col_in && gr >= 0 && gr < p.rows;
            if (tid < S::CR * S::PQ && tid / S::PQ + k * S::CR < S::PR)
              copy_quad(dst + k * S::CR * S::ROW,
                        ok ? src + static_cast<size_t>(gr) * p.pitch + ccol
                           : in,
                        ok);
          }
        } else {
          for (int q = tid; q < S::PR * S::PQ * V; q += S::threads) {
            const int pr = q / (S::PQ * V), pc = q % (S::PQ * V);
            const int gr = gr0 + pr, gc = gc0 + pc;
            const bool ok = zin && gr >= 0 && gr < p.rows && gc >= 0 &&
                            gc < p.pitch;
            cp_async_cell(slot + pr * S::ROW + pc,
                          ok ? src + static_cast<size_t>(gr) * p.pitch + gc
                             : in,
                          ok);
          }
        }
      }
      cp_async_commit();
    };
    // plane v's cells masked to the interior or, at `bit` kBoxBit, to the
    // box (level 1 of 2 under BOX), and the last level's stored
    auto mask = [&](int v, T (&acc)[CH][V], int bit, int zlo, int zhi) {
      const bool zok = zb + v >= zlo && zb + v < zhi;
#pragma unroll
      for (int h = 0; h < CH; ++h)
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (!(zok && (keep >> (bit + h * V + c) & 1u))) acc[h][c] = T(0);
    };
    auto store = [&](int v, const T (&acc)[CH][V]) {
      Cell* dst = out + static_cast<size_t>(p.z0 + zb + v) * plane_stride;
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        if (!(rows_out >> h & 1u)) continue;
        Cell* d =
            dst + static_cast<size_t>(p.r0 + i + h) * p.pitch + p.c0 + j;
        if (quad_out) {
          st_quad(d, acc[h]);
        } else if (col_out) {
#pragma unroll
          for (int c = 0; c < V; ++c)
            if (j + c < p.nr) d[c] = to_cell<Cell>(acc[h][c]);
        }
      }
    };
#pragma unroll
    for (int u = 0; u < kMarchAhead; ++u) fetch(u);

    // per level, the sums of its planes that wait for later planes' terms,
    // and the last R values of its z term (level_step)
    T pend[K][R][CH][V], held[K][R][CH][V];
#pragma unroll
    for (int L = 0; L < K; ++L)
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int h = 0; h < CH; ++h)
#pragma unroll
          for (int c = 0; c < V; ++c) pend[L][k][h][c] = held[L][k][h][c] = T(0);

    for (int u = 0; u < nin; ++u) {
      cp_async_wait<kMarchAhead - 1>();
      __syncthreads();  // plane u landed; the last plane's reads are done
      fetch(u + kMarchAhead);
      // level 1 takes input plane u and yields its plane u - R
      T lv[CH][V];
      if (active) {
        const T* back[R];  // planes u - R .. u - 1 (a slot of any plane < 0)
#pragma unroll
        for (int d = 0; d < R; ++d)
          back[d] = s_in + ((u - R + d + IN_SLOTS) % IN_SLOTS) * S::plane + win;
        level_step<S, NT, KINDS>(pl, s_in + (u % IN_SLOTS) * S::plane + win,
                                 back, pend[0], held[0], lv);
        if (u >= 2 * R) {
          if constexpr (BOX) {
            mask(u - R, lv, kBoxBit, p.zl, p.zh);
          } else {
            mask(u - R, lv, 0, 0, p.hz);
          }
          if constexpr (K == 1) store(u - R, lv);
        }
      }
      if constexpr (K == 2) {
        if (u >= 2 * R) {
          // level 2 takes level 1's plane u - R and yields its plane u - 2R
          const int v1 = u - R;
          T* const xl = s_lv + (v1 % LV_SLOTS) * S::plane;
          if (active) {
#pragma unroll
            for (int h = 0; h < CH; ++h) st_quad(xl + own + h * S::ROW, lv[h]);
          }
          __syncthreads();  // level 1's plane is in shared memory
          if (active) {
            const T* back[R];  // level 1's planes v1 - R .. v1 - 1
#pragma unroll
            for (int d = 0; d < R; ++d)
              back[d] = s_lv + ((v1 - R + d + LV_SLOTS) % LV_SLOTS) * S::plane +
                        win;
            T acc[CH][V];
            level_step<S, NT, KINDS>(pl, xl + win, back, pend[1], held[1], acc);
            if (u >= 4 * R) {
              mask(u - 2 * R, acc, 0, 0, p.hz);
              store(u - 2 * R, acc);
            }
          }
        }
      }
    }
  }
}

template <typename Cell, int R, int K, int NT, int KINDS, bool VEC, bool BOX,
          typename T = Compute<Cell>>
int launch_march(const Cell* in, Cell* out, const MarchPlan<T, R>& pl, Pass p,
                 cudaStream_t stream) {
  using S = March<T, R, K>;
  static int resident[kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(
      march_kernel<Cell, R, K, NT, KINDS, VEC, BOX>);
  const int smem = march_smem_bytes<T, R, K, NT, KINDS>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        S::threads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  const int tiles =
      ((p.mr + S::TM - 1) / S::TM) * ((p.nr + S::TN - 1) / S::TN);
  const int chunks = resident[dev] / tiles > 1 ? resident[dev] / tiles : 1;
  p.zc = (p.h + chunks - 1) / chunks;
  const int zmin = 16 * K * R < p.h ? 16 * K * R : p.h;
  if (p.zc < zmin) p.zc = zmin;
  const long tasks = static_cast<long>(tiles) * ((p.h + p.zc - 1) / p.zc);
  const int blocks =
      static_cast<int>(tasks < resident[dev] ? tasks : resident[dev]);
  march_kernel<Cell, R, K, NT, KINDS, VEC, BOX>
      <<<blocks, S::threads, smem, stream>>>(in, out, pl, p);
  return static_cast<int>(cudaGetLastError());
}

// plan_array's table (host memory) into the kernel's taps and KINDS.
template <typename T, int R>
bool fill_march_plan(const T* plan, int n_terms, MarchPlan<T, R>& pl,
                     int& kinds) {
  constexpr int W = 2 * R + 1;
  kinds = 0;
  const T* t = plan;
  for (int k = 0; k < n_terms; ++k, t += term_stride(R)) {
    const int cls = static_cast<int>(t[0]);
    if (cls != kCentre && cls != kIdentityZ && cls != kBuffered) return false;
    const int axes =
        (t[1] != T(0) ? kHasCol : 0) | (t[2] != T(0) ? kHasRow : 0);
    kinds |= (cls << 2 | axes) << (4 * k);
    for (int q = 0; q < W; ++q) {
      pl.zt[k][q] = t[3 + q];
      pl.ct[k][q] = t[3 + W + q];
      pl.rt[k][q] = t[3 + 2 * W + q];
    }
  }
  return true;
}

// The instance of the copies (vec) and, at K = 2, of a box that is not the
// interior (a ghost boundary's ring).
template <typename Cell, int R, int K, int NT, int KINDS,
          typename T = Compute<Cell>>
int march_instance(const Cell* in, Cell* out, const MarchPlan<T, R>& pl,
                   const Pass& p, int vec, bool box, cudaStream_t stream) {
  if constexpr (K == 2) {
    if (box)
      return vec ? launch_march<Cell, R, K, NT, KINDS, true, true>(in, out,
                                                                   pl, p,
                                                                   stream)
                 : launch_march<Cell, R, K, NT, KINDS, false, true>(in, out,
                                                                    pl, p,
                                                                    stream);
  }
  return vec ? launch_march<Cell, R, K, NT, KINDS, true, false>(in, out, pl,
                                                                p, stream)
             : launch_march<Cell, R, K, NT, KINDS, false, false>(in, out, pl,
                                                                 p, stream);
}

// The instantiation of the plan's term mix; any other is refused.
template <typename Cell, int R, int K, typename T = Compute<Cell>>
int march_terms(const Cell* in, Cell* out, const T* plan, const Pass& p,
                int vec, cudaStream_t stream) {
  MarchPlan<T, R> pl = {};
  int kinds = 0;
  if (!fill_march_plan<T, R>(plan, p.n_terms, pl, kinds))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool box = has_box(p);
  if (p.n_terms == 3 && kinds == kStarKinds)
    return march_instance<Cell, R, K, 3, kStarKinds>(in, out, pl, p, vec, box,
                                                     stream);
  if (p.n_terms == 1 && kinds == kBoxKinds)
    return march_instance<Cell, R, K, 1, kBoxKinds>(in, out, pl, p, vec, box,
                                                    stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool march_valid(const Pass& p, int R) {
  return R >= 1 && R <= kMarchMaxRadius && (p.K == 1 || p.K == 2) &&
         p.n_res == 0 && p.n_terms >= 1 && p.n_terms <= kMarchMaxTerms &&
         p.plan_len == p.n_terms * term_stride(R) && p.h >= 0 && p.m >= 0 &&
         p.n >= 0 && p.mr >= p.m && p.nr >= p.n && p.z0 >= 0 &&
         p.z0 + p.h <= p.nz && p.r0 >= 0 && p.r0 + p.mr <= p.rows &&
         p.c0 >= 0 && p.c0 + p.nr <= p.pitch && box_valid(p) &&
         static_cast<long long>(p.rows) * p.pitch < (1LL << 31);
}

// A pass of K = 1 or 2 steps by the march kernel; `plan` is plan_array's
// table in host memory.  K picks the instantiation; the radius is 1 (the
// 3-D registry's: radius-2 instances took 168 registers and spilled at K =
// 2 in float32, PERF.md).
template <typename Cell>
int march(const Cell* in, Cell* out, const Compute<Cell>* plan, const Pass& p,
          int radius, void* stream) {
  if (!plan || !march_valid(p, radius))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.h == 0 || p.mr == 0 || p.nr == 0) return 0;
  // a quad: 16 bytes of the compute type, V cells of the state
  constexpr int V = 16 / static_cast<int>(sizeof(Compute<Cell>));
  constexpr uintptr_t kQuadBytes = V * sizeof(Cell);
  const int vec = reinterpret_cast<uintptr_t>(in) % kQuadBytes == 0 &&
                  reinterpret_cast<uintptr_t>(out) % kQuadBytes == 0 &&
                  p.pitch % V == 0 && p.c0 % V == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.K == 1 ? march_terms<Cell, 1, 1>(in, out, plan, p, vec, s)
                   : march_terms<Cell, 1, 2>(in, out, plan, p, vec, s);
}

}  // namespace

// csrc/plan3d.cu includes this source for its helpers
// (LS_STENCIL3D_NO_ENTRIES) and defines entries of its own.
#ifndef LS_STENCIL3D_NO_ENTRIES
// Shared-memory bytes of a pass with this radius, K, block tile, term mix
// (n_buf buffered terms; ring = 1 or 2r+1 planes per level), plan length and
// element size (4 or 8 bytes); -1 if the arguments are out of range.
extern "C" long long ls_stencil3d_smem_bytes(int radius, int K, int bm, int bn,
                                             int n_buf, int ring,
                                             int plan_len, int itemsize) {
  Pass p = make_pass(plan_len, 0, 0, n_buf, ring, K, 0, 0, 0, 0, 0, 0, 0, 0,
                     0, 0, 0, bm, bn, 1);
  if (radius < 0 || radius > kMaxRadius || K < 1 || K > kMaxK || bm < 1 ||
      bn < 1 || n_buf < 0 || plan_len < 0 ||
      (itemsize != 4 && itemsize != 8) ||
      level_cells(p, radius, 1) > kPerThread * kThreads)
    return -1;
  return static_cast<long long>(smem_bytes(p, radius, itemsize));
}

// Each entry: the input and output buffers, the plan and its counts, the term
// mix, K, the buffer extents, the origin of interior cell (0, 0, 0), the
// interior, the rounded plane, the block tile, the z chunk, the box of the
// levels before the last (Pass's zl .. ch), the window of the rounded plane
// the launch covers, rows [wi0, wi1) x columns [wj0, wj1) (in_window), and
// the stream.
#define LS_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const T* in, T* out, const Compute<T>* plan,          \
                      int plan_len,                                         \
                      int n_terms, int radius, int n_res, int n_buf,        \
                      int ring, int K, int nz, int rows, int pitch, int z0, \
                      int r0, int c0, int h, int m, int n, int mr, int nr,  \
                      int bm, int bn, int zc, int zl, int zh, int rl,       \
                      int rh, int cl, int ch, int wi0, int wi1, int wj0,    \
                      int wj1, void* stream) {                              \
    return step(in, out, plan,                                              \
                in_window(with_box(make_pass(plan_len, n_terms, n_res,      \
                                             n_buf, ring, K, nz, rows,      \
                                             pitch, z0, r0, c0, h, m, n,    \
                                             mr, nr, bm, bn, zc),           \
                                   zl, zh, rl, rh, cl, ch),                 \
                          wi0, wi1, wj0, wj1),                              \
                radius, stream);                                            \
  }
#ifndef LS_STENCIL3D_BF16
LS_ENTRY(ls_stencil3d_step, float)
LS_ENTRY(ls_stencil3d_step_f64, double)
#else
LS_ENTRY(ls_stencil3d_step_bf16, __nv_bfloat16)
#endif

// The march kernel's entries: the input and output buffers, the tap table
// in host memory and its counts, K, the buffer extents, the origin of
// interior cell (0, 0, 0), the interior, the rounded plane, the box of
// level 1 at K = 2 (Pass's zl .. ch), the window (as LS_ENTRY's) and the
// stream.
#define LS_MARCH(NAME, T)                                                    \
  extern "C" int NAME(const T* in, T* out, const Compute<T>* plan,          \
                      int plan_len,                                         \
                      int n_terms, int radius, int n_res, int K, int nz,    \
                      int rows, int pitch, int z0, int r0, int c0, int h,   \
                      int m, int n, int mr, int nr, int zl, int zh, int rl, \
                      int rh, int cl, int ch, int wi0, int wi1, int wj0,    \
                      int wj1, void* stream) {                              \
    return march(in, out, plan,                                             \
                 in_window(with_box(make_pass(plan_len, n_terms, n_res, 0,  \
                                              1, K, nz, rows, pitch, z0,    \
                                              r0, c0, h, m, n, mr, nr,      \
                                              kMarchTileRows,               \
                                              kMarchTileQuads * 16 /        \
                                                  static_cast<int>(         \
                                                      sizeof(Compute<T>)),  \
                                              1),                           \
                                    zl, zh, rl, rh, cl, ch),                \
                           wi0, wi1, wj0, wj1),                             \
                 radius, stream);                                           \
  }
#ifndef LS_STENCIL3D_BF16
LS_MARCH(ls_stencil3d_march, float)
LS_MARCH(ls_stencil3d_march_f64, double)
#else
// the bfloat16 state tier (csrc/stencil3d_bf16.cu): the float32 kernels'
// instances on bf16 cells
LS_MARCH(ls_stencil3d_march_bf16, __nv_bfloat16)
#endif
#endif  // LS_STENCIL3D_NO_ENTRIES
