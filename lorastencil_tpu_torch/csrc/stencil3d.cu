// K fused dirichlet0 timesteps of a 3-D low-rank stencil on the port's
// internal layout, in float32 or float64, on CUDA cores: one pass over device
// memory.
//
// The float32 instance (ls_stencil3d_step) replaces the TPU kernel
// lorastencil_tpu/ops/pallas_3d.py::_stencil3d_kernel (driven by
// pallas_3d.stencil3d_step).  The float64 instance (ls_stencil3d_step_f64)
// serves the fp64-grade tier: it replaces
// lorastencil_tpu/ops/pallas_df64_3d.py::_df64_3d_kernel (df64_3d_step), which
// computes one fp64-grade step on error-free (hi, lo) fp32 pairs because the
// TPU has no fp64 unit; the H100 has one, so this instance computes in native
// double, and it also runs dtype float64 with fused steps, as the JAX engine
// runs pallas_3d's kernel in float64 off the TPU.  Level L = 1..K of the pass
// turns level L-1 into level L at in-plane extent (K-L)*r around the block
// tile; each level-L plane z sums, in order (ops/band_gemm.py apply_spec_3d):
//
//     the centre terms' plane convs of plane z
//   + each buffered term's plane convs of planes z-r..z+r times its z taps
//   + each identity term's planes z-r..z+r times its z taps
//   + the residue,
//
// and every level is masked to the global interior in z and in-plane, so
// the halo decays exactly as the reference's step-by-step semantics
// require.  Level K is the output: the rounded interior of every plane,
// with cells beyond the true interior written as zeros; the guard ring is
// never written.
//
// What bounds it: device-memory bytes.  A pass must read and write 4 B
// (float32) or 8 B (float64) per interior cell and does ~10-25 operations
// per cell per level, far below the card's fp32 and fp64 rates.  The design
// keeps every intermediate out of device memory:
//   * one block owns a (bm x bn) in-plane tile and a z chunk of zc output
//     planes, and marches z one input plane at a time; it starts K*r
//     planes early and recomputes that lookback, because blocks run in no
//     order and cannot inherit it (the TPU's sequential slab carry has no
//     counterpart);
//   * shared memory holds, per level, a ring of the last 2r+1 planes (one
//     plane when only buffered terms read it), and per buffered term and
//     level a ring of 2r+1 plane convs: each plane's conv is computed once
//     (the reference artifact's rotating conv buffer, src/3d/gpu_box.cu);
//   * the input ring has one slot more, which cp.async fills with the next
//     plane while the block computes on the current one;
//   * each thread keeps its cells' sums of a level plane in registers and
//     walks the terms once per plane, taps staged in registers;
//   * the host picks the largest tile whose rings fit the 227 KB of shared
//     memory for the pass's K and element size (ops/stencil3d.py; float64
//     rings take twice the bytes), and a z chunk that gives every SM work.
// Each input cell is read from device memory about (1 + 2Kr/zc) (1 +
// 2Kr/bm)(1 + 2Kr/bn) times, and each output cell written once.  This
// first kernel is not yet near that bound (PERF.md): its time goes to the
// work inside the SM on every level plane, not to device-memory bytes.  Sums
// follow the plain twin's order (ops/band_gemm.py): fp32 fuses each
// multiply-add (fmaf), so integer data agree bit for bit, and so does any
// data when every tap is a power of two; fp64 rounds each product and sum on
// its own (__dmul_rn, __dadd_rn: no FMA), so it agrees bit for bit on any
// data.
//
// C interface, loaded with ctypes: ls_stencil3d_smem_bytes sizes a launch,
// ls_stencil3d_step (float) and ls_stencil3d_step_f64 (double) launch on the
// given stream, allocate nothing and return cudaGetLastError() (0 =
// launched).

#include <cuda_runtime.h>

#include <cstddef>

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

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
stencil3d_kernel(const T* __restrict__ in, T* __restrict__ out,
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
    const T* src = in + static_cast<size_t>(zin ? gz : 0) * plane_stride;
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int ii = warp; ii < hin; ii += kWarps) {
      const int gr = p.r0 + i0 - e + ii;
      const bool rin = zin && gr >= 0 && gr < p.rows;
      const T* srow = src + static_cast<size_t>(rin ? gr : 0) * p.pitch;
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

      // Mask to the interior (z, rows, cols); store to the level ring, or
      // for level K to the rounded interior of the output.
      const int zv = zs - K * R + v;  // interior z of the plane
      const bool zok = zv >= 0 && zv < p.h;
      T* dst = smem + ring_off(p, R, L) + (v % p.ring) * cells + tid;
      T* gdst = out + static_cast<size_t>(p.z0 + zv) * plane_stride +
                    static_cast<size_t>(p.r0) * p.pitch + p.c0;
      int gi = i0 - e + tid / wout;  // interior coords of cell k
      int gj = j0 - e + tid % wout;
      for_cells<R>(n_mine, [&](int k) {
        if (k < n_mine) {
          const bool ok = zok && gi >= 0 && gi < p.m && gj >= 0 && gj < p.n;
          if (L < K) {
            dst[k * kThreads] = ok ? acc[k] : T(0);
          } else if (gi < p.mr && gj < p.nr) {
            gdst[static_cast<size_t>(gi) * p.pitch + gj] = ok ? acc[k] : T(0);
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

bool valid(const Pass& p, int R) {
  const int W = 2 * R + 1;
  return R >= 1 && R <= kMaxRadius && p.K >= 1 && p.K <= kMaxK &&
         p.n_terms >= 0 && p.n_res >= 0 && p.n_buf >= 0 &&
         (p.ring == 1 || p.ring == W) && p.plan_len <= kMaxPlan &&
         p.plan_len == p.n_terms * term_stride(R) + 4 * p.n_res &&
         p.bm >= 1 && p.bn >= 1 && p.zc >= 1 && p.h >= 0 && p.m >= 0 &&
         p.n >= 0 && p.mr >= p.m && p.nr >= p.n && p.z0 >= 0 &&
         p.z0 + p.h <= p.nz && p.r0 >= 0 && p.r0 + p.mr <= p.rows &&
         p.c0 >= 0 && p.c0 + p.nr <= p.pitch &&
         (p.mr + p.bm - 1) / p.bm <= kMaxGrid &&
         (p.h + p.zc - 1) / p.zc <= kMaxGrid;
}

template <typename T, int R>
int launch(const T* in, T* out, const T* plan, const Pass& p,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(p, R, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stencil3d_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.nr + p.bn - 1) / p.bn, (p.mr + p.bm - 1) / p.bm,
                  (p.h + p.zc - 1) / p.zc);
  stencil3d_kernel<T, R><<<grid, kThreads, smem, stream>>>(in, out, plan, p);
  return static_cast<int>(cudaGetLastError());
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
  return p;
}

template <typename T>
int step(const T* in, T* out, const T* plan, const Pass& p, int radius,
         void* stream) {
  if (!valid(p, radius) || smem_bytes(p, radius, sizeof(T)) > kMaxSmem ||
      level_cells(p, radius, 1) > kPerThread * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.h == 0 || p.mr == 0 || p.nr == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch<T, 1>(in, out, plan, p, s);
    case 2: return launch<T, 2>(in, out, plan, p, s);
    case 3: return launch<T, 3>(in, out, plan, p, s);
    case 4: return launch<T, 4>(in, out, plan, p, s);
    case 5: return launch<T, 5>(in, out, plan, p, s);
    case 6: return launch<T, 6>(in, out, plan, p, s);
    case 7: return launch<T, 7>(in, out, plan, p, s);
    case 8: return launch<T, 8>(in, out, plan, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared-memory bytes of a pass with this radius, K, block tile, term mix
// (n_buf buffered terms; ring = 1 or 2r+1 planes per level), plan length and
// element size (4 or 8 bytes); -1 if the arguments are out of range.
extern "C" long long ls_stencil3d_smem_bytes(int radius, int K, int bm, int bn,
                                             int n_buf, int ring,
                                             int plan_len, int itemsize) {
  Pass p = make_pass(plan_len, 0, 0, n_buf, ring, K, 0, 0, 0, 0, 0, 0, 0, 0,
                     0, 0, 0, bm, bn, 1);
  if (radius < 1 || radius > kMaxRadius || K < 1 || K > kMaxK || bm < 1 ||
      bn < 1 || n_buf < 0 || plan_len < 0 ||
      (itemsize != 4 && itemsize != 8) ||
      level_cells(p, radius, 1) > kPerThread * kThreads)
    return -1;
  return static_cast<long long>(smem_bytes(p, radius, itemsize));
}

// Each entry: the input and output buffers, the plan and its counts, the term
// mix, K, the buffer extents, the origin of interior cell (0, 0, 0), the
// interior, the rounded plane, the block tile, the z chunk and the stream.
#define LS_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const T* in, T* out, const T* plan, int plan_len,     \
                      int n_terms, int radius, int n_res, int n_buf,        \
                      int ring, int K, int nz, int rows, int pitch, int z0, \
                      int r0, int c0, int h, int m, int n, int mr, int nr,  \
                      int bm, int bn, int zc, void* stream) {               \
    return step(in, out, plan,                                              \
                make_pass(plan_len, n_terms, n_res, n_buf, ring, K, nz,     \
                          rows, pitch, z0, r0, c0, h, m, n, mr, nr, bm, bn, \
                          zc),                                              \
                radius, stream);                                            \
  }
LS_ENTRY(ls_stencil3d_step, float)
LS_ENTRY(ls_stencil3d_step_f64, double)
