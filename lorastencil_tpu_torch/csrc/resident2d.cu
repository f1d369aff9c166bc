// Every step of a 2-D dirichlet0 run in one cooperative launch, the state
// resident in the SMs' shared memory, in float32 or float64: the
// shared-memory resident kernel (ls_stencil2d_resident_smem, *_f64).  It
// replaces lorastencil_tpu/ops/pallas_2d.py::_stencil2d_resident_kernel
// (stencil2d_resident, float32) and pallas_df64.py::_resident_pair_2d_kernel
// (stencil2d_resident_pair; native float64 here, as csrc/stencil2d.cu's
// float64 instances are) for radius 1..kMaxRadius and at most kMaxTerms
// terms, which is every 2-D registry shape; csrc/stencil2d.cu's resident
// kernel takes the rest (ops/stencil2d.py resident_takes).
//
// One step, for every cell of the rounded interior (csrc/stencil2d.cu's):
//
//     out = sum_terms rowconv(colconv(in)) + sum_residue w * in[p + o]
//
// masked to 0 outside the true interior [0, m) x [0, n); the guard ring
// holds the halo for step 1 only and is 0 after it.  Each cell's sum keeps
// tile_sums' order: per term the column conv (along a row, plan "col"
// taps), then the row conv (down a column), taps in ascending offset, zero
// taps skipped; then the residue point by point; fmaf in float32,
// __dmul_rn / __dadd_rn in float64.  So a run equals as many single steps of
// the strip and tile kernels, and the plain twin, bit for bit.
//
// What bounds it: latency.  At 512^2 a step is ~1 MiB of float32 state and
// ~5-15 MFLOP, under a microsecond of the card's bytes or operations, so
// the time goes to the chain of each step: the block's compute, then the
// handshake with the neighbours.  The design:
//   * ownership: one block per SM (or fewer, for small grids); the rounded
//     interior is cut into pr x pc rectangles of nearly equal size (rows
//     [a mr / pr, (a + 1) mr / pr), columns likewise), each at least R
//     cells on a side unless it spans its axis, so that a rectangle's
//     R-wide ring lies in its <= 8 neighbours.  The host picks (pr, pc)
//     with the smallest window (tests/test_torch_resident_tiles.py
//     mirrors it).  A block holds its rectangle plus the ring twice in
//     shared memory (ping-pong windows); `in` is read once at the start and
//     the result written once at the end;
//   * a step, border first: the cells within R of the rectangle's border
//     (the ones the neighbours need) are computed one a thread, each as
//     independent chains, and sent at once; then, while they travel, the
//     inner cells of the next step, which need no ring: one a thread
//     where they are few, else a march (a thread owns march_cols columns
//     and a chunk of rows, each window row's column convs of every term
//     computed once and kept, the last 2R + 1, in a register ring, as
//     csrc/stencil2d.cu's strip kernels do); then the ring, read from the
//     neighbours' border;
//   * handshake, no grid barrier: each border cell goes to a zeroed
//     exchange buffer of two parities as 8-byte words that carry the
//     cell's bits beside the number of the state they belong to, so one
//     relaxed store publishes it and the reader polls the words of its
//     ring until they carry the state it waits for: no counter, no fence.
//     (On an H100 a counter per block beside the border, and one
//     thread-block cluster reading the neighbours' shared memory, were
//     slower or no faster; PERF.md has the times.)
//
// Why two parities suffice.  State t's border goes to parity (t - 1) % 2,
// so block X overwrites it with state t + 2's.  X computes state t + 2's
// border only from its ring of state t + 1, which it reads from every
// neighbour Y after Y sent it; Y sends state t + 1's border only after
// computing it from its own ring of state t, which it read (into shared
// memory, before the barrier that precedes that computation) from X's
// state t border.  So every read of state t's border precedes the store
// that overwrites it, and a polled word never carries a newer state than
// the one awaited.  The last step sends no border: no block reads it.
// Spinning is safe because the launch is cooperative: every block is
// resident, or the launch is refused.  A wait that outlasts
// kSpinLimitCycles traps (the launch fails) rather than hang the card.
//
// Capacity: a block's two windows fit kMaxSmem beside the residue's
// offsets.  The host refuses an internal buffer above
// ls_stencil2d_resident_capacity's bytes: 4/5 of what the SMs' windows hold,
// a margin under which the partition fits every aspect ratio at radius
// <= 4 (tests/test_torch_resident_tiles.py scans it); about 12.26 MB on 132
// SMs, a 1750^2 float32 or 1235^2 float64 layout.
//
// C interface, loaded with ctypes: ls_stencil2d_resident_smem (float) and
// ls_stencil2d_resident_smem_f64 (double) launch on the given stream,
// allocate nothing (the wrapper passes the zeroed output buffer and tagged
// words) and return a cudaError_t (0 = launched);
// ls_stencil2d_resident_capacity returns the capacity in bytes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 384;
constexpr int kMaxRadius = 4;
constexpr int kMaxTerms = 3;
constexpr int kMaxRes = (2 * kMaxRadius + 1) * (2 * kMaxRadius + 1);
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr int kResFast = 8;  // residue points whose loads go out together
// bytes of one of a block's two windows, at most: the shared memory beside
// the residue's offsets
constexpr size_t kWindowBytes = (kMaxSmem - sizeof(int) * kMaxRes) / 2;
// a wait's limit in SM clock cycles: seconds at any clock the card runs
constexpr long long kSpinLimitCycles = 8000000000ll;

struct Grid2D {
  int rows, pitch;  // buffer shape
  int r0, c0;       // origin of interior cell (0, 0)
  int m, n;         // interior
  int mr, nr;       // rounded interior
};

// w * x + y: fused in fp32, rounded step by step in fp64.
__device__ __forceinline__ float mad(float w, float x, float y) {
  return fmaf(w, x, y);
}
__device__ __forceinline__ double mad(double w, double x, double y) {
  return __dadd_rn(y, __dmul_rn(w, x));
}
// mad, or y where the tap is zero.  In float32 a select, not a branch, so
// that the independent sums beside it keep going (the product of a zero
// tap and an infinite cell is never added); in float64, whose pipe the
// sums keep busy, a branch that skips the zero tap's product and sum (on
// an H100 the select's extra float64 work cost 5-40% of a step).
template <typename T>
__device__ __forceinline__ T tap(T w, T x, T y) {
  if constexpr (sizeof(T) == 8) {
    if (w != T(0)) y = mad(w, x, y);
    return y;
  } else {
    const T z = mad(w, x, y);
    return w != T(0) ? z : y;
  }
}

// plan_array's table for one R, by value: per term its flags and W column
// and row taps; per residue point its offsets and weight.
template <typename T, int R>
struct SmemPlan {
  T ct[kMaxTerms][2 * R + 1];
  T rt[kMaxTerms][2 * R + 1];
  T res_w[kMaxRes];
  signed char res_dr[kMaxRes];
  signed char res_dc[kMaxRes];
  int has_col[kMaxTerms];
  int has_row[kMaxTerms];
  int n_terms;
  int n_res;
};
static_assert(sizeof(SmemPlan<double, kMaxRadius>) + 128 <= 4096,
              "the kernel's parameters must fit in 4 KB");

// The exchange of a block's border between steps: a zeroed buffer of two
// parities of the rounded interior's cells, each cell as 8-byte words (two
// a float64 cell) of 32 of its bits beside the number of the state it
// belongs to, stored and polled with relaxed device-scope accesses.
constexpr int kRingLoads = 4;  // ring cells whose loads a thread has out

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

// A wait that outlasts kSpinLimitCycles traps; the SM's cycle counter is
// cheap to read on every poll (the global timer is not).
__device__ __forceinline__ void check_spin(long long& t0) {
  if (t0 == 0) {
    t0 = clock64();
  } else if (clock64() - t0 > kSpinLimitCycles) {
    __trap();
  }
}

// A cell in the tagged exchange buffer: words of 32 bits of the cell and
// the state's number above them.
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
// The cell whose words `lo` (and `hi`, float64) were loaded from `p`,
// once both carry `tag`: reloaded until they do.
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

// The block's rectangle and where its border goes.
struct Rect {
  int gi0, gj0;  // first interior cell
  int h, w;      // rows, columns
  int P;         // window pitch: w + 2R
};

// Columns a thread of the inner march owns: two in float32 (their loads
// shared, two independent chains), one in float64 (its registers).
template <typename T>
__host__ __device__ constexpr int march_cols() {
  return sizeof(T) == 4 ? 2 : 1;
}

// The residue of the cell whose window centre is `c`, point by point after
// `acc`: `off` holds each point's offset in the window (dr P + dc, per
// block in shared memory, 0 past the plan's points).  The first kResFast
// points go in groups of four whose cells are loaded before their sums
// (the plan's weights and offsets indexed at run time each cost a
// dependent constant load), the rest one by one.
template <typename T, int R>
__device__ __forceinline__ T residue(const T* c, const int* off,
                                     const SmemPlan<T, R>& pl, T acc) {
  if (pl.n_res == 0) return acc;
#pragma unroll
  for (int p0 = 0; p0 < kResFast; p0 += 4) {
    T xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = c[off[p0 + i]];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (p0 + i < pl.n_res) acc = mad(pl.res_w[p0 + i], xv[i], acc);
  }
  for (int p = kResFast; p < pl.n_res; ++p)
    acc = mad(pl.res_w[p], c[off[p]], acc);
  return acc;
}

// One step of the cell whose window (the (2R + 1)^2 cells around it) starts
// at `x` (pitch P), computed alone: every term's column convs of the window
// rows are independent chains, in float32 with no branch between them (a
// zero tap, even a whole zero row, is a select; see tap).
template <typename T, int R>
__device__ __forceinline__ T cell(const T* x, int P, const int* off,
                                  const SmemPlan<T, R>& pl) {
  constexpr int W = 2 * R + 1;
  T acc = T(0);
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t) {
    if (t < pl.n_terms) {
      T z;
      if (pl.has_row[t]) {
        T ys[W];
        if (pl.has_col[t]) {
#pragma unroll
          for (int k = 0; k < W; ++k) {
            T y = T(0);
            // float64 skips a zero row's sums (see tap)
            if (sizeof(T) == 4 || pl.rt[t][k] != T(0)) {
#pragma unroll
              for (int q = 0; q < W; ++q)
                y = tap(pl.ct[t][q], x[k * P + q], y);
            }
            ys[k] = y;
          }
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k) ys[k] = x[k * P + R];
        }
        z = T(0);
#pragma unroll
        for (int k = 0; k < W; ++k) z = tap(pl.rt[t][k], ys[k], z);
      } else {  // the identity row axis: window row R alone
        const T* xr = x + R * P;
        if (pl.has_col[t]) {
          z = T(0);
#pragma unroll
          for (int q = 0; q < W; ++q) z = tap(pl.ct[t][q], xr[q], z);
        } else {
          z = xr[R];
        }
      }
      acc += z;
    }
  }
  return residue<T, R>(x + R * P + R, off, pl, acc);
}

// Cells (ua .. ua + rows - 1) x (v .. v + C - 1) of one step of the block's
// rectangle, columns from v_end on left alone: dst from src (windows of
// pitch P, the rectangle's cell (u, v) at window cell (u + R, v + R)).  The
// thread marches down the columns: each window row's column convs of every
// term are computed once and kept, the last 2R + 1, in a register ring.
template <typename T, int R>
__device__ __forceinline__ void march(const T* __restrict__ src,
                                      T* __restrict__ dst, const Rect& r,
                                      int v, int v_end, int ua, int rows,
                                      const int* off,
                                      const SmemPlan<T, R>& pl, int m, int n) {
  constexpr int W = 2 * R + 1;
  constexpr int C = march_cols<T>();
  const int P = r.P;
  T ring[kMaxTerms][C][W] = {};
  const T* x = src + ua * P + v;  // window row ua, the taps of column v
  for (int wr = 0; wr < rows + 2 * R; ++wr, x += P) {
    T xs[W + C - 1];
#pragma unroll
    for (int k = 0; k < W + C - 1; ++k) xs[k] = x[k];
#pragma unroll
    for (int t = 0; t < kMaxTerms; ++t) {
      if (t < pl.n_terms) {
        T y[C];
        if (pl.has_col[t]) {
#pragma unroll
          for (int j = 0; j < C; ++j) y[j] = T(0);
#pragma unroll
          for (int k = 0; k < W; ++k)
#pragma unroll
            for (int j = 0; j < C; ++j)
              y[j] = tap(pl.ct[t][k], xs[j + k], y[j]);
        } else {
#pragma unroll
          for (int j = 0; j < C; ++j) y[j] = xs[j + R];  // identity axis
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
#pragma unroll
          for (int k = 0; k < W - 1; ++k) ring[t][j][k] = ring[t][j][k + 1];
          ring[t][j][W - 1] = y[j];
        }
      }
    }
    if (wr < 2 * R) continue;
    const int u = ua + wr - 2 * R;  // ring[t][j][k]: window row u + k
    T acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = T(0);
#pragma unroll
    for (int t = 0; t < kMaxTerms; ++t) {
      if (t < pl.n_terms) {
        T z[C];
        if (pl.has_row[t]) {
#pragma unroll
          for (int j = 0; j < C; ++j) z[j] = T(0);
#pragma unroll
          for (int k = 0; k < W; ++k)
#pragma unroll
            for (int j = 0; j < C; ++j)
              z[j] = tap(pl.rt[t][k], ring[t][j][k], z[j]);
        } else {
#pragma unroll
          for (int j = 0; j < C; ++j) z[j] = ring[t][j][R];  // identity axis
        }
#pragma unroll
        for (int j = 0; j < C; ++j) acc[j] += z[j];
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      // a column past v_end is still inside the window: its sum is dropped
      const T val = residue<T, R>(src + (u + R) * P + v + j + R, off, pl,
                                  acc[j]);
      if (v + j < v_end)
        dst[(u + R) * P + v + j + R] =
            (r.gi0 + u < m && r.gj0 + v + j < n) ? val : T(0);
    }
  }
}

// The cells within R of the rectangle's border (rows [0, a) and [b, h), and
// columns [0, c) and [d, w) of rows [a, b)), one a thread, and the inner
// cells [a, b) x [c, d): one a thread where they are no more than the
// threads (a march's 2R rows of warm-up would be its critical path), else
// tasks of march_cols columns and a chunk of rows each, enough chunks to
// give every thread one.
struct Tasks {
  int a, b, c, d;
  int side_cols, band_cells;
  int in_cells;  // > 0: the inner cells, one a thread
  int in_cols, in_crows, in_tasks;
};

template <typename T, int R>
__device__ Tasks plan_tasks(int h, int w) {
  constexpr int C = march_cols<T>();
  Tasks q;
  q.a = min(R, h);
  q.b = max(q.a, h - R);
  q.c = min(R, w);
  q.d = max(q.c, w - R);
  const int mid = q.b - q.a;
  q.side_cols = q.c + (w - q.d);
  q.band_cells = (q.a + h - q.b) * w + mid * q.side_cols;
  q.in_cols = (q.d - q.c + C - 1) / C;  // column groups
  q.in_cells = mid * (q.d - q.c) <= kThreads ? mid * (q.d - q.c) : 0;
  q.in_tasks = 0;
  q.in_crows = 1;
  if (q.in_cells == 0 && mid > 0 && q.in_cols > 0) {
    const int chunks =
        q.in_cols >= kThreads ? 1 : min(mid, kThreads / q.in_cols);
    q.in_crows = (mid + chunks - 1) / chunks;
    q.in_tasks = q.in_cols * ((mid + q.in_crows - 1) / q.in_crows);
  }
  return q;
}

// Border cell t: (u, v).
__device__ __forceinline__ void band_cell(const Tasks& q, int h, int w, int t,
                                          int& u, int& v) {
  const int top = q.a * w;
  const int bottom = (h - q.b) * w;
  if (t < top + bottom) {
    u = t / w + (t < top ? 0 : q.b - q.a);
    v = t % w;
    return;
  }
  t -= top + bottom;
  u = q.a + t / q.side_cols;
  const int vi = t % q.side_cols;
  v = vi < q.c ? vi : q.d + vi - q.c;
}

// All `steps` steps: block b owns rectangle (b / pc, b % pc) of the pr x pc
// partition.  Per step s: the border of state s + 1 first, sent to `xch`
// (the zeroed tagged buffer, two parities of the rounded interior's cells),
// then (while it travels) the inner cells of state s + 2, then the ring of
// state s + 1.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
resident_smem_kernel(const T* __restrict__ in, T* out,
                     unsigned long long* xch,
                     const __grid_constant__ SmemPlan<T, R> pl, Grid2D g,
                     int pr, int pc, int steps) {
  constexpr int K = sizeof(T) / 4;  // tagged words a cell
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_off[kMaxRes];  // the residue's window offsets
  const int a = blockIdx.x / pc;
  const int b = blockIdx.x % pc;
  Rect r;
  r.gi0 = static_cast<int>(static_cast<long long>(a) * g.mr / pr);
  r.gj0 = static_cast<int>(static_cast<long long>(b) * g.nr / pc);
  r.h = static_cast<int>(static_cast<long long>(a + 1) * g.mr / pr) - r.gi0;
  r.w = static_cast<int>(static_cast<long long>(b + 1) * g.nr / pc) - r.gj0;
  r.P = r.w + 2 * R;
  const int h = r.h, w = r.w, P = r.P;
  const int WR = h + 2 * R;  // window rows
  T* const win0 = reinterpret_cast<T*>(smem_raw);
  T* const win1 = win0 + WR * P;
  const Tasks q = plan_tasks<T, R>(h, w);
  // the buffers' cell of window cell (0, 0)
  const ptrdiff_t origin = static_cast<ptrdiff_t>(g.r0 + r.gi0 - R) * g.pitch +
                           g.c0 + r.gj0 - R;
  const ptrdiff_t xplane = static_cast<ptrdiff_t>(g.mr) * g.nr * K;

  for (int idx = threadIdx.x; idx < WR * P; idx += kThreads) {
    const int wu = idx / P;
    win0[idx] = __ldg(in + origin + static_cast<ptrdiff_t>(wu) * g.pitch +
                      idx - wu * P);
  }
  for (int p = threadIdx.x; p < kMaxRes; p += kThreads)
    s_off[p] = p < pl.n_res ? pl.res_dr[p] * P + pl.res_dc[p] : 0;
  __syncthreads();
  auto inner = [&](const T* src, T* dst) {
    const int cols = q.d - q.c;
    for (int t = threadIdx.x; t < q.in_cells; t += kThreads) {
      const int u = q.a + t / cols;
      const int v = q.c + t % cols;
      T val = cell<T, R>(src + u * P + v, P, s_off, pl);
      if (r.gi0 + u >= g.m || r.gj0 + v >= g.n) val = T(0);
      dst[(u + R) * P + v + R] = val;
    }
    for (int t = threadIdx.x; t < q.in_tasks; t += kThreads) {
      const int ua = q.a + t / q.in_cols * q.in_crows;
      march<T, R>(src, dst, r, q.c + t % q.in_cols * march_cols<T>(), q.d,
                  ua, min(q.in_crows, q.b - ua), s_off, pl, g.m, g.n);
    }
  };
  inner(win0, win1);

  const int band = R * P;  // ring cells in each of the top and bottom bands
  const int ring = 2 * band + 2 * R * h;
  for (int s = 0;; ++s) {
    T* const src = (s & 1) ? win1 : win0;
    T* const dst = (s & 1) ? win0 : win1;
    if (s > 0) {
      // the ring of state s, the neighbours' border: 0 outside the rounded
      // interior (the guard, 0 after step 1); kRingLoads cells a thread at a
      // time, their loads out together
      const unsigned long long* xs = xch + ((s - 1) & 1) * xplane;
      for (int i0 = threadIdx.x; i0 < ring; i0 += kRingLoads * kThreads) {
        int slot[kRingLoads];
        const unsigned long long* wp[kRingLoads];
        unsigned long long lo[kRingLoads], hi[kRingLoads];
#pragma unroll
        for (int i = 0; i < kRingLoads; ++i) {
          const int idx = i0 + i * kThreads;
          slot[i] = -1;
          wp[i] = nullptr;
          lo[i] = hi[i] = 0;
          if (idx >= ring) continue;
          int wu, wv;
          if (idx < 2 * band) {
            const int t = idx < band ? idx : idx - band;
            wu = t / P + (idx < band ? 0 : h + R);
            wv = t % P;
          } else {
            const int t = idx - 2 * band;
            const int e = t % (2 * R);
            wu = R + t / (2 * R);
            wv = e < R ? e : w + e;
          }
          slot[i] = wu * P + wv;
          const int gi = r.gi0 - R + wu;
          const int gj = r.gj0 - R + wv;
          if (gi < 0 || gi >= g.mr || gj < 0 || gj >= g.nr) continue;
          wp[i] = xs + (static_cast<ptrdiff_t>(gi) * g.nr + gj) * K;
          lo[i] = load_word(wp[i]);
          if (K == 2) hi[i] = load_word(wp[i] + 1);
        }
#pragma unroll
        for (int i = 0; i < kRingLoads; ++i) {
          if (slot[i] < 0) continue;
          src[slot[i]] =
              wp[i] ? settle_tagged<T>(wp[i], lo[i], hi[i], s) : T(0);
        }
      }
      __syncthreads();
    }
    // the border of state s + 1, and its cells to the exchange
    const bool last = s + 1 == steps;
    unsigned long long* const xd = xch + (s & 1) * xplane;
    for (int t = threadIdx.x; t < q.band_cells; t += kThreads) {
      int u, v;
      band_cell(q, h, w, t, u, v);
      T val = cell<T, R>(src + u * P + v, P, s_off, pl);
      if (r.gi0 + u >= g.m || r.gj0 + v >= g.n) val = T(0);
      dst[(u + R) * P + v + R] = val;
      if (!last)
        store_tagged(
            xd + (static_cast<ptrdiff_t>(r.gi0 + u) * g.nr + r.gj0 + v) * K,
            val, s + 1);
    }
    __syncthreads();  // dst's rectangle complete
    if (last) break;
    inner(dst, src);  // state s + 2's inner cells
  }

  // the rectangle of the last step
  const T* res = (steps & 1) ? win1 : win0;
  for (int idx = threadIdx.x; idx < h * w; idx += kThreads) {
    const int u = idx / w;
    const int v = idx - u * w;
    out[origin + static_cast<ptrdiff_t>(u + R) * g.pitch + v + R] =
        res[(u + R) * P + v + R];
  }
}

// Window cells (one of the two) of the largest rectangle of a pr x pc
// partition of the rounded interior.
long long window_cells(const Grid2D& g, int R, int pr, int pc) {
  const long long h = (g.mr + pr - 1) / pr;
  const long long w = (g.nr + pc - 1) / pc;
  return (h + 2 * R) * (w + 2 * R);
}

// The partition: at most `blocks` rectangles, each at least R cells on a
// side unless it spans its axis; the one whose largest window is the
// smallest (the first, at the fewest row cuts, among equals).
void partition(const Grid2D& g, int R, int blocks, int& pr, int& pc) {
  const int max_pr = g.mr / R < blocks ? g.mr / R : blocks;
  long long best = -1;
  pr = pc = 1;
  for (int r = 1; r <= (max_pr > 1 ? max_pr : 1); ++r) {
    int c = blocks / r < g.nr / R ? blocks / r : g.nr / R;
    if (c < 1) c = 1;
    const long long cells = window_cells(g, R, r, c);
    if (best < 0 || cells < best) {
      best = cells;
      pr = r;
      pc = c;
    }
  }
}

// Bytes of the largest internal buffer a launch over `blocks` blocks takes:
// 4/5 of the cells their windows hold.
long long capacity_bytes(size_t cell, int blocks) {
  const long long window = static_cast<long long>(kWindowBytes / cell);
  return 4LL * blocks * window / 5 * static_cast<long long>(cell);
}

int sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

template <typename T, int R>
bool fill_plan(const T* plan, int n_terms, int n_res, SmemPlan<T, R>& pl) {
  constexpr int W = 2 * R + 1;
  if (n_terms > kMaxTerms || n_res > kMaxRes) return false;
  const T* t = plan;
  for (int k = 0; k < n_terms; ++k, t += 2 + 2 * W) {
    pl.has_col[k] = t[0] != T(0);
    pl.has_row[k] = t[1] != T(0);
    for (int q = 0; q < W; ++q) {
      pl.ct[k][q] = t[2 + q];
      pl.rt[k][q] = t[2 + W + q];
    }
  }
  pl.n_terms = n_terms;
  pl.n_res = n_res;
  for (int p = 0; p < n_res; ++p) {
    const int dr = static_cast<int>(t[3 * p]);
    const int dc = static_cast<int>(t[3 * p + 1]);
    if (dr < -R || dr > R || dc < -R || dc > R) return false;
    pl.res_dr[p] = static_cast<signed char>(dr);
    pl.res_dc[p] = static_cast<signed char>(dc);
    pl.res_w[p] = t[3 * p + 2];
  }
  return true;
}

// A run of `steps` steps; `plan` is plan_array's table in host memory, in
// the state's dtype; `xch` holds n_xch zeroed words.  Refused: a radius or
// term count the kernel does not take, an internal buffer above the
// capacity, too few words; the launch itself is refused unless every block
// is resident.
template <typename T>
int launch_resident_smem(const T* in, T* out, unsigned long long* xch,
                         long long n_xch, const T* plan, int plan_len,
                         int n_terms, int R, int n_res, Grid2D g, int steps,
                         void* stream) {
  const int W = 2 * R + 1;
  if (steps < 1 || !plan || R < 1 || R > kMaxRadius || n_terms < 0 ||
      n_terms > kMaxTerms || n_res < 0 || n_res > W * W ||
      plan_len != n_terms * (2 + 2 * W) + 3 * n_res || g.r0 < R ||
      g.c0 < R || g.m < 0 || g.n < 0 || g.mr < g.m || g.nr < g.n ||
      g.r0 + g.mr + R > g.rows || g.c0 + g.nr + R > g.pitch ||
      n_xch < 2LL * g.mr * g.nr * static_cast<long long>(sizeof(T) / 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.mr == 0 || g.nr == 0) return 0;
  int sms = 0;
  cudaError_t e = static_cast<cudaError_t>(sm_count(sms));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (static_cast<long long>(g.rows) * g.pitch * sizeof(T) >
      capacity_bytes(sizeof(T), sms))
    return static_cast<int>(cudaErrorInvalidValue);
  int pr = 1, pc = 1;
  partition(g, R, sms, pr, pc);
  // the instance of R, and its plan by value
  SmemPlan<T, 1> p1 = {};
  SmemPlan<T, 2> p2 = {};
  SmemPlan<T, 3> p3 = {};
  SmemPlan<T, 4> p4 = {};
  const void* kernel = nullptr;
  void* pl = nullptr;
  bool ok = false;
  switch (R) {
    case 1:
      ok = fill_plan<T, 1>(plan, n_terms, n_res, p1), pl = &p1;
      kernel = reinterpret_cast<const void*>(resident_smem_kernel<T, 1>);
      break;
    case 2:
      ok = fill_plan<T, 2>(plan, n_terms, n_res, p2), pl = &p2;
      kernel = reinterpret_cast<const void*>(resident_smem_kernel<T, 2>);
      break;
    case 3:
      ok = fill_plan<T, 3>(plan, n_terms, n_res, p3), pl = &p3;
      kernel = reinterpret_cast<const void*>(resident_smem_kernel<T, 3>);
      break;
    default:
      ok = fill_plan<T, 4>(plan, n_terms, n_res, p4), pl = &p4;
      kernel = reinterpret_cast<const void*>(resident_smem_kernel<T, 4>);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(T) * window_cells(g, R, pr, pc);
  if (smem > 2 * kWindowBytes) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < pr * pc)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&in, &out, &xch, pl, &g, &pr, &pc, &steps};
  e = cudaLaunchCooperativeKernel(kernel, dim3(pr * pc), dim3(kThreads),
                                  args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The input buffer, the zeroed output buffer, the zeroed tagged words and
// their number, the plan and its counts, then the buffer shape (rows,
// pitch), the origin of interior cell (0, 0), the interior (m, n), the
// rounded interior (mr, nr), the steps, and the stream.
#define LS_RESIDENT_SMEM(NAME, T)                                             \
  extern "C" int NAME(const T* in, T* out, unsigned long long* xch,          \
                      long long n_xch, const T* plan, int plan_len,          \
                      int n_terms, int radius, int n_res, int rows,          \
                      int pitch, int r0, int c0, int m, int n, int mr,       \
                      int nr, int steps, void* stream) {                     \
    return launch_resident_smem(in, out, xch, n_xch, plan, plan_len,         \
                                n_terms, radius, n_res,                      \
                                Grid2D{rows, pitch, r0, c0, m, n, mr, nr},   \
                                steps, stream);                              \
  }
LS_RESIDENT_SMEM(ls_stencil2d_resident_smem, float)
LS_RESIDENT_SMEM(ls_stencil2d_resident_smem_f64, double)

// Bytes of the largest internal buffer (rows x pitch cells) a launch takes
// on the current card, for float64 (`f64` != 0) or float32 cells, radius
// and terms; 0 where the kernel does not take the radius or the term
// count, a negated cudaError_t if the card cannot be asked.
extern "C" long long ls_stencil2d_resident_capacity(int f64, int radius,
                                                    int n_terms) {
  if (radius < 1 || radius > kMaxRadius || n_terms < 0 ||
      n_terms > kMaxTerms)
    return 0;
  int sms = 0;
  const int e = sm_count(sms);
  if (e != 0) return -static_cast<long long>(e);
  return capacity_bytes(f64 ? sizeof(double) : sizeof(float), sms);
}
