// Dirichlet0 timesteps of a 2-D low-rank stencil on the port's internal
// layout, in float32, float64 or bfloat16, on CUDA cores.  The kernels share
// one per-cell arithmetic, so each equals the others (and its plain twin)
// cell for cell on the same steps:
//
//   * the strip kernel (ls_stencil2d_strip: float32; ls_stencil2d_strip_f64,
//     strip64_kernel: float64; k = 1, radius 1..4, at most kStripMaxTerms
//     terms), the step kernel (ls_stencil2d_step with k = 1) and the fused
//     kernel, k >= 2 levels per pass over device memory (the same entry
//     with k >= 2), replace lorastencil_tpu/ops/pallas_2d.py::
//     _stencil2d_kernel (pallas_2d.stencil2d_step, extent fusion);
//   * the skew kernel (ls_stencil2d_skew) replaces
//     pallas_2d.py::_stencil2d_skew_kernel (stencil2d_skew_step, time-skewed
//     row bands);
//   * the step, fused and skew kernels (the tile kernels) serve only what
//     the strip walk leaves: csrc/plan2d.cu's plan strip kernel takes every
//     other launch of radius 1..8 within its caps, from either wrapper
//     (ops/stencil2d.py _one_kind), so they keep radius 9 up to the wide
//     radii, plans past its terms, residue or shared memory, bfloat16
//     launches deeper than 4, and the float64 launches the card measured
//     faster here (ops/stencil2d.py tile_beats_plan);
//   * the fused strip kernel (ls_stencil2d_fused_strip: float32, k = 2,
//     radius 1..4, 1 or 2 terms, no residue) serves both of those wrappers
//     where it takes their pass: one traversal for the two TPU kernels;
//   * the resident kernel (ls_stencil2d_resident), every step of a run in one
//     cooperative launch, replaces pallas_2d.py::_stencil2d_resident_kernel
//     (stencil2d_resident).
//
// The strip, step, skew and resident kernels have a float32 and a float64
// instance (the *_f64 entries; the float64 strip kernel is a kernel of its
// own, strip64_kernel); the fused strip kernel is float32 only.  Every
// float32 kernel also has a bfloat16 instance (the *_bf16 entries: the
// bf16 state tier, TPU kernels #1-#3 on a bfloat16 state): the kernels are
// templated on the state's cell type S and compute in Compute<S>, float for
// bfloat16, so a cell is widened at its load (exact) and rounded to nearest
// even (__float2bfloat16_rn) at its store.  A tiled pass thus rounds once,
// whatever its fused levels (they stay float32 in registers or shared
// memory); the resident run stores every step in S, so it rounds every step.
// The plan stays float32.  The float64
// strip kernel (and the float64 step beyond its radii and terms) replaces
// lorastencil_tpu/ops/pallas_df64.py::_df64_kernel (df64_step)
// and the float64 resident run pallas_df64.py::_resident_pair_2d_kernel
// (stencil2d_resident_pair): the TPU computes the fp64-grade tier on
// error-free (hi, lo) fp32 pairs because it has no fp64 unit; the H100 has
// one, so these instances compute in native double.  The float64 fused and
// skew kernels serve dtype float64 with fused steps, as the JAX engine runs
// pallas_2d's kernels in float64 off the TPU.
//
// One step, for every interior cell:
//
//     out = sum_terms rowconv(colconv(in)) + sum_residue w * in[p + o]
//
// and every cell outside the true interior [0, m) x [0, n) becomes 0 (the
// tile round-up cells, and at fused levels the halo and guard cells:
// pallas_2d.py mask_to_interior), so the halo feeds step 1 only and then
// decays, as the reference's step-by-step semantics require.  Under a ghost
// boundary (periodic, reflect) a fused pass's levels before the last keep the
// interior and the ring the host refilled instead (Grid2D's box, the JAX
// kernels' `bounds`); the last level keeps the interior.  A shard of the
// sharded engines (parallel/domain.py) gives a box that may start beyond the
// guard (an inner shard's ring holds its neighbours' cells) and end inside
// the interior (the last shard of an axis that the mesh does not divide:
// cells past the true edge are padding); its last level keeps the box cut to
// the interior.  The guard ring of the output buffer is never written.  The order of each sum is the plain
// twin's (ops/band_gemm.py apply_spec): per term the column conv, then the
// row conv, taps in ascending offset, zero taps skipped; then the residue
// point by point.  fp32 fuses each multiply-add (fmaf), so integer data agree
// with the twin bit for bit; fp64 rounds each product and sum on its own
// (__dmul_rn, __dadd_rn: no FMA), so it agrees bit for bit on any data.
//
// What bounds it: device-memory bytes.  A step reads and writes 4 B (fp32)
// or 8 B (fp64) per cell and does ~25-40 operations per cell (star2d1r,
// star2d3r), below the card's fp32 and fp64 rates, so the aim is to touch
// each cell's bytes once per pass, and, with k fused steps, once per k steps.
// The designs:
//   * strip (float32, k = 1, radius R <= 4, at most 3 terms): the main
//     path's step.  A warp owns 128 columns (four adjacent ones per lane)
//     and walks down a task of rows two at a time.  Input rows come into a
//     per-warp shared ring by 16-byte cp.async copies (4-byte ones where
//     the layout's alignment does not allow 16), kStripAhead rows ahead of
//     the compute; each lane reads its 12-column window of a new row with
//     three 16-byte shared loads, computes every term's column conv of the
//     row once, and keeps the last 2R + 2 of them per term in a register
//     ring, so the row conv reads no shared memory and needs no barrier: a
//     warp waits only on its own copies (__syncwarp).  The residue reads
//     each point's 4 cells from the ring in 16-byte loads of the aligned
//     quads around them (4-byte loads, lanes 16 bytes apart, would conflict
//     4 ways); a point's weight, offsets and load pattern serve the row
//     pair.  The plan comes by value in a __grid_constant__ parameter
//     (StripPlan) under a compile-time R and term count, so each
//     multiply-add of a term takes its weight from the constant bank; a
//     zero tap is a uniform branch.  Rows go out as 16-byte stores.  Each
//     warp the card holds at once takes one task, a column strip's share
//     of its rows, so that no wave runs part full.  The sums are
//     tile_sums', cell for cell (below).  The float64 strip kernel
//     (strip64_kernel) walks the same way with two cells per lane, so a
//     warp owns 64 columns and its rings take the registers four float32
//     cells would; both rows of a pair go through each tap together, and
//     its zero taps are tested on integer bit masks of the plan;
//   * fused strip (float32, k = 2, at most kFusedStripMaxTerms terms, each
//     with a row or column axis, no residue): the strip kernel's walk with
//     every level in registers.
//     Level 1 is the strip step on the input ring; level L >= 2 takes level
//     L - 1's masked row straight from registers, the R cells beyond each
//     lane's four from its neighbours by __shfl_up/down_sync, and keeps its
//     own register ring of column convs, lagging level L - 1 by R rows, so
//     every level row is computed once per task, with no shared
//     intermediate and no block barrier.  Lanes 0 and 31 lack a neighbour,
//     so level L is right on lanes L - 1 .. 32 - L and a warp stores
//     128 - 8 (K - 1) columns; the strips overlap by 8 (K - 1) columns,
//     and a task of n rows reads n + 2KR input rows.  Both rows of a pair
//     go through each tap together.  The terms' axes are a template
//     parameter (KINDS, chosen on the host from the plan), and a zero tap
//     is a predicated FMA (fma8_nonzero): per-term flags read at run time
//     and a branch per tap were both slower on the card.  The sums are
//     tile_sums' and level()'s, cell for cell;
//   * step (k = 1; past the strip walk's reach): one block per
//     (kTileRows x 128) output tile stages its
//     halo'd window in shared memory with coalesced row loads (a warp per
//     window row), computes the column conv into a shared intermediate 2r rows
//     taller than the tile, the row conv and residue into kTileRows / 2
//     register sums per thread, and stores them masked (tile_sums);
//   * fused (k >= 2): the window grows to (kTileRows + 2kr) x (128 + 2kr);
//     levels 1..k-1 ping-pong between two shared buffers over extents
//     shrinking by r per level, each masked to the interior in global
//     coordinates (level); level k is the step's tile_sums.  Shared memory
//     grows with k*r (about three windows), so the host splits a deeper pass
//     into launches of the largest k that fits (ops/stencil2d.py);
//   * skew (past the strip walk's reach; a skewed pass within it takes the
//     fused pass's launches): a block owns a 128-column strip and a chunk of
//     kChunkRows output
//     rows and marches down it in bands of kTileRows rows.  Level j lags level
//     j - 1 by r rows; each level keeps the last 2r rows of its previous band
//     in shared memory as the carry, so every level row is computed once per
//     block and only the k*r column halo is recomputed.  Blocks run in no
//     order, so each chunk starts (k - 2) r rows early and recomputes that
//     lookback: 64 strips of an 8192-column grid would leave half of the 132
//     SMs idle, and 256-row chunks give 32 blocks per strip;
//   * resident: one cooperative launch; persistent blocks loop over the
//     step's tiles, ping-pong two device buffers (which L2 holds for small
//     grids) and sync the grid between steps; loads bypass L1 (__ldcg), as
//     other blocks wrote the buffer since.  The launch is refused if the
//     occupancy query gives no resident block;
//   * wide (k = 1, a radius whose step window does not fit a block's shared
//     memory: above about 60 in float32, 35 in float64, up to kMaxRadius,
//     the reach the JAX layout's 128-column guard allows): a block owns a
//     (kTileRows x 64) tile and stages only a two-axis term's column convs
//     ((kTileRows + 2r) x 64 cells), reading every input through the
//     read-only cache; a one-axis term and the residue read the input
//     directly.  No bound was aimed at: it is the simple kernel that makes
//     the wide radii run (ROADMAP C3).
// kTileRows is 32 in fp32 and 16 in fp64: the 8-byte window of a 32-row tile
// would take 70 KB of shared memory at r = 1 (3 blocks per SM); at 16 rows it
// takes 37 KB (6 blocks per SM).  The TPU's split-bf16 matmuls, cyclic rolls
// and double-float pair arithmetic have no use here: tensor cores would not
// lift a byte-bound step, and their accumulation order could break the
// bit-exactness the tests hold the kernels to.
//
// Taps and residue come from a small device table in the state's dtype
// (ops/band_gemm.py plan_array), staged into shared memory by every block;
// the strip kernels take the same table from host memory by value.
//
// A pass may cover a window of the rounded interior only, whole layout
// tiles (the JAX kernel's `region`: the sharded engine's overlapped step
// computes its boundary frame first, then the inner window while the strips
// travel).  No kernel tests a window: the host moves the launch's origin to
// the window's first cell and its rounded extent to the window's (in_window),
// so the blocks start there, every store stays inside it, and a launch over
// the whole interior is the launch it was.
//
// C interface, loaded with ctypes: ls_stencil2d_step (the wide kernel
// beyond the step kernel's shared memory), ls_stencil2d_strip,
// ls_stencil2d_skew and ls_stencil2d_resident (float) and their *_f64
// (double) and *_bf16 (bfloat16 cells, a float plan) twins, and
// ls_stencil2d_fused_strip and its *_bf16 twin, launch on the given stream,
// allocate nothing and return a cudaError_t (0 = launched).  The *_bf16
// entries build apart, as csrc/stencil2d_bf16.cu (this source with
// LS_STENCIL2D_BF16 defined), so that the two builds run side by side.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileCols = 128;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTileCols;  // rows per sweep: 2
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadius = 128;  // the reach of the JAX layout's column guard
constexpr int kMaxPlan = 4096;  // entries of tap/residue table
constexpr int kMaxGridY = 65535;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr int kChunkRows = 256;      // skew: output rows per block

static_assert(kThreads % kTileCols == 0, "tile columns must divide threads");

// Output rows per block (see the header), by the compute type.
template <typename T>
constexpr int tile_rows() {
  return sizeof(T) == sizeof(float) ? 32 : 16;
}

// The cell types.  A state of S (float, double or __nv_bfloat16) computes in
// Compute<S>, float for bfloat16: a cell is widened at its load (exact) and
// rounded to nearest even at its store (to_cell).  Shared memory, registers
// and the plan hold the compute type.
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
__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

// w * x + y: fused in fp32, rounded step by step in fp64.
__device__ __forceinline__ float mad(float w, float x, float y) {
  return fmaf(w, x, y);
}
__device__ __forceinline__ double mad(double w, double x, double y) {
  return __dadd_rn(y, __dmul_rn(w, x));
}

// A cell of device memory in the compute type; kCoherent reads past L1 (the
// buffer was written by other blocks of the launch).
template <typename S, bool kCoherent>
__device__ __forceinline__ Compute<S> load(const S* p) {
  if constexpr (kBf16<S>) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    if constexpr (kCoherent) {
      return bf16_bits_to_float(__ldcg(q));
    } else {
      return bf16_bits_to_float(__ldg(q));
    }
  } else if constexpr (kCoherent) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

// The stencil's table in shared memory (plan_array's layout).
template <typename T>
struct Plan {
  const T* p;  // per term: has_col, has_row, col taps[W], row taps[W];
               // then per residue point: dr, dc, w
  int n_terms;
  int R;
  int n_res;
};

// Rows [gr0, gr0 + n_rows) x cols [gc0, gc0 + n_cols) of a (rows x pitch)
// buffer into shared `dst` (row pitch n_cols, the compute type), a warp per
// row with neighbouring lanes on neighbouring addresses; cells outside the
// buffer read as 0.
template <typename S, bool kCoherent>
__device__ void stage(const S* in, int rows, int pitch, int gr0, int gc0,
                      Compute<S>* dst, int n_rows, int n_cols) {
  using T = Compute<S>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int wr = warp; wr < n_rows; wr += kWarps) {
    const int gr = gr0 + wr;
    T* d = dst + wr * n_cols;
    if (gr >= 0 && gr < rows) {
      const S* src = in + static_cast<size_t>(gr) * pitch;
      for (int wc = lane; wc < n_cols; wc += 32) {
        const int gc = gc0 + wc;
        d[wc] = (gc >= 0 && gc < pitch) ? load<S, kCoherent>(src + gc) : T(0);
      }
    } else {
      for (int wc = lane; wc < n_cols; wc += 32) d[wc] = T(0);
    }
  }
}

// One step on a (kTileRows x 128) tile: the thread's sums acc[q] of output
// row ty + q * kRowStep, column tx, where `win` (row pitch win_cols >= 128 +
// 2R, kTileRows + 2R rows) holds the source with output cell (i, j) centred
// at win[(i + R) * win_cols + j + R].  s_col takes (kTileRows + 2R) x 128
// cells.  Contains barriers: every thread of the block calls it.
template <typename T, int kTileRows>
__device__ __forceinline__ void tile_sums(const T* win, int win_cols,
                                          T* s_col, const Plan<T>& pl,
                                          T (&acc)[kTileRows / kRowStep]) {
  constexpr int kRowsPerThread = kTileRows / kRowStep;
  const int R = pl.R;
  const int W = 2 * R + 1;
  const int win_rows = kTileRows + 2 * R;
  const int tx = threadIdx.x % kTileCols;
  const int ty = threadIdx.x / kTileCols;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = T(0);

  const T* term = pl.p;
  for (int t = 0; t < pl.n_terms; ++t, term += 2 + 2 * W) {
    // flags are block-uniform: the barriers below are reached by all
    const bool has_col = term[0] != T(0);
    const bool has_row = term[1] != T(0);
    const T* ct = term + 2;
    const T* rt = ct + W;
    const T* src;
    int src_pitch;
    if (has_col) {
      __syncthreads();  // the previous reader of s_col is done with it
      for (int wr = ty; wr < win_rows; wr += kRowStep) {
        const T* x = win + wr * win_cols + tx;
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
      src = win + tx + R;  // identity column axis
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

  const T* res = pl.p + pl.n_terms * (2 + 2 * W);
  for (int p = 0; p < pl.n_res; ++p) {
    const int dr = static_cast<int>(res[3 * p]);
    const int dc = static_cast<int>(res[3 * p + 1]);
    const T w = res[3 * p + 2];
    const T* x = win + (R + dr + ty) * win_cols + R + dc + tx;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
      acc[q] = mad(w, x[q * kRowStep * win_cols], acc[q]);
  }
}

// Store tile_sums' cells of output rows i0 + ty + q * kRowStep in [lo, hi)
// at column j (< nr): the sum inside the interior, 0 in the round-up, each
// rounded to the state's type.
template <typename S, int kTileRows>
__device__ __forceinline__ void store_tile(
    S* out, int pitch, int r0, int c0, int i0, int j, int lo, int hi, int m,
    int n, const Compute<S> (&acc)[kTileRows / kRowStep]) {
  using T = Compute<S>;
  S* dst = out + static_cast<size_t>(r0) * pitch + c0 + j;
  const int ty = threadIdx.x / kTileCols;
#pragma unroll
  for (int q = 0; q < kTileRows / kRowStep; ++q) {
    const int i = i0 + ty + q * kRowStep;
    if (i >= lo && i < hi)
      dst[static_cast<ptrdiff_t>(i) * pitch] =
          to_cell<S>((i < m && j < n) ? acc[q] : T(0));
  }
}

// Advance a thread's (row, column) walk over a row-major extent of `cols`
// columns by kThreads cells.
__device__ __forceinline__ void next_cell(int& i, int& j, int cols) {
  j += kThreads;
  while (j >= cols) {
    j -= cols;
    ++i;
  }
}

// One step over a (rows x cols) extent in shared memory: dst(i, j) (row pitch
// dp) from src (row pitch sp), whose cell (i + R, j + R) is the centre of
// dst(i, j); a cell whose interior coordinates (gi0 + i, gj0 + j) lie outside
// the box [rlo, rhi) x [clo, chi) becomes 0: the interior [0, m) x [0, n), or
// under a ghost boundary the interior and its ring (Grid2D's box).  s_col
// takes (rows + 2R) x cols cells.  The sums are tile_sums', cell for cell.
// Contains barriers and ends with one.
template <typename T>
__device__ void level(const T* src, int sp, T* dst, int dp, T* s_col,
                      int rows, int cols, const Plan<T>& pl, int gi0,
                      int gj0, int rlo, int rhi, int clo, int chi) {
  const int R = pl.R;
  const int W = 2 * R + 1;
  const int i_first = threadIdx.x / cols;
  const int j_first = threadIdx.x % cols;

  const T* term = pl.p;
  for (int t = 0; t < pl.n_terms; ++t, term += 2 + 2 * W) {
    const bool has_col = term[0] != T(0);
    const bool has_row = term[1] != T(0);
    const T* ct = term + 2;
    const T* rt = ct + W;
    const T* src_t;
    int pitch_t;
    if (has_col) {
      __syncthreads();  // the previous reader of s_col is done with it
      for (int i = i_first, j = j_first; i < rows + 2 * R;
           next_cell(i, j, cols)) {
        const T* x = src + i * sp + j;
        T y = T(0);
        for (int k = 0; k < W; ++k) {
          const T w = ct[k];
          if (w != T(0)) y = mad(w, x[k], y);
        }
        s_col[i * cols + j] = y;
      }
      __syncthreads();
      src_t = s_col;
      pitch_t = cols;
    } else {
      src_t = src + R;  // identity column axis
      pitch_t = sp;
    }
    for (int i = i_first, j = j_first; i < rows; next_cell(i, j, cols)) {
      const T* y = src_t + i * pitch_t + j;
      T z;
      if (has_row) {
        z = T(0);
        for (int k = 0; k < W; ++k) {
          const T w = rt[k];
          if (w != T(0)) z = mad(w, y[k * pitch_t], z);
        }
      } else {
        z = y[R * pitch_t];  // identity row axis
      }
      T* d = dst + i * dp + j;
      *d = (t == 0 ? T(0) : *d) + z;
    }
  }

  const T* res = pl.p + pl.n_terms * (2 + 2 * W);
  for (int i = i_first, j = j_first; i < rows; next_cell(i, j, cols)) {
    T* d = dst + i * dp + j;
    T acc = pl.n_terms > 0 ? *d : T(0);
    for (int p = 0; p < pl.n_res; ++p) {
      const int dr = static_cast<int>(res[3 * p]);
      const int dc = static_cast<int>(res[3 * p + 1]);
      acc = mad(res[3 * p + 2], src[(R + dr + i) * sp + R + dc + j], acc);
    }
    const int gi = gi0 + i;
    const int gj = gj0 + j;
    *d = (gi >= rlo && gi < rhi && gj >= clo && gj < chi) ? acc : T(0);
  }
  __syncthreads();
}

struct Grid2D {
  int rows, pitch;  // buffer shape
  int r0, c0;       // origin of interior cell (0, 0)
  int m, n;         // interior
  int mr, nr;       // rounded interior
  // the box [lr, hr) x [lc, hc), interior coordinates, that a pass's fused
  // levels before the last keep: the interior, or under a ghost boundary
  // the interior and its ring, which the host refilled (the JAX kernels'
  // `bounds`).  The last level keeps the interior cut at the box's ends
  // (in_window folds them into m, n): the ring it would keep beyond the
  // interior is refilled before the next pass reads it.
  int lr, hr, lc, hc;
};

// The grid of a launch over the window rows [i0, i1) x columns [j0, j1) of
// the rounded interior (the whole of it for a pass without a region): the
// window's first cell becomes interior cell (0, 0) and its extent the
// rounded interior, so the blocks start at the window's origin and store
// nothing outside it; the interior's ends and the box move with it.  The
// interior's ends are cut at the box's (hr, hc) first, so that the last
// level keeps the box cut to the interior.  A window outside the rounded
// interior gives a grid that bad_args refuses.
Grid2D in_window(Grid2D g, int i0, int i1, int j0, int j1) {
  if (i0 < 0 || i1 <= i0 || i1 > g.mr || j0 < 0 || j1 <= j0 || j1 > g.nr) {
    g.mr = -1;
    return g;
  }
  auto clamp = [](int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
  };
  const int m = clamp((g.hr < g.m ? g.hr : g.m) - i0, 0, i1 - i0);
  const int n = clamp((g.hc < g.n ? g.hc : g.n) - j0, 0, j1 - j0);
  const int hr = g.hr - i0 > m ? g.hr - i0 : m;
  const int hc = g.hc - j0 > n ? g.hc - j0 : n;
  return Grid2D{g.rows, g.pitch, g.r0 + i0, g.c0 + j0, m, n, i1 - i0,
                j1 - j0, g.lr - i0, hr, g.lc - j0, hc};
}

template <typename T>
__device__ __forceinline__ Plan<T> stage_plan(const T* plan, int plan_len,
                                              int n_terms, int R, int n_res,
                                              T* s_plan) {
  for (int p = threadIdx.x; p < plan_len; p += kThreads) s_plan[p] = plan[p];
  return Plan<T>{s_plan, n_terms, R, n_res};
}

// k steps per block tile, past the strip walk's reach (csrc/plan2d.cu takes
// radius 1..8 within its caps): the step kernel (kFused false, k = 1) and the
// fused one (kFused true, k >= 2; with kBox its levels before the last keep
// Grid2D's box, a ghost boundary's ring, the instance without it being the
// dirichlet0 pass's), compiled apart so that the step kernel
// keeps no registers for the levels.
template <typename S, int kTileRows, bool kFused, bool kBox>
__global__ void __launch_bounds__(kThreads)
step_kernel(const S* __restrict__ in, S* __restrict__ out,
            const Compute<S>* __restrict__ plan, int plan_len, int n_terms,
            int R, int n_res, Grid2D g, int k) {
  using T = Compute<S>;
  if constexpr (!kFused) k = 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T acc[kTileRows / kRowStep];
  const int E = k * R;  // the pass's reach
  const int e1 = E - R;
  const int win_rows = kTileRows + 2 * E;
  const int win_cols = kTileCols + 2 * E;
  T* s_a = smem;                            // win_rows x win_cols
  T* s_b = s_a + win_rows * win_cols;       // level buffer (k >= 2)
  T* s_col = s_b + (kFused ? (kTileRows + 2 * e1) * (kTileCols + 2 * e1) : 0);
  T* s_plan = s_col + win_rows * (kTileCols + 2 * e1);
  const int i0 = blockIdx.y * kTileRows;  // tile origin, interior coords
  const int j0 = blockIdx.x * kTileCols;

  const Plan<T> pl = stage_plan(plan, plan_len, n_terms, R, n_res, s_plan);
  // Window rows [i0 - E, i0 + kTileRows + E), cols [j0 - E, j0 + 128 + E)
  // of the interior; the guard (>= E, checked by the host) keeps the start
  // in bounds, and a tile past the rounded interior reads zeros beyond the
  // buffer's end.
  stage<S, false>(in, g.rows, g.pitch, g.r0 + i0 - E, g.c0 + j0 - E, s_a,
                  win_rows, win_cols);
  __syncthreads();

  const T* src = s_a;
  int src_cols = win_cols;
  if constexpr (kFused) {
    for (int lv = 1, e = e1; lv < k; ++lv, e -= R) {
      T* dst = (lv % 2) ? s_b : s_a;
      if constexpr (kBox)
        level(src, src_cols, dst, kTileCols + 2 * e, s_col, kTileRows + 2 * e,
              kTileCols + 2 * e, pl, i0 - e, j0 - e, g.lr, g.hr, g.lc, g.hc);
      else
        level(src, src_cols, dst, kTileCols + 2 * e, s_col, kTileRows + 2 * e,
              kTileCols + 2 * e, pl, i0 - e, j0 - e, 0, g.m, 0, g.n);
      src = dst;
      src_cols = kTileCols + 2 * e;
    }
  }
  tile_sums<T, kTileRows>(src, src_cols, s_col, pl, acc);
  const int j = j0 + threadIdx.x % kTileCols;
  if (j < g.nr)
    store_tile<S, kTileRows>(out, g.pitch, g.r0, g.c0, i0, j, 0, g.mr, g.m,
                             g.n, acc);
}

// k >= 2 time-skewed steps per block, past the strip walk's reach (a skewed
// pass within it runs the fused pass's launches): a 128-column strip, output
// rows [a, a + kChunkRows) of the rounded interior, bands of kTileRows rows.
template <typename S, int kTileRows>
__global__ void __launch_bounds__(kThreads)
skew_kernel(const S* __restrict__ in, S* __restrict__ out,
            const Compute<S>* __restrict__ plan, int plan_len, int n_terms,
            int R, int n_res, Grid2D g, int k) {
  using T = Compute<S>;
  constexpr int B = kTileRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T acc[kTileRows / kRowStep];
  const int band_rows = B + 2 * R;  // a level's carry of 2R rows + a band
  const int j0 = blockIdx.x * kTileCols;
  const int a = blockIdx.y * kChunkRows;
  const int end = min(a + kChunkRows, g.mr);
  // Level j (0 = the input) holds rows [T0 + t*B - j*R - 2R, T0 + (t+1)*B
  // - j*R) at band t, over columns [j0 - (k-j) R, j0 + 128 + (k-j) R); with
  // no rows below its first band computed, level j is right from row
  // T0 + (j-2) R on, so T0 makes level k right from row a.
  const int T0 = a - (k - 2) * R;
  // level buffers L[0..k-1], then s_col, then the plan
  T* s_col = smem;
  for (int lv = 0; lv < k; ++lv)
    s_col += band_rows * (kTileCols + 2 * (k - lv) * R);
  T* s_plan = s_col + band_rows * (kTileCols + 2 * (k - 1) * R);
  const Plan<T> pl = stage_plan(plan, plan_len, n_terms, R, n_res, s_plan);
  // no level row below a block's first band is ever read into a stored row,
  // but zeros keep those never-stored rows finite
  for (T* p = smem + threadIdx.x; p < s_col; p += kThreads) *p = T(0);

  for (int t = 0;; ++t) {
    const int out_row = T0 + t * B - k * R;  // level k's band
    if (out_row >= end) break;
    __syncthreads();  // the previous band's readers are done
    if (t == 0) {
      stage<S, false>(in, g.rows, g.pitch, g.r0 + T0 - 2 * R,
                      g.c0 + j0 - k * R, smem, band_rows,
                      kTileCols + 2 * k * R);
    } else {
      // each level's last 2R rows become its carry (B >= 2R: no overlap)
      T* buf = smem;
      for (int lv = 0; lv < k; ++lv) {
        const int cols = kTileCols + 2 * (k - lv) * R;
        for (int p = threadIdx.x; p < 2 * R * cols; p += kThreads)
          buf[p] = buf[B * cols + p];
        buf += band_rows * cols;
      }
      __syncthreads();
      stage<S, false>(in, g.rows, g.pitch, g.r0 + T0 + t * B,
                      g.c0 + j0 - k * R, smem + 2 * R * (kTileCols + 2 * k * R),
                      B, kTileCols + 2 * k * R);
    }
    __syncthreads();
    const T* src = smem;
    int src_cols = kTileCols + 2 * k * R;
    T* dst = smem + band_rows * src_cols;
    for (int lv = 1; lv < k; ++lv) {
      const int cols = kTileCols + 2 * (k - lv) * R;
      level(src, src_cols, dst + 2 * R * cols, cols, s_col, B, cols, pl,
            T0 + t * B - lv * R, j0 - (k - lv) * R, 0, g.m, 0, g.n);
      src = dst;
      src_cols = cols;
      dst += band_rows * cols;
    }
    tile_sums<T, kTileRows>(src, src_cols, s_col, pl, acc);
    const int j = j0 + threadIdx.x % kTileCols;
    if (j < g.nr)
      store_tile<S, kTileRows>(out, g.pitch, g.r0, g.c0, out_row, j, a, end,
                               g.m, g.n, acc);
  }
}

// All `steps` steps in one cooperative launch: step s reads `in` (s = 0) or
// the buffer step s - 1 wrote, and writes out0 (s even) or out1 (s odd).
// A bfloat16 state rounds every step: each step's state is stored in S.
template <typename S, int kTileRows>
__global__ void __launch_bounds__(kThreads)
resident_kernel(const S* in, S* out0, S* out1,
                const Compute<S>* __restrict__ plan, int plan_len,
                int n_terms, int R, int n_res, Grid2D g, int steps) {
  using T = Compute<S>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T acc[kTileRows / kRowStep];
  const int win_rows = kTileRows + 2 * R;
  const int win_cols = kTileCols + 2 * R;
  T* s_win = smem;
  T* s_col = s_win + win_rows * win_cols;
  T* s_plan = s_col + win_rows * kTileCols;
  const Plan<T> pl = stage_plan(plan, plan_len, n_terms, R, n_res, s_plan);
  const int tiles_x = (g.nr + kTileCols - 1) / kTileCols;
  const int tiles = tiles_x * ((g.mr + kTileRows - 1) / kTileRows);
  for (int s = 0; s < steps; ++s) {
    const S* src = s == 0 ? in : ((s - 1) % 2 ? out1 : out0);
    S* dst = s % 2 ? out1 : out0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int i0 = tile / tiles_x * kTileRows;
      const int j0 = tile % tiles_x * kTileCols;
      __syncthreads();  // the previous tile's readers are done
      stage<S, true>(src, g.rows, g.pitch, g.r0 + i0 - R, g.c0 + j0 - R,
                     s_win, win_rows, win_cols);
      __syncthreads();
      tile_sums<T, kTileRows>(s_win, win_cols, s_col, pl, acc);
      const int j = j0 + threadIdx.x % kTileCols;
      if (j < g.nr)
        store_tile<S, kTileRows>(dst, g.pitch, g.r0, g.c0, i0, j, 0, g.mr,
                                 g.m, g.n, acc);
    }
    if (s + 1 < steps) grid.sync();  // every tile written, every read done
  }
}

// -- the wide kernel: a step (k = 1) whose tile window overflows a block --
constexpr int kWideCols = 64;                       // output columns a block
constexpr int kWideRowStep = kThreads / kWideCols;  // rows per sweep: 4

// One step over a (kTileRows x kWideCols) output tile, for the radii whose
// staged window (the step kernel's) does not fit a block's shared memory:
// no input is staged.  A term with both axes puts its column conv of the
// tile's rows and their 2R-row halo into s_col ((kTileRows + 2R) x
// kWideCols cells: 147 KB in float64 at R = 128), reading its taps' inputs
// through the read-only cache; the row conv reads s_col; a one-axis term and
// the residue read the input the same way.  The plan is read from device
// memory.  tile_sums' order, so the sums are the step kernel's, cell for
// cell.
// One block per SM asked of ptxas: shared memory holds a few at most, and
// its default register target spilled.
template <typename S, int kTileRows>
__global__ void __launch_bounds__(kThreads, 1)
wide_step_kernel(const S* __restrict__ in, S* __restrict__ out,
            const Compute<S>* __restrict__ plan, int n_terms, int R,
            int n_res, Grid2D g) {
  using T = Compute<S>;
  constexpr int kRows = kTileRows / kWideRowStep;  // sums a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_col = reinterpret_cast<T*>(smem_raw);
  const int W = 2 * R + 1;
  const int tx = threadIdx.x % kWideCols;
  const int ty = threadIdx.x / kWideCols;
  const int i0 = blockIdx.y * kTileRows;  // tile origin, interior coords
  const int j = blockIdx.x * kWideCols + tx;
  const int gr0 = g.r0 + i0 - R;  // buffer row of window row 0
  const int gc = g.c0 + j;        // buffer column of the thread's cell
  // window row wr, dc columns right of the thread's cell; 0 outside the
  // buffer
  auto x = [&](int wr, int dc) -> T {
    const int r = gr0 + wr;
    const int c = gc + dc;
    return r >= 0 && r < g.rows && c >= 0 && c < g.pitch
               ? load<S, false>(in + static_cast<size_t>(r) * g.pitch + c)
               : T(0);
  };
  T acc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = T(0);

  const T* term = plan;
  for (int t = 0; t < n_terms; ++t, term += 2 + 2 * W) {
    // flags are block-uniform: the barriers below are reached by all
    const bool has_col = __ldg(term) != T(0);
    const bool has_row = __ldg(term + 1) != T(0);
    const T* ct = term + 2;
    const T* rt = ct + W;
    if (has_col && has_row) {
      __syncthreads();  // the previous reader of s_col is done with it
      for (int wr = ty; wr < kTileRows + 2 * R; wr += kWideRowStep) {
        T y = T(0);
        for (int q = 0; q < W; ++q) {
          const T w = __ldg(ct + q);
          if (w != T(0)) y = mad(w, x(wr, q - R), y);
        }
        s_col[wr * kWideCols + tx] = y;
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int o = ty + q * kWideRowStep;  // output row of the tile
      T z = T(0);
      if (has_row) {
        for (int k = 0; k < W; ++k) {
          const T w = __ldg(rt + k);
          if (w != T(0))
            z = mad(w, has_col ? s_col[(o + k) * kWideCols + tx] : x(o + k, 0),
                    z);
        }
      } else if (has_col) {  // identity row axis: the column conv of row o
        for (int c = 0; c < W; ++c) {
          const T w = __ldg(ct + c);
          if (w != T(0)) z = mad(w, x(o + R, c - R), z);
        }
      } else {
        z = x(o + R, 0);
      }
      acc[q] += z;
    }
  }
  const T* res = plan + n_terms * (2 + 2 * W);
  for (int p = 0; p < n_res; ++p) {
    const int dr = static_cast<int>(__ldg(res + 3 * p));
    const int dc = static_cast<int>(__ldg(res + 3 * p + 1));
    const T w = __ldg(res + 3 * p + 2);
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      acc[q] = mad(w, x(R + dr + ty + q * kWideRowStep, dc), acc[q]);
  }
  if (j >= g.nr) return;
  S* dst = out + static_cast<size_t>(g.r0) * g.pitch + g.c0 + j;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = i0 + ty + q * kWideRowStep;
    if (i < g.mr)
      dst[static_cast<ptrdiff_t>(i) * g.pitch] =
          to_cell<S>((i < g.m && j < g.n) ? acc[q] : T(0));
  }
}

// Shared memory of each kernel, in elements (ops/stencil2d.py repeats these).
template <typename T>
size_t step_cells(int k, int R, int plan_len) {
  const size_t tm = tile_rows<T>();
  const size_t E = static_cast<size_t>(k) * R;
  const size_t e1 = E - R;
  const size_t win = (tm + 2 * E) * (kTileCols + 2 * E);
  const size_t lvl = k > 1 ? (tm + 2 * e1) * (kTileCols + 2 * e1) : 0;
  return win + lvl + (tm + 2 * E) * (kTileCols + 2 * e1) + plan_len;
}

template <typename T>
size_t skew_cells(int k, int R, int plan_len) {
  const size_t band = tile_rows<T>() + 2 * static_cast<size_t>(R);
  size_t cells = plan_len + band * (kTileCols + 2 * (k - 1) * R);
  for (int lv = 0; lv < k; ++lv) cells += band * (kTileCols + 2 * (k - lv) * R);
  return cells;
}

template <typename T>
bool bad_args(int plan_len, int n_terms, int R, int n_res, const Grid2D& g,
              int reach) {
  const int W = 2 * R + 1;
  return R < 0 || R > kMaxRadius || n_terms < 0 || n_res < 0 ||
         plan_len > kMaxPlan || plan_len != n_terms * (2 + 2 * W) + 3 * n_res ||
         g.r0 < reach || g.c0 < reach || g.m < 0 || g.n < 0 || g.mr < g.m ||
         g.nr < g.n || g.lr > 0 || g.hr < g.m || g.lc > 0 || g.hc < g.n ||
         g.r0 + g.mr + reach > g.rows ||
         g.c0 + g.nr + reach > g.pitch ||
         (g.mr + tile_rows<T>() - 1) / tile_rows<T>() > kMaxGridY;
}

// -- the strip kernels: steps at k = 1, radius 1..kStripMaxRadius -----------
constexpr int kStripMaxRadius = 4;
constexpr int kStripMaxTerms = 3;
constexpr int kStripMaxRes = (2 * kStripMaxRadius + 1) * (2 * kStripMaxRadius + 1);
constexpr int kStripMinRows = 32;  // output rows of a warp's task, at least
constexpr int kStripCols = 128;  // columns of a warp's task: 4 per lane
constexpr int kStripPad = 4;     // window columns each side (>= R)
constexpr int kStripWindow = kStripCols + 2 * kStripPad;  // cells a row
// a ring row: the window, and one quad that a residue load may touch past it
constexpr int kStripRowCells = kStripWindow + 4;
// the float64 strip kernel's: 2 adjacent cells per lane
constexpr int kStrip64Cols = 64;
constexpr int kStrip64Window = kStrip64Cols + 2 * kStripPad;
constexpr int kStripRing = 16;   // input rows a warp holds (a power of 2)
constexpr int kStripAhead = 6;   // rows in flight ahead of the compute
constexpr int kStripWarps = 4;   // warps per block, each on its own tasks
constexpr int kMaxDevices = 64;
static_assert(kStripAhead + 2 * kStripMaxRadius + 2 <= kStripRing,
              "the ring must hold a row pair's residue rows and the rows "
              "ahead");

// plan_array's table for one R, by value: per term the flags, its W
// column and row taps and their nonzero ones as bit masks (bit q: tap q);
// per residue point its offsets and weight.
template <typename T, int R>
struct StripPlan {
  int has_col[kStripMaxTerms];
  int has_row[kStripMaxTerms];
  int col_nz[kStripMaxTerms];
  int row_nz[kStripMaxTerms];
  T ct[kStripMaxTerms][2 * R + 1];
  T rt[kStripMaxTerms][2 * R + 1];
  int n_res;
  int res_dr[kStripMaxRes];
  int res_dc[kStripMaxRes];
  T res_w[kStripMaxRes];
};
static_assert(sizeof(StripPlan<double, kStripMaxRadius>) + 128 <= 4096,
              "the strip kernels' parameters must fit in 4 KB");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// Quads: four adjacent cells of a float32 (16 bytes) or bfloat16 (8 bytes)
// row, which the strip kernels copy, read and store whole.  A quad into
// shared memory by cp.async (zeroed where !ok).
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src,
                                              bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void cp_async_quad(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0));
}
// One cell, off the quads' grid: a 4-byte cp.async, or for bfloat16 (which
// cp.async's 4-, 8- and 16-byte copies do not fit) a plain copy, which the
// warp's __syncwarp after the copies' wait orders as well.
__device__ __forceinline__ void copy_cell(float* dst, const float* src,
                                          bool ok) {
  cp_async4(dst, src, ok);
}
__device__ __forceinline__ void copy_cell(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, bool ok) {
  *reinterpret_cast<unsigned short*>(dst) =
      ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
}
// A quad of shared memory, widened to float.
__device__ __forceinline__ float4 read_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 read_quad(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_bits_to_float(u.x & 0xffffu),
                     __uint_as_float(u.x & 0xffff0000u),
                     bf16_bits_to_float(u.y & 0xffffu),
                     __uint_as_float(u.y & 0xffff0000u));
}
// Four sums into a quad of device memory, rounded to the state's type.
__device__ __forceinline__ void store_quad(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store_quad(__nv_bfloat16* dst,
                                           const float (&v)[4]) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                 bf16_bits(v[2]) | bf16_bits(v[3]) << 16);
}

// The lane's 4 cells of a residue point's row, at `xr` (the row's cell of
// the lane's first column, shifted by dc): loads of the aligned quads
// around them (one-cell loads, lanes a quad apart, would conflict 4 ways
// in float32).  `cls` is dc & 3, uniform over the warp.
template <typename S>
__device__ __forceinline__ void residue_cells(const S* xr, int cls,
                                              float (&v)[4]) {
  const float4 a = read_quad(xr - cls);
  if (cls == 0) {
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    return;
  }
  const float4 b = read_quad(xr - cls + 4);
  if (cls == 1) {
    v[0] = a.y, v[1] = a.z, v[2] = a.w, v[3] = b.x;
  } else if (cls == 2) {
    v[0] = a.z, v[1] = a.w, v[2] = b.x, v[3] = b.y;
  } else {
    v[0] = a.w, v[1] = b.x, v[2] = b.y, v[3] = b.z;
  }
}

// One float32 step per cell of rows [i0, i0 + rows) x columns
// [j0, j0 + 128) for each task of a warp, on a float32 or (S =
// __nv_bfloat16) bfloat16 state: the ring holds the state's cells, the
// sums are float32, each widened cell exact, and the store rounds to
// nearest even.  Lane l owns columns j0 + 4 l .. + 3.  `vec`: every row of
// `in` and `out` starts its window on a quad boundary (16 or 8 bytes) and
// nr % 4 == 0.  Rows go by pairs: a residue point's weight, offsets and
// load pattern serve two output rows.
// The launch bound asks for one block per SM: ptxas then gives each
// instantiation the registers its sums need (its own occupancy target
// spilled a few instantiations' registers).
template <typename S, int R, int NT>
__global__ void __launch_bounds__(kStripWarps * 32, 1)
strip_kernel(const S* __restrict__ in, S* __restrict__ out,
             const __grid_constant__ StripPlan<float, R> pl, Grid2D g, int vec,
             int rows) {
  constexpr int W = 2 * R + 1;
  constexpr int Y = W + 1;  // column convs kept: a pair's 2R + 2 rows
  __shared__ __align__(16) S ring_all[kStripWarps][kStripRing][kStripRowCells];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  S(*ring)[kStripRowCells] = ring_all[warp];
  const int col_tasks = (g.nr + kStripCols - 1) / kStripCols;
  const int tasks = col_tasks * ((g.mr + rows - 1) / rows);
  for (int task = blockIdx.x * kStripWarps + warp; task < tasks;
       task += gridDim.x * kStripWarps) {
    const int i0 = task / col_tasks * rows;
    const int j0 = task % col_tasks * kStripCols;
    const int n_out = min(rows, g.mr - i0);
    const int n_in = n_out + 2 * R;
    const int gr0 = g.r0 + i0 - R;  // buffer row of input row 0 (>= 0)
    const int gc0 = g.c0 + j0 - kStripPad;  // buffer column of window col 0
    const int j = j0 + 4 * lane;            // the lane's first column
    const bool inside = j + 3 < g.n;        // all 4 columns interior
    __syncwarp();  // the previous task's reads of the ring are done

    // input row s into ring slot s % kStripRing, 0 outside the buffer; one
    // commit group per call, empty past the last row
    auto fetch = [&](int s) {
      if (s < n_in) {
        S* dst = ring[s & (kStripRing - 1)];
        const int gr = gr0 + s;
        const S* src = in + static_cast<size_t>(gr) * g.pitch;
        if (vec) {
          for (int c = lane; c < kStripWindow / 4; c += 32) {
            const int gc = gc0 + 4 * c;
            const bool ok = gr < g.rows && gc >= 0 && gc + 4 <= g.pitch;
            cp_async_quad(dst + 4 * c, ok ? src + gc : in, ok);
          }
        } else {
          for (int c = lane; c < kStripWindow; c += 32) {
            const int gc = gc0 + c;
            const bool ok = gr < g.rows && gc >= 0 && gc < g.pitch;
            copy_cell(dst + c, ok ? src + gc : in, ok);
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
#pragma unroll
    for (int s = 0; s < kStripAhead; ++s) fetch(s);

    // the column convs of the last Y input rows: row s at y[.][s % Y]
    float y[NT > 0 ? NT : 1][Y][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int q = 0; q < Y; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) y[t][q][c] = 0.0f;

    // row pairs by groups of Y rows, so that every register ring index is a
    // constant; a row past n_in (an odd count's last pair) reads a stale
    // slot and feeds no stored output
    for (int s0 = 0; s0 < n_in; s0 += Y) {
#pragma unroll
      for (int u = 0; u < Y; u += 2) {
        const int s = s0 + u;
        if (s >= n_in) break;
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStripAhead - 2));
        __syncwarp();  // rows s, s + 1 landed for every lane
        fetch(s + kStripAhead);
        fetch(s + kStripAhead + 1);

#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the lane's window of row s + h: columns j - 4 .. j + 7
          const S* row = ring[(s + h) & (kStripRing - 1)] + 4 * lane;
          float x[12];
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const float4 f = read_quad(row + 4 * v);
            x[4 * v] = f.x;
            x[4 * v + 1] = f.y;
            x[4 * v + 2] = f.z;
            x[4 * v + 3] = f.w;
          }
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            if (pl.has_col[t]) {
#pragma unroll
              for (int c = 0; c < 4; ++c) y[t][u + h][c] = 0.0f;
#pragma unroll
              for (int q = 0; q < W; ++q) {
                const float w = pl.ct[t][q];
                if (w != 0.0f) {
#pragma unroll
                  for (int c = 0; c < 4; ++c)
                    y[t][u + h][c] =
                        fmaf(w, x[kStripPad - R + q + c], y[t][u + h][c]);
                }
              }
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) y[t][u + h][c] = x[kStripPad + c];
            }
          }
        }
        if (s + 1 < 2 * R) continue;

        // output rows i0 + s + h - 2R, h = 0, 1 (the first pair that reaches
        // here may hold only h = 1): input rows s + h - 2R + q, q < W, at
        // ring index (u + h + 2 + q) % Y
        float acc[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[h][c] = 0.0f;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            if (pl.has_row[t]) {
              float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int q = 0; q < W; ++q) {
                const float w = pl.rt[t][q];
                if (w != 0.0f) {
#pragma unroll
                  for (int c = 0; c < 4; ++c)
                    z[c] = fmaf(w, y[t][(u + h + 2 + q) % Y][c], z[c]);
                }
              }
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[h][c] += z[c];
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)  // identity row axis
                acc[h][c] += y[t][(u + h + 2 + R) % Y][c];
            }
          }
        }
        for (int p = 0; p < pl.n_res; ++p) {
          const int dc = pl.res_dc[p];
          const int r = s - R + pl.res_dr[p];  // the point's row for h = 0
          const float w = pl.res_w[p];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v[4];
            residue_cells(ring[(r + h) & (kStripRing - 1)] + 4 * lane +
                              kStripPad + dc,
                          dc & 3, v);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[h][c] = fmaf(w, v[c], acc[h][c]);
          }
        }

#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = s + h - 2 * R;  // output row of the task
          if (o < 0 || o >= n_out) continue;
          const int i = i0 + o;
          S* dst = out + static_cast<size_t>(g.r0 + i) * g.pitch + g.c0 + j;
          if (!(inside && i < g.m)) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (i >= g.m || j + c >= g.n) acc[h][c] = 0.0f;
          }
          if (vec) {
            if (j < g.nr) store_quad(dst, acc[h]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (j + c < g.nr) dst[c] = to_cell<S>(acc[h][c]);
          }
        }
      }
    }
  }
}

// The lane's 2 cells of a residue point's row, at `xr` (the row's cell of
// the lane's first column, shifted by dc): one 16-byte load of the aligned
// pair, or, at an odd dc, of the two pairs around them.
__device__ __forceinline__ void residue_pair(const double* xr, int odd,
                                             double (&v)[2]) {
  const double2* q = reinterpret_cast<const double2*>(xr - odd);
  const double2 a = q[0];
  if (!odd) {
    v[0] = a.x, v[1] = a.y;
    return;
  }
  const double2 b = q[1];
  v[0] = a.y, v[1] = b.x;
}

// Blocks per SM that the float64 strip kernel's launch bound asks for:
// three at three terms of radius <= 3 (ptxas then keeps the instance within
// 168 registers without a spill, at the row-tap interleave's cost), else
// one, which leaves ptxas the registers the rings need.
__host__ __device__ constexpr int strip64_min_blocks(int R, int NT) {
  return NT == 3 && R <= 3 ? 3 : 1;
}

// Tap q of every term's row conv for output rows s + h - 2R (h = 0, 1):
// z[t][h][c] += w * (column conv of input row s + h - 2R + q), the row at
// ring index (u + h + 2 + q) % Y; a zero tap (and an identity axis, whose
// taps are zero) is skipped.
template <int R, int NT, int Y>
__device__ __forceinline__ void row_taps(
    const StripPlan<double, R>& pl, const double (&y)[NT > 0 ? NT : 1][Y][2],
    int u, int q, double (&z)[NT > 0 ? NT : 1][2][2]) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if ((pl.row_nz[t] >> q) & 1) {
      const double w = pl.rt[t][q];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          z[t][h][c] = mad(w, y[t][(u + h + 2 + q) % Y][c], z[t][h][c]);
    }
}

// One float64 step per cell of rows [i0, i0 + rows) x columns
// [j0, j0 + 64) for each task of a warp; lane l owns columns j0 + 2 l and
// j0 + 2 l + 1.  strip_kernel's walk in double: 16-byte copies into the
// per-warp ring (VEC; 8-byte ones off the 16-byte grid), the column
// convs of each input row once per term in a register ring of Y = 2R + 2
// rows, row pairs.  Each lane reads both rows' windows of a pair (columns
// j - 4 .. j + 5, the pairs the taps reach) before the column convs, so a
// tap's weight and zero test serve 4 cells, as they do in the row conv.
// Tap q of every term's column conv goes beside tap q of the other terms'
// and, where the registers allow it (kInterleave), beside tap q of every
// term's row conv (for q < 2R - 1: those read earlier rows only), so that
// independent sums fill the FP64 pipe's latency.  At three terms and
// R <= 3 the row conv follows the column conv instead, and the launch bound
// asks for three blocks per SM (strip64_min_blocks), which the interleave's
// registers would not leave: on an H100 that took box2d3r's 4096^2 step
// from 0.164 to 0.143 ms, while one term's step (star2d1r) runs 6% faster
// with the interleave.  A zero tap is skipped by a uniform branch on
// the plan's bit masks (an integer test: a double compare would take the
// FP64 pipe; predicated PTX multiplies took 255 registers).  Each product
// and sum is rounded on its own (mad: no FMA), in tile_sums' order, so the
// kernel equals the tile kernel's float64 instance and the twin bit for bit
// on any data.
template <int R, int NT, bool VEC>
__global__ void __launch_bounds__(kStripWarps * 32, strip64_min_blocks(R, NT))
strip64_kernel(const double* __restrict__ in, double* __restrict__ out,
               const __grid_constant__ StripPlan<double, R> pl, Grid2D g,
               int rows) {
  constexpr int W = 2 * R + 1;
  constexpr int Y = W + 1;  // column convs kept: a pair's 2R + 2 rows
  constexpr int X = 2 * kStripPad + 2;        // window cells of a lane
  constexpr int V0 = (kStripPad - R) / 2;      // first pair a tap reads
  constexpr int V1 = (kStripPad + 1 + R) / 2;  // last
  constexpr bool kInterleave = strip64_min_blocks(R, NT) == 1;
  __shared__ __align__(16) double
      ring_all[kStripWarps][kStripRing][kStrip64Window];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  double(*ring)[kStrip64Window] = ring_all[warp];
  const int col_tasks = (g.nr + kStrip64Cols - 1) / kStrip64Cols;
  const int tasks = col_tasks * ((g.mr + rows - 1) / rows);
  for (int task = blockIdx.x * kStripWarps + warp; task < tasks;
       task += gridDim.x * kStripWarps) {
    const int i0 = task / col_tasks * rows;
    const int j0 = task % col_tasks * kStrip64Cols;
    const int n_out = min(rows, g.mr - i0);
    const int n_in = n_out + 2 * R;
    const int gr0 = g.r0 + i0 - R;  // buffer row of input row 0 (>= 0)
    const int gc0 = g.c0 + j0 - kStripPad;  // buffer column of window col 0
    const int j = j0 + 2 * lane;            // the lane's first column
    const bool inside = j + 1 < g.n;        // both columns interior
    __syncwarp();  // the previous task's reads of the ring are done

    // input row s into ring slot s % kStripRing, 0 outside the buffer (the
    // rows of a task lie inside it: bad_args); one commit group per call,
    // empty past the last row.  With VEC the lane copies pairs lane and,
    // for lanes 0-3, lane + 32 of every row, at columns set once a task.
    const int gq0 = gc0 + 2 * lane;
    const int gq1 = gq0 + kStrip64Cols;
    const bool ok0 = gq0 >= 0 && gq0 + 2 <= g.pitch;
    const bool ok1 = lane < kStrip64Window / 2 - 32 && gq1 >= 0 &&
                     gq1 + 2 <= g.pitch;
    auto fetch = [&](int s) {
      if (s < n_in) {
        double* dst = ring[s & (kStripRing - 1)];
        const double* src = in + static_cast<size_t>(gr0 + s) * g.pitch;
        if constexpr (VEC) {
          cp_async16(dst + 2 * lane, ok0 ? src + gq0 : in, ok0);
          if (lane < kStrip64Window / 2 - 32)
            cp_async16(dst + 2 * lane + kStrip64Cols, ok1 ? src + gq1 : in,
                       ok1);
        } else {
          for (int c = lane; c < kStrip64Window; c += 32) {
            const int gc = gc0 + c;
            const bool ok = gc >= 0 && gc < g.pitch;
            cp_async8(dst + c, ok ? src + gc : in, ok);
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
#pragma unroll
    for (int s = 0; s < kStripAhead; ++s) fetch(s);

    // the column convs of the last Y input rows: row s at y[.][s % Y]
    double y[NT > 0 ? NT : 1][Y][2];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int q = 0; q < Y; ++q) y[t][q][0] = y[t][q][1] = 0.0;

    // row pairs by groups of Y rows, so that every register ring index is a
    // constant; a row past n_in (an odd count's last pair) reads a stale
    // slot and feeds no stored output
    for (int s0 = 0; s0 < n_in; s0 += Y) {
#pragma unroll
      for (int u = 0; u < Y; u += 2) {
        const int s = s0 + u;
        if (s >= n_in) break;
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStripAhead - 2));
        __syncwarp();  // rows s, s + 1 landed for every lane
        fetch(s + kStripAhead);
        fetch(s + kStripAhead + 1);

        // output rows i0 + s + h - 2R, h = 0, 1: input rows s + h - 2R + q,
        // q < W, at ring index (u + h + 2 + q) % Y; each term's row conv
        // sums in z[t]
        double z[NT > 0 ? NT : 1][2][2];
        {
          // the lane's windows of rows s, s + 1: columns j - 4 .. j + 5 at
          // x[h][0 .. X), the pairs V0 .. V1 of them that a tap reads
          double x[2][X];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const double2* row = reinterpret_cast<const double2*>(
                ring[(s + h) & (kStripRing - 1)] + 2 * lane);
#pragma unroll
            for (int v = V0; v <= V1; ++v) {
              const double2 f = row[v];
              x[h][2 * v] = f.x;
              x[h][2 * v + 1] = f.y;
            }
          }
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                y[t][u + h][c] = pl.has_col[t] ? 0.0 : x[h][kStripPad + c];
                z[t][h][c] = 0.0;
              }
          // Tap q of every term's column conv of rows s, s + 1, and tap q of
          // its row conv, which for q < 2R - 1 reads rows before s only:
          // the chains are independent, so their taps interleave, and each
          // cell still sums its taps in ascending order.
#pragma unroll
          for (int q = 0; q < W; ++q) {
#pragma unroll
            for (int t = 0; t < NT; ++t)
              if ((pl.col_nz[t] >> q) & 1) {
                const double w = pl.ct[t][q];
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                  for (int c = 0; c < 2; ++c)
                    y[t][u + h][c] =
                        mad(w, x[h][kStripPad - R + q + c], y[t][u + h][c]);
              }
            if (kInterleave && q < 2 * R - 1)
              row_taps<R, NT, Y>(pl, y, u, q, z);
          }
        }
        if (s + 1 < 2 * R) continue;
#pragma unroll
        for (int q = kInterleave ? 2 * R - 1 : 0; q < W; ++q)
          row_taps<R, NT, Y>(pl, y, u, q, z);

        double acc[2][2] = {};
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 2; ++c)  // an identity row axis: the cell
              acc[h][c] = __dadd_rn(
                  acc[h][c],
                  pl.has_row[t] ? z[t][h][c] : y[t][(u + h + 2 + R) % Y][c]);
        for (int p = 0; p < pl.n_res; ++p) {
          const int dc = pl.res_dc[p];
          const int r = s - R + pl.res_dr[p];  // the point's row for h = 0
          const double w = pl.res_w[p];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            double v[2];
            residue_pair(ring[(r + h) & (kStripRing - 1)] + 2 * lane +
                             kStripPad + dc,
                         dc & 1, v);
#pragma unroll
            for (int c = 0; c < 2; ++c) acc[h][c] = mad(w, v[c], acc[h][c]);
          }
        }

#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = s + h - 2 * R;  // output row of the task
          if (o < 0 || o >= n_out) continue;
          const int i = i0 + o;
          double* dst =
              out + static_cast<size_t>(g.r0 + i) * g.pitch + g.c0 + j;
          if (!(inside && i < g.m)) {
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (i >= g.m || j + c >= g.n) acc[h][c] = 0.0;
          }
          if constexpr (VEC) {
            if (j < g.nr)
              *reinterpret_cast<double2*>(dst) =
                  make_double2(acc[h][0], acc[h][1]);
          } else {
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (j + c < g.nr) dst[c] = acc[h][c];
          }
        }
      }
    }
  }
}

// plan_array's table (host memory, the state's dtype) into a strip kernel's
// parameters.
template <int R, typename T>
bool fill_strip_plan(const T* plan, int n_terms, int n_res,
                     StripPlan<T, R>& pl) {
  constexpr int W = 2 * R + 1;
  if (n_terms > kStripMaxTerms || n_res > kStripMaxRes) return false;
  const T* t = plan;
  for (int k = 0; k < n_terms; ++k, t += 2 + 2 * W) {
    pl.has_col[k] = t[0] != T(0);
    pl.has_row[k] = t[1] != T(0);
    pl.col_nz[k] = pl.row_nz[k] = 0;
    for (int q = 0; q < W; ++q) {
      pl.ct[k][q] = t[2 + q];
      pl.rt[k][q] = t[2 + W + q];
      pl.col_nz[k] |= (pl.ct[k][q] != T(0)) << q;
      pl.row_nz[k] |= (pl.rt[k][q] != T(0)) << q;
    }
  }
  pl.n_res = n_res;
  for (int p = 0; p < n_res; ++p) {
    const int dr = static_cast<int>(t[3 * p]);
    const int dc = static_cast<int>(t[3 * p + 1]);
    if (dr < -R || dr > R || dc < -R || dc > R) return false;
    pl.res_dr[p] = dr;
    pl.res_dc[p] = dc;
    pl.res_w[p] = t[3 * p + 2];
  }
  return true;
}

// The tasks of a launch of a strip-walking kernel (`kernel`, whose column
// strips store `out_cols` columns each): every warp the card holds at once
// takes one task of a column strip's rows, so that no wave is left part
// full; the column strips share the warps, each strip's rows split evenly
// among its share.  `resident` caches the blocks the card holds at once,
// per device.  Sets the task's output rows and the blocks to launch.
int size_strips(const void* kernel, int* resident, int out_cols,
                const Grid2D& g, int& rows, int& blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kStripWarps * 32, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  const int col_tasks = (g.nr + out_cols - 1) / out_cols;
  int share = resident[dev] * kStripWarps / col_tasks;
  if (share < 1) share = 1;
  rows = (g.mr + share - 1) / share;
  if (rows < kStripMinRows) rows = kStripMinRows;
  const long tasks =
      static_cast<long>(col_tasks) * ((g.mr + rows - 1) / rows);
  const long want = (tasks + kStripWarps - 1) / kStripWarps;
  blocks = static_cast<int>(want < resident[dev] ? want : resident[dev]);
  return 0;
}

// A launch of the strip kernel of the cell type: strip_kernel (float or
// bfloat16), or strip64_kernel (double) with 16-byte copies (`vec`) or
// 8-byte ones.  The float64 kernel takes VEC as a template parameter: on an
// H100, the walk of an instance that also held the 8-byte copies took 4-8%
// longer.
template <typename S, int R, int NT>
int launch_strip(const S* in, S* out, const StripPlan<Compute<S>, R>& pl,
                 const Grid2D& g, int vec, cudaStream_t stream) {
  constexpr bool kF64 = std::is_same_v<S, double>;
  static int resident[2][kMaxDevices];  // per instance: 8- and 16-byte
  const void* kernel = nullptr;
  if constexpr (kF64)
    kernel = vec ? reinterpret_cast<const void*>(strip64_kernel<R, NT, true>)
                 : reinterpret_cast<const void*>(strip64_kernel<R, NT, false>);
  else
    kernel = reinterpret_cast<const void*>(strip_kernel<S, R, NT>);
  int rows = 0, blocks = 0;
  const int e = size_strips(kernel, resident[kF64 && vec],
                            kF64 ? kStrip64Cols : kStripCols, g, rows, blocks);
  if (e != 0) return e;
  if constexpr (!kF64)
    strip_kernel<S, R, NT><<<blocks, kStripWarps * 32, 0, stream>>>(
        in, out, pl, g, vec, rows);
  else if (vec)
    strip64_kernel<R, NT, true><<<blocks, kStripWarps * 32, 0, stream>>>(
        in, out, pl, g, rows);
  else
    strip64_kernel<R, NT, false><<<blocks, kStripWarps * 32, 0, stream>>>(
        in, out, pl, g, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int R>
int strip_terms(const S* in, S* out, const Compute<S>* plan, int n_terms,
                int n_res, const Grid2D& g, int vec, cudaStream_t stream) {
  StripPlan<Compute<S>, R> pl = {};
  if (!fill_strip_plan<R>(plan, n_terms, n_res, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n_terms) {
    case 0: return launch_strip<S, R, 0>(in, out, pl, g, vec, stream);
    case 1: return launch_strip<S, R, 1>(in, out, pl, g, vec, stream);
    case 2: return launch_strip<S, R, 2>(in, out, pl, g, vec, stream);
    case 3: return launch_strip<S, R, 3>(in, out, pl, g, vec, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Cells of the 16-byte (float, double) or 8-byte (bfloat16) copies of the
// strip kernels: a quad, or a double pair.
template <typename S>
constexpr int strip_vec() {
  return std::is_same_v<S, double> ? 2 : 4;
}

// Whether a strip-walking kernel's rows and rounded interior lie on its
// copies' grid (strip_vec cells), so that it copies and stores them whole.
template <typename S>
int strip_vec_ok(const S* in, const S* out, const Grid2D& g) {
  constexpr int kVec = strip_vec<S>();
  constexpr uintptr_t kBytes = kVec * sizeof(S);
  return reinterpret_cast<uintptr_t>(in) % kBytes == 0 &&
         reinterpret_cast<uintptr_t>(out) % kBytes == 0 &&
         g.pitch % kVec == 0 && g.c0 % kVec == 0 && g.nr % kVec == 0;
}

// A step (k = 1) by the strip kernel of the cell type; `plan` is
// plan_array's table in host memory, in the compute type.  Radii
// 1..kStripMaxRadius with at most kStripMaxTerms terms, as LS_DISPATCH does
// 1-D's narrow radii: the radius picks the instantiation; any other is
// refused.  `vec`: whole copies and stores (strip_vec_ok).
template <typename S>
int launch_strip_step(const S* in, S* out, const Compute<S>* plan,
                      int plan_len, int n_terms, int R, int n_res, Grid2D g,
                      int k, void* stream) {
  using T = Compute<S>;
  if (k != 1 || !plan || bad_args<T>(plan_len, n_terms, R, n_res, g, R))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.mr == 0 || g.nr == 0) return 0;
  const int vec = strip_vec_ok(in, out, g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return strip_terms<S, 1>(in, out, plan, n_terms, n_res, g, vec, s);
    case 2: return strip_terms<S, 2>(in, out, plan, n_terms, n_res, g, vec, s);
    case 3: return strip_terms<S, 3>(in, out, plan, n_terms, n_res, g, vec, s);
    case 4: return strip_terms<S, 4>(in, out, plan, n_terms, n_res, g, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// -- the fused strip kernel: float32 passes of K >= 2 steps ------------------
constexpr int kFusedStripMaxTerms = 2;
// A term's axes, two bits a term in the kernel's KINDS (term t at bits
// 2t, 2t + 1): its column conv and its row conv (plan_array's has_col and
// has_row).  Known at compile time, an identity axis costs no register
// copy and no branch.
constexpr int kHasCol = 1;
constexpr int kHasRow = 2;

__host__ __device__ constexpr bool term_has(int kinds, int t, int axis) {
  return (kinds >> (2 * t)) & axis;
}

// Output columns of a fused strip warp: level L is right on lanes L - 1 ..
// 32 - L, so level K on 32 - 2 (K - 1) lanes of 4 columns.
__host__ __device__ constexpr int fused_strip_cols(int K) {
  return kStripCols - 8 * (K - 1);
}

// The lane's 12-cell windows (columns j - 4 .. j + 7) of a level's row
// pair, whose 4 cells a lane holds in v: its own cells, and R from each
// neighbouring lane.  Lanes 0 and 31 get their own cells for the missing
// neighbour; nothing they compute from them is stored.
template <int R>
__device__ __forceinline__ void lane_windows(const float (&v)[2][4],
                                             float (&x)[2][12]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[h][kStripPad + c] = v[h][c];
      if (c >= kStripPad - R)
        x[h][c] = __shfl_up_sync(0xffffffffu, v[h][c], 1);
      if (c < R)
        x[h][kStripPad + 4 + c] = __shfl_down_sync(0xffffffffu, v[h][c], 1);
    }
}

// a[c] = fmaf(w, xa[c], a[c]) and b[c] = fmaf(w, xb[c], b[c]), c < 4, where
// w != 0, as predicated FMAs: a zero tap leaves the 8 sums as they are, as
// tile_sums' skipped tap does, with no branch.
__device__ __forceinline__ void fma8_nonzero(float w, const float* xa,
                                             const float* xb, float (&a)[4],
                                             float (&b)[4]) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.neu.f32 p, %8, 0f00000000;\n\t"
      "@p fma.rn.f32 %0, %8, %9, %0;\n\t"
      "@p fma.rn.f32 %1, %8, %10, %1;\n\t"
      "@p fma.rn.f32 %2, %8, %11, %2;\n\t"
      "@p fma.rn.f32 %3, %8, %12, %3;\n\t"
      "@p fma.rn.f32 %4, %8, %13, %4;\n\t"
      "@p fma.rn.f32 %5, %8, %14, %5;\n\t"
      "@p fma.rn.f32 %6, %8, %15, %6;\n\t"
      "@p fma.rn.f32 %7, %8, %16, %7;\n\t}"
      : "+f"(a[0]), "+f"(a[1]), "+f"(a[2]), "+f"(a[3]), "+f"(b[0]),
        "+f"(b[1]), "+f"(b[2]), "+f"(b[3])
      : "f"(w), "f"(xa[0]), "f"(xa[1]), "f"(xa[2]), "f"(xa[3]), "f"(xb[0]),
        "f"(xb[1]), "f"(xb[2]), "f"(xb[3]));
}

// Every term's column conv of the lane's 4 cells of a row pair, from their
// windows x, into y0[t] and y1[t]: per cell tile_sums' order (nonzero taps
// ascending, fmaf).
template <int R, int NT, int KINDS>
__device__ __forceinline__ void column_convs(const StripPlan<float, R>& pl,
                                             const float (&x)[2][12],
                                             float (&y0)[NT][4],
                                             float (&y1)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (term_has(KINDS, t, kHasCol)) {
#pragma unroll
      for (int c = 0; c < 4; ++c) y0[t][c] = y1[t][c] = 0.0f;
#pragma unroll
      for (int q = 0; q < 2 * R + 1; ++q)
        fma8_nonzero(pl.ct[t][q], &x[0][kStripPad - R + q],
                     &x[1][kStripPad - R + q], y0[t], y1[t]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y0[t][c] = x[0][kStripPad + c];
        y1[t][c] = x[1][kStripPad + c];
      }
    }
  }
}

// K fused float32 steps per cell of rows [i0, i0 + rows) x columns
// [j0, j0 + fused_strip_cols(K)) for each task of a warp, on a float32 or
// (S = __nv_bfloat16) bfloat16 state: the ring holds the state's cells,
// every level is float32 in registers, and the store rounds once.  Lane l
// holds the four columns jw + 4 l .. + 3 of every level, jw = j0 - 4 (K - 1).
// Level 1 is the strip kernel's step on the input ring; level L >= 2
// takes level L - 1's row from registers, its neighbours' cells by
// shuffles (lane_windows), and keeps its own register ring of column convs,
// lagging level L - 1 by R rows.  Every level row is masked as level() does:
// levels before the last to Grid2D's box, the last to the interior.  No
// residue (the plan's n_res is 0); KINDS
// holds the plan's flags.  `vec` and the launch bound as strip_kernel's.
template <typename S, int R, int NT, int K, int KINDS>
__global__ void __launch_bounds__(kStripWarps * 32, 1)
fused_strip_kernel(const S* __restrict__ in, S* __restrict__ out,
                   const __grid_constant__ StripPlan<float, R> pl, Grid2D g,
                   int vec, int rows) {
  constexpr int W = 2 * R + 1;
  constexpr int Y = W + 1;  // column convs kept per level: 2R + 2 rows
  constexpr int kOut = fused_strip_cols(K);
  __shared__ __align__(16) S ring_all[kStripWarps][kStripRing][kStripRowCells];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  S(*ring)[kStripRowCells] = ring_all[warp];
  const int col_tasks = (g.nr + kOut - 1) / kOut;
  const int tasks = col_tasks * ((g.mr + rows - 1) / rows);
  const bool stores = lane >= K - 1 && lane <= 32 - K;
  for (int task = blockIdx.x * kStripWarps + warp; task < tasks;
       task += gridDim.x * kStripWarps) {
    const int i0 = task / col_tasks * rows;
    const int j0 = task % col_tasks * kOut;
    const int n_out = min(rows, g.mr - i0);
    const int n_in = n_out + 2 * K * R;
    const int gr0 = g.r0 + i0 - K * R;  // buffer row of input row 0 (>= 0)
    const int jw = j0 - 4 * (K - 1);    // interior column of lane 0's first
    const int gc0 = g.c0 + jw - kStripPad;  // buffer column of window col 0
    const int j = jw + 4 * lane;            // the lane's first column
    bool col_in[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) col_in[c] = j + c >= 0 && j + c < g.n;
    // the lane's quad copies of a window row (vec): quads lane and, for
    // lanes 0 and 1, lane + 32, at the same columns in every row
    const int gq0 = gc0 + 4 * lane;
    const int gq1 = gq0 + 128;
    const bool ok0 = gq0 >= 0 && gq0 + 4 <= g.pitch;
    const bool ok1 = lane < kStripWindow / 4 - 32 && gq1 >= 0 &&
                     gq1 + 4 <= g.pitch;
    __syncwarp();  // the previous task's reads of the ring are done

    // input row s into ring slot s % kStripRing, 0 outside the buffer (the
    // rows of a task lie inside it: bad_args); one commit group per call,
    // empty past the last row
    auto fetch = [&](int s) {
      if (s < n_in) {
        S* dst = ring[s & (kStripRing - 1)];
        const int gr = gr0 + s;
        const S* src = in + static_cast<size_t>(gr) * g.pitch;
        if (vec) {
          cp_async_quad(dst + 4 * lane, ok0 ? src + gq0 : in, ok0);
          if (lane < kStripWindow / 4 - 32)
            cp_async_quad(dst + 4 * lane + 128, ok1 ? src + gq1 : in, ok1);
        } else {
          for (int c = lane; c < kStripWindow; c += 32) {
            const int gc = gc0 + c;
            const bool ok = gr < g.rows && gc >= 0 && gc < g.pitch;
            copy_cell(dst + c, ok ? src + gc : in, ok);
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
#pragma unroll
    for (int s = 0; s < kStripAhead; ++s) fetch(s);

    // level L's column convs of level L - 1's last Y rows (level 0: the
    // input): row a at y[L - 1][a % Y]
    float y[K][Y][NT][4];
#pragma unroll
    for (int L = 0; L < K; ++L)
#pragma unroll
      for (int q = 0; q < Y; ++q)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int c = 0; c < 4; ++c) y[L][q][t][c] = 0.0f;

    // input row pairs by groups of Y rows, so that every register ring
    // index is a constant.  At the pair (s, s + 1) level L yields its rows
    // s + h - 2LR (row a of level L is interior row i0 - (K - L) R + a),
    // the column convs of level L - 1's rows s + h - 2(L - 1)R sit at
    // index (u + h + 2(L - 1)) % Y, and the row conv of level L's row
    // s + h - 2LR reads indices (u + h + 2L + q) % Y, q < W.  A row past
    // n_in (an odd count's last pair) reads a stale slot and feeds no
    // stored output.
    for (int s0 = 0; s0 < n_in; s0 += Y) {
#pragma unroll
      for (int u = 0; u < Y; u += 2) {
        const int s = s0 + u;
        if (s >= n_in) break;
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStripAhead - 2));
        __syncwarp();  // rows s, s + 1 landed for every lane
        fetch(s + kStripAhead);
        fetch(s + kStripAhead + 1);

        {
          // the lane's windows of input rows s, s + 1: columns j - 4 .. j + 7
          float x[2][12];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const S* row = ring[(s + h) & (kStripRing - 1)] + 4 * lane;
#pragma unroll
            for (int v = 0; v < 3; ++v) {
              const float4 f = read_quad(row + 4 * v);
              x[h][4 * v] = f.x;
              x[h][4 * v + 1] = f.y;
              x[h][4 * v + 2] = f.z;
              x[h][4 * v + 3] = f.w;
            }
          }
          column_convs<R, NT, KINDS>(pl, x, y[0][u % Y], y[0][(u + 1) % Y]);
        }

        float v[2][4];  // the level's rows of this pair, masked
#pragma unroll
        for (int L = 1; L <= K; ++L) {
          if (L > 1) {  // level L - 1 yielded rows: their column convs
            float x[2][12];
            lane_windows<R>(v, x);
            column_convs<R, NT, KINDS>(pl, x, y[L - 1][(u + 2 * (L - 1)) % Y],
                                       y[L - 1][(u + 1 + 2 * (L - 1)) % Y]);
          }
          if (s < 2 * L * R) break;  // no row of level L yet (s is even)
          float acc[2][4] = {};
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            if (term_has(KINDS, t, kHasRow)) {
              float z[2][4] = {};
#pragma unroll
              for (int q = 0; q < W; ++q)
                fma8_nonzero(pl.rt[t][q], y[L - 1][(u + 2 * L + q) % Y][t],
                             y[L - 1][(u + 1 + 2 * L + q) % Y][t], z[0], z[1]);
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[h][c] += z[h][c];
            } else {
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int c = 0; c < 4; ++c)  // identity row axis
                  acc[h][c] += y[L - 1][(u + h + 2 * L + R) % Y][t][c];
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 - K * R + s + h - L * R;  // interior row
            if (L == K) {
              const bool row_in = i >= 0 && i < g.m;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                v[h][c] = row_in && col_in[c] ? acc[h][c] : 0.0f;
            } else {  // the box: compared here, no flags kept for it
              const bool row_in = i >= g.lr && i < g.hr;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                v[h][c] = row_in && j + c >= g.lc && j + c < g.hc ? acc[h][c]
                                                                 : 0.0f;
            }
          }
        }
        if (s < 2 * K * R || !stores) continue;

#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = s + h - 2 * K * R;  // output row of the task
          if (o >= n_out) continue;
          S* dst = out + static_cast<size_t>(g.r0 + i0 + o) * g.pitch +
                   g.c0 + j;
          if (vec) {
            if (j < g.nr) store_quad(dst, v[h]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (j + c < g.nr) dst[c] = to_cell<S>(v[h][c]);
          }
        }
      }
    }
  }
}

template <typename S, int R, int NT, int K, int KINDS>
int launch_fused_strip(const S* in, S* out, const StripPlan<float, R>& pl,
                       const Grid2D& g, int vec, cudaStream_t stream) {
  static int resident[kMaxDevices];
  int rows = 0, blocks = 0;
  const int e = size_strips(
      reinterpret_cast<const void*>(fused_strip_kernel<S, R, NT, K, KINDS>),
      resident, fused_strip_cols(K), g, rows, blocks);
  if (e != 0) return e;
  fused_strip_kernel<S, R, NT, K, KINDS>
      <<<blocks, kStripWarps * 32, 0, stream>>>(in, out, pl, g, vec, rows);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the plan's term count and kinds (every term has a
// column or a row axis: 3 kinds of one term, 9 of two).
template <typename S, int R>
int fused_strip_terms(const S* in, S* out, const float* plan, int n_terms,
                      const Grid2D& g, int vec, cudaStream_t stream) {
  StripPlan<float, R> pl = {};
  if (!fill_strip_plan<R>(plan, n_terms, 0, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  int kinds = 0;
  for (int t = 0; t < n_terms; ++t) {
    const int kind = (pl.has_col[t] ? kHasCol : 0) |
                     (pl.has_row[t] ? kHasRow : 0);
    if (kind == 0) return static_cast<int>(cudaErrorInvalidValue);
    kinds |= kind << (2 * t);
  }
#define LS_FUSED(NT, KINDS)                                            \
  case (NT) * 16 + (KINDS):                                            \
    return launch_fused_strip<S, R, NT, 2, KINDS>(in, out, pl, g, vec, \
                                                  stream);
  switch (n_terms * 16 + kinds) {
    LS_FUSED(1, 1) LS_FUSED(1, 2) LS_FUSED(1, 3)
    LS_FUSED(2, 5) LS_FUSED(2, 6) LS_FUSED(2, 7)
    LS_FUSED(2, 9) LS_FUSED(2, 10) LS_FUSED(2, 11)
    LS_FUSED(2, 13) LS_FUSED(2, 14) LS_FUSED(2, 15)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LS_FUSED
}

// A float32 or bfloat16 pass of k = 2 fused steps by the fused strip
// kernel; `plan` is plan_array's table in host memory, float32.  Radii
// 1..kStripMaxRadius, 1 or 2 terms, each with a column or a row axis, and no
// residue: the radius, term count and term kinds pick the instantiation;
// any other is refused.
template <typename S>
int launch_fused_strip_pass(const S* in, S* out, const float* plan,
                            int plan_len, int n_terms, int R, int n_res,
                            Grid2D g, int k, void* stream) {
  if (k != 2 || !plan || n_res != 0 || n_terms < 1 ||
      n_terms > kFusedStripMaxTerms ||
      bad_args<float>(plan_len, n_terms, R, n_res, g, k * R))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.mr == 0 || g.nr == 0) return 0;
  const int vec = strip_vec_ok(in, out, g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return fused_strip_terms<S, 1>(in, out, plan, n_terms, g, vec, s);
    case 2: return fused_strip_terms<S, 2>(in, out, plan, n_terms, g, vec, s);
    case 3: return fused_strip_terms<S, 3>(in, out, plan, n_terms, g, vec, s);
    case 4: return fused_strip_terms<S, 4>(in, out, plan, n_terms, g, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// A step (k = 1) by the wide kernel.
template <typename S>
int launch_wide(const S* in, S* out, const Compute<S>* plan, int n_terms,
                int R, int n_res, const Grid2D& g, cudaStream_t stream) {
  using T = Compute<S>;
  constexpr int kTileRows = tile_rows<T>();
  const void* kernel =
      reinterpret_cast<const void*>(wide_step_kernel<S, kTileRows>);
  const size_t smem =
      sizeof(T) * static_cast<size_t>(kTileRows + 2 * R) * kWideCols;
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 grid((g.nr + kWideCols - 1) / kWideCols,
                  (g.mr + kTileRows - 1) / kTileRows);
  wide_step_kernel<S, kTileRows><<<grid, kThreads, smem, stream>>>(
      in, out, plan, n_terms, R, n_res, g);
  return static_cast<int>(cudaGetLastError());
}

// A pass of k steps by the step kernel (k = 1) or the fused kernel; a step
// whose window does not fit a block's shared memory by the wide kernel.
template <typename S>
int launch_step(const S* in, S* out, const Compute<S>* plan, int plan_len,
                int n_terms, int R, int n_res, Grid2D g, int k,
                void* stream) {
  using T = Compute<S>;
  constexpr int kTileRows = tile_rows<T>();
  if (k < 1 || !plan || bad_args<T>(plan_len, n_terms, R, n_res, g, k * R))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.mr == 0 || g.nr == 0) return 0;
  const size_t smem = sizeof(T) * step_cells<T>(k, R, plan_len);
  if (k == 1 && smem > kMaxSmem)
    return launch_wide(in, out, plan, n_terms, R, n_res, g,
                       static_cast<cudaStream_t>(stream));
  // a box that is not the interior (a ghost boundary's ring) takes kBox
  const int form = k == 1 ? 0
                   : (g.lr != 0 || g.hr != g.m || g.lc != 0 || g.hc != g.n)
                       ? 2
                       : 1;
  const void* kernel =
      form == 2   ? reinterpret_cast<const void*>(
                      step_kernel<S, kTileRows, true, true>)
      : form == 1 ? reinterpret_cast<const void*>(
                        step_kernel<S, kTileRows, true, false>)
                  : reinterpret_cast<const void*>(
                        step_kernel<S, kTileRows, false, false>);
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 grid((g.nr + kTileCols - 1) / kTileCols,
                  (g.mr + kTileRows - 1) / kTileRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 2)
    step_kernel<S, kTileRows, true, true><<<grid, kThreads, smem, s>>>(
        in, out, plan, plan_len, n_terms, R, n_res, g, k);
  else if (form == 1)
    step_kernel<S, kTileRows, true, false><<<grid, kThreads, smem, s>>>(
        in, out, plan, plan_len, n_terms, R, n_res, g, k);
  else
    step_kernel<S, kTileRows, false, false><<<grid, kThreads, smem, s>>>(
        in, out, plan, plan_len, n_terms, R, n_res, g, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_skew(const S* in, S* out, const Compute<S>* plan, int plan_len,
                int n_terms, int R, int n_res, Grid2D g, int k,
                void* stream) {
  using T = Compute<S>;
  constexpr int kTileRows = tile_rows<T>();
  if (k < 2 || 2 * R > kTileRows ||
      bad_args<T>(plan_len, n_terms, R, n_res, g, k * R))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.mr == 0 || g.nr == 0) return 0;
  const void* kernel =
      reinterpret_cast<const void*>(skew_kernel<S, kTileRows>);
  const size_t smem = sizeof(T) * skew_cells<T>(k, R, plan_len);
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 grid((g.nr + kTileCols - 1) / kTileCols,
                  (g.mr + kChunkRows - 1) / kChunkRows);
  skew_kernel<S, kTileRows><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      in, out, plan, plan_len, n_terms, R, n_res, g, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_resident(const S* in, S* out0, S* out1, const Compute<S>* plan,
                    int plan_len, int n_terms, int R, int n_res, Grid2D g,
                    int steps, void* stream) {
  using T = Compute<S>;
  constexpr int kTileRows = tile_rows<T>();
  if (steps < 1 || bad_args<T>(plan_len, n_terms, R, n_res, g, R))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.mr == 0 || g.nr == 0) return 0;
  const void* kernel =
      reinterpret_cast<const void*>(resident_kernel<S, kTileRows>);
  const size_t smem = sizeof(T) * step_cells<T>(1, R, plan_len);
  const int se = set_smem(kernel, smem);
  if (se != 0) return se;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int tiles = ((g.nr + kTileCols - 1) / kTileCols) *
                    ((g.mr + kTileRows - 1) / kTileRows);
  const int blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
  void* args[] = {&in, &out0, &out1, &plan, &plan_len, &n_terms,
                  &R,  &n_res, &g,   &steps};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry: the input buffer, output buffer(s), the plan and its counts,
// then the buffer shape (rows, pitch), the origin of interior cell (0, 0),
// the interior (m, n), the rounded interior (mr, nr), the steps of the
// launch, and the stream.
// A pass also takes the box its levels before the last keep (Grid2D's lr,
// hr, lc, hc), after the steps, then its window, rows [wi0, wi1) x columns
// [wj0, wj1) of the rounded interior (in_window); a run keeps the interior.
#define LS_GRID(LR, HR, LC, HC) \
  Grid2D{rows, pitch, r0, c0, m, n, mr, nr, LR, HR, LC, HC}
#define LS_ENTRY(NAME, FN, S)                                               \
  extern "C" int NAME(const S* in, S* out, const Compute<S>* plan,        \
                      int plan_len, int n_terms, int radius, int n_res,   \
                      int rows, int pitch, int r0, int c0, int m, int n,  \
                      int mr, int nr, int k, int lr, int hr, int lc,      \
                      int hc, int wi0, int wi1, int wj0, int wj1,         \
                      void* stream) {                                     \
    return FN(in, out, plan, plan_len, n_terms, radius, n_res,            \
              in_window(LS_GRID(lr, hr, lc, hc), wi0, wi1, wj0, wj1), k,  \
              stream);                                                    \
  }
// csrc/plan2d.cu includes this source for its helpers and LS_ENTRY
// (LS_STENCIL2D_NO_ENTRIES) and defines entries of its own.
#ifndef LS_STENCIL2D_NO_ENTRIES
#ifndef LS_STENCIL2D_BF16
LS_ENTRY(ls_stencil2d_step, launch_step<float>, float)
LS_ENTRY(ls_stencil2d_strip, launch_strip_step<float>, float)
LS_ENTRY(ls_stencil2d_strip_f64, launch_strip_step<double>, double)
LS_ENTRY(ls_stencil2d_fused_strip, launch_fused_strip_pass<float>, float)
LS_ENTRY(ls_stencil2d_step_f64, launch_step<double>, double)
LS_ENTRY(ls_stencil2d_skew, launch_skew<float>, float)
LS_ENTRY(ls_stencil2d_skew_f64, launch_skew<double>, double)
#else
// the bfloat16 state tier (csrc/stencil2d_bf16.cu): the float32 kernels'
// instances on bf16 cells
LS_ENTRY(ls_stencil2d_step_bf16, launch_step<__nv_bfloat16>, __nv_bfloat16)
LS_ENTRY(ls_stencil2d_strip_bf16, launch_strip_step<__nv_bfloat16>,
         __nv_bfloat16)
LS_ENTRY(ls_stencil2d_fused_strip_bf16,
         launch_fused_strip_pass<__nv_bfloat16>, __nv_bfloat16)
LS_ENTRY(ls_stencil2d_skew_bf16, launch_skew<__nv_bfloat16>, __nv_bfloat16)
#endif

#define LS_RESIDENT(NAME, S)                                                \
  extern "C" int NAME(const S* in, S* out0, S* out1,                       \
                      const Compute<S>* plan, int plan_len, int n_terms,   \
                      int radius, int n_res, int rows, int pitch, int r0,  \
                      int c0, int m, int n, int mr, int nr, int steps,     \
                      void* stream) {                                      \
    return launch_resident(in, out0, out1, plan, plan_len, n_terms, radius, \
                           n_res, LS_GRID(0, m, 0, n), steps, stream);     \
  }
#ifndef LS_STENCIL2D_BF16
LS_RESIDENT(ls_stencil2d_resident, float)
LS_RESIDENT(ls_stencil2d_resident_f64, double)
#else
LS_RESIDENT(ls_stencil2d_resident_bf16, __nv_bfloat16)
#endif
#endif  // LS_STENCIL2D_NO_ENTRIES
