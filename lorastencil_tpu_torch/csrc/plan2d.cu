// The plan strip kernel: a 2-D pass of k fused dirichlet0 (or boxed) steps
// of any low-rank plan of radius 1..8 -- up to kPlanMaxTerms terms and up to
// kStripMaxRes residue points -- on the port's internal layout, in float32,
// bfloat16 (built apart as csrc/plan2d_bf16.cu) or float64: k = 1..4 at
// radius 1..4 (float64 1..2), k = 1..2 at radius 5..8 (bfloat16 1..4, which
// rounds once a launch and so cannot split a pass), plan_max_k.
//
// What it replaces.  The TPU kernels lorastencil_tpu/ops/pallas_2d.py::
// _stencil2d_kernel (:127, pallas_2d.stencil2d_step, extent fusion),
// pallas_2d.py::_stencil2d_skew_kernel (:686, stencil2d_skew_step: a skewed
// pass computes the fused pass's values, so it runs the same launches) and,
// on a float64 state, lorastencil_tpu/ops/pallas_df64.py::_df64_kernel
// (:419, df64_step) wherever the strip kernels of csrc/stencil2d.cu do not
// take the launch: a step of more than three terms (the 9x9 of rank 4) or of
// radius 5..8 (an 11x11 box), and a fused pass with residue points, three
// or more terms, a term with neither axis, or a radius past 4 (the 5x5 of 3
// terms and 4 residue points, star2d1r's one term and 8 residue points at k
// = 3 or 4).  It takes the role that csrc/stencil2d.cu's step_kernel (the
// tile kernel at k = 1 and its fused instance at k >= 2) and skew_kernel had
// there; they stay for radius 9 up to the wide radii, plans past this
// kernel's caps or shared memory, and bfloat16 passes deeper than 4.
//
// What bounds it.  A pass reads and writes each cell once (4, 2 or 8 bytes)
// and does ~40-150 multiply-adds a cell per level for these plans, so the
// card's fp32 issue rate and its shared-memory bandwidth bind it before
// device memory does.  step_kernel lost to both: it staged the whole halo'd
// window with plain loads behind a block barrier (no copy in flight while
// it computed), read every tap from a shared table with a compare and a
// branch, wrote each term's column conv to shared memory and read it back
// behind two barriers a term, and walked the fused levels one cell at a
// time, read-modifying-writing a level buffer once per term; its shared
// memory grew with k r, and its occupancy fell with it.
//
// The design carries over the strip kernels' pieces (csrc/stencil2d.cu):
//   * a warp owns a 128-column strip (four adjacent cells a lane) and walks
//     down a task of rows two at a time; every warp the card holds at once
//     takes one task (size_strips' rule), so no wave runs part full;
//   * input rows arrive by 16-byte cp.async copies (8-byte for bfloat16) in
//     a per-warp ring kStripAhead rows ahead of the compute; a warp waits
//     only on its own copies (__syncwarp), never on a block barrier;
//   * the plan comes by value in a __grid_constant__ parameter under a
//     compile-time radius and depth, so each multiply-add takes its weight
//     from the constant bank; a zero tap is a predicated FMA (float32) or a
//     uniform branch (float64);
//   * each input row's column convs are taken once per term and kept for the
//     2R + 2 rows the row convs of a row pair read: in registers where they
//     fit (kPlanRegFloats a thread: up to 3 terms, by depth and radius), else
//     in a per-warp shared ring that each lane reads and writes for its own
//     four cells only (16-byte words, no bank conflict, no barrier);
//   * the residue reads each point's cells from the ring as aligned 16-byte
//     quads (residue_cells), one point's weight and offsets serving both rows
//     of a pair;
//   * fused levels follow the fused strip kernel's scheme: level L lags
//     level L - 1 by R rows.  Each level before the last writes its masked
//     rows into a per-warp ring of its own (plan_level_ring: the 2R + 2 rows
//     its next level's residue reads, a power of two), which the next level
//     reads as it reads the input: its windows, and its residue points.  A
//     lane's windows reach Q = plan_quads(R) quads each side of its four
//     cells (one up to radius 4, two beyond), so level L is right on lanes
//     (L - 1) Q .. 31 - (L - 1) Q, a warp stores 128 - 8 Q (k - 1) columns,
//     and the strips overlap by 8 Q (k - 1) columns;
//   * radius 5..8 widens the window pad to 8 cells (plan_pad) and the input
//     ring to 32 rows (plan_ring: a row pair's 2R + 2 residue rows and the
//     kStripAhead rows in flight), and takes its term count at run time (the
//     shared ring of column convs), which holds the build down.
// The sums are step_kernel's (tile_sums and level()), cell for cell: per
// term the column conv, then the row conv, nonzero taps ascending, each
// multiply-add fused in fp32 and rounded product then sum in fp64; the terms
// added in order; then the residue point by point; each level masked to
// Grid2D's box (levels before the last) or the interior (the last).  So the
// kernel equals step_kernel and the plain twin (ops/stencil2d.py
// stencil2d_step_plain) bit for bit on the integer fill and on dyadic taps,
// and on any data in float64.  A bfloat16 state is widened at its load and
// rounded once, at the pass's store.
//
// Entries (C, ctypes): ls_stencil2d_plan_strip (float), _f64 (double) and
// _bf16 (the bfloat16 build), with csrc/stencil2d.cu's pass signature
// (LS_ENTRY): they launch on the given stream, allocate nothing and return a
// cudaError_t (0 = launched); each refuses what it does not take.

#define LS_STENCIL2D_NO_ENTRIES
#include "stencil2d.cu"

namespace {

constexpr int kPlanMaxRadius = 8;
constexpr int kPlanMaxTerms = 9;   // a plan of rank up to 2R + 1 at R = 4
constexpr int kPlanMaxK = 4;       // fused levels of one launch
constexpr int kPlanMaxWarps = 8;   // warps a block, each on its own tasks
// column-conv values (in units of 4 bytes) a thread keeps in registers:
// k levels x terms x (2R + 2) rows x 4 cells; past this a shared ring
constexpr int kPlanRegFloats = 144;

// The walk's widths at radius R.  A lane's windows reach plan_quads(R)
// quads each side of its four cells (one up to radius 4, two up to 8), so
// the window pad is plan_pad(R) >= R cells and level L is right on lanes
// (L - 1) Q .. 31 - (L - 1) Q: a warp stores plan_cols(R, K) columns.  A
// ring holds a row pair's 2R + 2 residue rows and the kStripAhead rows in
// flight: 16 rows up to radius 4, 32 beyond.  A level's ring holds the
// 2R + 2 rows its next level's residue reads (plan_level_ring, a power of
// two).  At R <= 4 the widths are the strip kernels' kStripPad,
// kStripRowCells, kStripRing and fused_strip_cols(K).
__host__ __device__ constexpr int plan_quads(int R) { return (R + 3) / 4; }
__host__ __device__ constexpr int plan_pad(int R) { return 4 * plan_quads(R); }
__host__ __device__ constexpr int plan_row_cells(int R) {
  return kStripCols + 2 * plan_pad(R) + 4;
}
__host__ __device__ constexpr int plan_ring(int R) {
  return kStripAhead + 2 * R + 2 <= kStripRing ? kStripRing : 2 * kStripRing;
}
__host__ __device__ constexpr int plan_level_ring(int R) {
  int rows = 2;
  while (rows < 2 * R + 2) rows *= 2;
  return rows;
}
__host__ __device__ constexpr int plan_cols(int R, int K) {
  return kStripCols - 8 * plan_quads(R) * (K - 1);
}
static_assert(kStripAhead + 2 * kPlanMaxRadius + 2 <= plan_ring(kPlanMaxRadius),
              "the ring must hold a row pair's residue rows and the rows "
              "ahead");
static_assert(plan_pad(4) == kStripPad && plan_row_cells(4) == kStripRowCells &&
                  plan_ring(4) == kStripRing &&
                  plan_cols(4, 3) == fused_strip_cols(3),
              "radius 1-4 keep the strip kernels' widths");

// The deepest launch of a state type at radius R: 4 levels in float32 and
// bfloat16 (radius 5-8: 2 in float32, whose deeper passes split into
// launches with the same values, 4 in bfloat16, which rounds once a
// launch), 2 in float64.
template <typename S, int R>
__host__ __device__ constexpr int plan_max_k() {
  return std::is_same_v<S, double> ? 2 : (R <= 4 || kBf16<S>) ? kPlanMaxK : 2;
}

// plan_array's table for one R, by value.
template <typename T, int R>
struct PlanStripPlan {
  int n_terms;
  int n_res;
  int has_col[kPlanMaxTerms];
  int has_row[kPlanMaxTerms];
  T ct[kPlanMaxTerms][2 * R + 1];
  T rt[kPlanMaxTerms][2 * R + 1];
  int res_dr[kStripMaxRes];
  int res_dc[kStripMaxRes];
  T res_w[kStripMaxRes];
};
static_assert(sizeof(PlanStripPlan<double, kPlanMaxRadius>) + 128 <= 4096,
              "the plan strip kernel's parameters must fit in 4 KB");

// Whether a pass of K levels and NT terms keeps its column convs in
// registers (the instances with NT > 0; radius 1-4 only: the wider radii
// take their term count at run time, which holds their build down).
template <typename T, int R, int K, int NT>
__host__ __device__ constexpr bool plan_in_registers() {
  return R <= 4 && K >= 2 && NT >= 1 && NT <= 3 &&
         K * NT * (2 * R + 2) * 4 * static_cast<int>(sizeof(T)) / 4 <=
             kPlanRegFloats;
}

// Four cells of a row of shared memory (the input ring's cells widened,
// or a level ring's), at p.
__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&x)[4]) {
  const float4 f = read_quad(p);
  x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&x)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&x)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(x[2], x[3]);
}
// Four float64 sums into device memory (float32 and bfloat16: store_quad).
__device__ __forceinline__ void store_quad(double* dst, const double (&v)[4]) {
  st4(dst, v);
}
// A quad of float64 cells into shared memory: two 16-byte copies.
__device__ __forceinline__ void cp_async_quad(double* dst, const double* src,
                                              bool ok) {
  cp_async16(dst, src, ok);
  cp_async16(dst + 2, ok ? src + 2 : src, ok);
}
__device__ __forceinline__ void copy_cell(double* dst, const double* src,
                                          bool ok) {
  cp_async8(dst, src, ok);
}
// The lane's 4 cells of a residue point's row, at `xr` (shifted by dc) in a
// row of shared memory; cls = dc & 3 (residue_cells for float and bfloat16;
// here double, by aligned 16-byte pairs).
__device__ __forceinline__ void residue4(const float* xr, int cls,
                                         float (&v)[4]) {
  residue_cells(xr, cls, v);
}
__device__ __forceinline__ void residue4(const __nv_bfloat16* xr, int cls,
                                         float (&v)[4]) {
  residue_cells(xr, cls, v);
}
__device__ __forceinline__ void residue4(const double* xr, int cls,
                                         double (&v)[4]) {
  const int odd = cls & 1;
  const double2* q = reinterpret_cast<const double2*>(xr - odd);
  const double2 a = q[0], b = q[1];
  if (!odd) {
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    return;
  }
  const double2 c = q[2];
  v[0] = a.y, v[1] = b.x, v[2] = b.y, v[3] = c.x;
}

// a[c] = mad(w, xa[c], a[c]), b[c] = mad(w, xb[c], b[c]) where w != 0 (a
// zero tap is skipped, as tile_sums skips it): predicated FMAs in float32,
// a uniform branch in float64 (rounded product, then sum).
__device__ __forceinline__ void mad8(float w, const float* xa, const float* xb,
                                     float (&a)[4], float (&b)[4]) {
  fma8_nonzero(w, xa, xb, a, b);
}
__device__ __forceinline__ void mad8(double w, const double* xa,
                                     const double* xb, double (&a)[4],
                                     double (&b)[4]) {
  if (w != 0.0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      a[c] = mad(w, xa[c], a[c]);
      b[c] = mad(w, xb[c], b[c]);
    }
  }
}
// a[c] = mad(w, x[c], a[c]) where w != 0.
__device__ __forceinline__ void mad4(float w, const float* x, float (&a)[4]) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.neu.f32 p, %4, 0f00000000;\n\t"
      "@p fma.rn.f32 %0, %4, %5, %0;\n\t"
      "@p fma.rn.f32 %1, %4, %6, %1;\n\t"
      "@p fma.rn.f32 %2, %4, %7, %2;\n\t"
      "@p fma.rn.f32 %3, %4, %8, %3;\n\t}"
      : "+f"(a[0]), "+f"(a[1]), "+f"(a[2]), "+f"(a[3])
      : "f"(w), "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]));
}
__device__ __forceinline__ void mad4(double w, const double* x,
                                     double (&a)[4]) {
  if (w != 0.0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = mad(w, x[c], a[c]);
  }
}

// The column convs a level keeps: for level L (0-based: the convs of level
// L's rows, which level L + 1 reads), term t and ring slot q, the lane's 4
// cells.  NT > 0: registers (every index a constant once the loops
// unroll); NT = 0: the warp's shared ring, [L][t][q][lane] words of 4 cells,
// each lane touching its own words only.
template <typename T, int K, int NT, int Y>
struct ConvRing {
  T reg[NT > 0 ? K : 1][NT > 0 ? Y : 1][NT > 0 ? NT : 1][4];
  T* sh;
  int nt;
  int lane;
  __device__ __forceinline__ T* word(int L, int t, int q) {
    return sh + ((static_cast<size_t>(L * nt + t) * Y + q) * 32 + lane) * 4;
  }
  __device__ __forceinline__ void put(int L, int t, int q, const T (&v)[4]) {
    if constexpr (NT > 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) reg[L][q][t][c] = v[c];
    } else {
      st4(word(L, t, q), v);
    }
  }
  __device__ __forceinline__ void get(int L, int t, int q, T (&v)[4]) {
    if constexpr (NT > 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = reg[L][q][t][c];
    } else {
      ld4(word(L, t, q), v);
    }
  }
};

// Bytes of a warp's shared memory: the input ring (cells of S), the rings
// of the K - 1 levels before the last (cells of T), and with NT = 0 the
// column convs of `nt` terms.
template <typename S, int R, int K, int NT>
__host__ __device__ constexpr size_t plan_warp_bytes(int nt) {
  using T = Compute<S>;
  constexpr size_t kRow = plan_row_cells(R);
  return plan_ring(R) * kRow * sizeof(S) +
         static_cast<size_t>(K - 1) * plan_level_ring(R) * kRow * sizeof(T) +
         (NT > 0 ? 0
                 : static_cast<size_t>(K) * nt * (2 * R + 2) * 32 * 4 *
                       sizeof(T));
}

// K fused steps (K = 1: one step) per cell of rows [i0, i0 + rows) x columns
// [j0, j0 + plan_cols(R, K)) for each task of a warp.  Lane l holds the four
// columns jw + 4 l .. + 3 of every level, jw = j0 - 4 Q (K - 1), Q =
// plan_quads(R).  Input row s (interior row i0 - K R + s) lands in ring slot
// s % plan_ring(R); level
// L's row a (interior row i0 - (K - L) R + a) is yielded at the input pair
// holding row a + 2 L R, from the column convs of level L - 1's rows
// a .. a + 2R (conv ring slot (row) % Y) and, for its residue, the rows of
// level L - 1's ring.  `vec`: the strip kernels' (whole quad copies and
// stores).
template <typename S, int R, int K, int NT>
__global__ void __launch_bounds__(kPlanMaxWarps * 32, 1)
plan_strip_kernel(const S* __restrict__ in, S* __restrict__ out,
                  const __grid_constant__ PlanStripPlan<Compute<S>, R> pl,
                  Grid2D g, int vec, int rows) {
  using T = Compute<S>;
  constexpr int W = 2 * R + 1;
  constexpr int Y = W + 1;  // conv rows kept per level: a pair's 2R + 2
  constexpr int kQ = plan_quads(R);
  constexpr int kPad = plan_pad(R);          // window cells each side
  constexpr int kRow = plan_row_cells(R);    // cells a ring row
  constexpr int kRing = plan_ring(R);        // rows the input ring
  constexpr int kLevelRing = plan_level_ring(R);  // rows a level's ring
  constexpr int kWin = kStripCols + 2 * kPad;  // window cells a row
  constexpr int X = 4 + 2 * kPad;            // a lane's window cells
  constexpr int kOut = plan_cols(R, K);
  constexpr int kTU = NT > 0 ? NT : 1;  // the term loops' unrolling
  extern __shared__ __align__(16) unsigned char plan_smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nt = NT > 0 ? NT : pl.n_terms;
  unsigned char* const mine =
      plan_smem + warp * plan_warp_bytes<S, R, K, NT>(nt);
  S(*const ring)[kRow] = reinterpret_cast<S(*)[kRow]>(mine);
  // level L's ring (L = 1 .. K - 1), rows of kRow cells
  T* const lv0 = reinterpret_cast<T*>(
      mine + static_cast<size_t>(kRing) * kRow * sizeof(S));
  auto lvrow = [&](int L, int a) -> T* {
    return lv0 + (static_cast<size_t>(L - 1) * kLevelRing +
                  (a & (kLevelRing - 1))) * kRow;
  };
  ConvRing<T, K, NT, Y> yr;
  yr.sh = lv0 + static_cast<size_t>(K - 1) * kLevelRing * kRow;
  yr.nt = nt;
  yr.lane = lane;
  // the level rings' pads (columns no lane writes) read as zeros
  for (int q = lane; q < (K - 1) * kLevelRing * kRow; q += 32)
    lv0[q] = T(0);

  const int col_tasks = (g.nr + kOut - 1) / kOut;
  const int tasks = col_tasks * ((g.mr + rows - 1) / rows);
  const bool stores = lane >= kQ * (K - 1) && lane <= 31 - kQ * (K - 1);
  for (int task = blockIdx.x * warps + warp; task < tasks;
       task += gridDim.x * warps) {
    const int i0 = task / col_tasks * rows;
    const int j0 = task % col_tasks * kOut;
    const int n_out = min(rows, g.mr - i0);
    const int n_in = n_out + 2 * K * R;
    const int gr0 = g.r0 + i0 - K * R;  // buffer row of input row 0 (>= 0)
    const int jw = j0 - 4 * kQ * (K - 1);  // interior column of lane 0's first
    const int gc0 = g.c0 + jw - kPad;      // buffer column of window col 0
    const int j = jw + 4 * lane;            // the lane's first column
    bool col_in[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) col_in[c] = j + c >= 0 && j + c < g.n;
    // the lane's quad copies of a window row (vec): quads lane and, for
    // lanes below 2 Q, lane + 32, at the same columns in every row
    const int gq0 = gc0 + 4 * lane;
    const int gq1 = gq0 + 128;
    const bool ok0 = gq0 >= 0 && gq0 + 4 <= g.pitch;
    const bool ok1 = lane < kWin / 4 - 32 && gq1 >= 0 &&
                     gq1 + 4 <= g.pitch;
    __syncwarp();  // the previous task's reads of the rings are done

    // input row s into ring slot s % kRing, 0 outside the buffer; one
    // commit group per call, empty past the last row
    auto fetch = [&](int s) {
      if (s < n_in) {
        S* dst = ring[s & (kRing - 1)];
        const int gr = gr0 + s;
        const S* src = in + static_cast<size_t>(gr) * g.pitch;
        if (vec) {
          cp_async_quad(dst + 4 * lane, ok0 ? src + gq0 : in, ok0);
          if (lane < kWin / 4 - 32)
            cp_async_quad(dst + 4 * lane + 128, ok1 ? src + gq1 : in, ok1);
        } else {
          for (int c = lane; c < kWin; c += 32) {
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
    if constexpr (NT > 0) {
#pragma unroll
      for (int L = 0; L < K; ++L)
#pragma unroll
        for (int q = 0; q < Y; ++q)
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int c = 0; c < 4; ++c) yr.reg[L][q][t][c] = T(0);
    }

    // Every term's column convs of a level's row pair, from the lane's
    // windows x (columns j - kPad .. j + 3 + kPad), into conv ring L's
    // slots q0, q1.
    auto column_convs = [&](int L, const T (&x)[2][X], int q0, int q1) {
#pragma unroll (kTU)
      for (int t = 0; t < nt; ++t) {
        T y0[4], y1[4];
        if (pl.has_col[t]) {
#pragma unroll
          for (int c = 0; c < 4; ++c) y0[c] = y1[c] = T(0);
#pragma unroll
          for (int q = 0; q < W; ++q)
            mad8(pl.ct[t][q], &x[0][kPad - R + q], &x[1][kPad - R + q], y0,
                 y1);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            y0[c] = x[0][kPad + c];
            y1[c] = x[1][kPad + c];
          }
        }
        yr.put(L, t, q0, y0);
        yr.put(L, t, q1, y1);
      }
    };

    // input row pairs by groups of Y rows, so that every ring index is a
    // constant.  At the pair (s, s + 1) level L yields its rows s + h -
    // 2LR, whose row convs read conv ring L - 1's slots (u + h + 2L + q) %
    // Y, q < W.  A row past n_in (an odd count's last pair) reads a stale
    // slot and feeds no stored output.
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
          T x[2][X];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int v = 0; v < X / 4; ++v) {
              T f[4];
              ld4(ring[(s + h) & (kRing - 1)] + 4 * lane + 4 * v, f);
#pragma unroll
              for (int c = 0; c < 4; ++c) x[h][4 * v + c] = f[c];
            }
          column_convs(0, x, u % Y, (u + 1) % Y);
        }

        T v[2][4];  // the level's rows of this pair, masked
#pragma unroll
        for (int L = 1; L <= K; ++L) {
          if (L > 1) {  // level L - 1 yielded rows b, b + 1: their convs
            const int b = s - 2 * (L - 1) * R;
            T x[2][X];
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int q = 0; q < X / 4; ++q) {
                T f[4];
                ld4(lvrow(L - 1, b + h) + 4 * lane + 4 * q, f);
#pragma unroll
                for (int c = 0; c < 4; ++c) x[h][4 * q + c] = f[c];
              }
            column_convs(L - 1, x, (u + 2 * (L - 1)) % Y,
                         (u + 1 + 2 * (L - 1)) % Y);
          }
          if (s < 2 * L * R) break;  // no row of level L yet (s is even)
          T acc[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[h][c] = T(0);
#pragma unroll (kTU)
          for (int t = 0; t < nt; ++t) {
            if (pl.has_row[t]) {
              T z0[4], z1[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) z0[c] = z1[c] = T(0);
              // slot k serves tap k of the pair's first row and tap k - 1
              // of its second: each row's taps stay ascending
#pragma unroll
              for (int k = 0; k <= W; ++k) {
                T ys[4];
                yr.get(L - 1, t, (u + 2 * L + k) % Y, ys);
                if (k < W) mad4(pl.rt[t][k], ys, z0);
                if (k > 0) mad4(pl.rt[t][k - 1], ys, z1);
              }
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc[0][c] += z0[c];
                acc[1][c] += z1[c];
              }
            } else {  // identity row axis: the conv of the row itself
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                T ys[4];
                yr.get(L - 1, t, (u + h + 2 * L + R) % Y, ys);
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[h][c] += ys[c];
              }
            }
          }
          // the residue, from level L - 1's rows (the input's at L = 1)
          for (int p = 0; p < pl.n_res; ++p) {
            const int dc = pl.res_dc[p];
            const int rb = s - 2 * L * R + R + pl.res_dr[p];  // row, h = 0
            const T w = pl.res_w[p];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              T vv[4];
              if (L == 1)
                residue4(ring[(rb + h) & (kRing - 1)] + 4 * lane + kPad + dc,
                         dc & 3, vv);
              else
                residue4(lvrow(L - 1, rb + h) + 4 * lane + kPad + dc,
                         dc & 3, vv);
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[h][c] = mad(w, vv[c], acc[h][c]);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 - K * R + s + h - L * R;  // interior row
            if (L == K) {
              const bool row_in = i >= 0 && i < g.m;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                v[h][c] = row_in && col_in[c] ? acc[h][c] : T(0);
            } else {  // the box
              const bool row_in = i >= g.lr && i < g.hr;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                v[h][c] = row_in && j + c >= g.lc && j + c < g.hc ? acc[h][c]
                                                                 : T(0);
            }
          }
          if (L < K) {  // into level L's ring, for level L + 1
            const int a = s - 2 * L * R;
            st4(lvrow(L, a) + kPad + 4 * lane, v[0]);
            st4(lvrow(L, a + 1) + kPad + 4 * lane, v[1]);
            __syncwarp();
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

// plan_array's table (host memory, the compute type) into the kernel's
// parameters.
template <int R, typename T>
bool fill_plan_strip(const T* plan, int n_terms, int n_res,
                     PlanStripPlan<T, R>& pl) {
  constexpr int W = 2 * R + 1;
  if (n_terms < 0 || n_terms > kPlanMaxTerms || n_res < 0 ||
      n_res > kStripMaxRes)
    return false;
  pl.n_terms = n_terms;
  pl.n_res = n_res;
  const T* t = plan;
  for (int k = 0; k < n_terms; ++k, t += 2 + 2 * W) {
    pl.has_col[k] = t[0] != T(0);
    pl.has_row[k] = t[1] != T(0);
    for (int q = 0; q < W; ++q) {
      pl.ct[k][q] = t[2 + q];
      pl.rt[k][q] = t[2 + W + q];
    }
  }
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

// The warps a block holds (as many as fit kMaxSmem, up to kPlanMaxWarps),
// its shared memory, and, as size_strips does, the task rows and blocks of
// one wave.
template <typename S, int R, int K, int NT>
int launch_plan(const S* in, S* out, const PlanStripPlan<Compute<S>, R>& pl,
                const Grid2D& g, int vec, cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(plan_strip_kernel<S, R, K, NT>);
  const size_t per_warp = plan_warp_bytes<S, R, K, NT>(pl.n_terms);
  int warps = static_cast<int>(kMaxSmem / per_warp);
  if (warps > kPlanMaxWarps) warps = kPlanMaxWarps;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = per_warp * warps;
  int e = set_smem(kernel, smem);
  if (e != 0) return e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce == cudaSuccess)
    ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       warps * 32, smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int resident = per_sm * sms;
  const int col_tasks = (g.nr + plan_cols(R, K) - 1) / plan_cols(R, K);
  int share = resident * warps / col_tasks;
  if (share < 1) share = 1;
  int rows = (g.mr + share - 1) / share;
  if (rows < kStripMinRows) rows = kStripMinRows;
  const long tasks = static_cast<long>(col_tasks) * ((g.mr + rows - 1) / rows);
  const long want = (tasks + warps - 1) / warps;
  const int blocks = static_cast<int>(want < resident ? want : resident);
  plan_strip_kernel<S, R, K, NT><<<blocks, warps * 32, smem, stream>>>(
      in, out, pl, g, vec, rows);
  return static_cast<int>(cudaGetLastError());
}

// Calls f(K, NT) (std::integral_constant values) with the instance that a
// launch of k fused steps of a plan of nt terms runs, and returns its result:
// k up to plan_max_k, the column convs in registers where plan_in_registers
// (NT = nt), else the shared ring (NT = 0); -1 past the kernel's depths.
// Both the launch (plan_depth) and the sizing entry go through it.
template <typename S, int R, int K, typename F>
int plan_terms(int nt, F&& f) {
  using T = Compute<S>;
  using Depth = std::integral_constant<int, K>;
  switch (nt) {
    case 1:
      if constexpr (plan_in_registers<T, R, K, 1>())
        return f(Depth{}, std::integral_constant<int, 1>{});
      break;
    case 2:
      if constexpr (plan_in_registers<T, R, K, 2>())
        return f(Depth{}, std::integral_constant<int, 2>{});
      break;
    case 3:
      if constexpr (plan_in_registers<T, R, K, 3>())
        return f(Depth{}, std::integral_constant<int, 3>{});
      break;
    default:
      break;
  }
  return f(Depth{}, std::integral_constant<int, 0>{});
}

template <typename S, int R, typename F>
int plan_instance(int k, int nt, F&& f) {
  switch (k) {
    case 1: return plan_terms<S, R, 1>(nt, f);
    case 2: return plan_terms<S, R, 2>(nt, f);
    case 3:
      if constexpr (plan_max_k<S, R>() >= 3) return plan_terms<S, R, 3>(nt, f);
      break;
    case 4:
      if constexpr (plan_max_k<S, R>() >= 4) return plan_terms<S, R, 4>(nt, f);
      break;
  }
  return -1;
}

template <typename S, int R>
int plan_depth(const S* in, S* out, const Compute<S>* plan, int n_terms,
               int n_res, const Grid2D& g, int k, int vec,
               cudaStream_t stream) {
  PlanStripPlan<Compute<S>, R> pl = {};
  if (k > plan_max_k<S, R>() || !fill_plan_strip<R>(plan, n_terms, n_res, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = plan_instance<S, R>(k, pl.n_terms, [&](auto K, auto NT) {
    return launch_plan<S, R, decltype(K)::value, decltype(NT)::value>(
        in, out, pl, g, vec, stream);
  });
  return e < 0 ? static_cast<int>(cudaErrorInvalidValue) : e;
}

// A warp's shared memory (launch_plan's per_warp) of the instance that a
// launch of k steps of n_terms terms at radius R runs; -1 where the kernel
// refuses the radius, the depth or the term count.
template <typename S, int R>
int warp_bytes_at(int n_terms, int k) {
  return plan_instance<S, R>(k, n_terms, [&](auto K, auto NT) {
    return static_cast<int>(
        plan_warp_bytes<S, R, decltype(K)::value, decltype(NT)::value>(
            n_terms));
  });
}

template <typename S>
int plan_strip_warp_bytes(int n_terms, int R, int k) {
  if (n_terms < 1 || n_terms > kPlanMaxTerms) return -1;
  switch (R) {
    case 1: return warp_bytes_at<S, 1>(n_terms, k);
    case 2: return warp_bytes_at<S, 2>(n_terms, k);
    case 3: return warp_bytes_at<S, 3>(n_terms, k);
    case 4: return warp_bytes_at<S, 4>(n_terms, k);
    case 5: return warp_bytes_at<S, 5>(n_terms, k);
    case 6: return warp_bytes_at<S, 6>(n_terms, k);
    case 7: return warp_bytes_at<S, 7>(n_terms, k);
    case 8: return warp_bytes_at<S, 8>(n_terms, k);
    default: return -1;
  }
}

// A pass of k steps by the plan strip kernel, k up to plan_max_k (radius
// 1-4: 4, float64 2; radius 5-8: 2, bfloat16 4); `plan` is plan_array's
// table in host memory, in the compute type.  Radii 1..kPlanMaxRadius, up
// to kPlanMaxTerms terms, any residue within the radius (at most
// kStripMaxRes points), and a warp's shared memory within a block's; any
// other is refused.  `vec`: every row of `in` and `out` starts its window
// on a quad of cells and nr % 4 == 0.
template <typename S>
int launch_plan_strip(const S* in, S* out, const Compute<S>* plan,
                      int plan_len, int n_terms, int R, int n_res, Grid2D g,
                      int k, void* stream) {
  using T = Compute<S>;
  if (k < 1 || k > kPlanMaxK || !plan || n_terms > kPlanMaxTerms ||
      bad_args<T>(plan_len, n_terms, R, n_res, g, k * R))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.mr == 0 || g.nr == 0) return 0;
  constexpr uintptr_t kQuad = 4 * sizeof(S) < 16 ? 4 * sizeof(S) : 16;
  const int vec = reinterpret_cast<uintptr_t>(in) % kQuad == 0 &&
                  reinterpret_cast<uintptr_t>(out) % kQuad == 0 &&
                  g.pitch % 4 == 0 && g.c0 % 4 == 0 && g.nr % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return plan_depth<S, 1>(in, out, plan, n_terms, n_res, g, k, vec, s);
    case 2: return plan_depth<S, 2>(in, out, plan, n_terms, n_res, g, k, vec, s);
    case 3: return plan_depth<S, 3>(in, out, plan, n_terms, n_res, g, k, vec, s);
    case 4: return plan_depth<S, 4>(in, out, plan, n_terms, n_res, g, k, vec, s);
    case 5: return plan_depth<S, 5>(in, out, plan, n_terms, n_res, g, k, vec, s);
    case 6: return plan_depth<S, 6>(in, out, plan, n_terms, n_res, g, k, vec, s);
    case 7: return plan_depth<S, 7>(in, out, plan, n_terms, n_res, g, k, vec, s);
    case 8: return plan_depth<S, 8>(in, out, plan, n_terms, n_res, g, k, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The entries, with csrc/stencil2d.cu's pass signature (LS_ENTRY): the
// buffers, the plan (host memory) and its counts, the buffer shape, the
// origin, the interior and rounded interior, k, the box of the levels before
// the last, the window, and the stream.
// ls_stencil2d_plan_strip_warp_bytes* (n_terms, R, k): plan_strip_warp_bytes,
// which ops/stencil2d.py plan_warp_bytes mirrors (the card tests hold the
// two together).
#ifndef LS_PLAN2D_BF16
LS_ENTRY(ls_stencil2d_plan_strip, launch_plan_strip<float>, float)
LS_ENTRY(ls_stencil2d_plan_strip_f64, launch_plan_strip<double>, double)
extern "C" int ls_stencil2d_plan_strip_warp_bytes(int n_terms, int R, int k) {
  return plan_strip_warp_bytes<float>(n_terms, R, k);
}
extern "C" int ls_stencil2d_plan_strip_warp_bytes_f64(int n_terms, int R,
                                                      int k) {
  return plan_strip_warp_bytes<double>(n_terms, R, k);
}
#else
LS_ENTRY(ls_stencil2d_plan_strip_bf16, launch_plan_strip<__nv_bfloat16>,
         __nv_bfloat16)
extern "C" int ls_stencil2d_plan_strip_warp_bytes_bf16(int n_terms, int R,
                                                       int k) {
  return plan_strip_warp_bytes<__nv_bfloat16>(n_terms, R, k);
}
#endif
