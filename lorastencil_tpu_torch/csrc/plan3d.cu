// The plan march kernel: a 3-D pass of K = 1 or 2 fused dirichlet0 (or
// boxed) steps of any plan of radius 1..4 -- any term mix (centre,
// buffered and identity-z terms, up to kGenMaxTerms) and any residue (up to
// kGenMaxRes points) -- on the port's internal layout, in float32, bfloat16
// (built apart as csrc/plan3d_bf16.cu) or float64.
//
// What it replaces.  The TPU kernel lorastencil_tpu/ops/pallas_3d.py::
// _stencil3d_kernel (:118, pallas_3d.stencil3d_step) and, on a float64
// state, lorastencil_tpu/ops/pallas_df64_3d.py::_df64_3d_kernel (:79,
// df64_3d_step) wherever the march kernel (csrc/stencil3d.cu) does not take
// the pass: every radius 2-4, residue points, and term mixes other than
// star3d1r's and box3d1r's (the per-plane decomposition of a dense 3x3x3:
// six buffered terms and three residue points; the 25-point star of radius
// 4: two buffered terms and eight residue points along z).  It takes the
// role csrc/stencil3d.cu's stencil3d_kernel had there; stencil3d_kernel stays
// for K >= 3, radius 5-8 and radius 0.
//
// What bounds it.  A pass reads and writes each cell once, and does ~50-300
// multiply-adds a cell for these plans, so the card's fp32 issue rate and
// its shared-memory bandwidth bind it, not device memory (0.0401 ms at 256^3
// in float32).  stencil3d_kernel lost ten to a hundred times that: every
// intermediate in shared-memory rings (a level's planes, each buffered
// term's convs), a block barrier between its phases, its plan read from
// shared memory at run time, and one 4- or 8-byte cp.async a cell.
//
// The design takes the march kernel's pieces:
//   * compile-time R and K (the plan's term classes and axes are uniform
//     branches on a plan by value in a __grid_constant__ parameter, its taps
//     weights from the constant bank; a zero tap a predicated FMA in fp32,
//     mad_quad);
//   * a thread owns 2 rows x one 16-byte quad of cells (4 float32, 2 float64)
//     of a (TM x 16-quad) tile for the whole z-march of a task, its sums in
//     registers; the thread groups cover level 1's extent (the tile plus (K -
//     1) R rows and whole quads each side) and every level runs on that grid;
//   * input planes arrive by 16-byte cp.async copies (bfloat16: 8-byte loads
//     widened) kPlanAhead planes ahead of the compute; a block keeps the
//     last 2R + 1 planes of each level it reads (the input's, and at K = 2
//     level 1's) in shared memory, so a plane costs one barrier at K = 1 and
//     two at K = 2;
//   * a level's plane v is summed once, when plane v + R of the level before
//     it lands: the centre terms' convs of plane v, each buffered term's
//     convs of the planes its nonzero z taps reach, each identity term's
//     cells of those planes, then the residue -- every read from the shared
//     planes with 16-byte loads (a residue point off the quad grid reads the
//     two aligned quads around its cells), no intermediate ring, no conv
//     buffer.  A buffered term whose z taps are dense recomputes its conv of
//     a plane once per plane it reaches (the march kernel, which keeps such
//     convs in registers, takes box3d1r's); a per-plane decomposition's
//     one-hot z taps compute each conv once.
// The tile's rows shrink where 2 (2R + 1) + kPlanAhead planes of level 1's
// extent would not fit a block's shared memory (plan_tile_rows).
// The sums are the plain twin's (ops/band_gemm.py apply_spec_3d) and
// stencil3d_kernel's, cell for cell: centre terms in order, each buffered
// term's z taps ascending, each identity term's, then the residue point by
// point; per conv the column conv of each row, then the row conv, nonzero
// taps ascending; fp32 fuses each multiply-add (fmaf), fp64 rounds the
// product and the sum (no FMA).  So float64 agrees bit for bit on any data,
// float32 on integer and dyadic data, and a bfloat16 pass rounds once, at
// its store.
//
// Entries (C, ctypes): ls_stencil3d_plan_march (float), _f64 (double) and
// _bf16 (the bfloat16 build), with the march kernel's signature (LS_MARCH):
// they launch on the given stream, allocate nothing and return a cudaError_t
// (0 = launched); each refuses what it does not take.

#define LS_STENCIL3D_NO_ENTRIES
#include "stencil3d.cu"

namespace {

constexpr int kGenMaxRadius = 4;
constexpr int kGenMaxTerms = 12;
constexpr int kGenMaxRes = 48;
constexpr int kPlanAhead = 2;    // input planes in flight
constexpr int kPlanQuads = 16;   // output quads of a task row
constexpr int kPlanRows = 2;     // rows of a thread's cell group

// plan_array's 3-D table for one R, by value.
template <typename T, int R>
struct GenPlan {
  int n_terms;
  int n_res;
  int cls[kGenMaxTerms];   // band_gemm.term_class
  int axes[kGenMaxTerms];  // kHasCol | kHasRow
  // a buffered term's one nonzero z tap (its index; -1 where it has more),
  // and whether the next term is buffered with the same one: the two convs
  // of one plane then share its window's loads
  int zone[kGenMaxTerms];
  int pair[kGenMaxTerms];
  T zt[kGenMaxTerms][2 * R + 1];
  T ct[kGenMaxTerms][2 * R + 1];
  T rt[kGenMaxTerms][2 * R + 1];
  int res_dz[kGenMaxRes];
  int res_dr[kGenMaxRes];
  int res_dc[kGenMaxRes];
  T res_w[kGenMaxRes];
};
static_assert(sizeof(GenPlan<double, kGenMaxRadius>) + sizeof(Pass) + 16 <=
                  4096,
              "the plan march kernel's parameters must fit in 4 KB");

// The cell grid and shared planes of an instance: cells of T, radius R, K
// levels, TM output rows a task.  A thread owns CH rows x one quad of V
// cells; the groups cover the tile plus ER rows and EQ quads each side
// (level 1's extent at K = 2).  A shared plane holds that grid with R rows
// and PQ quads each side, its rows PQT quads apart.
template <typename T, int R_, int K, int TM_>
struct Gen {
  static constexpr int R = R_;
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static constexpr int CH = kPlanRows;
  static constexpr int TM = TM_;
  static constexpr int TQ = kPlanQuads;
  static constexpr int TN = TQ * V;
  static constexpr int W = 2 * R + 1;
  static constexpr int PQ = (R + V - 1) / V;
  static constexpr int NQ = 2 * PQ + 1;  // quads of a thread's window row
  static constexpr int ER = (K - 1) * R;
  static constexpr int EQ = ((K - 1) * R + V - 1) / V;
  static constexpr int GR = TM + 2 * ER;
  static constexpr int GX = TQ + 2 * EQ;
  static constexpr int GY = GR / CH;
  static constexpr int groups = GX * GY;
  static constexpr int threads = (groups + 31) / 32 * 32;
  static constexpr int PR = GR + 2 * R;
  static constexpr int PQT = GX + 2 * PQ;
  static constexpr int ROW = PQT * V;  // elements a plane row
  static constexpr int plane = PR * ROW;
  static constexpr int in_slots = W + kPlanAhead;
  static constexpr int lv_slots = K > 1 ? W : 0;
  static constexpr int smem = static_cast<int>(sizeof(T)) * plane *
                              (in_slots + lv_slots);
  static_assert(GR % CH == 0, "cell groups must tile the grid");
};

// The tile rows of an instance: 32, or 16 or 8 where the planes of 32 would
// not fit a block's shared memory.
template <typename T, int R, int K>
__host__ __device__ constexpr int plan_tile_rows() {
  if constexpr (Gen<T, R, K, 32>::smem <= kMaxSmem) return 32;
  if constexpr (Gen<T, R, K, 16>::smem <= kMaxSmem) return 16;
  return 8;
}

// The lane's V cells of a residue point's row at `xr` (shifted by dc), off
// the quad grid by cls = dc & (V - 1): the aligned quads around them.
__device__ __forceinline__ void res_cells(const float* xr, int cls,
                                          float* v) {
  float a[4], b[4];
  ld_quad(xr - cls, a);
  if (cls == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = a[c];
    return;
  }
  ld_quad(xr - cls + 4, b);
  if (cls == 1) {
    v[0] = a[1], v[1] = a[2], v[2] = a[3], v[3] = b[0];
  } else if (cls == 2) {
    v[0] = a[2], v[1] = a[3], v[2] = b[0], v[3] = b[1];
  } else {
    v[0] = a[3], v[1] = b[0], v[2] = b[1], v[3] = b[2];
  }
}
__device__ __forceinline__ void res_cells(const double* xr, int cls,
                                          double* v) {
  double a[2], b[2];
  ld_quad(xr - cls, a);
  if (cls == 0) {
    v[0] = a[0], v[1] = a[1];
    return;
  }
  ld_quad(xr - cls + 2, b);
  v[0] = a[1], v[1] = b[0];
}

// Terms t .. t + NTG - 1's in-plane convs at the thread's CH x V cells,
// from its window at `win` in a shared plane (CH + 2R rows of NQ quads; its
// own cells the middle quad of rows R .. R + CH - 1): per cell and term
// PlaneTaps::at's order -- the column conv of each row the row conv reads,
// then the row conv, taps ascending, zero taps skipped, a missing axis the
// identity.  Only the rows and quads the terms read are loaded, each once
// for all NTG terms.
template <typename G, int NTG, typename T>
__device__ __forceinline__ void gen_convs(const GenPlan<T, G::R>& pl, int t,
                                          const T* win,
                                          T (&z)[NTG][G::CH][G::V]) {
  constexpr int R = G::R, V = G::V, CH = G::CH, W = G::W, PQ = G::PQ;
  bool has_col[NTG], has_row[NTG];
  bool any_col = false, any_row = false;
#pragma unroll
  for (int g = 0; g < NTG; ++g) {
    has_col[g] = pl.axes[t + g] & kHasCol;
    has_row[g] = pl.axes[t + g] & kHasRow;
    any_col = any_col || has_col[g];
    any_row = any_row || has_row[g];
#pragma unroll
    for (int h = 0; h < CH; ++h)
#pragma unroll
      for (int c = 0; c < V; ++c) z[g][h][c] = T(0);
  }
#pragma unroll
  for (int wr = 0; wr < CH + 2 * R; ++wr) {
    const int h0 = wr - R;  // the output row this window row is, if any
    const bool own_row = h0 >= 0 && h0 < CH;
    if (!any_row && !own_row) continue;
    T x[G::NQ * V];
    if (any_col) {
#pragma unroll
      for (int q = 0; q < G::NQ; ++q)
        ld_quad(win + wr * G::ROW + q * V, x + q * V);
    } else {
      ld_quad(win + wr * G::ROW + PQ * V, x + PQ * V);
    }
#pragma unroll
    for (int g = 0; g < NTG; ++g) {
      if (!has_row[g] && !own_row) continue;
      T y[V];
      if (has_col[g]) {
#pragma unroll
        for (int c = 0; c < V; ++c) y[c] = T(0);
#pragma unroll
        for (int b = 0; b < W; ++b)
          mad_quad(pl.ct[t + g][b], x + PQ * V + b - R, y);
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) y[c] = x[PQ * V + c];
      }
      if (has_row[g]) {
#pragma unroll
        for (int h = 0; h < CH; ++h) {
          const int a = wr - h;
          if (a >= 0 && a < W) mad_quad(pl.rt[t + g][a], y, z[g][h]);
        }
      } else {
#pragma unroll
        for (int h = 0; h < CH; ++h)
          if (h == h0) {
#pragma unroll
            for (int c = 0; c < V; ++c) z[g][h][c] = y[c];
          }
      }
    }
  }
}

// K = 1 or 2 fused steps per cell of a task's tile (TM rows x kPlanQuads
// quads) and z chunk, for each task of a block.  Input plane u of a task
// (interior z = zs - K R + u) lands in shared memory kPlanAhead planes
// ahead; level L's plane v (interior z = zs - K R + v) is summed when plane
// v + R of level L - 1 has landed, from level L - 1's planes v - R .. v + R
// (slot v % W of its ring; the input's, slot u % in_slots).  The last
// level's planes are the task's output.  VEC: the buffers start on the
// 16-byte grid and so do the layout's row pitch and origin column; the
// other instance copies and stores one cell at a time.  BOX (K = 2 only):
// level 1 keeps Pass's box, not the interior.  Cell: the state's cell type
// (a bfloat16 state computes in float, its planes widened as they land).
template <typename Cell, int R, int K, bool VEC, bool BOX,
          typename T = Compute<Cell>>
__global__ void __launch_bounds__(
    (Gen<T, R, K, plan_tile_rows<T, R, K>()>::threads), 1)
plan_march_kernel(const Cell* __restrict__ in, Cell* __restrict__ out,
                  const __grid_constant__ GenPlan<T, R> pl, const Pass p) {
  using G = Gen<T, R, K, plan_tile_rows<T, R, K>()>;
  constexpr int V = G::V, CH = G::CH, W = G::W;
  static_assert(!BOX || K == 2, "a box is for the level before the last");
  extern __shared__ float4 plan3_smem[];
  T* const s_in = reinterpret_cast<T*>(plan3_smem);
  T* const s_lv = s_in + G::in_slots * G::plane;  // level 1's planes (K = 2)
  const int tid = threadIdx.x;
  const bool active = tid < G::groups;
  const int gy = active ? tid / G::GX : 0;
  const int gx = active ? tid % G::GX : 0;
  const int win = gy * CH * G::ROW + gx * V;  // the thread's window
  const int own = win + R * G::ROW + G::PQ * V;  // its first cell
  const size_t plane_stride = static_cast<size_t>(p.rows) * p.pitch;
  const int tiles_c = (p.nr + G::TN - 1) / G::TN;
  const int tiles = tiles_c * ((p.mr + G::TM - 1) / G::TM);
  const int tasks = tiles * ((p.h + p.zc - 1) / p.zc);
  // level 1's ring starts zeroed: its cells beyond level 1's grid are never
  // written and feed no stored cell
  for (int q = tid; q < G::lv_slots * G::plane; q += blockDim.x) s_lv[q] = T(0);
  for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
    const int i0 = task % tiles / tiles_c * G::TM;
    const int j0 = task % tiles % tiles_c * G::TN;
    const int zs = task / tiles * p.zc;
    const int nin = min(p.zc, p.h - zs) + 2 * K * R;
    const int zb = zs - K * R;  // interior z of input plane 0
    // the thread's cells: interior rows i + h, columns j + c
    const int i = i0 - G::ER + gy * CH;
    const int j = j0 - G::EQ * V + gx * V;
    const bool col_out = active && gx >= G::EQ && gx < G::GX - G::EQ;
    const bool quad_out = col_out && VEC && j + V <= p.nr;
    // a plane's first buffer row and column
    const int gr0 = p.r0 + i0 - G::ER - R;
    const int gc0 = p.c0 + j0 - (G::EQ + G::PQ) * V;
    __syncthreads();  // the previous task's reads of shared memory are done

    // input plane u into its slot, zero outside the buffer; one commit
    // group per call, empty past the last plane
    auto fetch = [&](int u) {
      if (u < nin) {
        T* slot = s_in + (u % G::in_slots) * G::plane;
        const int gz = p.z0 + zb + u;
        const bool zin = gz >= 0 && gz < p.nz;
        const Cell* src =
            in + static_cast<size_t>(zin ? gz : 0) * plane_stride;
        if constexpr (VEC) {
          for (int q = tid; q < G::PR * G::PQT; q += blockDim.x) {
            const int pr = q / G::PQT, pq = q % G::PQT;
            const int gr = gr0 + pr, gc = gc0 + pq * V;
            const bool ok = zin && gr >= 0 && gr < p.rows && gc >= 0 &&
                            gc + V <= p.pitch;
            copy_quad(slot + pr * G::ROW + pq * V,
                      ok ? src + static_cast<size_t>(gr) * p.pitch + gc : in,
                      ok);
          }
        } else {
          for (int q = tid; q < G::PR * G::ROW; q += blockDim.x) {
            const int pr = q / G::ROW, pc = q % G::ROW;
            const int gr = gr0 + pr, gc = gc0 + pc;
            const bool ok = zin && gr >= 0 && gr < p.rows && gc >= 0 &&
                            gc < p.pitch;
            cp_async_cell(slot + pr * G::ROW + pc,
                          ok ? src + static_cast<size_t>(gr) * p.pitch + gc
                             : in,
                          ok);
          }
        }
      }
      cp_async_commit();
    };

    // Level L's plane v from the planes of level L - 1 (`ring`, `slots`
    // planes, plane w at slot w % slots): its sum, masked to the box
    // (levels before the last) or the interior.
    auto level = [&](const T* ring, int slots, int v, bool last,
                     T (&acc)[CH][V]) {
#pragma unroll
      for (int h = 0; h < CH; ++h)
#pragma unroll
        for (int c = 0; c < V; ++c) acc[h][c] = T(0);
      auto at = [&](int w) { return ring + (w % slots) * G::plane; };
      for (int t = 0; t < pl.n_terms; ++t) {  // centre terms
        if (pl.cls[t] != kCentre) continue;
        T z[1][CH][V];
        gen_convs<G, 1>(pl, t, at(v) + win, z);
#pragma unroll
        for (int h = 0; h < CH; ++h)
#pragma unroll
          for (int c = 0; c < V; ++c) acc[h][c] += z[0][h][c];
      }
      for (int t = 0; t < pl.n_terms; ++t) {  // buffered terms
        if (pl.cls[t] != kBuffered) continue;
        if (pl.pair[t]) {  // terms t, t + 1 on one plane: its loads once
          const int d = pl.zone[t];
          T z[2][CH][V];
          gen_convs<G, 2>(pl, t, at(v + d - R) + win, z);
#pragma unroll
          for (int g = 0; g < 2; ++g)
#pragma unroll
            for (int h = 0; h < CH; ++h)
#pragma unroll
              for (int c = 0; c < V; ++c)
                acc[h][c] = mad(pl.zt[t + g][d], z[g][h][c], acc[h][c]);
          ++t;
          continue;
        }
#pragma unroll 1
        for (int d = 0; d < W; ++d) {
          const T wz = pl.zt[t][d];
          if (wz == T(0)) continue;
          T z[1][CH][V];
          gen_convs<G, 1>(pl, t, at(v + d - R) + win, z);
#pragma unroll
          for (int h = 0; h < CH; ++h)
#pragma unroll
            for (int c = 0; c < V; ++c)
              acc[h][c] = mad(wz, z[0][h][c], acc[h][c]);
        }
      }
      for (int t = 0; t < pl.n_terms; ++t) {  // identity terms
        if (pl.cls[t] != kIdentityZ) continue;
#pragma unroll
        for (int d = 0; d < W; ++d) {
          const T wz = pl.zt[t][d];
          if (wz == T(0)) continue;
#pragma unroll
          for (int h = 0; h < CH; ++h) {
            T x[V];
            ld_quad(at(v + d - R) + own + h * G::ROW, x);
#pragma unroll
            for (int c = 0; c < V; ++c) acc[h][c] = mad(wz, x[c], acc[h][c]);
          }
        }
      }
      for (int q = 0; q < pl.n_res; ++q) {  // the residue
        const int dc = pl.res_dc[q];
        const T w = pl.res_w[q];
        const T* xr = at(v + pl.res_dz[q]) + own + pl.res_dr[q] * G::ROW + dc;
#pragma unroll
        for (int h = 0; h < CH; ++h) {
          T x[V];
          res_cells(xr + h * G::ROW, dc & (V - 1), x);
#pragma unroll
          for (int c = 0; c < V; ++c) acc[h][c] = mad(w, x[c], acc[h][c]);
        }
      }
      const int zv = zb + v;  // interior z of the plane
      const bool boxed = BOX && !last;
      const bool zok = boxed ? zv >= p.zl && zv < p.zh : zv >= 0 && zv < p.hz;
#pragma unroll
      for (int h = 0; h < CH; ++h)
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const int ii = i + h, jj = j + c;
          const bool ok =
              zok && (boxed ? ii >= p.rl && ii < p.rh && jj >= p.cl &&
                                  jj < p.ch
                            : ii >= 0 && ii < p.m && jj >= 0 && jj < p.n);
          if (!ok) acc[h][c] = T(0);
        }
    };
    auto store = [&](int v, const T (&acc)[CH][V]) {
      if (!col_out) return;
      Cell* dst = out + static_cast<size_t>(p.z0 + zb + v) * plane_stride;
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        const int row = gy * CH + h - G::ER;  // the tile's row
        if (row < 0 || row >= G::TM || i + h >= p.mr) continue;
        Cell* d = dst + static_cast<size_t>(p.r0 + i + h) * p.pitch + p.c0 + j;
        if (quad_out) {
          st_quad(d, acc[h]);
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c)
            if (j + c < p.nr) d[c] = to_cell<Cell>(acc[h][c]);
        }
      }
    };
#pragma unroll
    for (int u = 0; u < kPlanAhead; ++u) fetch(u);

    for (int u = 0; u < nin; ++u) {
      cp_async_wait<kPlanAhead - 1>();
      __syncthreads();  // plane u landed; the last plane's reads are done
      fetch(u + kPlanAhead);
      if (u < 2 * R) continue;  // level 1 has no plane yet
      // level 1 takes input planes u - 2R .. u and yields its plane u - R
      T lv[CH][V];
      if (active) {
        level(s_in, G::in_slots, u - R, K == 1, lv);
        if constexpr (K == 1) store(u - R, lv);
      }
      if constexpr (K == 2) {
        const int v1 = u - R;
        if (active) {
#pragma unroll
          for (int h = 0; h < CH; ++h)
            st_quad(s_lv + (v1 % W) * G::plane + own + h * G::ROW, lv[h]);
        }
        __syncthreads();  // level 1's plane is in shared memory
        if (v1 >= 3 * R && active) {
          // level 2 takes level 1's planes v1 - 2R .. v1 (level 1 yields
          // planes R on) and yields plane v1 - R
          T acc[CH][V];
          level(s_lv, W, v1 - R, true, acc);
          store(v1 - R, acc);
        }
      }
    }
  }
}

template <typename Cell, int R, int K, bool VEC, bool BOX,
          typename T = Compute<Cell>>
int launch_gen(const Cell* in, Cell* out, const GenPlan<T, R>& pl, Pass p,
               cudaStream_t stream) {
  using G = Gen<T, R, K, plan_tile_rows<T, R, K>()>;
  static int resident[kMaxDevices];
  const void* kernel = reinterpret_cast<const void*>(
      plan_march_kernel<Cell, R, K, VEC, BOX>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    if (G::smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::smem);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        G::threads, G::smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  // the march kernel's chunking: the tasks fill the resident blocks once,
  // with at least 16 K R planes a chunk so that the lookback costs <= 1/8
  const int tiles =
      ((p.mr + G::TM - 1) / G::TM) * ((p.nr + G::TN - 1) / G::TN);
  const int chunks = resident[dev] / tiles > 1 ? resident[dev] / tiles : 1;
  p.zc = (p.h + chunks - 1) / chunks;
  const int zmin = 16 * K * R < p.h ? 16 * K * R : p.h;
  if (p.zc < zmin) p.zc = zmin;
  const long tasks = static_cast<long>(tiles) * ((p.h + p.zc - 1) / p.zc);
  const int blocks =
      static_cast<int>(tasks < resident[dev] ? tasks : resident[dev]);
  plan_march_kernel<Cell, R, K, VEC, BOX>
      <<<blocks, G::threads, G::smem, stream>>>(in, out, pl, p);
  return static_cast<int>(cudaGetLastError());
}

// plan_array's 3-D table (host memory) into the kernel's parameters.
template <typename T, int R>
bool fill_gen_plan(const T* plan, int n_terms, int n_res, GenPlan<T, R>& pl) {
  constexpr int W = 2 * R + 1;
  if (n_terms < 0 || n_terms > kGenMaxTerms || n_res < 0 ||
      n_res > kGenMaxRes)
    return false;
  pl.n_terms = n_terms;
  pl.n_res = n_res;
  const T* t = plan;
  for (int k = 0; k < n_terms; ++k, t += term_stride(R)) {
    const int cls = static_cast<int>(t[0]);
    if (cls != kCentre && cls != kIdentityZ && cls != kBuffered) return false;
    pl.cls[k] = cls;
    pl.axes[k] = (t[1] != T(0) ? kHasCol : 0) | (t[2] != T(0) ? kHasRow : 0);
    pl.zone[k] = -1;
    int nonzero = 0;
    for (int q = 0; q < W; ++q) {
      pl.zt[k][q] = t[3 + q];
      pl.ct[k][q] = t[3 + W + q];
      pl.rt[k][q] = t[3 + 2 * W + q];
      if (pl.zt[k][q] != T(0)) pl.zone[k] = nonzero++ == 0 ? q : -1;
    }
    if (nonzero != 1) pl.zone[k] = -1;
  }
  for (int k = 0; k < n_terms; ++k)
    pl.pair[k] = k + 1 < n_terms && pl.cls[k] == kBuffered &&
                 pl.cls[k + 1] == kBuffered && pl.zone[k] >= 0 &&
                 pl.zone[k] == pl.zone[k + 1];
  for (int q = 0; q < n_res; ++q, t += 4) {
    const int dz = static_cast<int>(t[0]);
    const int dr = static_cast<int>(t[1]);
    const int dc = static_cast<int>(t[2]);
    if (dz < -R || dz > R || dr < -R || dr > R || dc < -R || dc > R)
      return false;
    pl.res_dz[q] = dz;
    pl.res_dr[q] = dr;
    pl.res_dc[q] = dc;
    pl.res_w[q] = t[3];
  }
  return true;
}

template <typename Cell, int R, typename T = Compute<Cell>>
int gen_radius(const Cell* in, Cell* out, const T* plan, const Pass& p,
               int vec, cudaStream_t stream) {
  GenPlan<T, R> pl = {};
  if (!fill_gen_plan<T, R>(plan, p.n_terms, p.n_res, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.K == 2 && has_box(p))
    return vec ? launch_gen<Cell, R, 2, true, true>(in, out, pl, p, stream)
               : launch_gen<Cell, R, 2, false, true>(in, out, pl, p, stream);
  if (p.K == 2)
    return vec ? launch_gen<Cell, R, 2, true, false>(in, out, pl, p, stream)
               : launch_gen<Cell, R, 2, false, false>(in, out, pl, p, stream);
  return vec ? launch_gen<Cell, R, 1, true, false>(in, out, pl, p, stream)
             : launch_gen<Cell, R, 1, false, false>(in, out, pl, p, stream);
}

bool gen_valid(const Pass& p, int R) {
  return R >= 1 && R <= kGenMaxRadius && (p.K == 1 || p.K == 2) &&
         p.n_terms >= 0 && p.n_terms <= kGenMaxTerms && p.n_res >= 0 &&
         p.n_res <= kGenMaxRes &&
         p.plan_len == p.n_terms * term_stride(R) + 4 * p.n_res &&
         p.h >= 0 && p.m >= 0 && p.n >= 0 && p.mr >= p.m && p.nr >= p.n &&
         p.z0 >= 0 && p.z0 + p.h <= p.nz && p.r0 >= 0 &&
         p.r0 + p.mr <= p.rows && p.c0 >= 0 && p.c0 + p.nr <= p.pitch &&
         box_valid(p) &&
         static_cast<long long>(p.rows) * p.pitch < (1LL << 31);
}

// A pass of K = 1 or 2 steps by the plan march kernel; `plan` is
// plan_array's table in host memory.  Radii 1..kGenMaxRadius: the radius
// and K pick the instantiation; any other is refused.
template <typename Cell>
int gen_pass(const Cell* in, Cell* out, const Compute<Cell>* plan,
             const Pass& p, int radius, void* stream) {
  if (!plan || !gen_valid(p, radius))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.h == 0 || p.mr == 0 || p.nr == 0) return 0;
  constexpr int V = 16 / static_cast<int>(sizeof(Compute<Cell>));
  constexpr uintptr_t kQuadBytes = V * sizeof(Cell);
  const int vec = reinterpret_cast<uintptr_t>(in) % kQuadBytes == 0 &&
                  reinterpret_cast<uintptr_t>(out) % kQuadBytes == 0 &&
                  p.pitch % V == 0 && p.c0 % V == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return gen_radius<Cell, 1>(in, out, plan, p, vec, s);
    case 2: return gen_radius<Cell, 2>(in, out, plan, p, vec, s);
    case 3: return gen_radius<Cell, 3>(in, out, plan, p, vec, s);
    case 4: return gen_radius<Cell, 4>(in, out, plan, p, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The entries, with the march kernel's signature (csrc/stencil3d.cu
// LS_MARCH): the buffers, the tap table in host memory and its counts, K,
// the buffer extents, the origin, the interior, the rounded plane, the box
// of level 1 at K = 2, the window, and the stream.
#define LS_PLAN_MARCH(NAME, T)                                              \
  extern "C" int NAME(const T* in, T* out, const Compute<T>* plan,          \
                      int plan_len, int n_terms, int radius, int n_res,     \
                      int K, int nz, int rows, int pitch, int z0, int r0,   \
                      int c0, int h, int m, int n, int mr, int nr, int zl,  \
                      int zh, int rl, int rh, int cl, int ch, int wi0,      \
                      int wi1, int wj0, int wj1, void* stream) {            \
    return gen_pass(in, out, plan,                                          \
                    in_window(with_box(make_pass(plan_len, n_terms, n_res,  \
                                                 0, 1, K, nz, rows, pitch,  \
                                                 z0, r0, c0, h, m, n, mr,   \
                                                 nr, 1, 1, 1),              \
                                       zl, zh, rl, rh, cl, ch),             \
                              wi0, wi1, wj0, wj1),                          \
                    radius, stream);                                        \
  }
#ifndef LS_PLAN3D_BF16
LS_PLAN_MARCH(ls_stencil3d_plan_march, float)
LS_PLAN_MARCH(ls_stencil3d_plan_march_f64, double)
#else
LS_PLAN_MARCH(ls_stencil3d_plan_march_bf16, __nv_bfloat16)
#endif
