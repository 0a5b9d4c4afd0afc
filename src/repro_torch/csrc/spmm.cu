// Block-ELL SpMM kernels for Hopper (sm_90a): C = A @ B, A in one of the
// block layouts of sparse/bsr.py and sparse/merge.py, B and C dense fp32,
// row-major. fp32 FMA on the CUDA cores: the rb x bc micro-tiles (8x8,
// 16x8, 8x16) are below wgmma's M = 64, hold ~1.4 real nonzeros each on
// GNN graphs, and TF32 would depart from the reference's fp32 products.
//
// Replaces src/repro/kernels/spmm_pallas.py:
//   spmm_rows_kernel, blkptr != NULL <- spmm_ragged_ell (_spmm_ragged_kernel)
//   spmm_rows_kernel, blkptr == NULL <- spmm_block_ell  (_spmm_kernel)
//   spmm_merge_kernel + fixup        <- spmm_merge_path (_spmm_merge_kernel)
//
// What bounds them on an H100. The product needs 2 * nnz * F FLOPs, each
// layout array read once, B read once and C written once: its floor is
// the bytes at 3.35 TB/s (the value tiles dominate: 5.1 GB ragged, 13.9 GB
// dense-W at Reddit-0.25 8x8). A kernel that multiplies whole tiles adds
// rb*bc*F FMAs and bc B-row gathers per slot, nearly all on zeros. These
// kernels do the work of the real nonzeros only: a tile costs its own
// read and two warp votes, each live column c one gather of B row
// colblk*bc + c, and each nonzero (r, c) one fmaf per feature column.
// What is left above the byte floor is per-slot work done in series by
// one warp: the votes, the live-column bookkeeping and the data-dependent
// B gathers (B at Reddit-0.25 is 59.6 MB, above the 50 MB L2). On the
// H100 the time scales with the number of (slot, feature chunk) passes
// and barely with F inside a chunk, nor with the depth of the prefetch
// (PERF.md).
//
// Design: one warp owns one (row block, 128-column feature chunk) of the
// rows kernel, or one (run of merge tiles, feature chunk) of the merge
// kernel; a CUDA block holds two such warps. No shared memory and no
// block barriers, so a long row block holds up one warp, not a block;
// the ragged launch takes the row blocks longest first, so the chains of
// hub row blocks start in the first wave. Per slot, in slot order:
//   1. the warp reads the tile with one vector load per lane (8x8: a
//      float2, 16x8 and 8x16: a float4; lane l holds row l / L, columns
//      (l % L) * E .. + E - 1, E = rb*bc/32 values, L = bc / E lanes per
//      row) and its colblk with one scalar load, kAhead slots before its
//      votes, into registers;
//   2. __ballot_sync per value slot gives each (r, c) nonzero bit and
//      __reduce_or_sync the tile's live columns (warp-uniform), minus
//      columns whose B row lies past n_b_rows (they read as zero);
//   3. B rows are gathered for live columns only: the first two of the
//      next slot before the current slot's FMAs, further ones two at a
//      time. A lane owns 4 feature columns: one float4 when F % 4 == 0
//      and B and C are 16-byte aligned, else columns f0 + 32k (k < 4) as
//      coalesced scalar loads, so at most one warp-tail of lanes is idle;
//   4. for each live column in ascending order and each row r with
//      v[r][c] != 0, v is broadcast by __shfl_sync and the row's rb x 4
//      accumulators (registers, reached through a switch on r) take
//      acc[r] = fmaf(v, b, acc[r]).
// An all-zero tile (dense-W padding, the ragged dummy slot, merge tail
// padding) costs its read and the votes. Every loop and branch is
// warp-uniform, so the warp never diverges.
//
// Why no cp.async or TMA: a slot's tile is 256-512 B that the same warp
// consumes in registers (votes and shuffles), and a B gather is one
// 512 B row at an address known only after the votes: below what a TMA
// descriptor and an mbarrier round trip amortize. A variant that staged
// tiles and B rows through a per-warp cp.async ring in shared memory, at
// depths 1 to 4, measured no faster on the H100 than these register
// loads, so the simpler kernel stayed.
//
// Numerics. A skipped product is an exact zero: for finite B,
// fmaf(+-0, b, acc) == acc, so per output row the live products are
// summed in the (slot, c) order of a whole-tile walk and give its result.
// Dense-W and ragged walk the same live tiles in the same order and agree
// bit for bit. Where B holds +-inf or NaN in a row that a tile pairs only
// with zero values, a whole-tile product (the Pallas kernels, the plain
// versions) gives NaN (0 * inf); these kernels give the CSR product's
// value, as ref.spmm_ref does on the CSR. Merge-path splits the slot
// stream into equal runs of merge tiles, one per warp; a row block that
// straddles runs is summed in a second pass (carry + fixup, in run
// order), so merge-path is held to a tolerance against ragged, not to
// its bits. No float atomics: two launches give the same bits.
//
// Value tiles are indexed with 64-bit offsets (dense-W at Reddit scale
// holds more than 2^31 floats). B rows past n_b_rows read as zero, so
// callers pass B unpadded; output rows past n_out_rows are not written.
// The launchers allocate nothing and do not synchronize; each returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it does not
// take) so the caller can raise.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kLaneCols = 4;                   // feature columns per lane: one float4
constexpr int kChunkCols = kWarp * kLaneCols;  // feature columns per warp
constexpr int kWarpsPerBlock = 2;

template <int RB, int BC>
struct Geo {
  static constexpr int E = RB * BC / kWarp;  // tile values per lane
  static constexpr int L = BC / E;           // lanes per tile row
  // bit r * L of a column's vote word marks row r
  static constexpr unsigned kRowBits = L == 4 ? 0x11111111u : 0x55555555u;
  // tiles in flight beyond the next slot's: 3 float2 or 2 float4 ones
  static constexpr int kAhead = E == 2 ? 3 : 2;
  static_assert(E == 2 || E == 4, "8x8, 16x8 or 8x16 tiles");
  static_assert(RB * L == kWarp, "one tile spans the warp");
};

template <int E>
struct Tile {
  float v[E];
  int cb;
};

template <int E>
struct Live {
  unsigned m[E];  // bit l of m[e]: lane l's value e is nonzero
  unsigned cols;  // bit c: tile column c is live (warp-uniform)
};

// Two live columns of a slot and this lane's B values for them (c < 0:
// none), loaded together before they are used.
struct Pair {
  int c[2];
  float x[2][kLaneCols];
};

template <int RB, int BC>
__device__ __forceinline__ void load_tile(const float* __restrict__ vals,
                                          const int* __restrict__ colblk, long long s, int lane,
                                          Tile<Geo<RB, BC>::E>& t) {
  constexpr int E = Geo<RB, BC>::E;
  const float* p = vals + s * (RB * BC) + lane * E;
  if constexpr (E == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    t.v[0] = x.x;
    t.v[1] = x.y;
  } else {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    t.v[0] = x.x;
    t.v[1] = x.y;
    t.v[2] = x.z;
    t.v[3] = x.w;
  }
  t.cb = __ldg(colblk + s);
}

// The warp's votes on a tile: which of its values are nonzero, and which
// columns hold a nonzero whose B row lies below n_b_rows (rows past it
// read as zero).
template <int RB, int BC>
__device__ __forceinline__ Live<Geo<RB, BC>::E> live_of(const Tile<Geo<RB, BC>::E>& t,
                                                        int lane, long long n_b_rows) {
  using G = Geo<RB, BC>;
  Live<G::E> lv;
  unsigned mine = 0;
  const int q = lane % G::L;
#pragma unroll
  for (int e = 0; e < G::E; ++e) {
    const bool nz = t.v[e] != 0.0f;
    lv.m[e] = __ballot_sync(kFull, nz);
    mine |= nz ? 1u << (q * G::E + e) : 0u;
  }
  lv.cols = __reduce_or_sync(kFull, mine);
  const long long room = n_b_rows - static_cast<long long>(t.cb) * BC;
  if (room < BC) lv.cols &= room > 0 ? (1u << room) - 1u : 0u;
  return lv;
}

// This lane's first feature column in a chunk. VEC: its columns are
// f0 .. f0 + 3, one float4; else f0 + kWarp * k (k < 4). Either way a
// warp-wide load is coalesced.
template <bool VEC>
__device__ __forceinline__ int first_col(int chunk, int lane) {
  return chunk * kChunkCols + (VEC ? 4 * lane : lane);
}

template <bool VEC>
__device__ __forceinline__ void load_b(const float* __restrict__ b, long long row,
                                       int F, int f0, float (&x)[kLaneCols]) {
  const float* p = b + row * F;
  if constexpr (VEC) {
    float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (f0 < F) y = __ldg(reinterpret_cast<const float4*>(p + f0));
    x[0] = y.x;
    x[1] = y.y;
    x[2] = y.z;
    x[3] = y.w;
  } else {
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k) {
      const int f = f0 + kWarp * k;
      x[k] = f < F ? __ldg(p + f) : 0.0f;
    }
  }
}

// acc[r] += a * x, r a runtime row: a jump to one of RB unrolled
// cases, so acc stays in registers.
template <int RB>
__device__ __forceinline__ void fma_row(int r, float a, const float (&x)[kLaneCols],
                                        float (&acc)[RB][kLaneCols]) {
#define SPMM_FMA_ROW(R)                                                      \
  case R:                                                                    \
    if constexpr (R < RB) {                                                  \
      _Pragma("unroll") for (int k = 0; k < kLaneCols; ++k) acc[R][k] =      \
          fmaf(a, x[k], acc[R][k]);                                          \
    }                                                                        \
    break;
  switch (r) {
    SPMM_FMA_ROW(0) SPMM_FMA_ROW(1) SPMM_FMA_ROW(2) SPMM_FMA_ROW(3)
    SPMM_FMA_ROW(4) SPMM_FMA_ROW(5) SPMM_FMA_ROW(6) SPMM_FMA_ROW(7)
    SPMM_FMA_ROW(8) SPMM_FMA_ROW(9) SPMM_FMA_ROW(10) SPMM_FMA_ROW(11)
    SPMM_FMA_ROW(12) SPMM_FMA_ROW(13) SPMM_FMA_ROW(14) SPMM_FMA_ROW(15)
    default:
      break;
  }
#undef SPMM_FMA_ROW
}

// The B rows of the two lowest columns in `cols`, loaded together; the
// columns are cleared from `cols`.
template <int BC, bool VEC>
__device__ __forceinline__ Pair gather(unsigned& cols, int cb, const float* __restrict__ b,
                                       int F, int f0) {
  Pair p;
  const long long row0 = static_cast<long long>(cb) * BC;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    p.c[j] = cols ? __ffs(static_cast<int>(cols)) - 1 : -1;
    cols &= cols - 1u;
    if (p.c[j] >= 0) load_b<VEC>(b, row0 + p.c[j], F, f0, p.x[j]);
  }
  return p;
}

// acc[r] += v[r][c] * B row, for each row r with v[r][c] != 0 (the value
// broadcast from its lane).
template <int RB, int BC>
__device__ __forceinline__ void fma_column(const Tile<Geo<RB, BC>::E>& t,
                                           const Live<Geo<RB, BC>::E>& lv, int c,
                                           const float (&x)[kLaneCols],
                                           float (&acc)[RB][kLaneCols]) {
  using G = Geo<RB, BC>;
  const int e = c % G::E;
  const int src = c / G::E;  // lane of (row 0, c); row r's is r * L + src
  unsigned me = lv.m[0];
  float ve = t.v[0];
#pragma unroll
  for (int j = 1; j < G::E; ++j) {
    if (e == j) {
      me = lv.m[j];
      ve = t.v[j];
    }
  }
  unsigned rows = (me >> src) & G::kRowBits;
  while (rows) {
    const int bit = __ffs(static_cast<int>(rows)) - 1;
    rows &= rows - 1u;
    fma_row<RB>(bit / G::L, __shfl_sync(kFull, ve, bit + src), x, acc);
  }
}

template <int RB, int BC>
__device__ __forceinline__ void fma_pair(const Tile<Geo<RB, BC>::E>& t,
                                         const Live<Geo<RB, BC>::E>& lv, const Pair& p,
                                         float (&acc)[RB][kLaneCols]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (p.c[j] >= 0) fma_column<RB, BC>(t, lv, p.c[j], p.x[j], acc);
}

// One slot's FMAs, live columns in ascending order: the two whose B rows
// were gathered ahead, then the rest two at a time.
template <int RB, int BC, bool VEC>
__device__ __forceinline__ void fma_slot(const Tile<Geo<RB, BC>::E>& t,
                                         const Live<Geo<RB, BC>::E>& lv, const Pair& ahead,
                                         const float* __restrict__ b, int F, int f0,
                                         float (&acc)[RB][kLaneCols]) {
  fma_pair<RB, BC>(t, lv, ahead, acc);
  if (ahead.c[1] < 0) return;
  unsigned rest = lv.cols & ~((2u << ahead.c[1]) - 1u);
  while (rest) fma_pair<RB, BC>(t, lv, gather<BC, VEC>(rest, t.cb, b, F, f0), acc);
}

// Walk slots [s_begin, s_end) in order, accumulating into acc. A slot's
// tile (and colblk) is loaded kAhead slots before its votes, and the
// B rows of its first two live columns one slot before its FMAs, so the
// loads of the next slots are in flight while the current slot's FMAs
// run. before(s) runs just before slot s's FMAs (merge-path's row-block
// steps). All of it is warp-uniform.
template <int RB, int BC, bool VEC, typename Before>
__device__ __forceinline__ void walk_slots(const int* __restrict__ colblk,
                                           const float* __restrict__ vals,
                                           const float* __restrict__ b, long long n_b_rows,
                                           int F, int f0, int lane, long long s_begin,
                                           long long s_end, float (&acc)[RB][kLaneCols],
                                           Before before) {
  constexpr int E = Geo<RB, BC>::E;
  constexpr int kAhead = Geo<RB, BC>::kAhead;
  if (s_begin >= s_end) return;
  Tile<E> ring[kAhead];  // ring[d]: slot s + 1 + d
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
    ring[d] = Tile<E>{};
    if (s_begin + 1 + d < s_end) load_tile<RB, BC>(vals, colblk, s_begin + 1 + d, lane, ring[d]);
  }
  Tile<E> cur;
  load_tile<RB, BC>(vals, colblk, s_begin, lane, cur);
  Live<E> lc = live_of<RB, BC>(cur, lane, n_b_rows);
  unsigned cols = lc.cols;
  Pair pc = gather<BC, VEC>(cols, cur.cb, b, F, f0);
  for (long long s = s_begin; s < s_end; ++s) {
    const Tile<E> nxt = ring[0];
#pragma unroll
    for (int d = 0; d + 1 < kAhead; ++d) ring[d] = ring[d + 1];
    if (s + 1 + kAhead < s_end)
      load_tile<RB, BC>(vals, colblk, s + 1 + kAhead, lane, ring[kAhead - 1]);
    Live<E> ln{};
    Pair pn;
    pn.c[0] = pn.c[1] = -1;
    if (s + 1 < s_end) {
      ln = live_of<RB, BC>(nxt, lane, n_b_rows);
      unsigned next_cols = ln.cols;
      pn = gather<BC, VEC>(next_cols, nxt.cb, b, F, f0);
    }
    before(s);
    fma_slot<RB, BC, VEC>(cur, lc, pc, b, F, f0, acc);
    cur = nxt;
    lc = ln;
    pc = pn;
  }
}

// Rows [0, n_valid) of acc to dst (row stride F), this lane's columns.
template <int RB, bool VEC>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, long long n_valid,
                                           int F, int f0, const float (&acc)[RB][kLaneCols]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= n_valid) break;
    float* p = dst + static_cast<long long>(r) * F;
    if constexpr (VEC) {
      if (f0 < F)
        *reinterpret_cast<float4*>(p + f0) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k)
        if (f0 + kWarp * k < F) p[f0 + kWarp * k] = acc[r][k];
    }
  }
}

template <int RB>
__device__ __forceinline__ void zero(float (&acc)[RB][kLaneCols]) {
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k) acc[r][k] = 0.0f;
}

// One warp per (row block, feature chunk). Ragged: the row block's slots
// are blkptr[i]..blkptr[i+1], and warp k takes row block order[k] (the
// caller's longest-first order, so the long chains of hub row blocks
// start in the first wave). Dense-W (blkptr == nullptr, order ignored):
// i*width .. (i+1)*width, padded slots included.
template <int RB, int BC, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
spmm_rows_kernel(const int* __restrict__ blkptr, const int* __restrict__ order, int width,
                 const int* __restrict__ colblk, const float* __restrict__ vals,
                 const float* __restrict__ b, float* __restrict__ out,
                 long long n_row_blocks, int n_chunks, long long n_b_rows, int F,
                 long long n_out_rows) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (w >= n_row_blocks * n_chunks) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  const long long k = w / n_chunks;
  const long long i = order != nullptr ? order[k] : k;
  const int f0 = first_col<VEC>(static_cast<int>(w - k * n_chunks), lane);
  long long s0, s1;
  if (blkptr != nullptr) {
    s0 = blkptr[i];
    s1 = blkptr[i + 1];
  } else {
    s0 = i * width;
    s1 = s0 + width;
  }
  float acc[RB][kLaneCols];
  zero<RB>(acc);
  walk_slots<RB, BC, VEC>(colblk, vals, b, n_b_rows, F, f0, lane, s0, s1, acc,
                          [](long long) {});
  store_rows<RB, VEC>(out + i * RB * F, n_out_rows - i * RB, F, f0, acc);
}

// One warp per (run of tiles_per_run merge tiles, feature chunk). The warp
// walks its slots in order, starting at its first tile's row block and
// stepping to the next row block whenever a slot reaches blkptr[i+1]
// (every row block owns >= 1 slot). A row block that starts inside the
// run is written straight to `out`; the run's first row block, when its
// first tile starts mid-row-block (tile_offset > 0), goes to
// carry[run] instead. Tail padding (slots >= n_slots) is skipped.
template <int RB, int BC, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
spmm_merge_kernel(const int* __restrict__ blkptr, const int* __restrict__ colblk,
                  const float* __restrict__ vals, const int* __restrict__ tile_rowblk,
                  const int* __restrict__ tile_offset, int tile_slots,
                  int tiles_per_run, int n_runs, int n_chunks, long long n_slots,
                  const float* __restrict__ b, float* __restrict__ out,
                  float* __restrict__ carry, long long n_b_rows, int F,
                  long long n_out_rows) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (w >= static_cast<long long>(n_runs) * n_chunks) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  const long long run = w / n_chunks;
  const int f0 = first_col<VEC>(static_cast<int>(w - run * n_chunks), lane);
  const long long t0 = run * tiles_per_run;
  const long long s_begin = t0 * tile_slots;
  const long long s_stop = s_begin + static_cast<long long>(tiles_per_run) * tile_slots;
  const long long s_end = s_stop < n_slots ? s_stop : n_slots;
  long long i = tile_rowblk[t0];
  long long row_end = blkptr[i + 1];
  bool to_carry = tile_offset[t0] > 0;
  float acc[RB][kLaneCols];
  zero<RB>(acc);
  auto flush = [&]() {
    if (to_carry)
      store_rows<RB, VEC>(carry + run * RB * F, RB, F, f0, acc);
    else
      store_rows<RB, VEC>(out + i * RB * F, n_out_rows - i * RB, F, f0, acc);
  };
  walk_slots<RB, BC, VEC>(colblk, vals, b, n_b_rows, F, f0, lane, s_begin, s_end, acc,
                          [&](long long s) {
                            while (s >= row_end) {  // slot opens the next row block
                              flush();
                              to_carry = false;
                              ++i;
                              row_end = blkptr[i + 1];
                              zero<RB>(acc);
                            }
                          });
  flush();
}

// Deterministic carry fixup, one thread per (run, feature column): the
// first run of each chain of runs that continue one row block ("leader")
// adds the chain's carries to that row block in run order. Row blocks
// never take two fixups at once and no atomics are used.
template <int RB>
__global__ void __launch_bounds__(kChunkCols)
spmm_merge_fixup_kernel(const int* __restrict__ tile_rowblk,
                        const int* __restrict__ tile_offset, int tiles_per_run,
                        int n_runs, const float* __restrict__ carry,
                        float* __restrict__ out, int F, long long n_out_rows) {
  const long long run = blockIdx.x;
  const int f = blockIdx.y * kChunkCols + threadIdx.x;
  if (f >= F) return;
  const long long t0 = run * tiles_per_run;
  if (tile_offset[t0] == 0) return;
  const int rowblk = tile_rowblk[t0];
  if (run > 0) {
    const long long tp = t0 - tiles_per_run;
    if (tile_offset[tp] > 0 && tile_rowblk[tp] == rowblk) return;  // not the leader
  }
  const long long row0 = static_cast<long long>(rowblk) * RB;
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = row0 + r < n_out_rows ? out[(row0 + r) * F + f] : 0.0f;
  for (long long c = run; c < n_runs; ++c) {
    const long long tc = c * tiles_per_run;
    if (c > run && (tile_offset[tc] == 0 || tile_rowblk[tc] != rowblk)) break;
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] += carry[(c * RB + r) * F + f];
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (row0 + r < n_out_rows) out[(row0 + r) * F + f] = acc[r];
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// The arguments every launch shares: n_chunks covers F in 128-column
// chunks, vec4 needs F % 4 == 0 and 16-byte aligned B and C, and the
// value tiles are 16-byte aligned.
bool geometry_ok(int F, int n_chunks, int vec4, const void* vals, const void* b,
                 const void* out) {
  if (F <= 0 || n_chunks <= 0) return false;
  if (static_cast<long long>(n_chunks - 1) * kChunkCols >= F) return false;
  if (static_cast<long long>(n_chunks) * kChunkCols < F) return false;
  if (vec4 && (F % 4 != 0 || !aligned16(b) || !aligned16(out))) return false;
  return aligned16(vals);
}

unsigned blocks_for(long long warps) {
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <int RB, int BC, bool VEC>
cudaError_t launch_rows(const int* blkptr, const int* order, int width, const int* colblk,
                        const float* vals, const float* b, float* out,
                        long long n_row_blocks, int n_chunks, long long n_b_rows, int F,
                        long long n_out_rows, cudaStream_t stream) {
  const long long warps = n_row_blocks * n_chunks;
  if ((warps + kWarpsPerBlock - 1) / kWarpsPerBlock > INT_MAX) return cudaErrorInvalidValue;
  spmm_rows_kernel<RB, BC, VEC><<<blocks_for(warps), kWarpsPerBlock * kWarp, 0, stream>>>(
      blkptr, blkptr != nullptr ? order : nullptr, width, colblk, vals, b, out, n_row_blocks,
      n_chunks, n_b_rows, F, n_out_rows);
  return cudaGetLastError();
}

template <int RB, int BC>
cudaError_t launch_rows(bool vec4, const int* blkptr, const int* order, int width,
                        const int* colblk, const float* vals, const float* b, float* out,
                        long long n_row_blocks, int n_chunks, long long n_b_rows, int F,
                        long long n_out_rows, cudaStream_t stream) {
  if (vec4)
    return launch_rows<RB, BC, true>(blkptr, order, width, colblk, vals, b, out,
                                     n_row_blocks, n_chunks, n_b_rows, F, n_out_rows, stream);
  return launch_rows<RB, BC, false>(blkptr, order, width, colblk, vals, b, out,
                                    n_row_blocks, n_chunks, n_b_rows, F, n_out_rows, stream);
}

template <bool VEC>
cudaError_t launch_merge(const int* blkptr, const int* colblk, const float* vals,
                         const int* tile_rowblk, const int* tile_offset, int tile_slots,
                         int tiles_per_run, int n_runs, int n_chunks, long long n_slots,
                         const float* b, float* out, float* carry, long long n_b_rows,
                         int F, long long n_out_rows, cudaStream_t stream) {
  const long long warps = static_cast<long long>(n_runs) * n_chunks;
  spmm_merge_kernel<8, 8, VEC><<<blocks_for(warps), kWarpsPerBlock * kWarp, 0, stream>>>(
      blkptr, colblk, vals, tile_rowblk, tile_offset, tile_slots, tiles_per_run, n_runs,
      n_chunks, n_slots, b, out, carry, n_b_rows, F, n_out_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_runs), static_cast<unsigned>(n_chunks));
  spmm_merge_fixup_kernel<8><<<grid, kChunkCols, 0, stream>>>(
      tile_rowblk, tile_offset, tiles_per_run, n_runs, carry, out, F, n_out_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ragged (blkptr != NULL, width ignored; order: the row blocks in the
// order warps take them, or NULL for 0..n-1) or dense-W (blkptr == NULL,
// order ignored) SpMM.
int autosage_spmm_rows(const void* blkptr, const void* order, int width, const void* colblk,
                       const void* vals, const void* b, void* out,
                       long long n_row_blocks, int rb, int bc, long long n_b_rows,
                       int F, long long n_out_rows, int n_chunks, int vec4, void* stream) {
  if (!geometry_ok(F, n_chunks, vec4, vals, b, out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bp = static_cast<const int*>(blkptr);
  const int* od = static_cast<const int*>(order);
  const int* cb = static_cast<const int*>(colblk);
  const float* v = static_cast<const float*>(vals);
  const float* bb = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rb == 8 && bc == 8)
    return launch_rows<8, 8>(vec4, bp, od, width, cb, v, bb, o, n_row_blocks, n_chunks,
                             n_b_rows, F, n_out_rows, s);
  if (rb == 16 && bc == 8)
    return launch_rows<16, 8>(vec4, bp, od, width, cb, v, bb, o, n_row_blocks, n_chunks,
                              n_b_rows, F, n_out_rows, s);
  if (rb == 8 && bc == 16)
    return launch_rows<8, 16>(vec4, bp, od, width, cb, v, bb, o, n_row_blocks, n_chunks,
                              n_b_rows, F, n_out_rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Merge-path SpMM (8x8): main pass plus carry fixup, both on `stream`.
int autosage_spmm_merge(const void* blkptr, const void* colblk, const void* vals,
                        const void* tile_rowblk, const void* tile_offset,
                        int tile_slots, int tiles_per_run, int n_runs,
                        long long n_slots, const void* b, void* out, void* carry,
                        int rb, int bc, long long n_b_rows, int F,
                        long long n_out_rows, int n_chunks, int vec4, void* stream) {
  if (rb != 8 || bc != 8 || n_runs <= 0 || tiles_per_run <= 0 ||
      !geometry_ok(F, n_chunks, vec4, vals, b, out) || (vec4 && !aligned16(carry)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bp = static_cast<const int*>(blkptr);
  const int* cb = static_cast<const int*>(colblk);
  const float* v = static_cast<const float*>(vals);
  const int* tr = static_cast<const int*>(tile_rowblk);
  const int* to = static_cast<const int*>(tile_offset);
  const float* bb = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  float* ca = static_cast<float*>(carry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    return static_cast<int>(launch_merge<true>(bp, cb, v, tr, to, tile_slots, tiles_per_run,
                                               n_runs, n_chunks, n_slots, bb, o, ca,
                                               n_b_rows, F, n_out_rows, s));
  return static_cast<int>(launch_merge<false>(bp, cb, v, tr, to, tile_slots, tiles_per_run,
                                              n_runs, n_chunks, n_slots, bb, o, ca,
                                              n_b_rows, F, n_out_rows, s));
}

}  // extern "C"
