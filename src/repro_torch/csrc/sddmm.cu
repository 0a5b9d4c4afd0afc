// Block-ELL SDDMM kernels for Hopper (sm_90a): per stored rb x bc
// micro-tile of a block layout (sparse/bsr.py, sparse/merge.py), the
// tile X[rowblk*rb, +rb] . Y[colblk*bc, +bc]^T times the tile's
// structural 0/1 mask, with X (n_x_rows, F) and Y (n_y_rows, F) dense
// fp32, row-major. fp32 FMA on the CUDA cores: the 8x8 and 16x8 tiles are
// below wgmma's M = 64, and TF32 would depart from the reference's fp32
// dot products.
//
// Replaces src/repro/kernels/sddmm_pallas.py:
//   sddmm_slots_kernel<kDense>  <- sddmm_block_ell  (_sddmm_kernel)
//   sddmm_slots_kernel<kRagged> <- sddmm_ragged_ell (_sddmm_ragged_kernel)
//   sddmm_slots_kernel<kMerge>  <- sddmm_merge_path (_sddmm_merge_kernel)
//
// What bounds them on an H100. The function needs each layout array read
// once (the mask tiles dominate: 5.1 GB ragged, 13.6 GB dense-W at
// Reddit-0.25 8x8), X and Y read once, the tile output written once, and
// 2 * nnz * F FLOPs, so its floor is the bytes at 3.35 TB/s. A kernel
// that multiplies whole tiles adds rb * bc * F FMAs and rb + bc row
// gathers per slot on tiles that hold ~1.4 real edges on Reddit-like
// graphs. These kernels compute the cells whose mask is > 0 only: a tile
// costs its mask read, E warp votes and its store, and each live cell
// (r, c) one gather of X row rowblk*rb + r and Y row colblk*bc + c (from
// L1/L2; Y is gathered at random) and F FMAs spread over the warp. What
// is left above the byte floor is those row gathers, 2 * F * 4 bytes a
// live cell through L2 (57 GB for Reddit-0.25's 27.8 M edges at F = 256,
// ~5.4 TB/s at the ragged kernel's time in PERF.md), and for dense-W the
// latency of streaming its dead slots.
// The mask is read and the tiles are written with streaming (evict-first)
// accesses, so they do not push X and Y rows out of L2. Giving each warp
// runs of 4 or 8 consecutive slots, for more X-row hits in L1 and more
// mask loads in flight, measured within a few per cent of this design on
// the H100 (better at 4, worse at 8) for more registers, so it was left
// out.
//
// Design: one warp per slot, slots taken in a grid-stride loop by one
// wave of resident blocks, so neighbouring warps work on neighbouring
// slots (mostly of one row block, whose X rows then stay in L1/L2). SDDMM
// has no reduction across slots, so no slot waits on another and nothing
// carries between blocks. No shared memory. Per slot:
//   1. the warp reads the mask with one vector load per lane (8x8: a
//      float2, 16x8: a float4; lane l holds cells l*E .. l*E + E - 1,
//      E = rb*bc/32), with the slot's colblk (and ragged row block), one
//      slot ahead of its votes;
//   2. __ballot_sync per value gives each live cell (mask > 0) as a bit;
//      a tile with none (a padded dense-W slot, the ragged dummy slot, a
//      merge tail slot) is stored as +0.0 and costs nothing else;
//   3. for each live cell, in bit order, the whole warp computes its dot
//      product (below) and the lane that owns the cell keeps dot * mask;
//   4. the warp stores the tile with one vector store per lane: the kept
//      values on live cells, +0.0 on every other cell.
// Every branch and loop of 2-3 is warp-uniform.
//
// The dot product, the same for every cell of every layout: lane l takes
// feature columns 4l + 128k + j (k = 0, 1, ..., j = 0..3) of both rows,
// as one float4 when F % 4 == 0 and X and Y are 16-byte aligned, else as
// four scalar loads (F = 41 and 602 rows are not 16-byte aligned; the
// columns are the same either way), and runs one fmaf chain over them in
// (k, j) order from +0.0; the 32 partials are then summed by a fixed xor
// butterfly (offsets 16, 8, 4, 2, 1), which leaves the same bits in every
// lane. The order depends on F alone, so the live tiles of the three
// layouts are equal bit for bit. A cell whose X or Y row lies past its
// array's end reads as 0 (its rows are not loaded).
//
// Zeros. Masked, padded, dummy and tail cells are +0.0 (the Pallas
// kernels multiply by the mask and leave -0.0 where a masked dot is
// negative, and NaN where it is +-inf or NaN; no edge reads that cell). A
// live cell is dot * mask + 0.0 (round to nearest, not contracted), which
// turns a -0.0 (a dot of -0.0 rows, an underflow) into +0.0: no -0.0
// appears anywhere. Rows of Y that only masked cells pair with are never
// read, so +-inf or NaN there leaves those cells +0.0.
//
// The merge layout recovers each live slot's row block by the Pallas
// kernel's fixed-trip bisection over blkptr, seeded at its tile's start
// row block and bounded above by the next tile's; it stops once the
// bounds meet, where the fixed-trip loop's further steps change nothing
// (each step is a dependent load, and blkptr does not stay in L1 beside
// the row gathers: the full 14 steps made merge-path twice as slow as
// ragged). No atomics: two launches give the same bits. Slot and tile
// offsets are 64-bit (the dense-W table holds 3.4 G floats at
// Reddit-0.25). The launcher allocates nothing, does not synchronize,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a mask or
// output that is not aligned to its vector loads).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kWarps = 8;                      // warps per block, one slot each at a time
constexpr int kLaneCols = 4;                   // feature columns per lane and chunk
constexpr int kChunkCols = kWarp * kLaneCols;  // feature columns per warp and chunk

enum Layout { kDense = 0, kRagged = 1, kMerge = 2 };

template <int E>
struct Cells {
  float v[E];
};

// Largest i with blkptr[i] <= s, for blkptr[lo] <= s < blkptr[hi]: the
// Pallas kernels' _bisect_rowblk, at most n_iter steps. It stops once
// hi - lo <= 1, where every further step of the fixed-trip loop leaves lo
// as it is, so the result is the fixed-trip one.
__device__ __forceinline__ long long bisect_rowblk(const int* __restrict__ blkptr,
                                                   long long s, long long lo,
                                                   long long hi, int n_iter) {
  for (int it = 0; it < n_iter && hi - lo > 1; ++it) {
    const long long mid = (lo + hi) / 2;
    if (__ldg(blkptr + mid) <= s) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// This lane's E mask cells of the tile at p: one streaming vector load.
template <int E>
__device__ __forceinline__ Cells<E> load_cells(const float* __restrict__ p) {
  Cells<E> m;
  if constexpr (E == 2) {
    const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
    m.v[0] = v.x;
    m.v[1] = v.y;
  } else {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    m.v[0] = v.x;
    m.v[1] = v.y;
    m.v[2] = v.z;
    m.v[3] = v.w;
  }
  return m;
}

// This lane's E output cells: one streaming vector store.
template <int E>
__device__ __forceinline__ void store_cells(float* __restrict__ p, const Cells<E>& o) {
  if constexpr (E == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(o.v[0], o.v[1]));
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(o.v[0], o.v[1], o.v[2], o.v[3]));
  }
}

// Columns f .. f + 3 of a row (0 past F): one float4 (VEC) or four
// scalar loads.
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ row, int f, int F,
                                      float (&a)[kLaneCols]) {
  if constexpr (VEC) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + f));
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) a[j] = f + j < F ? __ldg(row + f + j) : 0.0f;
  }
}

// <xr, yr> over F columns, the same bits in every lane: lane l's fmaf
// chain over columns 4l + 128k + j in (k, j) order, then the xor
// butterfly. Two chunks' loads are issued before their FMAs, so F <= 256
// costs one round trip. Called by the whole warp.
template <bool VEC>
__device__ __forceinline__ float warp_dot(const float* __restrict__ xr,
                                          const float* __restrict__ yr, int F, int lane) {
  float acc = 0.0f;
  for (int f = kLaneCols * lane; f < F; f += 2 * kChunkCols) {
    const bool two = f + kChunkCols < F;
    float a[2][kLaneCols], b[2][kLaneCols];
    load4<VEC>(xr, f, F, a[0]);
    load4<VEC>(yr, f, F, b[0]);
    if (two) {
      load4<VEC>(xr, f + kChunkCols, F, a[1]);
      load4<VEC>(yr, f + kChunkCols, F, b[1]);
    }
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) acc = fmaf(a[0][j], b[0][j], acc);
    if (two) {
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) acc = fmaf(a[1][j], b[1][j], acc);
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

template <int RB, int BC, int MODE, bool VEC>
__global__ void __launch_bounds__(kWarps * kWarp)
sddmm_slots_kernel(const int* __restrict__ slot_rowblk,  // kRagged
                   const int* __restrict__ colblk,       // per slot, all modes
                   const int* __restrict__ blkptr,       // kMerge
                   const int* __restrict__ tile_rowblk,  // kMerge
                   long long width,                      // kDense: W
                   int tile_slots, long long n_row_blocks, int n_bisect,
                   const float* __restrict__ mask, const float* __restrict__ x,
                   const float* __restrict__ y, float* __restrict__ out,
                   long long n_slots, long long n_x_rows, long long n_y_rows, int F) {
  constexpr int E = RB * BC / kWarp;  // cells per lane
  static_assert(E == 2 || E == 4, "8x8 or 16x8 tiles");
  const int lane = threadIdx.x & (kWarp - 1);
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  long long s = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x / kWarp);
  if (s >= n_slots) return;

  // slot s's mask cells, colblk and (ragged) row block, loaded one slot
  // ahead of their use
  Cells<E> nm = load_cells<E>(mask + s * (RB * BC) + lane * E);
  int ncb = __ldg(colblk + s);
  int nrbk = MODE == kRagged ? __ldg(slot_rowblk + s) : 0;
  for (; s < n_slots; s += n_warps) {
    const Cells<E> m = nm;
    const int cb = ncb;
    const int rbk = nrbk;
    const long long sn = s + n_warps;
    if (sn < n_slots) {
      nm = load_cells<E>(mask + sn * (RB * BC) + lane * E);
      ncb = __ldg(colblk + sn);
      if (MODE == kRagged) nrbk = __ldg(slot_rowblk + sn);
    }
    unsigned live[E];
    unsigned any = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      live[e] = __ballot_sync(kFull, m.v[e] > 0.0f);
      any |= live[e];
    }
    Cells<E> o;
#pragma unroll
    for (int e = 0; e < E; ++e) o.v[e] = 0.0f;
    if (any) {
      long long rb_i;
      if (MODE == kRagged) {
        rb_i = rbk;
      } else if (MODE == kDense) {
        rb_i = s / width;
      } else {
        // seeded at the tile's start row block; the next tile's start
        // row block bounds it from above (its first slot lies past s)
        const long long t = s / tile_slots;
        const long long hi = (t + 1) * tile_slots < n_slots
                                 ? __ldg(tile_rowblk + t + 1) + 1LL
                                 : n_row_blocks;
        rb_i = bisect_rowblk(blkptr, s, __ldg(tile_rowblk + t), hi, n_bisect);
      }
      const long long xrow0 = rb_i * RB;
      const long long yrow0 = static_cast<long long>(cb) * BC;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        unsigned w = live[e];
        while (w) {
          const int l = __ffs(static_cast<int>(w)) - 1;  // the cell's lane
          w &= w - 1u;
          const int cell = l * E + e;
          const long long xrow = xrow0 + cell / BC;
          const long long yrow = yrow0 + cell % BC;
          float d = 0.0f;
          if (xrow < n_x_rows && yrow < n_y_rows)
            d = warp_dot<VEC>(x + xrow * F, y + yrow * F, F, lane);
          if (lane == l) o.v[e] = __fadd_rn(__fmul_rn(d, m.v[e]), 0.0f);
        }
      }
    }
    store_cells<E>(out + s * (RB * BC) + lane * E, o);
  }
}

template <int RB, int BC, int MODE, bool VEC>
cudaError_t launch_vec(const int* slot_rowblk, const int* colblk, const int* blkptr,
                       const int* tile_rowblk, long long width, int tile_slots,
                       long long n_row_blocks, int n_bisect, const float* mask,
                       const float* x, const float* y, float* out, long long n_slots,
                       long long n_x_rows, long long n_y_rows, int F, cudaStream_t stream) {
  // one wave of resident blocks; the grid-stride loop covers the rest
  static int per_sm = 0;  // resident blocks per SM: the same on every H100
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sddmm_slots_kernel<RB, BC, MODE, VEC>, kWarps * kWarp, 0);
  if (err != cudaSuccess) return err;
  const long long want = (n_slots + kWarps - 1) / kWarps;
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(want < wave ? want : wave);
  sddmm_slots_kernel<RB, BC, MODE, VEC><<<blocks, kWarps * kWarp, 0, stream>>>(
      slot_rowblk, colblk, blkptr, tile_rowblk, width, tile_slots, n_row_blocks, n_bisect,
      mask, x, y, out, n_slots, n_x_rows, n_y_rows, F);
  return cudaGetLastError();
}

template <int RB, int BC, int MODE>
cudaError_t launch(const int* slot_rowblk, const int* colblk, const int* blkptr,
                   const int* tile_rowblk, long long width, int tile_slots,
                   long long n_row_blocks, int n_bisect, const float* mask,
                   const float* x, const float* y, float* out, long long n_slots,
                   long long n_x_rows, long long n_y_rows, int F, cudaStream_t stream) {
  constexpr uintptr_t kTileAlign = RB * BC / kWarp * sizeof(float);  // one lane's cells
  if (reinterpret_cast<uintptr_t>(mask) % kTileAlign ||
      reinterpret_cast<uintptr_t>(out) % kTileAlign)
    return cudaErrorInvalidValue;
  const bool vec = F % kLaneCols == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec)
    return launch_vec<RB, BC, MODE, true>(slot_rowblk, colblk, blkptr, tile_rowblk, width,
                                          tile_slots, n_row_blocks, n_bisect, mask, x, y,
                                          out, n_slots, n_x_rows, n_y_rows, F, stream);
  return launch_vec<RB, BC, MODE, false>(slot_rowblk, colblk, blkptr, tile_rowblk, width,
                                         tile_slots, n_row_blocks, n_bisect, mask, x, y, out,
                                         n_slots, n_x_rows, n_y_rows, F, stream);
}

template <int MODE>
int dispatch(int rb, int bc, const int* slot_rowblk, const int* colblk,
             const int* blkptr, const int* tile_rowblk, long long width, int tile_slots,
             long long n_row_blocks, int n_bisect, const float* mask, const float* x,
             const float* y, float* out, long long n_slots, long long n_x_rows,
             long long n_y_rows, int F, cudaStream_t stream) {
  if (rb == 8 && bc == 8)
    return static_cast<int>(launch<8, 8, MODE>(
        slot_rowblk, colblk, blkptr, tile_rowblk, width, tile_slots, n_row_blocks,
        n_bisect, mask, x, y, out, n_slots, n_x_rows, n_y_rows, F, stream));
  if (rb == 16 && bc == 8)
    return static_cast<int>(launch<16, 8, MODE>(
        slot_rowblk, colblk, blkptr, tile_rowblk, width, tile_slots, n_row_blocks,
        n_bisect, mask, x, y, out, n_slots, n_x_rows, n_y_rows, F, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Dense-W SDDMM: colblk and mask of (n_row_blocks, width) slots, flat.
int autosage_sddmm_dense(const void* colblk, const void* mask, const void* x,
                         const void* y, void* out, long long n_row_blocks, int width,
                         int rb, int bc, long long n_x_rows, long long n_y_rows, int F,
                         void* stream) {
  return dispatch<kDense>(rb, bc, nullptr, static_cast<const int*>(colblk), nullptr,
                          nullptr, width, 1, n_row_blocks, 0,
                          static_cast<const float*>(mask), static_cast<const float*>(x),
                          static_cast<const float*>(y), static_cast<float*>(out),
                          n_row_blocks * width, n_x_rows, n_y_rows, F,
                          static_cast<cudaStream_t>(stream));
}

// Ragged SDDMM over n_slots live slots.
int autosage_sddmm_ragged(const void* slot_rowblk, const void* slot_colblk,
                          const void* mask, const void* x, const void* y, void* out,
                          long long n_slots, int rb, int bc, long long n_x_rows,
                          long long n_y_rows, int F, void* stream) {
  return dispatch<kRagged>(rb, bc, static_cast<const int*>(slot_rowblk),
                           static_cast<const int*>(slot_colblk), nullptr, nullptr, 0, 1,
                           0, 0, static_cast<const float*>(mask),
                           static_cast<const float*>(x), static_cast<const float*>(y),
                           static_cast<float*>(out), n_slots, n_x_rows, n_y_rows, F,
                           static_cast<cudaStream_t>(stream));
}

// Merge-path SDDMM over n_tiles * tile_slots slots (tail slots masked).
int autosage_sddmm_merge(const void* blkptr, const void* slot_colblk,
                         const void* tile_rowblk, const void* tile_mask, const void* x,
                         const void* y, void* out, long long n_tiles, int tile_slots,
                         long long n_row_blocks, int n_bisect, int rb, int bc,
                         long long n_x_rows, long long n_y_rows, int F, void* stream) {
  return dispatch<kMerge>(rb, bc, nullptr, static_cast<const int*>(slot_colblk),
                          static_cast<const int*>(blkptr),
                          static_cast<const int*>(tile_rowblk), 0, tile_slots,
                          n_row_blocks, n_bisect, static_cast<const float*>(tile_mask),
                          static_cast<const float*>(x), static_cast<const float*>(y),
                          static_cast<float*>(out), n_tiles * tile_slots, n_x_rows,
                          n_y_rows, F, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
