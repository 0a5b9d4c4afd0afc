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
// What bounds them on an H100: the function needs each layout array read
// once (the mask tiles dominate: 5.1 GB ragged, 13.6 GB dense-W at
// Reddit-0.25 8x8), X and Y read once, the tile output written once, and
// 2 * nnz * F FLOPs, so its floor is the bytes at 3.35 TB/s. The layout
// adds work above that floor: every live slot re-gathers rb + bc rows of
// X and Y (from L1/L2) and spends rb * bc * F FMAs on a tile that holds
// ~1.4 real edges on Reddit-like graphs.
//
// Design (a simple one that is right first): one warp per slot, slots
// taken in a grid-stride loop, so neighbouring warps of a block work on
// neighbouring slots (mostly of one row block, whose X rows then stay in
// L1). SDDMM has no reduction across slots, so no slot waits on another
// and nothing carries between blocks: the Pallas grid's "arbitrary" f
// axis becomes a loop inside the warp. Per slot:
//   1. each lane reads its rb*bc/32 mask cells; a tile with no edge (a
//      padded dense-W slot, the ragged dummy slot, a merge tail slot) is
//      written as zeros without computing anything;
//   2. F is walked in chunks of 32 columns: the lanes stage the chunk of
//      the rb X rows and bc Y rows in warp-private shared memory
//      (coalesced, rows past their ends read as 0), then each lane
//      advances its rb*bc/32 dot products (cells (r0 + 32/bc*k, lane %
//      bc)) with one fmaf per column, in column order;
//   3. each lane writes its cells: dot * mask where the mask is set, and
//      +0.0 where it is not.
// Every dot product is one fmaf chain over f = 0..F-1, whatever the
// layout, so the live tiles of all three layouts are equal bit for bit,
// and a masked cell is always +0.0 (the Pallas kernels multiply by the
// mask and leave -0.0 where a masked dot is negative; no edge reads that
// cell). The merge layout recovers each slot's row block by the Pallas
// kernel's fixed-trip bisection over blkptr, seeded at its tile's start
// row block. No atomics: two launches give the same bits. Slot and tile
// offsets are 64-bit (the dense-W table holds 3.4 G floats at
// Reddit-0.25). The launcher allocates nothing, does not synchronize,
// and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;       // warps per block, one slot each at a time
constexpr int kChunk = 32;      // F columns staged per step (one per lane)
constexpr int kStride = kChunk + 4;  // smem row stride: 16-B aligned, and
                                     // rows 4 banks apart (no conflicts)

enum Layout { kDense = 0, kRagged = 1, kMerge = 2 };

// Largest i with blkptr[i] <= s, seeded at lo (blkptr[lo] <= s): the
// Pallas kernels' _bisect_rowblk, n_iter fixed steps.
__device__ __forceinline__ long long bisect_rowblk(const int* __restrict__ blkptr,
                                                   long long s, long long lo,
                                                   long long hi, int n_iter) {
  for (int it = 0; it < n_iter; ++it) {
    const long long mid = (lo + hi) / 2;
    const bool go = hi - lo > 1;
    const bool le = blkptr[mid] <= s;
    if (go && le) lo = mid;
    if (go && !le) hi = mid;
  }
  return lo;
}

template <int RB, int BC, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_slots_kernel(const int* __restrict__ slot_rowblk,  // kRagged
                   const int* __restrict__ colblk,       // per slot, all modes
                   const int* __restrict__ blkptr,       // kMerge
                   const int* __restrict__ tile_rowblk,  // kMerge
                   long long width,                      // kDense: W
                   int tile_slots, long long n_row_blocks, int n_bisect,
                   const float* __restrict__ mask, const float* __restrict__ x,
                   const float* __restrict__ y, float* __restrict__ out,
                   long long n_slots, long long n_x_rows, long long n_y_rows, int F) {
  constexpr int kPer = RB * BC / 32;  // cells per lane
  constexpr int kRowStep = 32 / BC;   // rows between a lane's cells
  static_assert(RB * BC % 32 == 0 && 32 % BC == 0, "tile must split over a warp");
  __shared__ __align__(16) float xs_all[kWarps][RB * kStride];
  __shared__ __align__(16) float ys_all[kWarps][BC * kStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* xs = xs_all[warp];
  float* ys = ys_all[warp];
  const int c = lane % BC;
  const int r0 = lane / BC;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;

  for (long long s = static_cast<long long>(blockIdx.x) * kWarps + warp; s < n_slots;
       s += n_warps) {
    const float* mk = mask + s * (RB * BC);
    float* o = out + s * (RB * BC);
    float m[kPer];
    bool live = false;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      m[k] = mk[(r0 + k * kRowStep) * BC + c];
      live |= m[k] > 0.0f;
    }
    if (!__any_sync(0xffffffffu, live)) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) o[(r0 + k * kRowStep) * BC + c] = 0.0f;
      continue;
    }
    long long rb_i;
    if (MODE == kRagged) {
      rb_i = slot_rowblk[s];
    } else if (MODE == kDense) {
      rb_i = s / width;
    } else {
      rb_i = bisect_rowblk(blkptr, s, tile_rowblk[s / tile_slots], n_row_blocks, n_bisect);
    }
    const long long xrow0 = rb_i * RB;
    const long long yrow0 = static_cast<long long>(colblk[s]) * BC;
    float acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = 0.0f;
    for (int f0 = 0; f0 < F; f0 += kChunk) {
      const int nf = F - f0 < kChunk ? F - f0 : kChunk;
      const bool in = lane < nf;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const long long row = xrow0 + r;
        xs[r * kStride + lane] = in && row < n_x_rows ? __ldg(x + row * F + f0 + lane) : 0.0f;
      }
#pragma unroll
      for (int cc = 0; cc < BC; ++cc) {
        const long long row = yrow0 + cc;
        ys[cc * kStride + lane] = in && row < n_y_rows ? __ldg(y + row * F + f0 + lane) : 0.0f;
      }
      __syncwarp();
      const float* yr = ys + c * kStride;
      int j = 0;
      for (; j + 4 <= nf; j += 4) {
        const float4 yv = *reinterpret_cast<const float4*>(yr + j);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + (r0 + k * kRowStep) * kStride + j);
          acc[k] = fmaf(xv.x, yv.x, acc[k]);
          acc[k] = fmaf(xv.y, yv.y, acc[k]);
          acc[k] = fmaf(xv.z, yv.z, acc[k]);
          acc[k] = fmaf(xv.w, yv.w, acc[k]);
        }
      }
      for (; j < nf; ++j) {
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          acc[k] = fmaf(xs[(r0 + k * kRowStep) * kStride + j], yr[j], acc[k]);
      }
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      o[(r0 + k * kRowStep) * BC + c] = m[k] > 0.0f ? acc[k] * m[k] : 0.0f;
  }
}

template <int RB, int BC, int MODE>
cudaError_t launch(const int* slot_rowblk, const int* colblk, const int* blkptr,
                   const int* tile_rowblk, long long width, int tile_slots,
                   long long n_row_blocks, int n_bisect, const float* mask,
                   const float* x, const float* y, float* out, long long n_slots,
                   long long n_x_rows, long long n_y_rows, int F, cudaStream_t stream) {
  // one warp per slot at a time; the grid-stride loop covers the rest
  const long long want = (n_slots + kWarps - 1) / kWarps;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  sddmm_slots_kernel<RB, BC, MODE><<<blocks, kWarps * 32, 0, stream>>>(
      slot_rowblk, colblk, blkptr, tile_rowblk, width, tile_slots, n_row_blocks,
      n_bisect, mask, x, y, out, n_slots, n_x_rows, n_y_rows, F);
  return cudaGetLastError();
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
