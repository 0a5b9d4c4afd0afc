// Block-ELL SpMM kernels for Hopper (sm_90a): C = A @ B, A in one of the
// block layouts of sparse/bsr.py and sparse/merge.py, B and C dense fp32,
// row-major. fp32 FMA on the CUDA cores: the rb x bc micro-tiles (8x8,
// 16x8, 8x16) are below wgmma's M = 64, and TF32 would depart from the
// reference's fp32 products.
//
// Replaces src/repro/kernels/spmm_pallas.py:
//   spmm_rows_kernel, width == 0  <- spmm_ragged_ell (_spmm_ragged_kernel)
//   spmm_rows_kernel, width  > 0  <- spmm_block_ell  (_spmm_kernel)
//   spmm_merge_kernel + fixup     <- spmm_merge_path (_spmm_merge_kernel)
//
// What bounds them on an H100: the product itself needs only 2*nnz*F
// FLOPs, so its floor is the bytes of the layout (each value tile read
// once, 3.35 TB/s HBM). The layout adds work on top of that floor: every
// slot costs rb*bc*F FMAs on a padded micro-tile that holds few real
// nonzeros on GNN graphs (~1.4 of 64 on Reddit-like graphs at 8x8), and
// those FMAs at 67 TFLOP/s fp32 take longer than the tile bytes, while
// each slot re-gathers bc rows of B from L2. The design keeps every FMA
// in registers: a thread owns one feature column and holds rb
// accumulators, a block stages
// kChunk slots' tiles and column-block ids in shared memory with one
// barrier pair per chunk, and each B row is read coalesced along F.
//
// All three kernels run the same per-slot, per-c fmaf order (fma_slot),
// so dense-W and ragged agree bit for bit: dense-W's padded slots add
// exact zeros. Merge-path splits the slot stream into equal runs of
// tiles, one run per block; a row that straddles runs is summed in a
// second pass (carry + fixup), so its summation order differs from
// ragged's and merge-path is held to a tolerance, not to bit identity.
// Nothing uses float atomics, so two launches give the same bits.
//
// Value tiles are indexed with 64-bit offsets (dense-W at Reddit scale
// holds more than 2^31 floats). B rows past n_b_rows read as zero, so
// callers pass B unpadded; output rows past n_out_rows are not written.
// The launchers allocate nothing and do not synchronize; each returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;  // slots staged in shared memory at a time

template <int RB, int BC>
__device__ __forceinline__ void stage_slots(const float* __restrict__ vals,
                                            const int* __restrict__ colblk,
                                            long long first, int n,
                                            float* vals_sm, int* cb_sm) {
  const float* src = vals + first * (RB * BC);
  for (int k = threadIdx.x; k < n * RB * BC; k += blockDim.x) vals_sm[k] = src[k];
  for (int k = threadIdx.x; k < n; k += blockDim.x) cb_sm[k] = colblk[first + k];
}

template <int RB, int BC>
__device__ __forceinline__ void fma_slot(const float* v, int cb,
                                         const float* __restrict__ b,
                                         long long n_b_rows, int F, int f,
                                         float (&acc)[RB]) {
  const long long row0 = static_cast<long long>(cb) * BC;
#pragma unroll
  for (int c = 0; c < BC; ++c) {
    const long long row = row0 + c;
    const float bv = row < n_b_rows ? __ldg(b + row * F + f) : 0.0f;
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = fmaf(v[r * BC + c], bv, acc[r]);
  }
}

template <int RB>
__device__ __forceinline__ void store_rows(float* __restrict__ out, long long row0,
                                           long long n_out_rows, int F, int f,
                                           const float (&acc)[RB]) {
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (row0 + r < n_out_rows) out[(row0 + r) * F + f] = acc[r];
}

// One block per (row block, feature tile). Ragged: the row block's slots
// are blkptr[i]..blkptr[i+1]. Dense-W (blkptr == nullptr): i*width ..
// (i+1)*width, padded slots included.
template <int RB, int BC>
__global__ void __launch_bounds__(256)
spmm_rows_kernel(const int* __restrict__ blkptr, int width,
                 const int* __restrict__ colblk, const float* __restrict__ vals,
                 const float* __restrict__ b, float* __restrict__ out,
                 long long n_b_rows, int F, long long n_out_rows) {
  __shared__ float vals_sm[kChunk * RB * BC];
  __shared__ int cb_sm[kChunk];
  const long long i = blockIdx.x;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = f < F;
  long long s0, s1;
  if (blkptr != nullptr) {
    s0 = blkptr[i];
    s1 = blkptr[i + 1];
  } else {
    s0 = i * width;
    s1 = s0 + width;
  }
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
  for (long long base = s0; base < s1; base += kChunk) {
    const int n = static_cast<int>(s1 - base < kChunk ? s1 - base : kChunk);
    stage_slots<RB, BC>(vals, colblk, base, n, vals_sm, cb_sm);
    __syncthreads();
    if (active)
      for (int k = 0; k < n; ++k)
        fma_slot<RB, BC>(vals_sm + k * RB * BC, cb_sm[k], b, n_b_rows, F, f, acc);
    __syncthreads();
  }
  if (active) store_rows<RB>(out, i * RB, n_out_rows, F, f, acc);
}

// One block per (run of tiles_per_block merge tiles, feature tile). The
// block walks its slots in order, starting at its first tile's row block
// and stepping to the next row block whenever a slot reaches blkptr[i+1]
// (every row block owns >= 1 slot, so one step at a time). A row that
// starts inside the run is written straight to `out`; the run's first
// row, when the first tile starts mid-row (tile_offset > 0), goes to
// carry[blockIdx.x] instead. Tail padding (slots >= n_slots) is skipped.
template <int RB, int BC>
__global__ void __launch_bounds__(256)
spmm_merge_kernel(const int* __restrict__ blkptr, const int* __restrict__ colblk,
                  const float* __restrict__ vals, const int* __restrict__ tile_rowblk,
                  const int* __restrict__ tile_offset, int tile_slots,
                  int tiles_per_block, long long n_slots,
                  const float* __restrict__ b, float* __restrict__ out,
                  float* __restrict__ carry, long long n_b_rows, int F,
                  long long n_out_rows) {
  __shared__ float vals_sm[kChunk * RB * BC];
  __shared__ int cb_sm[kChunk];
  const long long blk = blockIdx.x;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = f < F;
  const long long t0 = blk * tiles_per_block;
  const long long s_begin = t0 * tile_slots;
  const long long s_stop = s_begin + static_cast<long long>(tiles_per_block) * tile_slots;
  const long long s_end = s_stop < n_slots ? s_stop : n_slots;
  long long i = tile_rowblk[t0];
  long long row_end = blkptr[i + 1];
  bool to_carry = tile_offset[t0] > 0;
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
  for (long long base = s_begin; base < s_end; base += kChunk) {
    const int n = static_cast<int>(s_end - base < kChunk ? s_end - base : kChunk);
    stage_slots<RB, BC>(vals, colblk, base, n, vals_sm, cb_sm);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      while (base + k >= row_end) {  // slot opens the next row block
        if (active) {
          if (to_carry) {
#pragma unroll
            for (int r = 0; r < RB; ++r) carry[(blk * RB + r) * F + f] = acc[r];
          } else {
            store_rows<RB>(out, i * RB, n_out_rows, F, f, acc);
          }
        }
        to_carry = false;
        ++i;
        row_end = blkptr[i + 1];
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
      }
      if (active)
        fma_slot<RB, BC>(vals_sm + k * RB * BC, cb_sm[k], b, n_b_rows, F, f, acc);
    }
    __syncthreads();
  }
  if (active) {
    if (to_carry) {
#pragma unroll
      for (int r = 0; r < RB; ++r) carry[(blk * RB + r) * F + f] = acc[r];
    } else {
      store_rows<RB>(out, i * RB, n_out_rows, F, f, acc);
    }
  }
}

// Deterministic carry fixup: the first block of each chain of runs that
// continue one row ("leader") adds the chain's carries to that row in run
// order. Rows never take two fixups at once and no atomics are used.
template <int RB>
__global__ void __launch_bounds__(256)
spmm_merge_fixup_kernel(const int* __restrict__ tile_rowblk,
                        const int* __restrict__ tile_offset, int tiles_per_block,
                        int n_blocks, const float* __restrict__ carry,
                        float* __restrict__ out, int F, long long n_out_rows) {
  const long long blk = blockIdx.x;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const long long t0 = blk * tiles_per_block;
  if (tile_offset[t0] == 0) return;
  const int row = tile_rowblk[t0];
  if (blk > 0) {
    const long long tp = t0 - tiles_per_block;
    if (tile_offset[tp] > 0 && tile_rowblk[tp] == row) return;  // not the leader
  }
  const long long row0 = static_cast<long long>(row) * RB;
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = row0 + r < n_out_rows ? out[(row0 + r) * F + f] : 0.0f;
  for (long long c = blk; c < n_blocks; ++c) {
    const long long tc = c * tiles_per_block;
    if (c > blk && (tile_offset[tc] == 0 || tile_rowblk[tc] != row)) break;
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] += carry[(c * RB + r) * F + f];
  }
  store_rows<RB>(out, row0, n_out_rows, F, f, acc);
}

template <int RB, int BC>
cudaError_t launch_rows(const int* blkptr, int width, const int* colblk,
                        const float* vals, const float* b, float* out,
                        long long n_row_blocks, long long n_b_rows, int F,
                        long long n_out_rows, int threads, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_row_blocks), (F + threads - 1) / threads);
  spmm_rows_kernel<RB, BC><<<grid, threads, 0, stream>>>(
      blkptr, width, colblk, vals, b, out, n_b_rows, F, n_out_rows);
  return cudaGetLastError();
}

template <int RB, int BC>
cudaError_t launch_merge(const int* blkptr, const int* colblk, const float* vals,
                         const int* tile_rowblk, const int* tile_offset,
                         int tile_slots, int tiles_per_block, int n_blocks,
                         long long n_slots, const float* b, float* out, float* carry,
                         long long n_b_rows, int F, long long n_out_rows,
                         int threads, cudaStream_t stream) {
  const dim3 grid(n_blocks, (F + threads - 1) / threads);
  spmm_merge_kernel<RB, BC><<<grid, threads, 0, stream>>>(
      blkptr, colblk, vals, tile_rowblk, tile_offset, tile_slots, tiles_per_block,
      n_slots, b, out, carry, n_b_rows, F, n_out_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spmm_merge_fixup_kernel<RB><<<grid, threads, 0, stream>>>(
      tile_rowblk, tile_offset, tiles_per_block, n_blocks, carry, out, F, n_out_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ragged (blkptr != NULL, width ignored) or dense-W (blkptr == NULL) SpMM.
int autosage_spmm_rows(const void* blkptr, int width, const void* colblk,
                       const void* vals, const void* b, void* out,
                       long long n_row_blocks, int rb, int bc, long long n_b_rows,
                       int F, long long n_out_rows, int threads, void* stream) {
  const int* bp = static_cast<const int*>(blkptr);
  const int* cb = static_cast<const int*>(colblk);
  const float* v = static_cast<const float*>(vals);
  const float* bb = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rb == 8 && bc == 8)
    return launch_rows<8, 8>(bp, width, cb, v, bb, o, n_row_blocks, n_b_rows, F, n_out_rows, threads, s);
  if (rb == 16 && bc == 8)
    return launch_rows<16, 8>(bp, width, cb, v, bb, o, n_row_blocks, n_b_rows, F, n_out_rows, threads, s);
  if (rb == 8 && bc == 16)
    return launch_rows<8, 16>(bp, width, cb, v, bb, o, n_row_blocks, n_b_rows, F, n_out_rows, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Merge-path SpMM: main pass plus carry fixup, both on `stream`.
int autosage_spmm_merge(const void* blkptr, const void* colblk, const void* vals,
                        const void* tile_rowblk, const void* tile_offset,
                        int tile_slots, int tiles_per_block, int n_blocks,
                        long long n_slots, const void* b, void* out, void* carry,
                        int rb, int bc, long long n_b_rows, int F,
                        long long n_out_rows, int threads, void* stream) {
  if (rb != 8 || bc != 8) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_merge<8, 8>(
      static_cast<const int*>(blkptr), static_cast<const int*>(colblk),
      static_cast<const float*>(vals), static_cast<const int*>(tile_rowblk),
      static_cast<const int*>(tile_offset), tile_slots, tiles_per_block, n_blocks,
      n_slots, static_cast<const float*>(b), static_cast<float*>(out),
      static_cast<float*>(carry), n_b_rows, F, n_out_rows, threads,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
