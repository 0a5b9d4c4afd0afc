// Fused CSR attention kernels for Hopper (sm_90a): per row i,
// out_i = softmax_j(q_i . k_j * scale over the row's edges) . v, with the
// sparsity pattern in one of the 8x8 block layouts of sparse/bsr.py (a
// structural 0/1 mask per tile) and q, k, v, out dense fp32, row-major.
// fp32 FMA on the CUDA cores, expf (no fast math), no TF32: the 8x8
// tiles are below wgmma's M = 64 and the reference sums fp32 products.
//
// Replaces src/repro/kernels/attention_pallas.py:
//   attention_chunks_kernel (+ attention_combine_kernel), blkptr NULL
//       <- fused_csr_attention     (_fused_attn_kernel)
//   attention_chunks_kernel (+ attention_combine_kernel), blkptr
//       <- fused_ragged_attention  (_fused_ragged_attn_kernel)
//
// What bounds it on an H100. The function needs each layout array read
// once (the 256-byte mask tiles dominate: 5.1 GB ragged, 13.6 GB dense-W
// at Reddit-0.25), q, k, v read and out written once, and 4 * nnz * D
// FLOPs, so its floor is the bytes at 3.35 TB/s. A kernel that multiplies
// whole tiles re-gathers an 8 x D k tile and an 8 x D v tile per slot
// (16 KB at D = 256) for ~1.4 real edges a tile on Reddit-like graphs:
// ~320 GB of gathers at Reddit-0.25. These kernels compute the cells
// whose mask is > 0 only: each live cell (r, c) gathers its k row and its
// v row once (2 * D * 4 bytes through L2, ~57 GB for Reddit-0.25's
// 27.8 M edges at D = 256) and spends 2 * D FMAs spread over a warp. What
// is left above the byte floor is those row gathers, and for dense-W the
// stream of its dead slots' masks.
//
// Design. The work unit is a block of 8 warps per (row block, chunk of
// slots); warp r owns row r of the row block, so its running max m, sum
// l (warp-uniform registers) and accumulator row are its own, and no
// warp waits on another: no block barrier, no shared-memory softmax.
// Warp r keeps q row r and its accumulator row in shared memory, lane l
// touching only its own columns 4l + 128k + j (k = 0, 1, ..., j = 0..3),
// so each lane reads back what it wrote and no sync is needed; holding
// them in registers instead would cost 16 more registers a lane at
// D = 256 (fewer resident warps) and could not reach MAX_D. Per batch of
// 32 slots of its chunk:
//   1. lane t reads row r of slot t's mask tile (8 cells, two 16-byte
//      streaming loads) and the slot's colblk, one batch ahead of their
//      use; the 8 warps together read each tile once;
//   2. each lane folds its 8 cells into a byte of live bits (mask > 0),
//      and one __ballot_sync gives the batch's slots with a live cell in
//      row r: a warp skips every other slot (every padded dense-W slot,
//      the ragged dummy slot, and the slots whose edges are in other rows)
//      at the cost of its mask read;
//   3. for each live slot in order, the slot's bits and colblk come from
//      its lane by __shfl_sync, and for each live cell (r, c) in column
//      order the warp gathers k row colblk * 8 + c and, beside it, the
//      first 256 columns of v row colblk * 8 + c (the rest after the
//      softmax step for D > 256), computes q_r . k_c in one fixed order
//      (lane l's fmaf chain over its columns in (k, j) order from +0.0,
//      then a fixed xor butterfly, which leaves the same bits in every
//      lane), and runs the online-softmax step of the Pallas kernels on
//      that one logit: m_new = max(m, logit), m_safe = m_new while finite
//      else 0, p = exp(logit - m_safe), alpha = exp(m - m_safe) while m is
//      finite else 0, l = alpha * l + p, acc = acc * alpha + p * v_c.
// Masked cells are never computed, and their k and v rows never read: a
// row of v holding +-inf or NaN that a tile pairs only with masked cells
// leaves the output finite (the Pallas kernels give NaN there, 0 * inf).
// Rows of q, k, v past their ends read as zero.
//
// Chunks. Row blocks are split into chunks of chunk_slots slots counted
// from the row block's first slot, so a hub row block's chain of slots
// spreads over many warps. A row block whose slots fit one chunk writes
// out = acc / max(l, 1e-30) directly. Otherwise each chunk writes its
// rows' partial state (m, l, a live flag, and the accumulator row if the
// row had a live cell) to a workspace the wrapper allocates, and
// attention_combine_kernel folds each row's live chunks in chunk order:
// the first is taken as it is, each later one by the same guarded
// rescale as the online step (chunks without a live cell are left out),
// then out = acc / max(l, 1e-30). A row without edges gets +0.0.
// Why chunks: one chunk per row block leaves the hub rows' chains as the
// tail (at Reddit-0.25 a row block of 7,281 slots, a row of 52,755
// edges, each a dependent gather). chip_smoke.py phase 5 times both
// layouts in chunks of 256 slots (kernels/attention.py CHUNK_SLOTS) and
// unsplit on an NVIDIA H100 80GB HBM3 at 700 W (D = 256): ragged 21.16
// against 56.83 ms, dense-W 23.55 against 62.54 ms. Chunks of 64 to
// 1024 slots ran within a few per cent of each other in a sweep during
// bring-up; 256 needs a quarter of 64's workspace.
//
// Dense-W padding is trailing (sparse/bsr.py) and to_ragged keeps
// in-block slot order, so dense-W chunk c holds ragged chunk c's live
// slots followed by dead ones, and dense-W's extra chunks are dead: the
// same live cells meet the same code in the same order, and a row whose
// live cells fit one chunk takes the same division either way, so the
// two layouts give equal outputs bit for bit. No atomics: two launches
// give the same bits. Slot and tile offsets are 64-bit (the dense-W mask
// holds 3.4 G floats at Reddit-0.25). The launcher allocates nothing,
// does not synchronize, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a mask that is not 16-byte aligned).

#include <cstdint>

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kRB = 8;
constexpr int kBC = 8;
constexpr int kTile = kRB * kBC;
constexpr int kThreads = kRB * kWarp;          // warp r owns row r of the row block
constexpr int kLaneCols = 4;                   // feature columns per lane and chunk
constexpr int kChunkCols = kWarp * kLaneCols;  // feature columns per warp and chunk

// Columns f .. f + 3 of a row in global memory (0 past D): one float4
// (VEC) or four scalar loads.
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ row, int f, int D,
                                      float (&a)[kLaneCols]) {
  if constexpr (VEC) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + f));
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) a[j] = f + j < D ? __ldg(row + f + j) : 0.0f;
  }
}

// The same columns of a row this lane owns in shared memory (or writes
// to global memory): read and write.
template <bool VEC>
__device__ __forceinline__ void get4(const float* row, int f, int D, float (&a)[kLaneCols]) {
  if constexpr (VEC) {
    const float4 v = *reinterpret_cast<const float4*>(row + f);
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) a[j] = f + j < D ? row[f + j] : 0.0f;
  }
}

template <bool VEC>
__device__ __forceinline__ void put4(float* row, int f, int D, const float (&a)[kLaneCols]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(row + f) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j)
      if (f + j < D) row[f + j] = a[j];
  }
}

// Row r's 8 mask cells of one slot and the slot's colblk.
struct MaskRow {
  float4 lo, hi;
  int cb;
};

__device__ __forceinline__ MaskRow load_mask_row(const float* __restrict__ mask,
                                                 const int* __restrict__ colblk, long long s,
                                                 long long end, int r) {
  MaskRow m;
  if (s < end) {
    const float4* p = reinterpret_cast<const float4*>(mask + s * kTile + r * kBC);
    m.lo = __ldcs(p);
    m.hi = __ldcs(p + 1);
    m.cb = __ldg(colblk + s);
  } else {
    m.lo = m.hi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    m.cb = 0;
  }
  return m;
}

__device__ __forceinline__ unsigned live_bits(const MaskRow& m) {
  return static_cast<unsigned>(m.lo.x > 0.0f) | static_cast<unsigned>(m.lo.y > 0.0f) << 1 |
         static_cast<unsigned>(m.lo.z > 0.0f) << 2 | static_cast<unsigned>(m.lo.w > 0.0f) << 3 |
         static_cast<unsigned>(m.hi.x > 0.0f) << 4 | static_cast<unsigned>(m.hi.y > 0.0f) << 5 |
         static_cast<unsigned>(m.hi.z > 0.0f) << 6 | static_cast<unsigned>(m.hi.w > 0.0f) << 7;
}

// One live cell (this warp's row, key/value row j): the logit, the
// online-softmax step on (m, l) and acc_s = acc_s * alpha + p * v_j.
// Called by the whole warp; every branch is warp-uniform.
template <bool VEC>
__device__ __forceinline__ void attend_cell(const float* __restrict__ k,
                                            const float* __restrict__ v, long long j,
                                            long long n_kv_rows, const float* q_s,
                                            float* acc_s, int D, int lane, float scale,
                                            float& m, float& l) {
  const bool in = j < n_kv_rows;
  const float* kr = k + j * D;
  const float* vr = v + j * D;
  const int f0 = kLaneCols * lane;
  // v's first two column chunks, loaded beside k's
  float v0[2][kLaneCols] = {};
  float dot = 0.0f;
  for (int f = f0; f < D; f += 2 * kChunkCols) {
    const bool two = f + kChunkCols < D;
    float a[2][kLaneCols] = {}, b[2][kLaneCols];
    if (in) {
      load4<VEC>(kr, f, D, a[0]);
      if (two) load4<VEC>(kr, f + kChunkCols, D, a[1]);
      if (f == f0) {
        load4<VEC>(vr, f, D, v0[0]);
        if (two) load4<VEC>(vr, f + kChunkCols, D, v0[1]);
      }
    }
    get4<VEC>(q_s, f, D, b[0]);
#pragma unroll
    for (int t = 0; t < kLaneCols; ++t) dot = fmaf(b[0][t], a[0][t], dot);
    if (two) {
      get4<VEC>(q_s, f + kChunkCols, D, b[1]);
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t) dot = fmaf(b[1][t], a[1][t], dot);
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);

  const float logit = dot * scale;
  const float m_new = fmaxf(m, logit);
  const float m_safe = isfinite(m_new) ? m_new : 0.0f;
  const float p = expf(logit - m_safe);
  const float alpha = isfinite(m) ? expf(m - m_safe) : 0.0f;
  l = fmaf(alpha, l, p);
  m = m_new;

  for (int f = f0; f < D; f += 2 * kChunkCols) {
    const bool two = f + kChunkCols < D;
    float vv[2][kLaneCols] = {};
    if (f == f0) {
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t) {
        vv[0][t] = v0[0][t];
        vv[1][t] = v0[1][t];
      }
    } else if (in) {
      load4<VEC>(vr, f, D, vv[0]);
      if (two) load4<VEC>(vr, f + kChunkCols, D, vv[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !two) break;
      const int fh = f + h * kChunkCols;
      float acc[kLaneCols];
      get4<VEC>(acc_s, fh, D, acc);
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t) acc[t] = fmaf(p, vv[h][t], acc[t] * alpha);
      put4<VEC>(acc_s, fh, D, acc);
    }
  }
}

// Block b's row block i, chunk c, the row block's chunk count and the
// chunk's workspace entry (-1 when the row block has one chunk).
struct Chunk {
  long long i, c, n_ch, s_row, s_end, w;
};

__device__ __forceinline__ long long dense_chunks(long long width, int chunk_slots) {
  const long long n = (width + chunk_slots - 1) / chunk_slots;
  return n > 0 ? n : 1;
}

// Resident blocks per SM the register allocation must leave room for:
// 4 caps a lane at 64 registers (32 warps per SM, a few bytes of spills).
// Each warp has one live cell's k and v gathers in flight, so resident
// warps hide their latency; builds capped at 3 or 5 blocks, or not
// capped, ran slower on an NVIDIA H100 80GB HBM3 at 700 W (ragged,
// Reddit-0.25, D = 256). Gathering a second live cell's rows beside the
// first's took 80-112 registers and gained nothing.
constexpr int kMinBlocks = 4;

template <bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attention_chunks_kernel(const int* __restrict__ blkptr,     // ragged: (nrb + 1,)
                        const int* __restrict__ chunk_ptr,  // ragged: (nrb + 1,)
                        const int* __restrict__ ws_ptr,     // ragged: (nrb + 1,)
                        long long width,                    // dense-W: W
                        long long n_row_blocks, int chunk_slots,
                        const int* __restrict__ colblk, const float* __restrict__ mask,
                        const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ ws_state, float* __restrict__ ws_acc,
                        long long n_q_rows, long long n_kv_rows, int D, long long n_out_rows,
                        float scale) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int r = threadIdx.x / kWarp;
  const long long b = blockIdx.x;
  Chunk ch;
  if (blkptr != nullptr) {
    if (b >= __ldg(chunk_ptr + n_row_blocks)) return;  // past the last chunk
    long long lo = 0, hi = n_row_blocks;  // largest i with chunk_ptr[i] <= b
    while (hi - lo > 1) {
      const long long mid = (lo + hi) / 2;
      if (__ldg(chunk_ptr + mid) <= b) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const long long c0 = __ldg(chunk_ptr + lo);
    ch.i = lo;
    ch.c = b - c0;
    ch.n_ch = __ldg(chunk_ptr + lo + 1) - c0;
    ch.s_row = __ldg(blkptr + lo);
    ch.s_end = __ldg(blkptr + lo + 1);
    ch.w = ch.n_ch > 1 ? __ldg(ws_ptr + lo) + ch.c : -1;
  } else {
    ch.n_ch = dense_chunks(width, chunk_slots);
    ch.i = b / ch.n_ch;
    ch.c = b - ch.i * ch.n_ch;
    ch.s_row = ch.i * width;
    ch.s_end = ch.s_row + width;
    ch.w = ch.n_ch > 1 ? b : -1;
  }
  const long long s0 = ch.s_row + ch.c * chunk_slots;
  const long long s1 = s0 + chunk_slots < ch.s_end ? s0 + chunk_slots : ch.s_end;

  float* q_s = smem + 2 * r * D;
  float* acc_s = q_s + D;
  const long long row = ch.i * kRB + r;
  const int f0 = kLaneCols * lane;
  for (int f = f0; f < D; f += kChunkCols) {
    float a[kLaneCols] = {};
    if (row < n_q_rows) load4<VEC>(q + row * D, f, D, a);
    put4<VEC>(q_s, f, D, a);
    const float z[kLaneCols] = {};
    put4<VEC>(acc_s, f, D, z);
  }

  float m = -INFINITY, l = 0.0f;
  bool seen = false;  // a live cell in this row and chunk
  MaskRow next = load_mask_row(mask, colblk, s0 + lane, s1, r);
  for (long long sb = s0; sb < s1; sb += kWarp) {
    const MaskRow cur = next;
    if (sb + kWarp < s1) next = load_mask_row(mask, colblk, sb + kWarp + lane, s1, r);
    const unsigned bits = live_bits(cur);
    unsigned slots = __ballot_sync(kFull, bits != 0u);
    seen |= slots != 0u;
    while (slots) {
      const int t = __ffs(static_cast<int>(slots)) - 1;  // the slot's lane
      slots &= slots - 1u;
      unsigned cells = __shfl_sync(kFull, bits, t);
      const long long kv0 = static_cast<long long>(__shfl_sync(kFull, cur.cb, t)) * kBC;
      while (cells) {
        const int cc = __ffs(static_cast<int>(cells)) - 1;
        cells &= cells - 1u;
        attend_cell<VEC>(k, v, kv0 + cc, n_kv_rows, q_s, acc_s, D, lane, scale, m, l);
      }
    }
  }

  if (ch.w < 0) {
    if (row >= n_out_rows) return;
    const float den = fmaxf(l, 1e-30f);
    for (int f = f0; f < D; f += kChunkCols) {
      float a[kLaneCols];
      get4<VEC>(acc_s, f, D, a);
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t) a[t] = a[t] / den;
      put4<VEC>(out + row * D, f, D, a);
    }
    return;
  }
  const long long e = ch.w * kRB + r;  // this row's workspace entry
  if (lane == 0)
    reinterpret_cast<float4*>(ws_state)[e] = make_float4(m, l, seen ? 1.0f : 0.0f, 0.0f);
  if (!seen) return;
  for (int f = f0; f < D; f += kChunkCols) {
    float a[kLaneCols];
    get4<VEC>(acc_s, f, D, a);
    put4<VEC>(ws_acc + e * D, f, D, a);
  }
}

// Rows of row blocks split into several chunks: fold the chunks' partial
// states in chunk order, then divide. Warp r owns row r; lane l its
// columns 4l + 128k + j, each group of 4 folded on its own (the m and l
// fold is recomputed per group, with the same bits).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
attention_combine_kernel(const int* __restrict__ chunk_ptr,  // ragged
                         const int* __restrict__ ws_ptr,     // ragged
                         long long width, int chunk_slots,   // dense-W
                         const float* __restrict__ ws_state, const float* __restrict__ ws_acc,
                         float* __restrict__ out, int D, long long n_out_rows) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int r = threadIdx.x / kWarp;
  const long long i = blockIdx.x;
  long long n_ch, w0;
  if (chunk_ptr != nullptr) {
    n_ch = __ldg(chunk_ptr + i + 1) - __ldg(chunk_ptr + i);
    if (n_ch <= 1) return;  // written by its chunk
    w0 = __ldg(ws_ptr + i);
  } else {
    n_ch = dense_chunks(width, chunk_slots);
    w0 = i * n_ch;
  }
  const long long row = i * kRB + r;
  if (row >= n_out_rows) return;
  const float4* state = reinterpret_cast<const float4*>(ws_state);
  for (int f = kLaneCols * lane; f < D; f += kChunkCols) {
    float m = -INFINITY, l = 0.0f, acc[kLaneCols] = {};
    bool first = true;
    for (long long c = 0; c < n_ch; ++c) {
      const long long e = (w0 + c) * kRB + r;
      const float4 st = __ldg(state + e);
      if (st.z == 0.0f) continue;  // no live cell in this row and chunk
      float a[kLaneCols];
      load4<VEC>(ws_acc + e * D, f, D, a);
      if (first) {
        m = st.x;
        l = st.y;
#pragma unroll
        for (int t = 0; t < kLaneCols; ++t) acc[t] = a[t];
        first = false;
        continue;
      }
      const float m_new = fmaxf(m, st.x);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float ea = isfinite(m) ? expf(m - m_safe) : 0.0f;
      const float eb = isfinite(st.x) ? expf(st.x - m_safe) : 0.0f;
      l = fmaf(ea, l, eb * st.y);
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t) acc[t] = fmaf(ea, acc[t], eb * a[t]);
      m = m_new;
    }
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int t = 0; t < kLaneCols; ++t) acc[t] = acc[t] / den;
    put4<VEC>(out + row * D, f, D, acc);
  }
}

template <bool VEC>
cudaError_t launch(const int* blkptr, const int* chunk_ptr, const int* ws_ptr, long long width,
                   long long n_row_blocks, long long n_blocks, int chunk_slots,
                   const int* colblk, const float* mask, const float* q, const float* k,
                   const float* v, float* out, float* ws_state, float* ws_acc,
                   long long n_q_rows, long long n_kv_rows, int D, long long n_out_rows,
                   float scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kRB) * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_chunks_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  attention_chunks_kernel<VEC><<<static_cast<unsigned>(n_blocks), kThreads, smem, stream>>>(
      blkptr, chunk_ptr, ws_ptr, width, n_row_blocks, chunk_slots, colblk, mask, q, k, v, out,
      ws_state, ws_acc, n_q_rows, n_kv_rows, D, n_out_rows, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws_state == nullptr) return err;
  attention_combine_kernel<VEC><<<static_cast<unsigned>(n_row_blocks), kThreads, 0, stream>>>(
      chunk_ptr, ws_ptr, width, chunk_slots, ws_state, ws_acc, out, D, n_out_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ragged (blkptr, chunk_ptr and ws_ptr != NULL; width ignored) or dense-W
// (blkptr == NULL) fused attention over 8x8 tiles: n_blocks chunk blocks
// (ragged: at least chunk_ptr[n_row_blocks]; the rest exit at once),
// then, when ws_state != NULL, the combine over the workspace.
int autosage_attention(const void* blkptr, const void* chunk_ptr, const void* ws_ptr,
                       long long width, const void* colblk, const void* mask, const void* q,
                       const void* k, const void* v, void* out, void* ws_state, void* ws_acc,
                       long long n_row_blocks, long long n_blocks, int chunk_slots,
                       long long n_q_rows, long long n_kv_rows, int D, long long n_out_rows,
                       float scale, void* stream) {
  if (reinterpret_cast<uintptr_t>(mask) % 16 || chunk_slots <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % kLaneCols == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ws_acc) % 16 == 0;
  cudaError_t (*run)(const int*, const int*, const int*, long long, long long, long long, int,
                     const int*, const float*, const float*, const float*, const float*,
                     float*, float*, float*, long long, long long, int, long long, float,
                     cudaStream_t) = vec ? launch<true> : launch<false>;
  return static_cast<int>(run(
      static_cast<const int*>(blkptr), static_cast<const int*>(chunk_ptr),
      static_cast<const int*>(ws_ptr), width, n_row_blocks, n_blocks, chunk_slots,
      static_cast<const int*>(colblk), static_cast<const float*>(mask),
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(ws_state), static_cast<float*>(ws_acc),
      n_q_rows, n_kv_rows, D, n_out_rows, scale, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
