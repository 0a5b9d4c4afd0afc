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
//
// Grouped kernel (gqa_attention_chunks_kernel + gqa_attention_combine_
// kernel; no TPU kernel: the Pallas kernels take one head). Grouped-query
// attention over a band: q (n, H, D), k and v (n, Hkv, D), query head h
// reading KV head h / G, G = H / Hkv, every head over the same pattern.
// The kernels above, launched once a head, gather each live cell's k and v
// rows for one row and one head; on a sliding window's causal band the 8
// rows of a row block share nearly all of their ~1,024 columns and the G
// query heads of a KV head share k and v, so each k and v row was read
// 8 * G times a row block (64 at Mellum2's GQA 32/4), in G launches of
// dependent per-cell steps. The work is a small matrix product per slot.
// What bounds it on an H100: 4 * nnz * D * H FLOPs (128.9 GFLOP for the
// band of 8,192 rows, window 1,024, D 128, 32 heads: 1.92 ms at 67
// TFLOP/s fp32), against ~302 MB of q, k, v and out and ~32 MB of mask
// tiles (0.10 ms at 3.35 TB/s): FLOP-bound, on the CUDA cores
// (fp32 FMA, expf, no TF32, no fast math, as above).
//
// Design. A block of GT warps (GT = 8, 4, 2 or 1, the largest dividing G)
// works one (row block chunk, KV head, group of GT of its query heads);
// warp w owns query head w of the group, its half-warps rows 0-3 and 4-7
// of the row block, lane cg of each half key columns cg and cg + 16 of a
// batch and value columns 4cg + 64jj .. + 3. The block stages its 8 * GT q
// rows in shared memory once. It scans its chunk's mask tiles (256 slots
// at a time, one thread a tile) into 64 live bits a slot and keeps the
// slots with a live cell, in order (dense-W's padded slots and the ragged
// dummy slot drop out here). Then, per batch of 4 kept slots (32 key
// columns), double-buffered with cp.async: the batch's k and v rows (8 a
// slot) land in shared memory once for all 8 * GT rows, zeros for a column
// no row of the block has live and for rows past n_kv; each lane computes
// its 4 rows x 2 columns of logits from shared memory (q . k in d order),
// masked cells -inf by their live bits; the online-softmax step is taken
// per row over the batch's 32 columns (the row max by a 16-lane butterfly,
// then the guarded rescale of the kernels above: m_safe, alpha = 0 while m
// is -inf), p goes to the warp's rows of a shared tile, and each lane
// updates its 4 x 4DC accumulators in registers, acc = acc * alpha + sum_c
// p_c v_c in column order. Where a lane's rows do not have all 32 columns
// of the batch live (the band's diagonal and window-edge tiles, a batch's
// missing slots), each row skips the columns it does not have live, so a v
// row holding +-inf or NaN that another row reads never meets a p of 0 (0
// * inf is NaN): masked cells reach no sum, as in the kernels above. l is
// kept per lane and summed over the 16 lanes at the end. The chunks, their
// workspace ((entry, head, row) states and accumulators) and the combine's
// fold are those of the kernels above, per head; a row's live flag is its
// live bits over the chunk, shared by all heads. The same kept slots in
// the same order meet the same code under either layout, so ragged and
// dense-W outputs are equal bit for bit, and no atomics make two launches
// equal. Outputs differ from the per-head kernel's by the order of the
// sums alone. q, k and v come with their row and head strides, so the
// (B*S, heads, D) views of a model's projections go in uncopied. D <= 256
// (registers: 4 * 4 * DC accumulators a lane, DC = 1, 2, 4 for D <= 64,
// 128, 256); shared memory is ~110 KB at D = 128 and G = 8, two blocks an
// SM. On the band (G = 8, Hkv = 4, D = 128, NVIDIA H100 80GB HBM3, 700 W)
// one launch takes 6.3-6.5 ms for all 32 heads against 59.2-62.0 ms for 32
// launches of the kernels above (9.4-9.6x), ~30 % of its FLOP bound. At
// G = 1 a block is one warp and the kernel is 54-70x slower than the
// kernels above on scattered low-degree rows (D 256: 954 against 13.5 ms
// on an ogbn-products-shaped graph of 306,128 rows, 1,242 against 20.4 ms
// on Reddit-0.25), so a 2-D q keeps the kernels above.

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


// ------------------------------------------------------ grouped (GQA)
// q (n_q, H, D) and k, v (n_kv, Hkv, D), query head h reading KV head
// h / (H / Hkv); out (n_out, H, D). One block per (chunk, KV head, group
// of GT query heads of that KV head), one warp per query head: the
// header's "Grouped kernel" says why and how.

using u64 = unsigned long long;

constexpr int kNS = 4;              // live slots a batch
constexpr int kNC = kNS * kBC;      // key columns a batch
constexpr int kSeg = 256;           // slots a scan of the chunk's masks covers
constexpr int kHalf = kWarp / 2;    // lanes that share a row group
constexpr int kRows = kRB / 2;      // rows a lane owns
constexpr int kPS = kNC + 4;        // row stride of the probabilities in shared memory

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Piece u of a row of D floats (16 bytes when VEC, else one float) from
// src to dst in shared memory, zeros where !valid (read from nowhere:
// the copy is given the readable address base instead of src).
template <bool VEC>
__device__ __forceinline__ void stage_piece(float* dst, const float* src, int u, bool valid,
                                            const float* base) {
  if constexpr (VEC) {
    cp_async16(dst + 4 * u, valid ? src + 4 * u : base, valid);
  } else {
    cp_async4(dst + u, valid ? src + u : base, valid);
  }
}

// Columns of a slot's tile with a live cell in any of its 8 rows.
__device__ __forceinline__ unsigned live_columns(u64 bits) {
  bits |= bits >> 32;
  bits |= bits >> 16;
  bits |= bits >> 8;
  return static_cast<unsigned>(bits) & 0xffu;
}

// acc += p . v over a batch's kNC columns in order, for a lane's rows
// m0 .. m0 + 3 and value columns 4cg + 64jj .. + 3. With LIVE_ONLY a
// row skips the columns its live bits rl leave out: a staged v row that
// another row of the block reads may hold +-inf or NaN, and 0 * inf is
// NaN. For finite v both forms give the same sums.
template <int DC, bool LIVE_ONLY>
__device__ __forceinline__ void pv_update(float (&acc)[kRows][DC][4], const float* p_s,
                                          const float* v_b, int m0, int cg, int D4, int KS,
                                          const unsigned (&rl)[kRows]) {
  for (int c = 0; c < kNC; c += 4) {
    float4 pr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      pr[i] = *reinterpret_cast<const float4*>(p_s + (m0 + i) * kPS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int col = 4 * cg + 64 * jj;
        if (col >= D4) continue;
        const float4 vv = *reinterpret_cast<const float4*>(v_b + (c + cc) * KS + col);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (LIVE_ONLY && !(rl[i] >> (c + cc) & 1u)) continue;
          const float p = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
          acc[i][jj][0] = fmaf(p, vv.x, acc[i][jj][0]);
          acc[i][jj][1] = fmaf(p, vv.y, acc[i][jj][1]);
          acc[i][jj][2] = fmaf(p, vv.z, acc[i][jj][2]);
          acc[i][jj][3] = fmaf(p, vv.w, acc[i][jj][3]);
        }
      }
    }
  }
}

template <int DC, bool VEC>
__global__ void __launch_bounds__(kThreads, DC <= 2 ? 2 : 1)
gqa_attention_chunks_kernel(const int* __restrict__ blkptr,     // ragged: (nrb + 1,)
                            const int* __restrict__ chunk_ptr,  // ragged: (nrb + 1,)
                            const int* __restrict__ ws_ptr,     // ragged: (nrb + 1,)
                            long long width,                    // dense-W: W
                            long long n_row_blocks, int chunk_slots,
                            const int* __restrict__ colblk, const float* __restrict__ mask,
                            const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out,
                            float* __restrict__ ws_state, float* __restrict__ ws_acc,
                            long long n_q_rows, long long n_kv_rows, int D,
                            long long n_out_rows, float scale, int H, int G,
                            long long sq, long long sqh, long long sk, long long skh,
                            long long sv, long long svh) {
  extern __shared__ __align__(16) float smem[];
  const int GT = blockDim.x / kWarp;  // query heads of this block, one a warp
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int half = lane / kHalf;  // rows half*4 .. half*4 + 3 of the row block
  const int cg = lane % kHalf;    // key columns cg, cg + 16; value columns 4cg + 64jj ..
  const int groups = G / GT;
  const int j = blockIdx.y / groups;                      // the KV head
  const int h0 = j * G + (blockIdx.y % groups) * GT;      // the block's first query head
  const int h = h0 + warp;                                // this warp's query head
  const long long b = blockIdx.x;
  Chunk ch;
  if (blkptr != nullptr) {
    if (b >= __ldg(chunk_ptr + n_row_blocks)) return;  // past the last chunk
    long long lo = 0, hi = n_row_blocks;
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

  const int D4 = (D + 3) & ~3;
  const int KS = D4 + 4;  // row stride of the k and v tiles (16-byte bank shift)
  const int U = VEC ? D4 / 4 : D;  // pieces a row
  float* q_s = smem;                               // [GT * 8][D4]
  float* kv_s = q_s + GT * kRB * D4;               // [2 buffers][k, v][kNC][KS]
  float* p_s = kv_s + 4 * kNC * KS;                // [GT * 8][kPS]
  u64* seg_bits = reinterpret_cast<u64*>(p_s + GT * kRB * kPS);  // [kSeg]
  int* seg_cb = reinterpret_cast<int*>(seg_bits + kSeg);        // [kSeg]
  int* n_live_s = seg_cb + kSeg;

  if (!VEC && D4 > D) {  // columns D .. D4 - 1 read as zero; no copy writes them
    for (int t = threadIdx.x; t < GT * kRB + 4 * kNC; t += blockDim.x) {
      float* row = t < GT * kRB ? q_s + t * D4 : kv_s + (t - GT * kRB) * KS;
      for (int f = D; f < D4; ++f) row[f] = 0.0f;
    }
  }
  for (int t = threadIdx.x; t < GT * kRB * U; t += blockDim.x) {
    const int m = t / U, u = t - m * U;  // m = head * 8 + row
    const long long row = ch.i * kRB + (m & (kRB - 1));
    const bool valid = row < n_q_rows;
    stage_piece<VEC>(q_s + m * D4, q + row * sq + static_cast<long long>(h0 + m / kRB) * sqh, u,
                     valid, q);
  }
  cp_async_commit();

  // one batch of kNS live slots (list entries e0 ..) into buffer buf: the
  // k and v rows of every column with a live cell in the row block
  auto stage_batch = [&](int e0, int n_live, int buf) {
    for (int t = threadIdx.x; t < 2 * kNC * U; t += blockDim.x) {
      const int which = t / (kNC * U);
      const int rem = t - which * kNC * U;
      const int col = rem / U, u = rem - col * U;
      const int e = e0 + col / kBC, cell = col % kBC;
      long long kv = 0;
      bool valid = false;
      if (e < n_live) {
        kv = static_cast<long long>(seg_cb[e]) * kBC + cell;
        valid = (live_columns(seg_bits[e]) >> cell & 1u) && kv < n_kv_rows;
      }
      const float* src = which == 0 ? k + kv * sk + j * skh : v + kv * sv + j * svh;
      stage_piece<VEC>(kv_s + ((buf * 2 + which) * kNC + col) * KS, src, u, valid, k);
    }
    cp_async_commit();
  };

  const int m0 = warp * kRB + half * kRows;  // this lane's first row in q_s and p_s
  float m[kRows], l[kRows], acc[kRows][DC][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][jj][t] = 0.0f;
  }
  u64 seen = 0;  // live cells of the chunk, all rows

  for (long long seg = s0; seg < s1; seg += kSeg) {
    const int n_seg = static_cast<int>(s1 - seg < kSeg ? s1 - seg : kSeg);
    __syncthreads();  // the previous segment's list is no longer read
    for (int t = threadIdx.x; t < n_seg; t += blockDim.x) {
      const float4* p = reinterpret_cast<const float4*>(mask + (seg + t) * kTile);
      u64 bits = 0;
#pragma unroll
      for (int qd = 0; qd < kTile / 4; ++qd) {
        const float4 c = __ldcs(p + qd);
        bits |= static_cast<u64>(c.x > 0.0f) << (4 * qd) |
                static_cast<u64>(c.y > 0.0f) << (4 * qd + 1) |
                static_cast<u64>(c.z > 0.0f) << (4 * qd + 2) |
                static_cast<u64>(c.w > 0.0f) << (4 * qd + 3);
      }
      seg_bits[t] = bits;
      seg_cb[t] = __ldg(colblk + seg + t);
    }
    __syncthreads();
    if (warp == 0) {  // keep the live slots, in order, in place
      int n = 0;
      for (int base = 0; base < n_seg; base += kWarp) {
        const int t = base + lane;
        const u64 bits = t < n_seg ? seg_bits[t] : 0ull;
        const int cb = t < n_seg ? seg_cb[t] : 0;
        const unsigned live = __ballot_sync(kFull, bits != 0ull);
        __syncwarp();
        if (bits != 0ull) {
          const int pos = n + __popc(live & ((1u << lane) - 1u));
          seg_bits[pos] = bits;
          seg_cb[pos] = cb;
        }
        n += __popc(live);
        __syncwarp();
      }
      if (lane == 0) *n_live_s = n;
    }
    __syncthreads();
    const int n_live = *n_live_s;
    const int nb = (n_live + kNS - 1) / kNS;
    if (nb > 0) stage_batch(0, n_live, 0);
    for (int bt = 0; bt < nb; ++bt) {
      const int buf = bt & 1;
      if (bt + 1 < nb) {
        stage_batch((bt + 1) * kNS, n_live, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* k_b = kv_s + (buf * 2) * kNC * KS;
      const float* v_b = k_b + kNC * KS;
      const int e0 = bt * kNS;
      u64 bits[2];  // the slots of key columns cg and cg + 16
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = e0 + 2 * c + cg / kBC;
        bits[c] = e < n_live ? seg_bits[e] : 0ull;
      }
      // each of this lane's rows: its live columns of the batch, slot s in
      // bits 8s .. 8s + 7
      unsigned rl[kRows] = {};
#pragma unroll
      for (int s = 0; s < kNS; ++s) {
        const u64 sb = e0 + s < n_live ? seg_bits[e0 + s] : 0ull;
        seen |= sb;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          rl[i] |= static_cast<unsigned>(sb >> ((half * kRows + i) * kBC) & 0xffull) << (kBC * s);
      }
      bool full = true;
#pragma unroll
      for (int i = 0; i < kRows; ++i) full = full && rl[i] == 0xffffffffu;

      // logits of this lane's 4 rows against key columns cg and cg + 16
      float sc[kRows][2] = {};
#pragma unroll 4
      for (int d = 0; d < D4; d += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(k_b + cg * KS + d);
        const float4 k1 = *reinterpret_cast<const float4*>(k_b + (cg + kHalf) * KS + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(q_s + (m0 + i) * D4 + d);
          sc[i][0] = fmaf(a.x, k0.x, sc[i][0]);
          sc[i][0] = fmaf(a.y, k0.y, sc[i][0]);
          sc[i][0] = fmaf(a.z, k0.z, sc[i][0]);
          sc[i][0] = fmaf(a.w, k0.w, sc[i][0]);
          sc[i][1] = fmaf(a.x, k1.x, sc[i][1]);
          sc[i][1] = fmaf(a.y, k1.y, sc[i][1]);
          sc[i][1] = fmaf(a.z, k1.z, sc[i][1]);
          sc[i][1] = fmaf(a.w, k1.w, sc[i][1]);
        }
      }
      // the online-softmax step of the batch, per row
      float alpha[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int bit = (half * kRows + i) * kBC + cg % kBC;
        const float lg0 = (bits[0] >> bit & 1ull) ? sc[i][0] * scale : -INFINITY;
        const float lg1 = (bits[1] >> bit & 1ull) ? sc[i][1] * scale : -INFINITY;
        float mx = fmaxf(lg0, lg1);
#pragma unroll
        for (int off = kHalf / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float m_safe = isfinite(m_new) ? m_new : 0.0f;
        const float p0 = expf(lg0 - m_safe);
        const float p1 = expf(lg1 - m_safe);
        alpha[i] = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.0f;
        l[i] = fmaf(alpha[i], l[i], p0 + p1);
        m[i] = m_new;
        p_s[(m0 + i) * kPS + cg] = p0;
        p_s[(m0 + i) * kPS + cg + kHalf] = p1;
      }
      __syncwarp();
      // acc = acc * alpha + P . V over the batch's columns in order
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[i][jj][t] *= alpha[i];
      if (full) {
        pv_update<DC, false>(acc, p_s, v_b, m0, cg, D4, KS, rl);
      } else {
        pv_update<DC, true>(acc, p_s, v_b, m0, cg, D4, KS, rl);
      }
      __syncthreads();  // every warp is done with buffer buf and its p rows
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int off = kHalf / 2; off > 0; off >>= 1) l[i] += __shfl_xor_sync(kFull, l[i], off);

  const long long hd = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = half * kRows + i;
    const long long row = ch.i * kRB + r;
    const bool live = (seen >> (r * kBC) & 0xffull) != 0ull;
    float* dst;
    float den = 1.0f;
    if (ch.w < 0) {
      if (row >= n_out_rows) continue;
      dst = out + row * hd + static_cast<long long>(h) * D;
      den = fmaxf(l[i], 1e-30f);
    } else {
      const long long e = (ch.w * H + h) * kRB + r;  // this row's workspace entry
      if (cg == 0)
        reinterpret_cast<float4*>(ws_state)[e] = make_float4(m[i], l[i], live ? 1.0f : 0.0f, 0.0f);
      if (!live) continue;
      dst = ws_acc + e * D;
    }
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int col = 4 * cg + 64 * jj;
      if (col >= D) continue;
      float a[kLaneCols];
#pragma unroll
      for (int t = 0; t < 4; ++t) a[t] = ch.w < 0 ? acc[i][jj][t] / den : acc[i][jj][t];
      put4<VEC>(dst, col, D, a);
    }
  }
}

// The grouped form of attention_combine_kernel: block (row block i, query
// head h), the same fold over the workspace entries (w, h, r).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gqa_attention_combine_kernel(const int* __restrict__ chunk_ptr,  // ragged
                             const int* __restrict__ ws_ptr,     // ragged
                             long long width, int chunk_slots,   // dense-W
                             const float* __restrict__ ws_state,
                             const float* __restrict__ ws_acc, float* __restrict__ out, int D,
                             long long n_out_rows, int H) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int r = threadIdx.x / kWarp;
  const long long i = blockIdx.x;
  const int h = blockIdx.y;
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
  float* dst = out + row * H * static_cast<long long>(D) + static_cast<long long>(h) * D;
  for (int f = kLaneCols * lane; f < D; f += kChunkCols) {
    float m = -INFINITY, l = 0.0f, acc[kLaneCols] = {};
    bool first = true;
    for (long long c = 0; c < n_ch; ++c) {
      const long long e = ((w0 + c) * H + h) * kRB + r;
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
    put4<VEC>(dst, f, D, acc);
  }
}

// Shared memory of a grouped block of GT warps at width D.
size_t gqa_smem(int GT, int D) {
  const size_t d4 = (D + 3) & ~3;
  return sizeof(float) * (GT * kRB * d4 + 4 * kNC * (d4 + 4) + GT * kRB * kPS) +
         kSeg * (sizeof(u64) + sizeof(int)) + 16;
}

template <int DC, bool VEC>
cudaError_t launch_gqa(const int* blkptr, const int* chunk_ptr, const int* ws_ptr,
                       long long width, long long n_row_blocks, long long n_blocks,
                       int chunk_slots, const int* colblk, const float* mask, const float* q,
                       const float* k, const float* v, float* out, float* ws_state,
                       float* ws_acc, long long n_q_rows, long long n_kv_rows, int D,
                       long long n_out_rows, float scale, int H, int Hkv, int GT,
                       const long long* strides, cudaStream_t stream) {
  const size_t smem = gqa_smem(GT, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gqa_attention_chunks_kernel<DC, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int G = H / Hkv;
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(Hkv * (G / GT)));
  gqa_attention_chunks_kernel<DC, VEC><<<grid, GT * kWarp, smem, stream>>>(
      blkptr, chunk_ptr, ws_ptr, width, n_row_blocks, chunk_slots, colblk, mask, q, k, v, out,
      ws_state, ws_acc, n_q_rows, n_kv_rows, D, n_out_rows, scale, H, G, strides[0],
      strides[1], strides[2], strides[3], strides[4], strides[5]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws_state == nullptr) return err;
  const dim3 cgrid(static_cast<unsigned>(n_row_blocks), static_cast<unsigned>(H));
  gqa_attention_combine_kernel<VEC><<<cgrid, kThreads, 0, stream>>>(
      chunk_ptr, ws_ptr, width, chunk_slots, ws_state, ws_acc, out, D, n_out_rows, H);
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

// Grouped (GQA) fused attention over the same layouts: q (n_q_rows, H, D)
// with row and head strides sq, sqh; k and v (n_kv_rows, Hkv, D) with
// sk, skh and sv, svh (elements; the last dimension contiguous); out
// (n_out_rows, H, D) contiguous. H % Hkv == 0, D <= 256. The workspace
// holds (n_ws, H, 8) entries.
int autosage_attention_gqa(const void* blkptr, const void* chunk_ptr, const void* ws_ptr,
                           long long width, const void* colblk, const void* mask,
                           const void* q, const void* k, const void* v, void* out,
                           void* ws_state, void* ws_acc, long long n_row_blocks,
                           long long n_blocks, int chunk_slots, long long n_q_rows,
                           long long n_kv_rows, int D, long long n_out_rows, float scale, int H,
                           int Hkv, long long sq, long long sqh, long long sk, long long skh,
                           long long sv, long long svh, void* stream) {
  if (reinterpret_cast<uintptr_t>(mask) % 16 || chunk_slots <= 0 || D <= 0 || D > 256 ||
      Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  const int GT = G % 8 == 0 ? 8 : G % 4 == 0 ? 4 : G % 2 == 0 ? 2 : 1;
  const long long strides[6] = {sq, sqh, sk, skh, sv, svh};
  bool vec = D % kLaneCols == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(ws_acc) % 16 == 0;
  for (long long s : strides) vec = vec && s % kLaneCols == 0;
  using Fn = cudaError_t (*)(const int*, const int*, const int*, long long, long long, long long,
                             int, const int*, const float*, const float*, const float*,
                             const float*, float*, float*, float*, long long, long long, int,
                             long long, float, int, int, int, const long long*, cudaStream_t);
  Fn run;
  if (D <= 64) {
    run = vec ? launch_gqa<1, true> : launch_gqa<1, false>;
  } else if (D <= 128) {
    run = vec ? launch_gqa<2, true> : launch_gqa<2, false>;
  } else {
    run = vec ? launch_gqa<4, true> : launch_gqa<4, false>;
  }
  return static_cast<int>(run(
      static_cast<const int*>(blkptr), static_cast<const int*>(chunk_ptr),
      static_cast<const int*>(ws_ptr), width, n_row_blocks, n_blocks, chunk_slots,
      static_cast<const int*>(colblk), static_cast<const float*>(mask),
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(ws_state), static_cast<float*>(ws_acc),
      n_q_rows, n_kv_rows, D, n_out_rows, scale, H, Hkv, GT, strides,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
