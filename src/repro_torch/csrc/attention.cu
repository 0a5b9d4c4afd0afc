// Fused CSR attention kernel for Hopper (sm_90a): per row i,
// out_i = softmax_j(q_i . k_j * scale over the row's edges) . v, with the
// sparsity pattern in one of the 8x8 block layouts of sparse/bsr.py (a
// structural 0/1 mask per tile) and q, k, v, out dense fp32, row-major.
// fp32 FMA on the CUDA cores, expf (no fast math), no TF32: the 8x8
// tiles are below wgmma's M = 64 and the reference sums fp32 products.
//
// Replaces src/repro/kernels/attention_pallas.py:
//   attention_rows_kernel, width  > 0  <- fused_csr_attention
//                                         (_fused_attn_kernel)
//   attention_rows_kernel, blkptr      <- fused_ragged_attention
//                                         (_fused_ragged_attn_kernel)
//
// What bounds it on an H100: the function needs each layout array read
// once (the 256-byte mask tiles dominate: 5.1 GB ragged, 13.6 GB dense-W
// at Reddit-0.25), q, k, v read and out written once, and 4 * nnz * D
// FLOPs, so its floor is the bytes at 3.35 TB/s. The layout adds work
// above that floor: every live slot re-gathers an 8 x D k tile and an
// 8 x D v tile (16 KB at D = 256, from L2 or HBM) and spends 2 * 64 * D
// FMAs on a tile that holds ~1.4 real edges on Reddit-like graphs.
//
// Design (a simple one that is right first): one block of 256 threads
// per row block walks the row block's slots in order, as the Pallas grid
// walks its "arbitrary" axis. The q tile and the 8 x D accumulator stay
// in shared memory for the whole walk; the running max m and sum l of
// each row sit beside them. Per slot:
//   1. threads 0..63 load the 8x8 mask tile; a tile with no edge (every
//      padded dense-W slot, the ragged dummy slot) is skipped whole,
//      which leaves m, l and acc exactly as they were;
//   2. warp c dots k row (colblk * 8 + c) with the 8 q rows, lanes
//      striding D (coalesced), and reduces the 8 sums by shuffles;
//   3. threads 0..7 run the online-softmax update of their row exactly as
//      the Pallas kernel does: masked logits are -inf, m_safe guards rows
//      fully masked so far, p = exp(logit - m_safe) on edges and 0 off
//      them, alpha = 0 while m_prev is -inf, l = alpha * l + sum(p);
//   4. each thread rescales and adds p . v for its feature columns.
// The block writes out = acc / max(l, 1e-30): a row without edges gets 0.
// D is never split across blocks (each logit needs all of D): the loops
// stride D, so any D whose q tile and accumulator fit shared memory
// works (kernels/attention.py MAX_D).
//
// Dense-W and ragged run the same code on the same live tiles in the same
// order (to_ragged keeps in-block slot order), and the skipped tiles are
// the only difference, so their outputs are equal bit for bit. Nothing
// uses atomics: two launches give the same bits. Tile indices are 64-bit
// (the dense-W mask holds 3.4 G floats at Reddit-0.25). Rows of q, k, v
// past their ends read as zero, so callers pass them unpadded; output
// rows past n_out_rows are not written. The launcher allocates nothing,
// does not synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRB = 8;
constexpr int kBC = 8;
constexpr int kTile = kRB * kBC;
constexpr int kThreads = 256;  // 8 warps: warp c owns k row c of a tile

__global__ void __launch_bounds__(kThreads)
attention_rows_kernel(const int* __restrict__ blkptr, int width,
                      const int* __restrict__ colblk, const float* __restrict__ mask,
                      const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      long long n_q_rows, long long n_kv_rows, int D,
                      long long n_out_rows, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // kRB * D
  float* acc_s = q_s + kRB * D;       // kRB * D
  float* mask_s = acc_s + kRB * D;    // kTile
  float* logit_s = mask_s + kTile;    // kTile
  float* p_s = logit_s + kTile;       // kTile
  float* m_s = p_s + kTile;           // kRB
  float* l_s = m_s + kRB;             // kRB
  float* alpha_s = l_s + kRB;         // kRB

  const long long i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  long long s0, s1;
  if (blkptr != nullptr) {
    s0 = blkptr[i];
    s1 = blkptr[i + 1];
  } else {
    s0 = i * width;
    s1 = s0 + width;
  }
  for (int e = tid; e < kRB * D; e += kThreads) {
    const int r = e / D;
    const long long row = i * kRB + r;
    q_s[e] = row < n_q_rows ? q[row * D + (e - r * D)] : 0.0f;
    acc_s[e] = 0.0f;
  }
  if (tid < kRB) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  // the first __syncthreads_or below orders these writes before any read

  for (long long s = s0; s < s1; ++s) {
    float mv = 0.0f;
    if (tid < kTile) {
      mv = mask[s * kTile + tid];
      mask_s[tid] = mv;
    }
    if (!__syncthreads_or(mv > 0.0f)) continue;  // no edge: adds nothing
    const long long cb = colblk[s];

    // 2. logits: warp c dots k row cb * 8 + c with the 8 q rows
    {
      float part[kRB];
#pragma unroll
      for (int r = 0; r < kRB; ++r) part[r] = 0.0f;
      const long long krow = cb * kBC + warp;
      if (krow < n_kv_rows) {
        const float* kr = k + krow * D;
        for (int d = lane; d < D; d += 32) {
          const float kv = __ldg(kr + d);
#pragma unroll
          for (int r = 0; r < kRB; ++r) part[r] = fmaf(q_s[r * D + d], kv, part[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRB; ++r) logit_s[r * kBC + warp] = part[r];
      }
    }
    __syncthreads();

    // 3. online-softmax update, one thread per row
    if (tid < kRB) {
      const int r = tid;
      const float m_prev = m_s[r];
      float lg[kBC];
      float m_cur = -INFINITY;
#pragma unroll
      for (int c = 0; c < kBC; ++c) {
        lg[c] = mask_s[r * kBC + c] > 0.0f ? logit_s[r * kBC + c] * scale : -INFINITY;
        m_cur = fmaxf(m_cur, lg[c]);
      }
      const float m_new = fmaxf(m_prev, m_cur);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < kBC; ++c) {
        const float p = mask_s[r * kBC + c] > 0.0f ? expf(lg[c] - m_safe) : 0.0f;
        p_s[r * kBC + c] = p;
        psum += p;
      }
      const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
      l_s[r] = fmaf(alpha, l_s[r], psum);
      m_s[r] = m_new;
      alpha_s[r] = alpha;
    }
    __syncthreads();

    // 4. acc = acc * alpha + p . v, each thread on its own columns
    for (int d = tid; d < D; d += kThreads) {
      float vv[kBC];
#pragma unroll
      for (int c = 0; c < kBC; ++c) {
        const long long vrow = cb * kBC + c;
        vv[c] = vrow < n_kv_rows ? __ldg(v + vrow * D + d) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        float a = acc_s[r * D + d] * alpha_s[r];
#pragma unroll
        for (int c = 0; c < kBC; ++c) a = fmaf(p_s[r * kBC + c], vv[c], a);
        acc_s[r * D + d] = a;
      }
    }
    // the next slot's first barrier orders these reads of p_s and
    // alpha_s before the next softmax update rewrites them
  }
  __syncthreads();
  for (int e = tid; e < kRB * D; e += kThreads) {
    const int r = e / D;
    const long long row = i * kRB + r;
    if (row < n_out_rows) out[row * D + (e - r * D)] = acc_s[e] / fmaxf(l_s[r], 1e-30f);
  }
}

}  // namespace

extern "C" {

// Ragged (blkptr != NULL, width ignored) or dense-W (blkptr == NULL)
// fused attention over 8x8 tiles; one block per row block.
int autosage_attention(const void* blkptr, int width, const void* colblk,
                       const void* mask, const void* q, const void* k, const void* v,
                       void* out, long long n_row_blocks, long long n_q_rows,
                       long long n_kv_rows, int D, long long n_out_rows, float scale,
                       void* stream) {
  const size_t smem = (2 * static_cast<size_t>(kRB) * D + 3 * kTile + 3 * kRB) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attention_rows_kernel<<<static_cast<unsigned>(n_row_blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(blkptr), width, static_cast<const int*>(colblk),
      static_cast<const float*>(mask), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), n_q_rows, n_kv_rows, D, n_out_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
