// Block-ELL row softmax for Hopper (sm_90a): for every padded row of a
// dense-W block-ELL logits table (n_row_blocks, W, rb, bc), fp32 and
// row-major, the masked and numerically stable softmax over the row's
// W * bc cells, the structural mask (same shape) deciding which cells
// are live (mask > 0).
//
// Replaces src/repro/kernels/softmax_pallas.py:
//   row_softmax_kernel <- row_softmax_block_ell (_softmax_kernel)
// and computes what _softmax_kernel computes, cell for cell:
//   masked = mask > 0 ? v : -FLT_MAX            (finfo(float32).min)
//   m      = max over the row of masked
//   m      = m > -FLT_MAX ? m : 0               (softmax_pallas.py:24)
//   e      = mask > 0 ? exp(masked - m) : +0.0
//   out    = e / max(sum over the row of e, 1e-30)
// so a row whose live logits are all -FLT_MAX (or -inf) comes out all
// zeros, as the Pallas kernel's does (the CSR oracle, ref.py:203, would
// give 1/deg there), masked cells are +0.0 whatever their logit (NaN and
// +-inf included), and a row or row block without a live cell is +0.0.
//
// What bounds it on an H100: the function reads vals and mask once and
// writes out once, 3 * nrb * W * rb * bc * 4 bytes (40.7 GB at
// Reddit-0.25, 8x8: nrb = W = 7,281), and does a few operations per
// cell, so its floor is the bytes at 3.35 TB/s (~12.2 ms there).
//
// Design (a simple one that is right first): one block per row block.
// A row block's (W, rb, bc) slab is contiguous, and its 256 threads walk
// it in float4 steps of 1024 cells, coalesced. 1024 is a multiple of
// rb * bc, so every cell a thread reads lies in the same tile position
// and hence in one row: each thread keeps one online (max, sum) pair in
// registers (sum relative to the running max, rescaled when the max
// grows). The block then combines the pairs of each row in thread order
// through shared memory, and a second walk over the slab writes the
// probabilities. The slab does not fit in shared memory at real sizes
// (1.86 MB of logits per row block at Reddit-0.25 against 227 KB), and
// the ~1,000 row blocks in flight outgrow the 50 MB L2, so the second
// walk reads vals and mask from HBM again: the kernel moves 5/3 of the
// bytes its bound counts. No atomics and a fixed combining order: two
// launches give the same bits. Offsets are 64-bit (the table holds
// 3.4 G cells at Reddit-0.25). The launcher allocates nothing, does not
// synchronize, and returns cudaGetLastError().

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStep = kThreads * 4;  // cells per walk step (float4 a thread)
constexpr int kMaxRb = 32;           // rows per block the smem arrays hold

// (m, s) with s = sum of exp(v - m) over the live cells seen; m starts at
// -FLT_MAX, so a live -inf adds exp(-inf) = 0 and a live -FLT_MAX adds 1.
__device__ __forceinline__ void online_add(float v, float& m, float& s) {
  if (v > m) {
    s = s * expf(m - v) + 1.0f;
    m = v;
  } else {
    s += expf(v - m);
  }
}

__device__ __forceinline__ void online_merge(float m2, float s2, float& m, float& s) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(kThreads)
row_softmax_kernel(const float* __restrict__ vals, const float* __restrict__ mask,
                   float* __restrict__ out, long long slab, int rb, int bc) {
  __shared__ float m_part[kThreads];
  __shared__ float s_part[kThreads];
  __shared__ float row_m[kMaxRb];
  __shared__ float row_den[kMaxRb];
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * slab;
  const float4* v4 = reinterpret_cast<const float4*>(vals + base);
  const float4* k4 = reinterpret_cast<const float4*>(mask + base);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  const long long n4 = slab / 4;

  // pass 1: online max and sum of this thread's cells (all in one row)
  float m = -FLT_MAX, s = 0.0f;
  for (long long i = t; i < n4; i += kThreads) {
    const float4 v = __ldg(v4 + i);
    const float4 k = __ldg(k4 + i);
    if (k.x > 0.0f) online_add(v.x, m, s);
    if (k.y > 0.0f) online_add(v.y, m, s);
    if (k.z > 0.0f) online_add(v.z, m, s);
    if (k.w > 0.0f) online_add(v.w, m, s);
  }
  m_part[t] = m;
  s_part[t] = s;
  __syncthreads();

  // combine each row's pairs in thread order: thread t's cells sit at
  // tile position (4 * t) % (rb * bc), i.e. row ((4 * t) % (rb * bc)) / bc
  const int cells = rb * bc;
  if (t < rb) {
    float rm = -FLT_MAX, rs = 0.0f;
    for (int j = 0; j < kThreads; ++j) {
      if ((4 * j) % cells / bc == t) online_merge(m_part[j], s_part[j], rm, rs);
    }
    const float shift = rm > -FLT_MAX ? rm : 0.0f;
    rs *= expf(rm - shift);
    row_m[t] = shift;
    row_den[t] = rs < 1e-30f ? 1e-30f : rs;  // NaN stays NaN, as in jnp.maximum
  }
  __syncthreads();

  // pass 2: write the probabilities
  const int r = (4 * t) % cells / bc;
  const float shift = row_m[r];
  const float den = row_den[r];
  for (long long i = t; i < n4; i += kThreads) {
    const float4 v = __ldg(v4 + i);
    const float4 k = __ldg(k4 + i);
    float4 o;
    o.x = k.x > 0.0f ? expf(v.x - shift) / den : 0.0f;
    o.y = k.y > 0.0f ? expf(v.y - shift) / den : 0.0f;
    o.z = k.z > 0.0f ? expf(v.z - shift) / den : 0.0f;
    o.w = k.w > 0.0f ? expf(v.w - shift) / den : 0.0f;
    o4[i] = o;
  }
}

}  // namespace

extern "C" {

// Row softmax over a dense-W table of n_row_blocks x width tiles of
// rb x bc cells. rb * bc must divide kStep, bc must be a multiple of 4
// and rb at most kMaxRb (8x8, 16x8 and 8x16 are).
int autosage_row_softmax(const void* vals, const void* mask, void* out,
                         long long n_row_blocks, long long width, int rb, int bc,
                         void* stream) {
  const int cells = rb * bc;
  if (rb < 1 || rb > kMaxRb || bc % 4 != 0 || kStep % cells != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_row_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  row_softmax_kernel<<<static_cast<unsigned>(n_row_blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(mask),
      static_cast<float*>(out), width * cells, rb, bc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
