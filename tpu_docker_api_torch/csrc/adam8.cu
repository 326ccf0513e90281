// AdamW step with int8 moments for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel tpu_docker_api/train/optim.py _adam8_kernel
// (launched by _adam8_update_leaf, with the _kernel_with_params adapter
// for the fused weight decay and learning rate). One pass over a leaf:
// dequantize both moments, update them, compute the bias-corrected Adam
// step with -lr*(step + wd*p) folded in, and requantize blockwise — the
// f32 moments never reach device memory.
//
// What holds on Hopper, which the TPU layout hid:
//
// - Quantization blocks are b <= 256 contiguous elements of the leaf's
//   last dim, so a leaf is a flat run of n_blocks = numel / b blocks and
//   block i's scale is scales[i]: the port keeps the scales as (rows,
//   last_dim / b), the GPU-natural layout, not the TPU's lane-dense
//   (segments, blocks_per_segment, rows) one.
// - One warp per quantization block: lane l owns elements l, l + 32, ...
//   of it in registers (at most 8), so a warp's loads and stores are
//   coalesced, and the per-block max of |m| and of sqrt(v) is a warp
//   shuffle reduction, with no shared memory and no second pass.
// - Rounding follows the plain version (one_xla) op for op: every
//   product, sum, quotient and square root is an IEEE round-to-nearest
//   intrinsic, so nvcc contracts none of them into an fma; int8 rounding
//   is half-to-even (rintf), as jnp.round and torch.round are.
//
// Bound on an H100 SXM (3.35 TB/s): a leaf of N bf16 parameters reads g,
// p (2 bytes each), the int8 mq and vq, and writes the update (2 bytes)
// and both int8 moments: ~10 bytes per parameter plus 16 bytes of scales
// per block. At ~30 flops per element it is far below the compute
// roofline: it is memory-bound. This simple design reads 2-byte elements
// one per lane (64-byte warp transactions) instead of 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;                 // quantization blocks per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerLane = 8;            // b <= 256

struct Params {
  const void* g;
  const void* p;                          // nullptr: no fused wd/lr
  const int8_t* mq;
  const float* ms;
  const int8_t* vq;
  const float* vs;
  void* upd;
  int8_t* mq_out;
  float* ms_out;
  int8_t* vq_out;
  float* vs_out;
  int64_t n_blocks;
  int b;
  float b1, one_minus_b1, b2, one_minus_b2, eps;
  float inv_bc1;                          // 1 / (1 - b1^t)
  float inv_sqrt_bc2;                     // 1 / sqrt(1 - b2^t)
  float neg_lr, wd;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// scale = max / 127 + 1e-30; q = round(x * (1 / scale))
__device__ __forceinline__ float block_scale(float max_abs) {
  return __fadd_rn(__fdiv_rn(max_abs, 127.f), 1e-30f);
}

__device__ __forceinline__ int8_t quant(float x, float inv_scale) {
  return static_cast<int8_t>(rintf(__fmul_rn(x, inv_scale)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adam8_kernel(const Params p) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (blk >= p.n_blocks) return;
  const int64_t base = blk * p.b;
  const T* g = static_cast<const T*>(p.g) + base;
  const T* prm = p.p ? static_cast<const T*>(p.p) + base : nullptr;
  T* upd = static_cast<T*>(p.upd) + base;
  const float ms = p.ms[blk];
  const float vs = p.vs[blk];

  float m[kMaxPerLane], sv[kMaxPerLane];
  float m_max = 0.f, sv_max = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    m[i] = sv[i] = 0.f;
    if (e >= p.b) continue;
    const float gi = to_f32(g[e]);
    // m = b1 * (mq * ms) + (1 - b1) * g
    const float mi = __fadd_rn(
        __fmul_rn(p.b1, __fmul_rn(static_cast<float>(p.mq[base + e]), ms)),
        __fmul_rn(p.one_minus_b1, gi));
    // v = b2 * (r * r) + ((1 - b2) * g) * g, r = vq * vs (sqrt domain)
    const float r = __fmul_rn(static_cast<float>(p.vq[base + e]), vs);
    const float vi = __fadd_rn(__fmul_rn(p.b2, __fmul_rn(r, r)),
                               __fmul_rn(__fmul_rn(p.one_minus_b2, gi), gi));
    const float svi = __fsqrt_rn(vi);
    // step = (m / bc1) / (sqrt(v) / sqrt(bc2) + eps)
    float u = __fdiv_rn(__fmul_rn(mi, p.inv_bc1),
                        __fadd_rn(__fmul_rn(svi, p.inv_sqrt_bc2), p.eps));
    if (prm) {
      // -lr * (step + wd * p)
      u = __fmul_rn(p.neg_lr, __fadd_rn(u, __fmul_rn(p.wd, to_f32(prm[e]))));
    }
    upd[e] = from_f32<T>(u);
    m[i] = mi;
    sv[i] = svi;
    m_max = fmaxf(m_max, fabsf(mi));
    sv_max = fmaxf(sv_max, svi);
  }

  const float ms_new = block_scale(warp_max(m_max));
  const float vs_new = block_scale(warp_max(sv_max));
  const float m_inv = __fdiv_rn(1.f, ms_new);
  const float v_inv = __fdiv_rn(1.f, vs_new);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e >= p.b) continue;
    p.mq_out[base + e] = quant(m[i], m_inv);
    p.vq_out[base + e] = quant(sv[i], v_inv);
  }
  if (lane == 0) {
    p.ms_out[blk] = ms_new;
    p.vs_out[blk] = vs_new;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). All arrays are
// contiguous: g, p and upd hold n_blocks * b elements of one dtype (bf16
// or f32), mq/vq int8 alike, scales n_blocks f32. p may be null.
extern "C" int adam8(const void* g, const void* param, const void* mq,
                     const void* ms, const void* vq, const void* vs,
                     void* upd, void* mq_out, void* ms_out, void* vq_out,
                     void* vs_out, int64_t n_blocks, int b, int is_bf16,
                     float b1, float one_minus_b1, float b2,
                     float one_minus_b2, float eps, float inv_bc1,
                     float inv_sqrt_bc2, float neg_lr, float wd,
                     void* stream) {
  if (n_blocks < 1 || b < 1 || b > 32 * kMaxPerLane) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.g = g;
  p.p = param;
  p.mq = static_cast<const int8_t*>(mq);
  p.ms = static_cast<const float*>(ms);
  p.vq = static_cast<const int8_t*>(vq);
  p.vs = static_cast<const float*>(vs);
  p.upd = upd;
  p.mq_out = static_cast<int8_t*>(mq_out);
  p.ms_out = static_cast<float*>(ms_out);
  p.vq_out = static_cast<int8_t*>(vq_out);
  p.vs_out = static_cast<float*>(vs_out);
  p.n_blocks = n_blocks;
  p.b = b;
  p.b1 = b1;
  p.one_minus_b1 = one_minus_b1;
  p.b2 = b2;
  p.one_minus_b2 = one_minus_b2;
  p.eps = eps;
  p.inv_bc1 = inv_bc1;
  p.inv_sqrt_bc2 = inv_sqrt_bc2;
  p.neg_lr = neg_lr;
  p.wd = wd;
  const int64_t grid = (n_blocks + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    adam8_kernel<__nv_bfloat16><<<static_cast<unsigned>(grid), kThreads, 0,
                                  s>>>(p);
  } else {
    adam8_kernel<float><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
