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
// - One warp per quantization block, the per-block max of |m| and of
//   sqrt(v) a warp shuffle reduction (no shared memory, no second pass),
//   the new scales written by lane 0.
// - Rounding follows the plain version (one_xla) op for op: every
//   product, sum, quotient and square root is an IEEE round-to-nearest
//   intrinsic, so nvcc contracts none of them into an fma; int8 rounding
//   is half-to-even (rintf), as jnp.round and torch.round are. Both paths
//   below share that arithmetic (adam_element).
//
// Bound on an H100 SXM (3.35 TB/s): a leaf of N bf16 parameters reads g,
// p (2 bytes each), the int8 mq and vq, and writes the update (2 bytes)
// and both int8 moments: ~10 bytes per parameter plus 16 bytes of scales
// per block (at llama3-1b's leaves 0.375 ms a leaf on the mean). At ~30
// flops per element it is far below the compute roofline: it is bound by
// bytes, and the design is about how the warp touches memory.
//
// - The vector path (adam8_kernel_vec): lane l owns the 8 contiguous
//   elements 8l .. 8l + 7 of its warp's block, so one warp covers b = 256
//   in one pass. A lane reads g and p in one 16-byte load each (two in
//   f32) and mq and vq in one 8-byte load each, and writes the update in
//   one 16-byte store and each moment in one 8-byte store: a warp's
//   access is 256-512 contiguous bytes, not 32-64. A lane's guard is one
//   test (8l < b), so every load issues before any arithmetic. It needs b
//   a multiple of 8 and 16-byte aligned g, p and the update, 8-byte
//   aligned moments; every llama3-1b leaf has b = 256.
// - The scalar path (adam8_kernel_scalar), for any other leaf: lane l
//   owns elements l, l + 32, ... (at most 8), one element a load.
// The C entry point chooses the path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;                 // quantization blocks per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerLane = 8;            // b <= 256: 8 elements a lane

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

// One element's step: dequantize both moments, update them, and return
// the update; m and sqrt(v) come back for the requantization.
__device__ __forceinline__ float adam_element(const Params& p, float g,
                                              float mq, float ms, float vq,
                                              float vs, bool has_p,
                                              float prm, float& m,
                                              float& sv) {
  // m = b1 * (mq * ms) + (1 - b1) * g
  m = __fadd_rn(__fmul_rn(p.b1, __fmul_rn(mq, ms)),
                __fmul_rn(p.one_minus_b1, g));
  // v = b2 * (r * r) + ((1 - b2) * g) * g, r = vq * vs (sqrt domain)
  const float r = __fmul_rn(vq, vs);
  const float v = __fadd_rn(__fmul_rn(p.b2, __fmul_rn(r, r)),
                            __fmul_rn(__fmul_rn(p.one_minus_b2, g), g));
  sv = __fsqrt_rn(v);
  // step = (m / bc1) / (sqrt(v) / sqrt(bc2) + eps)
  const float u = __fdiv_rn(__fmul_rn(m, p.inv_bc1),
                            __fadd_rn(__fmul_rn(sv, p.inv_sqrt_bc2), p.eps));
  // -lr * (step + wd * p)
  return has_p ? __fmul_rn(p.neg_lr, __fadd_rn(u, __fmul_rn(p.wd, prm))) : u;
}

// 8 contiguous elements of T as f32, and back
__device__ __forceinline__ void load8(const float* src, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ws[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&x)[8]) {
  uint32_t ws[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    ws[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(ws[0], ws[1], ws[2], ws[3]);
}

// byte i of an 8-byte word of int8 values, as f32
__device__ __forceinline__ float int8_at(uint2 w, int i) {
  const uint32_t word = i < 4 ? w.x : w.y;
  return static_cast<float>(static_cast<int8_t>(word >> (8 * (i % 4))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adam8_kernel_vec(const Params p) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (blk >= p.n_blocks) return;
  const bool active = 8 * lane < p.b;     // b % 8 == 0: all 8 or none
  const int64_t at = blk * p.b + 8 * lane;
  const bool has_p = p.p != nullptr;

  float g[8], prm[8] = {};
  uint2 mq = {}, vq = {};
  if (active) {
    load8(static_cast<const T*>(p.g) + at, g);
    if (has_p) load8(static_cast<const T*>(p.p) + at, prm);
    mq = *reinterpret_cast<const uint2*>(p.mq + at);
    vq = *reinterpret_cast<const uint2*>(p.vq + at);
  }
  const float ms = p.ms[blk];
  const float vs = p.vs[blk];

  float m[8], sv[8], u[8];
  float m_max = 0.f, sv_max = 0.f;
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      u[i] = adam_element(p, g[i], int8_at(mq, i), ms, int8_at(vq, i), vs,
                          has_p, prm[i], m[i], sv[i]);
      m_max = fmaxf(m_max, fabsf(m[i]));
      sv_max = fmaxf(sv_max, sv[i]);
    }
    store8(static_cast<T*>(p.upd) + at, u);
  }

  const float ms_new = block_scale(warp_max(m_max));
  const float vs_new = block_scale(warp_max(sv_max));
  if (active) {
    const float m_inv = __fdiv_rn(1.f, ms_new);
    const float v_inv = __fdiv_rn(1.f, vs_new);
    uint32_t mw[2] = {0, 0}, vw[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mw[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                       quant(m[i], m_inv))) << (8 * (i % 4));
      vw[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                       quant(sv[i], v_inv))) << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(p.mq_out + at) = make_uint2(mw[0], mw[1]);
    *reinterpret_cast<uint2*>(p.vq_out + at) = make_uint2(vw[0], vw[1]);
  }
  if (lane == 0) {
    p.ms_out[blk] = ms_new;
    p.vs_out[blk] = vs_new;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adam8_kernel_scalar(const Params p) {
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
    upd[e] = from_f32<T>(adam_element(
        p, to_f32(g[e]), static_cast<float>(p.mq[base + e]), ms,
        static_cast<float>(p.vq[base + e]), vs, prm != nullptr,
        prm ? to_f32(prm[e]) : 0.f, m[i], sv[i]));
    m_max = fmaxf(m_max, fabsf(m[i]));
    sv_max = fmaxf(sv_max, sv[i]);
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

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename T>
void launch(const Params& p, bool vec, unsigned grid, cudaStream_t s) {
  if (vec) {
    adam8_kernel_vec<T><<<grid, kThreads, 0, s>>>(p);
  } else {
    adam8_kernel_scalar<T><<<grid, kThreads, 0, s>>>(p);
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
  // the vector path reads 8 elements a lane: whole 16-byte words of g, p
  // and the update, 8-byte words of the moments
  const bool vec = b % 8 == 0 && aligned(g, 16) && aligned(upd, 16) &&
                   (param == nullptr || aligned(param, 16)) &&
                   aligned(mq, 8) && aligned(vq, 8) && aligned(mq_out, 8) &&
                   aligned(vq_out, 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(p, vec, static_cast<unsigned>(grid), s);
  } else {
    launch<float>(p, vec, static_cast<unsigned>(grid), s);
  }
  return static_cast<int>(cudaGetLastError());
}
