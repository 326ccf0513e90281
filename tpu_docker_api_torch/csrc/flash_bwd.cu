// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, flash_bwd_dq and flash_bwd_dkv, run in that order.
//
// They replace the TPU kernels of tpu_docker_api/ops/flash_pallas.py
// launched by _bwd_impl: flash_bwd_dq replaces _flash_bwd_dq_kernel,
// flash_bwd_dkv replaces _flash_bwd_dkv_kernel. Both rebuild the softmax
// probabilities from the forward's natural-log lse (FlashAttention-2):
//
//   D_i   = rowsum(dO_i * O_i)
//   P_ij  = exp(q_i k_j^T * scale - lse_i)
//   dV_j  = sum_i P_ij dO_i                 dS_ij = P_ij (dO_i v_j^T - D_i)
//   dQ_i  = scale * sum_j dS_ij k_j         dK_j  = scale * sum_i dS_ij q_i
//
// flash_bwd_dq_kernel_tc (bf16, on the tensor cores) replaces
// _flash_bwd_dq_kernel. One block of one warpgroup per (batch*head,
// 64-query tile), the heaviest causal tiles first. The TPU kernel's
// sequential kv grid axis, which carried dQ in VMEM scratch, is a loop
// over 64-key tiles inside the block, with dQ in f32 registers, scaled
// once and cast once at the end.
// - S = Q K^T and dP = dO V^T are bf16 wgmma.mma_async (SS, both operands
//   K-major) with f32 accumulators; P = exp2(S scale log2(e) - lse
//   log2(e)) and dS = P (dP - D) are formed in the accumulator registers,
//   dS rounded to bf16 there and fed back as the register A operand of
//   dQ += dS K, with K read MN-major through the transpose bit. No P or dS
//   tile is staged in shared memory.
// - Q and dO arrive once and the K/V tiles stream through a 2-stage ring,
//   all by TMA (hopper.cuh; an mbarrier a stage): tile t + 1 loads while
//   tile t computes. In a prologue that overlaps the first loads, the
//   block computes D_i = rowsum(dO_i * O_i) for its rows (16-byte reads of
//   dO and O in f32, summed over a quad) and writes it out for
//   flash_bwd_dkv, so no separate pass over dO and O runs.
// - 64-key kv tiles measured 0.236 ms at the training shape against
//   0.318 for 128-key ones (PERF.md): at d=64 a thread then holds S and
//   dP in 32 floats each, 122 registers against 194, so four blocks fit
//   an SM where two did, and the causal diagonal tile wastes less.
//
// flash_bwd_dq_kernel (f32, on the CUDA cores): the first port's kernel,
// now for f32 only: one block of 8 warps per (batch*head, 64-query tile),
// tiles converted to f32 in shared memory, every product an f32 FMA.
//
// flash_bwd_dkv_kernel_tc (bf16, on the tensor cores): one block of one
// warpgroup per (batch, kv_head, 64-key tile). (Two warpgroups a block
// would share each Q/dO tile, but at ~160 registers a thread one such
// block fits an SM against three of one warpgroup, and more blocks in
// flight hide more of each one's waits; it measured slower.) Both of the
// TPU kernel's innermost grid axes, the GQA group and the q tiles, are
// one loop inside the block, with dK and dV in f32 registers and ONE cast
// at the end: no bf16 round-off compounds across the group, no atomics,
// no per-group partial outputs.
// - Every product is a bf16 wgmma.mma_async with f32 accumulators, on the
//   transposed tiles so that each A operand is K-major shared memory or
//   registers: S^T = K Q^T and dP^T = V dO^T take K or V (resident in
//   shared memory for the whole block) against the Q or dO tile;
//   P^T = exp2(S^T scale log2(e) - lse log2(e)) and dS^T = P^T (dP^T - D)
//   are formed in the accumulator registers and rounded to bf16 there;
//   dV += P^T dO and dK += dS^T Q take them as the register A operand,
//   with dO and Q read MN-major through the transpose bit. No P or dS
//   tile is staged in shared memory.
// - K and V arrive once by TMA. The Q/dO tiles stream through a 2-stage
//   ring filled by TMA (one thread issues the copies into hopper.cuh's
//   swizzled layout; an mbarrier a stage reports them), their lse and D
//   slices beside them by 4-byte cp.async: step i + 1 loads while step i
//   computes. No thread spends instructions on addresses.
// - Rounding: P and dS are rounded to bf16 before their products, where
//   the TPU kernel rounds them (flash_pallas.py:237, :243); scores, dP and
//   the sums stay f32. TMA needs 16-byte aligned rows: hopper.cuh's
//   encode_tile_map refuses others with cudaErrorMisalignedAddress.
//
// flash_bwd_dkv_kernel (f32, on the CUDA cores): the first port's kernel,
// so that, like dq's, the f32 path keeps its 1e-4 agreement with the
// plain version (TF32 tensor cores keep ~3 decimal digits).
//
// Both kernels: causal tiles wholly above the diagonal are never computed
// (dq stops its kv loop at the diagonal, dkv starts its q loop there);
// only the diagonal tiles and the ragged last tile run the mask. Any
// seq >= 1: rows and keys past seq are zero-filled and masked here.
// Inputs are addressed through (batch, head, seq) strides with a
// contiguous head_dim, so the model's (b, s, h, d) tensors and autograd's
// cotangent are read in place.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the backward
// does 10*d FLOPs per visible (query, key) pair (scores, dP, dQ in dq:
// 6d; scores, dP, dV, dK in dkv: 8d), 2.5x the forward. At training
// shapes (R=4, s=2048, 32 heads, d=64, causal) dq is ~103 GFLOP, ~0.104
// ms at peak, against ~153 MB of q/k/v/o/dO/lse/D/dq, ~0.046 ms; dkv
// ~138 GFLOP, ~0.139 ms: both are bound by operations, and only the
// tensor cores reach that rate.
//
// Left for later: overlap of one tile's elementwise work with the next
// tile's products (two accumulator sets, or two warpgroups ping-ponging),
// warp specialisation with a producer warp, a persistent grid. The scores
// and dP are computed twice over (once in each kernel), as in the TPU
// kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 64;               // queries per tile
constexpr int kBlockN = 64;               // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                  // rows a warp owns
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kRows * kWarps == kBlockM && kBlockM == kBlockN,
              "a warp owns 8 rows of a 64-row tile");

struct Strides {
  int64_t b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;                        // dq only
  const void* dout;
  const float* lse;                       // (batch*heads, seq), natural log
  float* delta;                           // dq writes it, dkv reads it
  void* dq;
  void* dk;
  void* dv;
  int seq, heads, kv_heads, causal;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  float scale;                            // softmax scale 1/sqrt(d)
  float scale_log2;                       // scale * log2(e)
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Load rows [r0, r0 + 64) of a (seq, D) slice at `src` (row stride `ss`)
// into `dst` as f32 with row pitch D + 4; rows past seq read as zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ss, int r0, int seq) {
  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * (D + 4) + d] = row < seq ? src[row * ss + d] : 0.f;
  }
}

// acc[r][i] += sum_j w[r][j] * X[j][lane*DPL + i] over a 64-row tile X
// (pitch D + 4) and this warp's (kRows, 64) weights W.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][D / 32],
                                           const float* W, const float* X,
                                           int lane) {
  constexpr int DPL = D / 32;
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int j = 0; j < kBlockN; j += 4) {
    float xv[4][DPL];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* xrow = &X[(j + jj) * LD + lane * DPL];
      if constexpr (DPL == 2) {
        const float2 t2 = *reinterpret_cast<const float2*>(xrow);
        xv[jj][0] = t2.x;
        xv[jj][1] = t2.y;
      } else {
        const float4 t4 = *reinterpret_cast<const float4*>(xrow);
        xv[jj][0] = t4.x;
        xv[jj][1] = t4.y;
        xv[jj][2] = t4.z;
        xv[jj][3] = t4.w;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 w = *reinterpret_cast<const float4*>(&W[r * kBlockN + j]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float a = acc[r][i];
        a = fmaf(w.x, xv[0][i], a);
        a = fmaf(w.y, xv[1][i], a);
        a = fmaf(w.z, xv[2][i], a);
        acc[r][i] = fmaf(w.w, xv[3][i], a);
      }
    }
  }
}

// For this warp's kRows rows of A and B (pitch D + 4, row base `rb`)
// against rows `lane` and `lane + 32` of X and Y: x[r][j] = A_r . X_j and
// y[r][j] = B_r . Y_j.
template <int D>
__device__ __forceinline__ void two_products(float (&x)[kRows][2],
                                             float (&y)[kRows][2],
                                             const float* A, const float* B,
                                             const float* X, const float* Y,
                                             int rb, int lane) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) x[r][0] = x[r][1] = y[r][0] = y[r][1] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 xa = *reinterpret_cast<const float4*>(&X[lane * LD + d]);
    const float4 xb =
        *reinterpret_cast<const float4*>(&X[(lane + 32) * LD + d]);
    const float4 ya = *reinterpret_cast<const float4*>(&Y[lane * LD + d]);
    const float4 yb =
        *reinterpret_cast<const float4*>(&Y[(lane + 32) * LD + d]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 a =
          *reinterpret_cast<const float4*>(&A[(rb + r) * LD + d]);
      const float4 b =
          *reinterpret_cast<const float4*>(&B[(rb + r) * LD + d]);
      x[r][0] = dot4(a, xa, x[r][0]);
      x[r][1] = dot4(a, xb, x[r][1]);
      y[r][0] = dot4(b, ya, y[r][0]);
      y[r][1] = dot4(b, yb, y[r][1]);
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * kBlockM * (D + 4) + kBlockM * kBlockN;
}

template <int D>
constexpr int dkv_smem_floats() {
  return 4 * kBlockM * (D + 4) + 2 * kBlockM * kBlockN + 2 * kBlockM;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 4;
  constexpr int DPL = D / 32;
  static_assert(DPL == 2 || DPL == 4, "head_dim 64 or 128");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBlockM * LD;
  float* Ks = dOs + kBlockM * LD;
  float* Vs = Ks + kBlockN * LD;
  float* dSs = Vs + kBlockN * LD;         // (kBlockM, kBlockN), per warp rows

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int hk = h / (p.heads / p.kv_heads);
  const int rb = warp * kRows;

  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h;
  const float* o = static_cast<const float*>(p.out) + b * p.so.b + h * p.so.h;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const int64_t stat0 = static_cast<int64_t>(bh) * p.seq;

  load_tile<D>(Qs, q, p.sq.s, q0, p.seq);
  load_tile<D>(dOs, dout, p.sdo.s, q0, p.seq);
  __syncthreads();

  // prologue: D_i = rowsum(dO_i * O_i) and lse_i in base 2 for this
  // warp's rows; D_i goes out for flash_bwd_dkv
  float lse2[kRows], dlt[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + rb + r;
    lse2[r] = 0.f;
    dlt[r] = 0.f;
    if (row < p.seq) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) {
        part = fmaf(dOs[(rb + r) * LD + d], o[row * p.so.s + d], part);
      }
      dlt[r] = warp_sum(part);
      lse2[r] = p.lse[stat0 + row] * kLog2e;
      if (lane == 0) p.delta[stat0 + row] = dlt[r];
    }
  }

  float acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;

  const int q_last = min(q0 + kBlockM, p.seq) - 1;
  const int kv_end = p.causal ? q_last + 1 : p.seq;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  float* dSw = dSs + rb * kBlockN;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(Ks, k, p.sk.s, k0, p.seq);
    load_tile<D>(Vs, v, p.sv.s, k0, p.seq);
    __syncthreads();

    // s = Q K^T and dp = dO V^T for this warp's rows, keys lane, lane+32
    float s[kRows][2], dp[kRows][2];
    two_products<D>(s, dp, Qs, dOs, Ks, Vs, rb, lane);

    const bool masked =
        (k0 + kBlockN > p.seq) || (p.causal && k0 + kBlockN - 1 > q0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + rb + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + lane + 32 * j;
        float pij = exp2f(s[r][j] * p.scale_log2 - lse2[r]);
        if (masked && (col >= p.seq || (p.causal && col > row))) pij = 0.f;
        dSw[r * kBlockN + lane + 32 * j] = pij * (dp[r][j] - dlt[r]);
      }
    }
    __syncwarp();
    accumulate<D>(acc, dSw, Ks, lane);    // dQ += dS K
    __syncwarp();
  }

  float* dq = static_cast<float*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + rb + r;
    if (row >= p.seq) continue;
    float* drow = dq + row * p.sdq.s + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) drow[i] = acc[r][i] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 4;
  constexpr int DPL = D / 32;
  static_assert(DPL == 2 || DPL == 4, "head_dim 64 or 128");

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBlockN * LD;
  float* Qs = Vs + kBlockN * LD;
  float* dOs = Qs + kBlockM * LD;
  float* Ps = dOs + kBlockM * LD;         // (kBlockN, kBlockM): P^T rows
  float* dSs = Ps + kBlockN * kBlockM;    // (kBlockN, kBlockM): dS^T rows
  float* lse2s = dSs + kBlockN * kBlockM; // (kBlockM,)
  float* dlts = lse2s + kBlockM;          // (kBlockM,)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * kBlockN;    // causal: the first tiles see most
  const int bhk = blockIdx.y;
  const int b = bhk / p.kv_heads;
  const int hk = bhk % p.kv_heads;
  const int group = p.heads / p.kv_heads;
  const int rb = warp * kRows;            // this warp's keys in the tile

  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h;
  load_tile<D>(Ks, k, p.sk.s, k0, p.seq);
  load_tile<D>(Vs, v, p.sv.s, k0, p.seq);

  float dk[kRows][DPL], dv[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) dk[r][i] = dv[r][i] = 0.f;

  const int n_q = (p.seq + kBlockM - 1) / kBlockM;
  const int first_q = p.causal ? k0 / kBlockM : 0;
  float* Pw = Ps + rb * kBlockM;
  float* dSw = dSs + rb * kBlockM;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
    const float* dout =
        static_cast<const float*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
    const int64_t stat0 = (static_cast<int64_t>(b) * p.heads + h) * p.seq;
    for (int qt = first_q; qt < n_q; ++qt) {
      const int q0 = qt * kBlockM;
      __syncthreads();  // the previous tile is consumed (and K/V stored)
      load_tile<D>(Qs, q, p.sq.s, q0, p.seq);
      load_tile<D>(dOs, dout, p.sdo.s, q0, p.seq);
      for (int i = tid; i < kBlockM; i += kThreads) {
        const int row = q0 + i;
        lse2s[i] = row < p.seq ? p.lse[stat0 + row] * kLog2e : 0.f;
        dlts[i] = row < p.seq ? p.delta[stat0 + row] : 0.f;
      }
      __syncthreads();

      // st = K Q^T and dpt = V dO^T for this warp's keys, queries lane,
      // lane + 32: the transposed score and dP tiles
      float st[kRows][2], dpt[kRows][2];
      two_products<D>(st, dpt, Ks, Vs, Qs, dOs, rb, lane);

      const bool masked = (q0 + kBlockM > p.seq) || (k0 + kBlockN > p.seq) ||
                          (p.causal && k0 + kBlockN - 1 > q0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = k0 + rb + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = lane + 32 * j;
          const int row = q0 + qi;
          float pij = exp2f(st[r][j] * p.scale_log2 - lse2s[qi]);
          if (masked &&
              (row >= p.seq || key >= p.seq || (p.causal && key > row))) {
            pij = 0.f;
          }
          Pw[r * kBlockM + qi] = pij;
          dSw[r * kBlockM + qi] = pij * (dpt[r][j] - dlts[qi]);
        }
      }
      __syncwarp();
      accumulate<D>(dv, Pw, dOs, lane);   // dV += P^T dO
      accumulate<D>(dk, dSw, Qs, lane);   // dK += dS^T Q
      __syncwarp();
    }
  }

  float* dkp = static_cast<float*>(p.dk) + b * p.sdk.b + hk * p.sdk.h;
  float* dvp = static_cast<float*>(p.dv) + b * p.sdv.b + hk * p.sdv.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + rb + r;
    if (key >= p.seq) continue;
    float* krow = dkp + key * p.sdk.s + lane * DPL;
    float* vrow = dvp + key * p.sdv.s + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      krow[i] = dk[r][i] * p.scale;
      vrow[i] = dv[r][i];
    }
  }
}

constexpr int kStages = 2;                // depth of each TMA ring
constexpr int kDqKeys = 64;               // keys a kv tile of dq's ring

// Shared memory of the tensor-core dk/dv kernel in bytes: K and V of the
// block's keys, resident; the ring's stages of (Q, dO, lse, D) for one
// 64-query tile each. Every tile is 1024-byte aligned.
template <int D>
struct DkvSmem {
  static constexpr uint32_t kKV = kBlockN * D * 2;    // K or V
  static constexpr uint32_t kTile = kBlockM * D * 2;  // Q or dO
  static constexpr uint32_t kStage = 2 * kTile + 1024;  // + lse, D
  static constexpr int kBytes = 1024 + 2 * kKV + kStages * kStage;
};

// TMA maps of q and dout (box: one 64-query tile) and of k and v (box:
// dkv's block of keys, or one of dq's kv tiles), each as a (batch, heads,
// seq, D) tensor
struct TileMaps {
  CUtensorMap q, k, v, dout;
};

// One warpgroup: 128 threads, the block's 64 keys by each q tile's 64
// queries in every product.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_kernel_tc(const Params p, const __grid_constant__ TileMaps maps) {
  using bf16 = __nv_bfloat16;
  using S = DkvSmem<D>;
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");

  extern __shared__ uint8_t smem_raw[];
  __shared__ alignas(8) uint64_t bars[kStages + 1];  // the stages, then K/V
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  uint8_t* base = smem_raw + pad;
  const uint32_t sK = raw + pad;
  const uint32_t sV = sK + S::kKV;
  const uint32_t sStage = sV + S::kKV;    // stage st at sStage + st * kStage:
                                          // Q, dO, lse (64 f32), D (64 f32)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k0 = blockIdx.x * kBlockN;    // causal: the first tiles see most
  const int bhk = blockIdx.y;
  const int b = bhk / p.kv_heads;
  const int hk = bhk % p.kv_heads;
  const int group = p.heads / p.kv_heads;

  // the loop runs over (group member g, q tile qt) pairs, flattened;
  // causal: from the diagonal tile on
  const int n_q = (p.seq + kBlockM - 1) / kBlockM;
  const int first_q = p.causal ? k0 / kBlockM : 0;
  const int per_head = n_q - first_q;
  const int n_steps = group * per_head;

  // step i's loads into its ring stage: Q and dO by TMA from thread 0,
  // the lse and D slices by cp.async (seq need not be a multiple of 4)
  auto load_step = [&](int i) {
    const int h = hk * group + i / per_head;
    const int q0 = (first_q + i % per_head) * kBlockM;
    const uint32_t st = sStage + (i % kStages) * S::kStage;
    if (tid == 0) {
      const uint32_t bar = hopper::smem_u32(&bars[i % kStages]);
      hopper::mbar_expect(bar, 2 * S::kTile);
      hopper::tma_load_tile<D, kBlockM>(st, &maps.q, bar, q0, h, b);
      hopper::tma_load_tile<D, kBlockM>(st + S::kTile, &maps.dout, bar, q0,
                                        h, b);
    }
    if (tid < 2 * kBlockM) {              // lse, then D: one f32 a thread
      const int row = q0 + tid % kBlockM;
      const bool ok = row < p.seq;
      const int64_t at = (static_cast<int64_t>(b) * p.heads + h) * p.seq +
                         (ok ? row : 0);
      const float* src = tid < kBlockM ? p.lse + at : p.delta + at;
      hopper::cp_async4(st + 2 * S::kTile + tid * 4, src, ok ? 4 : 0);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j <= kStages; ++j) {
      hopper::mbar_init(hopper::smem_u32(&bars[j]));
    }
    hopper::fence_mbar_init();
    const uint32_t bar = hopper::smem_u32(&bars[kStages]);
    hopper::mbar_expect(bar, 2 * S::kKV);
    hopper::tma_load_tile<D, kBlockN>(sK, &maps.k, bar, k0, hk, b);
    hopper::tma_load_tile<D, kBlockN>(sV, &maps.v, bar, k0, hk, b);
  }
  __syncthreads();                        // the barriers are initialised
  // the first kStages - 1 steps, one commit group each
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_steps) load_step(i);
    hopper::cp_async_commit();
  }

  const int key0 = k0 + 16 * warp + lane / 4;  // keys key0 and key0 + 8
  const int col0 = 2 * (lane % 4);        // + 8j (+1): query or d column
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  hopper::mbar_wait(hopper::smem_u32(&bars[kStages]), 0);  // K and V

  for (int i = 0; i < n_steps; ++i) {
    // the ring: step i + kStages - 1 loads into the stage step i - 1 left
    if (i + kStages - 1 < n_steps) load_step(i + kStages - 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<kStages - 1>();  // this thread's lse/D copies
    __syncthreads();                       // everyone's
    hopper::mbar_wait(hopper::smem_u32(&bars[i % kStages]),
                      (i / kStages) & 1);  // Q and dO

    const int q0 = (first_q + i % per_head) * kBlockM;
    const uint32_t sQ = sStage + (i % kStages) * S::kStage;
    const uint32_t sdO = sQ + S::kTile;
    const float* lse = reinterpret_cast<const float*>(
        base + (sQ - sK) + 2 * S::kTile);
    const float* dlt = lse + kBlockM;
    // st = K Q^T and dpt = V dO^T: the transposed score and dP tiles,
    // the block's 64 keys by the tile's 64 queries
    float st[32], dpt[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      hopper::wgmma_ss<64>(st, hopper::desc_k_major<kBlockN>(sK, 0, ks),
                           hopper::desc_k_major<kBlockM>(sQ, 0, ks));
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      hopper::wgmma_ss<64>(dpt, hopper::desc_k_major<kBlockN>(sV, 0, ks),
                           hopper::desc_k_major<kBlockM>(sdO, 0, ks));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    // P^T = exp2(S^T * scale * log2(e) - lse * log2(e)), dS^T = P^T *
    // (dP^T - D), in the accumulator registers
    const bool masked = (q0 + kBlockM > p.seq) || (k0 + kBlockN > p.seq) ||
                        (p.causal && k0 + kBlockN - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = 8 * j + col0;
      const float2 ls = *reinterpret_cast<const float2*>(lse + qc);
      const float2 dl = *reinterpret_cast<const float2*>(dlt + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * j + e;
        const float lse_e = (e % 2 ? ls.y : ls.x) * kLog2e;
        float pij = hopper::exp2_ftz(fmaf(st[idx], p.scale_log2, -lse_e));
        if (masked) {
          const int key = key0 + 8 * (e / 2);
          const int row = q0 + qc + e % 2;
          if (row >= p.seq || key >= p.seq || (p.causal && key > row)) {
            pij = 0.f;
          }
        }
        st[idx] = pij;
        dpt[idx] = pij * (dpt[idx] - (e % 2 ? dl.y : dl.x));
      }
    }
    uint32_t pa[4][4], da[4][4];        // P^T and dS^T in bf16
    hopper::pack_a<64>(st, pa);
    hopper::pack_a<64>(dpt, da);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {    // dV += P^T dO
      hopper::wgmma_rs<D>(dv, pa[kk], hopper::desc_mn_major<kBlockM>(sdO, kk));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {    // dK += dS^T Q
      hopper::wgmma_rs<D>(dk, da[kk], hopper::desc_mn_major<kBlockM>(sQ, kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    __syncthreads();                      // stage i is free again
  }

  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.sdk.b + hk * p.sdk.h;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.sdv.b + hk * p.sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.seq) continue;
    bf16* krow = dkp + key * p.sdk.s + col0;
    bf16* vrow = dvp + key * p.sdv.s + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) =
          __floats2bfloat162_rn(dk[4 * j + 2 * r] * p.scale,
                                dk[4 * j + 2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// Shared memory of the tensor-core dq kernel in bytes: the block's Q and
// dO tiles, resident, and the ring's stages of (K, V) for one kv tile
// each. Every tile is 1024-byte aligned.
template <int D>
struct DqSmem {
  static constexpr uint32_t kTile = kBlockM * D * 2;  // Q or dO
  static constexpr uint32_t kKV = kDqKeys * D * 2;    // K or V
  static constexpr int kBytes = 1024 + 2 * kTile + kStages * 2 * kKV;
};

// sum_i a_i * b_i over 8 bf16 pairs held in two 16-byte words, in f32
__device__ __forceinline__ float dot8_bf16(uint4 a, uint4 b, float acc) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
  const uint32_t wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&wa[i]));
    const float2 fb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&wb[i]));
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

// One warpgroup: 128 threads, the block's 64 queries by each kv tile's
// kDqKeys keys in S and dP, by D columns in dQ.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel_tc(const Params p, const __grid_constant__ TileMaps maps) {
  using bf16 = __nv_bfloat16;
  using S = DqSmem<D>;
  constexpr int BN = kDqKeys;
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");

  extern __shared__ uint8_t smem_raw[];
  __shared__ alignas(8) uint64_t full[kStages];  // one mbarrier a stage
  const uint32_t sQ = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + S::kTile;
  const uint32_t sKV = sdO + S::kTile;    // stage st: K at sKV + st * 2 *
                                          // kKV, V right after it

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // heaviest causal tiles (the last ones) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int hk = h / (p.heads / p.kv_heads);

  // keys [0, kv_end) are visible to at least one query of this block
  const int q_last = min(q0 + kBlockM, p.seq) - 1;
  const int kv_end = p.causal ? q_last + 1 : p.seq;
  const int n_tiles = (kv_end + BN - 1) / BN;

  // thread 0 loads kv tile t into its ring stage (and Q, dO with tile 0)
  auto load_kv = [&](int t) {
    const int st = t % kStages;
    const uint32_t bar = hopper::smem_u32(&full[st]);
    const uint32_t dst = sKV + st * 2 * S::kKV;
    hopper::mbar_expect(bar, 2 * S::kKV + (t == 0 ? 2 * S::kTile : 0));
    if (t == 0) {
      hopper::tma_load_tile<D, kBlockM>(sQ, &maps.q, bar, q0, h, b);
      hopper::tma_load_tile<D, kBlockM>(sdO, &maps.dout, bar, q0, h, b);
    }
    hopper::tma_load_tile<D, BN>(dst, &maps.k, bar, t * BN, hk, b);
    hopper::tma_load_tile<D, BN>(dst + S::kKV, &maps.v, bar, t * BN, hk, b);
  };
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(hopper::smem_u32(&full[st]));
    }
    hopper::fence_mbar_init();
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) load_kv(t);
    }
  }
  __syncthreads();                        // the barriers are initialised

  // prologue, while the first tiles load: D_i = rowsum(dO_i * O_i) and
  // lse_i in base 2 for this thread's rows row0 and row0 + 8 (each lane of
  // a quad sums every fourth 16-byte chunk of the row); D_i goes out for
  // flash_bwd_dkv
  const int row0 = q0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);        // + 8j (+1): key or d column
  const bf16* o = static_cast<const bf16*>(p.out) + b * p.so.b + h * p.so.h;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const int64_t stat0 = static_cast<int64_t>(bh) * p.seq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float part = 0.f;
    if (row < p.seq) {
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        const int c = lane % 4 + 4 * j;
        part = dot8_bf16(
            *reinterpret_cast<const uint4*>(o + row * p.so.s + 8 * c),
            *reinterpret_cast<const uint4*>(dout + row * p.sdo.s + 8 * c),
            part);
      }
    }
    dlt[r] = hopper::quad_sum(part);
    lse2[r] = row < p.seq ? p.lse[stat0 + row] * kLog2e : 0.f;
    if (lane % 4 == 0 && row < p.seq) p.delta[stat0 + row] = dlt[r];
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    // the ring: tile t + kStages - 1 loads into the stage tile t - 1 left
    if (tid == 0 && t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    hopper::mbar_wait(hopper::smem_u32(&full[t % kStages]),
                      (t / kStages) & 1);  // tile t (and Q, dO) have landed

    const int k0 = t * BN;
    const uint32_t sK = sKV + (t % kStages) * 2 * S::kKV;
    const uint32_t sV = sK + S::kKV;
    // s = Q K^T and dp = dO V^T: the block's 64 queries by the tile's keys
    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      hopper::wgmma_ss<BN>(s, hopper::desc_k_major<kBlockM>(sQ, 0, ks),
                           hopper::desc_k_major<BN>(sK, 0, ks));
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      hopper::wgmma_ss<BN>(dp, hopper::desc_k_major<kBlockM>(sdO, 0, ks),
                           hopper::desc_k_major<BN>(sV, 0, ks));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // P = exp2(S * scale * log2(e) - lse * log2(e)), dS = P * (dP - D), in
    // the accumulator registers; only the diagonal tiles and the ragged
    // last tile need the mask
    const bool masked = (k0 + BN > p.seq) || (p.causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i / 2) % 2;
      float pij = hopper::exp2_ftz(fmaf(s[i], p.scale_log2, -lse2[r]));
      if (masked) {
        const int col = k0 + 8 * (i / 4) + col0 + i % 2;
        if (col >= p.seq || (p.causal && col > row0 + 8 * r)) pij = 0.f;
      }
      dp[i] = pij * (dp[i] - dlt[r]);
    }
    uint32_t da[BN / 16][4];              // dS in bf16, the A operand
    hopper::pack_a<BN>(dp, da);
    hopper::fence_regs(da);
    hopper::fence_regs(dq);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {  // dQ += dS K
      hopper::wgmma_rs<D>(dq, da[kk], hopper::desc_mn_major<BN>(sK, kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    hopper::fence_regs(da);
    __syncthreads();                      // stage t is free again
  }

  bf16* dqp = static_cast<bf16*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.seq) continue;
    bf16* drow = dqp + row * p.sdq.s + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j + 2 * r] * p.scale,
                                dq[4 * j + 2 * r + 1] * p.scale);
    }
  }
}

template <int D>
cudaError_t launch_dq(const Params& p, int batch, cudaStream_t stream) {
  const int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kBlockM - 1) / kBlockM, batch * p.heads);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, int batch, cudaStream_t stream) {
  const int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kBlockN - 1) / kBlockN, batch * p.kv_heads);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The four tensor maps of a tensor-core kernel: q and dout read 64 rows a
// box, k and v kv_rows
template <int D>
cudaError_t encode_maps(TileMaps* maps, const Params& p, int batch,
                        int kv_rows) {
  auto encode = [&](CUtensorMap* map, const void* base, int heads,
                    const Strides& st, int rows) {
    return hopper::encode_tile_map(map, base, batch, heads, p.seq, D, st.b,
                                   st.h, st.s, rows);
  };
  cudaError_t err = encode(&maps->q, p.q, p.heads, p.sq, kBlockM);
  if (err == cudaSuccess) err = encode(&maps->dout, p.dout, p.heads, p.sdo,
                                       kBlockM);
  if (err == cudaSuccess) err = encode(&maps->k, p.k, p.kv_heads, p.sk,
                                       kv_rows);
  if (err == cudaSuccess) err = encode(&maps->v, p.v, p.kv_heads, p.sv,
                                       kv_rows);
  return err;
}

template <int D>
cudaError_t launch_dq_tc(const Params& p, int batch, cudaStream_t stream) {
  // the prologue reads O's rows 16 bytes at a time
  if (!hopper::rows_aligned16(p.out, p.so.b, p.so.h, p.so.s)) {
    return cudaErrorMisalignedAddress;
  }
  TileMaps maps;
  cudaError_t err = encode_maps<D>(&maps, p, batch, kDqKeys);
  if (err != cudaSuccess) return err;
  constexpr int smem = DqSmem<D>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kBlockM - 1) / kBlockM, batch * p.heads);
  flash_bwd_dq_kernel_tc<D><<<grid, 128, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const Params& p, int batch, cudaStream_t stream) {
  TileMaps maps;
  cudaError_t err = encode_maps<D>(&maps, p, batch, kBlockN);
  if (err != cudaSuccess) return err;
  constexpr int smem = DkvSmem<D>::kBytes;
  err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_tc<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kBlockN - 1) / kBlockN, batch * p.kv_heads);
  flash_bwd_dkv_kernel_tc<D><<<grid, 128, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

bool valid(int batch, int seq, int heads, int kv_heads) {
  return seq >= 1 && batch >= 1 && kv_heads >= 1 && heads % kv_heads == 0;
}

Params make_params(int seq, int heads, int kv_heads, int causal,
                   float scale) {
  Params p = {};
  p.seq = seq;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

// Both return the CUDA error of the launch (0 on success). Strides are in
// elements, for the (batch, head, seq) dims; head_dim is contiguous. lse
// and delta are contiguous (batch, heads, seq) f32.

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* out, const void* dout,
                            const void* lse, void* delta, void* dq,
                            int batch, int seq, int heads, int kv_heads,
                            int head_dim, int is_bf16, int causal,
                            int64_t q_sb, int64_t q_sh, int64_t q_ss,
                            int64_t k_sb, int64_t k_sh, int64_t k_ss,
                            int64_t v_sb, int64_t v_sh, int64_t v_ss,
                            int64_t o_sb, int64_t o_sh, int64_t o_ss,
                            int64_t do_sb, int64_t do_sh, int64_t do_ss,
                            int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
                            float scale, void* stream) {
  if (!valid(batch, seq, heads, kv_heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(seq, heads, kv_heads, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.sq = {q_sb, q_sh, q_ss};
  p.sk = {k_sb, k_sh, k_ss};
  p.sv = {v_sb, v_sh, v_ss};
  p.so = {o_sb, o_sh, o_ss};
  p.sdo = {do_sb, do_sh, do_ss};
  p.sdq = {dq_sb, dq_sh, dq_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (head_dim == 64) err = launch_dq_tc<64>(p, batch, s);
    if (head_dim == 128) err = launch_dq_tc<128>(p, batch, s);
  } else {
    if (head_dim == 64) err = launch_dq<64>(p, batch, s);
    if (head_dim == 128) err = launch_dq<128>(p, batch, s);
  }
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             int batch, int seq, int heads, int kv_heads,
                             int head_dim, int is_bf16, int causal,
                             int64_t q_sb, int64_t q_sh, int64_t q_ss,
                             int64_t k_sb, int64_t k_sh, int64_t k_ss,
                             int64_t v_sb, int64_t v_sh, int64_t v_ss,
                             int64_t do_sb, int64_t do_sh, int64_t do_ss,
                             int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
                             int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                             float scale, void* stream) {
  if (!valid(batch, seq, heads, kv_heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(seq, heads, kv_heads, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  p.dk = dk;
  p.dv = dv;
  p.sq = {q_sb, q_sh, q_ss};
  p.sk = {k_sb, k_sh, k_ss};
  p.sv = {v_sb, v_sh, v_ss};
  p.sdo = {do_sb, do_sh, do_ss};
  p.sdk = {dk_sb, dk_sh, dk_ss};
  p.sdv = {dv_sb, dv_sh, dv_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (head_dim == 64) err = launch_dkv_tc<64>(p, batch, s);
    if (head_dim == 128) err = launch_dkv_tc<128>(p, batch, s);
  } else {
    if (head_dim == 64) err = launch_dkv<64>(p, batch, s);
    if (head_dim == 128) err = launch_dkv<128>(p, batch, s);
  }
  return static_cast<int>(err);
}
