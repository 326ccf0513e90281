// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel tpu_docker_api/ops/flash_pallas.py
// _flash_kernel_kvgrid (launched by _fwd_impl): causal or full GQA
// attention by online softmax in base 2, emitting out and the natural-log
// row logsumexp. The file holds two kernels of that one function:
//
// flash_fwd_kernel_tc — bf16, on the tensor cores. One block of one
// warpgroup per (batch*head, 64-query tile). The TPU kernel's sequential
// kv grid axis, which carried (m, l, acc) in VMEM scratch, is a loop over
// 128-key tiles inside the block with (m, l, acc) in f32 registers. Of
// the four block shapes tried at s=2048 on an H100 (1 or 2 warpgroups,
// 64 or 128 keys a tile; PERF.md), this one was the fastest.
// - S = Q K^T and O += P V are bf16 wgmma.mma_async with f32
//   accumulators. Q and K come from shared memory (K-major); P is the S
//   accumulator rounded to bf16 in registers and fed back as the register
//   A operand (the accumulator layout is the A layout), so P never
//   touches shared memory; V is read MN-major through the transpose bit,
//   with no transposed copy.
// - Q arrives once and the K/V tiles stream through a 2-stage ring, all
//   by TMA: one thread issues the copies (4-D tensor maps over the
//   (b, s, h, d) strided views, rows past seq zero-filled) into the
//   128-byte-swizzled layout the wgmma descriptors name (hopper.cuh), and
//   an mbarrier a stage reports them: tile t + 1 loads while tile t
//   computes, and no thread spends instructions on addresses.
// - The softmax spends one fma and one ex2.approx.ftz per score: the scale
//   folds into the exponent, and the row max is taken on raw scores.
// - Kept from the first port: the base-2 online softmax with (m, l) per
//   row in f32; causal tile skipping (the kv loop stops at the block's
//   diagonal; only diagonal and ragged tiles run the mask); any seq >= 1
//   (rows and keys past seq are zero-filled and masked, so the serve
//   path's 32- and 64-token prefill buckets need no padding); GQA by head
//   index with no repeat of K/V; lse as (batch, heads, seq) f32 in natural
//   log; the heaviest causal tiles scheduled first.
// - Rounding: P is rounded to bf16 before P V, where the TPU kernel rounds
//   it (flash_pallas.py:133); the scores, (m, l) and the PV sum stay f32.
//   TMA needs 16-byte aligned rows: hopper.cuh's encode_tile_map refuses
//   others with cudaErrorMisalignedAddress.
//
// flash_fwd_kernel — f32, on the CUDA cores: the first port's kernel,
// now for f32 only. TF32 tensor cores would keep ~3 decimal digits and break the
// f32 path's 1e-4 agreement with the plain version; f32 is a test and
// reference path, not the model's.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// slice's largest prefill (R=1, s=2048, 32 heads, d=64) a causal launch
// is 4*32*2048^2*64/2 ~= 17.2 GFLOP, ~17 us at peak, against ~21 MB of
// q/k/v/out/lse, ~6 us: compute-bound, and only the tensor cores reach
// that rate.
//
// Left for later: warp specialisation (a producer warp of its own issuing
// TMA, with setmaxnreg), overlapping one tile's softmax with the next tile's S
// product (every wgmma here is waited on at once, so a warpgroup's tensor
// cores idle while it does its softmax), and a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 64;               // queries per block (f32 kernel)
constexpr int kBlockN = 64;               // keys per kv tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBlockM / kWarps;   // query rows per warp
constexpr float kNegInf = -1e30f;         // the JAX kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int seq, heads, kv_heads, causal;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float scale_log2;                       // softmax scale * log2(e)
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

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

// Shared memory in floats: Q and K tiles with rows padded by 4 floats
// (a 16-byte step, so a warp's float4 reads of 32 different K rows fall
// in different banks), the V tile, and one (kRows, kBlockN) probability
// tile per warp.
template <int D>
constexpr int smem_floats() {
  return kBlockM * (D + 4) + kBlockN * (D + 4) + kBlockN * D +
         kWarps * kRows * kBlockN;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 4;
  constexpr int DPL = D / 32;             // output columns per lane
  static_assert(D % 32 == 0 && (DPL == 2 || DPL == 4), "head_dim 64 or 128");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBlockM * LD;
  float* Vs = Ks + kBlockN * LD;
  float* Ps = Vs + kBlockN * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // heaviest causal tiles (the last ones) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int hk = h / (p.heads / p.kv_heads);

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[r * LD + d] = row < p.seq ? q[row * p.q_ss + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  // keys [0, kv_end) are visible to at least one query of this tile
  const int q_last = min(q0 + kBlockM, p.seq) - 1;
  const int kv_end = p.causal ? q_last + 1 : p.seq;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  const float* Pw = Ps + warp * kRows * kBlockN;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile is consumed; Q is stored
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int col = k0 + c;
      const bool ok = col < p.seq;
      Ks[c * LD + d] = ok ? k[col * p.k_ss + d] : 0.f;
      Vs[c * D + d] = ok ? v[col * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // scores for this warp's rows against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&Ks[lane * LD + d]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&Ks[(lane + 32) * LD + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(
            &Qs[(warp * kRows + r) * LD + d]);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kb, s[r][1]);
      }
    }

    // only the diagonal tiles and the ragged last tile need the mask
    const bool masked =
        (k0 + kBlockN > p.seq) || (p.causal && k0 + kBlockN - 1 > q0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + warp * kRows + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[r][j] * p.scale_log2;  // base-2 domain
        if (masked) {
          const int col = k0 + lane + 32 * j;
          if (col >= p.seq || (p.causal && col > row)) x = kNegInf;
        }
        s[r][j] = x;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = exp2f(s[r][0] - m_new);
      const float p1 = exp2f(s[r][1] - m_new);
      const float alpha = exp2f(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      Ps[(warp * kRows + r) * kBlockN + lane] = p0;
      Ps[(warp * kRows + r) * kBlockN + lane + 32] = p1;
    }
    __syncwarp();

    // acc[r][:] += sum_j p[r][j] * V[j][lane*DPL : lane*DPL + DPL]
#pragma unroll 2
    for (int j = 0; j < kBlockN; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = &Vs[(j + jj) * D + lane * DPL];
        if constexpr (DPL == 2) {
          const float2 t2 = *reinterpret_cast<const float2*>(vrow);
          vv[jj][0] = t2.x;
          vv[jj][1] = t2.y;
        } else {
          const float4 t4 = *reinterpret_cast<const float4*>(vrow);
          vv[jj][0] = t4.x;
          vv[jj][1] = t4.y;
          vv[jj][2] = t4.z;
          vv[jj][3] = t4.w;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&Pw[r * kBlockN + j]);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          float a = acc[r][i];
          a = fmaf(pv.x, vv[0][i], a);
          a = fmaf(pv.y, vv[1][i], a);
          a = fmaf(pv.z, vv[2][i], a);
          acc[r][i] = fmaf(pv.w, vv[3][i], a);
        }
      }
    }
    __syncwarp();
  }

  float* out = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= p.seq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / l_safe;
    float* orow = out + row * p.o_ss + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[i] = acc[r][i] * inv;
    if (lane == 0) {
      p.lse[static_cast<int64_t>(bh) * p.seq + row] =
          m[r] * kLn2 + logf(l_safe);
    }
  }
}

constexpr int kStages = 2;                // depth of the K/V ring
constexpr int kTcQueries = 64;            // queries a block: one warpgroup
constexpr int kTcKeys = 128;              // keys a kv tile

// TMA maps of q (box: the block's queries) and of k and v (box: one kv
// tile), each as a (batch, heads, seq, D) tensor
struct TileMaps {
  CUtensorMap q, k, v;
};

// Shared memory of the tensor-core kernel in bytes: the Q tile and the
// ring's stages of (K, V), each tile 1024-byte aligned, plus the slack
// that aligns the base.
template <int D>
constexpr int tc_smem_bytes() {
  return 1024 + kTcQueries * D * 2 + kStages * 2 * kTcKeys * D * 2;
}

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_kernel_tc(const Params p, const __grid_constant__ TileMaps maps) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = kTcQueries;
  constexpr int BN = kTcKeys;
  constexpr uint32_t kQBytes = BM * D * 2;
  constexpr uint32_t kKVBytes = BN * D * 2;
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");

  extern __shared__ uint8_t smem_raw[];
  __shared__ alignas(8) uint64_t full[kStages];  // one mbarrier a stage
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sKV = sQ + kQBytes;      // stage st: K at sKV + st * 2 *
                                          // kKVBytes, V right after it

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // heaviest causal tiles (the last ones) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int hk = h / (p.heads / p.kv_heads);

  // keys [0, kv_end) are visible to at least one query of this block
  const int q_last = min(q0 + BM, p.seq) - 1;
  const int kv_end = p.causal ? q_last + 1 : p.seq;
  const int n_tiles = (kv_end + BN - 1) / BN;

  // thread 0 loads kv tile t into its ring stage (and Q with tile 0)
  auto load_kv = [&](int t) {
    const int st = t % kStages;
    const uint32_t bar = hopper::smem_u32(&full[st]);
    const uint32_t dst = sKV + st * 2 * kKVBytes;
    hopper::mbar_expect(bar, 2 * kKVBytes + (t == 0 ? kQBytes : 0));
    if (t == 0) hopper::tma_load_tile<D, BM>(sQ, &maps.q, bar, q0, h, b);
    hopper::tma_load_tile<D, BN>(dst, &maps.k, bar, t * BN, hk, b);
    hopper::tma_load_tile<D, BN>(dst + kKVBytes, &maps.v, bar, t * BN, hk, b);
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

  const int row0 = q0 + 16 * warp + lane / 4;  // rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);        // + 8j (+1): key or output column
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                // this lane's share of the row sum

  for (int t = 0; t < n_tiles; ++t) {
    // the ring: tile t + kStages - 1 loads into the stage tile t - 1 left
    if (tid == 0 && t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    hopper::mbar_wait(hopper::smem_u32(&full[t % kStages]),
                      (t / kStages) & 1);  // tile t (and Q) have landed

    const int k0 = t * BN;
    const uint32_t sK = sKV + (t % kStages) * 2 * kKVBytes;
    const uint32_t sV = sK + kKVBytes;
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      hopper::wgmma_ss<BN>(s, hopper::desc_k_major<BM>(sQ, 0, ks),
                           hopper::desc_k_major<BN>(sK, 0, ks));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // only the diagonal tiles and the ragged last tile need the mask
    const bool masked = (k0 + BN > p.seq) || (p.causal && k0 + BN - 1 > q0);
    // the row maxima of the raw scores; (m, l) live in the base-2 domain,
    // scores scaled by scale * log2(e) (positive, so the max commutes
    // with it) in the exponent's one fma
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      if (masked) {
        const int col = k0 + 8 * (i / 4) + col0 + (i % 2);
        const int row = row0 + 8 * ((i / 2) % 2);
        if (col >= p.seq || (p.causal && col > row)) s[i] = kNegInf;
      }
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], hopper::quad_max(mx[r]) * p.scale_log2);
      alpha[r] = hopper::exp2_ftz(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i / 2) % 2;
      s[i] = hopper::exp2_ftz(fmaf(s[i], p.scale_log2, -m[r]));
      l[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    uint32_t pa[BN / 16][4];              // P in bf16, the A operand of PV
    hopper::pack_a<BN>(s, pa);
    hopper::fence_regs(pa);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      hopper::wgmma_rs<D>(o, pa[kk], hopper::desc_mn_major<BN>(sV, kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    __syncthreads();                      // stage t is free again
  }

  bf16* out = static_cast<bf16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l_safe = fmaxf(hopper::quad_sum(l[r]), 1e-30f);
    if (row >= p.seq) continue;
    const float inv = 1.f / l_safe;
    bf16* orow = out + row * p.o_ss + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
    }
    if (lane % 4 == 0) {
      p.lse[static_cast<int64_t>(bh) * p.seq + row] =
          m[r] * kLn2 + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kBlockM - 1) / kBlockM, batch * p.heads);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const Params& p, int batch, cudaStream_t stream) {
  TileMaps maps;
  cudaError_t err = hopper::encode_tile_map(
      &maps.q, p.q, batch, p.heads, p.seq, D, p.q_sb, p.q_sh, p.q_ss,
      kTcQueries);
  if (err == cudaSuccess) {
    err = hopper::encode_tile_map(&maps.k, p.k, batch, p.kv_heads, p.seq, D,
                                  p.k_sb, p.k_sh, p.k_ss, kTcKeys);
  }
  if (err == cudaSuccess) {
    err = hopper::encode_tile_map(&maps.v, p.v, batch, p.kv_heads, p.seq, D,
                                  p.v_sb, p.v_sh, p.v_ss, kTcKeys);
  }
  if (err != cudaSuccess) return err;
  constexpr int smem = tc_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_fwd_kernel_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kTcQueries - 1) / kTcQueries, batch * p.heads);
  flash_fwd_kernel_tc<D><<<grid, 128, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Strides are in
// elements, for the (batch, head, seq) dims; head_dim is contiguous.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int batch, int seq, int heads,
                         int kv_heads, int head_dim, int is_bf16, int causal,
                         int64_t q_sb, int64_t q_sh, int64_t q_ss,
                         int64_t k_sb, int64_t k_sh, int64_t k_ss,
                         int64_t v_sb, int64_t v_sh, int64_t v_ss,
                         int64_t o_sb, int64_t o_sh, int64_t o_ss,
                         float scale, void* stream) {
  if (seq < 1 || batch < 1 || kv_heads < 1 || heads % kv_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.seq = seq;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.causal = causal;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (head_dim == 64) err = launch_tc<64>(p, batch, s);
    if (head_dim == 128) err = launch_tc<128>(p, batch, s);
  } else {
    if (head_dim == 64) err = launch_f32<64>(p, batch, s);
    if (head_dim == 128) err = launch_f32<128>(p, batch, s);
  }
  return static_cast<int>(err);
}
