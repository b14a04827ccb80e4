// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel for each operand type, each one source for two layouts.
//
// Replaces the four Pallas backward kernels of the JAX package:
//   mxnet_tpu/ops/pallas_kernels.py  _bshd_bwd_dq_kernel   (head-fused)
//   mxnet_tpu/ops/pallas_kernels.py  _bshd_bwd_dkv_kernel  (head-fused)
//   mxnet_tpu/ops/pallas_kernels.py  _attn_bwd_dq_kernel   (per head)
//   mxnet_tpu/ops/pallas_kernels.py  _attn_bwd_dkv_kernel  (per head)
// As in flash_attn_fwd.cu, every kernel takes element strides for (batch,
// seq, head) of every operand, so the (B,S,H,D) and (B,H,S,D) wrappers pass
// views without a copy.
//
// Semantics kept exactly (pallas_kernels.py:217-234, 285-396):
//   - scale = 1/sqrt(D); QK^T, dO V^T, dS K, dS^T Q and Pdrop^T dO take the
//     operand type (fp32 or bf16) and accumulate in fp32.
//   - P = exp(S*scale - LSE) from the forward's (B,H,S) logsumexp; dead
//     positions (causal q < k, key mask 0, the ragged edge) give P = 0 and
//     dS = 0, so a fully masked row gives zero gradients.
//   - dropout: the forward's lowbias32 keep bits over global (b*H+h, q, k);
//     Pdrop = keep ? P/keep_prob : 0 and dP = keep ? dO V^T / keep_prob : 0.
//   - dS = P * (dP - delta), delta = rowsum(dO * O) computed by the caller.
//   - dS and Pdrop are rounded to the operand type before their products.
//   - dQ = scale * dS K; dK = scale * dS^T Q; dV = Pdrop^T dO.
//
// What bounds it on the H100: dQ does three S x S x D products per (q, k)
// pair and dK/dV four (both recompute S and dP, as the TPU kernels do),
// ~S/3 FLOPs per byte at the training shapes: bound by operations on the
// CUDA cores (67 TFLOP/s fp32), by bytes on the tensor cores (989 TFLOP/s
// bf16, ridge ~295 FLOPs a byte) at S 512.
//
// No atomics: each block owns its output rows, so the result is
// deterministic (the training smoke's dropout repeat check relies on it).
//
// Four kernels, one for each (operand type, pass), chosen in the C entry
// points:
//
// bf16 dK/dV: bwd_dkv_tc_kernel, on the tensor cores. One warpgroup (128
// threads) per (key tile of 64 rows, b*h), streaming query tiles of BC rows
// (64; 32 at D 128, where the dK and dV accumulators take 128 registers a
// thread) from the diagonal on under causal. All four products are wgmma
// (hopper_tc.cuh). It computes the transposed tiles S^T = K Q^T and
// dP^T = V dO^T (A = the block's K or V tile, B = the streamed Q or dO
// tile, all K-major in shared memory), so that Pdrop^T and dS^T come out
// in the accumulator fragment that is the A operand of dV += Pdrop^T dO
// and dK += dS^T Q: they are rounded to bf16 in registers and fed back
// with no shared-memory round trip (B = dO or Q, MN-major). Each thread
// owns two key rows (16w + l/4 and +8) and two query columns of every 8,
// so the masks and keep bits are taken at each element's own global
// (q, k), and LSE and delta are read per column. Q and dO tiles (bf16, by
// cp.async) and their LSE and delta rows stream through a two-stage ring:
// tile t+1 is in flight while tile t computes. dK and dV stay in fp32
// registers until the end; at D <= 64 the registers are capped so that 3
// blocks share an SM.
//
// bf16 dQ: bwd_dq_tc_kernel, on the tensor cores, the mirror of dK/dV. One
// warpgroup per (query tile of 64 rows, b*h), heaviest causal tiles first.
// The Q and dO tiles stay in shared memory (loaded once); K and V tiles of
// BC keys (64; 32 at D 128) and their live bits (range and key mask)
// stream through a two-stage cp.async ring up to the diagonal under
// causal. S = Q K^T and dP = dO V^T are wgmma from shared memory (all
// K-major); dS comes out in the accumulator fragment, is rounded to bf16 in
// registers and is the A operand of dQ += dS K, whose B operand is the
// same K tile read MN-major: no shared-memory round trip. Each thread owns
// two query rows (16w + l/4 and +8), so their LSE (in log2 units) and delta
// live in registers. P = 2^(S * scale * log2 e - LSE * log2 e), one FMA
// and one ex2 an element; the range, causal and key-mask tests run only on
// tiles at an edge (the ragged end, the diagonal, or any tile under a key
// mask); dropout is a template flag. dQ stays in D/2 fp32 registers until
// the end. At D <= 64 the registers are capped (168) so that 3 blocks share
// an SM: ptxas (CUDA 12.8) gives 154 registers at D 64, 156 with dropout,
// no spill; 49 KB of shared memory a block at D 64.
//
// fp32 dQ: bwd_dq_f32_kernel, on the CUDA cores in fp32 (no TF32), the
// mirror of fp32 dK/dV below. One block of 128 threads per (query tile of
// BR rows, b*h), heaviest causal tiles first; BR is 64 at D <= 64 and 32 at
// D 128. Q and dO are resident row tiles (stride D + 4, 16-byte cp.async)
// with each row's LSE * log2 e and delta in registers; K and V tiles of 32
// keys and their per-key live bits (in range, unmasked) stream through a
// two-stage cp.async ring up to the diagonal under causal, tile t+1 in
// flight while t computes. S = Q K^T and dP = dO V^T are float4 micro-tiles
// (thread (t / 8, t % 8) owns queries tr + 16i and keys tc + 8j: at D 64, 8
// FMAs an LDS.128). dS goes to shared memory
// transposed, key-major with a row stride of BR + 4 floats: the
// element-wise writes hit distinct banks, and dQ += dS K reads 4 queries of
// one key as a float4 (each thread owns 4 consecutive dQ columns of BR * D
// / 512 queries, whole quads: at D 64, 3 loads for 32 FMAs, 10.7 an
// LDS.128). Where it fits (BR <= D) dS^T takes the V stage of its own tile,
// dead once dP is computed, at the cost of one more barrier: 69,632 bytes a
// block at D 64 (3 blocks an SM; its own buffer would take 79,872 and give
// 2). The element-wise step is the other kernels': ex2 in log2 units, the
// causal test on diagonal tiles only, the key tests as a bit mask, dropout
// as a template flag; query rows past S are computed but never written.
//
// fp32 dK/dV: bwd_dkv_f32_kernel, on the CUDA cores in fp32 (no TF32: the
// reference keeps fp32 products). One block of 128 threads per (key tile
// of BR rows, b*h) streams query tiles of 32 rows from the diagonal on
// under causal; BR is 64 at D <= 64 and 32 at D 128. Its pace is set by
// how many shared-memory load instructions feed each FMA, so every operand
// is read as float4 into register-blocked micro-tiles (hopper_simt.cuh):
//   - all tiles are row-major fp32 with a row stride of D + 4 floats (K, V
//     resident; Q, dO and their LSE and delta rows in a two-stage ring
//     filled by 16-byte cp.async, tile t+1 in flight while t computes);
//   - S^T and dP^T: thread (tr, tc) = (t / 8, t % 8) owns keys tr + 16i
//     and queries tc + 8j (a BR/16 x 4 micro-tile of each) and reads 4
//     consecutive d of each row as one float4: at D 64, 8 loads for 128
//     FMAs; a quarter-warp reads one K/V row (broadcast) and 8 Q/dO rows
//     on 8 distinct bank groups;
//   - dV += Pdrop^T dO and dK += dS^T Q: thread (t / (D/4), t % (D/4)) owns
//     keys and 4 consecutive columns of dK and dV (BR * D / 512 keys: 8
//     at D 64) and reads 4 consecutive queries of its Pdrop^T and dS^T
//     rows and one float4 of 4 Q/dO rows: at D 64, 24 loads for 256 FMAs.
//   So the two inner loops do 8 and 10.7 FMAs an LDS.128 at D 64 (5.3 and
//   10.7 at D 128, 8 and 8 at D 32).
// Pdrop^T and dS^T go through shared memory (row stride 40 floats, so the
// element-wise writes hit distinct banks): the second pair of products
// contracts over all 32 queries of a tile, of which each thread computed
// only 4 in the first, and keeping whole rows in registers would take 8x
// the registers. The element-wise step is the bf16 kernels': ex2 in log2
// units (ex2.approx, ~2 ulp, far inside the 2e-4 tolerance), the query
// range and causal tests on edge tiles only, the key tests as a per-thread
// bit mask, dropout as a template flag. Shared memory: 90,112 bytes a
// block at D 64 (2 blocks an SM), 111,616 at D 128 (2), 57,344 at D 32 (3).
// Registers (ptxas, CUDA 12.8): 232 at D 64 (246 with dropout), 220 at
// D 128, 168 at D 32, no spill; 2 blocks an SM fit both limits at D 64.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper_simt.cuh"
#include "hopper_tc.cuh"
#include "launch.cuh"

namespace {

constexpr int NT = 128;          // threads per block

// element strides (batch, seq, head) of q, k, v, dO, dQ, dK, dV
enum { SQ = 0, SK = 3, SV = 6, SG = 9, SDQ = 12, SDK = 15, SDV = 18,
       NSTRIDES = 21 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;                 // dO
  const float* lse;              // (B,H,S)
  const float* delta;            // (B,H,S)
  const int32_t* mask;           // (B,S) or null
  void* dq;
  void* dk;
  void* dv;
  long long st[NSTRIDES];
  long long mask_sb;
  int H, S;
  float scale;
  int causal;
  int dropout_on;
  float keep;          // 1 - dropout, as float32
  uint32_t thresh;     // min(floor(keep * 2^32), 2^32 - 1)
  uint32_t seed;
};

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool kept(const Params& p, int bh, int qi,
                                     int kj) {
  const uint32_t c = ((uint32_t)qi * 0x9E3779B9u) ^
                     ((uint32_t)kj * 0x85EBCA6Bu) ^
                     ((uint32_t)bh * 0xC2B2AE35u) ^ p.seed;
  return lowbias32(c) < p.thresh;
}

// ----------------------------------------- fp32 on the CUDA cores: dQ, dK/dV

constexpr int F_BC = 32;         // rows per streamed tile (dK/dV: queries)
constexpr int F_STAGES = 2;      // ring depth of the streamed tiles
constexpr int F_LP = F_BC + 8;   // row stride of dK/dV's pd_s, ds_s (floats)

// rows of the block's own tile, keys (dK/dV) or queries (dQ); a variable,
// so that device code may read it
template <int D> constexpr int F32_ROWS = D > 64 ? 32 : 64;

template <int D>
constexpr int dkv_f32_smem_bytes() {
  // K, V; the Q/dO ring; Pdrop^T and dS^T
  return 2 * simt::RowTile<F32_ROWS<D>, D>::BYTES +
         2 * F_STAGES * simt::RowTile<F_BC, D>::BYTES +
         2 * F32_ROWS<D> * F_LP * (int)sizeof(float);
}

// dS^T takes the V stage of its own key tile (dead once dP is computed)
// where it fits, so that 3 blocks share an SM at D 64
template <int D> constexpr bool DQ_ALIAS = F32_ROWS<D> <= D;

template <int D>
constexpr int dq_f32_smem_bytes() {
  // Q, dO; the K/V ring; dS^T unless it takes a V stage
  return 2 * simt::RowTile<F32_ROWS<D>, D>::BYTES +
         2 * F_STAGES * simt::RowTile<F_BC, D>::BYTES +
         (DQ_ALIAS<D> ? 0 : simt::RowTile<F_BC, F32_ROWS<D>>::BYTES);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NT, D > 64 ? 2 : 3)
    bwd_dq_f32_kernel(const Params p) {
  using simt::ld4;
  using simt::at;
  constexpr int BR = F32_ROWS<D>;
  constexpr int LD = simt::RowTile<BR, D>::LD;
  constexpr int TILE = simt::RowTile<F_BC, D>::FLOATS;
  constexpr int LT = simt::RowTile<F_BC, BR>::LD;   // dS^T row stride
  constexpr int RM = BR / 16;    // S, dP: queries per thread (x 4 keys)
  constexpr int TC2 = D / 4;     // dQ: threads across D, 4 columns each
  constexpr int TR2 = NT / TC2;
  constexpr int RQ = BR / (4 * TR2);   // dQ: quads of 4 queries per thread
  static_assert(F_BC == 32 && RQ >= 1, "micro-tiles");
  static_assert(!DQ_ALIAS<D> || simt::RowTile<F_BC, BR>::FLOATS <= TILE,
                "dS^T fits a V stage");
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* g_s = q_s + simt::RowTile<BR, D>::FLOATS;
  float* ring = g_s + simt::RowTile<BR, D>::FLOATS;   // K, V of each stage
  float* ds_own = ring + 2 * F_STAGES * TILE;         // dS^T, unless aliased
  __shared__ uint32_t live_s[F_STAGES];   // bit k: key k0 + k is live

  const int tid = threadIdx.x;
  const int tr = tid >> 3;       // S, dP: queries tr + 16i
  const int tc = tid & 7;        //        keys tc + 8j
  const int orow = tid / TC2;    // dQ: queries 4 (orow + TR2 r) .. + 3
  const int ocol = 4 * (tid % TC2);   // columns ocol .. ocol + 3
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qt * BR;
  const int S = p.S;
  const long long* st = p.st;

  const float* Q = static_cast<const float*>(p.q) + b * st[SQ] +
                   h * st[SQ + 2];
  const float* K = static_cast<const float*>(p.k) + b * st[SK] +
                   h * st[SK + 2];
  const float* V = static_cast<const float*>(p.v) + b * st[SV] +
                   h * st[SV + 2];
  const float* G = static_cast<const float*>(p.g) + b * st[SG] +
                   h * st[SG + 2];
  float* DQ = static_cast<float*>(p.dq) + b * st[SDQ] + h * st[SDQ + 2];
  const int32_t* M = p.mask ? p.mask + b * p.mask_sb : nullptr;

  int n_kt = (S + F_BC - 1) / F_BC;
  if (p.causal) n_kt = min(n_kt, (q0 + BR - 1) / F_BC + 1);

  auto issue = [&](int kt, int sg) {
    const int k0 = kt * F_BC;
    simt::load_rows<F_BC, D, NT>(ring + 2 * sg * TILE, K, st[SK + 1], k0, S);
    simt::load_rows<F_BC, D, NT>(ring + (2 * sg + 1) * TILE, V, st[SV + 1],
                                 k0, S);
    if (tid < 32) {
      const uint32_t w = simt::live_bits(M, k0, S);
      if (tid == 0) live_s[sg] = w;
    }
  };
  simt::load_rows<BR, D, NT>(q_s, Q, st[SQ + 1], q0, S);
  simt::load_rows<BR, D, NT>(g_s, G, st[SG + 1], q0, S);
  issue(0, 0);
  hopper::cp_async_commit();

  float lse2[RM], dl[RM];        // LSE * log2 e and delta of rows tr + 16i
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + tr + 16 * i;
    const bool in = qi < S;
    lse2[i] = in ? p.lse[(long long)bh * S + qi] * hopper::LOG2E : 0.f;
    dl[i] = in ? p.delta[(long long)bh * S + qi] : 0.f;
  }
  float dq[RQ][4][4];            // [quad][query in quad][column]
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u) dq[r][e][u] = 0.f;
  const float sl2 = p.scale * hopper::LOG2E;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int sg = kt % F_STAGES;
    const int k0 = kt * F_BC;
    hopper::cp_async_wait<0>();  // this thread's copies of tile kt landed
    __syncthreads();             // ... everyone's; tile kt - 1 is done with
    if (kt + 1 < n_kt) {         // so its stage takes tile kt + 1 meanwhile
      issue(kt + 1, (kt + 1) % F_STAGES);
      hopper::cp_async_commit();
    }
    const float* k_s = ring + 2 * sg * TILE;
    const float* v_s = k_s + TILE;

    float s[RM][4], dp[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    simt::dot_tile<RM, D, LD>(s, q_s + tr * LD, k_s + tc * LD);
    simt::dot_tile<RM, D, LD>(dp, g_s + tr * LD, v_s + tc * LD);

    // P = 2^(S * scale * log2 e - LSE * log2 e); dS^T = (P (dP - delta))^T,
    // key-major, so that the writes hit distinct banks and the dQ product
    // reads 4 queries of one key as a float4. The causal test is taken only
    // on the diagonal tiles; query rows past S are never written.
    float* ds_s = DQ_ALIAS<D> ? ring + (2 * sg + 1) * TILE : ds_own;
    if constexpr (DQ_ALIAS<D>) __syncthreads();   // every dP read V
    const uint32_t lw = live_s[sg];
    const bool diag = p.causal && k0 + F_BC - 1 > q0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kl = tc + 8 * j;
      const int kj = k0 + kl;
      const bool key = (lw >> kl) & 1u;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int ql = tr + 16 * i;
        const int qi = q0 + ql;
        const bool alive = key && !(diag && qi < kj);
        const float pr = hopper::ex2(fmaf(s[i][j], sl2, -lse2[i]));
        float dpv = dp[i][j];
        if constexpr (DROP) dpv = kept(p, bh, qi, kj) ? dpv / p.keep : 0.f;
        ds_s[kl * LT + ql] = alive ? pr * (dpv - dl[i]) : 0.f;
      }
    }
    __syncthreads();

    // dQ += dS K: per key, one float4 of 4 queries from each quad's dS^T
    // row and one float4 of 4 columns of the K row
#pragma unroll 4
    for (int kk = 0; kk < F_BC; ++kk) {
      float4 a[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        a[r] = ld4(ds_s + kk * LT + 4 * (orow + TR2 * r));
      const float4 c = ld4(k_s + kk * LD + ocol);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = at(a[r], e);
          dq[r][e][0] = fmaf(x, c.x, dq[r][e][0]);
          dq[r][e][1] = fmaf(x, c.y, dq[r][e][1]);
          dq[r][e][2] = fmaf(x, c.z, dq[r][e][2]);
          dq[r][e][3] = fmaf(x, c.w, dq[r][e][3]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + 4 * (orow + TR2 * r) + e;
      if (qi >= S) continue;
      *reinterpret_cast<float4*>(DQ + (long long)qi * st[SDQ + 1] + ocol) =
          make_float4(dq[r][e][0] * p.scale, dq[r][e][1] * p.scale,
                      dq[r][e][2] * p.scale, dq[r][e][3] * p.scale);
    }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NT, 2) bwd_dkv_f32_kernel(const Params p) {
  using simt::ld4;
  using simt::dot4;
  using simt::at;
  constexpr int BR = F32_ROWS<D>;
  constexpr int LD = simt::RowTile<BR, D>::LD;
  constexpr int TILE = simt::RowTile<F_BC, D>::FLOATS;
  constexpr int RM = BR / 16;    // S^T, dP^T: keys per thread (x 4 queries)
  constexpr int TC2 = D / 4;     // dK, dV: threads across D, 4 columns each
  constexpr int TR2 = NT / TC2;
  constexpr int RM2 = BR / TR2;  // dK, dV: keys per thread
  static_assert(F_BC / 8 == 4 && RM2 >= 1, "micro-tiles");
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + simt::RowTile<BR, D>::FLOATS;
  float* ring = v_s + simt::RowTile<BR, D>::FLOATS;
  float* pd_s = ring + 2 * F_STAGES * TILE;   // Pdrop^T, BR x F_LP
  float* ds_s = pd_s + BR * F_LP;             // dS^T, BR x F_LP
  __shared__ float lse_s[F_STAGES][F_BC];     // LSE * log2 e
  __shared__ float dl_s[F_STAGES][F_BC];

  const int tid = threadIdx.x;
  const int tr = tid >> 3;       // S^T, dP^T: keys tr + 16i
  const int tc = tid & 7;        //            queries tc + 8j
  const int orow = tid / TC2;    // dK, dV: keys orow + TR2 * i
  const int ocol = 4 * (tid % TC2);   //     columns ocol .. ocol + 3
  const int kt = blockIdx.x;     // causal: tile 0 streams the most q tiles
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = kt * BR;
  const int S = p.S;
  const long long* st = p.st;

  const float* Q = static_cast<const float*>(p.q) + b * st[SQ] +
                   h * st[SQ + 2];
  const float* K = static_cast<const float*>(p.k) + b * st[SK] +
                   h * st[SK + 2];
  const float* V = static_cast<const float*>(p.v) + b * st[SV] +
                   h * st[SV + 2];
  const float* G = static_cast<const float*>(p.g) + b * st[SG] +
                   h * st[SG + 2];
  float* DK = static_cast<float*>(p.dk) + b * st[SDK] + h * st[SDK + 2];
  float* DV = static_cast<float*>(p.dv) + b * st[SDV] + h * st[SDV + 2];
  const int32_t* M = p.mask ? p.mask + b * p.mask_sb : nullptr;

  uint32_t live = 0;             // bit i: key tr + 16i is in range, unmasked
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kj = k0 + tr + 16 * i;
    if (kj < S && (M == nullptr || M[kj] != 0)) live |= 1u << i;
  }

  const int n_qt = (S + F_BC - 1) / F_BC;
  const int qt0 = p.causal ? k0 / F_BC : 0;

  auto issue = [&](int qt, int sg) {
    const int q0 = qt * F_BC;
    simt::load_rows<F_BC, D, NT>(ring + 2 * sg * TILE, Q, st[SQ + 1], q0, S);
    simt::load_rows<F_BC, D, NT>(ring + (2 * sg + 1) * TILE, G, st[SG + 1],
                                 q0, S);
    if (tid < F_BC) {
      const int qi = q0 + tid;
      const bool in = qi < S;
      lse_s[sg][tid] =
          in ? p.lse[(long long)bh * S + qi] * hopper::LOG2E : 0.f;
      dl_s[sg][tid] = in ? p.delta[(long long)bh * S + qi] : 0.f;
    }
  };
  simt::load_rows<BR, D, NT>(k_s, K, st[SK + 1], k0, S);
  simt::load_rows<BR, D, NT>(v_s, V, st[SV + 1], k0, S);
  issue(qt0, 0);                 // k0 < S, so qt0 < n_qt
  hopper::cp_async_commit();

  float dk[RM2][4], dv[RM2][4];
#pragma unroll
  for (int i = 0; i < RM2; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) dk[i][u] = dv[i][u] = 0.f;
  const float sl2 = p.scale * hopper::LOG2E;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int sg = (qt - qt0) % F_STAGES;
    const int q0 = qt * F_BC;
    if (qt + 1 < n_qt) issue(qt + 1, (qt + 1 - qt0) % F_STAGES);
    hopper::cp_async_commit();   // possibly empty: one group per iteration
    hopper::cp_async_wait<1>();  // this thread's copies of tile qt landed
    __syncthreads();             // ... and everyone else's
    const float* q_s = ring + 2 * sg * TILE;
    const float* g_s = q_s + TILE;

    // transposed tiles: rows are this block's keys, columns the queries
    float s[RM][4], dp[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[RM], c[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = ld4(k_s + (tr + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ld4(q_s + (tc + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], c[j], s[i][j]);
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = ld4(v_s + (tr + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ld4(g_s + (tc + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], c[j], dp[i][j]);
    }

    // P = 2^(S^T * scale * log2 e - LSE * log2 e). The query range and
    // causal tests are taken only on tiles at an edge (the diagonal, the
    // ragged end); a dead key is dead in every tile.
    const bool edge = q0 + F_BC > S || (p.causal && q0 < k0 + BR - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ql = tc + 8 * j;
      const int qi = q0 + ql;
      const float lse2 = lse_s[sg][ql];
      const float dl = dl_s[sg][ql];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int kl = tr + 16 * i;
        const bool alive = ((live >> i) & 1u) &&
                           (!edge || (qi < S && !(p.causal && qi < k0 + kl)));
        const float pr = hopper::ex2(fmaf(s[i][j], sl2, -lse2));
        float pd = pr, dpv = dp[i][j];
        if constexpr (DROP) {
          const bool on = kept(p, bh, qi, k0 + kl);
          pd = on ? pr / p.keep : 0.f;
          dpv = on ? dpv / p.keep : 0.f;
        }
        pd_s[kl * F_LP + ql] = alive ? pd : 0.f;
        ds_s[kl * F_LP + ql] = alive ? pr * (dpv - dl) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < F_BC; qq += 4) {
      float4 a[RM2], c[4];
#pragma unroll
      for (int i = 0; i < RM2; ++i)
        a[i] = ld4(pd_s + (orow + TR2 * i) * F_LP + qq);
#pragma unroll
      for (int u = 0; u < 4; ++u) c[u] = ld4(g_s + (qq + u) * LD + ocol);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < RM2; ++i) {
          const float x = at(a[i], u);
          dv[i][0] = fmaf(x, c[u].x, dv[i][0]);
          dv[i][1] = fmaf(x, c[u].y, dv[i][1]);
          dv[i][2] = fmaf(x, c[u].z, dv[i][2]);
          dv[i][3] = fmaf(x, c[u].w, dv[i][3]);
        }
#pragma unroll
      for (int i = 0; i < RM2; ++i)
        a[i] = ld4(ds_s + (orow + TR2 * i) * F_LP + qq);
#pragma unroll
      for (int u = 0; u < 4; ++u) c[u] = ld4(q_s + (qq + u) * LD + ocol);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < RM2; ++i) {
          const float x = at(a[i], u);
          dk[i][0] = fmaf(x, c[u].x, dk[i][0]);
          dk[i][1] = fmaf(x, c[u].y, dk[i][1]);
          dk[i][2] = fmaf(x, c[u].z, dk[i][2]);
          dk[i][3] = fmaf(x, c[u].w, dk[i][3]);
        }
    }
    __syncthreads();             // stage sg is free for tile qt + 2
  }

#pragma unroll
  for (int i = 0; i < RM2; ++i) {
    const int kj = k0 + orow + TR2 * i;
    if (kj >= S) continue;
    *reinterpret_cast<float4*>(DK + (long long)kj * st[SDK + 1] + ocol) =
        make_float4(dk[i][0] * p.scale, dk[i][1] * p.scale,
                    dk[i][2] * p.scale, dk[i][3] * p.scale);
    *reinterpret_cast<float4*>(DV + (long long)kj * st[SDV + 1] + ocol) =
        make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
  }
}

// ------------------------------------- dQ and dK/dV in bf16, tensor cores

constexpr int TC_BR = 64;        // rows of the block's own tile (wgmma's M)
constexpr int TC_STAGES = 2;     // ring depth of the streamed tiles

// rows of the streamed tile (wgmma's N in S and dP)
template <int D> constexpr int tc_cols() { return D > 64 ? 32 : 64; }

// at D <= 64 the registers are capped (at 168) for 3 blocks an SM: a few
// registers more drop the main-path dK/dV instance to 2 blocks and ~15%
// speed
template <int D> constexpr int tc_min_blocks() { return D > 64 ? 1 : 3; }

// the block's two resident tiles, the ring of two streamed tiles a stage,
// and 1024 bytes to align the tiles by hand (dQ: Q, dO resident, K/V
// streamed; dK/dV: K, V resident, Q/dO streamed)
template <int D>
constexpr int tc_smem_bytes() {
  return 2 * hopper::Tile<TC_BR, D>::BYTES +
         2 * TC_STAGES * hopper::Tile<tc_cols<D>(), D>::BYTES + 1024;
}

template <int D, int BCK, bool DROP>
__global__ void __launch_bounds__(NT, tc_min_blocks<D>())
    bwd_dq_tc_kernel(const Params p) {
  using namespace hopper;
  using QT = Tile<TC_BR, D>;
  using KT = Tile<BCK, D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int key_ok[TC_STAGES][BCK];    // key in range and unmasked
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t g_s = q_s + QT::BYTES;
  const uint32_t ring = g_s + QT::BYTES;
  auto k_st = [&](int sg) { return ring + 2 * sg * KT::BYTES; };
  auto v_st = [&](int sg) { return ring + (2 * sg + 1) * KT::BYTES; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);   // query rows r0, r0 + 8
  const int cq = 2 * (lane & 3);                  // columns cq, cq + 1 of 8
  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qt * TC_BR;
  const int S = p.S;
  const long long* st = p.st;

  typedef __nv_bfloat16 bf16;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * st[SQ] + h * st[SQ + 2];
  const bf16* K = static_cast<const bf16*>(p.k) + b * st[SK] + h * st[SK + 2];
  const bf16* V = static_cast<const bf16*>(p.v) + b * st[SV] + h * st[SV + 2];
  const bf16* G = static_cast<const bf16*>(p.g) + b * st[SG] + h * st[SG + 2];
  bf16* DQ = static_cast<bf16*>(p.dq) + b * st[SDQ] + h * st[SDQ + 2];
  const int32_t* M = p.mask ? p.mask + b * p.mask_sb : nullptr;

  int n_kt = (S + BCK - 1) / BCK;
  if (p.causal) n_kt = min(n_kt, (q0 + TC_BR - 1) / BCK + 1);

  auto issue = [&](int kt, int sg) {
    const int k0 = kt * BCK;
    load_tile<BCK, D, NT>(k_st(sg), K, st[SK + 1], k0, S);
    load_tile<BCK, D, NT>(v_st(sg), V, st[SV + 1], k0, S);
    if (tid < BCK) {
      const int kj = k0 + tid;
      key_ok[sg][tid] = kj < S && (M == nullptr || M[kj] != 0);
    }
  };
  load_tile<TC_BR, D, NT>(q_s, Q, st[SQ + 1], q0, S);
  load_tile<TC_BR, D, NT>(g_s, G, st[SG + 1], q0, S);
  issue(0, 0);
  cp_async_commit();

  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  float lse2[2], dl[2];          // LSE * log2 e and delta of the two rows
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool in = qi[hf] < S;
    lse2[hf] = in ? p.lse[(long long)bh * S + qi[hf]] * LOG2E : 0.f;
    dl[hf] = in ? p.delta[(long long)bh * S + qi[hf]] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const float sl2 = p.scale * LOG2E;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int sg = kt % TC_STAGES;
    const int k0 = kt * BCK;
    if (kt + 1 < n_kt) issue(kt + 1, (kt + 1) % TC_STAGES);
    cp_async_commit();           // possibly empty: one group per iteration
    cp_async_wait<1>();          // this thread's copies of tile kt landed
    fence_proxy_async();
    __syncthreads();             // ... and everyone else's

    float s[BCK / 2], dp[BCK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k<TC_BR, D>(q_s, kk), desc_k<BCK, D>(k_st(sg), kk),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k<TC_BR, D>(g_s, kk), desc_k<BCK, D>(v_st(sg), kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // element i: query row r0 + 8 * ((i / 2) % 2), key 8 * (i / 4) + cq
    // + i % 2. The key and causal tests are taken only on tiles at an
    // edge: the ragged end, the causal diagonal, or a key mask.
    const bool edge = k0 + BCK > S || M != nullptr ||
                      (p.causal && k0 + BCK - 1 > q0);
    uint32_t ok = 0;             // bit 2j + e: key 8j + cq + e is live
    if (edge) {
#pragma unroll
      for (int j = 0; j < BCK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ok |= (uint32_t)(key_ok[sg][8 * j + cq + e] != 0) << (2 * j + e);
    }
#pragma unroll
    for (int j = 0; j < BCK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + cq + e;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * j + 2 * hf + e;
          const bool alive =
              !edge || (((ok >> (2 * j + e)) & 1u) &&
                        !(p.causal && qi[hf] < kj));
          const float pr = ex2(fmaf(s[i], sl2, -lse2[hf]));
          float dpv = dp[i];
          if constexpr (DROP)
            dpv = kept(p, bh, qi[hf], kj) ? dpv / p.keep : 0.f;
          dp[i] = alive ? pr * (dpv - dl[hf]) : 0.f;
        }
      }

    // dS (rounded to bf16) as A fragments, 16 keys a k-step; B is the same
    // K tile, MN-major
    uint32_t da[BCK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BCK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BCK / 16; ++kk)
      wgmma_rs(dq, da[kk], desc_mn<BCK, D>(k_st(sg), kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    __syncthreads();             // stage sg is free for tile kt + 2
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (qi[hf] >= S) continue;
    bf16* row = DQ + (long long)qi[hf] * st[SDQ + 1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + cq) =
          __floats2bfloat162_rn(dq[i] * p.scale, dq[i + 1] * p.scale);
    }
  }
}

template <int D, int BCQ, bool DROP>
__global__ void __launch_bounds__(NT, tc_min_blocks<D>())
    bwd_dkv_tc_kernel(const Params p) {
  using namespace hopper;
  using KT = Tile<TC_BR, D>;
  using QT = Tile<BCQ, D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float lse_s[TC_STAGES][BCQ];   // LSE * log2 e
  __shared__ float dl_s[TC_STAGES][BCQ];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + KT::BYTES;
  const uint32_t ring = v_s + KT::BYTES;
  auto q_st = [&](int sg) { return ring + 2 * sg * QT::BYTES; };
  auto g_st = [&](int sg) { return ring + (2 * sg + 1) * QT::BYTES; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);   // key rows r0 and r0 + 8
  const int cq = 2 * (lane & 3);                  // columns cq, cq + 1 of 8
  const int kt = blockIdx.x;     // causal: tile 0 streams the most q tiles
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = kt * TC_BR;
  const int S = p.S;
  const long long* st = p.st;

  typedef __nv_bfloat16 bf16;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * st[SQ] + h * st[SQ + 2];
  const bf16* K = static_cast<const bf16*>(p.k) + b * st[SK] + h * st[SK + 2];
  const bf16* V = static_cast<const bf16*>(p.v) + b * st[SV] + h * st[SV + 2];
  const bf16* G = static_cast<const bf16*>(p.g) + b * st[SG] + h * st[SG + 2];
  bf16* DK = static_cast<bf16*>(p.dk) + b * st[SDK] + h * st[SDK + 2];
  bf16* DV = static_cast<bf16*>(p.dv) + b * st[SDV] + h * st[SDV + 2];
  const int32_t* M = p.mask ? p.mask + b * p.mask_sb : nullptr;

  const int kj[2] = {k0 + r0, k0 + r0 + 8};
  bool live[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    live[hf] = kj[hf] < S && (M == nullptr || M[kj[hf]] != 0);

  const int n_qt = (S + BCQ - 1) / BCQ;
  const int qt0 = p.causal ? k0 / BCQ : 0;

  auto issue = [&](int qt, int sg) {
    const int q0 = qt * BCQ;
    load_tile<BCQ, D, NT>(q_st(sg), Q, st[SQ + 1], q0, S);
    load_tile<BCQ, D, NT>(g_st(sg), G, st[SG + 1], q0, S);
    if (tid < BCQ) {
      const int qi = q0 + tid;
      const bool in = qi < S;
      lse_s[sg][tid] = in ? p.lse[(long long)bh * S + qi] * LOG2E : 0.f;
      dl_s[sg][tid] = in ? p.delta[(long long)bh * S + qi] : 0.f;
    }
  };
  load_tile<TC_BR, D, NT>(k_s, K, st[SK + 1], k0, S);
  load_tile<TC_BR, D, NT>(v_s, V, st[SV + 1], k0, S);
  issue(qt0, 0);                 // k0 < S, so qt0 < n_qt
  cp_async_commit();

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const float sl2 = p.scale * LOG2E;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int sg = (qt - qt0) % TC_STAGES;
    const int q0 = qt * BCQ;
    if (qt + 1 < n_qt) issue(qt + 1, (qt + 1 - qt0) % TC_STAGES);
    cp_async_commit();           // possibly empty: one group per iteration
    cp_async_wait<1>();          // this thread's copies of tile qt landed
    fence_proxy_async();
    __syncthreads();             // ... and everyone else's

    // transposed tiles: rows are this block's keys, columns the queries
    float s[BCQ / 2], dp[BCQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k<TC_BR, D>(k_s, kk), desc_k<BCQ, D>(q_st(sg), kk),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k<TC_BR, D>(v_s, kk), desc_k<BCQ, D>(g_st(sg), kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // element i: key row r0 + 8 * ((i / 2) % 2), query 8 * (i / 4) + cq
    // + i % 2. P = 2^(S^T * scale * log2 e - LSE * log2 e). The causal and
    // range tests are taken only on tiles at an edge (the diagonal, the
    // ragged end); a dead key row is dead in every tile.
    const bool edge = q0 + BCQ > S || (p.causal && q0 < k0 + TC_BR - 1);
#pragma unroll
    for (int j = 0; j < BCQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + cq + e;
        const int qi = q0 + ql;
        const float lse2 = lse_s[sg][ql];
        const float dl = dl_s[sg][ql];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * j + 2 * hf + e;
          const bool alive =
              live[hf] && (!edge || (qi < S && !(p.causal && qi < kj[hf])));
          const float pr = ex2(fmaf(s[i], sl2, -lse2));
          float pd = pr, dpv = dp[i];
          if constexpr (DROP) {
            const bool on = kept(p, bh, qi, kj[hf]);
            pd = on ? pr / p.keep : 0.f;
            dpv = on ? dpv / p.keep : 0.f;
          }
          s[i] = alive ? pd : 0.f;
          dp[i] = alive ? pr * (dpv - dl) : 0.f;
        }
      }

    // Pdrop^T and dS^T (rounded to bf16) as A fragments, 16 queries a k-step
    uint32_t pa[BCQ / 16][4], da[BCQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BCQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BCQ / 16; ++kk)
      wgmma_rs(dv, pa[kk], desc_mn<BCQ, D>(g_st(sg), kk), 1);
#pragma unroll
    for (int kk = 0; kk < BCQ / 16; ++kk)
      wgmma_rs(dk, da[kk], desc_mn<BCQ, D>(q_st(sg), kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();             // stage sg is free for tile qt + 2
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (kj[hf] >= S) continue;
    bf16* rk = DK + (long long)kj[hf] * st[SDK + 1];
    bf16* rv = DV + (long long)kj[hf] * st[SDV + 1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(rk + 8 * j + cq) =
          __floats2bfloat162_rn(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(rv + 8 * j + cq) =
          __floats2bfloat162_rn(dv[i], dv[i + 1]);
    }
  }
}

// ----------------------------------------------------------------- launch

template <int D>
cudaError_t launch_dq_f32(const Params& p, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> done[2];
  return launcher::pair<dq_f32_smem_bytes<D>(), NT>(
      bwd_dq_f32_kernel<D, false>, bwd_dq_f32_kernel<D, true>, done,
      F32_ROWS<D>, p, B, stream);
}

template <int D>
cudaError_t launch_dkv_f32(const Params& p, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> done[2];
  return launcher::pair<dkv_f32_smem_bytes<D>(), NT>(
      bwd_dkv_f32_kernel<D, false>, bwd_dkv_f32_kernel<D, true>, done,
      F32_ROWS<D>, p, B, stream);
}

template <int D>
cudaError_t launch_dq_tc(const Params& p, int B, cudaStream_t stream) {
  constexpr int BCK = tc_cols<D>();
  static std::atomic<unsigned long long> done[2];
  return launcher::pair<tc_smem_bytes<D>(), NT>(
      bwd_dq_tc_kernel<D, BCK, false>, bwd_dq_tc_kernel<D, BCK, true>, done,
      TC_BR, p, B, stream);
}

template <int D>
cudaError_t launch_dkv_tc(const Params& p, int B, cudaStream_t stream) {
  constexpr int BCQ = tc_cols<D>();
  static std::atomic<unsigned long long> done[2];
  return launcher::pair<tc_smem_bytes<D>(), NT>(
      bwd_dkv_tc_kernel<D, BCQ, false>, bwd_dkv_tc_kernel<D, BCQ, true>, done,
      TC_BR, p, B, stream);
}

// bf16 on the tensor cores, fp32 on the CUDA cores; no other path
template <int D>
cudaError_t launch_d(bool dkv, bool bf16, const Params& p, int B,
                     cudaStream_t stream) {
  if (bf16)
    return dkv ? launch_dkv_tc<D>(p, B, stream) : launch_dq_tc<D>(p, B, stream);
  return dkv ? launch_dkv_f32<D>(p, B, stream)
             : launch_dq_f32<D>(p, B, stream);
}

int launch(bool dkv, const void* q, const void* k, const void* v,
           const void* g, const float* lse, const float* delta,
           const int32_t* mask, void* dq, void* dk, void* dv,
           const long long* strides, long long mask_sb, int B, int H, int S,
           int D, int is_bf16, float scale, int causal, int dropout_on,
           float keep, unsigned int thresh, unsigned int seed, void* stream) {
  cudaGetLastError();            // report this launch's error, not a stale one
  if (B < 1 || H < 1 || S < 1 || (long long)B * H > 65535 ||
      strides == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.g = g;
  p.lse = lse; p.delta = delta; p.mask = mask;
  p.dq = dq; p.dk = dk; p.dv = dv;
  for (int i = 0; i < NSTRIDES; ++i) p.st[i] = strides[i];
  p.mask_sb = mask_sb;
  p.H = H; p.S = S;
  p.scale = scale; p.causal = causal; p.dropout_on = dropout_on;
  p.keep = keep; p.thresh = thresh; p.seed = seed;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (D) {
    case 32: return (int)launch_d<32>(dkv, bf16, p, B, st);
    case 64: return (int)launch_d<64>(dkv, bf16, p, B, st);
    case 128: return (int)launch_d<128>(dkv, bf16, p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. Both take the same arguments:
// q, k, v, dO and the outputs share one shape; strides holds 21 element
// strides, (batch, seq, head) of q, k, v, dO, dQ, dK, dV in that order (the
// outputs a kernel does not write may be null with zero strides). The last
// (head_dim) axis of every operand must be contiguous. lse and delta are
// (B,H,S) fp32, contiguous; mask may be null. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, const int32_t* mask,
    void* dq, void* dk, void* dv, const long long* strides,
    long long mask_sb, int B, int H, int S, int D, int is_bf16,
    float scale, int causal, int dropout_on, float keep,
    unsigned int thresh, unsigned int seed, void* stream) {
  return launch(false, q, k, v, g, lse, delta, mask, dq, dk, dv, strides,
                mask_sb, B, H, S, D, is_bf16, scale, causal, dropout_on, keep,
                thresh, seed, stream);
}

extern "C" int flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, const int32_t* mask,
    void* dq, void* dk, void* dv, const long long* strides,
    long long mask_sb, int B, int H, int S, int D, int is_bf16,
    float scale, int causal, int dropout_on, float keep,
    unsigned int thresh, unsigned int seed, void* stream) {
  return launch(true, q, k, v, g, lse, delta, mask, dq, dk, dv, strides,
                mask_sb, B, H, S, D, is_bf16, scale, causal, dropout_on, keep,
                thresh, seed, stream);
}
