// Flash-attention forward for Hopper (sm_90a), one kernel for two layouts.
//
// Replaces the two Pallas forward kernels of the JAX package:
//   mxnet_tpu/ops/pallas_kernels.py  _bshd_fwd_kernel  (head-fused, (B,S,H,D))
//   mxnet_tpu/ops/pallas_kernels.py  _attn_fwd_kernel  (per head, (B*H,S,D))
// Mosaic's per-head block rule is why two families exist on the TPU. Here
// the kernel takes element strides for (batch, seq, head), so the (B,S,H,D)
// and (B,H,S,D) wrappers both call it on views, without a copy.
//
// Semantics kept exactly (pallas_kernels.py:166-214, 239-280):
//   - scale = 1/sqrt(D); QK^T and PV take the operand type (fp32 or bf16)
//     and accumulate in fp32; the online softmax runs in fp32.
//   - causal: query q sees key k <= q; key tiles past the diagonal are
//     skipped, not masked.
//   - key mask (B,S), nonzero = attend; masked positions contribute exactly
//     0; a fully masked row outputs 0 (the l >= 1e-20 clamp).
//   - the normaliser l sums the PRE-dropout, unrounded fp32 P.
//   - dropout keeps where lowbias32(q*0x9E3779B9 ^ k*0x85EBCA6B ^
//     bh*0xC2B2AE35 ^ seed) < floor(keep*2^32), uint32 over the global
//     (b*H+h, q, k) coordinates: the same bits as the TPU kernel.
//   - P is rounded to the operand type before PV.
//   - writes the per-row logsumexp, (B,H,S) fp32, for the backward pass.
//
// What bounds it on the H100: at the prefill and training shapes (D=64, S
// up to a few thousand) attention does ~S/2 FLOPs per byte of Q/K/V/O. On
// the CUDA cores (67 TFLOP/s fp32) that is far above the ridge point, so
// the fp32 kernel is bound by operations; on the tensor cores (989 TFLOP/s
// bf16) the ridge is ~295 FLOPs a byte, so the bf16 kernel at S 512 is
// bound by bytes, and by latency at small grids.
//
// Two kernels, chosen by the operand type in the C entry point:
//
// bf16: flash_fwd_tc_kernel, on the tensor cores. One warpgroup (128
// threads) per (64-row query tile, b*h): 64 rows is wgmma's M, and at the
// serving shape B 1, S 1024, H 12 it gives 192 blocks for 132 SMs (128-row
// tiles would give 96; two warpgroups sharing each K/V tile measured no
// faster at the training shape either). Both products are wgmma
// (hopper_tc.cuh): S = Q K^T reads Q and the K tile from shared memory
// (both K-major); O += P V takes P from registers and the V tile from
// shared memory (MN-major, transposed by wgmma). K/V tiles of 64 keys stay
// bf16 in a ring of two stages filled by cp.async: tile t+1 is in flight
// while tile t computes. Each thread keeps its two rows of S, P and O in
// the accumulator fragment (rows 16w + l/4 and +8, 2 columns of every 8),
// so the masks and dropout bits are taken at each element's own global
// (q, k); row max and row sum reduce over the 4 lanes that share a row.
// The S accumulator of 16 keys becomes the bf16 A fragment of PV in place,
// with no shared-memory round trip. The element-wise work on the CUDA
// cores is what the tensor cores wait for, so it is kept short: the
// softmax runs in log2 units (one FMA and one ex2 an element), masks are
// tested only on tiles at an edge, dropout is a template flag, O is
// rescaled only when a row max moved, and at D <= 64 the registers are
// capped so that 4 blocks share an SM.
//
// fp32: flash_fwd_kernel, on the CUDA cores (the reference keeps fp32 math;
// TF32 would change the numbers). One block of 128 threads per (64-row
// query tile, b*h). Q, K, V tiles of 64 rows are staged in shared memory as
// fp32 with a padded row stride (D+1) so that the column reads below hit
// distinct banks. Thread t owns query rows (t/16) + 8i, i < 8, in both
// products: for S = QK^T it holds 8x4 scores (keys (t%16) + 16j), for O it
// holds 8 x D/16 outputs (columns (t%16) + 16j). Row max and row sum reduce
// over the 16 lanes of a half-warp with shuffles; P is staged in shared
// memory for the PV product.
//
// Both mask ragged edges (S not a multiple of 64) in the kernel and run
// causal query tiles heaviest first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper_tc.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // key rows per tile
constexpr int NT = 128;          // threads per block
constexpr int RM = BQ / 8;       // query rows per thread
constexpr int CN = BK / 16;      // score columns per thread
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* mask;
  float* lse;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long mask_sb;
  int H, S;
  float scale;
  int causal;
  int dropout_on;
  float keep;          // 1 - dropout, as float32
  uint32_t thresh;     // min(floor(keep * 2^32), 2^32 - 1)
  uint32_t seed;
};

// the CUDA-core kernel runs fp32 only; bf16 goes to the tensor-core one
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// P enters the PV product in the operand type (pallas_kernels.py:212).
template <typename T> __device__ __forceinline__ float operand(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 1;      // padded fp32 row stride of q_s/k_s/v_s
  constexpr int LP = BK + 1;     // padded row stride of p_s
  constexpr int DN = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * LD;
  float* v_s = k_s + BK * LD;
  float* p_s = v_s + BK * LD;
  __shared__ int key_ok[BK];

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qt * BQ;
  const int S = p.S;

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int32_t* M = p.mask ? p.mask + b * p.mask_sb : nullptr;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - (i / D) * D;
    const int qi = q0 + r;
    q_s[r * LD + d] = qi < S ? to_f(Q[(long long)qi * p.q_ss + d]) : 0.f;
  }

  float acc[RM][DN];
  float m_i[RM], l_i[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (S + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();             // last tile's reads of k_s/v_s/p_s are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i - (i / D) * D;
      const int kj = k0 + r;
      const bool in = kj < S;
      k_s[r * LD + d] = in ? to_f(K[(long long)kj * p.k_ss + d]) : 0.f;
      v_s[r * LD + d] = in ? to_f(V[(long long)kj * p.v_ss + d]) : 0.f;
    }
    if (tid < BK) {
      const int kj = k0 + tid;
      key_ok[tid] = kj < S && (M == nullptr || M[kj] != 0);
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = q_s[(tr + 8 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = k_s[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + tr + 8 * i;
      bool dead[CN];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kl = tc + 16 * j;
        dead[j] = !key_ok[kl] || (p.causal && qi < k0 + kl);
        s[i][j] = dead[j] ? NEG_INF : s[i][j] * p.scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = dead[j] ? 0.f : expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kl = tc + 16 * j;
        float pv = s[i][j];
        if (p.dropout_on) {
          const uint32_t c = ((uint32_t)qi * 0x9E3779B9u) ^
                             ((uint32_t)(k0 + kl) * 0x85EBCA6Bu) ^
                             ((uint32_t)bh * 0xC2B2AE35u) ^ p.seed;
          pv = lowbias32(c) < p.thresh ? pv / p.keep : 0.f;
        }
        p_s[(tr + 8 * i) * LP + kl] = operand<T>(pv);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pr[RM], vr[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pr[i] = p_s[(tr + 8 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DN; ++j) vr[j] = v_s[kk * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + tr + 8 * i;
    if (qi >= S) continue;
    const float l = fmaxf(l_i[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DN; ++j)
      O[(long long)qi * p.o_ss + tc + 16 * j] = from_f<T>(acc[i][j] / l);
    if (tc == 0) p.lse[(long long)bh * S + qi] = m_i[i] + logf(l);
  }
}


// ------------------------------------------------ bf16, on the tensor cores

constexpr int TC_STAGES = 2;     // K/V ring depth

template <int D>
constexpr int tc_smem_bytes() {
  // Q, the K/V ring, and 1024 bytes to align the tiles by hand
  return hopper::Tile<BQ, D>::BYTES +
         2 * TC_STAGES * hopper::Tile<BK, D>::BYTES + 1024;
}

// at D <= 64 the registers are capped (at 128) for 4 blocks an SM
template <int D> constexpr int tc_min_blocks() { return D > 64 ? 1 : 4; }

template <int D, bool DROP>
__global__ void __launch_bounds__(NT, tc_min_blocks<D>())
    flash_fwd_tc_kernel(const Params p) {
  using namespace hopper;
  using QT = Tile<BQ, D>;
  using KT = Tile<BK, D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int key_ok[TC_STAGES][BK];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_s + QT::BYTES;
  auto k_st = [&](int st) { return ring + 2 * st * KT::BYTES; };
  auto v_st = [&](int st) { return ring + (2 * st + 1) * KT::BYTES; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);   // rows r0 and r0 + 8
  const int cq = 2 * (lane & 3);                  // columns cq, cq + 1 of 8
  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qt * BQ;
  const int S = p.S;

  typedef __nv_bfloat16 bf16;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* O = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int32_t* M = p.mask ? p.mask + b * p.mask_sb : nullptr;

  int n_kt = (S + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  auto issue = [&](int kt, int st) {
    const int k0 = kt * BK;
    load_tile<BK, D, NT>(k_st(st), K, p.k_ss, k0, S);
    load_tile<BK, D, NT>(v_st(st), V, p.v_ss, k0, S);
    if (tid < BK) {
      const int kj = k0 + tid;
      key_ok[st][tid] = kj < S && (M == nullptr || M[kj] != 0);
    }
  };
  load_tile<BQ, D, NT>(q_s, Q, p.q_ss, q0, S);
  issue(0, 0);
  cp_async_commit();

  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};   // m in log2 units
  const float sl2 = p.scale * LOG2E;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % TC_STAGES;
    const int k0 = kt * BK;
    if (kt + 1 < n_kt) issue(kt + 1, (kt + 1) % TC_STAGES);
    cp_async_commit();           // possibly empty: one group per iteration
    cp_async_wait<1>();          // this thread's copies of tile kt landed
    fence_proxy_async();
    __syncthreads();             // ... and everyone else's

    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_k<BQ, D>(q_s, kk), desc_k<BK, D>(k_st(st), kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // element i of sc: row r0 + 8 * ((i / 2) % 2), key 8 * (i / 4) + cq
    // + i % 2. Dead scores become NEG_INF, tested only on tiles at an
    // edge: the ragged end, the causal diagonal, or a key mask.
    if (k0 + BK > S || M != nullptr || (p.causal && k0 + BK - 1 > q0)) {
      uint32_t ok = 0;           // bit 2j + e: key 8j + cq + e attends
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ok |= (uint32_t)(key_ok[st][8 * j + cq + e] != 0) << (2 * j + e);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool live = ((ok >> (2 * j + e)) & 1u) &&
                              !(p.causal && qi[hf] < k0 + 8 * j + cq + e);
            if (!live) sc[4 * j + 2 * hf + e] = NEG_INF;
          }
    }
    // p = 2^(s * scale * log2 e - m), m the running row max in log2 units
    float corr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[hf], mx == NEG_INF ? NEG_INF : mx * sl2);
      // a row dead so far keeps m = NEG_INF; subtracting 0 then sends its
      // NEG_INF scores to 2^-1e30 = 0, as every dead score
      const float m_use = m_new == NEG_INF ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hf + e;
          const float pr = ex2(fmaf(sc[i], sl2, -m_use));
          rs += pr;              // the normaliser: pre-dropout, unrounded
          if constexpr (DROP) {
            const uint32_t c = ((uint32_t)qi[hf] * 0x9E3779B9u) ^
                               ((uint32_t)(k0 + 8 * j + cq + e) *
                                0x85EBCA6Bu) ^
                               ((uint32_t)bh * 0xC2B2AE35u) ^ p.seed;
            sc[i] = lowbias32(c) < p.thresh ? pr / p.keep : 0.f;
          } else {
            sc[i] = pr;
          }
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      corr[hf] = ex2(m_i[hf] - m_use);
      l_i[hf] = l_i[hf] * corr[hf] + rs;
      m_i[hf] = m_new;
    }
    // rescale O only where a row max of this warp moved
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[4 * j + r] *= corr[r / 2];
    }

    // P (rounded to bf16) as the A fragments of PV, 16 keys a k-step
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o, pa[kk], desc_mn<BK, D>(v_st(st), kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();             // stage st is free for tile kt + 2
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (qi[hf] >= S) continue;
    const float l = fmaxf(l_i[hf], 1e-20f);
    bf16* row = O + (long long)qi[hf] * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j + 2 * hf] / l,
                                o[4 * j + 2 * hf + 1] / l);
    if ((lane & 3) == 0)         // natural units; NEG_INF stays NEG_INF
      p.lse[(long long)bh * S + qi[hf]] =
          (m_i[hf] == NEG_INF ? NEG_INF : m_i[hf] * LN2) + logf(l);
  }
}

// ----------------------------------------------------------------- launch

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) *
         (int)sizeof(float);
}

// above 48 KB a block's dynamic shared memory needs an opt-in, once per
// device and kernel (one bit each), so a launch can also be captured in a
// CUDA graph
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes,
                   std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  constexpr int bytes = tc ? tc_smem_bytes<D>() : smem_bytes<D>();
  static std::atomic<unsigned long long> done[2];   // per kernel below
  void (*kernel)(const Params) = nullptr;
  if constexpr (tc)
    kernel = p.dropout_on ? flash_fwd_tc_kernel<D, true>
                          : flash_fwd_tc_kernel<D, false>;
  else
    kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = opt_in(kernel, bytes, done[tc && p.dropout_on]);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BQ - 1) / BQ, B * p.H);
  kernel<<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Strides are in elements; the
// last (head_dim) axis of q, k, v and o must be contiguous. mask may be
// null. Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int32_t* mask, float* lse,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long mask_sb,
    int B, int H, int S, int D, int is_bf16,
    float scale, int causal, int dropout_on, float keep,
    unsigned int thresh, unsigned int seed, void* stream) {
  cudaGetLastError();            // report this launch's error, not a stale one
  if (B < 1 || H < 1 || S < 1 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.mask = mask; p.lse = lse;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.mask_sb = mask_sb;
  p.H = H; p.S = S;
  p.scale = scale; p.causal = causal; p.dropout_on = dropout_on;
  p.keep = keep; p.thresh = thresh; p.seed = seed;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch_d<__nv_bfloat16>(p, B, D, st)
                            : launch_d<float>(p, B, D, st);
  return (int)err;
}
