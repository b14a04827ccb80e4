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
//   - the normaliser l sums the PRE-dropout P.
//   - dropout keeps where lowbias32(q*0x9E3779B9 ^ k*0x85EBCA6B ^
//     bh*0xC2B2AE35 ^ seed) < floor(keep*2^32), uint32 over the global
//     (b*H+h, q, k) coordinates: the same bits as the TPU kernel.
//   - writes the per-row logsumexp, (B,H,S) fp32, for the backward pass.
//
// What bounds it on the H100: at the prefill shapes (D=64, S up to a few
// thousand) attention does ~S/2 FLOPs per byte of Q/K/V/O, far above the
// card's ridge point, so it is bound by operations. This first version
// computes on the CUDA cores in fp32 (67 TFLOP/s peak), not on the tensor
// cores; the products of two bf16 values are exact in fp32, so a bf16 input
// gets the same numbers a tensor-core product with fp32 accumulation gives.
//
// Design: one block of 128 threads per (64-row query tile, b*h). Q, K, V
// tiles of 64 rows are staged in shared memory as fp32 with a padded row
// stride (D+1) so that the column reads below hit distinct banks. Thread t
// owns query rows (t/16) + 8i, i < 8, in both products: for S = QK^T it
// holds 8x4 scores (keys (t%16) + 16j), for O it holds 8 x D/16 outputs
// (columns (t%16) + 16j). Row max and row sum reduce over the 16 lanes of a
// half-warp with shuffles; P is staged in shared memory for the PV product.
// Ragged edges (S not a multiple of 64) are masked in the kernel. Causal
// query tiles run heaviest first. wgmma/TMA come in a later version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
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

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) *
         (int)sizeof(float);
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  // above 48 KB a block's dynamic shared memory needs an opt-in, once per
  // device (one bit each), so a launch can also be captured in a graph
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted_in.load() & bit)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    opted_in.fetch_or(bit);
  }
  dim3 grid((p.S + BQ - 1) / BQ, B * p.H);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(p);
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
