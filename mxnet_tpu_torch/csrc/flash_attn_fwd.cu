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
// Two kernels, one for each operand type, chosen in the C entry point:
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
// fp32: flash_fwd_f32_kernel, on the CUDA cores in fp32 (the reference keeps
// fp32 products; TF32 would change the numbers). One block of 128 threads per
// (query tile of BR rows, b*h), heaviest causal tiles first. BR is 64, or 32
// where 64-row tiles would give fewer than 2 blocks an SM: there the heaviest
// causal tile, nearly alone on its SM, sets the time (on an H100 at the
// serving shape B 1, S 1024, H 12, 192 tiles of 64 rows for 132 SMs, 32-row
// tiles took 0.139 to 0.129 ms; at the training shape they cost 29%, so the
// launch picks by grid size). Q is a resident fp32 row tile (row stride D + 4,
// hopper_simt.cuh); K and V tiles of 32 keys and their per-key live bits
// stream through a two-stage cp.async ring, tile t+1 in flight while t
// computes. Its pace is set by how many shared-memory loads feed each FMA, so
// every operand is read as float4: S = Q K^T is a micro-tile in which thread
// (t / 8, t % 8) owns rows tr + 16i and keys tc + 8j (8 FMAs an LDS.128 at D
// 64). The same thread keeps rows tr + 16i of O (columns 4tc + 32c .. + 3), so
// the row max, sum and correction stay in registers: row max and sum reduce
// over the 8 lanes that share a row, P goes through shared memory (row stride
// 40 floats, conflict-free writes) read back only by the warp that wrote it
// (no block barrier), and O += P V reads, per 4 keys, one float4 of each own P
// row and D/32 of each of the 4 V rows (10.7 FMAs an LDS.128 at D 64). The
// softmax is the bf16 kernel's: log2 units, masks tested only on tiles with a
// dead key or on the diagonal, dropout a template flag, O rescaled only where
// a row max moved. 62,464 bytes of shared memory a block at D 64 and BR 64 (3
// blocks an SM).
//
// Both mask ragged edges (S not a multiple of a tile) in the kernel and run
// causal query tiles heaviest first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper_simt.cuh"
#include "hopper_tc.cuh"
#include "launch.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block (bf16)
constexpr int NT = 128;          // threads per block
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

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// dropout keeps (q, k) of head bh where lowbias32 of the mixed global
// coordinates is below the threshold
__device__ __forceinline__ bool kept(const Params& p, int bh, int qi,
                                     int kj) {
  const uint32_t c = ((uint32_t)qi * 0x9E3779B9u) ^
                     ((uint32_t)kj * 0x85EBCA6Bu) ^
                     ((uint32_t)bh * 0xC2B2AE35u) ^ p.seed;
  return lowbias32(c) < p.thresh;
}

// ----------------------------------------------- fp32, on the CUDA cores

constexpr int F_BC = 32;         // keys per streamed tile
constexpr int F_STAGES = 2;      // K/V ring depth
constexpr int F_LP = F_BC + 8;   // row stride of p_s (floats)

template <int D, int BR>
constexpr int f32_smem_bytes() {
  // Q; the K/V ring; P
  return simt::RowTile<BR, D>::BYTES +
         2 * F_STAGES * simt::RowTile<F_BC, D>::BYTES +
         BR * F_LP * (int)sizeof(float);
}

// BR query rows per block (64, or 32 on small grids)
template <int D, int BR, bool DROP>
__global__ void __launch_bounds__(NT, D > 64 ? 2 : 3)
    flash_fwd_f32_kernel(const Params p) {
  using simt::ld4;
  using simt::at;
  constexpr int LD = simt::RowTile<BR, D>::LD;
  constexpr int TILE = simt::RowTile<F_BC, D>::FLOATS;
  constexpr int RM = BR / 16;    // rows per thread: tr + 16i
  constexpr int CH = D / 32;     // O: float4 chunks a row, columns 4tc + 32c
  static_assert(F_BC == 32 && CH >= 1, "micro-tiles");
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* ring = q_s + simt::RowTile<BR, D>::FLOATS;   // K, V of each stage
  float* p_s = ring + 2 * F_STAGES * TILE;            // P, BR x F_LP
  __shared__ uint32_t live_s[F_STAGES];   // bit k: key k0 + k is live

  const int tid = threadIdx.x;
  const int tr = tid >> 3;       // rows tr + 16i of S, P and O
  const int tc = tid & 7;        // keys tc + 8j; O columns 4tc + 32c .. + 3
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = qt * BR;
  const int S = p.S;

  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int32_t* M = p.mask ? p.mask + b * p.mask_sb : nullptr;

  int n_kt = (S + F_BC - 1) / F_BC;
  if (p.causal) n_kt = min(n_kt, (q0 + BR - 1) / F_BC + 1);

  auto issue = [&](int kt, int sg) {
    const int k0 = kt * F_BC;
    simt::load_rows<F_BC, D, NT>(ring + 2 * sg * TILE, K, p.k_ss, k0, S);
    simt::load_rows<F_BC, D, NT>(ring + (2 * sg + 1) * TILE, V, p.v_ss, k0,
                                 S);
    if (tid < 32) {
      const uint32_t w = simt::live_bits(M, k0, S);
      if (tid == 0) live_s[sg] = w;
    }
  };
  simt::load_rows<BR, D, NT>(q_s, Q, p.q_ss, q0, S);
  issue(0, 0);
  hopper::cp_async_commit();

  float o[RM][CH][4];
  float m_i[RM], l_i[RM];        // m in log2 units
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) o[i][c][u] = 0.f;
  }
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

    float s[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    simt::dot_tile<RM, D, LD>(s, q_s + tr * LD, k_s + tc * LD);

    // dead scores become NEG_INF, tested only on tiles with a dead key or
    // on the causal diagonal
    const uint32_t lw = live_s[sg];
    const bool diag = p.causal && k0 + F_BC - 1 > q0;
    if (diag || lw != 0xffffffffu) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = tc + 8 * j;
        const bool key = (lw >> kl) & 1u;
#pragma unroll
        for (int i = 0; i < RM; ++i)
          if (!key || (diag && q0 + tr + 16 * i < k0 + kl)) s[i][j] = NEG_INF;
      }
    }
    // p = 2^(s * scale * log2 e - m), m the running row max in log2 units;
    // a row's max and sum reduce over the 8 lanes that share it
    float corr[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx == NEG_INF ? NEG_INF : mx * sl2);
      // a row dead so far keeps m = NEG_INF; subtracting 0 then sends its
      // NEG_INF scores to 2^-1e30 = 0, as every dead score
      const float m_use = m_new == NEG_INF ? 0.f : m_new;
      const int qi = q0 + tr + 16 * i;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = hopper::ex2(fmaf(s[i][j], sl2, -m_use));
        rs += pr;                // the normaliser: pre-dropout, unrounded
        float pd = pr;
        if constexpr (DROP)
          pd = kept(p, bh, qi, k0 + tc + 8 * j) ? pr / p.keep : 0.f;
        p_s[(tr + 16 * i) * F_LP + tc + 8 * j] = pd;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      corr[i] = hopper::ex2(m_i[i] - m_use);
      l_i[i] = l_i[i] * corr[i] + rs;
      m_i[i] = m_new;
    }
    // rescale O only where a row max of this warp moved
    bool moved = false;
#pragma unroll
    for (int i = 0; i < RM; ++i) moved |= corr[i] != 1.f;
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int u = 0; u < 4; ++u) o[i][c][u] *= corr[i];
    }
    __syncwarp();                // a row's P is written and read by one warp

    // O += P V: per 4 keys, one float4 of each own P row (a broadcast in
    // the quarter-warp) and CH float4s of each V row
#pragma unroll 2
    for (int kk = 0; kk < F_BC; kk += 4) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = ld4(p_s + (tr + 16 * i) * F_LP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 w[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c)
          w[c] = ld4(v_s + (kk + u) * LD + 4 * tc + 32 * c);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float x = at(a[i], u);
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            o[i][c][0] = fmaf(x, w[c].x, o[i][c][0]);
            o[i][c][1] = fmaf(x, w[c].y, o[i][c][1]);
            o[i][c][2] = fmaf(x, w[c].z, o[i][c][2]);
            o[i][c][3] = fmaf(x, w[c].w, o[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= S) continue;
    const float l = fmaxf(l_i[i], 1e-20f);
    float* row = O + (long long)qi * p.o_ss;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      *reinterpret_cast<float4*>(row + 4 * tc + 32 * c) =
          make_float4(o[i][c][0] / l, o[i][c][1] / l, o[i][c][2] / l,
                      o[i][c][3] / l);
    if (tc == 0)                 // natural units; NEG_INF stays NEG_INF
      p.lse[(long long)bh * S + qi] =
          (m_i[i] == NEG_INF ? NEG_INF : m_i[i] * hopper::LN2) + logf(l);
  }
}

// ------------------------------------------------ bf16, on the tensor cores

constexpr int BK = 64;           // key rows per tile
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

// fp32 on 64-row query tiles, or on 32-row ones where 64-row tiles would
// give fewer than two blocks an SM: there the heaviest causal tile sets the
// time, and halving it pays more than the smaller tiles cost
template <int D, int BR>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> done[2];
  return launcher::pair<f32_smem_bytes<D, BR>(), NT>(
      flash_fwd_f32_kernel<D, BR, false>, flash_fwd_f32_kernel<D, BR, true>,
      done, BR, p, B, stream);
}

// bf16 on the tensor cores, fp32 on the CUDA cores; no other path
template <int D>
cudaError_t launch(bool bf16, const Params& p, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> done_tc[2];
  if (bf16)
    return launcher::pair<tc_smem_bytes<D>(), NT>(
        flash_fwd_tc_kernel<D, false>, flash_fwd_tc_kernel<D, true>, done_tc,
        BQ, p, B, stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((p.S + 63) / 64) * B * p.H;
  return tiles < 2LL * sms ? launch_f32<D, 32>(p, B, stream)
                           : launch_f32<D, 64>(p, B, stream);
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
  const bool bf16 = is_bf16 != 0;
  switch (D) {
    case 32: return (int)launch<32>(bf16, p, B, st);
    case 64: return (int)launch<64>(bf16, p, B, st);
    case 128: return (int)launch<128>(bf16, p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
