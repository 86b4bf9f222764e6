// The chunked gated delta rule of Kimi Delta Attention (KDA), forward, for
// NVIDIA Hopper (sm_90a): the scan of models/kimi_linear.py's
// KimiDeltaAttention, ops/kda.py's kda_chunked.
//
// Replaces no TPU kernel: the JAX package has no linear attention. As a
// loop of PyTorch ops over the chunks (ops/kda.py::kda_ops) the scan is
// some 40 launches a chunk, 512 chunks a 32,768-token layer, and leaves
// the card waiting on the host. Per (batch, head), chunks of C = 64
// tokens, d_k = d_v = 128, G_t the running sum of the log decays g from a
// chunk's first token, S_0 the float32 state at its start:
//   A[t, s] = beta_t sum_c k_t[c] k_s[c] exp(G_t[c] - G_s[c])        (s < t)
//   M[t, s] = scale sum_c q_t[c] k_s[c] exp(G_t[c] - G_s[c])         (s <= t)
//   (I + A) [W_k | W_v] = [beta K exp(G) | beta V]
//   U = W_v - W_k S_0;  O = (scale Q exp(G)) S_0 + M U
//   S_C = Diag(exp G_C) S_0 + (K exp(G_C - G))^T U
// Every exponent is a difference of known sign: pairs of two 16-token
// sub-blocks meet at the token r just before the later one,
// exp(G_t - G_r) exp(G_r - G_s), both factors at most 1; pairs inside one
// sub-block take exp(G_t - G_s) directly. No decay overflows.
//
// Bound: memory. A layer of (1, 32,768, 32, 128) reads q, k, v (bf16), g
// (float32) and beta and writes o: ~1.6 GB, 0.48 ms at 3.35 TB/s, against
// ~1.5e11 FLOPs, 0.15 ms at 989.4 TFLOP/s. The recurrence is sequential
// over the chunks, so the state pass has only (batch x heads x d_v / 32)
// CTAs.
//
// Design: two launches, on the caller's stream.
//   - kda_intra, one CTA (16 warps) a (chunk, head, batch): everything that
//     does not depend on the state. Loads the chunk's k, q and g, sums g
//     down the chunk, forms A and M (off-diagonal sub-block pairs as
//     bf16 warp MMAs (nvcuda::wmma, float32 accumulators) of the
//     reference-point operands; diagonal sub-blocks in float32, a thread
//     a pair), inverts the unit lower triangular I + A in float32 (16 x 16
//     diagonal blocks by substitution, then the off-diagonal blocks a
//     block diagonal at a time), and takes [W_k | W_v] = T R as bf16 MMAs.
//     Writes W_k, W_v, scale Q exp(G), K exp(G_C - G) and M in bf16 and
//     exp(G_C) in float32: ~74 KB a chunk;
//   - kda_state, one CTA (8 warps) a (32 columns of d_v, head, batch):
//     walks the chunks in order with its 128 x 32 slice of the state in
//     float32 shared memory; each chunk's records come through a double
//     buffer of shared memory by cp.async, the next chunk's copy in flight
//     while this one is computed. U, O and the state update are bf16 warp
//     MMAs (the state and U rounded to bf16 as operands) accumulated in
//     float32; O leaves as bf16, (B, T, H, d_v) contiguous.
// Beside the scan, kda_conv: the layer's short convolutions (causal,
// depthwise, 4 taps over the q, k and v projections), SiLU and the q and k
// L2 norms in one pass (PyTorch's depthwise conv1d and a strided SiLU took
// ~7 ms a layer at 12,288 channels x 32,768 tokens; this reads and writes
// each element once, ~1 ms). The file builds with --fmad=false:
// multiply-adds are explicit fmaf. A call takes one packed struct, makes
// its launches (two for the scan, one for the conv), allocates nothing,
// never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <climits>

// Mirrored field for field by ops/_kernels.py::KDA_LAUNCH_FIELDS. At file
// scope: the extern "C" launcher takes it, so it needs external linkage.
struct KdaLaunch {
  const void* q;      // (batch, seq, heads, 128) bf16, contiguous
  const void* k;      // the same
  const void* v;      // the same
  const float* g;     // (batch, seq, heads, 128) float32
  const float* beta;  // (batch, seq, heads) float32
  void* out;          // (batch, seq, heads, 128) bf16
  // the intra-chunk pass's records, one a (batch, head, chunk) in that
  // order: (64, 128) bf16 each, (64, 64) bf16, (128,) float32
  void* wk;
  void* wv;
  void* qt;
  void* kb;
  void* mm;
  float* gam;
  long long batch;
  long long seq;
  long long heads;
  float scale;
};

// Mirrored field for field by ops/_kernels.py::KDA_CONV_LAUNCH_FIELDS.
struct KdaConvLaunch {
  const void* x;  // (batch, seq, 3 * heads * 128) bf16, contiguous: q | k | v
  const void* w;  // (3 * heads * 128, 4) bf16, contiguous
  void* q;        // (batch, seq, heads, 128) bf16 each
  void* k;
  void* v;
  long long batch;
  long long seq;
  long long heads;
};

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int C = 64;    // tokens a chunk
constexpr int D = 128;   // d_k = d_v
constexpr int SUB = 16;  // tokens a sub-block
constexpr int NSUB = C / SUB;
constexpr int kWarps = 8;  // the state pass
constexpr int kThreads = kWarps * 32;
constexpr int kIntraWarps = 16;
constexpr int kIntraThreads = kIntraWarps * 32;
constexpr int DVS = 32;  // state columns a state-pass CTA
// padded leading dimensions of shared-memory tiles (bank spread; each a
// multiple of 8 bf16 or 4 floats, and 16-row blocks 32-byte aligned)
constexpr int LDK = D + 8;      // bf16 rows of 128
constexpr int LDA = C + 4;      // float rows of 64
constexpr int LDT = C + 8;      // bf16 rows of 64
constexpr int LDR = 2 * D + 8;  // bf16 rows of 256
constexpr int LDS = DVS + 8;    // bf16 rows of 32
constexpr int LDSF = DVS + 4;   // float rows of 32

constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// kda_intra's shared memory
constexpr int I_KS = 0;
constexpr int I_QS = I_KS + align128(C * LDK * 2);
constexpr int I_G = I_QS + align128(C * LDK * 2);
constexpr int I_A = I_G + align128(C * D * 4);
constexpr int I_M = I_A + align128(C * LDA * 4);
constexpr int I_BETA = I_M + align128(C * LDA * 4);
constexpr int I_REGION = I_BETA + align128(C * 4);
// phase 1 of the region: the reference-point operands
constexpr int R_OPLK = 0;                                  // [3][16][LDK] bf16
constexpr int R_OPLQ = R_OPLK + align128(3 * SUB * LDK * 2);  // [3][16][LDK] bf16
constexpr int R_OPR = R_OPLQ + align128(3 * SUB * LDK * 2);   // [96][LDK] bf16
constexpr int R_PHASE1 = R_OPR + align128(6 * SUB * LDK * 2);
// phase 2: T, its bf16 copy, the right-hand side, staging, products
constexpr int R_T = 0;                                   // [64][LDA] float
constexpr int R_TB = R_T + align128(C * LDA * 4);        // [64][LDT] bf16
constexpr int R_RB = R_TB + align128(C * LDT * 2);       // [64][LDR] bf16
constexpr int R_STAGE = R_RB + align128(C * LDR * 2);    // [16][16][16] float
constexpr int R_TMP = R_STAGE + align128(kIntraWarps * 256 * 4);  // [3][16][16] float
constexpr int R_PHASE2 = R_TMP + align128(3 * 256 * 4);
constexpr int I_SMEM = I_REGION + (R_PHASE1 > R_PHASE2 ? R_PHASE1 : R_PHASE2);

// kda_state's shared memory: the state, its bf16 copy, U, staging, and two
// buffers of a chunk's records
constexpr int B_WK = 0;
constexpr int B_QT = B_WK + align128(C * LDK * 2);
constexpr int B_KB = B_QT + align128(C * LDK * 2);
constexpr int B_MM = B_KB + align128(C * LDK * 2);
constexpr int B_WV = B_MM + align128(C * LDT * 2);
constexpr int B_GAM = B_WV + align128(C * LDS * 2);
constexpr int B_BYTES = B_GAM + align128(D * 4);
constexpr int S_S = 0;
constexpr int S_SB = S_S + align128(D * LDSF * 4);
constexpr int S_UB = S_SB + align128(D * LDS * 2);
constexpr int S_STAGE = S_UB + align128(C * LDS * 2);
constexpr int S_BUF = S_STAGE + align128(kWarps * 256 * 4);
constexpr int S_SMEM = S_BUF + 2 * B_BYTES;

static_assert(I_SMEM <= 232448, "kda_intra's shared memory");
static_assert(S_SMEM <= 232448, "kda_state's shared memory");

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 tobf(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162 p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  u.x = *reinterpret_cast<uint32_t*>(&p[0]);
  u.y = *reinterpret_cast<uint32_t*>(&p[1]);
  u.z = *reinterpret_cast<uint32_t*>(&p[2]);
  u.w = *reinterpret_cast<uint32_t*>(&p[3]);
  return u;
}

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(p[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// ------------------------------------------------------------ intra-chunk

__global__ void __launch_bounds__(kIntraThreads, 1) kda_intra(const KdaLaunch a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + I_KS);
  bf16* qs = reinterpret_cast<bf16*>(smem + I_QS);
  float* G = reinterpret_cast<float*>(smem + I_G);
  float* A = reinterpret_cast<float*>(smem + I_A);
  float* Mf = reinterpret_cast<float*>(smem + I_M);
  float* bs = reinterpret_cast<float*>(smem + I_BETA);
  unsigned char* region = smem + I_REGION;
  bf16* oplk = reinterpret_cast<bf16*>(region + R_OPLK);
  bf16* oplq = reinterpret_cast<bf16*>(region + R_OPLQ);
  bf16* opr = reinterpret_cast<bf16*>(region + R_OPR);
  float* T = reinterpret_cast<float*>(region + R_T);
  bf16* Tb = reinterpret_cast<bf16*>(region + R_TB);
  bf16* Rb = reinterpret_cast<bf16*>(region + R_RB);
  float* stage = reinterpret_cast<float*>(region + R_STAGE);
  float* tmp = reinterpret_cast<float*>(region + R_TMP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long nch = gridDim.x;
  const long long t0 = chunk * C;
  const int rows = (int)(a.seq - t0 < C ? a.seq - t0 : C);
  const long long rs = a.heads * D;  // elements from one token to the next
  const long long base = (b * a.seq + t0) * rs + h * D;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  const float* g = a.g + base;
  const float* beta = a.beta + (b * a.seq + t0) * a.heads + h;
  const long long rec = (b * a.heads + h) * nch + chunk;
  const float scale = a.scale;

  // loads; rows past the sequence are zero (g 0, beta 0: they add nothing)
  for (int i = tid; i < C * (D / 8); i += kIntraThreads) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), qv = kv;
    if (r < rows) {
      kv = *reinterpret_cast<const uint4*>(k + r * rs + c8);
      qv = *reinterpret_cast<const uint4*>(q + r * rs + c8);
    }
    *reinterpret_cast<uint4*>(ks + r * LDK + c8) = kv;
    *reinterpret_cast<uint4*>(qs + r * LDK + c8) = qv;
  }
  for (int i = tid; i < C * (D / 4); i += kIntraThreads) {
    const int r = i / (D / 4), c4 = (i % (D / 4)) * 4;
    float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) gv = *reinterpret_cast<const float4*>(g + r * rs + c4);
    *reinterpret_cast<float4*>(G + r * D + c4) = gv;
  }
  if (tid < C) bs[tid] = tid < rows ? beta[tid * a.heads] : 0.f;
  for (int i = tid; i < C * LDA; i += kIntraThreads) {
    A[i] = 0.f;
    Mf[i] = 0.f;
  }
  __syncthreads();

  // G: the running sum down the chunk, in kParts runs of kRun rows, then
  // each run offset by the sums of the runs before it
  constexpr int kParts = kIntraThreads / D, kRun = C / kParts;
  {
    const int c = tid & (D - 1), r0 = (tid / D) * kRun;
    float s = 0.f;
#pragma unroll
    for (int r = r0; r < r0 + kRun; ++r) {
      s = __fadd_rn(s, G[r * D + c]);
      G[r * D + c] = s;
    }
  }
  __syncthreads();
  {
    const int c = tid & (D - 1), part = tid / D;
    float off = 0.f;
    for (int p = 0; p < part; ++p) off = __fadd_rn(off, G[(p * kRun + kRun - 1) * D + c]);
    __syncthreads();
    for (int r = part * kRun; r < (part + 1) * kRun; ++r) G[r * D + c] = __fadd_rn(G[r * D + c], off);
  }
  __syncthreads();

  // reference-point operands of the off-diagonal sub-block pairs: for
  // sub-block i (1..3), r = 16 i - 1; left rows t of sub-block i take
  // exp(G_t - G_r) (k with beta_t, q with scale), right rows s < 16 i take
  // exp(G_r - G_s); the right rows of block i start at row 8 i (i - 1)
  for (int i = tid; i < 3 * SUB * D; i += kIntraThreads) {
    const int blk = i / (SUB * D) + 1, rr = (i / D) % SUB, c = i % D;
    const int t = blk * SUB + rr, r = blk * SUB - 1;
    const float e = __expf(__fsub_rn(G[t * D + c], G[r * D + c]));
    oplk[((blk - 1) * SUB + rr) * LDK + c] = tobf(bs[t] * bf(ks[t * LDK + c]) * e);
    oplq[((blk - 1) * SUB + rr) * LDK + c] = tobf(scale * bf(qs[t * LDK + c]) * e);
  }
  for (int i = tid; i < 6 * SUB * D; i += kIntraThreads) {
    const int row = i / D, c = i % D;
    const int blk = row < 16 ? 1 : (row < 48 ? 2 : 3);
    const int s = row - 8 * blk * (blk - 1), r = blk * SUB - 1;
    const float e = __expf(__fsub_rn(G[r * D + c], G[s * D + c]));
    opr[row * LDK + c] = tobf(bf(ks[s * LDK + c]) * e);
  }
  __syncthreads();

  // off-diagonal sub-block pairs (i > j) of A and M: 12 tiles
  for (int tile = warp; tile < 12; tile += kIntraWarps) {
    const int kind = tile & 1, p = tile >> 1;
    const int i = p < 1 ? 1 : (p < 3 ? 2 : 3);
    const int j = p - i * (i - 1) / 2;
    const bf16* left = (kind ? oplq : oplk) + (i - 1) * SUB * LDK;
    const bf16* right = opr + (8 * i * (i - 1) + SUB * j) * LDK;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBc fb;
      wmma::load_matrix_sync(fa, left + 16 * kk, LDK);
      wmma::load_matrix_sync(fb, right + 16 * kk, LDK);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync((kind ? Mf : A) + SUB * i * LDA + SUB * j, acc, LDA,
                            wmma::mem_row_major);
  }

  // diagonal sub-blocks: the NSUB x 120 pairs s < t inside a sub-block, a
  // thread a pair, exp(G_t - G_s) direct; M's diagonal (q_t . k_t, no
  // decay) on the threads left. Channels go two at a time (float2,
  // bfloat162), each lane from its own offset, so the lanes of a warp read
  // G in different banks
  {
    constexpr int kPairs = SUB * (SUB - 1) / 2;
    constexpr int kBusy = NSUB * kPairs;
    static_assert(kBusy < kIntraThreads, "a thread a pair");
    if (tid < kBusy) {
      const int blk = tid / kPairs, e = tid % kPairs;
      int tt = 1;
      while (tt * (tt + 1) / 2 <= e) ++tt;
      const int t = blk * SUB + tt, s = blk * SUB + e - tt * (tt - 1) / 2;
      float sa0 = 0.f, sa1 = 0.f, sm0 = 0.f, sm1 = 0.f;
#pragma unroll 8
      for (int j = 0; j < D / 2; ++j) {
        const int c = ((j + lane) & (D / 2 - 1)) * 2;
        const float2 gt = *reinterpret_cast<const float2*>(G + t * D + c);
        const float2 gs = *reinterpret_cast<const float2*>(G + s * D + c);
        const float2 kS = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ks + s * LDK + c));
        const float2 kT = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ks + t * LDK + c));
        const float2 qT = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qs + t * LDK + c));
        const float e0 = kS.x * __expf(__fsub_rn(gt.x, gs.x));
        const float e1 = kS.y * __expf(__fsub_rn(gt.y, gs.y));
        sa0 = fmaf(kT.x, e0, sa0);
        sa1 = fmaf(kT.y, e1, sa1);
        sm0 = fmaf(qT.x, e0, sm0);
        sm1 = fmaf(qT.y, e1, sm1);
      }
      A[t * LDA + s] = bs[t] * __fadd_rn(sa0, sa1);
      Mf[t * LDA + s] = scale * __fadd_rn(sm0, sm1);
    } else {
      for (int r = tid - kBusy; r < C; r += kIntraThreads - kBusy) {
        float m0 = 0.f, m1 = 0.f;
#pragma unroll 8
        for (int j = 0; j < D / 2; ++j) {
          const int c = ((j + lane) & (D / 2 - 1)) * 2;
          const float2 kT = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ks + r * LDK + c));
          const float2 qT = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qs + r * LDK + c));
          m0 = fmaf(qT.x, kT.x, m0);
          m1 = fmaf(qT.y, kT.y, m1);
        }
        Mf[r * LDA + r] = scale * __fadd_rn(m0, m1);
      }
    }
  }
  __syncthreads();

  // M out; the right-hand side [beta K exp(G) | beta V]; scale Q exp(G),
  // K exp(G_C - G) and exp(G_C) out; T zeroed
  {
    bf16* mm = static_cast<bf16*>(a.mm) + rec * C * C;
    for (int i = tid; i < C * C / 8; i += kIntraThreads) {
      const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
      *reinterpret_cast<uint4*>(mm + r * C + c8) = pack8(Mf + r * LDA + c8);
    }
  }
  {
    bf16* qt = static_cast<bf16*>(a.qt) + rec * C * D;
    bf16* kb = static_cast<bf16*>(a.kb) + rec * C * D;
    const float* glast = G + (C - 1) * D;
    for (int i = tid; i < C * (D / 8); i += kIntraThreads) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      float kf[8], qf[8], vf[8], rk[8], rv[8], qo[8], ko[8];
      unpack8(*reinterpret_cast<const uint4*>(ks + r * LDK + c8), kf);
      unpack8(*reinterpret_cast<const uint4*>(qs + r * LDK + c8), qf);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (r < rows) vv = *reinterpret_cast<const uint4*>(v + r * rs + c8);
      unpack8(vv, vf);
      const float br = bs[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float gr = G[r * D + c8 + j];
        const float e = __expf(gr);
        rk[j] = br * kf[j] * e;
        rv[j] = br * vf[j];
        qo[j] = scale * qf[j] * e;
        ko[j] = kf[j] * __expf(__fsub_rn(glast[c8 + j], gr));
      }
      *reinterpret_cast<uint4*>(Rb + r * LDR + c8) = pack8(rk);
      *reinterpret_cast<uint4*>(Rb + r * LDR + D + c8) = pack8(rv);
      *reinterpret_cast<uint4*>(qt + r * D + c8) = pack8(qo);
      *reinterpret_cast<uint4*>(kb + r * D + c8) = pack8(ko);
    }
    if (tid < D) a.gam[rec * D + tid] = __expf(glast[tid]);
  }
  for (int i = tid; i < C * LDA; i += kIntraThreads) T[i] = 0.f;
  __syncthreads();

  // T = (I + A)^-1: the 16 x 16 diagonal blocks by substitution, a thread
  // a column
  if (tid < NSUB * SUB) {
    const int blk = tid / SUB, col = tid % SUB, o = blk * SUB;
    float x[SUB];
#pragma unroll
    for (int r = 0; r < SUB; ++r) {
      float acc = r == col ? 1.f : 0.f;
#pragma unroll
      for (int s = 0; s < r; ++s) acc = fmaf(-A[(o + r) * LDA + o + s], x[s], acc);
      x[r] = acc;
      T[(o + r) * LDA + o + col] = acc;
    }
  }
  __syncthreads();
  // then the off-diagonal blocks a block diagonal at a time:
  // T_ij = -T_ii sum_{m=j}^{i-1} A_im T_mj
  for (int d = 1; d < NSUB; ++d) {
    const int np = NSUB - d;
    for (int e = tid; e < np * 256; e += kIntraThreads) {
      const int p = e / 256, r = (e / 16) % 16, c = e % 16, i = d + p, j = p;
      float acc = 0.f;
      for (int m = SUB * j; m < SUB * i; ++m)
        acc = fmaf(A[(SUB * i + r) * LDA + m], T[m * LDA + SUB * j + c], acc);
      tmp[p * 256 + r * 16 + c] = acc;
    }
    __syncthreads();
    for (int e = tid; e < np * 256; e += kIntraThreads) {
      const int p = e / 256, r = (e / 16) % 16, c = e % 16, i = d + p, j = p;
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < SUB; ++m)
        acc = fmaf(T[(SUB * i + r) * LDA + SUB * i + m], tmp[p * 256 + m * 16 + c], acc);
      T[(SUB * i + r) * LDA + SUB * j + c] = -acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < C * C; i += kIntraThreads) Tb[(i / C) * LDT + i % C] = tobf(T[(i / C) * LDA + i % C]);
  __syncthreads();

  // [W_k | W_v] = T R: 4 x 16 tiles of 16 x 16, staged per warp, out as bf16
  {
    bf16* wk = static_cast<bf16*>(a.wk) + rec * C * D;
    bf16* wv = static_cast<bf16*>(a.wv) + rec * C * D;
    float* st = stage + warp * 256;
    const int r = lane >> 1, c0 = (lane & 1) * 8;
    for (int tile = warp; tile < 4 * 16; tile += kIntraWarps) {
      const int ti = tile / 16, tc = tile % 16;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk <= ti; ++kk) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, Tb + 16 * ti * LDT + 16 * kk, LDT);
        wmma::load_matrix_sync(fb, Rb + 16 * kk * LDR + 16 * tc, LDR);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
      __syncwarp();
      const int row = 16 * ti + r, col = 16 * tc + c0;
      bf16* dst = (col < D ? wk + row * D + col : wv + row * D + col - D);
      *reinterpret_cast<uint4*>(dst) = pack8(st + r * 16 + c0);
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------ state pass

__device__ __forceinline__ void load_records(unsigned char* buf, const KdaLaunch& a, long long rec,
                                             int col0, int tid) {
  const bf16* src[3] = {static_cast<const bf16*>(a.wk) + rec * C * D,
                        static_cast<const bf16*>(a.qt) + rec * C * D,
                        static_cast<const bf16*>(a.kb) + rec * C * D};
  const int dst[3] = {B_WK, B_QT, B_KB};
  for (int i = tid; i < 3 * C * (D / 8); i += kThreads) {
    const int m = i / (C * (D / 8)), r = (i / (D / 8)) % C, c8 = (i % (D / 8)) * 8;
    cp_async16(buf + dst[m] + (r * LDK + c8) * 2, src[m] + r * D + c8);
  }
  const bf16* mm = static_cast<const bf16*>(a.mm) + rec * C * C;
  for (int i = tid; i < C * (C / 8); i += kThreads) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    cp_async16(buf + B_MM + (r * LDT + c8) * 2, mm + r * C + c8);
  }
  const bf16* wv = static_cast<const bf16*>(a.wv) + rec * C * D + col0;
  for (int i = tid; i < C * (DVS / 8); i += kThreads) {
    const int r = i / (DVS / 8), c8 = (i % (DVS / 8)) * 8;
    cp_async16(buf + B_WV + (r * LDS + c8) * 2, wv + r * D + c8);
  }
  if (tid < D / 4) cp_async16(buf + B_GAM + tid * 16, a.gam + rec * D + tid * 4);
}

__global__ void __launch_bounds__(kThreads, 1) kda_state(const KdaLaunch a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem + S_S);
  bf16* Sb = reinterpret_cast<bf16*>(smem + S_SB);
  bf16* Ub = reinterpret_cast<bf16*>(smem + S_UB);
  float* stage = reinterpret_cast<float*>(smem + S_STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * DVS;
  const long long h = blockIdx.y, b = blockIdx.z;
  const long long nch = (a.seq + C - 1) / C;
  const long long rec0 = (b * a.heads + h) * nch;
  bf16* out = static_cast<bf16*>(a.out);
  const long long rs = a.heads * D;

  for (int i = tid; i < D * LDSF; i += kThreads) S[i] = 0.f;
  load_records(smem + S_BUF, a, rec0, col0, tid);
  cp_async_commit();

  const int ti = warp >> 1, tc = warp & 1;  // this warp's tile of U and O
  float* st = stage + warp * 256;
  const int lr = lane >> 1, lc = (lane & 1) * 8;
  for (long long n = 0; n < nch; ++n) {
    unsigned char* buf = smem + S_BUF + (n & 1) * B_BYTES;
    if (n + 1 < nch) {
      load_records(smem + S_BUF + ((n + 1) & 1) * B_BYTES, a, rec0 + n + 1, col0, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wk = reinterpret_cast<const bf16*>(buf + B_WK);
    const bf16* qt = reinterpret_cast<const bf16*>(buf + B_QT);
    const bf16* kb = reinterpret_cast<const bf16*>(buf + B_KB);
    const bf16* mm = reinterpret_cast<const bf16*>(buf + B_MM);
    const bf16* wv = reinterpret_cast<const bf16*>(buf + B_WV);
    const float* gam = reinterpret_cast<const float*>(buf + B_GAM);

    for (int i = tid; i < D * DVS; i += kThreads) {
      Sb[(i / DVS) * LDS + i % DVS] = tobf(S[(i / DVS) * LDSF + i % DVS]);
    }
    __syncthreads();

    // W_k S and (scale Q exp(G)) S for this warp's tile
    FragC accp, acco;
    wmma::fill_fragment(accp, 0.f);
    wmma::fill_fragment(acco, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fw, fq;
      FragB fs;
      wmma::load_matrix_sync(fs, Sb + 16 * kk * LDS + 16 * tc, LDS);
      wmma::load_matrix_sync(fw, wk + 16 * ti * LDK + 16 * kk, LDK);
      wmma::load_matrix_sync(fq, qt + 16 * ti * LDK + 16 * kk, LDK);
      wmma::mma_sync(accp, fw, fs, accp);
      wmma::mma_sync(acco, fq, fs, acco);
    }
    // U = W_v - W_k S, rounded to bf16
    wmma::store_matrix_sync(st, accp, 16, wmma::mem_row_major);
    __syncwarp();
    {
      const int row = 16 * ti + lr, col = 16 * tc + lc;
      float u[8];
      unpack8(*reinterpret_cast<const uint4*>(wv + row * LDS + col), u);
#pragma unroll
      for (int j = 0; j < 8; ++j) u[j] = __fsub_rn(u[j], st[lr * 16 + lc + j]);
      *reinterpret_cast<uint4*>(Ub + row * LDS + col) = pack8(u);
    }
    // the state decays to the chunk's end: Diag(exp G_C) S
    for (int i = tid; i < D * DVS; i += kThreads) {
      const int r = i / DVS, c = i % DVS;
      S[r * LDSF + c] = __fmul_rn(S[r * LDSF + c], gam[r]);
    }
    __syncthreads();

    // O = (scale Q exp(G)) S + M U, out as bf16
    for (int kk = 0; kk <= ti; ++kk) {
      FragA fm;
      FragB fu;
      wmma::load_matrix_sync(fm, mm + 16 * ti * LDT + 16 * kk, LDT);
      wmma::load_matrix_sync(fu, Ub + 16 * kk * LDS + 16 * tc, LDS);
      wmma::mma_sync(acco, fm, fu, acco);
    }
    __syncwarp();
    wmma::store_matrix_sync(st, acco, 16, wmma::mem_row_major);
    __syncwarp();
    {
      const long long t = n * C + 16 * ti + lr;
      if (t < a.seq) {
        bf16* dst = out + (b * a.seq + t) * rs + h * D + col0 + 16 * tc + lc;
        *reinterpret_cast<uint4*>(dst) = pack8(st + lr * 16 + lc);
      }
    }
    // S += (K exp(G_C - G))^T U: this warp's 16 rows of the state
#pragma unroll
    for (int cb = 0; cb < DVS / 16; ++cb) {
      FragC accs;
      wmma::load_matrix_sync(accs, S + 16 * warp * LDSF + 16 * cb, LDSF, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        FragAc fk;
        FragB fu;
        wmma::load_matrix_sync(fk, kb + 16 * kk * LDK + 16 * warp, LDK);
        wmma::load_matrix_sync(fu, Ub + 16 * kk * LDS + 16 * cb, LDS);
        wmma::mma_sync(accs, fk, fu, accs);
      }
      wmma::store_matrix_sync(S + 16 * warp * LDSF + 16 * cb, accs, LDSF, wmma::mem_row_major);
    }
    __syncthreads();
  }
}


// ------------------------------------------------------------ short conv

constexpr int kConvTaps = 4;
constexpr int kConvWarps = 4;
constexpr int kConvRun = 16;  // tokens a warp, in order

// The causal depthwise convolution of the q, k and v projections (4 taps a
// channel, no bias), SiLU, and the L2 norm of each q and k head: a warp a
// (128-channel group, run of 16 tokens), a lane 4 channels, the last three
// inputs of each channel kept in registers as the run advances. The
// convolution and SiLU round to bf16 as the op sequence does; the norm
// reads the rounded values in float32: y / sqrt(sum y^2 + 1e-6).
__global__ void __launch_bounds__(kConvWarps * 32) kda_conv(const KdaConvLaunch a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long group = blockIdx.y;  // 0 .. 3 heads - 1: q heads, k heads, v heads
  const long long b = blockIdx.z;
  const long long t0 = ((long long)blockIdx.x * kConvWarps + warp) * kConvRun;
  if (t0 >= a.seq) return;
  const long long width = 3 * a.heads * D;
  const int c = lane * 4;
  const bf16* x = static_cast<const bf16*>(a.x) + b * a.seq * width + group * D + c;
  float w[4][kConvTaps];
  {
    const bf16* wp = static_cast<const bf16*>(a.w) + (group * D + c) * kConvTaps;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int tap = 0; tap < kConvTaps; ++tap) w[j][tap] = bf(wp[j * kConvTaps + tap]);
    }
  }
  float hist[kConvTaps - 1][4];  // inputs t - 3, t - 2, t - 1
#pragma unroll
  for (int h = 0; h < kConvTaps - 1; ++h) {
    const long long t = t0 - (kConvTaps - 1) + h;
    uint2 u = make_uint2(0, 0);
    if (t >= 0) u = *reinterpret_cast<const uint2*>(x + t * width);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 lo = __bfloat1622float2(p[0]), hi = __bfloat1622float2(p[1]);
    hist[h][0] = lo.x;
    hist[h][1] = lo.y;
    hist[h][2] = hi.x;
    hist[h][3] = hi.y;
  }
  const int part = (int)(group / a.heads);
  const long long head = group % a.heads;
  bf16* out = static_cast<bf16*>(part == 0 ? a.q : (part == 1 ? a.k : a.v)) + b * a.seq * a.heads * D
              + head * D + c;
  const long long t1 = t0 + kConvRun < a.seq ? t0 + kConvRun : a.seq;
  for (long long t = t0; t < t1; ++t) {
    const uint2 u = *reinterpret_cast<const uint2*>(x + t * width);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 lo = __bfloat1622float2(p[0]), hi = __bfloat1622float2(p[1]);
    const float cur[4] = {lo.x, lo.y, hi.x, hi.y};
    float y[4];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = __fmul_rn(w[j][kConvTaps - 1], cur[j]);
#pragma unroll
      for (int h = 0; h < kConvTaps - 1; ++h) acc = fmaf(w[j][h], hist[h][j], acc);
      const float r = bf(tobf(acc));
      y[j] = bf(tobf(__fdiv_rn(r, __fadd_rn(1.f, __expf(-r)))));
      ss = fmaf(y[j], y[j], ss);
#pragma unroll
      for (int h = 0; h < kConvTaps - 2; ++h) hist[h][j] = hist[h + 1][j];
      hist[kConvTaps - 2][j] = cur[j];
    }
    if (part < 2) {
      const float inv = rsqrtf(__fadd_rn(warp_sum(ss), 1e-6f));
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = __fmul_rn(y[j], inv);
    }
    __nv_bfloat162 o[2] = {__floats2bfloat162_rn(y[0], y[1]), __floats2bfloat162_rn(y[2], y[3])};
    *reinterpret_cast<uint2*>(out + t * a.heads * D) = *reinterpret_cast<uint2*>(o);
  }
}

}  // namespace

extern "C" {

// Once per device, before the first launch there, with that device
// current: both kernels' dynamic shared-memory limits. Returns a CUDA
// error code (0 on success).
int tev_kda_init() {
  cudaError_t err = cudaFuncSetAttribute(kda_intra, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         I_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kda_state, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
  return (int)err;
}

// The two launches on `stream` (a cudaStream_t of the current device):
// the intra-chunk pass writes the records, the state pass reads them and
// writes args->out. Returns the first launch error, else
// cudaGetLastError() (0 on success).
int tev_kda(const KdaLaunch* args, void* stream) {
  const KdaLaunch& a = *args;
  if (a.batch < 1 || a.heads < 1 || a.seq < 1 || a.batch > 65535 || a.heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nch = (a.seq + C - 1) / C;
  if (nch > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  kda_intra<<<dim3((unsigned)nch, (unsigned)a.heads, (unsigned)a.batch), kIntraThreads, I_SMEM,
              s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kda_state<<<dim3(D / DVS, (unsigned)a.heads, (unsigned)a.batch), kThreads, S_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// One launch on `stream`: the short convolutions, SiLU and q, k norms of
// a KDA layer's projections into args->q, k, v. Returns
// cudaGetLastError() (0 on success).
int tev_kda_conv(const KdaConvLaunch* args, void* stream) {
  const KdaConvLaunch& a = *args;
  if (a.batch < 1 || a.heads < 1 || a.seq < 1 || a.batch > 65535 || 3 * a.heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per = (long long)kConvWarps * kConvRun;
  const long long blocks = (a.seq + per - 1) / per;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kda_conv<<<dim3((unsigned)blocks, (unsigned)(3 * a.heads), (unsigned)a.batch), kConvWarps * 32, 0,
             (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The message of a CUDA error code.
const char* tev_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
