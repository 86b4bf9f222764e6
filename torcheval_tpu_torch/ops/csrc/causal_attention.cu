// Causal softmax attention, forward, for NVIDIA Hopper (sm_90a): one pass
// over the keys of each query tile, the scores kept on chip.
//
// Replaces no TPU kernel: the JAX package leaves attention to XLA
// (flax.linen.SelfAttention). The port ran it as separate PyTorch ops
// (ops/causal_attention.py::attention_ops): a product into the
// materialised (B, H, S, S) scores, a causal torch.where over them, a
// softmax and a second product, each a full read and write of the scores,
// half of which the mask throws away. This kernel computes
//   out[b, i, h] = sum_{j <= i} softmax_j(q_i . k_j / d) v_j
// with d = sqrt(head_dim) rounded to the input dtype, as the op sequence
// divides. Scores, the running max and the running sum are float32; the
// probabilities are rounded to the input dtype once, before the product
// with V; the output is rounded once.
//
// Bound: the tensor cores. A (b, h) pair needs 2 S (S + 1) head_dim FLOPs
// (QK^T and PV over the S (S + 1) / 2 causal pairs) against 4 S head_dim
// elements read and written, so at S = 1,024 a launch sits far above the
// card's ~295 FLOPs a byte. At head_dim 64 the softmax's exponentials
// (one a score, on the 16-a-clock special function units) cost about as
// much again as the products.
//
// Design:
//   - one CTA of two warpgroups (8 warps) a (batch x head, tile of 128
//     queries); each warpgroup owns 64 query rows, each warp 16 of them.
//     Tiles are issued longest first (blockIdx.y counts down from the last
//     tile), so the short tiles near the start of the sequence fill the
//     tail of the last wave;
//   - Q is copied once into shared memory; K and V tiles of 64 keys stream
//     through a double-buffered ring of shared memory with cp.async, the
//     copy of tile j + 1 in flight while tile j is computed; rows past the
//     sequence are zero-filled. Q, K and V are read in place: a row at
//     base + b * batch_stride + s * row_stride + h * head_stride, unit
//     stride along head_dim (the (B, S, H, hd) projection outputs, row
//     stride H * hd). A tile holds each row in 64-element (128-byte)
//     slices with the 128-byte swizzle of the wgmma operand layouts;
//   - both products are warpgroup MMAs (wgmma, float32 accumulators):
//     QK^T reads Q and K from shared memory (K-major), PV takes the
//     probabilities from registers (the score fragments repacked) and V
//     from shared memory (MN-major). Each chain of k-steps is one asm
//     statement that ends in wgmma.wait_group, so the compiler never sees
//     a register the MMAs still own;
//   - softmax online in float32 registers: exp2 with log2(e) / d folded
//     into one fused multiply-add a score. The running max moves, and the
//     output and sum are rescaled, only when a row's max grows past the
//     stale one by 2^8 (a warp-wide vote), since exp2 of the stale shift
//     is then at most 2^8; the final division by the sum cancels the base;
//   - the key loop of a query tile stops at the diagonal, a warpgroup
//     skips the key tiles wholly above its rows, and only a tile that
//     crosses the diagonal or the end of the sequence is masked;
//   - the output goes through the warp's own rows of the Q tile, so each
//     row leaves in 16-byte stores, as (B, S, H, hd) contiguous.
// Head widths 64 and 128, bfloat16 and float16. The file builds with
// --fmad=false: the softmax's multiply-adds are explicit __fmaf_rn. A
// launch takes one packed struct, makes one launch on the caller's
// stream, allocates nothing, never synchronises, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

// Mirrored field for field by ops/_kernels.py::CAUSAL_ATTENTION_LAUNCH_FIELDS.
// At file scope: the extern "C" launcher takes it, so it needs external
// linkage. Strides are in elements.
struct CausalAttentionLaunch {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // (batch, seq, heads, head_dim) contiguous
  long long batch;
  long long seq;
  long long heads;
  long long q_batch_stride, q_row_stride, q_head_stride;
  long long k_batch_stride, k_row_stride, k_head_stride;
  long long v_batch_stride, v_row_stride, v_head_stride;
  int head_dim;  // 64 or 128
  int dtype;     // 1 bfloat16, 2 float16
};

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;  // two warpgroups of 64 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kBM = kWarps * 16;  // queries a CTA
constexpr int kBN = 64;           // keys a tile
constexpr int kNS = kBN / 8;      // 8-key column blocks of a score row
constexpr float kLazyLog2 = 8.0f;  // the stale max may trail by 2^8

// Shared-memory sizes of a head width: Q, K x 2, V x 2, and 1 KB to align
// the tiles to the swizzle's 1,024 bytes
template <int HD>
struct Tiles {
  static constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;
  static constexpr int kSmemBytes = kQBytes + 4 * kKVBytes + 1024;
  static constexpr int kMinBlocks = HD == 64 ? 2 : 1;
};

// Byte offset of 16-byte chunk c of row r in a tile of ROWS rows: each row
// in 64-element (128-byte) slices, slice-major, each slice's chunks
// swizzled (chunk ^ (row & 7)) as the 128-byte swizzle of the wgmma
// operand layouts has them.
template <int ROWS>
__device__ __forceinline__ uint32_t at(int r, int c) {
  return (uint32_t)((c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// A wgmma shared-memory operand with the 128-byte swizzle: `lbo` and
// `sbo` the byte strides between 64-element slices and between groups of
// 8 rows
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The accumulator operands of an m64nN wgmma: N / 2 floats a thread, as
// d[N / 8][4] (8 columns a block, the mma fragment order within it)
#define TEV_D4(c, d, n) c(d[n][0]), c(d[n][1]), c(d[n][2]), c(d[n][3])
#define TEV_D32(c, d)                                                                      \
  TEV_D4(c, d, 0), TEV_D4(c, d, 1), TEV_D4(c, d, 2), TEV_D4(c, d, 3), TEV_D4(c, d, 4),     \
      TEV_D4(c, d, 5), TEV_D4(c, d, 6), TEV_D4(c, d, 7)
#define TEV_D64(c, d)                                                                      \
  TEV_D32(c, d), TEV_D4(c, d, 8), TEV_D4(c, d, 9), TEV_D4(c, d, 10), TEV_D4(c, d, 11),     \
      TEV_D4(c, d, 12), TEV_D4(c, d, 13), TEV_D4(c, d, 14), TEV_D4(c, d, 15)
#define TEV_R32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TEV_R64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// Per element type TY ("bf16", "f16"), three chains of four k-steps, each
// waited for inside its asm statement:
//   qk:   d (=, or += when `acc`) sum_k A_k B_k, m64n64k16, A (this
//         warpgroup's Q rows) and B (K) K-major in shared memory;
//   pv64, pv128: d += sum_k P_k V_k, m64n64k16 / m64n128k16, P from
//         registers (a[k]: 16 keys of this warp's rows), V MN-major.
#define TEV_WGMMA_CHAINS(NAME, TY)                                                         \
  __device__ __forceinline__ void qk_##NAME(float (&d)[8][4], const uint64_t (&da)[4],     \
                                            const uint64_t (&db)[4], int acc) {            \
    asm volatile(                                                                          \
        "{\n.reg .pred p, t;\nsetp.ne.b32 p, %40, 0;\nsetp.eq.b32 t, %40, %40;\n"          \
        "wgmma.fence.sync.aligned;\n"                                                     \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TEV_R32                \
        ", %32, %36, p, 1, 1, 0, 0;\n"                                                     \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TEV_R32                \
        ", %33, %37, t, 1, 1, 0, 0;\n"                                                     \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TEV_R32                \
        ", %34, %38, t, 1, 1, 0, 0;\n"                                                     \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TEV_R32                \
        ", %35, %39, t, 1, 1, 0, 0;\n"                                                     \
        "wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n}\n"          \
        : TEV_D32("+f", d)                                                                 \
        : "l"(da[0]), "l"(da[1]), "l"(da[2]), "l"(da[3]), "l"(db[0]), "l"(db[1]),          \
          "l"(db[2]), "l"(db[3]), "r"(acc)                                                 \
        : "memory");                                                                       \
  }                                                                                        \
  __device__ __forceinline__ void pv64_##NAME(float (&d)[8][4], const uint32_t (&a)[4][4], \
                                              const uint64_t (&db)[4]) {                   \
    asm volatile(                                                                          \
        "{\n.reg .pred t;\nsetp.eq.b32 t, %32, %32;\nwgmma.fence.sync.aligned;\n"       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TEV_R32                \
        ", {%32, %33, %34, %35}, %48, t, 1, 1, 1;\n"                                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TEV_R32                \
        ", {%36, %37, %38, %39}, %49, t, 1, 1, 1;\n"                                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TEV_R32                \
        ", {%40, %41, %42, %43}, %50, t, 1, 1, 1;\n"                                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TEV_R32                \
        ", {%44, %45, %46, %47}, %51, t, 1, 1, 1;\n"                                       \
        "wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n}\n"          \
        : TEV_D32("+f", d)                                                                 \
        : TEV_D4("r", a, 0), TEV_D4("r", a, 1), TEV_D4("r", a, 2), TEV_D4("r", a, 3),      \
          "l"(db[0]), "l"(db[1]), "l"(db[2]), "l"(db[3])                                   \
        : "memory");                                                                       \
  }                                                                                        \
  __device__ __forceinline__ void pv128_##NAME(float (&d)[16][4],                          \
                                               const uint32_t (&a)[4][4],                  \
                                               const uint64_t (&db)[4]) {                  \
    asm volatile(                                                                          \
        "{\n.reg .pred t;\nsetp.eq.b32 t, %64, %64;\nwgmma.fence.sync.aligned;\n"       \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " TEV_R64               \
        ", {%64, %65, %66, %67}, %80, t, 1, 1, 1;\n"                                       \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " TEV_R64               \
        ", {%68, %69, %70, %71}, %81, t, 1, 1, 1;\n"                                       \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " TEV_R64               \
        ", {%72, %73, %74, %75}, %82, t, 1, 1, 1;\n"                                       \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " TEV_R64               \
        ", {%76, %77, %78, %79}, %83, t, 1, 1, 1;\n"                                       \
        "wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n}\n"          \
        : TEV_D64("+f", d)                                                                 \
        : TEV_D4("r", a, 0), TEV_D4("r", a, 1), TEV_D4("r", a, 2), TEV_D4("r", a, 3),      \
          "l"(db[0]), "l"(db[1]), "l"(db[2]), "l"(db[3])                                   \
        : "memory");                                                                       \
  }

TEV_WGMMA_CHAINS(bf16, "bf16")
TEV_WGMMA_CHAINS(f16, "f16")

struct BF16 {
  __device__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static float divisor(int hd) {
    return __bfloat162float(__float2bfloat16_rn(sqrtf((float)hd)));
  }
  __device__ static void qk(float (&d)[8][4], const uint64_t (&da)[4], const uint64_t (&db)[4],
                            int acc) {
    qk_bf16(d, da, db, acc);
  }
  __device__ static void pv(float (&d)[8][4], const uint32_t (&a)[4][4], const uint64_t (&db)[4]) {
    pv64_bf16(d, a, db);
  }
  __device__ static void pv(float (&d)[16][4], const uint32_t (&a)[4][4],
                            const uint64_t (&db)[4]) {
    pv128_bf16(d, a, db);
  }
};

struct F16 {
  __device__ static uint32_t pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static float divisor(int hd) {
    return __half2float(__float2half_rn(sqrtf((float)hd)));
  }
  __device__ static void qk(float (&d)[8][4], const uint64_t (&da)[4], const uint64_t (&db)[4],
                            int acc) {
    qk_f16(d, da, db, acc);
  }
  __device__ static void pv(float (&d)[8][4], const uint32_t (&a)[4][4], const uint64_t (&db)[4]) {
    pv64_f16(d, a, db);
  }
  __device__ static void pv(float (&d)[16][4], const uint32_t (&a)[4][4],
                            const uint64_t (&db)[4]) {
    pv128_f16(d, a, db);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// this thread's copies have landed, and are visible to the wgmma (async) proxy
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ROWS rows of HD elements from row `row0` of a (seq, hd) slab into the
// tile at `dst`; rows at or past `seq` are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const uint16_t* base, long long row_stride,
                                          int row0, int seq, int tid) {
  constexpr int kChunks = Tiles<HD>::kChunks;
  static_assert(ROWS * kChunks % kThreads == 0, "tile chunks must spread evenly");
#pragma unroll
  for (int u = 0; u < ROWS * kChunks / kThreads; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = row0 + r;
    const bool valid = row < seq;
    const uint16_t* src = base + (valid ? (long long)row * row_stride : 0) + c * 8;
    cp_async16(dst + at<ROWS>(r, c), src, valid);
  }
}

// s = Q K^T for this warpgroup's 64 query rows (from row q_row0 of the Q
// tile at s_q) over the key tile at s_k
template <class C, int HD>
__device__ __forceinline__ void qk_tile(float (&s)[kNS][4], uint32_t s_q, int q_row0,
                                        uint32_t s_k) {
#pragma unroll
  for (int slice = 0; slice < HD / 64; ++slice) {
    uint64_t da[4];
    uint64_t db[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // K-major: 16 elements (32 bytes) of each row a k-step
      da[ks] = smem_desc(s_q + slice * kBM * 128 + q_row0 * 128 + ks * 32, 16, 1024);
      db[ks] = smem_desc(s_k + slice * kBN * 128 + ks * 32, 16, 1024);
    }
    C::qk(s, da, db, slice);
  }
}

// The running softmax over the scores s of the key tile at n0 for this
// warp's 16 rows from row_w, then o += P V over the value tile at s_v
template <class C, int HD>
__device__ __forceinline__ void softmax_pv(float (&s)[kNS][4], float (&o)[HD / 8][4],
                                           float (&m_run)[2], float (&l_run)[2], uint32_t s_v,
                                           int n0, int row_w, int seq, float scale_log2,
                                           int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  if (n0 + kBN - 1 > row_w || n0 + kBN > seq) {  // the diagonal or the end
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + n * 8 + 2 * t + (e & 1);
        const int row = row_w + g + (e >> 1) * 8;
        if (col > row || col >= seq) s[n][e] = -INFINITY;
      }
    }
  }
  float mx[2];
  bool grow = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int n = 0; n < kNS; ++n) m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    mx[r] = m;
    // m_run is -inf before the first tile, which always grows it
    grow |= __fmul_rn(__fsub_rn(m, m_run[r]), scale_log2) > kLazyLog2;
  }
  if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // key 0 is visible to every row and comes first, so m_new is finite
      const float m_new = fmaxf(m_run[r], mx[r]);
      const float corr = ex2(__fmul_rn(__fsub_rn(m_run[r], m_new), scale_log2));
      m_run[r] = m_new;
      l_run[r] = __fmul_rn(l_run[r], corr);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][2 * r] = __fmul_rn(o[n][2 * r], corr);
        o[n][2 * r + 1] = __fmul_rn(o[n][2 * r + 1], corr);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float shift = -__fmul_rn(m_run[r], scale_log2);
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
      s[n][2 * r] = ex2(__fmaf_rn(s[n][2 * r], scale_log2, shift));
      s[n][2 * r + 1] = ex2(__fmaf_rn(s[n][2 * r + 1], scale_log2, shift));
      sum = __fadd_rn(sum, __fadd_rn(s[n][2 * r], s[n][2 * r + 1]));
    }
    l_run[r] = __fadd_rn(l_run[r], sum);
  }
  // the score fragments of 16 keys are the A fragment of a PV k-step
  uint32_t p[kBN / 16][4];
  uint64_t db[kBN / 16];
#pragma unroll
  for (int ks = 0; ks < kBN / 16; ++ks) {
    p[ks][0] = C::pack(s[2 * ks][0], s[2 * ks][1]);
    p[ks][1] = C::pack(s[2 * ks][2], s[2 * ks][3]);
    p[ks][2] = C::pack(s[2 * ks + 1][0], s[2 * ks + 1][1]);
    p[ks][3] = C::pack(s[2 * ks + 1][2], s[2 * ks + 1][3]);
    // MN-major (transposed): 16 keys, two groups of 8 rows, a k-step
    db[ks] = smem_desc(s_v + ks * 16 * 128, kBN * 128, 1024);
  }
  C::pv(o, p, db);
}

template <class C, int HD>
__global__ void __launch_bounds__(kThreads, Tiles<HD>::kMinBlocks)
    causal_attention_kernel(const CausalAttentionLaunch a) {
  using T = Tiles<HD>;
  extern __shared__ __align__(128) uint8_t smem_raw[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row
  const int t = lane & 3;   // fragment column pair
  const int seq = (int)a.seq;
  const long long b = blockIdx.x / a.heads;
  const long long h = blockIdx.x % a.heads;
  const int m0 = (int)(gridDim.y - 1 - blockIdx.y) * kBM;  // longest tile first

  const uint16_t* q = static_cast<const uint16_t*>(a.q) + b * a.q_batch_stride + h * a.q_head_stride;
  const uint16_t* k = static_cast<const uint16_t*>(a.k) + b * a.k_batch_stride + h * a.k_head_stride;
  const uint16_t* v = static_cast<const uint16_t*>(a.v) + b * a.v_batch_stride + h * a.v_head_stride;

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (s_q - raw);
  const uint32_t s_k0 = s_q + T::kQBytes;
  const uint32_t s_v0 = s_k0 + 2 * T::kKVBytes;

  const int n_end = min(seq, m0 + kBM);
  const int n_tiles = (n_end + kBN - 1) / kBN;
  const int wg_row0 = (warp >> 2) * 64;  // this warpgroup's first row of the tile
  const int row_w = m0 + warp * 16;      // this warp's first query row
  const float scale_log2 = kLog2e / C::divisor(HD);

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};

  load_tile<HD, kBM>(s_q, q, a.q_row_stride, m0, seq, tid);
  load_tile<HD, kBN>(s_k0, k, a.k_row_stride, 0, seq, tid);
  load_tile<HD, kBN>(s_v0, v, a.v_row_stride, 0, seq, tid);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    // tile j has landed, and every warp is done with tile j - 1's buffers
    cp_async_wait_all();
    __syncthreads();
    const uint32_t buf = (j & 1) * T::kKVBytes;
    if (j + 1 < n_tiles) {
      const uint32_t next = T::kKVBytes - buf;
      load_tile<HD, kBN>(s_k0 + next, k, a.k_row_stride, (j + 1) * kBN, seq, tid);
      load_tile<HD, kBN>(s_v0 + next, v, a.v_row_stride, (j + 1) * kBN, seq, tid);
      cp_async_commit();
    }
    const int n0 = j * kBN;
    if (n0 > m0 + wg_row0 + 63) continue;  // every key of the tile is above this warpgroup's rows
    float s[kNS][4];
    qk_tile<C, HD>(s, s_q, wg_row0, s_k0 + buf);
    softmax_pv<C, HD>(s, o, m_run, l_run, s_v0 + buf, n0, row_w, seq, scale_log2, lane);
  }

  // normalise, stage this warp's rows in its own rows of the Q tile (its
  // warpgroup alone read them, and is done), store 16 bytes a lane
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 2));
    const float inv = __frcp_rn(l);
    const int row = warp * 16 + g + r * 8;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const uint32_t word = C::pack(__fmul_rn(o[n][2 * r], inv), __fmul_rn(o[n][2 * r + 1], inv));
      *reinterpret_cast<uint32_t*>(smem + at<kBM>(row, n) + 4 * t) = word;
    }
  }
  __syncwarp();
  uint16_t* out = static_cast<uint16_t*>(a.out);
  const long long out_row = a.heads * HD;
#pragma unroll
  for (int u = 0; u < 16 * T::kChunks / 32; ++u) {
    const int i = lane + u * 32;
    const int r = i / T::kChunks;
    const int c = i % T::kChunks;
    const int row = row_w + r;
    if (row < seq) {
      const uint4 w = *reinterpret_cast<const uint4*>(smem + at<kBM>(warp * 16 + r, c));
      *reinterpret_cast<uint4*>(out + (b * seq + row) * out_row + h * HD + c * 8) = w;
    }
  }
}

template <class C, int HD>
cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(causal_attention_kernel<C, HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<HD>::kSmemBytes);
}

template <class C, int HD>
int launch(const CausalAttentionLaunch& a, cudaStream_t stream) {
  const long long m_tiles = (a.seq + kBM - 1) / kBM;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.batch * a.heads), (unsigned)m_tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Tiles<HD>::kSmemBytes;
  cfg.stream = stream;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, causal_attention_kernel<C, HD>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, before the first launch there, with that device
// current: each variant's dynamic shared-memory limit. Returns a CUDA
// error code (0 on success).
int tev_causal_attention_init() {
  const cudaError_t errs[4] = {set_smem_limit<BF16, 64>(), set_smem_limit<F16, 64>(),
                               set_smem_limit<BF16, 128>(), set_smem_limit<F16, 128>()};
  for (cudaError_t err : errs) {
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One launch on `stream` (a cudaStream_t of the current device): writes
// args->out. Returns the launch's error, else cudaGetLastError() (0 on
// success).
int tev_causal_attention(const CausalAttentionLaunch* args, void* stream) {
  const CausalAttentionLaunch& a = *args;
  if (a.batch < 1 || a.heads < 1 || a.seq < 1 || a.seq > INT_MAX ||
      a.batch * a.heads > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.dtype == 1 && a.head_dim == 64) return launch<BF16, 64>(a, s);
  if (a.dtype == 2 && a.head_dim == 64) return launch<F16, 64>(a, s);
  if (a.dtype == 1 && a.head_dim == 128) return launch<BF16, 128>(a, s);
  if (a.dtype == 2 && a.head_dim == 128) return launch<F16, 128>(a, s);
  return (int)cudaErrorInvalidValue;
}

const char* tev_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
