// Fused-AUC weight histogram for NVIDIA Hopper (sm_90a).
//
// Replaces torcheval_tpu/ops/fused_auc.py::_hist_kernel (:164, the Pallas
// TPU kernel launched by _histogram_pallas). For each task t it adds into a
// (2, num_bins) float32 histogram: positive mass w*y in row 0, negative mass
// w*(1-y) in row 1, the bin of a sample being
//     min(int(clip(v, 0, 1) * num_bins), num_bins - 1)
// of its score v mapped to [0, 1]. The mapping is fused in:
//   - fixed bounds (lo, hi):  v = (s - lo) * inv_span, inv_span the float32
//     reciprocal of float32(hi - lo) -- the arithmetic XLA emits for the JAX
//     package's `(s - lo) / (hi - lo)` with constant bounds, so the bins are
//     bit-identical to its xla and pallas backends;
//   - per-task bounds (bounds=None): v = (s - lo[t]) / span[t] if span[t] > 0
//     else 0.5, lo and span from a torch min/max reduction before the launch
//     (the JAX package's _normalize_scores).
// A NaN v lands in bin 0, as the JAX package's float->int32 cast puts it.
// Every multiply, add and divide is an explicit round-to-nearest intrinsic
// and the file is built with --fmad=false, so no FMA contraction can move a
// sample across a bin edge. The TPU kernel contracts a one-hot matrix on the
// MXU (2 * n * num_bins MACs); on Hopper a histogram is an atomic scatter
// into on-chip memory, so nothing of that shape is kept.
//
// Bound: memory traffic. Each sample is read once: 8 B (score, label), 12 B
// with a weight. The histogram is read and written once (16 * num_bins B a
// task). A few flops a sample are far below the card's compute rate.
//
// Design: a thread block cluster of C CTAs (up to 16, the non-portable
// size) builds one task's histogram for its share of the samples in the
// CTAs' shared memory, in one of two layouts:
//   - replicated (the histogram fits a CTA: num_bins <= 8,192, 64 KB): every
//     CTA keeps a whole private copy and adds each sample with a local
//     shared-memory atomic. The flush reduces the cluster's C copies through
//     distributed shared memory: CTA r walks a contiguous range of the
//     2 * num_bins entries and sums each over the C copies
//     (`ld.shared::cluster` at the address `mapa` gives, in rank order), so
//     a cluster leaves one value a bin, not C.
//   - split (larger histograms): bin b lives only in CTA b % C at slot b / C
//     (interleaved, so a narrow band of hot bins spreads over every CTA),
//     and a sample owned by another CTA is added there with
//     `red.shared::cluster.add`.
// On the H100 a remote `red.shared::cluster` costs far more than a local
// shared atomic: 8,192 bins split over 8 CTAs ran 3-20x slower than private
// copies (PERF.md). So the split layout serves only histograms a CTA
// cannot hold, where the alternative is a global atomic a sample; past
// num_bins > 204,800 (100 KB slices at C = 16), or with fewer than 16
// samples a bin to pay for zeroing and flushing the slices, a global-memory
// variant adds every sample straight into the output.
//
// Unit weights (the streaming metrics' path) count: a bin holds a 32-bit
// sample count, added with an integer atomic -- shared memory adds integers
// natively but floats only through a compare-and-swap loop, which capped
// the first float version of this design at about one sample a clock an SM
// -- and the flush turns it into float32, exact while a bin stays below
// 2^24. A label other than 0 or 1 (soft, or NaN) adds its float masses
// straight into the output instead. Weighted launches add float masses.
//
// Work sized to the batch: a task gets one cluster for every 2,048 samples
// a CTA, up to a persistent grid that fills the card, and each cluster adds
// its non-zero bins into the state with one global atomic each, coalesced
// since each CTA walks a contiguous range. (One cluster a task could flush
// with plain stores, each bin having one writer; at the streaming batch of
// 65,536 samples four clusters beat one, so that flush is not kept.) The
// Python wrapper picks the layout and the cluster size and count from n, T
// and num_bins (ops/fused_auc.py::k1_geometry, from a measured sweep).
//
// HBM kept busy: scores, labels and weights are read 16 bytes at a time
// (kUnroll float4 loads of each in flight a thread before any atomic). A row
// whose score pointer is not 16-byte aligned takes scalar loads for its head
// (< 4 samples) and tail; a label or weight row whose address is out of
// phase with its score row (a one-element view, or a row broadcast over
// tasks whose length is not a multiple of 4) takes scalar loads throughout.
// The kernel decides per row from the addresses; nothing is copied to align.
//
// A lean launch: tev_fused_auc_hist_init sets the function attributes
// (dynamic shared memory, non-portable cluster size) once per device; the
// occupancy query (cudaOccupancyMaxActiveClusters) runs once per (device,
// layout). A launch takes its arguments as one packed struct, makes one
// cudaLaunchKernelEx with a cluster dimension, no cudaSetDevice and no
// attribute call, and returns cudaGetLastError(); a cluster that cannot be
// scheduled is an error the wrapper raises, never a retry with another
// design.
//
// Zero contributions are skipped (adding +0.0 to a bin that starts at +0.0
// never changes it). Float atomics add in an order that varies from run to
// run; with integer-valued weights every bin below 2^24 is exact in any
// order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

// Mirrored field for field by ops/_kernels.py::K1Launch (ctypes). At file
// scope: the extern "C" launcher takes it, so it needs external linkage.
struct K1Launch {
  const float* scores;     // (T, n) contiguous
  const float* labels;     // row t at labels + t * label_row_stride
  const float* weights;    // nullptr: unit weights
  const float* task_lo;    // (T,) when per_task_bounds
  const float* task_span;  // (T,) when per_task_bounds
  float* out;              // (T, 2, num_bins), accumulated into
  long long label_row_stride;
  long long weight_row_stride;
  long long n;
  int num_tasks;
  int num_bins;
  int per_task_bounds;  // 0: fixed (lo, inv_span); 1: task_lo/task_span
  float lo;
  float inv_span;
  int cluster;            // CTAs a cluster (power of two <= 16; 1: global)
  int clusters_per_task;  // clusters (blocks, global variant) a task
  int smem_bytes;         // 2 * slots * 4 a CTA; 0: global-memory variant
  int split;              // 0: replicated (slots == num_bins); 1: split
};

namespace {

constexpr int kThreads = 512;  // ops/fused_auc.py::_THREADS
constexpr int kUnroll = 2;     // float4 loads of each operand in flight

__device__ __forceinline__ int bin_of(float v, int num_bins) {
  if (v != v) return 0;  // NaN -> bin 0, as the JAX package's cast gives
  v = fminf(fmaxf(v, 0.0f), 1.0f);
  int b = __float2int_rz(__fmul_rn(v, (float)num_bins));
  return min(b, num_bins - 1);
}

// The shared::cluster address of `local` (a shared::cta address) in CTA
// `rank` of this cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void cluster_red_add(uint32_t addr, float v) {
  asm volatile("red.shared::cluster.add.f32 [%0], %1;"
               :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void cluster_red_add(uint32_t addr, uint32_t v) {
  asm volatile("red.shared::cluster.add.u32 [%0], %1;"
               :: "r"(addr), "r"(v) : "memory");
}

template <typename T>
__device__ __forceinline__ T cluster_load(uint32_t addr);

template <>
__device__ __forceinline__ float cluster_load<float>(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

template <>
__device__ __forceinline__ uint32_t cluster_load<uint32_t>(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Bins one task's samples and adds their masses into the task histogram:
// this cluster's shared memory (kShared) or the output row in device
// memory. kCount (unit weights): a bin holds sample counts, added with
// integer atomics -- shared memory adds 32-bit integers natively, floats
// only through a compare-and-swap loop -- and turned into float32 at the
// flush, exactly while a bin stays below 2^24. A label other than 0 or 1
// (soft, or NaN) then adds its float masses straight into the output.
template <bool kShared, bool kCount>
struct TaskSink {
  using Word = typename std::conditional<kCount, uint32_t, float>::type;
  float lo, inv_span, span;
  int per_task_bounds, num_bins;
  Word* slice;         // this CTA's copy (replicated) or slice (split)
  uint32_t smem_base;  // its shared::cta address
  uint32_t rank;       // this CTA's rank in its cluster
  int slots, log2c;
  bool split;
  float* out_t;

  __device__ __forceinline__ int bin(float s) const {
    float v;
    if (per_task_bounds) {
      v = span > 0.0f ? __fdiv_rn(__fsub_rn(s, lo), span) : 0.5f;
    } else {
      v = __fmul_rn(__fsub_rn(s, lo), inv_span);
    }
    return bin_of(v, num_bins);
  }

  // Adds `v` at slot `slot` of row `row` of the copy or slice that holds
  // bin b (`owner`): a local shared atomic, or a remote one.
  __device__ __forceinline__ void put(uint32_t owner, uint32_t slot, int row,
                                      Word v) const {
    const uint32_t i = row * slots + slot;
    if (owner == rank) {
      atomicAdd(&slice[i], v);
    } else {
      cluster_red_add(cluster_addr(smem_base + 4u * i, owner), v);
    }
  }

  __device__ __forceinline__ void add(float s, float y, float w) const {
    const int b = bin(s);
    if constexpr (kShared) {
      uint32_t owner = rank, slot = (uint32_t)b;
      if (split) {
        owner = (uint32_t)b & ((1u << log2c) - 1u);
        slot = (uint32_t)b >> log2c;
      }
      if constexpr (kCount) {
        if (y == 1.0f || y == 0.0f) {
          put(owner, slot, y == 0.0f, 1u);
          return;
        }
        // a soft or NaN label (w is 1): its float masses go below
      } else {
        const float wpos = __fmul_rn(w, y);
        const float wneg = __fmul_rn(w, __fsub_rn(1.0f, y));
        if (wpos != 0.0f) put(owner, slot, 0, wpos);
        if (wneg != 0.0f) put(owner, slot, 1, wneg);
        return;
      }
    }
    const float wpos = __fmul_rn(w, y);
    const float wneg = __fmul_rn(w, __fsub_rn(1.0f, y));
    if (wpos != 0.0f) atomicAdd(&out_t[b], wpos);
    if (wneg != 0.0f) atomicAdd(&out_t[num_bins + b], wneg);
  }

  __device__ __forceinline__ void add4(float4 s, float4 y, float4 w) const {
    add(s.x, y.x, w.x);
    add(s.y, y.y, w.y);
    add(s.z, y.z, w.z);
    add(s.w, y.w, w.w);
  }

  // This cluster's value of entry j (of 2 * num_bins): the owner's slot
  // (split), or the sum of the C copies in rank order (replicated).
  __device__ __forceinline__ float cluster_value(int j, int cluster) const {
    if (split) {
      const int row = j >= num_bins;
      const int b = j - row * num_bins;
      const uint32_t owner = (uint32_t)b & ((1u << log2c) - 1u);
      const uint32_t slot = (uint32_t)b >> log2c;
      return (float)cluster_load<Word>(
          cluster_addr(smem_base + 4u * (row * slots + slot), owner));
    }
    Word v = 0;
    for (int q = 0; q < cluster; ++q) {
      const Word x = (uint32_t)q == rank
                         ? slice[j]
                         : cluster_load<Word>(cluster_addr(smem_base + 4u * j, q));
      if constexpr (kCount) {
        v += x;  // exact
      } else {
        v = __fadd_rn(v, x);
      }
    }
    return (float)v;
  }
};

__device__ __forceinline__ float4 load4(const float* row, long long i, bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const float4*>(row + i));
  return make_float4(row[i], row[i + 1], row[i + 2], row[i + 3]);
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Grid (cluster * clusters_per_task, T); with kShared, clusters of
// `cluster` CTAs along x, each cluster one slice of a task's samples.
template <bool kShared, bool kCount>
__global__ void __launch_bounds__(kThreads)
fused_auc_hist_kernel(const K1Launch a) {
  using Sink = TaskSink<kShared, kCount>;
  extern __shared__ uint32_t smem[];
  const int t = blockIdx.y;
  float* const out_t = a.out + (long long)t * 2 * a.num_bins;
  const int slots = a.smem_bytes >> 3;

  Sink sink;
  sink.lo = a.lo;
  sink.inv_span = a.inv_span;
  sink.span = 0.0f;
  if (a.per_task_bounds) {
    sink.lo = a.task_lo[t];
    sink.span = a.task_span[t];
  }
  sink.per_task_bounds = a.per_task_bounds;
  sink.num_bins = a.num_bins;
  sink.slice = reinterpret_cast<typename Sink::Word*>(smem);
  sink.smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  sink.rank = 0;
  sink.slots = slots;
  sink.log2c = __ffs(a.cluster) - 1;
  sink.split = a.split != 0;
  sink.out_t = out_t;

  if constexpr (kShared) {
    sink.rank = cg::this_cluster().block_rank();
    for (int j = threadIdx.x; j < 2 * slots; j += kThreads) smem[j] = 0u;
    cg::this_cluster().sync();  // every slice zeroed before any remote add
  }

  const float* s_row = a.scores + (long long)t * a.n;
  const float* y_row = a.labels + (long long)t * a.label_row_stride;
  const float* w_row =
      kCount ? nullptr : a.weights + (long long)t * a.weight_row_stride;
  const long long n = a.n;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;

  // scalar head up to the score row's first 16-byte boundary, and tail
  const long long head = min(
      (long long)(((16u - (reinterpret_cast<uintptr_t>(s_row) & 15u)) & 15u) >> 2), n);
  const long long groups = (n - head) >> 2;
  const long long tail = head + 4 * groups;
  for (long long i = tid; i < head; i += nthreads) {
    sink.add(s_row[i], y_row[i], w_row ? w_row[i] : 1.0f);
  }
  for (long long i = tail + tid; i < n; i += nthreads) {
    sink.add(s_row[i], y_row[i], w_row ? w_row[i] : 1.0f);
  }

  const float* s_body = s_row + head;
  const float* y_body = y_row + head;
  const float* w_body = w_row ? w_row + head : nullptr;
  const bool vec_y = aligned16(y_body);
  const bool vec_w = w_body && aligned16(w_body);
  const float4 ones = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  for (long long g0 = tid; g0 < groups; g0 += kUnroll * nthreads) {
    float4 sv[kUnroll], yv[kUnroll], wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = g0 + u * nthreads;
      if (g < groups) {
        sv[u] = load4(s_body, 4 * g, true);
        yv[u] = load4(y_body, 4 * g, vec_y);
        wv[u] = w_body ? load4(w_body, 4 * g, vec_w) : ones;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (g0 + u * nthreads < groups) sink.add4(sv[u], yv[u], wv[u]);
    }
  }

  if constexpr (kShared) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every add landed
    // CTA r flushes entries [r * chunk, (r + 1) * chunk) of the task's
    // 2 * num_bins
    const int entries = 2 * a.num_bins;
    const int chunk = (entries + a.cluster - 1) / a.cluster;
    const int begin = (int)sink.rank * chunk;
    const int end = min(begin + chunk, entries);
    for (int j = begin + threadIdx.x; j < end; j += kThreads) {
      const float v = sink.cluster_value(j, a.cluster);
      if (v != 0.0f) atomicAdd(&out_t[j], v);
    }
    cluster.sync();  // no CTA leaves while its shared memory is still read
  }
}

using KernelFn = void (*)(K1Launch);
// the cluster variants: unit weights (counts) and weighted
const KernelFn kSharedKernels[] = {fused_auc_hist_kernel<true, true>,
                                   fused_auc_hist_kernel<true, false>};

}  // namespace

extern "C" {

// Once per device, before the first launch there, with that device
// current: the shared-memory limit of the cluster variant
// (`max_smem_bytes` a CTA) and its non-portable cluster size. Returns a
// CUDA error code (0 on success).
int tev_fused_auc_hist_init(int max_smem_bytes) {
  for (KernelFn kernel : kSharedKernels) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Clusters of `cluster` CTAs with `smem_bytes` each that can be resident on
// the current device at once (cudaOccupancyMaxActiveClusters, the fewer of
// the unit-weight and weighted kernels), or a negative CUDA error code. Run
// after tev_fused_auc_hist_init.
int tev_fused_auc_hist_max_active_clusters(int cluster, int smem_bytes) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fewest = 1 << 30;
  for (KernelFn kernel : kSharedKernels) {
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return -(int)err;
    fewest = clusters < fewest ? clusters : fewest;
  }
  return fewest;
}

// Blocks of the global-memory variant that fit on one SM of the current
// device (0 on error).
int tev_fused_auc_hist_global_blocks_per_sm(void) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_auc_hist_kernel<false, false>, kThreads, 0) != cudaSuccess) {
    return 0;
  }
  return per_sm;
}

// One launch on `stream` (a cudaStream_t of the current device) of the
// geometry in `args`: grid (cluster * clusters_per_task, num_tasks), the
// cluster variant when smem_bytes > 0 (counting when weights is null).
// Adds the histogram into args->out, which the caller zeroes for a
// one-shot histogram. Returns the launch's error, else cudaGetLastError()
// (0 on success).
int tev_fused_auc_hist(const K1Launch* args, void* stream) {
  const K1Launch& a = *args;
  if (a.n <= 0 || a.num_tasks <= 0) return 0;
  const int c = a.cluster;
  const long long slots = a.smem_bytes / 8;
  if (c < 1 || c > 16 || (c & (c - 1)) != 0 || a.clusters_per_task < 1 ||
      (a.smem_bytes > 0 && (a.split ? slots * c : slots) < a.num_bins)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * a.clusters_per_task, a.num_tasks, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = a.smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaError_t err;
  if (a.smem_bytes > 0) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = a.weights ? cudaLaunchKernelEx(&cfg, fused_auc_hist_kernel<true, false>, a)
                    : cudaLaunchKernelEx(&cfg, fused_auc_hist_kernel<true, true>, a);
  } else {
    err = cudaLaunchKernelEx(&cfg, fused_auc_hist_kernel<false, false>, a);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* tev_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
