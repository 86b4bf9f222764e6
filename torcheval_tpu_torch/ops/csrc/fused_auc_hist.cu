// Fused-AUC weight histogram for NVIDIA Hopper (sm_90a).
//
// Replaces torcheval_tpu/ops/fused_auc.py::_hist_kernel (the Pallas TPU
// kernel launched by _histogram_pallas). For each task t it builds a
// (2, num_bins) float32 histogram: positive mass w*y in row 0, negative
// mass w*(1-y) in row 1, the bin of a sample being
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
// sample across a bin edge.
//
// Bound: memory traffic. Each sample is read once (4 B score, 4 B label,
// 4 B weight when one is given: 12*T*n bytes at most) and the histogram is
// written once (8*T*num_bins bytes), plus read once (8*T*num_bins) when the
// kernel accumulates into an existing histogram. There are ~10 flops per
// sample, far below the card's compute rate.
//
// Design: grid (sample blocks, T). A block walks its share of the samples
// with a grid-stride loop (coalesced loads) and adds each sample into a
// block-private 2*num_bins float histogram in dynamic shared memory with
// shared-memory atomics, so the per-sample atomics never touch device
// memory. At the end the block adds its non-zero bins into the (T, 2,
// num_bins) output with one global atomic each. Above the shared-memory
// budget (2*num_bins*4 bytes over ~200 KB) a second variant adds straight
// into the output in device memory; the Python wrapper picks the variant by
// size. Zero contributions are skipped (adding +0.0 to a bin that starts at
// +0.0 never changes it), which halves the atomics for 0/1 labels.
//
// Float atomics add in an order that varies from run to run; with
// integer-valued weights every bin below 2^24 is exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct HistArgs {
  const float* scores;      // (T, n) contiguous
  const float* labels;      // row t at labels + t * label_row_stride
  long long label_row_stride;
  const float* weights;     // nullptr: unit weights
  long long weight_row_stride;
  long long n;
  int num_bins;
  int per_task_bounds;      // 0: fixed (lo, inv_span); 1: task_lo/task_span
  float lo;
  float inv_span;
  const float* task_lo;     // (T,) when per_task_bounds
  const float* task_span;   // (T,) when per_task_bounds
  float* out;               // (T, 2, num_bins), accumulated into
};

__device__ __forceinline__ int bin_of(float v, int num_bins) {
  if (v != v) return 0;  // NaN -> bin 0, as the JAX package's cast gives
  v = fminf(fmaxf(v, 0.0f), 1.0f);
  int b = __float2int_rz(__fmul_rn(v, (float)num_bins));
  return min(b, num_bins - 1);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
fused_auc_hist_kernel(HistArgs a) {
  extern __shared__ float smem[];
  const int t = blockIdx.y;
  const int two_b = 2 * a.num_bins;
  float* const out_t = a.out + (long long)t * two_b;
  float* const hist = kShared ? smem : out_t;

  if (kShared) {
    for (int j = threadIdx.x; j < two_b; j += blockDim.x) smem[j] = 0.0f;
    __syncthreads();
  }

  float lo = a.lo, inv_span = a.inv_span, span = 0.0f;
  if (a.per_task_bounds) {
    lo = a.task_lo[t];
    span = a.task_span[t];
  }
  const float* s_row = a.scores + (long long)t * a.n;
  const float* y_row = a.labels + (long long)t * a.label_row_stride;
  const float* w_row =
      a.weights ? a.weights + (long long)t * a.weight_row_stride : nullptr;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += stride) {
    const float s = s_row[i];
    float v;
    if (a.per_task_bounds) {
      v = span > 0.0f ? __fdiv_rn(__fsub_rn(s, lo), span) : 0.5f;
    } else {
      v = __fmul_rn(__fsub_rn(s, lo), inv_span);
    }
    const int b = bin_of(v, a.num_bins);
    const float y = y_row[i];
    const float w = w_row ? w_row[i] : 1.0f;
    const float wpos = __fmul_rn(w, y);
    const float wneg = __fmul_rn(w, __fsub_rn(1.0f, y));
    if (wpos != 0.0f) atomicAdd(&hist[b], wpos);
    if (wneg != 0.0f) atomicAdd(&hist[a.num_bins + b], wneg);
  }

  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < two_b; j += blockDim.x) {
      const float v = smem[j];
      if (v != 0.0f) atomicAdd(&out_t[j], v);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from torch.cuda.current_stream()) on
// CUDA device `device`, with a (blocks_per_task, num_tasks) grid. Adds the
// histogram of the samples into `out`, which the caller zeroes for a
// one-shot histogram. `use_shared` picks the shared-memory variant.
// Returns cudaGetLastError() after the launch (0 on success).
int tev_fused_auc_hist(const float* scores, const float* labels,
                       long long label_row_stride, const float* weights,
                       long long weight_row_stride, long long n, int num_tasks,
                       int num_bins, int per_task_bounds, float lo,
                       float inv_span, const float* task_lo,
                       const float* task_span, float* out, int use_shared,
                       int blocks_per_task, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || num_tasks <= 0) return 0;

  HistArgs a;
  a.scores = scores;
  a.labels = labels;
  a.label_row_stride = label_row_stride;
  a.weights = weights;
  a.weight_row_stride = weight_row_stride;
  a.n = n;
  a.num_bins = num_bins;
  a.per_task_bounds = per_task_bounds;
  a.lo = lo;
  a.inv_span = inv_span;
  a.task_lo = task_lo;
  a.task_span = task_span;
  a.out = out;

  dim3 grid(blocks_per_task < 1 ? 1 : blocks_per_task, num_tasks);
  cudaStream_t s = (cudaStream_t)stream;
  if (use_shared) {
    const int bytes = 2 * num_bins * (int)sizeof(float);
    if (bytes > 48 * 1024) {  // above 48 KB only after an explicit opt-in
      err = cudaFuncSetAttribute(fused_auc_hist_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
      if (err != cudaSuccess) return (int)err;
    }
    fused_auc_hist_kernel<true><<<grid, kThreads, bytes, s>>>(a);
  } else {
    fused_auc_hist_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// Blocks of the shared-memory variant that fit on one SM at `num_bins`
// (0 on error): the wrapper sizes its grid from it.
int tev_fused_auc_hist_blocks_per_sm(int num_bins, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  const int bytes = 2 * num_bins * (int)sizeof(float);
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(fused_auc_hist_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess) {
    return 0;
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_auc_hist_kernel<true>, kThreads, bytes) != cudaSuccess) {
    return 0;
  }
  return per_sm;
}

const char* tev_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
