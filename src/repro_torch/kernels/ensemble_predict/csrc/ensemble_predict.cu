// Ensemble traversal on Hopper: every tree of a packed FedGBF ensemble,
// bin + traverse + combine, in one launch.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/ensemble_predict/ensemble_predict.py:
//   ensemble_predict_raw    <- predict_forest_raw_pallas_call (_predict_raw_kernel):
//                              raw f32 features against value-space thresholds;
//   ensemble_predict_binned <- predict_forest_pallas_call (_predict_kernel):
//                              int32 bins against bin-space thresholds.
// The TPU kernels read every node and every feature through one-hot
// contractions on the MXU, because the TPU has no per-lane gather.  Hopper
// has gathers, so here each thread reads its node and its feature directly.
//
// Design (right and simple first): one thread per row, 256 threads per
// block, the ragged last block masked (no padding copy).  The block stages
// the tree tables -- feature i32, threshold (f32 or i32), leaf f32, scale
// f32 -- into shared memory, in chunks of whole trees of at most 48 KB
// (92 B a tree at depth 3, so the 78-tree serving model is one 7 KB chunk).
// Each thread descends max_depth levels per tree and accumulates
// acc + leaf * scale in tree order as one FMA, __fmaf_rn, rounded once: the
// step XLA's CPU backend contracts the TPU kernels' accumulation into, and
// the step of the plain PyTorch version (ref.py, through core/fma.py), so
// the kernel equals both bit for bit.  The
// raw kernel sanitises each feature it reads (NaN -> -FLT_MAX, +-inf clipped
// to +-FLT_MAX), without which +inf > FLT_MAX would route an infinite
// feature right at an unsplit node.
//
// Bound: the bytes of x (n * d * 4) plus the tables and the output, read
// once; the work is a chain of max_depth dependent gathers per tree and row,
// so latency, not the HBM rate, is what this simple form hits first.  No
// wgmma or TMA is used yet: there is no matrix product here, and the
// row-per-thread gathers read x through L1.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemBytes = 48 * 1024;  // no opt-in attribute needed
constexpr int kMaxDepth = 12;

__device__ __forceinline__ float sanitize(float v) {
  return isnan(v) ? -FLT_MAX : fminf(fmaxf(v, -FLT_MAX), FLT_MAX);
}

template <bool kRaw, typename T>
__global__ void __launch_bounds__(kThreads)
ensemble_predict_kernel(const T* __restrict__ x,
                        const int* __restrict__ feature,
                        const T* __restrict__ threshold,
                        const float* __restrict__ leaf,
                        const float* __restrict__ scale,
                        float* __restrict__ out,
                        int n, int d, int n_trees, int max_depth, int chunk) {
  extern __shared__ int4 smem[];
  const int n_internal = (1 << max_depth) - 1;
  const int n_leaves = 1 << max_depth;
  int* s_feature = reinterpret_cast<int*>(smem);
  T* s_threshold = reinterpret_cast<T*>(s_feature + chunk * n_internal);
  float* s_leaf = reinterpret_cast<float*>(s_threshold + chunk * n_internal);
  float* s_scale = s_leaf + chunk * n_leaves;

  const long long row =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = row < n;
  const T* x_row = x + (active ? row : 0) * static_cast<long long>(d);
  float acc = 0.0f;

  for (int t0 = 0; t0 < n_trees; t0 += chunk) {
    const int c = min(chunk, n_trees - t0);
    __syncthreads();  // the previous chunk is no longer read
    const size_t node0 = static_cast<size_t>(t0) * n_internal;
    for (int i = threadIdx.x; i < c * n_internal; i += kThreads) {
      s_feature[i] = feature[node0 + i];
      s_threshold[i] = threshold[node0 + i];
    }
    const size_t leaf0 = static_cast<size_t>(t0) * n_leaves;
    for (int i = threadIdx.x; i < c * n_leaves; i += kThreads) {
      s_leaf[i] = leaf[leaf0 + i];
    }
    for (int i = threadIdx.x; i < c; i += kThreads) {
      s_scale[i] = scale[t0 + i];
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < c; ++t) {
        const int* t_feature = s_feature + t * n_internal;
        const T* t_threshold = s_threshold + t * n_internal;
        int idx = 0;
        for (int level = 0; level < max_depth; ++level) {
          const int node = (1 << level) - 1 + idx;
          const int f = t_feature[node];
          // clamp as JAX's clip + clamping gather do; f == -1 never goes right
          T v = x_row[min(max(f, 0), d - 1)];
          if constexpr (kRaw) {
            v = sanitize(v);
          }
          idx = 2 * idx + ((f >= 0 && v > t_threshold[node]) ? 1 : 0);
        }
        acc = __fmaf_rn(s_leaf[t * n_leaves + idx], s_scale[t], acc);
      }
    }
  }
  if (active) {
    out[row] = acc;
  }
}

template <bool kRaw, typename T>
int launch(const T* x, const int* feature, const T* threshold,
           const float* leaf, const float* scale, float* out, int n, int d,
           int n_trees, int max_depth, void* stream) {
  if (n <= 0 || d <= 0 || n_trees <= 0 || max_depth < 0 ||
      max_depth > kMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t n_internal = (size_t{1} << max_depth) - 1;
  const size_t n_leaves = size_t{1} << max_depth;
  const size_t per_tree = n_internal * (sizeof(int) + sizeof(T)) +
                          (n_leaves + 1) * sizeof(float);
  size_t chunk = kSmemBytes / per_tree;
  if (chunk > static_cast<size_t>(n_trees)) chunk = n_trees;
  if (chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  ensemble_predict_kernel<kRaw, T>
      <<<blocks, kThreads, chunk * per_tree,
         static_cast<cudaStream_t>(stream)>>>(
          x, feature, threshold, leaf, scale, out, n, d, n_trees, max_depth,
          static_cast<int>(chunk));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers of contiguous
// tensors; stream is a cudaStream_t.  Returns the cudaError_t of the launch.
extern "C" int ensemble_predict_raw(const float* x, const int* feature,
                                    const float* thr_value, const float* leaf,
                                    const float* scale, float* out, int n,
                                    int d, int n_trees, int max_depth,
                                    void* stream) {
  return launch<true, float>(x, feature, thr_value, leaf, scale, out, n, d,
                             n_trees, max_depth, stream);
}

extern "C" int ensemble_predict_binned(const int* binned, const int* feature,
                                       const int* threshold, const float* leaf,
                                       const float* scale, float* out, int n,
                                       int d, int n_trees, int max_depth,
                                       void* stream) {
  return launch<false, int>(binned, feature, threshold, leaf, scale, out, n,
                            d, n_trees, max_depth, stream);
}
