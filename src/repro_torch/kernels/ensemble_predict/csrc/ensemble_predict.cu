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
// Function (unchanged from the first port): each tree descends max_depth
// levels, going right iff f >= 0 && v > thr, with f clamped to [0, d-1] for
// the read; per row acc = __fmaf_rn(leaf_t[idx], scale_t, acc) from 0 in
// tree order, rounded once per tree: the step XLA's CPU backend contracts
// the TPU kernels' accumulation into and the step of the plain PyTorch
// version (ref.py, through core/fma.py), so the kernel equals both bit for
// bit.  No base_score is added.  The raw kernel sanitises its input (NaN ->
// -FLT_MAX, +-inf clipped to +-FLT_MAX), without which +inf > FLT_MAX would
// route an infinite feature right at an unsplit node.
//
// Bound: the bytes of x (n * d * 4) read once and the output written once;
// there is no arithmetic to speak of.  At the serving batch (8192 x 23) that
// is 0.8 MB, a quarter of a microsecond, far below a launch: there the
// floor is the launch itself, and the aim is a kernel that finishes in a
// few microseconds of it.  At large batches (262,144 x 23: 24 MB, 7.5 us)
// the walk sets the pace, not HBM: one thread a row takes about 6 us more
// for each further 256-row tile an SM.  What limits it is not measured; it
// is not bank conflicts on the x gathers (a column-major tile, free of
// them, was slower; see PERF.md).  The first port missed the serving aim
// by a wide margin: one thread per row (32 blocks of 256 for 8192 rows on
// 132 SMs), each a chain of trees x levels dependent reads (node feature,
// x gather, threshold) with runtime loop bounds, x gathered through L1 at
// a 92-byte stride.
//
// Design (sizes chosen by ops.launch_config, passed in, checked here):
// * Rows in tiles, trees over threads.  A block of 256 threads takes tiles
//   of R rows with G threads per row (R * G = 256; R = 32, G = 8 for a
//   forest of 8 trees or more), so 8192 rows make 256 tiles.  Thread (r, g)
//   walks trees g, g + G, ... of the current chunk for row r, two at a time
//   so that two trees' chains overlap, and writes each chosen leaf value
//   into shared memory, s_val[t][r].  After a barrier the row's owner (g =
//   0) runs the FMA chain over the chunk in tree order from s_val and
//   s_scale: the arithmetic of the plain version, unchanged.  Blocks loop
//   over tiles (grid <= the blocks the SMs hold, from the occupancy
//   calculator, ensemble_predict_occupancy); an ensemble that is one chunk
//   is staged once per block, not once per tile.
// * Large batches (two 256-row tiles an SM or more) and single trees take
//   G = 1: a thread walks every tree of its row, two in flight, and runs
//   the FMA chain as it goes, with no leaf buffer: fewer shared loads and
//   instructions a row, and enough rows in flight to hide each chain.
// * The two trees in flight are walked in step, one level of each per
//   iteration of one loop over the depth, so their dependent loads
//   overlap.  Depth 3 (TreeConfig's default, and the depth of the shipped
//   checkpoint) has an instance of its own whose level loop unrolls; every
//   other depth (0-12) takes the runtime-depth instance.  ops.launch_config
//   picks the instance (unrolled).
// * Staging issues each thread's loads (up to four) before its stores, so
//   that a block waits for one round trip to memory, not one per item.
// * The row tile of x is staged into shared memory once, with coalesced
//   loads, at an odd row stride (conflict-free for the level-0 reads, where
//   every row of a warp reads one feature); the raw kernel sanitises each
//   value as it is staged.  Where R rows of d features exceed the tile
//   budget (large d), x is read from global memory as before, sanitised at
//   the read; every d is accepted.
// * One 8-byte shared load per node: (feature, threshold) packed as an
//   int2 as the tables are staged, the feature already clamped and an
//   unsplit node's threshold replaced by one no value exceeds (+inf for
//   sanitised floats, INT_MAX for bins), so a level is one load, one
//   gather and one compare.
// * Shared memory: the tables chunk, s_val (G > 1), and the x tile.  The
//   chunk fits 48 KB where one tree does; a deeper tree (depth 12: 49,148
//   B of tables) takes one tree a chunk and opts in above 48 KB
//   (cudaFuncSetAttribute, once per instance).

#include <cfloat>
#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may opt into
constexpr int kMaxDepth = 12;
constexpr int kUnrolledDepth = 3;  // the depth with an instance of its own

__device__ __forceinline__ float sanitize(float v) {
  return isnan(v) ? -FLT_MAX : fminf(fmaxf(v, -FLT_MAX), FLT_MAX);
}

template <typename T>
__device__ __forceinline__ T as_value(int bits);
template <>
__device__ __forceinline__ float as_value<float>(int bits) {
  return __int_as_float(bits);
}
template <>
__device__ __forceinline__ int as_value<int>(int bits) {
  return bits;
}

__device__ __forceinline__ int value_bits(float v) { return __float_as_int(v); }
__device__ __forceinline__ int value_bits(int v) { return v; }

// A threshold no (sanitised) value exceeds: an unsplit node routes left.
template <typename T>
__device__ __forceinline__ int never_right();
template <>
__device__ __forceinline__ int never_right<float>() {
  return 0x7f800000;  // +inf
}
template <>
__device__ __forceinline__ int never_right<int>() {
  return INT_MAX;
}

// The leaves reached in trees a and b (possibly the same tree), walked in
// step so that the two dependent chains overlap: nodes are each tree's
// packed (clamped feature, threshold) pairs in level order, xr the row's
// features (read from global memory and sanitised at the read where x is
// not staged).  kDepth >= 0 fixes the depth (the loop unrolls); -1 takes
// depth.
template <bool kSanitize, typename T, int kDepth>
__device__ __forceinline__ int2 walk2(const int2* __restrict__ a,
                                      const int2* __restrict__ b,
                                      const T* xr, int depth) {
  const int levels = kDepth >= 0 ? kDepth : depth;
  int ia = 0, ib = 0;
#pragma unroll
  for (int level = 0; level < levels; ++level) {
    const int first = (1 << level) - 1;
    const int2 pa = a[first + ia];
    const int2 pb = b[first + ib];
    T va = xr[pa.x];
    T vb = xr[pb.x];
    if constexpr (kSanitize) {
      va = sanitize(va);
      vb = sanitize(vb);
    }
    ia = 2 * ia + (va > as_value<T>(pa.y) ? 1 : 0);
    ib = 2 * ib + (vb > as_value<T>(pb.y) ? 1 : 0);
  }
  return make_int2(ia, ib);
}

// Copies count items into shared memory, each thread's loads (up to four
// a round) all in flight before its stores: load(i) gives item i,
// store(i, v) puts it in place.
template <typename V, typename Load, typename Store>
__device__ __forceinline__ void stage(int count, Load load, Store store) {
  for (int base = 0; base < count; base += 4 * kThreads) {
    V v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + k * kThreads + threadIdx.x;
      if (i < count) v[k] = load(i);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + k * kThreads + threadIdx.x;
      if (i < count) store(i, v[k]);
    }
  }
}

template <bool kRaw, typename T, int kDepth, bool kStageX>
__global__ void __launch_bounds__(kThreads)
ensemble_predict_kernel(const T* __restrict__ x,
                        const int* __restrict__ feature,
                        const T* __restrict__ threshold,
                        const float* __restrict__ leaf,
                        const float* __restrict__ scale,
                        float* __restrict__ out, int n, int d, int n_trees,
                        int depth, int rows, int lanes, int chunk,
                        int stride) {
  const int n_internal = (1 << depth) - 1;
  const int n_leaves = 1 << depth;
  extern __shared__ int4 smem[];
  int2* s_node = reinterpret_cast<int2*>(smem);              // chunk x I
  float* s_leaf = reinterpret_cast<float*>(s_node + chunk * n_internal);
  float* s_scale = s_leaf + chunk * n_leaves;                // chunk
  float* s_val = s_scale + chunk;              // chunk x R, if lanes > 1
  T* s_x = reinterpret_cast<T*>(s_val + (lanes > 1 ? chunk * rows : 0));

  const int r = threadIdx.x % rows;
  const int g = threadIdx.x / rows;
  const int n_tiles = (n + rows - 1) / rows;
  const bool restage = chunk < n_trees;  // tables change within a tile
  bool staged = false;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * rows;
    const int rows_here =
        n - row0 < rows ? static_cast<int>(n - row0) : rows;
    const bool active = r < rows_here;
    const T* xr = kStageX ? s_x + r * stride
                          : x + (row0 + (active ? r : 0)) * d;
    float acc = 0.0f;
    for (int t0 = 0; t0 < n_trees; t0 += chunk) {
      const int c = min(chunk, n_trees - t0);
      if (restage || !staged) {
        // the previous chunk's walk and chain no longer read the tables
        if (staged) __syncthreads();
        const int* t_feature = feature + static_cast<size_t>(t0) * n_internal;
        const T* t_threshold =
            threshold + static_cast<size_t>(t0) * n_internal;
        const float* t_leaf = leaf + static_cast<size_t>(t0) * n_leaves;
        stage<int2>(
            c * n_internal,
            [&](int i) {
              return make_int2(t_feature[i], value_bits(t_threshold[i]));
            },
            [&](int i, int2 p) {
              s_node[i] = p.x < 0 ? make_int2(0, never_right<T>())
                                  : make_int2(min(p.x, d - 1), p.y);
            });
        stage<float>(
            c * n_leaves, [&](int i) { return t_leaf[i]; },
            [&](int i, float v) { s_leaf[i] = v; });
        for (int i = threadIdx.x; i < c; i += kThreads) {
          s_scale[i] = scale[t0 + i];
        }
        staged = true;
      }
      if (kStageX && t0 == 0) {
        // the previous tile's walk is past the barrier below; its chain
        // reads s_val and s_scale only
        const T* src = x + row0 * d;
        stage<T>(
            rows_here * d, [&](int i) { return src[i]; },
            [&](int i, T v) {
              if constexpr (kRaw) v = sanitize(v);
              const int rr = i / d;
              s_x[rr * stride + (i - rr * d)] = v;
            });
      }
      __syncthreads();  // tables, x tile staged; the last chain is done
      if (active) {
        for (int t = g; t < c; t += 2 * lanes) {
          // two trees in flight: their chains are independent
          const int t2 = t + lanes < c ? t + lanes : t;
          const int2 i = walk2<kRaw && !kStageX, T, kDepth>(
              s_node + t * n_internal, s_node + t2 * n_internal, xr, depth);
          const float v1 = s_leaf[t * n_leaves + i.x];
          const float v2 = s_leaf[t2 * n_leaves + i.y];
          if (lanes == 1) {
            // one thread a row: the chain runs as the trees are walked
            acc = __fmaf_rn(v1, s_scale[t], acc);
            if (t2 != t) acc = __fmaf_rn(v2, s_scale[t2], acc);
          } else {
            s_val[t * rows + r] = v1;
            if (t2 != t) s_val[t2 * rows + r] = v2;
          }
        }
      }
      __syncthreads();  // s_val complete; s_x and the tables read
      if (lanes > 1 && active && g == 0) {
#pragma unroll 8
        for (int t = 0; t < c; ++t) {
          acc = __fmaf_rn(s_val[t * rows + r], s_scale[t], acc);
        }
      }
    }
    if (active && g == 0) {
      out[row0 + r] = acc;
    }
  }
}

// Bytes of dynamic shared memory the kernel's layout needs.
size_t smem_needed(int depth, int rows, int lanes, int chunk, int stride,
                   bool stage_x) {
  const size_t n_internal = (size_t{1} << depth) - 1;
  const size_t n_leaves = size_t{1} << depth;
  const size_t s_val_rows = lanes > 1 ? rows : 0;
  return chunk * (n_internal * sizeof(int2) +
                  (n_leaves + 1 + s_val_rows) * sizeof(float)) +
         (stage_x ? static_cast<size_t>(rows) * stride * 4 : 0);
}

// Allows the instance (once) up to the most shared memory a block may
// have, where smem needs more than the default.
template <bool kRaw, typename T, int kDepth, bool kStageX>
cudaError_t opt_in(int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  static const cudaError_t err = cudaFuncSetAttribute(
      ensemble_predict_kernel<kRaw, T, kDepth, kStageX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

template <bool kRaw, typename T, int kDepth, bool kStageX>
int launch_instance(const T* x, const int* feature, const T* threshold,
                    const float* leaf, const float* scale, float* out, int n,
                    int d, int n_trees, int max_depth, int rows, int lanes,
                    int chunk, int stride, int smem, int grid,
                    cudaStream_t stream) {
  const cudaError_t err = opt_in<kRaw, T, kDepth, kStageX>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ensemble_predict_kernel<kRaw, T, kDepth, kStageX>
      <<<grid, kThreads, smem, stream>>>(x, feature, threshold, leaf, scale,
                                         out, n, d, n_trees, max_depth, rows,
                                         lanes, chunk, stride);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of 256 threads with smem bytes of dynamic shared memory that one
// SM holds at once, registers and shared memory both counted.
template <bool kRaw, typename T, int kDepth, bool kStageX>
int occupancy_of(int smem, int* blocks) {
  cudaError_t err = opt_in<kRaw, T, kDepth, kStageX>(smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ensemble_predict_kernel<kRaw, T, kDepth, kStageX>, kThreads,
        smem);
  }
  return static_cast<int>(err);
}

template <bool kRaw, typename T>
int occupancy(int unrolled, int stage_x, int smem, int* blocks) {
  if (unrolled) {
    return stage_x ? occupancy_of<kRaw, T, kUnrolledDepth, true>(smem, blocks)
                   : occupancy_of<kRaw, T, kUnrolledDepth, false>(smem,
                                                                  blocks);
  }
  return stage_x ? occupancy_of<kRaw, T, -1, true>(smem, blocks)
                 : occupancy_of<kRaw, T, -1, false>(smem, blocks);
}

template <bool kRaw, typename T>
int launch(const T* x, const int* feature, const T* threshold,
           const float* leaf, const float* scale, float* out, int n, int d,
           int n_trees, int max_depth, int rows, int lanes, int chunk,
           int stride, int stage_x, int unrolled, int smem, int grid,
           void* stream) {
  if (n <= 0 || d <= 0 || n_trees <= 0 || max_depth < 0 ||
      max_depth > kMaxDepth || (unrolled && max_depth != kUnrolledDepth) ||
      lanes <= 0 || rows <= 0 ||
      rows * lanes != kThreads || chunk <= 0 || chunk > n_trees ||
      grid <= 0 || smem < 0 || smem > kMaxSmem ||
      (stage_x && stride < d) ||
      static_cast<size_t>(smem) < smem_needed(max_depth, rows, lanes, chunk,
                                              stride, stage_x != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EP_ARGS                                                              \
  x, feature, threshold, leaf, scale, out, n, d, n_trees, max_depth, rows, \
      lanes, chunk, stride, smem, grid, s
  if (unrolled) {
    return stage_x ? launch_instance<kRaw, T, kUnrolledDepth, true>(EP_ARGS)
                   : launch_instance<kRaw, T, kUnrolledDepth, false>(EP_ARGS);
  }
  return stage_x ? launch_instance<kRaw, T, -1, true>(EP_ARGS)
                 : launch_instance<kRaw, T, -1, false>(EP_ARGS);
#undef EP_ARGS
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers of contiguous
// tensors; stream is a cudaStream_t.  rows, lanes, chunk, stride, stage_x,
// unrolled, smem and grid are ops.launch_config's choice.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for sizes the kernel
// does not take).
extern "C" int ensemble_predict_raw(const float* x, const int* feature,
                                    const float* thr_value, const float* leaf,
                                    const float* scale, float* out, int n,
                                    int d, int n_trees, int max_depth,
                                    int rows, int lanes, int chunk,
                                    int stride, int stage_x, int unrolled,
                                    int smem, int grid, void* stream) {
  return launch<true, float>(x, feature, thr_value, leaf, scale, out, n, d,
                             n_trees, max_depth, rows, lanes, chunk, stride,
                             stage_x, unrolled, smem, grid, stream);
}

extern "C" int ensemble_predict_binned(const int* binned, const int* feature,
                                       const int* threshold, const float* leaf,
                                       const float* scale, float* out, int n,
                                       int d, int n_trees, int max_depth,
                                       int rows, int lanes, int chunk,
                                       int stride, int stage_x, int unrolled,
                                       int smem, int grid, void* stream) {
  return launch<false, int>(binned, feature, threshold, leaf, scale, out, n,
                            d, n_trees, max_depth, rows, lanes, chunk, stride,
                            stage_x, unrolled, smem, grid, stream);
}

// The blocks one SM of the current device holds of the raw (raw != 0) or
// binned instance, depth-3 (unrolled != 0) or runtime-depth, that stages x
// (stage_x != 0) or not, at smem bytes of dynamic shared memory:
// ops.launch_config's grid.  Returns the cudaError_t of the query.
extern "C" int ensemble_predict_occupancy(int raw, int unrolled, int stage_x,
                                          int smem, int* blocks) {
  if (smem < 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return raw ? occupancy<true, float>(unrolled, stage_x, smem, blocks)
             : occupancy<false, int>(unrolled, stage_x, smem, blocks);
}
