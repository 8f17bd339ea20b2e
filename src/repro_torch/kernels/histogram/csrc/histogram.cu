// Gradient-histogram accumulation on Hopper: hist[t, node, f, bin, :] +=
// [g*w_t, h*w_t, w_t] over the rows of each tree t of a boosting round.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/histogram/:
//   histogram_round  <- train_histogram.py fused_round_histogram_pallas_call
//                       (_fused_round_histogram_kernel): the whole round's T
//                       trees in one launch, ids and stats formed in-kernel,
//                       child_mode for the subtraction pipeline;
//   histogram_round with T = 1
//                    <- train_histogram.py fused_histogram_pallas_call
//                       (_fused_histogram_kernel), the single-tree form;
//   histogram_staged <- histogram.py histogram_pallas_call
//                       (_histogram_kernel): the same accumulation on ids
//                       = assign * B + binned and data = [g*w, h*w, w]
//                       staged beforehand.
// The TPU kernels build a one-hot of the ids and contract it on the MXU,
// because the TPU has no scatter.  Hopper has one, but a float atomicAdd
// adds in scheduling order, and two launches on the same input must give
// bit-identical histograms or the trees built on the card change from run
// to run.  So nothing here is atomic.
//
// Design (right and simple first): one thread owns one histogram slot
// (node * B + bin) of one feature of one tree and scans every row in row
// order, adding the row's stats when the row's id is its slot.  Each sum is
// therefore the sequential sum in row order -- the order of the CPU's
// index_add_ and of XLA's segment_sum on the CPU -- so the kernel is
// bit-equal to the plain PyTorch version (ref.py) run on the CPU, and
// deterministic.  A block holds up to 256 (feature, slot) threads of one
// tree: C = min(nodes * B, 256) slots times F = 256 / C features, so the
// grid is (slot chunks, feature blocks, trees); a slot range wider than
// 256 is split into several chunks.  The block stages 128 rows at a time in
// shared memory -- the ids of its F features and the rows' 2K + 1 stats,
// formed once per row from assign, w, g and h (in child mode: weight 0 for
// odd assign, parent id assign >> 1) -- and every thread keeps its 2K + 1
// running sums in shared memory too, so K is a run-time value.  Shared
// memory per block stays under 48 KB.  Ids outside [0, nodes * B) match no
// slot and are dropped, as segment_sum and the one-hot drop them.  Products
// and sums use __fmul_rn/__fadd_rn, so nvcc cannot contract them into an FMA
// that the plain version does not take.
//
// Bound: the inputs read once (binned n*d*4 B, assign and w T*n*4 B each,
// g and h n*K*4 B each) and the output written once; the work is
// n * d * T * (2K + 1) adds.  This simple form is far from either bound:
// each thread's scan is sequential over all n rows, so a launch takes
// O(n) dependent steps however many SMs there are.  Splitting the rows into
// tiles with a deterministic, ordered second pass is the next step.

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRowsPerTile = 128;
constexpr size_t kSmemBytes = 48 * 1024;  // no opt-in attribute needed

// ids and stats of one tile of rows into shared memory.  kStaged reads
// them as given; otherwise they are formed from binned, assign, g, h, w.
template <bool kStaged>
__device__ void stage_tile(const int* __restrict__ binned,
                           const int* __restrict__ assign,
                           const float* __restrict__ g,
                           const float* __restrict__ h,
                           const float* __restrict__ w,
                           const float* __restrict__ data, int* s_id,
                           int* s_node, float* s_stat, long long row0,
                           int rows, int n, int d, int f0, int feats,
                           int n_stats, int num_bins, int child) {
  const int n_chan = (n_stats - 1) / 2;
  const long long tree_row0 = static_cast<long long>(blockIdx.z) * n;
  if (kStaged) {
    for (int i = threadIdx.x; i < rows * n_stats; i += blockDim.x) {
      const int r = i / n_stats;
      s_stat[i] = data[(row0 + r) * n_stats + (i - r * n_stats)];
    }
  } else {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const long long row = row0 + r;
      const int a = assign[tree_row0 + row];
      float wv = w[tree_row0 + row];
      int node = a;
      if (child) {
        wv = __fmul_rn(wv, (a & 1) ? 0.0f : 1.0f);  // right child: weight 0
        node = a >> 1;                              // floor(a / 2): parent
      }
      s_node[r] = node;
      float* st = s_stat + r * n_stats;
      for (int k = 0; k < n_chan; ++k) {
        st[k] = __fmul_rn(g[row * n_chan + k], wv);
        st[n_chan + k] = __fmul_rn(h[row * n_chan + k], wv);
      }
      st[n_stats - 1] = wv;
    }
    __syncthreads();  // s_node is read below
  }
  for (int i = threadIdx.x; i < rows * feats; i += blockDim.x) {
    const int r = i / feats;
    const int fi = i - r * feats;
    const int f = f0 + fi;
    int id = -1;
    if (f < d) {
      const int v = binned[(row0 + r) * d + f];
      // int32 wrap, as jnp's int32 arithmetic wraps
      id = kStaged ? v
                   : static_cast<int>(static_cast<unsigned>(s_node[r]) *
                                          static_cast<unsigned>(num_bins) +
                                      static_cast<unsigned>(v));
    }
    s_id[i] = id;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
histogram_kernel(const int* __restrict__ binned, const int* __restrict__ assign,
                 const float* __restrict__ g, const float* __restrict__ h,
                 const float* __restrict__ w, const float* __restrict__ data,
                 float* __restrict__ out, int n, int d, int n_stats,
                 int n_nodes, int num_bins, int child, int chunk, int feats) {
  extern __shared__ float smem[];
  const int n_slots = n_nodes * num_bins;
  const int threads = blockDim.x;
  float* s_acc = smem;                                  // n_stats * threads
  float* s_stat = s_acc + n_stats * threads;            // rows * n_stats
  int* s_id = reinterpret_cast<int*>(s_stat + kRowsPerTile * n_stats);
  int* s_node = s_id + kRowsPerTile * feats;            // rows

  const int fi = threadIdx.x / chunk;
  const int f0 = blockIdx.y * feats;
  const int f = f0 + fi;
  const int slot = blockIdx.x * chunk + (threadIdx.x - fi * chunk);
  const bool owner = fi < feats && f < d && slot < n_slots;
  for (int k = 0; k < n_stats; ++k) s_acc[k * threads + threadIdx.x] = 0.0f;

  for (long long row0 = 0; row0 < n; row0 += kRowsPerTile) {
    const int rows = static_cast<int>(
        n - row0 < kRowsPerTile ? n - row0 : kRowsPerTile);
    __syncthreads();  // the previous tile is no longer read
    stage_tile<kStaged>(binned, assign, g, h, w, data, s_id, s_node, s_stat,
                        row0, rows, n, d, f0, feats, n_stats, num_bins, child);
    __syncthreads();
    if (owner) {
      for (int r = 0; r < rows; ++r) {
        if (s_id[r * feats + fi] == slot) {
          const float* st = s_stat + r * n_stats;
          for (int k = 0; k < n_stats; ++k) {
            float* acc = s_acc + k * threads + threadIdx.x;
            *acc = __fadd_rn(*acc, st[k]);
          }
        }
      }
    }
  }
  if (owner) {
    // out[t, node, f, bin, k]: the port's (T, nodes, d, B, 2K+1) layout
    const int node = slot / num_bins;
    const int bin = slot - node * num_bins;
    const size_t base =
        ((static_cast<size_t>(blockIdx.z) * n_nodes + node) * d + f) *
            num_bins + bin;
    for (int k = 0; k < n_stats; ++k) {
      out[base * n_stats + k] = s_acc[k * threads + threadIdx.x];
    }
  }
}

size_t smem_bytes(int threads, int feats, int n_stats) {
  return sizeof(float) * (static_cast<size_t>(n_stats) * threads +
                          static_cast<size_t>(kRowsPerTile) * n_stats) +
         sizeof(int) * static_cast<size_t>(kRowsPerTile) * (feats + 1);
}

template <bool kStaged>
int launch(const int* binned, const int* assign, const float* g,
           const float* h, const float* w, const float* data, float* out,
           int n, int d, int n_trees, int n_stats, int n_nodes, int num_bins,
           int child, void* stream) {
  if (n < 0 || d <= 0 || n_trees <= 0 || n_stats <= 0 || n_nodes <= 0 ||
      num_bins <= 0 || (!kStaged && n_stats % 2 == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_slots = static_cast<long long>(n_nodes) * num_bins;
  if (n_slots > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // C slots times F features per block; fewer slots when the accumulators
  // of wide stats would pass the shared-memory budget.
  int chunk = n_slots < kMaxThreads ? static_cast<int>(n_slots) : kMaxThreads;
  int feats = kMaxThreads / chunk < d ? kMaxThreads / chunk : d;
  while (smem_bytes(chunk * feats, feats, n_stats) > kSmemBytes) {
    if (feats > 1) {
      feats /= 2;
    } else if (chunk > 32) {
      chunk /= 2;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);  // stats too wide
    }
  }
  const int threads = chunk * feats;
  const dim3 grid(static_cast<unsigned>((n_slots + chunk - 1) / chunk),
                  static_cast<unsigned>((d + feats - 1) / feats),
                  static_cast<unsigned>(n_trees));
  if (grid.y > 65535 || grid.z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  histogram_kernel<kStaged>
      <<<grid, threads, smem_bytes(threads, feats, n_stats),
         static_cast<cudaStream_t>(stream)>>>(binned, assign, g, h, w, data,
                                              out, n, d, n_stats, n_nodes,
                                              num_bins, child, chunk, feats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers of contiguous
// tensors; stream is a cudaStream_t.  Returns the cudaError_t of the launch.
//
// histogram_round: binned (n, d) i32, assign and w (T, n) i32/f32, g and h
// (n, K) f32 -> out (T, n_nodes, d, B, 2K+1) f32.  With child != 0, assign
// is the current level's assignment and n_nodes the parent count.
extern "C" int histogram_round(const int* binned, const int* assign,
                               const float* g, const float* h, const float* w,
                               float* out, int n, int d, int n_trees, int k,
                               int n_nodes, int num_bins, int child,
                               void* stream) {
  return launch<false>(binned, assign, g, h, w, nullptr, out, n, d, n_trees,
                       2 * k + 1, n_nodes, num_bins, child, stream);
}

// histogram_staged: ids (n, d) i32 = assign * B + binned, data (n, S) f32
// -> out (n_nodes, d, B, S) f32.
extern "C" int histogram_staged(const int* ids, const float* data, float* out,
                                int n, int d, int n_stats, int n_nodes,
                                int num_bins, void* stream) {
  return launch<true>(ids, nullptr, nullptr, nullptr, nullptr, data, out, n, d,
                      1, n_stats, n_nodes, num_bins, 0, stream);
}
