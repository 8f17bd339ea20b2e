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
// because the TPU has no scatter.
//
// What the sums must be.  Each histogram cell is the sequential sum, in row
// order, of its rows' 2K + 1 stats: the order of the CPU's index_add_ and
// of XLA's segment_sum on the CPU, which the JAX reference trains with.
// Near-ties in split gains decide trees, so equal trees need equal bits.
// That rules out a float atomicAdd (scheduling order), a tiled reduction
// with a second pass (tile order), and the one-hot product on the tensor
// cores (TF32, or sums in tile order): nothing here is atomic on floats and
// no tensor-core instruction is used.
//
// Bound: the inputs read once (binned n*d*4 B, assign and w T*n*4 B each,
// g and h n*K*4 B each) and the output written once; T*n*d*(2K+1) adds.
// Both are tiny next to the card's rates (0.9 us at the training shape);
// what a launch costs is its longest serial chain and its launch overhead.
//
// Design: a stable counting sort of each (tree, feature)'s rows by slot
// (node * B + bin), then an ordered walk of each slot's own rows.
//   1. slot_count   grid (tiles, feature groups of 8, T): a block stages a
//                   tile's keys for its 8 features (row by row, so reads
//                   of neighbouring features share sectors) and the rows'
//                   nodes (child mode: parent assign >> 1; int32 wrap);
//                   each warp counts its feature's ids per slot with
//                   integer atomics on counters it owns (exact in any
//                   order; shared memory up to 1024 slots, else its row
//                   of `counts`).  Ids outside [0, nodes * B) get no
//                   slot: dropped per tree.  The first feature group also
//                   packs each (tree, row)'s stats [g*w, h*w, w] (or the
//                   staged data row) into float4s for the walk.
//   2. slot_scan    one block per (tree, feature): exclusive scan of the
//                   (slot, tile) counts in slot-major order, rewriting
//                   `counts` into each tile's first position in each
//                   slot's segment and writing `starts` (nslots + 1).
//   3. slot_scatter the same blocks again; 32 rows at a time in row order,
//                   a row's rank is __popc of its lower peers
//                   (__match_any_sync on the id) and the warp's cursor per
//                   slot carries the count on, so order[t, f, starts[slot]
//                   + rank] = row lists every slot's rows in increasing
//                   row order (stable).  Each stage of 256 rows is sorted
//                   locally first and stored slot run by slot run.
//   4. walk         one warp per (tree, feature, slot): the lanes load the
//                   next 256 entries of the slot's segment (coalesced) and
//                   gather those rows' packed stats into registers while
//                   lanes 0..2K add the chunk before from shared memory,
//                   stat-major, four entries a load, with __fadd_rn in
//                   segment order (2K + 1 independent chains); then they
//                   stage the gathered chunk.  The warp writes its cell
//                   once; empty slots write 0.
// The work drops from T*d*nodes*B*n compares (one thread per slot scanning
// every row) to T*d*n, and the serial chain from n rows to each slot's own
// row count.  The gathers are random rows of inputs that stay in the 50 MB
// L2, so no TMA.  Rows of weight 0 are added like any other (g * 0 is NaN
// for a non-finite g).  Products and sums use __fmul_rn / __fadd_rn, so
// nvcc cannot contract them into an FMA that the plain version does not
// take.  Scratch (counts, order, starts, packed stats) is allocated by the
// caller.

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageRows = 256;                // rows staged at a time
constexpr int kKeyStride = kWarpsPerBlock + 1;  // padded staged row
constexpr long long kCountsPerTf = 1LL << 20;  // tiles * slots per (t, f)
constexpr int kSmemSlots = 1024;               // shared-memory counters
constexpr int kMaxStats = 32;                  // one accumulator per lane
constexpr size_t kSmemBytes = 48 * 1024;       // no opt-in attribute needed

struct Geometry {
  int tile_rows;
  int n_tiles;
};

// Tiles of 256 rows, doubled until the count matrix of one (t, f) stays
// within kCountsPerTf entries.
Geometry geometry(int n, long long n_slots) {
  long long tile = kStageRows;
  auto tiles = [&](long long rows) {
    return n == 0 ? 1 : (n + rows - 1) / rows;
  };
  while (tiles(tile) * n_slots > kCountsPerTf && tile < n) tile *= 2;
  return {static_cast<int>(tile), static_cast<int>(tiles(tile))};
}

// One stage of a block's tile: kStageRows rows of its kWarpsPerBlock
// features of `keys`, read row by row (the features of a row are
// neighbours), and in round mode the rows' nodes of tree t (child mode:
// the parent assign >> 1).  Padded to kKeyStride words a row so that the
// warps' column reads hit 32 different banks.
template <bool kStaged>
__device__ __forceinline__ void stage_keys(const int* __restrict__ keys,
                                           const int* __restrict__ assign,
                                           int* s_keys, int* s_node,
                                           long long row0, int n, int d,
                                           int f0, int t, int child) {
  for (int e = threadIdx.x; e < kStageRows * kWarpsPerBlock; e += kThreads) {
    const int r = e / kWarpsPerBlock;
    const int fi = e - r * kWarpsPerBlock;
    const long long row = row0 + r;
    s_keys[r * kKeyStride + fi] =
        row < n && f0 + fi < d ? keys[row * d + f0 + fi] : 0;
  }
  if (!kStaged) {
    for (int r = threadIdx.x; r < kStageRows; r += kThreads) {
      const long long row = row0 + r;
      const int a = row < n ? assign[static_cast<long long>(t) * n + row] : 0;
      s_node[r] = child ? (a >> 1) : a;  // floor(a / 2): the parent
    }
  }
}

// The slot of staged row r for this warp's feature column fi, or -1 when
// the row is past n or its id falls outside [0, n_slots): dropped.
template <bool kStaged>
__device__ __forceinline__ int staged_slot(const int* s_keys,
                                           const int* s_node, int r, int fi,
                                           bool in_rows, int num_bins,
                                           int n_slots) {
  const int v = s_keys[r * kKeyStride + fi];
  // int32 wrap, as jnp's and torch's int32 arithmetic wraps
  const int id =
      kStaged ? v
              : static_cast<int>(static_cast<unsigned>(s_node[r]) *
                                     static_cast<unsigned>(num_bins) +
                                 static_cast<unsigned>(v));
  return in_rows && static_cast<unsigned>(id) < static_cast<unsigned>(n_slots)
             ? id
             : -1;
}

// The stats of one (tree, row) as the walk adds them, packed into
// `stride` floats (2K + 1 or S used, the rest padding): round mode forms
// [g*w, h*w, w] from g, h, w and, in child mode, weight 0 for odd assign;
// staged mode copies its data row.
template <bool kStaged>
__device__ __forceinline__ void pack_row(const int* __restrict__ assign,
                                         const float* __restrict__ g,
                                         const float* __restrict__ h,
                                         const float* __restrict__ w,
                                         const float* __restrict__ data,
                                         float* __restrict__ packed,
                                         long long row, int n, int t,
                                         int n_stats, int stride, int child) {
  float* out = packed + (static_cast<long long>(t) * n + row) * stride;
  if (kStaged) {
    for (int k = 0; k < n_stats; ++k) out[k] = data[row * n_stats + k];
    return;
  }
  const int k_chan = (n_stats - 1) / 2;
  const long long tr = static_cast<long long>(t) * n + row;
  float wv = w[tr];
  if (child) {
    wv = __fmul_rn(wv, (assign[tr] & 1) ? 0.0f : 1.0f);  // right child: 0
  }
  for (int k = 0; k < k_chan; ++k) {
    out[k] = __fmul_rn(g[row * k_chan + k], wv);
    out[k_chan + k] = __fmul_rn(h[row * k_chan + k], wv);
  }
  out[2 * k_chan] = wv;
}

// Step 1: per-tile slot counts, counts[t, f, tile, slot].  Block: one
// tile of one tree, kWarpsPerBlock features, a warp each.  Integer counts
// are exact in any order, so the warp adds with shared- (or, past
// kSmemSlots slots, device-) memory atomics on counters it owns.  The
// blocks of the first feature group also pack their rows' stats for the
// walk (when `packed` is given).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
slot_count_kernel(const int* __restrict__ keys, const int* __restrict__ assign,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const float* __restrict__ w, const float* __restrict__ data,
                  float* __restrict__ packed, int* __restrict__ counts, int n,
                  int d, int num_bins, int n_slots, int child, int n_stats,
                  int stride, int tile_rows, int n_tiles, int smem_counters) {
  __shared__ int s_keys[kStageRows * kKeyStride];
  __shared__ int s_node[kStageRows];
  extern __shared__ int s_cnt[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int tile = blockIdx.x;
  const int f0 = blockIdx.y * kWarpsPerBlock;
  const int f = f0 + warp;
  const int t = blockIdx.z;
  const bool owner = f < d;
  int* row_cnt = counts +
                 ((static_cast<long long>(t) * d + (owner ? f : 0)) * n_tiles +
                  tile) * n_slots;
  int* cnt = smem_counters ? s_cnt + warp * n_slots : row_cnt;
  if (owner) {
    for (int s = lane; s < n_slots; s += kWarp) cnt[s] = 0;
  }
  const long long tile0 = static_cast<long long>(tile) * tile_rows;
  if (packed != nullptr && blockIdx.y == 0) {
    for (int r = threadIdx.x; r < tile_rows && tile0 + r < n; r += kThreads) {
      pack_row<kStaged>(assign, g, h, w, data, packed, tile0 + r, n, t,
                        n_stats, stride, child);
    }
  }
  for (int r0 = 0; r0 < tile_rows; r0 += kStageRows) {
    __syncthreads();  // the previous stage is no longer read
    stage_keys<kStaged>(keys, assign, s_keys, s_node, tile0 + r0, n, d, f0,
                        t, child);
    __syncthreads();
    if (owner) {
      for (int r = lane; r < kStageRows; r += kWarp) {
        const int id = staged_slot<kStaged>(s_keys, s_node, r, warp,
                                            tile0 + r0 + r < n, num_bins,
                                            n_slots);
        if (id >= 0) atomicAdd(cnt + id, 1);
      }
    }
  }
  __syncwarp();
  if (owner && smem_counters) {
    for (int s = lane; s < n_slots; s += kWarp) row_cnt[s] = cnt[s];
  }
}

// Exclusive prefix of v over the block in thread order; *total gets the
// block's sum.  Every thread of the block calls it.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  int x = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarpsPerBlock ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarpsPerBlock) s_warp[lane] = s;  // inclusive, per warp
  }
  __syncthreads();
  *total = s_warp[kWarpsPerBlock - 1];
  const int before = warp > 0 ? s_warp[warp - 1] : 0;
  __syncthreads();  // s_warp is rewritten by the next call
  return before + x - v;
}

// Step 2: counts -> each tile's first position in each slot's segment;
// starts[t, f, 0..n_slots]; order's tail past the kept rows set to -1.
// Threads cover `width` slots at a time, split over `groups` ranges of
// tiles when there are fewer slots than threads.
__global__ void __launch_bounds__(kThreads)
slot_scan_kernel(int* __restrict__ counts, int* __restrict__ starts,
                 int* __restrict__ order, int n, int n_slots, int n_tiles) {
  __shared__ int s_part[kThreads];
  __shared__ int s_start[kThreads];
  __shared__ int s_warp[kWarpsPerBlock];
  const long long tf = blockIdx.x;
  int* c = counts + tf * n_tiles * n_slots;  // [tile][slot]
  int* st = starts + tf * (n_slots + 1);
  const int width = n_slots < kThreads ? n_slots : kThreads;
  const int groups = kThreads / width;
  const int per_group = (n_tiles + groups - 1) / groups;
  const int sl = threadIdx.x % width;
  const int grp = threadIdx.x / width;
  const int tile0 = grp * per_group;
  const int tile1 = min(tile0 + per_group, n_tiles);
  int carry = 0;
  for (int slot0 = 0; slot0 < n_slots; slot0 += width) {
    const int slot = slot0 + sl;
    const bool on = grp < groups && slot < n_slots;
    int part = 0;
    if (on) {
#pragma unroll 4
      for (int tile = tile0; tile < tile1; ++tile) {
        part += c[static_cast<long long>(tile) * n_slots + slot];
      }
    }
    s_part[threadIdx.x] = part;
    __syncthreads();
    int slot_total = 0;
    if (threadIdx.x < width) {  // exclusive prefix over the tile groups
      for (int gi = 0; gi < groups; ++gi) {
        const int v = s_part[gi * width + threadIdx.x];
        s_part[gi * width + threadIdx.x] = slot_total;
        slot_total += v;
      }
    }
    int chunk_total;
    const int excl = block_exclusive_scan(slot_total, s_warp, &chunk_total);
    if (threadIdx.x < width && slot0 + threadIdx.x < n_slots) {
      s_start[threadIdx.x] = carry + excl;
      st[slot0 + threadIdx.x] = carry + excl;
    }
    __syncthreads();
    if (on) {
      int run = s_start[sl] + s_part[threadIdx.x];
      for (int tile = tile0; tile < tile1; ++tile) {
        const long long i = static_cast<long long>(tile) * n_slots + slot;
        const int v = c[i];
        c[i] = run;
        run += v;
      }
    }
    carry += chunk_total;
    __syncthreads();  // s_part and s_start are rewritten next chunk
  }
  if (threadIdx.x == 0) st[n_slots] = carry;
  for (int i = carry + threadIdx.x; i < n; i += kThreads) {
    order[tf * n + i] = -1;
  }
}

// Step 3: order[t, f, position] = row, stable within each slot.  The same
// blocks as step 1; each warp walks its column 32 rows at a time in row
// order: a row's rank among the 32 is __popc of its lower peers (lanes of
// the same slot), and the warp's cursor per slot carries the count on.
// With the counters in shared memory the warp first sorts each stage of
// 256 rows by slot locally (the stage's counts, scanned) and then writes
// it out slot run by slot run, so neighbouring lanes store to neighbouring
// places; past kSmemSlots slots each row is stored where it is ranked.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
slot_scatter_kernel(const int* __restrict__ keys,
                    const int* __restrict__ assign, int* __restrict__ counts,
                    int* __restrict__ order, int n, int d, int num_bins,
                    int n_slots, int child, int tile_rows, int n_tiles,
                    int smem_counters) {
  __shared__ int s_keys[kStageRows * kKeyStride];
  __shared__ int s_node[kStageRows];
  extern __shared__ int s_dyn[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int tile = blockIdx.x;
  const int f0 = blockIdx.y * kWarpsPerBlock;
  const int f = f0 + warp;
  const int t = blockIdx.z;
  const bool owner = f < d;
  const long long tf = static_cast<long long>(t) * d + (owner ? f : 0);
  int* row_off = counts + (tf * n_tiles + tile) * n_slots;
  // per warp: cursor[slot] | local cursor[slot] | rows | places, a stage
  int* cur = row_off;
  int* loc = nullptr;
  int* s_row = nullptr;
  int* s_pos = nullptr;
  if (smem_counters) {
    cur = s_dyn + warp * (2 * n_slots + 2 * kStageRows);
    loc = cur + n_slots;
    s_row = loc + n_slots;
    s_pos = s_row + kStageRows;
    if (owner) {
      for (int s = lane; s < n_slots; s += kWarp) cur[s] = row_off[s];
    }
  }
  int* out = order + tf * n;
  const unsigned lower = (1u << lane) - 1u;
  const long long tile0 = static_cast<long long>(tile) * tile_rows;
  for (int r0 = 0; r0 < tile_rows; r0 += kStageRows) {
    __syncthreads();
    stage_keys<kStaged>(keys, assign, s_keys, s_node, tile0 + r0, n, d, f0,
                        t, child);
    __syncthreads();
    if (!owner) continue;
    int kept = 0;
    if (smem_counters) {  // loc[slot]: the slot's first local place
      for (int s = lane; s < n_slots; s += kWarp) loc[s] = 0;
      __syncwarp();
      for (int r = lane; r < kStageRows; r += kWarp) {
        const int id = staged_slot<kStaged>(s_keys, s_node, r, warp,
                                            tile0 + r0 + r < n, num_bins,
                                            n_slots);
        if (id >= 0) atomicAdd(loc + id, 1);
      }
      __syncwarp();
      for (int s0 = 0; s0 < n_slots; s0 += kWarp) {
        const int v = s0 + lane < n_slots ? loc[s0 + lane] : 0;
        int x = v;
#pragma unroll
        for (int o = 1; o < kWarp; o <<= 1) {
          const int y = __shfl_up_sync(kFull, x, o);
          if (lane >= o) x += y;
        }
        if (s0 + lane < n_slots) loc[s0 + lane] = kept + x - v;
        kept += __shfl_sync(kFull, x, kWarp - 1);
      }
      __syncwarp();
    }
    for (int r = lane; r < kStageRows; r += kWarp) {
      const long long row = tile0 + r0 + r;
      const int id = staged_slot<kStaged>(s_keys, s_node, r, warp, row < n,
                                          num_bins, n_slots);
      const unsigned peers = __match_any_sync(kFull, id);
      const int rank = __popc(peers & lower);
      const int base = id >= 0 ? cur[id] : 0;
      const int local = id >= 0 && smem_counters ? loc[id] : 0;
      __syncwarp();  // every peer has read the cursors
      if (id >= 0) {
        const bool leader = lane == __ffs(peers) - 1;
        if (leader) cur[id] = base + __popc(peers);
        if (smem_counters) {
          if (leader) loc[id] = local + __popc(peers);
          s_row[local + rank] = static_cast<int>(row);
          s_pos[local + rank] = base + rank;
        } else {
          out[base + rank] = static_cast<int>(row);
        }
      }
      __syncwarp();
    }
    for (int i = lane; i < kept; i += kWarp) out[s_pos[i]] = s_row[i];
  }
}

// Step 4: one warp per (t, f, slot) walks the slot's segment in order.
// A row's stats are kQ float4s of `packed` (q_count of them used); kU:
// 32-entry groups per chunk.  The lanes gather chunk i + 1 into registers
// while the lanes below S add chunk i from shared memory, laid out
// stat-major ([k][entry]) so that lane k reads its stat four entries at a
// time; then they stage chunk i + 1 there.  Lane k adds stat k of every
// entry in order.
template <int kQ, int kU>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const int* __restrict__ order, const int* __restrict__ starts,
            const float4* __restrict__ packed, float* __restrict__ out, int n,
            int d, int n_stats, int q_count, int n_nodes, int num_bins,
            long long n_warps) {
  constexpr int kChunk = kWarp * kU;
  extern __shared__ float s_buf[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long gw = static_cast<long long>(blockIdx.x) * warps + warp;
  if (gw >= n_warps) return;
  const int n_slots = n_nodes * num_bins;
  const long long tf = gw / n_slots;
  const int slot = static_cast<int>(gw - tf * n_slots);
  const int t = static_cast<int>(tf / d);
  const int f = static_cast<int>(tf - static_cast<long long>(t) * d);
  const int* seg = order + tf * n;
  const int start = starts[tf * (n_slots + 1) + slot];
  const int end = starts[tf * (n_slots + 1) + slot + 1];
  const float4* tree_rows = packed + static_cast<long long>(t) * n * q_count;
  // two chunk buffers, each stat-major
  float* buf = s_buf + static_cast<size_t>(warp) * 2 * kChunk * n_stats;

  int rows[kU];
  float4 v[kU][kQ];
  auto load_rows = [&](int pos) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = pos + u * kWarp + lane;
      rows[u] = p < end ? seg[p] : -1;
    }
  };
  // loads only: the values are first used in stage(), after the adds of
  // the chunk before
  auto gather = [&]() {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (rows[u] < 0) continue;
      const float4* src =
          tree_rows + static_cast<long long>(rows[u]) * q_count;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (q < q_count) v[u][q] = src[q];
      }
    }
  };
  auto stage = [&](float* b) {  // entry u * 32 + lane, stat-major
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (rows[u] < 0) continue;
      float* e = b + u * kWarp + lane;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float c[4] = {v[u][q].x, v[u][q].y, v[u][q].z, v[u][q].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * q + j < n_stats) e[(4 * q + j) * kChunk] = c[j];
        }
      }
    }
  };

  // prologue: chunk 0 staged, chunk 1's rows loaded
  load_rows(start);
  gather();
  stage(buf);
  load_rows(start + kChunk);
  __syncwarp();
  float acc = 0.0f;
  int cur = 0;
  for (int c = start; c < end; c += kChunk) {
    gather();  // chunk c + 1, in flight while chunk c is added
    int later[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = c + 2 * kChunk + u * kWarp + lane;
      later[u] = p < end ? seg[p] : -1;
    }
    const float* b = buf + (cur * n_stats + lane) * kChunk;
    const int cnt = min(kChunk, end - c);
    if (lane < n_stats) {
      if (cnt == kChunk) {
#pragma unroll
        for (int e = 0; e < kChunk; e += 4) {
          const float4 q = *reinterpret_cast<const float4*>(b + e);
          acc = __fadd_rn(acc, q.x);
          acc = __fadd_rn(acc, q.y);
          acc = __fadd_rn(acc, q.z);
          acc = __fadd_rn(acc, q.w);
        }
      } else {
        for (int e = 0; e < cnt; ++e) acc = __fadd_rn(acc, b[e]);
      }
    }
    stage(buf + (cur ^ 1) * kChunk * n_stats);
#pragma unroll
    for (int u = 0; u < kU; ++u) rows[u] = later[u];
    cur ^= 1;
    __syncwarp();
  }
  if (lane < n_stats) {
    // out[t, node, f, bin, k]: the port's (T, nodes, d, B, 2K+1) layout
    const int node = slot / num_bins;
    const int bin = slot - node * num_bins;
    const size_t cell =
        ((static_cast<size_t>(t) * n_nodes + node) * d + f) * num_bins + bin;
    out[cell * n_stats + lane] = acc;
  }
}

bool valid_shape(int n, int d, int n_trees, int n_nodes, int num_bins) {
  return n >= 0 && d > 0 && d <= 65535 && n_trees > 0 && n_trees <= 65535 &&
         n_nodes > 0 && num_bins > 0 &&
         static_cast<long long>(n_nodes) * num_bins <= (1LL << 30);
}

// What the walk adds for each (tree, row), packed by step 1 into `packed`
// (T, n, stats_stride) when it is given: round mode from g, h, w (and
// assign in child mode), staged mode from data.
struct Stats {
  const float* g;
  const float* h;
  const float* w;
  const float* data;
  float* packed;
  int n_stats;
};

int stats_stride(int n_stats) { return (n_stats + 3) / 4 * 4; }

template <bool kStaged>
int sort_slots(const int* keys, const int* assign, int* counts, int* order,
               int* starts, int n, int d, int n_trees, int n_nodes,
               int num_bins, int child, const Stats& st,
               cudaStream_t stream) {
  if (!valid_shape(n, d, n_trees, n_nodes, num_bins)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_slots = n_nodes * num_bins;
  const Geometry geo = geometry(n, n_slots);
  const int smem_counters = n_slots <= kSmemSlots;
  const size_t count_smem =
      smem_counters ? sizeof(int) * kWarpsPerBlock * n_slots : 0;
  const size_t scatter_smem =
      smem_counters
          ? sizeof(int) * kWarpsPerBlock * (2 * n_slots + 2 * kStageRows)
          : 0;
  cudaError_t err = cudaSuccess;
  if (scatter_smem > kSmemBytes / 2) {  // beside 10 KB of static staging
    err = cudaFuncSetAttribute(slot_scatter_kernel<kStaged>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(scatter_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(geo.n_tiles, (d + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  n_trees);
  slot_count_kernel<kStaged><<<grid, kThreads, count_smem, stream>>>(
      keys, assign, st.g, st.h, st.w, st.data, st.packed, counts, n, d,
      num_bins, n_slots, child, st.n_stats, stats_stride(st.n_stats),
      geo.tile_rows, geo.n_tiles, smem_counters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  slot_scan_kernel<<<n_trees * d, kThreads, 0, stream>>>(
      counts, starts, order, n, n_slots, geo.n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  slot_scatter_kernel<kStaged><<<grid, kThreads, scatter_smem, stream>>>(
      keys, assign, counts, order, n, d, num_bins, n_slots, child,
      geo.tile_rows, geo.n_tiles, smem_counters);
  return static_cast<int>(cudaGetLastError());
}

template <int kQ, int kU>
int launch_walk(const int* order, const int* starts, const float* packed,
                float* out, int n, int d, int n_trees, int n_stats,
                int n_nodes, int num_bins, cudaStream_t stream) {
  const size_t per_warp = sizeof(float) * 2 * kWarp * kU * n_stats;
  int warps = static_cast<int>(kSmemBytes / per_warp);
  if (warps > kWarpsPerBlock) warps = kWarpsPerBlock;
  const long long n_warps =
      static_cast<long long>(n_trees) * d * n_nodes * num_bins;
  const long long blocks = (n_warps + warps - 1) / warps;
  if (warps < 1 || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  walk_kernel<kQ, kU>
      <<<static_cast<unsigned>(blocks), warps * kWarp, warps * per_warp,
         stream>>>(order, starts, reinterpret_cast<const float4*>(packed),
                   out, n, d, n_stats, stats_stride(n_stats) / 4, n_nodes,
                   num_bins, n_warps);
  return static_cast<int>(cudaGetLastError());
}

// Steps 1-4 for S stats: rows of up to 4 stats (K = 1) are one float4,
// walked 256 entries a chunk; wider ones, up to 8 float4s, 32.
template <bool kStaged>
int histogram(const int* keys, const int* assign, const Stats& st, float* out,
              int n, int d, int n_trees, int n_nodes, int num_bins, int child,
              int* counts, int* order, int* starts, cudaStream_t stream) {
  const int err = sort_slots<kStaged>(keys, assign, counts, order, starts, n,
                                      d, n_trees, n_nodes, num_bins, child,
                                      st, stream);
  if (err != 0) return err;
  if (st.n_stats <= 4) {
    return launch_walk<1, 8>(order, starts, st.packed, out, n, d, n_trees,
                             st.n_stats, n_nodes, num_bins, stream);
  }
  return launch_walk<kMaxStats / 4, 1>(order, starts, st.packed, out, n, d,
                                       n_trees, st.n_stats, n_nodes,
                                       num_bins, stream);
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers of contiguous
// tensors; stream is a cudaStream_t.  Each function returns the
// cudaError_t of its launches (0 when all were accepted).  The caller
// allocates the scratch: counts (histogram_scratch_ints int32), order
// (T, d, n) int32, starts (T, d, nodes * B + 1) int32 and, for the two
// histogram entry points, packed (histogram_packed_floats float32).

// float32 entries of `packed` for one launch at this shape.
extern "C" long long histogram_packed_floats(int n, int n_trees,
                                             int n_stats) {
  return static_cast<long long>(n_trees) * n * stats_stride(n_stats);
}

// int32 entries of `counts` for one launch at this shape.
extern "C" long long histogram_scratch_ints(int n, int d, int n_trees,
                                            int n_nodes, int num_bins) {
  if (!valid_shape(n, d, n_trees, n_nodes, num_bins)) return -1;
  const long long n_slots = static_cast<long long>(n_nodes) * num_bins;
  return static_cast<long long>(n_trees) * d * geometry(n, n_slots).n_tiles *
         n_slots;
}

// Steps 1-3 alone: keys (n, d) i32 -- binned with assign (T, n) i32, or
// staged ids when staged != 0 (T = 1, assign unused) -> order (T, d, n):
// each slot's rows in row order, segment [starts[s], starts[s + 1]), the
// tail past starts[nodes * B] set to -1.
extern "C" int histogram_sort(const int* keys, const int* assign,
                              int* counts, int* order, int* starts, int n,
                              int d, int n_trees, int n_nodes, int num_bins,
                              int child, int staged, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Stats none{nullptr, nullptr, nullptr, nullptr, nullptr, 1};
  if (staged) {
    return n_trees == 1
               ? sort_slots<true>(keys, nullptr, counts, order, starts, n, d,
                                  1, n_nodes, num_bins, 0, none, s)
               : static_cast<int>(cudaErrorInvalidValue);
  }
  return sort_slots<false>(keys, assign, counts, order, starts, n, d,
                           n_trees, n_nodes, num_bins, child, none, s);
}

// histogram_round: binned (n, d) i32, assign and w (T, n) i32/f32, g and h
// (n, K) f32, K <= 15 -> out (T, n_nodes, d, B, 2K+1) f32.  With child !=
// 0, assign is the current level's assignment and n_nodes the parent
// count.
extern "C" int histogram_round(const int* binned, const int* assign,
                               const float* g, const float* h, const float* w,
                               float* out, int n, int d, int n_trees, int k,
                               int n_nodes, int num_bins, int child,
                               int* counts, int* order, int* starts,
                               float* packed, void* stream) {
  if (k < 1 || 2 * k + 1 > kMaxStats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Stats st{g, h, w, nullptr, packed, 2 * k + 1};
  return histogram<false>(binned, assign, st, out, n, d, n_trees, n_nodes,
                          num_bins, child, counts, order, starts,
                          static_cast<cudaStream_t>(stream));
}

// histogram_staged: ids (n, d) i32 = assign * B + binned, data (n, S) f32,
// S <= 32 -> out (n_nodes, d, B, S) f32.
extern "C" int histogram_staged(const int* ids, const float* data, float* out,
                                int n, int d, int n_stats, int n_nodes,
                                int num_bins, int* counts, int* order,
                                int* starts, float* packed, void* stream) {
  if (n_stats < 1 || n_stats > kMaxStats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Stats st{nullptr, nullptr, nullptr, data, packed, n_stats};
  return histogram<true>(ids, nullptr, st, out, n, d, 1, n_nodes, num_bins, 0,
                         counts, order, starts,
                         static_cast<cudaStream_t>(stream));
}
