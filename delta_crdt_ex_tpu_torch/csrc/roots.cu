// Digest-tree roots over a batch of leaf arrays, for Hopper (sm_90a).
// Built by delta_crdt_ex_tpu_torch/utils/kernels.py into a shared library
// with a plain C interface; bound with ctypes by
// delta_crdt_ex_tpu_torch/ops/roots.py (BatchedRootsKernel).
//
// Replaces the Pallas TPU kernel _roots_kernel / batched_roots_pallas
// (delta_crdt_ex_tpu/ops/pallas_tree.py:47, pallas_call at 87). Same
// function: out[n] = tree_from_leaves(leaf[n])[0], the root of log2(L)
// pairwise folds combine(l, r) = mix32(l ^ P1) + (mix32(r ^ P2) << 1)
// + 0x9E3779B9 in wrapping uint32, node i of a level folding nodes 2i
// (left) and 2i + 1 (right) of the level below.
//
// Design. An aligned power-of-two run of leaves is a whole subtree, so
// the fold splits into runs without changing its order:
//   1. A thread-block cluster of C blocks (C a power of two <= 8, picked
//      by the caller so that N * C blocks fill the card) folds one tree;
//      block rank r folds the run [r * L / C, (r + 1) * L / C).
//   2. A block streams its run through shared memory in tiles of up to
//      2048 leaves (16 KB), double-buffered with cp.async (16 bytes a
//      thread, neighbouring threads on neighbouring addresses), so one
//      tile is in flight while the previous one folds. A tile lands in
//      rows of 8 leaves padded to 80 bytes, so the threads of a warp
//      that each read their own row touch distinct banks.
//   3. Thread i folds row i of the tile in registers; the warp folds its
//      32 row roots with shuffles (lane i, a multiple of 2d, combines its
//      value as the left operand with lane i + d's); warp 0 folds the
//      warps' roots of a tile one step later, under the barrier the next
//      tile needs anyway, and merges the tile roots through a
//      binary-counter stack in registers (slot k holds a pending left
//      subtree of 2^k tiles).
//   4. Each block writes its run's root into rank 0's shared memory
//      through distributed shared memory; after the cluster barrier,
//      rank 0 folds the C roots, lower rank on the left, and writes out.
// Leaves are read from the port's int64 leaf column directly (uint32
// values, the low 32 bits taken); roots are written as int64. Any
// power-of-two L >= 1 and any N >= 1 are taken (L = 1 returns the leaf).
//
// Bound: memory. The kernel reads N * L * 8 bytes once and writes N * 8;
// the fold is about 20 integer operations per leaf, far below the card's
// integer rate per byte read. At small N the clusters keep every SM busy.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;                      // leaves a thread folds per tile
constexpr int kTile = kThreads * kRun;       // leaves per tile
constexpr int kRowBytes = kRun * 8 + 16;     // a padded row of kRun leaves
constexpr int kBufBytes = kThreads * kRowBytes;
constexpr int kMaxCluster = 8;
constexpr int kMaxLevels = 40;               // tiles per block < 2^40
constexpr uint32_t kP1 = 0x85EBCA6Bu;
constexpr uint32_t kP2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * kP1;
  x = (x ^ (x >> 13)) * kP2;
  return x ^ (x >> 16);
}

// parent of a left and a right child (unsigned arithmetic wraps mod 2^32)
__device__ __forceinline__ uint32_t combine(uint32_t left, uint32_t right) {
  return mix32(left ^ kP1) + (mix32(right ^ kP2) << 1) + kGolden;
}

// Fold `lanes` values (a power of two, <= 32) held by lanes 0 .. lanes-1
// of the warp; lane 0 ends with their root. All 32 lanes must call.
__device__ __forceinline__ uint32_t warp_fold(uint32_t v, int lanes) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < lanes; d <<= 1) {
    const uint32_t right = __shfl_down_sync(0xffffffffu, v, d);
    if ((lane & (2 * d - 1)) == 0) v = combine(v, right);
  }
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying `tile` leaves from `src` into `buf`, in padded rows of
// `run` leaves (2^lg_pieces 16-byte pieces a row). Consecutive threads
// copy consecutive 16-byte pieces.
__device__ __forceinline__ void issue_tile(unsigned char* buf, const int64_t* src, int tile,
                                           int lg_pieces) {
  const int pieces = tile / 2;
  for (int p = threadIdx.x; p < pieces; p += kThreads) {
    const int row = p >> lg_pieces;
    const int col = p & ((1 << lg_pieces) - 1);
    cp_async16(buf + row * kRowBytes + col * 16, src + 2 * p);
  }
}

// root of one padded row of `run` leaves (2, 4 or 8)
__device__ __forceinline__ uint32_t fold_row(const unsigned char* row, int run) {
  uint32_t v[kRun];
#pragma unroll
  for (int j = 0; j < kRun / 2; ++j) {
    const longlong2 x = 2 * j < run ? *reinterpret_cast<const longlong2*>(row + 16 * j)
                                    : make_longlong2(0, 0);
    v[2 * j] = (uint32_t)x.x;
    v[2 * j + 1] = (uint32_t)x.y;
  }
#pragma unroll
  for (int w = kRun; w > 1; w >>= 1) {
    if (w <= run) {
#pragma unroll
      for (int j = 0; j < w / 2; ++j) v[j] = combine(v[2 * j], v[2 * j + 1]);
    }
  }
  return v[0];
}

// Warp 0: fold tile k's warp roots and push the tile root as tile k of
// the binary-counter stack; returns the running root (the block's root
// after the last tile). All 32 lanes of warp 0 call.
__device__ __forceinline__ uint32_t push_tile(const uint32_t* warp_roots, int warps, int64_t k,
                                              uint32_t* stack) {
  const int lane = threadIdx.x & 31;
  uint32_t x = warp_fold(lane < warps ? warp_roots[lane] : 0u, warps);
#pragma unroll
  for (int b = 0; b < kMaxLevels; ++b) {
    if ((k >> b) & 1) {
      x = combine(stack[b], x);
    } else {
      stack[b] = x;
      break;
    }
  }
  return x;
}

__global__ void __launch_bounds__(kThreads) batched_roots_kernel(
    const int64_t* __restrict__ leaf, int64_t l, int c, int64_t* __restrict__ out) {
  __shared__ __align__(16) unsigned char buf[2][kBufBytes];
  __shared__ uint32_t warp_roots[2][kThreads / 32];
  __shared__ uint32_t run_roots[kMaxCluster];
  const int t = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = c > 1 ? (int)cluster.block_rank() : 0;
  if (c > 1) {
    // every block of the cluster has started before rank 0's shared
    // memory is written (this arrive's wait comes after the fold)
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  }
  const int64_t tree = blockIdx.x / c;
  const int64_t span = l / c;  // leaves of this block's run
  const int64_t* src = leaf + tree * l + rank * span;

  uint32_t root = 0;  // thread 0: the run's root
  if (span == 1) {
    root = (uint32_t)src[0];
  } else {
    const int tile = span < kTile ? (int)span : kTile;
    const int run = tile < kRun ? tile : kRun;
    const int rows = tile / run;  // threads holding a row
    const int lanes = rows < 32 ? rows : 32;
    const int warps = rows / lanes;
    const int lg_pieces = run == 8 ? 2 : (run == 4 ? 1 : 0);
    const int64_t n_tiles = span / tile;
    uint32_t stack[kMaxLevels];

    issue_tile(buf[0], src, tile, lg_pieces);
    cp_async_commit();
    for (int64_t i = 0; i < n_tiles; ++i) {
      if (i + 1 < n_tiles) {
        issue_tile(buf[(i + 1) & 1], src + (i + 1) * tile, tile, lg_pieces);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile i has landed; tile i - 1's warp roots are written
      if (i > 0 && t < 32) root = push_tile(warp_roots[(i - 1) & 1], warps, i - 1, stack);
      uint32_t v = t < rows ? fold_row(buf[i & 1] + t * kRowBytes, run) : 0u;
      v = warp_fold(v, lanes);
      if ((t & 31) == 0 && (t >> 5) < warps) warp_roots[i & 1][t >> 5] = v;
      __syncthreads();  // buf[i & 1] is free for tile i + 2
    }
    if (t < 32) root = push_tile(warp_roots[(n_tiles - 1) & 1], warps, n_tiles - 1, stack);
  }

  if (c == 1) {
    if (t == 0) out[tree] = (int64_t)root;
    return;
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (t == 0) cluster.map_shared_rank(run_roots, 0)[rank] = root;
  cluster.sync();  // every run root is in rank 0's shared memory
  if (rank == 0 && t == 0) {
    for (int d = 1; d < c; d <<= 1) {
      for (int j = 0; j < c; j += 2 * d) run_roots[j] = combine(run_roots[j], run_roots[j + d]);
    }
    out[tree] = (int64_t)run_roots[0];
  }
}

}  // namespace

extern "C" {

// roots of n trees of l leaves each (leaf: int64[n, l], row-major; out:
// int64[n]), each tree folded by a cluster of c blocks. Launch on `stream`
// (a cudaStream_t as void*) with cudaLaunchKernelEx; returns its error or
// cudaGetLastError() after the launch, 0 on success, or
// cudaErrorInvalidValue for arguments the kernel does not take (l not a
// power of two, c not a power of two in [1, min(8, l)], more blocks than
// a grid holds, leaf not 16-byte aligned). The caller checks types and
// layout.
int batched_roots(const void* leaf, int64_t n, int64_t l, int c, void* out, void* stream) {
  if (n <= 0) return 0;
  if (l < 1 || (l & (l - 1)) != 0 || c < 1 || c > kMaxCluster || (c & (c - 1)) != 0 || c > l ||
      n * c > 0x7fffffffLL || ((uintptr_t)leaf & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * c), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, batched_roots_kernel, (const int64_t*)leaf, l, c,
                                           (int64_t*)out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* roots_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
