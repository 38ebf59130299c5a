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
// Design. One block per tree. The TPU kernel's strided roll fold and its
// 8-row blocks were Mosaic constraints and are gone. Here a contiguous,
// aligned power-of-two run of leaves is a whole subtree, so:
//   1. each of the block's P = min(L, 256) threads folds its own run of
//      L / P leaves in registers: chunks of up to 8 leaves fold by an
//      unrolled pairwise tree, and the chunk roots merge through a
//      binary-counter stack (slot k holds a pending left subtree of 2^k
//      chunks; the loop over k is unrolled, so the stack stays in
//      registers);
//   2. the warp folds its threads' subtree roots with shuffles: at
//      distance d, lane i (i a multiple of 2d) combines its value (left)
//      with lane i + d's (right), so order is kept;
//   3. the warps' roots go through shared memory and warp 0 folds them
//      the same way.
// Leaves are read from the port's int64 leaf column directly (uint32
// values, the low 32 bits taken); roots are written as int64. Any
// power-of-two L >= 1 and any N >= 1 are taken (L = 1 returns the leaf).
//
// Bound: memory. The kernel reads N * L * 8 bytes once and writes N * 8;
// the fold is about 20 integer operations per leaf, far below the card's
// integer rate per byte read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;       // leaves a thread loads and folds at once
constexpr int kMaxLevels = 24;  // chunks per thread < 2^24
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

__global__ void __launch_bounds__(kThreads) batched_roots_kernel(
    const int64_t* __restrict__ leaf, int64_t l, int64_t* __restrict__ out) {
  __shared__ uint32_t warp_roots[kThreads / 32];
  const int t = threadIdx.x;
  const int64_t p = l < kThreads ? l : kThreads;  // threads holding a subtree
  const int64_t run = l / p;                      // leaves per thread
  const int chunk = run < kChunk ? (int)run : kChunk;
  const int64_t n_chunks = run / chunk;
  const int64_t* row = leaf + (int64_t)blockIdx.x * l;

  uint32_t acc = 0;
  if (t < p) {
    const int64_t* mine = row + t * run;
    uint32_t stack[kMaxLevels];
    for (int64_t c = 0; c < n_chunks; ++c) {
      uint32_t v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        v[j] = j < chunk ? (uint32_t)mine[c * chunk + j] : 0u;
      }
#pragma unroll
      for (int w = kChunk; w > 1; w >>= 1) {
        if (w <= chunk) {
#pragma unroll
          for (int j = 0; j < w / 2; ++j) v[j] = combine(v[2 * j], v[2 * j + 1]);
        }
      }
      // push chunk c: every set low bit of c is a pending left sibling
      uint32_t x = v[0];
#pragma unroll
      for (int k = 0; k < kMaxLevels; ++k) {
        if ((c >> k) & 1) {
          x = combine(stack[k], x);
        } else {
          stack[k] = x;
          break;
        }
      }
      acc = x;  // after the last chunk: the root of the thread's run
    }
  }

  acc = warp_fold(acc, p < 32 ? (int)p : 32);
  if (p <= 32) {
    if (t == 0) out[blockIdx.x] = (int64_t)acc;
    return;
  }
  const int warps = (int)(p / 32);
  if ((t & 31) == 0) warp_roots[t >> 5] = acc;
  __syncthreads();
  if (t < 32) {
    acc = warp_fold(t < warps ? warp_roots[t] : 0u, warps);
    if (t == 0) out[blockIdx.x] = (int64_t)acc;
  }
}

}  // namespace

extern "C" {

// roots of n trees of l leaves each (leaf: int64[n, l], row-major; out:
// int64[n]). Launch on `stream` (a cudaStream_t as void*); returns
// cudaGetLastError() after the launch, 0 on success, or
// cudaErrorInvalidValue for a shape the kernel does not take (l not a
// power of two, more leaves per thread than the register stack covers,
// or more trees than a grid holds). The caller checks types and layout.
int batched_roots(const void* leaf, int64_t n, int64_t l, void* out, void* stream) {
  if (n <= 0) return 0;
  if (l < 1 || (l & (l - 1)) != 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int64_t p = l < kThreads ? l : kThreads;
  const int64_t run = l / p;
  if (run / (run < kChunk ? run : kChunk) >= (1LL << kMaxLevels)) return (int)cudaErrorInvalidValue;
  batched_roots_kernel<<<(unsigned)n, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)leaf, l, (int64_t*)out);
  return (int)cudaGetLastError();
}

const char* roots_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
