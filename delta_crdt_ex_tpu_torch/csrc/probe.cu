// Probe-window LWW point lookup over the open-addressing hash store, for
// Hopper (sm_90a). Built by delta_crdt_ex_tpu_torch/utils/kernels.py into
// a shared library with a plain C interface; bound with ctypes by
// delta_crdt_ex_tpu_torch/ops/hash_map.py (ProbeLookupKernel).
//
// Replaces the Pallas TPU kernel _probe_kernel_body / probe_lookup_pallas
// (delta_crdt_ex_tpu/ops/hash_map.py:756, pallas_call at 873). Same grid:
// out[q] = (found, slot, node, ctr, valh, ts_lo, ts_hi, free_slot) as
// int32; not found gives slot -1 and zeros, no dead window lane gives
// free_slot = 2^30.
//
// Design. One warp per query; the warp's 32 lanes stride the probe window
// [base, base + w) (w = 32: one table lane per thread, so the key and
// alive loads of a warp are one coalesced read). The TPU kernel DMAed two
// 128-lane rows per column and narrowed on 32-bit halves because the TPU
// has no 64-bit integers; here keys, timestamps and gids compare as whole
// 64-bit words. Each thread keeps its best key-matching alive lane under
// the LWW order (ts signed, writer gid unsigned, ctr unsigned, then the
// lowest lane) and its lowest dead lane; a butterfly of warp shuffles
// reduces both, so every thread ends with the result and threads 0..7
// write the eight output words. The probe base (the JAX probe_base) is
// computed here from the key hash.
//
// Bound: memory. The least bytes are the window lanes' key + alive
// columns, the matching lanes' node/ctr/ts/valh, the query hash and the
// 32-byte output row; the work per byte is a few integer ops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;          // lanes per probe group (hash_store.GROUP)
constexpr int kNoFree = 1 << 30;   // free_slot when the window has no dead lane
constexpr int kWarpsPerBlock = 8;
constexpr uint64_t kSalt = 0x9E3779B97F4A7C15ull;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct Best {
  long long ts;
  unsigned long long gid;
  unsigned long long ctr;
  int slot;  // -1 = no candidate
};

// a beats b under the LWW order; the lower slot wins a full tie
__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  if (a.slot < 0) return false;
  if (b.slot < 0) return true;
  if (a.ts != b.ts) return a.ts > b.ts;
  if (a.gid != b.gid) return a.gid > b.gid;
  if (a.ctr != b.ctr) return a.ctr > b.ctr;
  return a.slot < b.slot;
}

__global__ void probe_lookup_kernel(
    const int64_t* __restrict__ khash, int q,
    const int64_t* __restrict__ key, const bool* __restrict__ alive,
    const int32_t* __restrict__ node, const int64_t* __restrict__ ctr,
    const int64_t* __restrict__ ts, const int64_t* __restrict__ valh,
    int h, int w, const int64_t* __restrict__ ctx_gid, int r,
    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t qi = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (qi >= q) return;  // whole warp exits together

  const uint64_t kh = (uint64_t)khash[qi];
  const uint64_t ng = (uint64_t)(h / kGroup);
  const int base = (int)((mix64(kh ^ kSalt) & (ng - 1)) * kGroup);

  Best best = {0, 0, 0, -1};
  int free_slot = kNoFree;
  for (int off = lane; off < w; off += 32) {
    const int s = base + off;
    if (s >= h) break;  // windows do not wrap past the table end
    if (!alive[s]) {
      free_slot = min(free_slot, s);
    } else if ((uint64_t)key[s] == kh) {
      int nd = node[s];
      nd = nd < 0 ? 0 : (nd >= r ? r - 1 : nd);
      Best c = {(long long)ts[s], (unsigned long long)ctx_gid[nd],
                (unsigned long long)ctr[s], s};
      if (better(c, best)) best = c;
    }
  }

  for (int m = 16; m > 0; m >>= 1) {
    Best o;
    o.ts = __shfl_xor_sync(0xffffffffu, best.ts, m);
    o.gid = __shfl_xor_sync(0xffffffffu, best.gid, m);
    o.ctr = __shfl_xor_sync(0xffffffffu, best.ctr, m);
    o.slot = __shfl_xor_sync(0xffffffffu, best.slot, m);
    if (better(o, best)) best = o;
    free_slot = min(free_slot, __shfl_xor_sync(0xffffffffu, free_slot, m));
  }

  if (lane < 8) {
    const bool found = best.slot >= 0;
    int32_t v = 0;
    switch (lane) {
      case 0: v = found; break;
      case 1: v = found ? best.slot : -1; break;
      case 2: v = found ? node[best.slot] : 0; break;
      case 3: v = found ? (int32_t)(uint32_t)best.ctr : 0; break;
      case 4: v = found ? (int32_t)(uint32_t)(uint64_t)valh[best.slot] : 0; break;
      case 5: v = found ? (int32_t)(uint32_t)(unsigned long long)best.ts : 0; break;
      case 6: v = found ? (int32_t)(uint32_t)((unsigned long long)best.ts >> 32) : 0; break;
      default: v = free_slot; break;
    }
    out[qi * 8 + lane] = v;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as void*); returns cudaGetLastError()
// after the launch, 0 on success. The caller checks shapes and types.
int probe_lookup(const void* khash, int q, const void* key, const void* alive,
                 const void* node, const void* ctr, const void* ts,
                 const void* valh, int h, int w, const void* ctx_gid, int r,
                 void* out, void* stream) {
  if (q <= 0) return 0;
  const int blocks = (q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  probe_lookup_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)khash, q, (const int64_t*)key, (const bool*)alive,
      (const int32_t*)node, (const int64_t*)ctr, (const int64_t*)ts,
      (const int64_t*)valh, h, w, (const int64_t*)ctx_gid, r, (int32_t*)out);
  return (int)cudaGetLastError();
}

const char* probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
