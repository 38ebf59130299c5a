// Probe-window LWW point lookup over the open-addressing hash store, for
// Hopper (sm_90a). Built by delta_crdt_ex_tpu_torch/utils/kernels.py into
// a shared library with a plain C interface; bound with ctypes by
// delta_crdt_ex_tpu_torch/ops/hash_map.py (ProbeLookupKernel).
//
// Replaces the Pallas TPU kernel _probe_kernel_body / probe_lookup_pallas
// (delta_crdt_ex_tpu/ops/hash_map.py:756, pallas_call at 873). Same grid:
// out[q] = (found, slot, node, ctr, valh, ts_lo, ts_hi, free_slot) as
// int32; not found gives slot -1 and zeros, no dead window lane gives
// free_slot = 2^30. The winner is the LWW maximum (ts signed, writer gid
// unsigned, ctr unsigned, then the lowest lane) over the alive lanes of
// the window whose key matches; word 2 is the winner's node unclamped.
//
// Design. A group of G threads per query (G = 8 at the default W = 32;
// G is the power of two that covers the window's 4-lane chunks, at most
// 32), so a warp serves 32 / G queries. The window base is a multiple of
// 8 lanes and H a power of two >= 8, so every 4-lane chunk is 32-byte
// aligned and lies wholly inside or wholly outside the table: a thread
// reads its chunk's keys as two 16-byte loads and its alive flags as one
// 32-bit load, and masks lanes past W. Wider windows loop over further
// chunks. Each group walks a grid-stride run of queries that fills the
// card, and issues the next query's key hash and window loads before it
// resolves the current one, so every thread keeps two latencies in
// flight. A thread compares its four lanes first and then loads node,
// ctr, ts and valh of its first key-matching alive lane (1-3 lanes per
// key), so the matches of all threads of a warp load in one step. The
// block stages the writer table ctx_gid in shared memory (read from
// global memory when R exceeds kMaxSharedGids), so no load depends on
// another beyond khash -> window -> matching lane. A width-G butterfly of
// shuffles reduces the LWW maximum and the lowest dead lane; the thread
// that owns the winning lane then writes the eight words from its own
// registers as two 16-byte stores (thread 0 of the group when nothing
// matched).
//
// Bound: memory. The least bytes are the window lanes' key + alive
// columns, the matching lanes' node/ctr/ts/valh, the writer table, the
// query hash and the 32-byte output row; the work per byte is a few
// integer ops. Windows of nearby keys overlap, so much of the window
// traffic is served from L2 and the kernel is latency-bound at small Q.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kGroup = 8;              // lanes per probe group (hash_store.GROUP)
constexpr int kNoFree = 1 << 30;       // free_slot when the window has no dead lane
constexpr int kThreads = 128;          // threads per block: at Q = 2048 one block an SM
constexpr int kChunk = 4;              // window lanes a thread loads at once
constexpr int kMaxGroup = 32;          // threads per query at most
constexpr int kMaxSharedGids = 2048;   // writer-table entries staged in shared memory
constexpr int kMaxDevices = 64;
constexpr uint64_t kSalt = 0x9E3779B97F4A7C15ull;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// first lane of the key's probe window (the JAX probe_base)
__device__ __forceinline__ int probe_base(uint64_t kh, uint64_t n_groups) {
  return (int)((mix64(kh ^ kSalt) & (n_groups - 1)) * kGroup);
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

// one thread's 4-lane chunk of a window, loaded and not yet compared
struct Chunk {
  longlong2 k01, k23;  // key[s .. s + 3]
  unsigned alive;      // byte j = alive[s + j]
  int s;               // first lane; -1 when the chunk is outside the window or the table
};

__device__ __forceinline__ Chunk load_chunk(const int64_t* __restrict__ key,
                                            const bool* __restrict__ alive,
                                            int base, int c, int h, int w) {
  Chunk ch;
  const int off = c * kChunk;
  const int s = base + off;
  if (off < w && s < h) {  // s is a multiple of 4 and h of 8: the chunk is in the table
    const longlong2* kp = reinterpret_cast<const longlong2*>(key + s);
    ch.k01 = __ldg(kp);
    ch.k23 = __ldg(kp + 1);
    ch.alive = __ldg(reinterpret_cast<const unsigned*>(alive + s));
    ch.s = s;
  } else {
    ch.k01 = make_longlong2(0, 0);
    ch.k23 = make_longlong2(0, 0);
    ch.alive = 0;
    ch.s = -1;
  }
  return ch;
}

// The thread's running result for one query.
struct Mine {
  Best best;
  int node;        // the best lane's node, unclamped
  unsigned valh;   // the best lane's valh, low 32 bits
  int free_slot;   // lowest dead lane seen
};

__device__ __forceinline__ void consider(int s, const int32_t* __restrict__ node,
                                         const int64_t* __restrict__ ctr,
                                         const int64_t* __restrict__ ts,
                                         const int64_t* __restrict__ valh, const int64_t* gids,
                                         int r, Mine& m) {
  // the lane's four columns: one load instruction each, issued together
  const int nd = node[s];
  const long long t = ts[s];
  const unsigned long long cr = (unsigned long long)ctr[s];
  const unsigned vh = (unsigned)(unsigned long long)valh[s];
  const int ndc = nd < 0 ? 0 : (nd >= r ? r - 1 : nd);
  const Best c = {t, (unsigned long long)gids[ndc], cr, s};
  if (better(c, m.best)) {
    m.best = c;
    m.node = nd;
    m.valh = vh;
  }
}

__device__ __forceinline__ void scan_chunk(
    const Chunk& ch, uint64_t kh, int base, int w,
    const int32_t* __restrict__ node, const int64_t* __restrict__ ctr,
    const int64_t* __restrict__ ts, const int64_t* __restrict__ valh,
    const int64_t* gids, int r, Mine& m) {
  if (ch.s < 0) return;
  const long long k[kChunk] = {ch.k01.x, ch.k01.y, ch.k23.x, ch.k23.y};
  unsigned match = 0;  // bit j: lane s + j is alive and holds the key
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (ch.s + j - base < w) {  // lanes past the window are neither free nor candidates
      if (((ch.alive >> (8 * j)) & 0xffu) == 0) {
        m.free_slot = min(m.free_slot, ch.s + j);
      } else if ((uint64_t)k[j] == kh) {
        match |= 1u << j;
      }
    }
  }
  // The first match of every thread of the warp loads in one step,
  // whichever lane of its chunk it sits in (a branch per lane would
  // wait out one memory latency per lane position); a second match in
  // the same chunk is rare and loads after.
  if (match) {
    consider(ch.s + __ffs(match) - 1, node, ctr, ts, valh, gids, r, m);
    for (unsigned e = match & (match - 1); e; e &= e - 1) {
      consider(ch.s + __ffs(e) - 1, node, ctr, ts, valh, gids, r, m);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) probe_lookup_kernel(
    const int64_t* __restrict__ khash, int q,
    const int64_t* __restrict__ key, const bool* __restrict__ alive,
    const int32_t* __restrict__ node, const int64_t* __restrict__ ctr,
    const int64_t* __restrict__ ts, const int64_t* __restrict__ valh,
    int h, int w, const int64_t* __restrict__ ctx_gid, int r,
    int32_t* __restrict__ out) {
  extern __shared__ int64_t shared_gid[];
  const int sub = threadIdx.x & (G - 1);  // thread within the query's group
  const int64_t stride = (int64_t)gridDim.x * (kThreads / G);
  const int64_t first = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / G;
  // the warp's first group: the loop runs warp-uniformly, so the
  // shuffles below always have all 32 lanes
  const int64_t warp_first = ((int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31)) / G;
  const uint64_t n_groups = (uint64_t)(h / kGroup);
  const int n_chunks = (w + kChunk - 1) / kChunk;

  // the first query's hash is in flight while the block stages the writer table
  int64_t qi = first;
  uint64_t kh = qi < q ? (uint64_t)khash[qi] : 0;
  const int64_t* gids = ctx_gid;
  if (r <= kMaxSharedGids) {
    for (int i = threadIdx.x; i < r; i += kThreads) shared_gid[i] = ctx_gid[i];
    __syncthreads();
    gids = shared_gid;
  }
  int base = probe_base(kh, n_groups);
  Chunk cur = load_chunk(key, alive, base, qi < q ? sub : n_chunks, h, w);
  int64_t qn = qi + stride;
  uint64_t khn = qn < q ? (uint64_t)khash[qn] : 0;

  for (int64_t wq = warp_first; wq < q; wq += stride) {
    // the next query's window and the one after's hash: in flight while
    // this query resolves
    const int base_n = probe_base(khn, n_groups);
    const Chunk nxt = load_chunk(key, alive, base_n, qn < q ? sub : n_chunks, h, w);
    const int64_t qnn = qn + stride;
    const uint64_t khnn = qnn < q ? (uint64_t)khash[qnn] : 0;

    Mine m = {{0, 0, 0, -1}, 0, 0u, kNoFree};
    if (qi < q) {
      scan_chunk(cur, kh, base, w, node, ctr, ts, valh, gids, r, m);
      for (int c = sub + G; c < n_chunks; c += G) {
        scan_chunk(load_chunk(key, alive, base, c, h, w), kh, base, w, node, ctr, ts, valh,
                   gids, r, m);
      }
    }
    Best best = m.best;
    int free_slot = m.free_slot;
#pragma unroll
    for (int d = G / 2; d > 0; d >>= 1) {
      Best o;
      o.ts = __shfl_xor_sync(0xffffffffu, best.ts, d, G);
      o.gid = __shfl_xor_sync(0xffffffffu, best.gid, d, G);
      o.ctr = __shfl_xor_sync(0xffffffffu, best.ctr, d, G);
      o.slot = __shfl_xor_sync(0xffffffffu, best.slot, d, G);
      if (better(o, best)) best = o;
      free_slot = min(free_slot, __shfl_xor_sync(0xffffffffu, free_slot, d, G));
    }
    if (qi < q) {
      const bool found = best.slot >= 0;
      // exactly one thread writes: the winning lane's owner, or thread 0
      if (found ? m.best.slot == best.slot : sub == 0) {
        const unsigned long long t = (unsigned long long)best.ts;
        int4* o = reinterpret_cast<int4*>(out + qi * 8);
        o[0] = make_int4(found, found ? best.slot : -1, found ? m.node : 0,
                         found ? (int)(unsigned)best.ctr : 0);
        o[1] = make_int4(found ? (int)m.valh : 0, found ? (int)(unsigned)t : 0,
                         found ? (int)(unsigned)(t >> 32) : 0, free_slot);
      }
    }
    qi = qn;
    kh = khn;
    base = base_n;
    cur = nxt;
    qn = qnn;
    khn = khnn;
  }
}

// grid that fills the card with resident blocks, at most one group per query
template <int G>
cudaError_t launch(const int64_t* khash, int q, const int64_t* key, const bool* alive,
                   const int32_t* node, const int64_t* ctr, const int64_t* ts,
                   const int64_t* valh, int h, int w, const int64_t* ctx_gid, int r,
                   int32_t* out, cudaStream_t stream) {
  // blocks per SM and SMs of each device, packed as per_sm << 16 | n_sm
  // (0 = not asked yet); one atomic word, so concurrent first launches from
  // several host threads at worst both ask and store the same value
  static std::atomic<int> resident[kMaxDevices];
  const size_t smem = r <= kMaxSharedGids ? (size_t)r * sizeof(int64_t) : 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int packed = dev < kMaxDevices ? resident[dev].load(std::memory_order_relaxed) : 0;
  if (packed == 0) {
    int per_sm = 0, n_sm = 0;
    // at the largest staged writer table, so the count holds for every r
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, probe_lookup_kernel<G>, kThreads, kMaxSharedGids * sizeof(int64_t));
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    packed = (per_sm < 1 ? 1 : per_sm) << 16 | n_sm;
    if (dev < kMaxDevices) resident[dev].store(packed, std::memory_order_relaxed);
  }
  const int per_sm = packed >> 16, n_sm = packed & 0xFFFF;
  const int64_t wanted = ((int64_t)q * G + kThreads - 1) / kThreads;
  const int64_t full = (int64_t)per_sm * n_sm;
  const int blocks = (int)(wanted < full ? wanted : full);
  probe_lookup_kernel<G><<<blocks, kThreads, smem, stream>>>(
      khash, q, key, alive, node, ctr, ts, valh, h, w, ctx_gid, r, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads per query for a window of w lanes: the power of two that covers
// its 4-lane chunks, at most 32; chunk c of a window falls to thread c mod G.
int probe_group(int w) {
  const int n_chunks = (w + kChunk - 1) / kChunk;
  int g = 1;
  while (g < n_chunks && g < kMaxGroup) g <<= 1;
  return g;
}

// Launch on `stream` (a cudaStream_t as void*); returns cudaGetLastError()
// after the launch, 0 on success, or cudaErrorInvalidValue for inputs the
// kernel does not take (key or out not 16-byte aligned, alive not 4-byte
// aligned, h not a power of two >= 8). The caller checks shapes and types.
int probe_lookup(const void* khash, int q, const void* key, const void* alive,
                 const void* node, const void* ctr, const void* ts,
                 const void* valh, int h, int w, const void* ctx_gid, int r,
                 void* out, void* stream) {
  if (q <= 0) return 0;
  if (h < kGroup || (h & (h - 1)) != 0 || w < 1 || r < 1 ||
      ((uintptr_t)key & 15) != 0 || ((uintptr_t)out & 15) != 0 || ((uintptr_t)alive & 3) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int g = probe_group(w);
  const int64_t* kh = (const int64_t*)khash;
  const int64_t* k = (const int64_t*)key;
  const bool* a = (const bool*)alive;
  const int32_t* nd = (const int32_t*)node;
  const int64_t* c = (const int64_t*)ctr;
  const int64_t* t = (const int64_t*)ts;
  const int64_t* v = (const int64_t*)valh;
  const int64_t* gid = (const int64_t*)ctx_gid;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (g) {
    case 1: return (int)launch<1>(kh, q, k, a, nd, c, t, v, h, w, gid, r, o, s);
    case 2: return (int)launch<2>(kh, q, k, a, nd, c, t, v, h, w, gid, r, o, s);
    case 4: return (int)launch<4>(kh, q, k, a, nd, c, t, v, h, w, gid, r, o, s);
    case 8: return (int)launch<8>(kh, q, k, a, nd, c, t, v, h, w, gid, r, o, s);
    case 16: return (int)launch<16>(kh, q, k, a, nd, c, t, v, h, w, gid, r, o, s);
    default: return (int)launch<32>(kh, q, k, a, nd, c, t, v, h, w, gid, r, o, s);
  }
}

const char* probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
