// One merge attempt of the column fan-in: a delta slice merged into a
// lane-batched column store, committed in place only where every lane
// merged (or, per lane, where that lane merged). Built by
// delta_crdt_ex_tpu_torch/utils/kernels.py into a shared library with a
// plain C interface; bound with ctypes by
// delta_crdt_ex_tpu_torch/ops/merge_kernel.py (MergeSliceKernel).
//
// Replaces no TPU kernel: the JAX package's column merge
// (delta_crdt_ex_tpu/ops/binned.py:merge_slice) is jnp that XLA fuses. On
// the card the same merge in plain torch (ops/binned.py:_merge_slice_b)
// is hundreds of small kernels, each a pass over the whole store, because
// every output column is a fresh copy; this kernel is the fused merge.
//
// Function: ops/binned.py:_merge_slice_b per lane, then the conditional
// commit of ops/binned.py:merge_commit_ref, bit for bit where ok holds:
//   - the lane's writer table merged with the slice's (merge_gid_tables);
//   - per slice row: the remote interval in local slots (rdense, ldense),
//     the insert mask (alive, writer known, not covered by the local
//     context), gap detection, the amin/amax prune on the pre-merge row;
//   - inserts at the row's fill plus their rank, with their entry hash;
//   - on a flagged row, the kill of every local dot the interval covers
//     and the slice does not carry;
//   - the row's fill, leaf digest (wrapping uint32), amin/amax (rebuilt
//     on a flagged row, else widened by the inserts) and context union.
// Flags and n_inserted are the plain op's on every attempt; n_killed is
// the plain op's wherever ok holds (elsewhere it counts the kills of
// every flagged row, where the plain op stops at the kill budget).
//
// Design. Two launches; both touch only the slice's rows.
//   1. merge_compute reads the store and never writes it. A block of
//      kWarps warps rebuilds its lane's merged writer table in shared
//      memory (R x Rr compares), then each warp takes one slice row: the
//      row's context, slice entries and B slots are spread over the
//      lanes of the warp (a slot a lane, looping where B > 32), insert
//      ranks come from ballots, the kill test compares each local dot
//      with the row's slice dots held in shared memory, and amin/amax are
//      reduced with shared-memory atomics. The warp writes the row's new
//      contents to a [N, U, ...] scratch, and its counts and flags into
//      per-lane words with atomics (inserts, flagged rows, kills, fill
//      overflow, gap; the block of slice rows 0 writes the gid overflow
//      and the merged table). The words are part of the scratch and are
//      zeroed by a memset ahead of this launch, so no attempt depends on
//      what an earlier one left behind.
//   2. merge_commit reads every lane's words, writes the attempt's flags
//      [6, N] and counts [2, N], and only where ok holds copies the
//      scratch rows and the merged writer table into the store. ok is
//      every lane's ok (the graphed fan-in, whose retry re-runs every
//      lane), or with per_lane each lane's own (an eager merge into a
//      copy, which no retry reads).
// Where ok is false the store is left exactly as it was, which is what
// the caller's retry on the same store relies on.
//
// This file is the one source of the kernel's limits and of its scratch
// layout: merge_scratch_bytes refuses shapes past the limits, and the
// caller hands one buffer of that many bytes, which the launch carves.
//
// Bound: bytes of the touched rows (each read once and written once,
// the scratch twice more, all from L2 at the cells' sizes) plus the
// latencies of a memset and two launches; the arithmetic is a few
// hundred integer operations a slot. Nothing outside the slice's rows is
// read or written.
//
// Preconditions (as for the plain op's scatters): slice rows name
// distinct buckets, except padding (negative); a row at or past L is
// treated as padding here, where the plain op would fault. Local writer
// slots (node) lie in [0, R).

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kWarps = 4;  // slice rows a block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kAcc = 8;  // words a lane: see the enum below
constexpr int64_t kMaxLanes = 65535;  // grid.y
constexpr int kMaxR = 256;
constexpr int kMaxRr = 256;
constexpr int kMaxS = 1024;
constexpr int kMaxB = 4096;
constexpr int kMaxSmem = 200 * 1024;
constexpr int64_t kU32Max = 0xFFFFFFFFLL;
constexpr uint64_t kM1 = 0xBF58476D1CE4E5B9ULL;
constexpr uint64_t kM2 = 0x94D049BB133111EBULL;

enum { kIns = 0, kFlagged = 1, kKilled = 2, kFill = 3, kGap = 4, kGid = 5 };

struct Dims {
  int64_t n, L, B, R, U, S, Rr;
  int64_t kill_budget, max_inserts;  // max_inserts < 0: no insert tier
  int64_t slice_lanes;               // 1: the slice has a lane axis; 0: shared
  int64_t per_lane;                  // 1: commit each ok lane; 0: only if every lane is ok
};

struct Store {
  int64_t* key;
  int64_t* valh;
  int64_t* ts;
  int32_t* node;
  int64_t* ctr;
  uint8_t* alive;
  int64_t* ehash;
  int32_t* fill;
  int64_t* amin;
  int64_t* amax;
  int64_t* leaf;
  int64_t* ctx_gid;
  int64_t* ctx_max;
};

struct Slice {
  const int64_t* rows;
  const int64_t* key;
  const int64_t* valh;
  const int64_t* ts;
  const int32_t* node;
  const int64_t* ctr;
  const uint8_t* alive;
  const int64_t* ctx_rows;
  const int64_t* ctx_lo;
  const int64_t* ctx_gid;
};

// the new contents of each slice row of each lane, and the per-lane words
struct Scratch {
  int64_t* key;  // [N, U, B] each
  int64_t* valh;
  int64_t* ts;
  int64_t* ctr;
  int64_t* ehash;
  int32_t* node;
  uint8_t* alive;
  int32_t* fill;     // [N, U]
  int64_t* leaf;     // [N, U]
  int64_t* amin;     // [N, U, R]
  int64_t* amax;     // [N, U, R]
  int64_t* ctx_max;  // [N, U, R]
  int64_t* gid;      // [N, R] merged writer table
  uint32_t* acc;     // [N, kAcc] per-lane words
};

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * kM1;
  x = (x ^ (x >> 27)) * kM2;
  return x ^ (x >> 31);
}

// ops/binned.py:entry_hash (uint32 value, as int64)
__device__ __forceinline__ int64_t entry_hash(int64_t key, int64_t gid, int64_t ctr, int64_t ts, int64_t valh) {
  const uint64_t h = mix64((uint64_t)key ^ mix64((uint64_t)gid ^ (uint64_t)ctr) ^
                           mix64((uint64_t)ts ^ ((uint64_t)valh << 32)));
  return (int64_t)((h ^ (h >> 32)) & 0xFFFFFFFFULL);
}

// ops/dots.py:encode_dot
__device__ __forceinline__ int64_t encode_dot(int64_t node, int64_t ctr) {
  return (int64_t)(((uint64_t)node << 32) | ((uint64_t)ctr & 0xFFFFFFFFULL));
}

__host__ __device__ constexpr int64_t align16(int64_t b) { return (b + 15) & ~(int64_t)15; }

__host__ __device__ constexpr int64_t block_smem(int64_t R, int64_t Rr) {
  return align16(8 * R + 8 * Rr + 4 * Rr + 4 * Rr + Rr);
}

__host__ __device__ constexpr int64_t warp_smem(int64_t R, int64_t S) {
  return align16(5 * 8 * R + 8 * S + 4 * S + R);
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads) merge_compute(Dims d, Store x, Slice sl, Scratch w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t R = d.R, Rr = d.Rr, S = d.S, B = d.B, L = d.L, U = d.U;
  const int64_t lane_n = blockIdx.y;
  const int t = threadIdx.x;
  const int64_t so = d.slice_lanes ? lane_n : 0;  // the slice's lane

  // ---- the lane's merged writer table (ops/dots.py:merge_gid_tables)
  int64_t* gid_l = (int64_t*)smem;     // [R]: the local table, then the merged one
  int64_t* gid_r = gid_l + R;          // [Rr]
  int32_t* remap = (int32_t*)(gid_r + Rr);  // [Rr]
  int32_t* target = remap + Rr;        // [Rr]
  uint8_t* is_new = (uint8_t*)(target + Rr);  // [Rr]
  for (int64_t i = t; i < R; i += kThreads) gid_l[i] = x.ctx_gid[lane_n * R + i];
  for (int64_t j = t; j < Rr; j += kThreads) gid_r[j] = sl.ctx_gid[so * Rr + j];
  __syncthreads();
  for (int64_t j = t; j < Rr; j += kThreads) {
    const int64_t g = gid_r[j];
    const bool occ = g != 0;
    int64_t match = -1;
    for (int64_t i = 0; i < R && match < 0; ++i) {
      if (occ && gid_l[i] == g) match = i;
    }
    is_new[j] = occ && match < 0;
    target[j] = (int32_t)(match < 0 ? 0 : match);  // argmax of no match is slot 0
  }
  __syncthreads();
  int64_t n_free = 0;
  for (int64_t i = 0; i < R; ++i) n_free += gid_l[i] == 0;
  for (int64_t j = t; j < Rr; j += kThreads) {
    const bool occ = gid_r[j] != 0;
    int64_t tgt = target[j];
    if (is_new[j]) {
      int64_t rank = 0;
      for (int64_t k = 0; k < j; ++k) rank += is_new[k];
      rank = clamp64(rank, 0, R - 1);
      int64_t slot = R;  // the rank-th free local slot, R past the last
      if (rank < n_free) {
        int64_t seen = 0;
        for (int64_t i = 0; i < R; ++i) {
          if (gid_l[i] == 0) {
            if (seen == rank) {
              slot = i;
              break;
            }
            ++seen;
          }
        }
      }
      tgt = slot;
    }
    if (!occ) tgt = R;
    remap[j] = (int32_t)((occ && tgt < R) ? tgt : -1);
    target[j] = (int32_t)tgt;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    if (t == 0) {
      int64_t n_new = 0;
      for (int64_t j = 0; j < Rr; ++j) n_new += is_new[j];
      w.acc[lane_n * kAcc + kGid] = n_new > n_free ? 1u : 0u;
      for (int64_t j = 0; j < Rr; ++j) {
        if (target[j] < R) gid_l[target[j]] = gid_r[j];
      }
    }
    __syncthreads();
    for (int64_t i = t; i < R; i += kThreads) w.gid[lane_n * R + i] = gid_l[i];
  }

  // ---- one slice row a warp
  const int warp = t >> 5, lane = t & 31;
  const unsigned full = 0xffffffffu;
  const int64_t u = (int64_t)blockIdx.x * kWarps + warp;
  if (u >= U) return;
  const int64_t row = sl.rows[so * U + u];
  if (row < 0 || row >= L) return;  // padding: contributes nothing

  unsigned char* wbase = smem + block_smem(R, Rr) + warp * warp_smem(R, S);
  int64_t* local = (int64_t*)wbase;  // [R] ctx_max of the row
  int64_t* rd = local + R;           // [R] interval upper bounds in local slots
  int64_t* ld = rd + R;              // [R] lower bounds
  int64_t* amn = ld + R;             // [R] the row's new amin
  int64_t* amx = amn + R;            // [R] the row's new amax
  int64_t* rdot = amx + R;           // [S] the row's slice dots
  int32_t* ins_s = (int32_t*)(rdot + S);  // [S] slice slot of the k-th insert
  uint8_t* hit = (uint8_t*)(ins_s + S);   // [R] some remote slot maps here

  const int64_t lrow = lane_n * L + row;  // the row in the store
  const int64_t srow = so * U + u;        // the row in the slice
  const int64_t orow = lane_n * U + u;    // the row in the scratch

  bool gap = false, flag = false;
  for (int64_t r = lane; r < R; r += 32) {
    const int64_t lc = x.ctx_max[lrow * R + r];
    int64_t hi = 0, lo = kU32Max;
    bool mapped = false;
    for (int64_t j = 0; j < Rr; ++j) {
      if (remap[j] != r) continue;
      mapped = true;
      const int64_t cr = sl.ctx_rows[srow * Rr + j], cl = sl.ctx_lo[srow * Rr + j];
      if (cr > cl) {
        hi = cr > hi ? cr : hi;
        lo = cl < lo ? cl : lo;
      }
    }
    if (lo == kU32Max) lo = 0;
    const int64_t a0 = x.amin[lrow * R + r], a1 = x.amax[lrow * R + r];
    local[r] = lc;
    rd[r] = hi;
    ld[r] = lo;
    amn[r] = a0;
    amx[r] = a1;
    hit[r] = mapped;
    gap |= hi > lo && lc < lo;
    flag |= hi >= a0 && lo < a1;
  }
  gap = __any_sync(full, gap);
  flag = __any_sync(full, flag);
  if (flag) {  // a flagged row's amin/amax are rebuilt from its survivors
    for (int64_t r = lane; r < R; r += 32) {
      amn[r] = kU32Max;
      amx[r] = 0;
    }
  }
  __syncwarp();

  // inserts: the slice entries not covered by the local context, ranked
  int64_t n_ins = 0;
  for (int64_t s0 = 0; s0 < S; s0 += 32) {
    const int64_t s = s0 + lane;
    bool ins = false;
    if (s < S) {
      const int64_t e = srow * S + s;
      const int64_t nd = clamp64(sl.node[e], 0, Rr - 1);
      const int64_t ln = remap[nd];
      const int64_t lnc = clamp64(ln, 0, R - 1);
      const int64_t c = sl.ctr[e];
      const bool al = sl.alive[e] != 0;
      ins = al && !(local[lnc] >= c) && ln >= 0;
      rdot[s] = al ? encode_dot(lnc, c) : 0;
    }
    const unsigned ballot = __ballot_sync(full, ins);
    if (ins) ins_s[n_ins + __popc(ballot & ((1u << lane) - 1u))] = (int32_t)s;
    n_ins += __popc(ballot);
  }
  __syncwarp();

  // the row's slots: inserts at fill + rank, the kill on a flagged row
  const int64_t fill0 = x.fill[lrow];
  uint32_t leaf_delta = 0, dies = 0;
  for (int64_t b = lane; b < B; b += 32) {
    const int64_t src = lrow * B + b, dst = orow * B + b;
    const int64_t k = b - fill0;
    int64_t key, valh, ts, ctr, eh, node;
    bool al;
    if (k >= 0 && k < n_ins) {
      const int64_t e = srow * S + ins_s[k];
      key = sl.key[e];
      valh = sl.valh[e];
      ts = sl.ts[e];
      ctr = sl.ctr[e];
      const int64_t nd = clamp64(sl.node[e], 0, Rr - 1);
      node = clamp64(remap[nd], 0, R - 1);
      eh = entry_hash(key, gid_r[nd], ctr, ts, valh);
      al = true;
      leaf_delta += (uint32_t)eh;
      if (!flag) {
        atomicMin((long long*)&amn[node], (long long)ctr);
        atomicMax((long long*)&amx[node], (long long)ctr);
      }
    } else {
      key = x.key[src];
      valh = x.valh[src];
      ts = x.ts[src];
      ctr = x.ctr[src];
      eh = x.ehash[src];
      node = x.node[src];
      al = x.alive[src] != 0;
      if (flag && al) {
        const int64_t nc = clamp64(node, 0, R - 1);
        const bool covered = rd[nc] >= ctr && ld[nc] < ctr;
        if (covered) {
          const int64_t dot = encode_dot(node, ctr);
          bool present = false;
          for (int64_t s = 0; s < S; ++s) present |= rdot[s] == dot;
          if (!present) {
            al = false;
            leaf_delta -= (uint32_t)eh;
            ++dies;
          }
        }
      }
    }
    if (flag && al && node >= 0 && node < R) {
      atomicMin((long long*)&amn[node], (long long)ctr);
      atomicMax((long long*)&amx[node], (long long)ctr);
    }
    w.key[dst] = key;
    w.valh[dst] = valh;
    w.ts[dst] = ts;
    w.ctr[dst] = ctr;
    w.ehash[dst] = eh;
    w.node[dst] = (int32_t)node;
    w.alive[dst] = al ? 1 : 0;
  }
  leaf_delta = __reduce_add_sync(full, leaf_delta);
  dies = __reduce_add_sync(full, dies);
  __syncwarp();

  for (int64_t r = lane; r < R; r += 32) {
    w.amin[orow * R + r] = amn[r];
    w.amax[orow * R + r] = amx[r];
    w.ctx_max[orow * R + r] = hit[r] ? (rd[r] > local[r] ? rd[r] : local[r]) : local[r];
  }
  if (lane == 0) {
    w.fill[orow] = (int32_t)(fill0 + n_ins);
    w.leaf[orow] = (int64_t)(((uint64_t)x.leaf[lrow] + leaf_delta) & 0xFFFFFFFFULL);
    uint32_t* acc = w.acc + lane_n * kAcc;
    if (n_ins) atomicAdd(&acc[kIns], (uint32_t)n_ins);
    if (flag) {
      atomicAdd(&acc[kFlagged], 1u);
      if (dies) atomicAdd(&acc[kKilled], dies);
    }
    if (fill0 + n_ins > B) atomicOr(&acc[kFill], 1u);
    if (gap) atomicOr(&acc[kGap], 1u);
  }
}

__device__ __forceinline__ void lane_flags(const Dims& d, const uint32_t* acc, bool f[6]) {
  const int64_t n_ins = __ldcg(&acc[kIns]);
  const int64_t flagged = __ldcg(&acc[kFlagged]);
  const bool gid = __ldcg(&acc[kGid]) != 0;
  const bool fill = __ldcg(&acc[kFill]) != 0;
  const bool gap = __ldcg(&acc[kGap]) != 0;
  const bool kill = flagged > d.kill_budget;
  const int64_t grid = d.U * d.S;
  const bool ins = d.max_inserts >= 0 && n_ins > (d.max_inserts < grid ? d.max_inserts : grid);
  f[0] = !(gid || kill || fill || gap || ins);  // MergeResult order
  f[1] = gid;
  f[2] = kill;
  f[3] = fill;
  f[4] = gap;
  f[5] = ins;
}

__global__ void __launch_bounds__(kThreads) merge_commit(Dims d, Store x, Slice sl, Scratch w, uint8_t* flags,
                                                         int64_t* counts) {
  const int t = threadIdx.x;
  const int64_t R = d.R, B = d.B, L = d.L, U = d.U;
  const int64_t lane_n = blockIdx.y;
  int ok = 1;
  for (int64_t m = t; m < d.n; m += kThreads) {
    bool f[6];
    lane_flags(d, w.acc + m * kAcc, f);
    ok &= f[0];
    if (blockIdx.x == 0 && blockIdx.y == 0) {
      for (int i = 0; i < 6; ++i) flags[i * d.n + m] = f[i];
      counts[m] = __ldcg(&w.acc[m * kAcc + kIns]);
      counts[d.n + m] = __ldcg(&w.acc[m * kAcc + kKilled]);
    }
  }
  ok = __syncthreads_and(ok);
  if (d.per_lane) {
    bool f[6];
    lane_flags(d, w.acc + lane_n * kAcc, f);
    ok = f[0];
  }

  if (ok) {
    const int64_t so = d.slice_lanes ? lane_n : 0;
    if (blockIdx.x == 0) {
      for (int64_t i = t; i < R; i += kThreads) x.ctx_gid[lane_n * R + i] = w.gid[lane_n * R + i];
    }
    const int warp = t >> 5, lane = t & 31;
    const int64_t u = (int64_t)blockIdx.x * kWarps + warp;
    const int64_t row = u < U ? sl.rows[so * U + u] : -1;
    if (row >= 0 && row < L) {
      const int64_t lrow = lane_n * L + row, orow = lane_n * U + u;
      for (int64_t b = lane; b < B; b += 32) {
        const int64_t src = orow * B + b, dst = lrow * B + b;
        x.key[dst] = w.key[src];
        x.valh[dst] = w.valh[src];
        x.ts[dst] = w.ts[src];
        x.ctr[dst] = w.ctr[src];
        x.ehash[dst] = w.ehash[src];
        x.node[dst] = w.node[src];
        x.alive[dst] = w.alive[src];
      }
      for (int64_t r = lane; r < R; r += 32) {
        x.amin[lrow * R + r] = w.amin[orow * R + r];
        x.amax[lrow * R + r] = w.amax[orow * R + r];
        x.ctx_max[lrow * R + r] = w.ctx_max[orow * R + r];
      }
      if (lane == 0) {
        x.fill[lrow] = w.fill[orow];
        x.leaf[lrow] = w.leaf[orow];
      }
    }
  }
}

int64_t smem_bytes(const Dims& d) { return block_smem(d.R, d.Rr) + kWarps * warp_smem(d.R, d.S); }

Dims read_dims(const int64_t* dims) {
  Dims d;
  d.n = dims[0];
  d.L = dims[1];
  d.B = dims[2];
  d.R = dims[3];
  d.U = dims[4];
  d.S = dims[5];
  d.Rr = dims[6];
  d.kill_budget = dims[7];
  d.max_inserts = dims[8];
  d.slice_lanes = dims[9];
  d.per_lane = dims[10];
  return d;
}

bool within_limits(const Dims& d) {
  return d.n >= 1 && d.n <= kMaxLanes && d.L >= 1 && d.B >= 1 && d.B <= kMaxB && d.R >= 1 && d.R <= kMaxR &&
         d.U >= 1 && (d.U + kWarps - 1) / kWarps <= 0x7fffffffLL && d.S >= 1 && d.S <= kMaxS && d.Rr >= 1 &&
         d.Rr <= kMaxRr;
}

// so the sizes above are the whole rule: no shape within them needs more
static_assert(block_smem(kMaxR, kMaxRr) + kWarps * warp_smem(kMaxR, kMaxS) <= kMaxSmem, "shared memory");

// The scratch's parts, each 16-byte aligned, in one buffer at `base`
// (nullptr: only count). Returns the bytes the parts take.
int64_t carve(const Dims& d, unsigned char* base, Scratch* w) {
  const int64_t nub = d.n * d.U * d.B, nu = d.n * d.U, nur = d.n * d.U * d.R;
  int64_t off = 0;
  auto take = [&](int64_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += align16(bytes);
    return p;
  };
  w->acc = (uint32_t*)take(4 * d.n * kAcc);  // first: the memset's target
  w->key = (int64_t*)take(8 * nub);
  w->valh = (int64_t*)take(8 * nub);
  w->ts = (int64_t*)take(8 * nub);
  w->ctr = (int64_t*)take(8 * nub);
  w->ehash = (int64_t*)take(8 * nub);
  w->node = (int32_t*)take(4 * nub);
  w->alive = (uint8_t*)take(nub);
  w->fill = (int32_t*)take(4 * nu);
  w->leaf = (int64_t*)take(8 * nu);
  w->amin = (int64_t*)take(8 * nur);
  w->amax = (int64_t*)take(8 * nur);
  w->ctx_max = (int64_t*)take(8 * nur);
  w->gid = (int64_t*)take(8 * d.n * d.R);
  return off;
}

}  // namespace

extern "C" {

// Once, outside any stream capture: lets merge_compute use up to
// kMaxSmem bytes of dynamic shared memory. Returns a cudaError_t.
int merge_init(void) {
  const cudaError_t e = cudaFuncSetAttribute(merge_compute, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return (int)e;
}

// dims, for merge_scratch_bytes and merge_slice_commit: n, L, B, R, U,
// S, Rr, kill_budget, max_inserts (< 0: none), slice_lanes, per_lane.

// The bytes of scratch one attempt at these dims needs, or -1 where a
// size is past the kernel's limits (merge_limits), or L or U is 0.
int64_t merge_scratch_bytes(const int64_t* dims) {
  const Dims d = read_dims(dims);
  if (!within_limits(d)) return -1;
  Scratch w;
  return carve(d, nullptr, &w);
}

// The limits as text.
const char* merge_limits(void) {
  static const char* const text = [] {
    static char buf[200];
    snprintf(buf, sizeof buf, "lanes <= %lld, B <= %d, R <= %d, slice writers Rr <= %d, slice entries a row S <= %d",
             (long long)kMaxLanes, kMaxB, kMaxR, kMaxRr, kMaxS);
    return (const char*)buf;
  }();
  return text;
}

// One merge attempt. store: the 13 column pointers in BinnedStore
// order; slice: the 10 RowSlice pointers in field order; scratch: a
// buffer of merge_scratch_bytes(dims) bytes, 16-byte aligned. flags:
// bool[6, n]; counts: int64[2, n]. Zeroes the per-lane words, then
// launches both passes on `stream`; returns -1 for shapes past the
// limits, else the first error of the memset or of cudaGetLastError()
// after each launch, 0 on success. The caller checks types and layout.
int merge_slice_commit(const int64_t* dims, void* const* store, void* const* slice, void* scratch, void* flags,
                       void* counts, void* stream) {
  const Dims d = read_dims(dims);
  if (!within_limits(d)) return -1;
  Store x;
  x.key = (int64_t*)store[0];
  x.valh = (int64_t*)store[1];
  x.ts = (int64_t*)store[2];
  x.node = (int32_t*)store[3];
  x.ctr = (int64_t*)store[4];
  x.alive = (uint8_t*)store[5];
  x.ehash = (int64_t*)store[6];
  x.fill = (int32_t*)store[7];
  x.amin = (int64_t*)store[8];
  x.amax = (int64_t*)store[9];
  x.leaf = (int64_t*)store[10];
  x.ctx_gid = (int64_t*)store[11];
  x.ctx_max = (int64_t*)store[12];
  Slice sl;
  sl.rows = (const int64_t*)slice[0];
  sl.key = (const int64_t*)slice[1];
  sl.valh = (const int64_t*)slice[2];
  sl.ts = (const int64_t*)slice[3];
  sl.node = (const int32_t*)slice[4];
  sl.ctr = (const int64_t*)slice[5];
  sl.alive = (const uint8_t*)slice[6];
  sl.ctx_rows = (const int64_t*)slice[7];
  sl.ctx_lo = (const int64_t*)slice[8];
  sl.ctx_gid = (const int64_t*)slice[9];
  Scratch w;
  carve(d, (unsigned char*)scratch, &w);

  const dim3 grid((unsigned)((d.U + kWarps - 1) / kWarps), (unsigned)d.n, 1);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(w.acc, 0, (size_t)(4 * d.n * kAcc), s);
  if (e != cudaSuccess) return (int)e;
  merge_compute<<<grid, kThreads, (size_t)smem_bytes(d), s>>>(d, x, sl, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_commit<<<grid, kThreads, 0, s>>>(d, x, sl, w, (uint8_t*)flags, (int64_t*)counts);
  e = cudaGetLastError();
  return (int)e;
}

const char* merge_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
