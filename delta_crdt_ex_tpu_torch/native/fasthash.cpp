// Batch BLAKE2b-64 key hashing for the host runtime.
//
// The device only ever sees 64-bit key ids; the host derives them from
// canonically-encoded terms (utils/hashing.py). Hashing a large mutation
// batch or rebuilding dictionaries for a million-key map pays ~1 us of
// Python/hashlib overhead per key; this extension hashes a packed buffer
// of encodings in one call. It implements RFC 7693 BLAKE2b with
// digest_length=8, no key — bit-for-bit identical to Python's
// hashlib.blake2b(data, digest_size=8), which stays as the plain
// version, so every replica agrees on key ids whichever path hashed
// them (equality is enforced by tests/test_torch_native.py).
//
// Build: g++ -O3 -shared -fPIC fasthash.cpp -o libfasthash.so
// (done on demand by delta_crdt_ex_tpu_torch/native/__init__.py into build/native/)

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

constexpr uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, unsigned n) {
  return (x >> n) | (x << (64 - n));
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86-64 / aarch64)
}

void compress(uint64_t h[8], const uint8_t block[128], uint64_t t, bool last) {
  uint64_t m[16];
  for (int i = 0; i < 16; ++i) m[i] = load64(block + 8 * i);
  uint64_t v[16];
  for (int i = 0; i < 8; ++i) v[i] = h[i];
  for (int i = 0; i < 8; ++i) v[8 + i] = IV[i];
  v[12] ^= t;  // t0 (messages < 2^64 bytes; t1 stays 0)
  if (last) v[14] = ~v[14];

#define G(a, b, c, d, x, y)      \
  v[a] = v[a] + v[b] + (x);      \
  v[d] = rotr64(v[d] ^ v[a], 32); \
  v[c] = v[c] + v[d];            \
  v[b] = rotr64(v[b] ^ v[c], 24); \
  v[a] = v[a] + v[b] + (y);      \
  v[d] = rotr64(v[d] ^ v[a], 16); \
  v[c] = v[c] + v[d];            \
  v[b] = rotr64(v[b] ^ v[c], 63);

  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = SIGMA[r];
    G(0, 4, 8, 12, m[s[0]], m[s[1]]);
    G(1, 5, 9, 13, m[s[2]], m[s[3]]);
    G(2, 6, 10, 14, m[s[4]], m[s[5]]);
    G(3, 7, 11, 15, m[s[6]], m[s[7]]);
    G(0, 5, 10, 15, m[s[8]], m[s[9]]);
    G(1, 6, 11, 12, m[s[10]], m[s[11]]);
    G(2, 7, 8, 13, m[s[12]], m[s[13]]);
    G(3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
#undef G

  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[8 + i];
}

// BLAKE2b, digest_size bytes (1..64), no key, sequential mode.
void blake2b(const uint8_t* data, uint64_t len, uint8_t* out, unsigned digest_size) {
  uint64_t h[8];
  for (int i = 0; i < 8; ++i) h[i] = IV[i];
  h[0] ^= 0x01010000ULL ^ digest_size;  // param block: fanout=1, depth=1

  uint8_t block[128];
  uint64_t t = 0;
  while (len > 128) {
    std::memcpy(block, data, 128);
    t += 128;
    compress(h, block, t, false);
    data += 128;
    len -= 128;
  }
  std::memset(block, 0, 128);
  std::memcpy(block, data, len);
  t += len;
  compress(h, block, t, true);
  std::memcpy(out, h, digest_size);
}

}  // namespace

extern "C" {

// Hash n concatenated byte strings; offsets has n+1 entries delimiting
// each string in `packed`. Writes one big-endian-interpreted 64-bit key
// id per string (matching int.from_bytes(digest, "big") in Python, with
// 0 mapped to 1 — the empty-slot sentinel).
void hash64_batch(const uint8_t* packed, const uint64_t* offsets, uint64_t n,
                  uint64_t* out) {
  for (uint64_t i = 0; i < n; ++i) {
    uint8_t d[8];
    blake2b(packed + offsets[i], offsets[i + 1] - offsets[i], d, 8);
    uint64_t v = 0;
    for (int j = 0; j < 8; ++j) v = (v << 8) | d[j];
    out[i] = v ? v : 1;
  }
}

// 32-bit value digests, same packing convention.
void hash32_batch(const uint8_t* packed, const uint64_t* offsets, uint64_t n,
                  uint32_t* out) {
  for (uint64_t i = 0; i < n; ++i) {
    uint8_t d[4];
    blake2b(packed + offsets[i], offsets[i + 1] - offsets[i], d, 4);
    out[i] = ((uint32_t)d[0] << 24) | ((uint32_t)d[1] << 16) |
             ((uint32_t)d[2] << 8) | (uint32_t)d[3];
  }
}
}
