// Native host runtime for zk_state_proofs_tpu: fast Keccak-256 and batched
// witness packing. The GPU does the verification math; this library covers
// the host-side hot loops around it (the role the reference fills with
// native Rust throughout — tiny-keccak and eth_trie node handling,
// reference: crypto-ops/src/keccak.rs, trie-utils/src/proofs/*):
//   - zkp_keccak256 / zkp_keccak256_batch: legacy-padding Keccak-256
//   - zkp_pack_proofs: proof lists -> zero-padded device tensor bundles
//     (the data-loader path feeding ops/mpt.verify_proofs)
// C ABI, consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <vector>

namespace {

constexpr int kRounds = 24;
constexpr size_t kRate = 136;

constexpr uint64_t kRC[kRounds] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

constexpr int kRho[25] = {0, 1, 62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                          25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

// Word-at-a-time FNV-style mix — hash-table key for node-pool
// deduplication (not a cryptographic digest; collisions fall through to a
// byte compare, so quality only affects probe length).
inline uint64_t fnv1a64(const uint8_t* p, size_t n) {
  uint64_t h = 1469598103934665603ULL ^ (n * 1099511628211ULL);
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    std::memcpy(&w, p + i, 8);
    h ^= w;
    h *= 1099511628211ULL;
    h ^= h >> 29;
  }
  uint64_t tail = 0;
  if (i < n) std::memcpy(&tail, p + i, n - i);
  h ^= tail;
  h *= 1099511628211ULL;
  h ^= h >> 32;
  return h;
}

inline uint64_t next_pow2(uint64_t x) {
  uint64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

inline uint64_t rotl64(uint64_t x, int n) {
  return n == 0 ? x : (x << n) | (x >> (64 - n));
}

void keccak_f1600(uint64_t a[25]) {
  for (int r = 0; r < kRounds; ++r) {
    uint64_t c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d[x];
    uint64_t b[25];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], kRho[x + 5 * y]);
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= kRC[r];
  }
}

}  // namespace

extern "C" {

// Legacy (pad 0x01) Keccak-256 of a single message.
void zkp_keccak256(const uint8_t* data, size_t len, uint8_t out[32]) {
  uint64_t state[25] = {0};
  uint8_t block[kRate];
  size_t off = 0;
  while (len - off >= kRate) {
    for (size_t i = 0; i < kRate / 8; ++i) {
      uint64_t lane;
      std::memcpy(&lane, data + off + 8 * i, 8);  // little-endian host
      state[i] ^= lane;
    }
    keccak_f1600(state);
    off += kRate;
  }
  size_t rem = len - off;
  std::memset(block, 0, kRate);
  if (rem) std::memcpy(block, data + off, rem);
  block[rem] ^= 0x01;
  block[kRate - 1] ^= 0x80;
  for (size_t i = 0; i < kRate / 8; ++i) {
    uint64_t lane;
    std::memcpy(&lane, block + 8 * i, 8);
    state[i] ^= lane;
  }
  keccak_f1600(state);
  std::memcpy(out, state, 32);
}

// Batch digest: messages concatenated in `data`, bounds in `offsets`
// (n+1 entries); writes n*32 bytes to `out`.
void zkp_keccak256_batch(const uint8_t* data, const int64_t* offsets, int n,
                         uint8_t* out) {
  for (int i = 0; i < n; ++i) {
    zkp_keccak256(data + offsets[i],
                  static_cast<size_t>(offsets[i + 1] - offsets[i]),
                  out + 32 * i);
  }
}

// Pack B proofs into padded tensors. Layout of inputs:
//   node_blob / node_offsets[total_nodes+1]: all proof nodes, concatenated
//   proof_counts[b]: nodes per proof
//   roots: b*32 bytes
//   key_blob / key_offsets[b+1]: lookup keys
// Outputs (preallocated by caller, zero-filled here):
//   nodes   u8 [b, max_nodes, node_len]
//   node_lens i32 [b, max_nodes]; num_nodes i32 [b]
//   out_roots u8 [b, 32]
//   key_nibbles u8 [b, key_nib]; key_lens i32 [b]
// Returns 0, or the 1-based index of the first proof violating the bucket.
int zkp_pack_proofs(const uint8_t* node_blob, const int64_t* node_offsets,
                    const int32_t* proof_counts, const uint8_t* roots,
                    const uint8_t* key_blob, const int64_t* key_offsets,
                    int b, int max_nodes, int node_len, int key_nib,
                    uint8_t* nodes, int32_t* node_lens, int32_t* num_nodes,
                    uint8_t* out_roots, uint8_t* key_nibbles,
                    int32_t* key_lens) {
  std::memset(nodes, 0, static_cast<size_t>(b) * max_nodes * node_len);
  std::memset(node_lens, 0, static_cast<size_t>(b) * max_nodes * 4);
  std::memset(key_nibbles, 0, static_cast<size_t>(b) * key_nib);
  int64_t node_idx = 0;
  for (int i = 0; i < b; ++i) {
    int cnt = proof_counts[i];
    if (cnt > max_nodes) return i + 1;
    num_nodes[i] = cnt;
    for (int j = 0; j < cnt; ++j, ++node_idx) {
      int64_t start = node_offsets[node_idx];
      int64_t len = node_offsets[node_idx + 1] - start;
      if (len > node_len) return i + 1;
      std::memcpy(nodes + (static_cast<size_t>(i) * max_nodes + j) * node_len,
                  node_blob + start, static_cast<size_t>(len));
      node_lens[i * max_nodes + j] = static_cast<int32_t>(len);
    }
    std::memcpy(out_roots + 32 * i, roots + 32 * i, 32);
    int64_t kstart = key_offsets[i];
    int64_t klen = key_offsets[i + 1] - kstart;
    if (2 * klen > key_nib) return i + 1;
    for (int64_t k = 0; k < klen; ++k) {
      uint8_t byte = key_blob[kstart + k];
      key_nibbles[static_cast<size_t>(i) * key_nib + 2 * k] = byte >> 4;
      key_nibbles[static_cast<size_t>(i) * key_nib + 2 * k + 1] = byte & 0x0f;
    }
    key_lens[i] = static_cast<int32_t>(2 * klen);
  }
  return 0;
}

// Deduplicate packed proof-node rows into a unique-node pool (the input
// to ops/mpt.verify_proofs_pooled — hash each unique node once on device,
// where the reference re-hashes every node per proof,
// crypto-ops/src/lib.rs:10-13). Mirrors witness/pack.build_node_pool
// byte-for-byte — rows 1.. ordered by DESCENDING byte length (stable by
// first encounter within equal lengths; keeps the Pallas keccak kernel's
// per-tile sponge-block skip effective) with the reserved all-zero pool
// row 0 — so the two paths are interchangeable.
//
// Inputs: nodes u8 [b, max_nodes, node_len] (zero-padded), node_lens i32
// [b, max_nodes], num_nodes i32 [b]. Outputs (caller-allocated):
// pool_nodes u8 [cap, node_len] (must be ZERO-FILLED by the caller so
// unused rows stay zero), pool_lens i32 [cap] (zero-filled), pool_idx
// i32 [b, max_nodes] (zero-filled: rows past num_nodes map to row 0).
// Returns the number of pool rows used (>= 1), or -1 if cap overflows.
int zkp_build_node_pool(const uint8_t* nodes, const int32_t* node_lens,
                        const int32_t* num_nodes, int b, int max_nodes,
                        int node_len, uint8_t* pool_nodes, int32_t* pool_lens,
                        int32_t* pool_idx, int cap) {
  if (cap < 1) return -1;
  // open-addressing table of (pool row + 1); 0 = empty slot
  const uint64_t tsize =
      next_pow2(2ULL * (static_cast<uint64_t>(b) * max_nodes + 2));
  const uint64_t tmask = tsize - 1;
  std::vector<int32_t> table(tsize, 0);
  int used = 1;  // row 0 = the reserved zero row (len 0)
  for (int i = 0; i < b; ++i) {
    const int cnt = num_nodes[i];
    for (int j = 0; j < cnt; ++j) {
      const uint8_t* row =
          nodes + (static_cast<size_t>(i) * max_nodes + j) * node_len;
      const int32_t len = node_lens[i * max_nodes + j];
      if (len == 0) {
        pool_idx[i * max_nodes + j] = 0;  // empty row == the zero row
        continue;
      }
      uint64_t slot = fnv1a64(row, static_cast<size_t>(len)) & tmask;
      int32_t at = -1;
      for (;;) {
        const int32_t entry = table[slot];
        if (entry == 0) break;  // not present
        const int32_t cand = entry - 1;
        const uint8_t* crow =
            pool_nodes + static_cast<size_t>(cand) * node_len;
        if (pool_lens[cand] == len &&
            std::memcmp(crow, row, static_cast<size_t>(len)) == 0) {
          at = cand;
          break;
        }
        slot = (slot + 1) & tmask;
      }
      if (at < 0) {
        if (used >= cap) return -1;
        at = used++;
        // copy the full padded row (tail is zeros by the packing contract)
        std::memcpy(pool_nodes + static_cast<size_t>(at) * node_len, row,
                    static_cast<size_t>(node_len));
        pool_lens[at] = len;
        table[slot] = at + 1;
      }
      pool_idx[i * max_nodes + j] = at;
    }
  }
  // Reorder rows 1..used-1 by descending length (stable: ties keep
  // first-encounter order) and remap pool_idx. Row 0 (zero row) stays put.
  if (used > 2) {
    std::vector<int32_t> order(used - 1);
    for (int i = 0; i < used - 1; ++i) order[i] = i + 1;
    std::stable_sort(order.begin(), order.end(),
                     [&](int32_t a, int32_t c) {
                       return pool_lens[a] > pool_lens[c];
                     });
    std::vector<int32_t> inv(used, 0);
    for (int newpos = 0; newpos < used - 1; ++newpos)
      inv[order[newpos]] = newpos + 1;
    std::vector<uint8_t> tmp_nodes(static_cast<size_t>(used - 1) * node_len);
    std::vector<int32_t> tmp_lens(used - 1);
    for (int newpos = 0; newpos < used - 1; ++newpos) {
      const int32_t old = order[newpos];
      std::memcpy(tmp_nodes.data() + static_cast<size_t>(newpos) * node_len,
                  pool_nodes + static_cast<size_t>(old) * node_len, node_len);
      tmp_lens[newpos] = pool_lens[old];
    }
    std::memcpy(pool_nodes + node_len, tmp_nodes.data(), tmp_nodes.size());
    std::memcpy(pool_lens + 1, tmp_lens.data(), tmp_lens.size() * 4);
    const int64_t total = static_cast<int64_t>(b) * max_nodes;
    for (int64_t k = 0; k < total; ++k) pool_idx[k] = inv[pool_idx[k]];
  }
  return used;
}

}  // extern "C"
