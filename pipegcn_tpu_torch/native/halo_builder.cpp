// Native host kernels for the halo index pipeline (partition/halo.py).
//
// ShardedGraph.build's dominant cost at Reddit scale is sorting the
// ~114M-edge list by (owner device, local destination) — a two-key
// numpy lexsort taking tens of seconds to minutes. The build fuses the
// keys into one uint64 and sorts here with a stable LSD radix sort
// (comparison-free, one 256-bucket pass per significant byte), the
// native analogue of the C++ graph machinery the reference leans on
// (DGL's partition/csr code, SURVEY.md §2b).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Stable argsort of uint64 keys: writes the permutation (int64 indices)
// into `out`. LSD radix over 11-bit digits on (key, index) PAIRS — the
// payload travels with the key so every pass streams memory instead of
// gathering keys[idx] (the gather's cache misses dominate otherwise).
// Only digits below the maximum key's bit-width run (the common fused
// key owner*N + local_id fits in ~31 bits → 3 passes). Returns 0.
int pgt_radix_argsort_u64(int64_t n, const uint64_t* keys, int64_t* out) {
  if (n < 0 || (n > 0 && (!keys || !out))) return 1;
  if (n == 0) return 0;

  constexpr int kDigitBits = 11;
  constexpr int kBuckets = 1 << kDigitBits;
  constexpr uint64_t kMask = kBuckets - 1;

  uint64_t max_key = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (keys[i] > max_key) max_key = keys[i];
  }
  int n_passes = 0;
  while (max_key >> (kDigitBits * n_passes)) ++n_passes;
  if (n_passes == 0) n_passes = 1;

  struct Pair {
    uint64_t k;
    int64_t i;
  };
  std::vector<Pair> a(n), b(n);
  for (int64_t i = 0; i < n; ++i) {
    a[i].k = keys[i];
    a[i].i = i;
  }
  Pair* cur = a.data();
  Pair* nxt = b.data();

  std::vector<int64_t> hist(kBuckets);
  for (int p = 0; p < n_passes; ++p) {
    const int shift = kDigitBits * p;
    std::memset(hist.data(), 0, kBuckets * sizeof(int64_t));
    for (int64_t i = 0; i < n; ++i) {
      ++hist[(cur[i].k >> shift) & kMask];
    }
    int populated = 0;
    for (int d = 0; d < kBuckets && populated < 2; ++d) {
      if (hist[d]) ++populated;
    }
    if (populated < 2) continue;  // uniform digit: pass is a no-op
    int64_t run = 0;
    for (int d = 0; d < kBuckets; ++d) {
      const int64_t c = hist[d];
      hist[d] = run;
      run += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      nxt[hist[(cur[i].k >> shift) & kMask]++] = cur[i];
    }
    Pair* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int64_t i = 0; i < n; ++i) out[i] = cur[i].i;
  return 0;
}

}  // extern "C"
