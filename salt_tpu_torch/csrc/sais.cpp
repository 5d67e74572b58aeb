// SA-IS suffix array construction (linear time, induced sorting).
//
// Native component of the salt_tpu_torch index build: replaces the
// reference's incremental BWT-SW construction (Index_src/bwt_gen.c,
// 4bit_bwt_gen.c, QSufSort.c) for large genomes.  Loaded from Python via
// ctypes (salt_tpu_torch/index/suffix.py); built with g++ at first use by
// salt_tpu_torch/utils/native.py.
//
// Exposes:
//   int salt_sais_u8(const uint8_t* text, int64_t* sa, int64_t n)
//   int salt_sais_u8_i32(const uint8_t* text, int32_t* sa, int64_t n)
//     write the suffix array of text[0..n-1] (WITHOUT the implicit
//     terminal sentinel) into sa[0..n-1]; return 0 on success.
//     The i32 variant (n < 2^31) halves the working set — the index build
//     prefers it for every monolithic index (the uint32 genome-size
//     contract caps coordinates anyway; >2^31-base genomes go through
//     the sharded-by-bin build where each shard is < 2^31).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using i64 = int64_t;

template <typename T, typename I>
void get_counts(const T* s, I* cnt, I n, i64 k) {
  std::memset(cnt, 0, sizeof(I) * k);
  for (I i = 0; i < n; ++i) ++cnt[s[i]];
}

template <typename I>
void get_buckets(const I* cnt, I* bkt, i64 k, bool end) {
  I sum = 0;
  for (i64 i = 0; i < k; ++i) {
    sum += cnt[i];
    bkt[i] = end ? sum : sum - cnt[i];
  }
}

template <typename T, typename I>
void induce_sa(const T* s, I* sa, I* cnt, I* bkt, I n, i64 k,
               const std::vector<bool>& is_s) {
  // L-type induction (left to right)
  get_buckets(cnt, bkt, k, false);
  // the sentinel's predecessor
  if (n > 0) {
    I j = n - 1;
    if (!is_s[j]) sa[bkt[s[j]]++] = j;
  }
  for (I i = 0; i < n; ++i) {
    I j = sa[i];
    if (j > 0 && !is_s[j - 1]) sa[bkt[s[j - 1]]++] = j - 1;
  }
  // S-type induction (right to left)
  get_buckets(cnt, bkt, k, true);
  for (I i = n - 1; i >= 0; --i) {
    I j = sa[i];
    if (j > 0 && is_s[j - 1]) sa[--bkt[s[j - 1]]] = j - 1;
  }
}

template <typename T, typename I>
void sais_core(const T* s, I* sa, I n, i64 k) {
  if (n == 0) return;
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  // classify: is_s[i] = suffix i is S-type (sentinel at n is S)
  std::vector<bool> is_s(n, false);
  is_s[n - 1] = false;  // last real char: L-type vs sentinel (smaller)
  // conventional: suffix n (sentinel) is S; s[n-1] > sentinel -> L
  for (I i = n - 2; i >= 0; --i)
    is_s[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && is_s[i + 1]);

  auto is_lms = [&](I i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

  std::vector<I> cnt(k), bkt(k);
  get_counts(s, cnt.data(), n, k);

  // step 1: place LMS suffixes at bucket ends (in text order) and induce
  std::fill(sa, sa + n, I(-1));
  get_buckets(cnt.data(), bkt.data(), k, true);
  for (I i = n - 1; i >= 1; --i)
    if (is_lms(i)) sa[--bkt[s[i]]] = i;
  induce_sa(s, sa, cnt.data(), bkt.data(), n, k, is_s);

  // step 2: name LMS substrings using their induced order
  I n_lms = 0;
  for (I i = 0; i < n; ++i)
    if (is_lms(sa[i])) sa[n_lms++] = sa[i];
  std::fill(sa + n_lms, sa + n, I(-1));
  I name = 0, prev = -1;
  for (I i = 0; i < n_lms; ++i) {
    I pos = sa[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (I d = 0;; ++d) {
        if (pos + d == n || prev + d == n) {
          // one substring ends at the sentinel
          diff = !(pos + d == n && prev + d == n);
          break;
        }
        if (s[pos + d] != s[prev + d] || is_s[pos + d] != is_s[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
          diff = !(is_lms(pos + d) && is_lms(prev + d));
          break;
        }
      }
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    sa[n_lms + pos / 2] = name - 1;
  }
  // compact names in text order
  std::vector<I> lms_pos;
  lms_pos.reserve(n_lms);
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) lms_pos.push_back(i);
  std::vector<I> s1(n_lms);
  {
    I j = 0;
    for (I i = n_lms; i < n; ++i)
      if (sa[i] >= 0) s1[j++] = sa[i];
  }

  // step 3: order LMS suffixes
  std::vector<I> sa1(n_lms);
  if (name < n_lms) {
    sais_core<I, I>(s1.data(), sa1.data(), n_lms, name);
  } else {
    for (I i = 0; i < n_lms; ++i) sa1[s1[i]] = i;
  }

  // step 4: final induce from ordered LMS suffixes
  std::fill(sa, sa + n, I(-1));
  get_buckets(cnt.data(), bkt.data(), k, true);
  for (I i = n_lms - 1; i >= 0; --i) {
    I j = lms_pos[sa1[i]];
    sa[--bkt[s[j]]] = j;
  }
  induce_sa(s, sa, cnt.data(), bkt.data(), n, k, is_s);
}

}  // namespace

// ---------------------------------------------------------------------
// uint32-storage variant for texts with 2^31 <= n < 2^32-1 (whole-genome
// scale: GRCh38 is ~3.1G bases, over int32 but comfortably under
// uint32).  Same induced-sorting algorithm as sais_core above, with
// EMPTY = 0xFFFFFFFF standing in for -1 and int64 loop counters (an
// unsigned descending loop would never terminate).  Halves the peak
// working set vs the int64 path: ~40GB total at 3.1G bases instead of
// ~80GB — the difference between fitting an ordinary 128GB build host
// or not (the reference builds GRCh38 via incremental BWT-SW,
// Index_src/bwt_gen.c:1400-1538; we spend more RAM to keep the build a
// single linear-time pass).
namespace {

const uint32_t EMPTY32 = 0xFFFFFFFFu;

template <typename T>
void get_counts_u32(const T* s, uint32_t* cnt, i64 n, i64 k) {
  std::memset(cnt, 0, sizeof(uint32_t) * k);
  for (i64 i = 0; i < n; ++i) ++cnt[s[i]];
}

void get_buckets_u32(const uint32_t* cnt, uint32_t* bkt, i64 k, bool end) {
  uint32_t sum = 0;
  for (i64 i = 0; i < k; ++i) {
    sum += cnt[i];
    bkt[i] = end ? sum : sum - cnt[i];
  }
}

template <typename T>
void induce_sa_u32(const T* s, uint32_t* sa, uint32_t* cnt, uint32_t* bkt,
                   i64 n, i64 k, const std::vector<bool>& is_s) {
  get_buckets_u32(cnt, bkt, k, false);
  if (n > 0) {
    i64 j = n - 1;
    if (!is_s[j]) sa[bkt[s[j]]++] = static_cast<uint32_t>(j);
  }
  for (i64 i = 0; i < n; ++i) {
    uint32_t j = sa[i];
    if (j != EMPTY32 && j > 0 && !is_s[j - 1]) sa[bkt[s[j - 1]]++] = j - 1;
  }
  get_buckets_u32(cnt, bkt, k, true);
  for (i64 i = n - 1; i >= 0; --i) {
    uint32_t j = sa[i];
    if (j != EMPTY32 && j > 0 && is_s[j - 1]) sa[--bkt[s[j - 1]]] = j - 1;
  }
}

template <typename T>
void sais_core_u32(const T* s, uint32_t* sa, i64 n, i64 k) {
  if (n == 0) return;
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  std::vector<bool> is_s(n, false);
  is_s[n - 1] = false;
  for (i64 i = n - 2; i >= 0; --i)
    is_s[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && is_s[i + 1]);

  auto is_lms = [&](uint32_t i) {
    return i != EMPTY32 && i > 0 && is_s[i] && !is_s[i - 1];
  };

  std::vector<uint32_t> cnt(k), bkt(k);
  get_counts_u32(s, cnt.data(), n, k);

  std::fill(sa, sa + n, EMPTY32);
  get_buckets_u32(cnt.data(), bkt.data(), k, true);
  for (i64 i = n - 1; i >= 1; --i)
    if (is_lms(static_cast<uint32_t>(i)))
      sa[--bkt[s[i]]] = static_cast<uint32_t>(i);
  induce_sa_u32(s, sa, cnt.data(), bkt.data(), n, k, is_s);

  i64 n_lms = 0;
  for (i64 i = 0; i < n; ++i)
    if (is_lms(sa[i])) sa[n_lms++] = sa[i];
  std::fill(sa + n_lms, sa + n, EMPTY32);
  i64 name = 0, prev = -1;
  for (i64 i = 0; i < n_lms; ++i) {
    i64 pos = sa[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (i64 d = 0;; ++d) {
        if (pos + d == n || prev + d == n) {
          diff = !(pos + d == n && prev + d == n);
          break;
        }
        if (s[pos + d] != s[prev + d] || is_s[pos + d] != is_s[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(static_cast<uint32_t>(pos + d)) ||
                      is_lms(static_cast<uint32_t>(prev + d)))) {
          diff = !(is_lms(static_cast<uint32_t>(pos + d)) &&
                   is_lms(static_cast<uint32_t>(prev + d)));
          break;
        }
      }
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    sa[n_lms + pos / 2] = static_cast<uint32_t>(name - 1);
  }
  std::vector<uint32_t> lms_pos;
  lms_pos.reserve(n_lms);
  for (i64 i = 1; i < n; ++i)
    if (is_lms(static_cast<uint32_t>(i)))
      lms_pos.push_back(static_cast<uint32_t>(i));
  std::vector<uint32_t> s1(n_lms);
  {
    i64 j = 0;
    for (i64 i = n_lms; i < n; ++i)
      if (sa[i] != EMPTY32) s1[j++] = sa[i];
  }

  std::vector<uint32_t> sa1(n_lms);
  if (name < n_lms) {
    sais_core_u32<uint32_t>(s1.data(), sa1.data(), n_lms, name);
  } else {
    for (i64 i = 0; i < n_lms; ++i) sa1[s1[i]] = static_cast<uint32_t>(i);
  }

  std::fill(sa, sa + n, EMPTY32);
  get_buckets_u32(cnt.data(), bkt.data(), k, true);
  for (i64 i = n_lms - 1; i >= 0; --i) {
    uint32_t j = lms_pos[sa1[i]];
    sa[--bkt[s[j]]] = j;
  }
  induce_sa_u32(s, sa, cnt.data(), bkt.data(), n, k, is_s);
}

}  // namespace

extern "C" int salt_sais_u8(const uint8_t* text, i64* sa, i64 n) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  sais_core<uint8_t, i64>(text, sa, n, 256);
  return 0;
}

extern "C" int salt_sais_u8_i32(const uint8_t* text, int32_t* sa, i64 n) {
  if (n < 0 || n > INT32_MAX) return -1;
  if (n == 0) return 0;
  sais_core<uint8_t, int32_t>(text, sa, static_cast<int32_t>(n), 256);
  return 0;
}

extern "C" int salt_sais_u8_u32(const uint8_t* text, uint32_t* sa, i64 n) {
  if (n < 0 || n >= static_cast<i64>(EMPTY32)) return -1;
  if (n == 0) return 0;
  sais_core_u32<uint8_t>(text, sa, n, 256);
  return 0;
}
