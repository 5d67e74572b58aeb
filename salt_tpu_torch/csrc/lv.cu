// Banded, SNP-aware Landau-Vishkin edit distance for a batch of
// candidates (the aligner's gapped check).
//
// Replaces the TPU kernel salt_tpu/ops/lv_pallas.py:_lv_tile_kernel
// (and its v2/v3 formulations, which differ only in TPU layout).  It
// computes exactly salt_tpu_torch/ops/lv.py:lv_distance_plain with
// text_words=True (= salt_tpu/ops/lv.py:lv_distance_batch):
//
//   * match(i, j) = (onehot(read[i]) & nibble(text[j])) != 0;
//   * the phase-1 run from (0, 0) uses AND-matching directly;
//   * an (e, d) cell extends its run only when the pattern and text
//     nibbles at its start are EQUAL (LandauVishkin.c:79);
//   * reaches are capped at endl_d = min(L, TL - d);
//   * the result is the smallest e <= k whose reach gets to L, else 255;
//     inactive candidates get 255.
//
// The text window of a candidate is the TL = L + window_pad nibbles at
// uint32 positions pos + t (wrapping mod 2^32), each read from word
// min((pos + t) >> 3, n_words - 1) of the 4-bit packed reference.  The
// diagonal walk reads the window at i + d for d in [-k, k]; i + d < 0
// reads nibble 0 and positions past the window read zero, as the plain
// version pads it.
//
// What bounds it on an H100: per candidate the kernel gathers about
// TL/8 + 1 words of the reference at a data-dependent address plus its L
// read bytes, and walks (d + 1)^2 band cells for a distance d.  At the
// aligner's shapes (N = 8,192-16,384 candidates, L = 100, k = 10) that is
// a microsecond of int32 work for the whole card, less than a launch
// that does nothing, so no design gets near it.  The first design gave a
// candidate one thread, which packed the read a byte at a time, built the
// window a nibble at a time and walked up to (k + 1)^2 cells in a row with
// reach[] in local memory: 0.051 ms a call whatever N, one thread's
// chain, with 3-6% of the card's thread slots filled.
//
// Design: one lane per diagonal.  Within one e every band cell reads only
// reaches of e - 1, so the cells of a step are independent.  A candidate
// gets a group of G lanes of one warp (8 for k <= 3, 16 for k <= 7, 32
// above; for k > 15 each lane holds two neighbouring diagonals), lane =
// diagonal, its reach in a register.  A step takes the neighbours' reaches
// by __shfl_up_sync / __shfl_down_sync (kNeg outside the band and past the
// last diagonal, as reach[] had it), forms the best start, applies the
// equality guard and one first-mismatch search on the lane's own diagonal,
// and ends the walk for the whole group with __any_sync as soon as one
// in-band reach gets to L: that e is the smallest.  The chain falls from
// (k + 1)^2 cells to k steps.  The group also does the set-up: lane w
// loads the 8 read bytes of pattern word w and packs it, and lane w loads
// one reference word and takes its upper neighbour's word by shuffle, so
// that window word w is one funnel shift (the word stream starts at
// nibble pos - k, the k nibbles before the window are overwritten with
// window nibble 0, those past k + TL with zero).  The word index of each
// of the two words is wrapped and clamped on its own, which gives every
// nibble the word min(p >> 3, n_words - 1) and the offset p & 7 of its own
// position p: the same nibbles as one load a nibble, at the clamped end of
// the reference and across the wrap at 2^32 as well.  Pattern and window
// are nibble words in shared memory, a few hundred bytes a group.  The
// first mismatch from a reach r is found 8 nibbles at a time: AND the two
// funnel-shifted words, fold each nibble's bits to its bit 0
// (x | x>>1 | x>>2 | x>>3, masked with 0x11111111) and take __ffs of the
// complement.  The run from (0, 0), which is the whole read for a
// candidate at distance 0, is searched by all lanes at once, 8 nibbles a
// lane and one ballot.  Groups that share a warp name only their own lanes in
// every shuffle and vote, so each leaves as soon as it is done.
//
// With a warp a candidate the call is no longer one chain but the card's
// instruction throughput: the time doubles from N = 8,192 to 16,384 (0.012 and
// 0.020 ms on an H100 at 700 W), most of a step's lanes lie outside the
// band, and candidates that reach k without aligning cost the most.  Two
// diagonals a lane on half the lanes measured slower at k = 10 (0.015
// ms): the two cells of a lane run one after the other.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBig = 255;
constexpr int kNeg = -2;
constexpr int kThreads = 128;

// 8 nibbles starting at nibble `nib` of a word stream.
__device__ __forceinline__ uint32_t read8(const uint32_t* s, int nib) {
  const int w = nib >> 3;
  return __funnelshift_r(s[w], s[w + 1], (nib & 7) * 4);
}

__device__ __forceinline__ uint32_t nibble(const uint32_t* s, int nib) {
  return (s[nib >> 3] >> ((nib & 7) * 4)) & 15u;
}

// Bit 4q set where pattern nibble i + q ANDs to zero with text nibble
// i + q + toff, q = 0..7.
__device__ __forceinline__ uint32_t miss8(const uint32_t* P, const uint32_t* T,
                                          int i, int toff) {
  const uint32_t x = read8(P, i) & read8(T, i + toff);
  uint32_t t = x | (x >> 1);
  t = (t | (t >> 2)) & 0x11111111u;
  return ~t & 0x11111111u;
}

// First i >= r where pattern nibble i ANDs to zero with text nibble
// i + toff.  The pattern is zero from L on, so the result is <= L.
__device__ __forceinline__ int first_miss(const uint32_t* P, const uint32_t* T,
                                          int r, int toff) {
  for (int i = r;; i += 8) {
    const uint32_t miss = miss8(P, T, i, toff);
    if (miss) return i + ((__ffs(miss) - 1) >> 2);
  }
}

// first_miss(P, T, 0, toff) by a whole group: lane t looks at the 8
// nibbles from 8t (then 8(t + G), ...), a ballot finds the first lane with
// a mismatch.  Every lane of the group gets the result.
template <int G>
__device__ __forceinline__ int first_miss_group(const uint32_t* P,
                                                const uint32_t* T, int L,
                                                int toff, int t,
                                                unsigned mask) {
  const int lane0 = (threadIdx.x & 31) - t;  // the group's first lane
  for (int i0 = 0;; i0 += 8 * G) {
    const int i = i0 + 8 * t;
    const uint32_t miss = i <= L ? miss8(P, T, i, toff) : 0u;
    const unsigned vote = __ballot_sync(mask, miss != 0u) & mask;
    if (vote) {
      const int src = __ffs(vote) - 1;
      const uint32_t m = __shfl_sync(mask, miss, src);
      return i0 + 8 * (src - lane0) + ((__ffs(m) - 1) >> 2);
    }
  }
}

// The low `n` nibbles of a word, 0 <= n <= 8.
__device__ __forceinline__ uint32_t low_nibbles(int n) {
  return n >= 8 ? 0xffffffffu : (1u << (4 * n)) - 1u;
}

// The lanes of this thread's group of G within its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) / G * G);
  }
}

// G lanes a candidate, kPer diagonals a lane: diagonal dd = t * kPer + i.
template <int G, int kPer>
__global__ void __launch_bounds__(kThreads)
    lv_distance_kernel(const uint32_t* __restrict__ words,
                       unsigned long long n_words,
                       const long long* __restrict__ pos,
                       const uint8_t* __restrict__ active,
                       const uint8_t* __restrict__ seq, int n, int L, int TL,
                       int k, int nwp, int nwt, int stride,
                       int* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  constexpr int kGroups = kThreads / G;
  const int group = threadIdx.x / G;
  const int t = threadIdx.x % G;
  const int cand = blockIdx.x * kGroups + group;
  // a group's lanes leave together, and every shuffle and vote below
  // names the group's own lanes only
  if (cand >= n) return;
  if (!active[cand]) {
    if (t == 0) out[cand] = kBig;
    return;
  }
  const unsigned mask = group_mask<G>();
  uint32_t* P = smem + group * stride;
  uint32_t* T = P + nwp;

  // one-hot pattern, zero from L on: lane w packs word w
  const uint8_t* s = seq + static_cast<size_t>(cand) * L;
  for (int w = t; w < nwp; w += G) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = w * 8 + q;
      if (i < L) {
        const uint32_t c = min(static_cast<uint32_t>(s[i]), 4u);
        word |= (c == 4u ? 15u : (1u << c)) << (4 * q);
      }
    }
    P[w] = word;
  }

  // text window: T[j] = text[0] for j < k, text[j - k] for j < k + TL,
  // then zero.  Word w holds the 8 nibbles at uint32 positions
  // base - k + 8w + q: a funnel shift of two reference words, each at its
  // own wrapped and clamped index.
  const uint32_t base = static_cast<uint32_t>(pos[cand]);
  auto word_at = [&](uint32_t nib_pos) -> uint32_t {
    return words[min(static_cast<unsigned long long>(nib_pos >> 3),
                     n_words - 1)];
  };
  const uint32_t first = (word_at(base) >> ((base & 7u) * 4u)) & 15u;
  const uint32_t start = base - static_cast<uint32_t>(k);
  const int shift = static_cast<int>(start & 7u) * 4;
  for (int w0 = 0; w0 < nwt; w0 += G) {
    const int w = w0 + t;
    const uint32_t p = start + 8u * static_cast<uint32_t>(w);
    const uint32_t lo = word_at(p);
    uint32_t hi = __shfl_down_sync(mask, lo, 1, G);
    if (t == G - 1) hi = word_at(p + 8u);
    if (w < nwt) {
      uint32_t word = __funnelshift_r(lo, hi, shift);
      const uint32_t front = low_nibbles(min(max(k - 8 * w, 0), 8));
      word = (word & ~front) | ((first * 0x11111111u) & front);
      word &= low_nibbles(min(max(k + TL - 8 * w, 0), 8));
      T[w] = word;
    }
  }
  __syncwarp(mask);

  // phase 1: the run from (0, 0), all lanes on it together
  const int run0 = min(first_miss_group<G>(P, T, L, k, t, mask), L);
  if (run0 >= L) {
    if (t == 0) out[cand] = 0;
    return;
  }
  const int D = 2 * k + 1;
  int reach[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) reach[i] = t * kPer + i == k ? run0 : kNeg;

  for (int e = 1; e <= k; ++e) {
    // reaches of e - 1 on the diagonals next to this lane's
    int below = __shfl_up_sync(mask, reach[kPer - 1], 1, G);
    int above = __shfl_down_sync(mask, reach[0], 1, G);
    if (t == 0) below = kNeg;
    if (t == G - 1) above = kNeg;
    int next[kPer];
    bool done = false;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int dd = t * kPer + i;
      const int d = dd - k;
      const int cur = reach[i];
      const int prev = i == 0 ? below : reach[i - 1];
      const int up = i == kPer - 1 ? above : reach[i + 1];
      const int right = dd + 1 < D ? up + 1 : kNeg;
      const bool in_band = d >= -e && d <= e;
      const int best = max(max(cur + 1, prev), right);
      int r = best;
      if (in_band && best >= 0) {
        const int bc = min(best, L);
        if (nibble(P, bc) == nibble(T, bc + dd)) {
          r = min(first_miss(P, T, bc, dd), min(L, TL - d));
        }
      }
      next[i] = in_band ? r : cur;
      done |= in_band && r >= L;
    }
    if (__any_sync(mask, done)) {
      if (t == 0) out[cand] = e;
      return;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) reach[i] = next[i];
  }
  if (t == 0) out[cand] = kBig;
}

template <int G, int kPer>
int launch(const uint32_t* words, unsigned long long n_words,
           const long long* pos, const uint8_t* active, const uint8_t* seq,
           int n, int L, int TL, int k, int* out, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const int nwp = L / 8 + 2;
  const int nwt = (L + 2 * k) / 8 + 2;
  // an odd stride spreads the groups of one warp over the banks
  const int stride = (nwp + nwt) | 1;
  const size_t smem = static_cast<size_t>(stride) * kGroups * 4;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kGroups - 1) / kGroups;
  lv_distance_kernel<G, kPer><<<blocks, kThreads, smem, stream>>>(
      words, n_words, pos, active, seq, n, L, TL, k, nwp, nwt, stride, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` for n candidates; returns the CUDA
// error code of the launch (0 on success).  words: uint32 [n_words];
// pos: int64 [n] (low 32 bits are the position); active: bool [n];
// seq: uint8 [n, L] base codes; out: int32 [n].  Requires 1 <= L <= 2047,
// TL >= L, 0 <= k <= 30.  The lanes a candidate gets follow from k alone.
extern "C" int salt_lv_distance(const uint32_t* words,
                                unsigned long long n_words,
                                const long long* pos, const uint8_t* active,
                                const uint8_t* seq, int n, int L, int TL,
                                int k, int* out, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 0 || k > 30) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 3) {
    return launch<8, 1>(words, n_words, pos, active, seq, n, L, TL, k, out, s);
  }
  if (k <= 7) {
    return launch<16, 1>(words, n_words, pos, active, seq, n, L, TL, k, out, s);
  }
  if (k <= 15) {
    return launch<32, 1>(words, n_words, pos, active, seq, n, L, TL, k, out, s);
  }
  return launch<32, 2>(words, n_words, pos, active, seq, n, L, TL, k, out, s);
}

extern "C" const char* salt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
