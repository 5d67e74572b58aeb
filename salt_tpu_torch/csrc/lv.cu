// Banded, SNP-aware Landau-Vishkin edit distance for a batch of
// candidates (the aligner's gapped check), and its byte-wide form (the
// polish tool's re-scoring).
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
// The byte form (salt_lv_distance_bytes) is the same kernel with 8-bit
// elements, 4 a word: it computes lv_distance_plain with
// pat_precoded=True, text_words=False (= salt_tpu/ops/lv.py:lv_distance_batch
// as salt_tpu/polish/polish.py calls it, which is XLA there, not a TPU
// kernel).  The pattern rows are match codes used as they are (polish's
// run to 64, which no nibble holds), the reference is one byte a
// position, and the window byte at uint32 position p is ref[0] when p >=
// 2^31 (the plain version clips the int32 cast of p) and ref[min(p,
// n_ref - 1)] otherwise.  Match is still (p & t) != 0 and the guard still
// equality.  The element width is a template parameter: the nibble
// instantiations compile to what they were, the byte ones fold 8 bits to
// bit 0 of each byte, step 4 elements a word and build the window with
// four byte loads a word, each clamped on its own.  It is bound like the
// nibble form, by issue slots at a warp a candidate (k = 13 takes
// the 32-lane group); twice the words a read cost it a few more steps in
// every run search.
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

// Elements are kBits wide (4: one-hot nibbles; 8: match-code bytes),
// E = 32 / kBits a word, little-endian within the word.
template <int kBits>
struct Elem {
  static constexpr int E = 32 / kBits;
  static constexpr int kLog = kBits == 4 ? 3 : 2;       // log2(E)
  static constexpr int kBitLog = kBits == 4 ? 2 : 3;    // log2(kBits)
  static constexpr uint32_t kOne = kBits == 4 ? 0x11111111u : 0x01010101u;
  static constexpr uint32_t kMask = (1u << kBits) - 1u;
};

// E elements starting at element `at` of a word stream.
template <int kBits>
__device__ __forceinline__ uint32_t read_word(const uint32_t* s, int at) {
  using X = Elem<kBits>;
  const int w = at >> X::kLog;
  return __funnelshift_r(s[w], s[w + 1], (at & (X::E - 1)) * kBits);
}

template <int kBits>
__device__ __forceinline__ uint32_t element(const uint32_t* s, int at) {
  using X = Elem<kBits>;
  return (s[at >> X::kLog] >> ((at & (X::E - 1)) * kBits)) & X::kMask;
}

// Bit kBits * q set where pattern element i + q ANDs to zero with text
// element i + q + toff, q = 0..E-1.
template <int kBits>
__device__ __forceinline__ uint32_t miss_word(const uint32_t* P,
                                              const uint32_t* T, int i,
                                              int toff) {
  const uint32_t x = read_word<kBits>(P, i) & read_word<kBits>(T, i + toff);
  uint32_t t = x | (x >> 1);
  t = t | (t >> 2);
  if constexpr (kBits == 8) t = t | (t >> 4);
  t &= Elem<kBits>::kOne;
  return ~t & Elem<kBits>::kOne;
}

// First i >= r where pattern element i ANDs to zero with text element
// i + toff.  The pattern is zero from L on, so the result is <= L.
template <int kBits>
__device__ __forceinline__ int first_miss(const uint32_t* P, const uint32_t* T,
                                          int r, int toff) {
  using X = Elem<kBits>;
  for (int i = r;; i += X::E) {
    const uint32_t miss = miss_word<kBits>(P, T, i, toff);
    if (miss) return i + ((__ffs(miss) - 1) >> X::kBitLog);
  }
}

// first_miss(P, T, 0, toff) by a whole group: lane t looks at the E
// elements from E * t (then E * (t + G), ...), a ballot finds the first
// lane with a mismatch.  Every lane of the group gets the result.
template <int G, int kBits>
__device__ __forceinline__ int first_miss_group(const uint32_t* P,
                                                const uint32_t* T, int L,
                                                int toff, int t,
                                                unsigned mask) {
  using X = Elem<kBits>;
  const int lane0 = (threadIdx.x & 31) - t;  // the group's first lane
  for (int i0 = 0;; i0 += X::E * G) {
    const int i = i0 + X::E * t;
    const uint32_t miss = i <= L ? miss_word<kBits>(P, T, i, toff) : 0u;
    const unsigned vote = __ballot_sync(mask, miss != 0u) & mask;
    if (vote) {
      const int src = __ffs(vote) - 1;
      const uint32_t m = __shfl_sync(mask, miss, src);
      return i0 + X::E * (src - lane0) + ((__ffs(m) - 1) >> X::kBitLog);
    }
  }
}

// The low `n` elements of a word, 0 <= n <= E.
template <int kBits>
__device__ __forceinline__ uint32_t low_elements(int n) {
  return n >= Elem<kBits>::E ? 0xffffffffu : (1u << (kBits * n)) - 1u;
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
// kBits = 4: `ref` is uint32 words of 8 nibbles, n_ref words, `seq` holds
// base codes.  kBits = 8: `ref` is bytes, n_ref of them, `seq` holds match
// codes.
template <int G, int kPer, int kBits>
__global__ void __launch_bounds__(kThreads)
    lv_distance_kernel(const void* __restrict__ ref,
                       unsigned long long n_ref,
                       const long long* __restrict__ pos,
                       const uint8_t* __restrict__ active,
                       const uint8_t* __restrict__ seq, int n, int L, int TL,
                       int k, int nwp, int nwt, int stride,
                       int* __restrict__ out) {
  using X = Elem<kBits>;
  constexpr int E = X::E;
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

  // pattern, zero from L on: lane w packs word w (one-hot nibbles of the
  // base codes, or the match codes as they are)
  const uint8_t* s = seq + static_cast<size_t>(cand) * L;
  for (int w = t; w < nwp; w += G) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int i = w * E + q;
      if (i < L) {
        if constexpr (kBits == 4) {
          const uint32_t c = min(static_cast<uint32_t>(s[i]), 4u);
          word |= (c == 4u ? 15u : (1u << c)) << (4 * q);
        } else {
          word |= static_cast<uint32_t>(s[i]) << (8 * q);
        }
      }
    }
    P[w] = word;
  }

  // text window: T[j] = text[0] for j < k, text[j - k] for j < k + TL,
  // then zero.  Word w holds the E elements at uint32 positions
  // base - k + E * w + q.
  const uint32_t base = static_cast<uint32_t>(pos[cand]);
  const uint32_t start = base - static_cast<uint32_t>(k);
  uint32_t first;
  if constexpr (kBits == 4) {
    // a funnel shift of two reference words, each at its own wrapped and
    // clamped index
    const uint32_t* words = static_cast<const uint32_t*>(ref);
    auto word_at = [&](uint32_t nib_pos) -> uint32_t {
      return words[min(static_cast<unsigned long long>(nib_pos >> 3),
                       n_ref - 1)];
    };
    first = (word_at(base) >> ((base & 7u) * 4u)) & 15u;
    const int shift = static_cast<int>(start & 7u) * 4;
    for (int w0 = 0; w0 < nwt; w0 += G) {
      const int w = w0 + t;
      const uint32_t p = start + 8u * static_cast<uint32_t>(w);
      const uint32_t lo = word_at(p);
      uint32_t hi = __shfl_down_sync(mask, lo, 1, G);
      if (t == G - 1) hi = word_at(p + 8u);
      if (w < nwt) {
        uint32_t word = __funnelshift_r(lo, hi, shift);
        const uint32_t front = low_elements<4>(min(max(k - 8 * w, 0), 8));
        word = (word & ~front) | ((first * 0x11111111u) & front);
        word &= low_elements<4>(min(max(k + TL - 8 * w, 0), 8));
        T[w] = word;
      }
    }
  } else {
    // four byte loads a word, each position clipped on its own: 0 where
    // its int32 cast is negative, else at most the last byte
    const uint8_t* bytes = static_cast<const uint8_t*>(ref);
    auto byte_at = [&](uint32_t p) -> uint32_t {
      if (p & 0x80000000u) return bytes[0];
      return bytes[min(static_cast<unsigned long long>(p), n_ref - 1)];
    };
    first = byte_at(base);
    for (int w = t; w < nwt; w += G) {
      const uint32_t p = start + 4u * static_cast<uint32_t>(w);
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * w + q;           // element of the stream
        if (j >= k && j < k + TL) word |= byte_at(p + q) << (8 * q);
      }
      const uint32_t front = low_elements<8>(min(max(k - 4 * w, 0), 4));
      T[w] = word | ((first * 0x01010101u) & front);
    }
  }
  __syncwarp(mask);

  // phase 1: the run from (0, 0), all lanes on it together
  const int run0 = min(first_miss_group<G, kBits>(P, T, L, k, t, mask), L);
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
        if (element<kBits>(P, bc) == element<kBits>(T, bc + dd)) {
          r = min(first_miss<kBits>(P, T, bc, dd), min(L, TL - d));
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

template <int G, int kPer, int kBits>
int launch(const void* ref, unsigned long long n_ref, const long long* pos,
           const uint8_t* active, const uint8_t* seq, int n, int L, int TL,
           int k, int* out, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  constexpr int E = Elem<kBits>::E;
  const int nwp = L / E + 2;
  const int nwt = (L + 2 * k) / E + 2;
  // an odd stride spreads the groups of one warp over the banks
  const int stride = (nwp + nwt) | 1;
  const size_t smem = static_cast<size_t>(stride) * kGroups * 4;
  if (smem > 48 * 1024) {
    // long reads in bytes with many groups a block: ask for the room
    const cudaError_t err = cudaFuncSetAttribute(
        lv_distance_kernel<G, kPer, kBits>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + kGroups - 1) / kGroups;
  lv_distance_kernel<G, kPer, kBits><<<blocks, kThreads, smem, stream>>>(
      ref, n_ref, pos, active, seq, n, L, TL, k, nwp, nwt, stride, out);
  return static_cast<int>(cudaGetLastError());
}

// The lanes a candidate gets follow from k alone.
template <int kBits>
int launch_by_k(const void* ref, unsigned long long n_ref,
                const long long* pos, const uint8_t* active,
                const uint8_t* seq, int n, int L, int TL, int k, int* out,
                void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 0 || k > 30 || n_ref == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= 3) {
    return launch<8, 1, kBits>(ref, n_ref, pos, active, seq, n, L, TL, k, out, s);
  }
  if (k <= 7) {
    return launch<16, 1, kBits>(ref, n_ref, pos, active, seq, n, L, TL, k, out, s);
  }
  if (k <= 15) {
    return launch<32, 1, kBits>(ref, n_ref, pos, active, seq, n, L, TL, k, out, s);
  }
  return launch<32, 2, kBits>(ref, n_ref, pos, active, seq, n, L, TL, k, out, s);
}

}  // namespace

// Launches the kernel on `stream` for n candidates; returns the CUDA
// error code of the launch (0 on success).  words: uint32 [n_words];
// pos: int64 [n] (low 32 bits are the position); active: bool [n];
// seq: uint8 [n, L] base codes; out: int32 [n].  Requires 1 <= L <= 2047,
// TL >= L, 0 <= k <= 30.
extern "C" int salt_lv_distance(const uint32_t* words,
                                unsigned long long n_words,
                                const long long* pos, const uint8_t* active,
                                const uint8_t* seq, int n, int L, int TL,
                                int k, int* out, void* stream) {
  return launch_by_k<4>(words, n_words, pos, active, seq, n, L, TL, k, out,
                        stream);
}

// The byte form: ref: uint8 [n_ref], one match code a position; seq: uint8
// [n, L] match codes, used as they are.  Everything else as above.
extern "C" int salt_lv_distance_bytes(const uint8_t* ref,
                                      unsigned long long n_ref,
                                      const long long* pos,
                                      const uint8_t* active,
                                      const uint8_t* seq, int n, int L, int TL,
                                      int k, int* out, void* stream) {
  return launch_by_k<8>(ref, n_ref, pos, active, seq, n, L, TL, k, out,
                        stream);
}

extern "C" const char* salt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
