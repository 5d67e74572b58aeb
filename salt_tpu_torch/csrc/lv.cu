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
// Design: one thread per candidate.  The thread packs its read's one-hot
// pattern and its text window (with k copies of nibble 0 in front) into
// nibble words in dynamic shared memory, laid out word-major across the
// block (word w of thread t at [w * blockDim + t]), so any per-thread
// word index is bank-conflict free.  The first mismatch from a reach r is
// found 8 nibbles at a time: AND the two funnel-shifted words, fold each
// nibble's bits to its bit 0 (x | x>>1 | x>>2 | x>>3, masked with
// 0x11111111) and take __ffs of the complement.
//
// What bounds it on an H100: per candidate the kernel gathers about
// TL/8 + 1 words (4 bytes each) of the reference at a data-dependent
// address, plus its L read bytes, then walks up to k(k+1) band cells
// serially, each a few shared-memory word reads.  At the aligner's shapes
// (N = 2 * gap_batch * u = 8,192-16,384 candidates, L = 100, k = 10) one
// thread per candidate fills only about one 128-thread block per SM, so
// a call lasts one thread's serial walk: latency bounds it, not bandwidth
// or arithmetic.  The design keeps that walk short -- one step per 8
// matching bases in the word-wide mismatch search, one global load per 8
// window nibbles through a cached last word -- and leaves spreading a
// candidate over several threads to later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBig = 255;
constexpr int kNeg = -2;
constexpr int kMaxDiagonals = 61;  // 2 * (LV_MAX_K - 1) + 1

// 8 nibbles starting at nibble `nib` of a word stream with stride `st`.
__device__ __forceinline__ uint32_t read8(const uint32_t* s, int st, int nib) {
  const int w = nib >> 3;
  return __funnelshift_r(s[w * st], s[(w + 1) * st], (nib & 7) * 4);
}

__device__ __forceinline__ uint32_t nibble(const uint32_t* s, int st, int nib) {
  return (s[(nib >> 3) * st] >> ((nib & 7) * 4)) & 15u;
}

// First i >= r where pattern nibble i ANDs to zero with text nibble
// i + toff.  The pattern is zero from L on, so the result is <= L.
__device__ __forceinline__ int first_miss(const uint32_t* P, const uint32_t* T,
                                          int st, int r, int toff) {
  for (int i = r;; i += 8) {
    const uint32_t x = read8(P, st, i) & read8(T, st, i + toff);
    uint32_t t = x | (x >> 1);
    t = (t | (t >> 2)) & 0x11111111u;
    const uint32_t miss = ~t & 0x11111111u;
    if (miss) return i + ((__ffs(miss) - 1) >> 2);
  }
}

__global__ void lv_distance_kernel(const uint32_t* __restrict__ words,
                                   unsigned long long n_words,
                                   const long long* __restrict__ pos,
                                   const uint8_t* __restrict__ active,
                                   const uint8_t* __restrict__ seq, int n,
                                   int L, int TL, int k, int nwp, int nwt,
                                   int* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int cand = blockIdx.x * blockDim.x + threadIdx.x;
  if (cand >= n) return;
  if (!active[cand]) {
    out[cand] = kBig;
    return;
  }
  const int st = blockDim.x;
  uint32_t* P = smem + threadIdx.x;
  uint32_t* T = smem + nwp * st + threadIdx.x;

  // one-hot pattern, zero from L on
  const uint8_t* s = seq + static_cast<size_t>(cand) * L;
  for (int w = 0; w < nwp; ++w) {
    uint32_t word = 0;
    for (int q = 0; q < 8; ++q) {
      const int i = w * 8 + q;
      if (i < L) {
        const uint32_t c = min(static_cast<uint32_t>(s[i]), 4u);
        word |= (c == 4u ? 15u : (1u << c)) << (4 * q);
      }
    }
    P[w * st] = word;
  }

  // text window: T[j] = text[0] for j < k, text[j - k] for j < k + TL,
  // then zero
  const uint32_t base = static_cast<uint32_t>(pos[cand]);
  unsigned long long cached_w = ~0ull;
  uint32_t cached = 0;
  auto text_nib = [&](uint32_t t) -> uint32_t {
    const uint32_t p = base + t;
    const unsigned long long w = min(static_cast<unsigned long long>(p >> 3),
                                     n_words - 1);
    if (w != cached_w) {
      cached = words[w];
      cached_w = w;
    }
    return (cached >> ((p & 7u) * 4u)) & 15u;
  };
  const uint32_t first = text_nib(0);
  for (int w = 0; w < nwt; ++w) {
    uint32_t word = 0;
    for (int q = 0; q < 8; ++q) {
      const int j = w * 8 + q;
      const uint32_t v = j < k ? first : (j < k + TL ? text_nib(j - k) : 0u);
      word |= v << (4 * q);
    }
    T[w * st] = word;
  }

  // phase 1: the run from (0, 0)
  const int run0 = min(first_miss(P, T, st, 0, k), L);
  if (run0 >= L) {
    out[cand] = 0;
    return;
  }
  int reach[kMaxDiagonals];
  const int D = 2 * k + 1;
  for (int dd = 0; dd < D; ++dd) reach[dd] = kNeg;
  reach[k] = run0;

  for (int e = 1; e <= k; ++e) {
    int prev = kNeg;  // reach of diagonal dd - 1 at e - 1
    for (int dd = k - e; dd <= k + e; ++dd) {
      const int d = dd - k;
      const int cur = reach[dd];
      const int right = dd + 1 < D ? reach[dd + 1] + 1 : kNeg;
      const int best = max(max(cur + 1, prev), right);
      const int bc = min(max(best, 0), L);
      int r = best;
      if (best >= 0 && nibble(P, st, bc) == nibble(T, st, bc + dd)) {
        r = min(first_miss(P, T, st, bc, dd), min(L, TL - d));
      }
      if (r >= L) {
        out[cand] = e;
        return;
      }
      prev = cur;
      reach[dd] = r;
    }
  }
  out[cand] = kBig;
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
  if (n == 0) return 0;
  const int nwp = L / 8 + 2;
  const int nwt = (L + 2 * k) / 8 + 2;
  const size_t per_thread = static_cast<size_t>(nwp + nwt) * 4;
  int threads = 128;
  while (threads > 32 && per_thread * threads > 100 * 1024) threads /= 2;
  const size_t smem = per_thread * threads;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lv_distance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + threads - 1) / threads;
  lv_distance_kernel<<<blocks, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      words, n_words, pos, active, seq, n, L, TL, k, nwp, nwt, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* salt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
