// The sampled-mode locate walk (K4): for every lane of a block of candidate
// slots, the bounded LF walk from its rank to a flagged stop rank, and the
// coordinate read there, in one launch.
//
// Replaces no TPU kernel: salt_tpu writes the walk in XLA
// (salt_tpu/ops/locate.py:resolve_sampled), and the port's plain version,
// salt_tpu_torch/ops/locate.py:resolve_sampled_plain, runs it as eager
// PyTorch: max(intv, max_r_walk) + 1 trips over every lane, a few dozen
// small operations on (B, n) int64 tensors each, some 900 launches for one
// 8,192 x 128 block.  This kernel computes exactly that function, bit for
// bit, on every lane:
//
//   * k = umin(rank, bound), bound = n - 1 of the lane's family (C or R);
//     rank is a uint32 carried in int64 (as wrapped int32): its low 32 bits
//     are the rank;
//   * a lane is done where the stop bit of rank k is set: bit k & 31 of the
//     word of select row ((k >> 5) + seloff), seloff = c_sel_rows for R;
//     an inactive lane is done from the start and takes no step;
//   * a step reads symbol sym = 4 bits (k & 7) of word (k >> 3) + woff of
//     syms_cat (woff = c_words for R), then the rank row row_off +
//     min(sym, 4 | 5) * n_words + (iu >> 5) of the family's planes, iu =
//     min(k, n & U32), and goes to k' = umin(cfreq[min(sym, 5 | 6)] + count
//     + 1, bound): the sum wraps mod 2^32 before the minimum;
//   * at most `trips` steps; then slot = excl + popcount(bits below k & 31)
//     + sampoff (c_n_samples for R) of rank k's select row, and the result
//     is (samples_cat[slot] + steps) mod 2^32, or UINT32_MAX for an active
//     lane at rank 0 and for an R lane that took no step on a '#' rank
//     (sharp_lo <= int32(k) < sharp_hi);
//   * every index into a table is clamped to the table, as ops/uint.take
//     clamps it; both families' cfreq indexes too.
//
// What bounds it on an H100: latency.  A lane is a chain of dependent
// random 8- and 4-byte loads into tables of tens of MB (a chr21 index's
// planes and select rows) that mostly miss in L2, some 3 to 4 steps a lane
// on average at intv = 8.  The design keeps loads in flight:
//
//   * one thread a lane, 256 threads a block: an 8,192 x 128 block of the
//     aligner is 4,096 blocks, about four waves of 8 blocks an SM over 132
//     SMs; the walk's state is one 32-bit rank and a step count, so
//     registers do not limit the warps that wait at once;
//   * each step issues the select row and the symbol word of the current
//     rank together (both depend on k alone), then the rank row that
//     depends on the symbol: two dependent loads a step, not three;
//   * a lane leaves its loop when done (the plain version freezes done
//     lanes, which gives the same values); a warp's lanes are 32
//     neighbouring slots of one read;
//   * each block keeps both families' C-arrays (at most 16 values each) in
//     shared memory.
//
// The launch does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCfreq = 16;  // cfreq entries a family (n_sym + 1)

struct Family {
  const int2* bc;      // the plane tensor this family's rows are in
  long long n_rows;    // its rows: every row index is clamped to them
  long long row_off;   // the family's first row
  long long n_words;   // rows a plane
  const long long* cfreq;
  int n_cfreq;         // n_sym + 1
};

struct Tables {
  const int2* sel;       // (count of stops before the word, stop bits)
  long long n_sel;
  const unsigned* samples;
  long long n_samples;
  const unsigned* syms;  // 8 BWT symbols of 4 bits a word
  long long n_syms;
  long long c_words, c_sel_rows, c_n_samples;  // the R part's offsets
  long long sharp_lo, sharp_hi;                // the '#' ranks of R
  // each family's symbols n (low 32 bits) and its bound n - 1
  unsigned c_n, r_n, c_bound, r_bound;
  int trips;
};

__device__ __forceinline__ long long clamp_ll(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

__device__ __forceinline__ int2 sel_row(const Tables& t, unsigned k,
                                        long long seloff) {
  return __ldg(t.sel + clamp_ll(static_cast<long long>(k >> 5) + seloff,
                                t.n_sel - 1));
}

__device__ __forceinline__ unsigned sym_word(const Tables& t, unsigned k,
                                             long long woff) {
  return __ldg(t.syms + clamp_ll(static_cast<long long>(k >> 3) + woff,
                                 t.n_syms - 1));
}

__device__ __forceinline__ bool stop_bit(int2 row, unsigned k) {
  return (static_cast<unsigned>(row.y) >> (k & 31u)) & 1u;
}

// The set bits of a row's word below bit k & 31, added to its count.
__device__ __forceinline__ long long count_below(int2 row, unsigned k) {
  const unsigned mask = (1u << (k & 31u)) - 1u;
  return static_cast<long long>(row.x) +
         __popc(static_cast<unsigned>(row.y) & mask);
}

__global__ void __launch_bounds__(kThreads)
    sa_walk_kernel(const long long* rank, const uint8_t* is_r,
                   const uint8_t* active, long long n_lanes, Tables t,
                   Family fc, Family fr, long long* out) {
  __shared__ long long cf[2][kMaxCfreq];
  for (int i = threadIdx.x; i < 2 * kMaxCfreq; i += blockDim.x) {
    // pick the values, not a reference to one of the two parameters,
    // which would copy both to the stack
    const int f = i / kMaxCfreq, j = i % kMaxCfreq;
    const long long* cfreq = f ? fr.cfreq : fc.cfreq;
    cf[f][j] = j < (f ? fr.n_cfreq : fc.n_cfreq) ? cfreq[j] : 0;
  }
  __syncthreads();

  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const int r = is_r[i] ? 1 : 0;
  const bool on = active[i] != 0;
  // selects of scalars: an index into a parameter would copy it to the
  // stack
  const unsigned bound = r ? t.r_bound : t.c_bound;
  const long long woff = r ? t.c_words : 0;
  const long long seloff = r ? t.c_sel_rows : 0;
  unsigned k = min(static_cast<unsigned>(rank[i]), bound);
  const bool at_sentinel = on && k == 0;

  int2 sel = sel_row(t, k, seloff);
  int steps = 0;
  if (on) {
    const int2* bc = r ? fr.bc : fc.bc;
    const long long last_row = (r ? fr.n_rows : fc.n_rows) - 1;
    const long long row_off = r ? fr.row_off : fc.row_off;
    const long long n_words = r ? fr.n_words : fc.n_words;
    const long long cmax = (r ? fr.n_cfreq : fc.n_cfreq) - 1;
    const unsigned n = r ? t.r_n : t.c_n;
    // the symbol clamps of the plain version: rank planes, C-array
    const unsigned rank_sym = r ? 5u : 4u, cfreq_sym = r ? 6u : 5u;
    unsigned word = sym_word(t, k, woff);
    while (steps < t.trips && !stop_bit(sel, k)) {
      const unsigned sym = (word >> ((k & 7u) * 4u)) & 15u;
      const unsigned iu = min(k, n);
      const long long row = row_off +
                            static_cast<long long>(min(sym, rank_sym)) *
                                n_words +
                            static_cast<long long>(iu >> 5);
      const int2 rk = __ldg(bc + clamp_ll(row, last_row));
      const long long base =
          cf[r][clamp_ll(static_cast<long long>(min(sym, cfreq_sym)), cmax)];
      // the sum wraps mod 2^32 before the minimum
      k = min(static_cast<unsigned>(base + count_below(rk, iu) + 1), bound);
      ++steps;
      sel = sel_row(t, k, seloff);
      word = sym_word(t, k, woff);
    }
  }

  const long long slot = count_below(sel, k) + (r ? t.c_n_samples : 0);
  const unsigned val = __ldg(t.samples + clamp_ll(slot, t.n_samples - 1));
  const long long ks = static_cast<int>(k);  // the plain version's int32
  const bool on_sharp = ks >= t.sharp_lo && ks < t.sharp_hi;
  out[i] = at_sentinel || (r && steps == 0 && on_sharp)
               ? 0xFFFFFFFFLL
               : static_cast<long long>(val + static_cast<unsigned>(steps));
}

}  // namespace

// Launches the kernel on `stream` over n_lanes lanes; returns the CUDA
// error code of the launch (0 on success).  rank: int64 [n_lanes] (uint32
// in the low bits); is_r, active: uint8 [n_lanes] (0 or 1); out: int64
// [n_lanes].  The sampled tables: sel int32 [n_sel, 2], samples and syms
// int32 [n_samples], [n_syms] holding uint32 bits, with the R part's
// offsets c_words, c_sel_rows and c_n_samples and its '#' ranks [sharp_lo,
// sharp_hi).  A family's rank rows: int32 [*_n_rows, 2] at *_bc, its planes
// from row *_row_off, *_n_words rows a plane, *_n symbols (low 32 bits);
// its cfreq: int64 [*_n_cfreq], 1 <= *_n_cfreq <= 16.  trips: the most
// steps a lane takes.  Every table holds at least one entry.
extern "C" int salt_sa_walk(
    const long long* rank, const uint8_t* is_r, const uint8_t* active,
    long long n_lanes, const int* sel, long long n_sel, const int* samples,
    long long n_samples, const int* syms, long long n_syms, long long c_words,
    long long c_sel_rows, long long c_n_samples, long long sharp_lo,
    long long sharp_hi, int trips,
    const int* c_bc, long long c_n_rows, long long c_row_off,
    long long c_n_words, const long long* c_cfreq, int c_n_cfreq,
    const int* r_bc, long long r_n_rows, long long r_row_off,
    long long r_n_words, const long long* r_cfreq, int r_n_cfreq,
    long long c_n, long long r_n, long long* out, void* stream) {
  if (n_lanes == 0) return 0;
  Tables t{reinterpret_cast<const int2*>(sel),
           n_sel,
           reinterpret_cast<const unsigned*>(samples),
           n_samples,
           reinterpret_cast<const unsigned*>(syms),
           n_syms,
           c_words,
           c_sel_rows,
           c_n_samples,
           sharp_lo,
           sharp_hi,
           static_cast<unsigned>(c_n),
           static_cast<unsigned>(r_n),
           static_cast<unsigned>(c_n - 1),
           static_cast<unsigned>(r_n - 1),
           trips};
  const Family fc{reinterpret_cast<const int2*>(c_bc), c_n_rows, c_row_off,
                  c_n_words, c_cfreq, c_n_cfreq};
  const Family fr{reinterpret_cast<const int2*>(r_bc), r_n_rows, r_row_off,
                  r_n_words, r_cfreq, r_n_cfreq};
  const long long blocks = (n_lanes + kThreads - 1) / kThreads;
  sa_walk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      rank, is_r, active, n_lanes, t, fc, fr, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* salt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
