// Overlap seeding of a batch of reads (K3): for every seed start of every
// row, the 12-mer jump, the masked LF steps and the greedy left extension
// of both families, in one launch.
//
// Replaces no TPU kernel: salt_tpu writes seeding in XLA
// (salt_tpu/ops/seed.py:seed_overlap), and the port's plain version,
// salt_tpu_torch/ops/seed.py:seed_overlap_plain, runs it as eager PyTorch:
// some ten small operations for each LF step and family, and an extension
// loop that reads `any(active)` back to the host once a round.  This
// kernel computes exactly that function, bit for bit:
//
//   * the 12-mer of a seed's last l_lkt bases (codes > 3 count as 0 and
//     make has_n) jumps to sp0 = int32(lkt[kmer]), ep0 = int32(lkt[kmer +
//     1]) - 1 (C) and to int32(r_lkt_sp[kmer]), int32(r_lkt_ep[kmer]) (R),
//     (1, 0) when has_n; every table index is clamped to its table;
//   * the l_seed - l_lkt LF steps, last base first (all l_seed of them
//     from (0, n) for R without jump tables): a code > 3 kills the lane,
//     else c' = C[c] + rank(k, c) + 1, l' = C[c] + rank(l + 1, c), and the
//     lane dies when c' > l' unsigned; a dead lane keeps its interval and
//     never comes back;
//   * the extension, while (l - k) > max_seed (low 32 bits, unsigned) and
//     l_ext < p: one more base to the left, taken when rank(k) + 1 <=
//     rank(l + 1) (int64) and, for C only, its code is <= 3;
//   * rank(idx, c) reads row row_off + c * n_words + ((idx & U32) >> 5) of
//     the plane tensor the family's index lives in, clamped to that whole
//     tensor (both families' rows when they share one), and adds to the
//     int32 count of the row the set bits of its word below bit idx & 31;
//     C[c] reads cfreq[min(max(c, 0), n_sym)].
//
// What bounds it on an H100: not bytes and not operations.  A seed is a
// chain of dependent random 8-byte row loads, l_seed - l_lkt LF steps and
// up to p extension rounds, into plane tables of tens of MB (the 12-mer
// table alone is 4^12 x 4 B = 67 MB) that mostly miss in L2, so each step
// waits on device memory.  The design is about keeping loads in flight:
//
//   * one thread a (row, seed start), 64 threads a block: the aligner's
//     8,192 rows x 4 starts are 512 blocks over 132 SMs, and l_overlap =
//     1 (80 starts) fills the card many times over;
//   * one thread runs both families' chains, interleaved: a step issues
//     the k and l + 1 rows of C and of R together (four independent
//     8-byte __ldg loads), the two 12-mer jumps load their four table
//     words together, and the extension rounds of the two families run
//     in the same loop (each with its own l_ext), so one wait serves both;
//   * dead lanes issue no loads, so a repeat-free batch leaves early;
//   * each block keeps the two C-arrays (at most 16 values a family) in
//     shared memory, and the codes of a row are read from device memory
//     where the steps need them (the row stays in L1).
//
// The launch does not synchronise: the extension round count never
// reaches the host.  On an H100 at 700 W, over a 4,000,000-base
// repeat-rich index, a launch takes 0.032 ms at 8,192 rows x 4 starts
// and 0.107 ms at 8,192 x 80, where the plain version spends 135-190 and
// 190-370 ms of host time; what the aligner saves is that host time, its
// launches and its read-backs, not device time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxCfreq = 16;  // cfreq entries a family (n_sym + 1)

// seed_only_ref: R gives (1, 0, 0, false); R jump tables; R from (0, n)
// over all l_seed bases.
enum Mode : int { kRJump = 0, kRFull = 1, kSeedOnlyRef = 2 };

struct Family {
  const int2* bc;      // the plane tensor this family's rows are in
  long long n_rows;    // its rows: every row index is clamped to them
  long long row_off;   // the family's first row
  long long n_words;   // rows a plane
  const long long* cfreq;
  int n_cfreq;         // n_sym + 1
};

struct Args {
  const long long* seq;  // (R, L) codes
  int n_rows, L, S, l_seed, l_overlap, l_lkt, mode;
  unsigned max_seed;     // max_seed & U32
  long long n_r;         // symbols of the R index (its start interval)
  const int* lkt;
  long long n_lkt;
  const int* r_lkt_sp;
  long long n_r_lkt_sp;
  const int* r_lkt_ep;
  long long n_r_lkt_ep;
  long long* out[6];     // C sp, ep, offset; R sp, ep, offset
  uint8_t* valid[2];     // C, R
};

__device__ __forceinline__ long long clamp_ll(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// The unsigned 32-bit comparison of ops/uint.py:ugt.
__device__ __forceinline__ bool ugt(long long a, long long b) {
  return static_cast<unsigned>(a) > static_cast<unsigned>(b);
}

// The rank row of (idx, c): int64 arithmetic wraps as the plain version's.
__device__ __forceinline__ int2 rank_row(const Family& f, long long idx,
                                         long long c) {
  const unsigned long long row =
      static_cast<unsigned long long>(f.row_off) +
      static_cast<unsigned long long>(c) *
          static_cast<unsigned long long>(f.n_words) +
      (static_cast<unsigned>(idx) >> 5);
  return __ldg(f.bc + clamp_ll(static_cast<long long>(row), f.n_rows - 1));
}

__device__ __forceinline__ long long rank_of(int2 row, long long idx) {
  const unsigned mask = (1u << (static_cast<unsigned>(idx) & 31u)) - 1u;
  return static_cast<long long>(row.x) +
         __popc(static_cast<unsigned>(row.y) & mask);
}

__device__ __forceinline__ long long table(const int* t, long long n,
                                           long long i) {
  return static_cast<long long>(__ldg(t + clamp_ll(i, n - 1)));
}

// One family's interval and state through the steps.
struct Lane {
  long long k, l;
  bool alive;
};

// One LF step of a live lane on code c (0 <= c <= 3 or a negative code,
// as the plain version passes it), from the two rows loaded for it.
__device__ __forceinline__ void lf_apply(Lane& s, int2 rk, int2 rl,
                                         long long base) {
  const long long kn = base + rank_of(rk, s.k) + 1;
  const long long ln = base + rank_of(rl, s.l + 1);
  if (ugt(kn, ln)) {
    s.alive = false;
  } else {
    s.k = kn;
    s.l = ln;
  }
}

struct Ext {
  long long k, l, ext;
  bool active;
};

__global__ void __launch_bounds__(kThreads)
    seed_overlap_kernel(Args a, Family fc, Family fr) {
  __shared__ long long cf[2][kMaxCfreq];
  for (int i = threadIdx.x; i < 2 * kMaxCfreq; i += blockDim.x) {
    // pick the values, not a reference to one of the two parameters,
    // which would copy both to the stack
    const int f = i / kMaxCfreq, j = i % kMaxCfreq;
    const long long* cfreq = f ? fr.cfreq : fc.cfreq;
    cf[f][j] = j < (f ? fr.n_cfreq : fc.n_cfreq) ? cfreq[j] : 0;
  }
  __syncthreads();

  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(a.n_rows) * a.S) return;
  const long long* q = a.seq + (t / a.S) * a.L;
  const long long p = (t % a.S) * static_cast<long long>(a.l_overlap);
  const long long* w = q + p;  // the seed window, w[0 .. l_seed - 1]
  const int n_lf = a.l_seed - a.l_lkt;
  const bool two = a.mode != kSeedOnlyRef;
  const bool r_jump = a.mode == kRJump;
  const long long cmax = fc.n_cfreq - 1, rmax = fr.n_cfreq - 1;

  // ---- the 12-mer jump ----
  bool has_n = false;
  unsigned long long kmer = 0;
  for (int j = n_lf; j < a.l_seed; ++j) {
    long long c = w[j];
    if (c > 3) {
      has_n = true;
      c = 0;
    }
    kmer = kmer * 4 + static_cast<unsigned long long>(c);
  }
  const long long km = static_cast<long long>(kmer);
  Lane C, R;
  {
    const long long sp = table(a.lkt, a.n_lkt, km);
    const long long ep =
        table(a.lkt, a.n_lkt, static_cast<long long>(kmer + 1));
    long long rsp = 0, rep = 0;
    if (r_jump) {
      rsp = table(a.r_lkt_sp, a.n_r_lkt_sp, km);
      rep = table(a.r_lkt_ep, a.n_r_lkt_ep, km);
    }
    C.k = has_n ? 1 : sp;
    C.l = has_n ? 0 : ep - 1;
    C.alive = !ugt(C.k, C.l);
    if (r_jump) {
      R.k = has_n ? 1 : rsp;
      R.l = has_n ? 0 : rep;
      R.alive = !ugt(R.k, R.l);
    } else {
      R.k = 0;
      R.l = a.n_r;
      R.alive = a.mode == kRFull;
    }
  }

  // ---- LF steps, last base first; C steps below n_lf, R there too with
  // the jump tables and over the whole window without them ----
  for (int j = r_jump || !two ? n_lf - 1 : a.l_seed - 1; j >= 0; --j) {
    const bool c_on = j < n_lf && C.alive;
    const bool r_on = (j < n_lf || !r_jump) && R.alive;
    if (!c_on && !r_on) {
      if (!C.alive && !R.alive) break;
      continue;
    }
    const long long c = w[j];
    if (c > 3) {  // a bad base kills the families that step on it
      if (c_on) C.alive = false;
      if (r_on) R.alive = false;
      continue;
    }
    int2 ck{}, cl{}, rk{}, rl{};
    if (c_on) {
      ck = rank_row(fc, C.k, c);
      cl = rank_row(fc, C.l + 1, c);
    }
    if (r_on) {
      rk = rank_row(fr, R.k, c);
      rl = rank_row(fr, R.l + 1, c);
    }
    if (c_on) lf_apply(C, ck, cl, cf[0][clamp_ll(c, cmax)]);
    if (r_on) lf_apply(R, rk, rl, cf[1][clamp_ll(c, rmax)]);
  }

  // ---- greedy left extension, both families in one loop ----
  const unsigned ms = a.max_seed;
  Ext ec{C.k, C.l, 0, C.alive && ugt(C.l - C.k, ms) && p > 0};
  Ext er{R.k, R.l, 0, two && R.alive && ugt(R.l - R.k, ms) && p > 0};
  while (ec.active || er.active) {
    long long cc = 0, rc = 0;
    int2 ck{}, cl{}, rk{}, rl{};
    if (ec.active) {
      cc = q[p - ec.ext - 1];
      const long long cs = cc < 4 ? cc : 4;
      ck = rank_row(fc, ec.k, cs);
      cl = rank_row(fc, ec.l + 1, cs);
    }
    if (er.active) {
      rc = q[p - er.ext - 1];
      const long long cs = rc < 4 ? rc : 4;
      rk = rank_row(fr, er.k, cs);
      rl = rank_row(fr, er.l + 1, cs);
    }
    if (ec.active) {
      const long long cs = cc < 4 ? cc : 4;
      const long long ok = rank_of(ck, ec.k), ol = rank_of(cl, ec.l + 1);
      if (!(ok + 1 > ol) && cc <= 3) {
        const long long base = cf[0][clamp_ll(cs, cmax)];
        ec.k = base + ok + 1;
        ec.l = base + ol;
        ec.ext += 1;
        ec.active = ugt(ec.l - ec.k, ms) && ec.ext < p;
      } else {
        ec.active = false;
      }
    }
    if (er.active) {
      const long long cs = rc < 4 ? rc : 4;
      const long long ok = rank_of(rk, er.k), ol = rank_of(rl, er.l + 1);
      if (!(ok + 1 > ol)) {
        const long long base = cf[1][clamp_ll(cs, rmax)];
        er.k = base + ok + 1;
        er.l = base + ol;
        er.ext += 1;
        er.active = ugt(er.l - er.k, ms) && er.ext < p;
      } else {
        er.active = false;
      }
    }
  }

  a.out[0][t] = ec.k;
  a.out[1][t] = ec.l;
  a.out[2][t] = p - ec.ext;
  a.valid[0][t] = C.alive;
  a.out[3][t] = two ? er.k : 1;
  a.out[4][t] = two ? er.l : 0;
  a.out[5][t] = two ? p - er.ext : 0;
  a.valid[1][t] = two && R.alive;
}

}  // namespace

// Launches the kernel on `stream` for n_rows x S seed starts; returns the
// CUDA error code of the launch (0 on success).  seq: int64 [n_rows, L]
// codes; seed start s of a row is s * l_overlap, S = (L - l_seed) /
// l_overlap + 1.  A family's rank rows: int32 [*_n_rows, 2] at *_bc, its
// planes from row *_row_off, *_n_words rows a plane; its cfreq: int64
// [*_n_cfreq], 1 <= *_n_cfreq <= 16.  lkt: int32 [n_lkt]; the R jump
// tables int32 [n_r_lkt_*] (mode 0 only).  mode: 0 R jump tables, 1 R
// from (0, n_r) over all l_seed bases, 2 seed_only_ref.  Outputs: int64
// [n_rows, S] sp, ep, offset and uint8 [n_rows, S] valid of each family.
// Requires 1 <= l_lkt <= l_seed <= L, l_overlap >= 1.
extern "C" int salt_seed_overlap(
    const long long* seq, int n_rows, int L, int S, int l_seed, int l_overlap,
    int l_lkt, long long max_seed, int mode,
    const int* c_bc, long long c_n_rows, long long c_row_off,
    long long c_n_words, const long long* c_cfreq, int c_n_cfreq,
    const int* r_bc, long long r_n_rows, long long r_row_off,
    long long r_n_words, const long long* r_cfreq, int r_n_cfreq,
    long long n_r, const int* lkt, long long n_lkt, const int* r_lkt_sp,
    long long n_r_lkt_sp, const int* r_lkt_ep, long long n_r_lkt_ep,
    long long* c_sp, long long* c_ep, long long* c_off, uint8_t* c_valid,
    long long* r_sp, long long* r_ep, long long* r_off, uint8_t* r_valid,
    void* stream) {
  const long long n = static_cast<long long>(n_rows) * S;
  if (n == 0) return 0;
  Args a{seq, n_rows, L, S, l_seed, l_overlap, l_lkt, mode,
         static_cast<unsigned>(max_seed), n_r, lkt, n_lkt, r_lkt_sp,
         n_r_lkt_sp, r_lkt_ep, n_r_lkt_ep,
         {c_sp, c_ep, c_off, r_sp, r_ep, r_off}, {c_valid, r_valid}};
  const Family fc{reinterpret_cast<const int2*>(c_bc), c_n_rows, c_row_off,
                  c_n_words, c_cfreq, c_n_cfreq};
  const Family fr{reinterpret_cast<const int2*>(r_bc), r_n_rows, r_row_off,
                  r_n_words, r_cfreq, r_n_cfreq};
  const long long blocks = (n + kThreads - 1) / kThreads;
  seed_overlap_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, fc, fr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* salt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
