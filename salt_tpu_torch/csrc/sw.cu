// Batched score-only affine-gap Smith-Waterman (the aligner's rescue and
// -X 1 pre-filter): for each of B (reference window, read) pairs, the
// best local alignment score.
//
// Replaces the TPU kernels of salt_tpu/ops/sw_pallas.py: _sw_fori_kernel,
// _sw_grid_kernel and _sw_wave_kernel, three formulations of one function
// that differ only in how a TPU holds 128 candidates in lanes.  It
// computes exactly salt_tpu_torch/ops/sw_batch.py:sw_score_plain
// (= salt_tpu/ops/sw_batch.py:sw_score_batch):
//
//   E(i,j) = max(E(i,j-1) - ge, H(i,j-1) - go)      gap along the window
//   F(i,j) = max(F(i-1,j) - ge, H(i-1,j) - go)      gap along the read
//   H(i,j) = max(0, H(i-1,j-1) + s(i,j), E(i,j), F(i,j))
//   result = max H over i < L, j < min(ref_len, W); 0 when there is none
//
//   * SNP mode: s = +1 where the reference nibble is a non-zero power of
//     two and ANDs to non-zero with the read's one-hot code, else -3 (a
//     read code 15 matches, a read code 0 never does);
//   * plain mode: s = -1 where either code is >= 4, else +1 on equality,
//     else -3.
//
// What bounds it on an H100: integer arithmetic, not memory.  A pair
// reads W + L + 8 bytes and does W * L cells of 9 int32 operations (with
// Hopper's fused add-max and three-way max; a dozen without), so the
// least time is the cells over the card's int32 rate (132 SMs x 64 lanes
// a clock).  What kept the first design (one thread a pair,
// sw_thread_kernel below) 8 and 15 times above that at the aligner's two
// shapes was latency: one thread swept a pair's whole
// table, a chain of W * L dependent cells (E, then F from the row above,
// then H, through a shared-memory load and store), with two warps on an
// SM and nothing to hide the chain behind.
//
// Design, reads of up to 256 bases (sw_wave_kernel): a group of 16 lanes
// (half a warp) owns a pair and sweeps its table as a wavefront over
// anti-diagonals.  Lane t owns R = ceil(L / 16) consecutive read rows and
// keeps, for each of them, H and E of the previous column and the read's
// code in registers (R is a template parameter, the row loop is
// unrolled): the table never touches shared memory.  At step s lane t
// computes column j = s - t of its strip.  F runs down the strip inside
// the lane; what crosses to lane t + 1 is the bottom row's H and F of that
// column, which lane t + 1 needs one step later: one __shfl_up_sync of one
// word a step.  The word holds H and F as int16 halves, and that is exact,
// not a clamp: 0 <= H <= L <= 2047, and every F the kernel computes is
// max(F' - ge, H' - go) >= H' - go >= -go >= -16384 (the start value kNegF
// belongs to lane 0 alone and is never sent).  The receiving lane keeps
// the H it received as the next column's diagonal.  A lane's column j is
// the column its upper neighbour computed the step before, so a lane with
// a valid column always receives a valid column's values; lanes before
// the start or past ref_len compute nothing and keep their state.  Rows
// >= L (L not a multiple of 16) sit below every real row: nothing flows up
// from them, and they are kept out of the running maximum (in plain mode
// their padding code could match).  The window's bytes are staged once in
// shared memory with coalesced loads and lane t reads byte s - t (handing
// the code down the lanes by a second shuffle measured 8% slower).  `best`
// is a per-lane maximum, reduced over the group by __shfl_xor_sync at the
// end.  The two groups of a warp name only their own lanes in every
// shuffle, so each runs its own number of steps.
//
// A pair's chain falls from W * L cells to (W + 15) * R, and the kernel
// becomes bound by instruction throughput: a step costs a shuffle, a
// shared byte, the unpacking and the loop besides its R cells.  One group
// size serves every batch: with the recurrence written in Hopper's DPX
// intrinsics, __viaddmax_s32 (max(a + b, c)) and __vimax3_s32_relu
// (max(a, b, c, 0)), which ptxas emits as VIADDMNMX and VIMNMX3, a cell
// needs 9 issued operations, and no instantiation has a stack frame or a
// spill.  Other group sizes were measured on an H100 at 700 W and left
// out: at B = 8,192, L = 100, W = 105, 8 lanes x 13 rows took 0.064 ms, 16
// x 7 0.077 ms, 32 x 4 0.110 ms, one thread a pair 0.375 ms; at B = 4,096,
// L = 104, W = 512, 0.232, 0.225, 0.269 and 1.81 ms; 32 lanes won only
// under about 1,000 pairs a call, by microseconds.  At the batches the
// aligner sends (about 1,400 pairs at W = 105, 250 at W = 512) the card is
// not full and a call lasts one group's chain: 0.028 and 0.09-0.10 ms,
// against 0.37 and 1.8 ms for one thread a pair.
//
// Reads longer than 256 bases (sw_thread_kernel): one thread per pair
// sweeps the window's columns; inside a column it walks the L read rows
// with F, H(i-1,j) and the diagonal in registers.  The previous column's
// H and E live in dynamic shared memory as two int16 halves of one word
// per row, laid out row-major across the block (row i of thread t at
// [i * blockDim + t]) so that a warp's 32 lanes hit 32 banks; the read's
// codes sit behind them as bytes in the same layout.  The block shrinks
// from 128 threads as L grows so that 5 * L bytes a thread still fit, and
// while the grid would leave SMs empty.  Which of the two kernels runs
// depends on the shape alone (L, and W where a block could not stage the
// windows), never on a failure.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNegF = -(1 << 20);
constexpr int kWaveThreads = 128;
constexpr int kWaveLanes = 16;    // lanes a pair
constexpr int kWaveMaxRows = 16;  // rows a lane: reads of up to 256 bases
constexpr int kWaveGroups = kWaveThreads / kWaveLanes;
constexpr int kWaveMaxShared = 48 * 1024;

// One cell of the recurrence.  Takes H(i,j-1), E(i,j-1) in hl, el, the
// diagonal H(i-1,j-1), the upper H(i-1,j) and F(i-1,j); leaves H(i,j),
// E(i,j), F(i,j) in h, e, f.
__device__ __forceinline__ void sw_cell(int hl, int el, int diag, int hup,
                                        int s, int go, int ge, int& h, int& e,
                                        int& f) {
  e = __viaddmax_s32(el, -ge, hl - go);
  f = __viaddmax_s32(f, -ge, hup - go);
  h = __vimax3_s32_relu(diag + s, e, f);
}

template <bool kSnp>
__device__ __forceinline__ int sw_score(int r, int rmask, int q) {
  if (kSnp) return (rmask & q) ? 1 : -3;
  return (r >= 4 || q >= 4) ? -1 : (r == q ? 1 : -3);
}

// SNP mode: only a one-hot reference nibble can match
__device__ __forceinline__ int one_hot_or_zero(int r) {
  return (r != 0 && (r & (r - 1)) == 0) ? r : 0;
}

// The lanes of this thread's group within its warp.
__device__ __forceinline__ unsigned group_mask() {
  return ((1u << kWaveLanes) - 1u)
         << ((threadIdx.x & 31) / kWaveLanes * kWaveLanes);
}

template <bool kSnp, int R>
__global__ void __launch_bounds__(kWaveThreads)
    sw_wave_kernel(const uint8_t* __restrict__ refs,
                   const uint8_t* __restrict__ reads,
                   const int* __restrict__ ref_len, int B, int W, int L,
                   int go, int ge, int* __restrict__ out) {
  extern __shared__ uint8_t windows[];  // [groups a block][W]
  constexpr int G = kWaveLanes;
  const int group = threadIdx.x / G;
  const int t = threadIdx.x % G;
  const int b = blockIdx.x * kWaveGroups + group;
  // the lanes of a group leave together, and every shuffle below names
  // the group's own lanes only
  if (b >= B) return;
  const unsigned mask = group_mask();

  const int len = min(max(ref_len[b], 0), W);
  uint8_t* window = windows + group * W;
  const uint8_t* ref = refs + static_cast<size_t>(b) * W;
  for (int j = t; j < len; j += G) window[j] = ref[j];

  const int row0 = t * R;
  const int rows = min(max(L - row0, 0), R);
  const uint8_t* read = reads + static_cast<size_t>(b) * L + row0;
  int q[R], hcol[R], ecol[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    q[r] = r < rows ? read[r] : 0;
    hcol[r] = 0;
    ecol[r] = 0;
  }
  __syncwarp(mask);

  int best = 0;
  int diag_in = 0;    // H(row0 - 1, j - 1)
  uint32_t send = 0;  // bottom row's H | F << 16 of the last column
  const int steps = len > 0 ? len + G - 1 : 0;
  for (int s = 0; s < steps; ++s) {
    const uint32_t recv = __shfl_up_sync(mask, send, 1, G);
    const int j = s - t;
    if (j >= 0 && j < len) {
      const int rc = window[j];
      const int rmask = one_hot_or_zero(rc);
      int hup = t == 0 ? 0 : static_cast<int>(recv & 0xffffu);
      int f = t == 0 ? kNegF : static_cast<int>(recv) >> 16;
      int diag = diag_in;
      diag_in = hup;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int hl = hcol[r];
        int h, e;
        sw_cell(hl, ecol[r], diag, hup, sw_score<kSnp>(rc, rmask, q[r]), go,
                ge, h, e, f);
        hcol[r] = h;
        ecol[r] = e;
        if (r < rows) best = max(best, h);
        diag = hl;
        hup = h;
      }
      send = static_cast<uint32_t>(hup & 0xffff) |
             (static_cast<uint32_t>(f) << 16);
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    best = max(best, __shfl_xor_sync(mask, best, o, G));
  }
  if (t == 0) out[b] = best;
}

template <bool kSnp>
__global__ void sw_thread_kernel(const uint8_t* __restrict__ refs,
                                 const uint8_t* __restrict__ reads,
                                 const int* __restrict__ ref_len, int B, int W,
                                 int L, int go, int ge,
                                 int* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.x * T + tid;
  // per-thread state only: no barrier follows, so idle threads may leave
  if (b >= B) return;
  uint32_t* he = smem + tid;                                    // [L][T]
  uint8_t* rd = reinterpret_cast<uint8_t*>(smem + L * T) + tid;  // [L][T]

  const uint8_t* read = reads + static_cast<size_t>(b) * L;
  for (int i = 0; i < L; ++i) {
    he[i * T] = 0u;  // H = 0, E = 0
    rd[i * T] = read[i];
  }
  const int len = min(max(ref_len[b], 0), W);
  const uint8_t* ref = refs + static_cast<size_t>(b) * W;
  int best = 0;
  for (int j = 0; j < len; ++j) {
    const int r = ref[j];
    // SNP mode: only a one-hot reference nibble can match
    const int rmask = (r != 0 && (r & (r - 1)) == 0) ? r : 0;
    int diag = 0;  // H(i-1, j-1)
    int hup = 0;   // H(i-1, j)
    int f = kNegF;
    for (int i = 0; i < L; ++i) {
      const uint32_t w = he[i * T];
      const int hl = static_cast<int16_t>(w & 0xffffu);  // H(i, j-1)
      const int el = static_cast<int16_t>(w >> 16);      // E(i, j-1)
      const int q = rd[i * T];
      int s;
      if (kSnp) {
        s = (rmask & q) ? 1 : -3;
      } else {
        s = (r >= 4 || q >= 4) ? -1 : (r == q ? 1 : -3);
      }
      const int e = max(el - ge, hl - go);
      f = max(f - ge, hup - go);
      const int h = max(max(0, diag + s), max(e, f));
      he[i * T] = static_cast<uint32_t>(h & 0xffff) |
                  (static_cast<uint32_t>(e & 0xffff) << 16);
      best = max(best, h);
      diag = hl;
      hup = h;
    }
  }
  out[b] = best;
}

struct Args {
  const uint8_t* refs;
  const uint8_t* reads;
  const int* ref_len;
  int B, W, L, go, ge;
  int* out;
  cudaStream_t stream;
};

template <bool kSnp, int R>
int launch_wave(const Args& a) {
  const size_t smem = static_cast<size_t>(kWaveGroups) * a.W;
  if (smem > static_cast<size_t>(kWaveMaxShared)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (a.B + kWaveGroups - 1) / kWaveGroups;
  sw_wave_kernel<kSnp, R><<<blocks, kWaveThreads, smem, a.stream>>>(
      a.refs, a.reads, a.ref_len, a.B, a.W, a.L, a.go, a.ge, a.out);
  return static_cast<int>(cudaGetLastError());
}

// The wavefront kernel with R = ceil(L / 16) rows a lane.
template <bool kSnp>
int launch_wave_rows(const Args& a) {
  switch ((a.L + kWaveLanes - 1) / kWaveLanes) {
    case 1: return launch_wave<kSnp, 1>(a);
    case 2: return launch_wave<kSnp, 2>(a);
    case 3: return launch_wave<kSnp, 3>(a);
    case 4: return launch_wave<kSnp, 4>(a);
    case 5: return launch_wave<kSnp, 5>(a);
    case 6: return launch_wave<kSnp, 6>(a);
    case 7: return launch_wave<kSnp, 7>(a);
    case 8: return launch_wave<kSnp, 8>(a);
    case 9: return launch_wave<kSnp, 9>(a);
    case 10: return launch_wave<kSnp, 10>(a);
    case 11: return launch_wave<kSnp, 11>(a);
    case 12: return launch_wave<kSnp, 12>(a);
    case 13: return launch_wave<kSnp, 13>(a);
    case 14: return launch_wave<kSnp, 14>(a);
    case 15: return launch_wave<kSnp, 15>(a);
    case 16: return launch_wave<kSnp, 16>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kSnp>
int launch_thread(const Args& a) {
  int dev = 0, max_smem = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 4 bytes of H|E and 1 byte of read code per row and thread
  const size_t per_thread = static_cast<size_t>(a.L) * 5;
  int threads = 128;
  while (threads > 1 && per_thread * threads > static_cast<size_t>(max_smem)) {
    threads /= 2;
  }
  while (threads > 32 && (a.B + threads - 1) / threads < n_sm) threads /= 2;
  const size_t smem = per_thread * threads;
  if (smem > static_cast<size_t>(max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sw_thread_kernel<kSnp>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (a.B + threads - 1) / threads;
  sw_thread_kernel<kSnp><<<blocks, threads, smem, a.stream>>>(
      a.refs, a.reads, a.ref_len, a.B, a.W, a.L, a.go, a.ge, a.out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSnp>
int launch(const Args& a, int lanes) {
  switch (lanes) {
    case 1: return launch_thread<kSnp>(a);
    case kWaveLanes: return launch_wave_rows<kSnp>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The lanes a pair gets at L read bases and W window columns: 16 (the
// wavefront kernel) for reads of up to 256 bases, 1 (one thread a pair)
// for longer reads and for windows too wide for a block to stage.
extern "C" int salt_sw_lanes(int L, int W) {
  const bool fits = L <= kWaveLanes * kWaveMaxRows &&
                    static_cast<long long>(kWaveGroups) * W <= kWaveMaxShared;
  return fits ? kWaveLanes : 1;
}

// Launches the kernel on `stream` for B pairs; returns the CUDA error code
// of the launch (0 on success).  refs: uint8 [B, W] reference nibbles (SNP
// mode) or base codes (plain mode); reads: uint8 [B, L] one-hot codes (SNP
// mode) or base codes (plain mode); ref_len: int32 [B] valid columns of
// each window; out: int32 [B].  Requires 1 <= L <= 2047, W >= 1,
// 0 <= ge <= go, 1 <= go <= 16384.  `lanes` names the instantiation: 0
// takes salt_sw_lanes(L, W), as every caller in the package does; 1 or 16
// force that many lanes a pair (for measurements; 16 is an error where L
// needs more than 16 rows a lane).
extern "C" int salt_sw_score(const uint8_t* refs, const uint8_t* reads,
                             const int* ref_len, int B, int W, int L,
                             int snp_mode, int go, int ge, int* out,
                             void* stream, int lanes) {
  if (B == 0) return 0;
  const Args a{refs, reads, ref_len, B, W, L, go, ge, out,
               static_cast<cudaStream_t>(stream)};
  if (lanes == 0) lanes = salt_sw_lanes(L, W);
  return snp_mode ? launch<true>(a, lanes) : launch<false>(a, lanes);
}

extern "C" const char* salt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
