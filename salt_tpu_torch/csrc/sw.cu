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
// Design: one thread per pair sweeps the window's columns; inside a
// column it walks the L read rows with F, H(i-1,j) and the diagonal in
// registers.  The previous column's H and E live in dynamic shared memory
// as two int16 halves of one word per row (0 <= H <= L <= 2047 and
// -go <= E <= L, so 16 bits hold them), laid out row-major across the
// block (row i of thread t at [i * blockDim + t]) so that a warp's 32
// lanes hit 32 banks; the read's codes sit behind them as bytes in the
// same layout.  A cell is one shared load and one shared store.  The
// block shrinks from 128 threads as L grows so that 5 * L bytes a thread
// still fit, and while the grid would leave SMs empty.
//
// What bounds it on an H100: integer arithmetic, not memory.  A pair
// reads W + L + 4 bytes and does W * L cells of about a dozen int32
// operations.  With one thread per pair and the H -> F -> H dependence
// from row to row, a call lasts one thread's serial sweep (latency), as
// the LV kernel's does; spreading a pair over several threads along
// anti-diagonals is left to later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNegF = -(1 << 20);

template <bool kSnp>
__global__ void sw_score_kernel(const uint8_t* __restrict__ refs,
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

template <bool kSnp>
int launch(const uint8_t* refs, const uint8_t* reads, const int* ref_len,
           int B, int W, int L, int go, int ge, int* out,
           cudaStream_t stream) {
  int dev = 0, max_smem = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 4 bytes of H|E and 1 byte of read code per row and thread
  const size_t per_thread = static_cast<size_t>(L) * 5;
  int threads = 128;
  while (threads > 1 && per_thread * threads > static_cast<size_t>(max_smem)) {
    threads /= 2;
  }
  while (threads > 32 && (B + threads - 1) / threads < n_sm) threads /= 2;
  const size_t smem = per_thread * threads;
  if (smem > static_cast<size_t>(max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sw_score_kernel<kSnp>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + threads - 1) / threads;
  sw_score_kernel<kSnp><<<blocks, threads, smem, stream>>>(
      refs, reads, ref_len, B, W, L, go, ge, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` for B pairs; returns the CUDA error code
// of the launch (0 on success).  refs: uint8 [B, W] reference nibbles (SNP
// mode) or base codes (plain mode); reads: uint8 [B, L] one-hot codes (SNP
// mode) or base codes (plain mode); ref_len: int32 [B] valid columns of
// each window; out: int32 [B].  Requires 1 <= L <= 2047, W >= 1,
// 0 <= ge <= go, 1 <= go <= 16384.
extern "C" int salt_sw_score(const uint8_t* refs, const uint8_t* reads,
                             const int* ref_len, int B, int W, int L,
                             int snp_mode, int go, int ge, int* out,
                             void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return snp_mode
             ? launch<true>(refs, reads, ref_len, B, W, L, go, ge, out, s)
             : launch<false>(refs, reads, ref_len, B, W, L, go, ge, out, s);
}

extern "C" const char* salt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
