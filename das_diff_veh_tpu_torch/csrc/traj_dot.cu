// Trajectory-following cut with the circular correlation finished in the
// kernel: the CUDA counterpart of the Pallas kernel
// das_diff_veh_tpu/ops/pallas_gather.py::_dot_kernel (entry
// traj_follow_correlate_dot).
//
// For window slot b and output channel k, cut `nwin` windows of `wlen`
// samples at `base + w*offset` from the channel row `row[b,k]` and from the
// pivot row of the same slot, as csrc/traj_gather.cu does (a window with
// `w*offset + wlen > avail[b,k]` is invalid), and correlate each window pair
// circularly:
//
//     c[w, lag] = sum_n s2[w, n + lag] * r[w, n],   s2 = [s, s]
//
// with s the channel window and r the pivot window (`swap` exchanges them).
// The output row is the sum of c over the windows divided by
// max(n_eff, 1), n_eff the number of valid windows, rolled so that zero lag
// sits at wlen/2: out[(lag + wlen/2) % wlen].  The wrapper
// (ops/traj_gather.py) computes the per-(b,k) scalars (base, avail, row).
//
// Design.  The Pallas kernel builds the (nwin, wlen, wlen) doubled-window
// (Toeplitz) matrix in VMEM and runs one MXU dot; here nothing of that size
// exists.  One thread block per (b*nk + k); for each valid window it stages
// the doubled source window (2*wlen floats) and the receiver window (wlen
// floats) in shared memory, and each thread owns the lags lag = tid,
// tid + blockDim.x, ...: it sums s2[n + lag] * r[n] over n in ascending
// order.  Neighbouring threads read neighbouring s2 words (no bank
// conflicts) and r[n] is a broadcast.  The per-lag window sums live in
// shared memory (wlen floats), so shared memory is 16*wlen bytes whatever
// nwin is: 4 KB at wlen 250.
//
// Order of operations, part of the contract: every product and every sum is
// rounded on its own (__fmul_rn, __fadd_rn: nvcc may not contract them into
// FMAs), the lag sum runs over ascending n from +0, the window sums over
// ascending w from +0, and the division is IEEE (__fdiv_rn).  The plain
// version (correlate_dot_plain) does the same operations in the same order,
// so the two are equal bit for bit.  An invalid window's operands are zero,
// so its sum is +0 and adding it leaves the window sum unchanged (a sum that
// starts at +0 and adds under round-to-nearest never becomes -0): the kernel
// skips invalid windows, the plain version adds their zeros, and the bits
// agree.
//
// Tiers.  bf16 = 1 rounds both operands to bfloat16 (round to nearest even)
// as they are staged; a product of two bfloat16 values is exact in float32,
// and the sums stay float32.  Both tiers run on the CUDA cores.
//
// Bound.  Bound by operations: 2*wlen^2 per valid window (one multiply and
// one add per lag and sample).  At the dot chunk's shapes (64 slots, 18 rows
// on the time-reversed side and 7 on the main side, nwin=6, wlen=250) that
// is at most 64*25*6*2*250^2 = 1.2 GFLOP per chunk, 0.018 ms at 67 TFLOP/s
// of float32; the bytes (the window samples read once, 64*25*250*4 B
// written) take a few microseconds at 3.35 TB/s.  chip_smoke.py counts the
// valid windows of the run's own scalars.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWlen = 3072;   // 16*wlen bytes of shared memory <= 48 KB

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <bool kBf16>
__global__ void traj_dot_kernel(const float* __restrict__ rec,
                                const int* __restrict__ scal,
                                float* __restrict__ out,
                                int nk, int nch, int nt, int pivot_row,
                                int nwin, int wlen, int offset, int swap) {
  extern __shared__ float smem[];
  float* s2 = smem;              // 2*wlen: the doubled source window
  float* r = smem + 2 * wlen;    // wlen: the receiver window
  float* tot = r + wlen;         // wlen: the window sum of each lag

  const int bk = blockIdx.x;     // b * nk + k
  const int b = bk / nk;
  const int base = scal[3 * bk + 0];
  const int avail = scal[3 * bk + 1];
  const int row = scal[3 * bk + 2];
  const float* ch = rec + (static_cast<long long>(b) * nch + row) * nt + base;
  const float* pv = rec + (static_cast<long long>(b) * nch + pivot_row) * nt + base;
  const float* src = swap ? pv : ch;
  const float* rcv = swap ? ch : pv;

  for (int lag = threadIdx.x; lag < wlen; lag += blockDim.x) tot[lag] = 0.0f;
  int n_eff = 0;
  for (int w = 0; w < nwin; ++w) {
    if (w * offset + wlen > avail) continue;   // block-uniform
    ++n_eff;
    const int at = w * offset;
    __syncthreads();               // the previous window's reads are done
    for (int j = threadIdx.x; j < wlen; j += blockDim.x) {
      const float s = operand<kBf16>(src[at + j]);
      s2[j] = s;
      s2[j + wlen] = s;
      r[j] = operand<kBf16>(rcv[at + j]);
    }
    __syncthreads();
    for (int lag = threadIdx.x; lag < wlen; lag += blockDim.x) {
      float acc = 0.0f;
      for (int n = 0; n < wlen; ++n) acc = __fadd_rn(acc, __fmul_rn(s2[n + lag], r[n]));
      tot[lag] = __fadd_rn(tot[lag], acc);
    }
  }
  const float denom = static_cast<float>(n_eff > 1 ? n_eff : 1);
  const int half = wlen / 2;
  float* dst = out + static_cast<long long>(bk) * wlen;
  for (int lag = threadIdx.x; lag < wlen; lag += blockDim.x) {
    const int at = lag + half < wlen ? lag + half : lag + half - wlen;
    dst[at] = __fdiv_rn(tot[lag], denom);
  }
}

}  // namespace

// rec: (B, nch, nt) float32; scal: (B*nk, 3) int32 [base, avail, row];
// out: (B*nk, wlen) float32.  swap: 1 correlates (source = pivot, receiver =
// channel); bf16: 1 rounds the operands to bfloat16.  Launches on `stream`
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a wlen the kernel does not take.
extern "C" int traj_dot_correlate(const void* rec, const void* scal, void* out,
                                  int n_bk, int nk, int nch, int nt, int pivot_row,
                                  int nwin, int wlen, int offset, int swap, int bf16,
                                  void* stream) {
  if (wlen < 1 || wlen > kMaxWlen) return static_cast<int>(cudaErrorInvalidValue);
  if (n_bk == 0) return 0;
  int threads = (wlen + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t shmem = static_cast<size_t>(4) * wlen * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(rec);
  const int* sc = static_cast<const int*>(scal);
  float* o = static_cast<float*>(out);
  if (bf16) {
    traj_dot_kernel<true><<<n_bk, threads, shmem, s>>>(in, sc, o, nk, nch, nt, pivot_row,
                                                       nwin, wlen, offset, swap);
  } else {
    traj_dot_kernel<false><<<n_bk, threads, shmem, s>>>(in, sc, o, nk, nch, nt, pivot_row,
                                                        nwin, wlen, offset, swap);
  }
  return static_cast<int>(cudaGetLastError());
}
