// Peak |x| over the lag axis: the CUDA counterpart of the Pallas kernel
// das_diff_veh_tpu/ops/pallas_xcorr.py::_lag_absmax_kernel (entry
// _pallas_lag_absmax, called by the fused peak finish).
//
// out[p] = max_l |lag[p, l]| for a contiguous (npairs, nlag) float32 block.
//
// Design.  The Pallas kernel streams the lag axis through its grid into a
// 128-lane running max resident in VMEM, over zero-padded tiles, and folds
// the lanes outside.  Here one warp owns one row: each lane keeps a running
// max over a strided share of the row, read as 16-byte float4 loads when the
// row length is a multiple of 4 and the block is 16-byte aligned (else one
// float at a time), and a shuffle tree folds the 32 lanes.  Nothing is
// padded: the loop bound is the row length.  Max is a selection, so the
// result is exact whatever the order; NaN propagates as in torch.amax and
// jnp.maximum (plain fmaxf would drop it), and an all-zero row gives 0.
//
// Bound.  A single pass over the block: the card's memory rate bounds it.
// On the config-4 path (64 source rows x 512 receivers x 1024 lags a launch)
// it reads 134 MB and writes 128 KB: 0.040 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

// max that keeps a NaN from either side
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <int kVec>
__global__ void lag_absmax_kernel(const float* __restrict__ lag,
                                  float* __restrict__ out, int npairs,
                                  int nlag) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock
                        + (threadIdx.x >> 5);
  if (row >= npairs) return;
  float m = 0.0f;
  if (kVec == 4) {
    const float4* r4 = reinterpret_cast<const float4*>(lag + row * nlag);
    for (int i = lane; i < nlag / 4; i += 32) {
      const float4 v = r4[i];
      m = nan_max(m, fabsf(v.x));
      m = nan_max(m, fabsf(v.y));
      m = nan_max(m, fabsf(v.z));
      m = nan_max(m, fabsf(v.w));
    }
  } else {
    const float* r = lag + row * nlag;
    for (int i = lane; i < nlag; i += 32) m = nan_max(m, fabsf(r[i]));
  }
  for (int d = 16; d > 0; d >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, d));
  if (lane == 0) out[row] = m;
}

}  // namespace

// lag: (npairs, nlag) float32, contiguous; out: (npairs,) float32.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int lag_absmax(const void* lag, void* out, int npairs, int nlag,
                          void* stream) {
  if (npairs == 0) return 0;
  const unsigned blocks = (npairs + kRowsPerBlock - 1) / kRowsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(lag);
  float* y = static_cast<float*>(out);
  if (nlag % 4 == 0 && reinterpret_cast<std::uintptr_t>(lag) % 16 == 0)
    lag_absmax_kernel<4><<<blocks, kThreads, 0, s>>>(x, y, npairs, nlag);
  else
    lag_absmax_kernel<1><<<blocks, kThreads, 0, s>>>(x, y, npairs, nlag);
  return static_cast<int>(cudaGetLastError());
}
