// Window-mean cross-spectra of every source row against every receiver row:
// the CUDA counterpart of the Pallas kernel
// das_diff_veh_tpu/ops/pallas_xcorr.py::_spectra_tile_kernel (entry
// _pallas_cross_spectra, called by the all-pairs path's _make_cross_fn).
//
//   C[s, r, f] = sum over slabs of ( (sum_{w in slab} S[s,w,f] conj(R[r,w,f])) * (1/nwin) )
//
// with the window axis cut into slabs of `win_block` windows (the last one
// ragged).  Inputs are the complex64 spectra as torch.fft.rfft leaves them,
// interleaved (re, im), src (m, nwin, nf) and rcv (nall, nwin, nf); the
// output is the complex64 (m, nall, nf) that torch.fft.irfft takes.
//
// Design.  The Pallas kernel splits the spectra into planar real/imag tiles
// padded to the TPU's (32, 128) grain and streams the window axis as its
// sequential fourth grid dimension, with the output tile resident in VMEM.
// Here nothing is split or padded.  One thread block owns a tile of
// kTS sources x kTR receivers x kTF frequencies; its window loop replaces the
// TPU's sequential grid dimension.  The block stages the source and receiver
// tiles of up to kWC windows in shared memory behind one barrier (all of
// config 4's 7 windows: each thread's loads are in flight together), then
// each thread (one frequency, kPS sources x kPR receivers) accumulates its
// outputs in registers.  Lanes run along the frequency axis, so loads and stores are
// 256-byte coalesced rows.  Blocks that share a receiver tile are adjacent
// in the launch order, so the receiver spectra come from device memory about
// once and from L2 after that.  Ragged edges are masked; the ragged window
// slab is cut by the loop bound, which adds exactly what the Pallas kernel's
// zero mask adds.
//
// Arithmetic and order.  Float32 on the CUDA cores, no TF32 and no tensor
// cores: the f32 tier matches XLA's HIGHEST.  Each output's sum runs over
// windows in ascending order inside each slab, is scaled by 1/nwin and added
// to the output, slab after slab: (a+ib)(c-id) = (ac+bd) + i(bc-ad), each
// product and sum rounded on its own (__fmul_rn/__fadd_rn keep nvcc from
// contracting them into FMAs).  So one pair's result depends on neither the
// tiling, nor the number of source rows, nor the receiver set, and it equals
// the plain PyTorch version (ops/cross_spectra.py) bit for bit.
//
// Bound.  At config 4 (a launch of m=64 source rows against nall=10000
// receivers, nwin=7, nf=513) it writes 2.63 GB and reads 0.29 GB: 0.87 ms
// at 3.35 TB/s, against 18.4 GFLOP (8 per complex multiply-add), 0.27 ms at
// 67 TFLOP/s float32.  It is bound by the bytes of its output.

#include <cuda_runtime.h>

namespace {

constexpr int kTF = 32;                  // frequencies per block: one per lane
constexpr int kPS = 4;                   // sources per thread
constexpr int kPR = 4;                   // receivers per thread
constexpr int kWS = 2;                   // warps along the source axis
constexpr int kWR = 4;                   // warps along the receiver axis
constexpr int kWarps = kWS * kWR;
constexpr int kTS = kWS * kPS;           // sources per block
constexpr int kTR = kWR * kPR;           // receivers per block
constexpr int kThreads = 32 * kWarps;
constexpr int kWC = 7;                   // windows staged per barrier (43 KB)
// staging: warp i loads source row i and receiver rows i and i + kWarps
static_assert(kTS == kWarps && kTR == 2 * kWarps, "staging covers the tile");

// kOneSlab: win_block >= nwin, so the slab loop runs once and the output sum
// (0 + slab) needs no registers of its own.  The register caps (64 and 80 a
// thread) let 4 and 3 blocks share an SM; on the H100 they were the fastest
// of 1 to 4 blocks a SM at config 4's shapes, one slab and slabs of 3.
template <bool kOneSlab>
__global__ void __launch_bounds__(kThreads, kOneSlab ? 4 : 3)
cross_spectra_kernel(const float2* __restrict__ src, const float2* __restrict__ rcv,
                     float2* __restrict__ out, int m, int nall, int nwin, int nf,
                     int win_block, float inv_nwin, int n_fb, int n_sb) {
  __shared__ float2 s_src[kWC][kTS][kTF];
  __shared__ float2 s_rcv[kWC][kTR][kTF];

  // block order: frequency block fastest, then source block, then receiver
  // block, so that neighbouring blocks share a receiver tile
  const long long bid = blockIdx.x;
  const int fb = static_cast<int>(bid % n_fb);
  const int sb = static_cast<int>((bid / n_fb) % n_sb);
  const int rb = static_cast<int>(bid / (static_cast<long long>(n_fb) * n_sb));
  const int f0 = fb * kTF, s0 = sb * kTS, r0 = rb * kTR;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ps0 = (warp / kWR) * kPS;    // this thread's first source in the tile
  const int pr0 = (warp % kWR) * kPR;    // and its first receiver
  const int f = f0 + lane;

  // the three rows this thread stages, at window 0 (null: outside the data)
  const bool f_ok = f < nf;
  const float2* st_s = (f_ok && s0 + warp < m)
      ? src + static_cast<long long>(s0 + warp) * nwin * nf + f : nullptr;
  const float2* st_r0 = (f_ok && r0 + warp < nall)
      ? rcv + static_cast<long long>(r0 + warp) * nwin * nf + f : nullptr;
  const float2* st_r1 = (f_ok && r0 + kWarps + warp < nall)
      ? rcv + static_cast<long long>(r0 + kWarps + warp) * nwin * nf + f : nullptr;
  const float2 zero = make_float2(0.0f, 0.0f);

  float2 res[kPS][kPR];
  float2 acc[kPS][kPR];
#pragma unroll
  for (int p = 0; p < kPS; ++p)
#pragma unroll
    for (int q = 0; q < kPR; ++q) res[p][q] = zero;

  const int n_slabs = kOneSlab ? 1 : (nwin + win_block - 1) / win_block;
  for (int slab = 0; slab < n_slabs; ++slab) {
    const int w0 = slab * win_block;
    const int w1 = min(w0 + win_block, nwin);
#pragma unroll
    for (int p = 0; p < kPS; ++p)
#pragma unroll
      for (int q = 0; q < kPR; ++q) acc[p][q] = zero;

    for (int wc = w0; wc < w1; wc += kWC) {
      const int nw = min(kWC, w1 - wc);
      __syncthreads();                   // the previous windows' tiles are read
#pragma unroll
      for (int j = 0; j < kWC; ++j) {
        if (j < nw) {
          const long long off = static_cast<long long>(wc + j) * nf;
          s_src[j][warp][lane] = st_s ? st_s[off] : zero;
          s_rcv[j][warp][lane] = st_r0 ? st_r0[off] : zero;
          s_rcv[j][kWarps + warp][lane] = st_r1 ? st_r1[off] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kWC; ++j) {
        if (j < nw) {                    // windows in ascending order
          float2 a[kPS], c[kPR];
#pragma unroll
          for (int p = 0; p < kPS; ++p) a[p] = s_src[j][ps0 + p][lane];
#pragma unroll
          for (int q = 0; q < kPR; ++q) c[q] = s_rcv[j][pr0 + q][lane];
#pragma unroll
          for (int p = 0; p < kPS; ++p)
#pragma unroll
            for (int q = 0; q < kPR; ++q) {
              // (a.x + i a.y)(c.x - i c.y) = (ac + bd) + i(bc - ad)
              const float re = __fadd_rn(__fmul_rn(a[p].x, c[q].x),
                                         __fmul_rn(a[p].y, c[q].y));
              const float im = __fsub_rn(__fmul_rn(a[p].y, c[q].x),
                                         __fmul_rn(a[p].x, c[q].y));
              acc[p][q].x = __fadd_rn(acc[p][q].x, re);
              acc[p][q].y = __fadd_rn(acc[p][q].y, im);
            }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPS; ++p)
#pragma unroll
      for (int q = 0; q < kPR; ++q) {
        res[p][q].x = __fadd_rn(res[p][q].x, __fmul_rn(acc[p][q].x, inv_nwin));
        res[p][q].y = __fadd_rn(res[p][q].y, __fmul_rn(acc[p][q].y, inv_nwin));
      }
  }

  if (!f_ok) return;
#pragma unroll
  for (int p = 0; p < kPS; ++p) {
    const int s = s0 + ps0 + p;
    if (s >= m) break;
#pragma unroll
    for (int q = 0; q < kPR; ++q) {
      const int r = r0 + pr0 + q;
      if (r < nall) out[(static_cast<long long>(s) * nall + r) * nf + f] = res[p][q];
    }
  }
}

}  // namespace

// src: (m, nwin, nf), rcv: (nall, nwin, nf), out: (m, nall, nf), all
// complex64 (interleaved float2), contiguous.  win_block in [1, nwin];
// inv_nwin is float32(1/nwin).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int cross_spectra(const void* src, const void* rcv, void* out, int m,
                             int nall, int nwin, int nf, int win_block,
                             float inv_nwin, void* stream) {
  if (m == 0 || nall == 0 || nf == 0) return 0;
  const int n_fb = (nf + kTF - 1) / kTF;
  const int n_sb = (m + kTS - 1) / kTS;
  const long long n_rb = (nall + kTR - 1) / kTR;
  const long long blocks = static_cast<long long>(n_fb) * n_sb * n_rb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = win_block >= nwin ? cross_spectra_kernel<true>
                                        : cross_spectra_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(src), static_cast<const float2*>(rcv),
      static_cast<float2*>(out), m, nall, nwin, nf, win_block, inv_nwin, n_fb, n_sb);
  return static_cast<int>(cudaGetLastError());
}
