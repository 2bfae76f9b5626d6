// Trajectory-following cut with the circular correlation finished in the
// kernel: the CUDA counterpart of the Pallas kernel
// das_diff_veh_tpu/ops/pallas_gather.py::_dot_kernel (entry
// traj_follow_correlate_dot).
//
// For window slot b and output channel k, cut `nwin` windows of `wlen`
// samples at `base + w*offset` from the channel row `row[b,k]` and from the
// pivot row of the same slot, as csrc/traj_gather.cu does (a window with
// `w*offset + wlen > avail[b,k]` is invalid; with offset >= 1 the valid
// windows are a prefix w < n_eff), and correlate each window pair
// circularly:
//
//     c[w, lag] = sum_n s2[w, n + lag] * r[w, n],   s2 = [s, s]
//
// with s the channel window and r the pivot window (`swap` exchanges them).
// The output row is the sum of c over the windows divided by
// max(n_eff, 1), rolled so that zero lag sits at wlen/2:
// out[(lag + wlen/2) % wlen].  The wrapper (ops/traj_gather.py) computes the
// per-(b,k) scalars (base, avail, row).
//
// Design.  The Pallas kernel builds the (nwin, wlen, wlen) doubled-window
// (Toeplitz) matrix in VMEM and runs one MXU dot; here nothing of that size
// exists.  One thread block per output row (b*nk + k).  The row's valid
// windows are staged in groups of at most `group` windows (a fixed number
// per launch, so shared memory does not grow with nwin), and every warp
// takes tasks (window, tile of 256 lags) of the group, so a row's windows
// run at once.  Each task writes its window's correlations to a per-window
// buffer; after the group, each lag adds the group's windows in ascending w
// to its window sum.  A row without a valid window only writes zeros.
//
// Staging is latency-bound (the scalars, then the window samples, each a
// round trip to L2), so each thread loads 8 samples before storing any.
//
// f32 tier (CUDA cores, bit-exact).  Lane i of a task owns the 8 lags
// lag0 = 8*(32*tile + i) ... lag0 + 7.  It keeps s2[n + lag0 ... n + lag0 + 7]
// in a ring of 8 registers and slides it by one sample a step: one new
// shared-memory load (issued 8 steps ahead) and a broadcast of r[n] (16-byte
// loads, 2 per 8 steps) feed 8 products and 8 sums on 8 independent chains:
// 284 instructions per 128 products and sums in the compiled loop, against
// the 256 of the operations themselves.  Lanes 8 lags apart
// would hit the same 4 shared-memory banks, so s2 is stored skewed, element
// e at e + e/8 (one pad word every 8): a warp's loads then fall in 32
// distinct banks.  Order of operations, part of the contract: every product
// and every sum is rounded on its own (__fmul_rn, __fadd_rn: nvcc may not
// contract them into FMAs), the lag sum runs over ascending n from +0, the
// window sums over ascending w from +0, and the division is IEEE
// (__fdiv_rn).  The plain version (correlate_dot_plain) does the same
// operations in the same order, so the two are equal bit for bit.  An
// invalid window's operands are zero, so its sum is +0 and adding it leaves
// the window sum unchanged (a sum that starts at +0 and adds under
// round-to-nearest never becomes -0): the kernel skips invalid windows, the
// plain version adds their zeros, and the bits agree.
//
// bf16 tier (tensor cores).  Both operands are rounded to bfloat16 (round to
// nearest even) as they are staged.  Writing lag = 8u + q (q < 8),
//
//     c[8u + q] = sum_{n'} s2[n' + 8u] * r[n' - q]
//
// is the matrix product C = A B with A[u, n'] = s2[n' + 8u] (the doubled
// source window read with a row stride of 8 elements: the Toeplitz matrix
// is an address pattern, never stored), B[n', q] = r[n' - q] (zero outside
// [0, wlen)) and C[u, q] stored row-major with stride 8, which is c in lag
// order.  K = n' runs over roundup(wlen + 7, 16) samples, each 256-lag tile
// is 32 rows u (two m16 tiles), and each k-step of 16 is one
// mma.sync.m16n8k16 (bf16 in, float32 accumulate) per m16 tile.  A's
// fragments are 32-bit loads of s2 at k0 + 8u + 2*(lane%4), which fall in 32
// distinct banks; B's are built from two 16-bit loads of the zero-padded
// receiver each.  s2 is zero past 2*wlen: those entries meet only lags past
// wlen, which are discarded, and zeros keep them finite.  The products of
// two bfloat16 values are exact in float32, but the tensor core sums them in
// its own order, so this tier is not bit-equal to the plain version's
// sequential sum: its contract is 1e-5 peak-relative per launch against
// correlate_dot_plain(..., "bf16") and against a float64 evaluation of the
// same bfloat16 operands (tests/test_torch_cuda.py, chip_smoke.py).  The
// Pallas kernel's bf16 tier is an MXU contraction with no stated order
// either.
//
// Bound.  Bound by operations: 2*wlen^2 per valid window (one multiply and
// one add per lag and sample).  At the dot chunk's shapes (64 slots, 18 rows
// on the time-reversed side and 7 on the main side, nwin=6, wlen=250) the
// run's valid windows need ~0.32 GFLOP per chunk: 0.0048 ms at 67 TFLOP/s
// of float32, and the bytes (the window samples read once, 64*25*250*4 B
// written) ~0.001 ms at 3.35 TB/s, which bounds the bf16 tier.  The f32
// tier's contract forbids FMA, so it issues one instruction per product and
// one per sum: twice the bound's count of fused operations, and its issue
// floor (132 SMs x 128 lanes x 1.98 GHz) is 0.0095 ms per chunk, twice its
// bound.  chip_smoke.py counts the valid windows of the run's own scalars.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLagTile = 256;        // lags of one warp task
constexpr int kMaxWarps = 8;
constexpr int kMaxGroup = 8;         // windows staged at once, at most
constexpr int kMaxWlen = 3072;
constexpr int kSmemBudget = 48 * 1024;
constexpr int kStageUnroll = 8;      // window samples a thread loads at once

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of one launch, in 4-byte words: the window sums (`tot`),
// then `group` correlation buffers of `cw` floats, then `group` staging
// slots of `sw` words.
//   f32 slot:  the receiver (`rw` floats, zero past wlen), then the doubled
//              source, skewed (element e at e + e/8), zero past 2*wlen;
//   bf16 slot: the doubled source (`s2n` bfloat16, zero past 2*wlen), then
//              the receiver at offset 8 (`k` + 16 bfloat16, zero outside).
struct Layout {
  int ntiles;     // ceil(wlen / 256)
  int group;      // windows staged at once
  int nwarps;
  int tot;        // words of the window sums
  int cw;         // floats of one correlation buffer (256 * ntiles)
  int sw;         // words of one staging slot
  int rw;         // f32: receiver floats per slot
  int s2n;        // doubled-source elements per slot
  int k;          // bf16: K, the reduction length
  int bytes;
};

Layout make_layout(int wlen, int nwin, bool bf16) {
  Layout l{};
  l.ntiles = (wlen + kLagTile - 1) / kLagTile;
  l.cw = kLagTile * l.ntiles;
  l.tot = round_up(wlen, 4);
  if (bf16) {
    l.k = round_up(wlen + 7, 16);
    l.s2n = l.k + kLagTile * l.ntiles;                 // a multiple of 16
    l.sw = round_up(l.s2n / 2 + (l.k + 16) / 2, 4);
  } else {
    l.rw = round_up(wlen + 1, 8);                      // r is read 8 samples ahead
    l.s2n = kLagTile * l.ntiles + wlen + 8;            // the ring reads 16 ahead
    l.sw = l.rw + round_up(l.s2n + l.s2n / 8 + 1, 4);
  }
  const int per_window = l.cw + l.sw;
  int group = (kSmemBudget / 4 - l.tot) / per_window;
  group = group < kMaxGroup ? group : kMaxGroup;
  group = group < nwin ? group : nwin;
  l.group = group > 1 ? group : 1;
  const int tasks = l.group * l.ntiles;
  l.nwarps = tasks < kMaxWarps ? tasks : kMaxWarps;
  l.bytes = 4 * (l.tot + l.group * per_window);
  return l;
}

__device__ __forceinline__ int skew(int e) { return e + (e >> 3); }

// Stage windows w0 .. w0 + gc - 1 of the row into the group's slots: the
// doubled source (zero past 2*wlen) and the receiver (zero past wlen; bf16:
// at offset 8, zero before it).  Each thread loads kStageUnroll window
// samples before it stores any, so that the loads' latencies overlap (one
// round trip for a 6-window group of 250 samples at 192 threads).
template <bool kBf16>
__device__ void stage(float* slots, const Layout& l, const float* __restrict__ src,
                      const float* __restrict__ rcv, int w0, int gc, int wlen, int offset) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n = gc * wlen;
  const int dq = nthr / wlen, dr = nthr - dq * wlen;
  int wl = tid / wlen, j = tid - wl * wlen;    // sample tid of the group
  for (int i0 = tid; i0 < n; i0 += kStageUnroll * nthr) {
    float s[kStageUnroll], r[kStageUnroll];
    int ww[kStageUnroll], jj[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      ww[u] = wl;
      jj[u] = j;
      if (i0 + u * nthr < n) {
        const int at = (w0 + wl) * offset + j;
        s[u] = src[at];
        r[u] = rcv[at];
      }
      j += dr;
      wl += dq;
      if (j >= wlen) {
        j -= wlen;
        ++wl;
      }
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      if (i0 + u * nthr >= n) break;
      float* slot = slots + ww[u] * l.sw;
      if constexpr (kBf16) {
        __nv_bfloat16* s2 = reinterpret_cast<__nv_bfloat16*>(slot);
        const __nv_bfloat16 sb = __float2bfloat16_rn(s[u]);
        s2[jj[u]] = sb;
        s2[jj[u] + wlen] = sb;
        s2[l.s2n + 8 + jj[u]] = __float2bfloat16_rn(r[u]);
      } else {
        float* s2 = slot + l.rw;
        s2[skew(jj[u])] = s[u];
        s2[skew(jj[u] + wlen)] = s[u];
        slot[jj[u]] = r[u];
      }
    }
  }
  // zeros: the doubled source past 2*wlen and the receiver outside [0, wlen)
  const int zs = l.s2n - 2 * wlen;
  const int zr = kBf16 ? l.k + 16 - wlen : l.rw - wlen;
  for (int i = tid; i < gc * (zs + zr); i += nthr) {
    const int zw = i / (zs + zr), z = i - zw * (zs + zr);
    float* slot = slots + zw * l.sw;
    if constexpr (kBf16) {
      __nv_bfloat16* s2 = reinterpret_cast<__nv_bfloat16*>(slot);
      const int at = z < zs ? 2 * wlen + z                       // past the doubled source
                            : l.s2n + (z - zs < 8 ? z - zs : z - zs + wlen);  // receiver pad
      s2[at] = __float2bfloat16_rn(0.0f);
    } else if (z < zs) {
      slot[l.rw + skew(2 * wlen + z)] = 0.0f;
    } else {
      slot[wlen + z - zs] = 0.0f;
    }
  }
}

// f32 task: lags 8*(32*tile + lane) ... + 7 of one window, in the ring.
// ring[m % 8] holds s2[lag0 + n + m'] for the 8 samples the step needs and
// `ahead` the 8 after them, loaded a block of 8 steps before their use, as
// the receiver samples are, so that no step waits on shared memory.
__device__ __forceinline__ void task_f32(const float* slot, const Layout& l, float* crow,
                                         int wlen, int tile, int lane) {
  const float* rr = slot;
  const float* s2 = slot + l.rw;
  const int lq = 32 * tile + lane;            // first lag / 8
  float acc[8], ring[8], ahead[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j] = 0.0f;
    ring[j] = s2[9 * lq + j];                 // element 8*lq + j
    ahead[j] = s2[9 * (lq + 1) + j];          // element 8*(lq + 1) + j
  }
  const int nfull = wlen >> 3;
  const float4* r4 = reinterpret_cast<const float4*>(rr);
  float4 ra = r4[0], rb = r4[1];
#pragma unroll 2
  for (int nb = 0; nb < nfull; ++nb) {
    const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
    ra = r4[2 * nb + 2];                      // the next block's receiver samples
    rb = r4[2 * nb + 3];
    const float* next = s2 + 9 * (lq + nb + 2);   // elements 8*(lq + nb + 2) + dn
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j] = __fadd_rn(acc[j], __fmul_rn(ring[(dn + j) & 7], rv[dn]));
      }
      ring[dn] = ahead[dn];
      ahead[dn] = next[dn];
    }
  }
  const int rem = wlen & 7;
  if (rem) {
    const float* rt = rr + 8 * nfull;
#pragma unroll
    for (int dn = 0; dn < 7; ++dn) {
      if (dn < rem) {
        const float rv = rt[dn];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j] = __fadd_rn(acc[j], __fmul_rn(ring[(dn + j) & 7], rv));
        }
        ring[dn] = ahead[dn];
      }
    }
  }
  float4* c4 = reinterpret_cast<float4*>(crow + 8 * lq);
  c4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  c4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 task: rows u = 32*tile ... + 31 of C (lags 256*tile ... + 255).
__device__ __forceinline__ void task_bf16(const float* slot, const Layout& l, float* crow,
                                          int tile, int lane) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(slot);        // s2, two per word
  const unsigned short* rp =
      reinterpret_cast<const unsigned short*>(slot) + l.s2n;           // r at offset 8
  const int g = lane >> 2, t = lane & 3;
  float d[2][4] = {};
  // A[u, k] = s2[k + 8u]: word (k0 + 2t + 8(u0 + g)) / 2 for u0 = 32*tile + 16*mt
  const int a_base = 128 * tile + 4 * g + t;
  // B[k, q] = r[k - q] at rp[k - q + 8], k = k0 + 2t (+1, +8, +9), q = g
  const int r_base = 2 * t - g + 8;
  // fragments of the next k-step are loaded before this step's products
  uint32_t fa[2][4], fb[2];
  auto load = [&](int k0) {
    const int ri = k0 + r_base;
    fb[0] = rp[ri] | (static_cast<uint32_t>(rp[ri + 1]) << 16);
    fb[1] = rp[ri + 8] | (static_cast<uint32_t>(rp[ri + 9]) << 16);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int o = a_base + (k0 >> 1) + 64 * mt;
      fa[mt][0] = a[o];
      fa[mt][1] = a[o + 32];
      fa[mt][2] = a[o + 4];
      fa[mt][3] = a[o + 36];
    }
  };
  load(0);
  for (int k0 = 0; k0 < l.k; k0 += 16) {
    uint32_t ca[2][4], cb[2] = {fb[0], fb[1]};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) ca[mt][i] = fa[mt][i];
    }
    if (k0 + 16 < l.k) load(k0 + 16);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma_bf16(d[mt], ca[mt][0], ca[mt][1], ca[mt][2], ca[mt][3], cb[0], cb[1]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int lag = 8 * (32 * tile + 16 * mt + g) + 2 * t;     // C[u, 2t] is c[8u + 2t]
    *reinterpret_cast<float2*>(crow + lag) = make_float2(d[mt][0], d[mt][1]);
    *reinterpret_cast<float2*>(crow + lag + 64) = make_float2(d[mt][2], d[mt][3]);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kMaxWarps * 32)
traj_dot_kernel(const float* __restrict__ rec, const int* __restrict__ scal,
                float* __restrict__ out, int nk, int nch, int nt, int pivot_row,
                int nwin, int wlen, int offset, int swap, Layout l) {
  extern __shared__ float4 smem4[];
  float* tot = reinterpret_cast<float*>(smem4);
  float* cbuf = tot + l.tot;
  float* slots = cbuf + l.group * l.cw;

  const int bk = blockIdx.x;     // b * nk + k
  const int b = bk / nk;
  const int base = scal[3 * bk + 0];
  const int avail = scal[3 * bk + 1];
  const int row = scal[3 * bk + 2];
  const float* ch = rec + (static_cast<long long>(b) * nch + row) * nt + base;
  const float* pv = rec + (static_cast<long long>(b) * nch + pivot_row) * nt + base;
  const float* src = swap ? pv : ch;
  const float* rcv = swap ? ch : pv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, nwarps = nthr >> 5;

  int n_eff = 0;
  while (n_eff < nwin && n_eff * offset + wlen <= avail) ++n_eff;
  for (int lag = tid; lag < wlen; lag += nthr) tot[lag] = 0.0f;
  for (int w0 = 0; w0 < n_eff; w0 += l.group) {
    const int gc = n_eff - w0 < l.group ? n_eff - w0 : l.group;
    __syncthreads();               // the previous group's slots and buffers are read
    stage<kBf16>(slots, l, src, rcv, w0, gc, wlen, offset);
    __syncthreads();
    for (int task = warp; task < gc * l.ntiles; task += nwarps) {
      const int wl = task / l.ntiles, tile = task - wl * l.ntiles;
      if constexpr (kBf16) {
        task_bf16(slots + wl * l.sw, l, cbuf + wl * l.cw, tile, lane);
      } else {
        task_f32(slots + wl * l.sw, l, cbuf + wl * l.cw, wlen, tile, lane);
      }
    }
    __syncthreads();
    for (int lag = tid; lag < wlen; lag += nthr) {   // ascending w, one rounding per sum
      float t = tot[lag];
      for (int wl = 0; wl < gc; ++wl) t = __fadd_rn(t, cbuf[wl * l.cw + lag]);
      tot[lag] = t;
    }
  }
  const float denom = static_cast<float>(n_eff > 1 ? n_eff : 1);
  const int half = wlen / 2;
  float* dst = out + static_cast<long long>(bk) * wlen;
  for (int lag = tid; lag < wlen; lag += nthr) {   // the same thread summed this lag
    const int at = lag + half < wlen ? lag + half : lag + half - wlen;
    dst[at] = __fdiv_rn(tot[lag], denom);
  }
}

template <bool kBf16>
int launch(const Layout& l, int n_bk, cudaStream_t s, const float* rec, const int* scal,
           float* out, int nk, int nch, int nt, int pivot_row, int nwin, int wlen, int offset,
           int swap) {
  if (l.bytes > kSmemBudget) {
    const cudaError_t err = cudaFuncSetAttribute(
        traj_dot_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  traj_dot_kernel<kBf16><<<n_bk, 32 * l.nwarps, l.bytes, s>>>(
      rec, scal, out, nk, nch, nt, pivot_row, nwin, wlen, offset, swap, l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rec: (B, nch, nt) float32; scal: (B*nk, 3) int32 [base, avail, row];
// out: (B*nk, wlen) float32.  swap: 1 correlates (source = pivot, receiver =
// channel); bf16: 1 rounds the operands to bfloat16 and runs the tensor-core
// tier.  Launches on `stream` and returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a wlen or an offset the kernel does not take.
extern "C" int traj_dot_correlate(const void* rec, const void* scal, void* out,
                                  int n_bk, int nk, int nch, int nt, int pivot_row,
                                  int nwin, int wlen, int offset, int swap, int bf16,
                                  void* stream) {
  if (wlen < 1 || wlen > kMaxWlen || offset < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_bk == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(rec);
  const int* sc = static_cast<const int*>(scal);
  float* o = static_cast<float*>(out);
  const Layout l = make_layout(wlen, nwin, bf16 != 0);
  if (bf16) {
    return launch<true>(l, n_bk, s, in, sc, o, nk, nch, nt, pivot_row, nwin, wlen, offset,
                        swap);
  }
  return launch<false>(l, n_bk, s, in, sc, o, nk, nch, nt, pivot_row, nwin, wlen, offset,
                       swap);
}
