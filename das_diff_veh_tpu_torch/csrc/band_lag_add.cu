// The ambient day stack's banded finish: a band-pruned inverse real FFT of
// each pair's cross-spectrum, cut to the lags within L of zero and added
// into the pair's row of the stack.  It replaces no TPU kernel: the JAX
// package has no day stack.  It takes the place of cuFFT's c2r over the
// whole window, the copy of its input and the strided band add
// (ops/band_lag_add.py).
//
// For source i and band slot j of a chunk the receiver row is
// i + j - lead of the chunk's (m, nb, nf) cross-spectra; a row outside
// [0, nb) is a receiver past either end of the array, and its stack row is
// left as it is.  Otherwise, with N = wlen and X the row's spectrum,
//
//   y[n] = Re X[0] + (-1)^n Re X[N/2] + 2 Re sum_{0<k<N/2} X[k] w^{kn},
//   w = e^{2 pi i / N},   out[i, j, L + d] += y[d mod N] / N,  |d| <= L,
//
// which is c2r's rule (the imaginary parts of bins 0 and N/2 dropped), with
// X taken as 0 outside the whitening band lo..hi.
//
// Decomposition.  Every band bin below N/2 lies below Q, the smallest power
// of two above the band's last bin below N/2 (at least 16), and P = N / Q.  For
// n = r + P m,  y[r + P m] = Re sum_{k<Q} (A_k w^{kr}) w_Q^{km}:  P twiddled
// Q-point inverse FFTs (A_0 = Re X[0], A_k = 2 X[k]).  Only the real part of
// each is needed, so rows r and r + P/2 share one complex FFT: with
// Y_k = conj(X[Q-k]) and c_p = w^{-Qp},
//
//   G_p[k] = w^{kp} (X_k + c_p Y_k) + i w^{k(p+P/2)} (X_k - c_p Y_k)   (k > 0),
//   G_p[0] = Re X[0] (1 + i),
//
// and the inverse FFT of G_p holds y[p + P m] in its real part and
// y[p + P/2 + P m] in its imaginary part.  The Nyquist bin, when the band
// reaches it, adds its alternating term at the end.  Each pair so costs P/2
// complex Q-point FFTs in place of one N-point c2r over 2049 bins of which
// the band leaves 196 nonzero (the DASH day stack: N 4096, Q 256, P 16).
//
// Twiddles.  Every twiddle comes from the table the wrapper makes once in
// float64 and rounds once to float32: w^{kp} as P rows of Q (coalesced
// along k), c_p, and each radix-16 stage's w_{Ns*16}^{r k} as 16 rows of Ns.
// The radix-2/4/8/16 butterflies' own constants are cos and sin of
// multiples of pi/8, rounded once.
//
// Design.  One block of N/32 threads takes one pair; the pair's bits so
// depend on its bins alone, not on the chunk it falls in.  The band bins
// are read once from the cross-spectra into shared memory (zeros outside
// the band, no pad and no copy in device memory).  Each thread holds 16
// complex points in registers through each Stockham stage: the first stage
// forms G from the shared bins and runs a radix-R0 butterfly (R0 = 2, 4, 8
// or 16), every later stage is radix 16; between stages the P/2 rows of Q
// points sit in shared memory, padded one point in 16, so that the strided
// stores hit distinct banks.  The last stage writes the real output in lag
// order (one float of padding in 32), from which the 2L+1 lags are added
// into the stack's row by one coalesced read-add-write (neighbouring
// threads on neighbouring floats).  The bins and the row are streamed
// (__ldcs, __stcs) so that they do not push the twiddle table out of L1.
//
// Bound.  Bytes: each in-array pair reads its (hi-lo+1) band bins once and
// reads and writes its (2L+1)-float row once.  A DASH record's 5,151,021
// in-array pairs move 1,568 + 16,008 B each, about 90.5 GB: 27 ms at
// 3.35 TB/s, against about 0.77 TFLOP of butterflies and twiddles (11 ms
// at 67 TFLOP/s).  Everything between the bins and the row stays on chip;
// a full launch (64 x 664) ran in 0.358 ms against its 0.202 ms byte bound
// on an H100 80GB HBM3 at 700 W, the irfft finish it replaces in 1.432 ms.

#include <cuda_runtime.h>



namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 times_i(float2 a) { return make_float2(-a.y, a.x); }

// a * e^{2 pi i E / 16}; the exact cases without a multiply
template <int E>
__device__ __forceinline__ float2 w16(float2 a) {
  constexpr float c1 = 0.92387953251128674f;   // cos(pi/8)
  constexpr float s1 = 0.38268343236508977f;   // sin(pi/8)
  constexpr float r2 = 0.70710678118654752f;   // cos(pi/4)
  constexpr int e = E & 15;
  if constexpr (e == 0) return a;
  else if constexpr (e == 4) return times_i(a);
  else if constexpr (e == 8) return make_float2(-a.x, -a.y);
  else if constexpr (e == 12) return make_float2(a.y, -a.x);
  else {
    // cos and sin of e pi / 8 from their first-octant values
    constexpr float cs = e == 1 ? c1 : e == 2 ? r2 : e == 3 ? s1 : e == 5 ? -s1
                       : e == 6 ? -r2 : e == 7 ? -c1 : e == 9 ? -c1 : e == 10 ? -r2
                       : e == 11 ? -s1 : e == 13 ? s1 : e == 14 ? r2 : c1;
    constexpr float sn = e == 1 ? s1 : e == 2 ? r2 : e == 3 ? c1 : e == 5 ? c1
                       : e == 6 ? r2 : e == 7 ? s1 : e == 9 ? -s1 : e == 10 ? -r2
                       : e == 11 ? -c1 : e == 13 ? -c1 : e == 14 ? -r2 : -s1;
    return cmul(a, make_float2(cs, sn));
  }
}

// In-place inverse DFTs (sign +, unnormalised) of v[0..R-1].
__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2, float2& x3) {
  const float2 a0 = cadd(x0, x2), a1 = csub(x0, x2);
  const float2 a2 = cadd(x1, x3), a3 = times_i(csub(x1, x3));
  x0 = cadd(a0, a2);
  x2 = csub(a0, a2);
  x1 = cadd(a1, a3);
  x3 = csub(a1, a3);
}

__device__ __forceinline__ void dft4(float2* v) { dft4(v[0], v[1], v[2], v[3]); }

// 8 = 2 x 4: k = k1 + 2 k2, m = m2 + 4 m1
__device__ __forceinline__ void dft8(float2* v) {
  dft4(v[0], v[2], v[4], v[6]);
  dft4(v[1], v[3], v[5], v[7]);
  const float2 z1[4] = {v[1], w16<2>(v[3]), w16<4>(v[5]), w16<6>(v[7])};
  const float2 z0[4] = {v[0], v[2], v[4], v[6]};
#pragma unroll
  for (int m2 = 0; m2 < 4; ++m2) {
    v[m2] = cadd(z0[m2], z1[m2]);
    v[m2 + 4] = csub(z0[m2], z1[m2]);
  }
}

// 16 = 4 x 4: k = k1 + 4 k2, m = m2 + 4 m1; z[k1][m2] after the first pass
__device__ __forceinline__ void dft16(float2* v) {
  dft4(v[0], v[4], v[8], v[12]);
  dft4(v[1], v[5], v[9], v[13]);
  dft4(v[2], v[6], v[10], v[14]);
  dft4(v[3], v[7], v[11], v[15]);
  // v[k1 + 4 m2] now holds z[k1][m2]; twiddle by w16^{k1 m2}
  v[5] = w16<1>(v[5]);
  v[9] = w16<2>(v[9]);
  v[13] = w16<3>(v[13]);
  v[6] = w16<2>(v[6]);
  v[10] = w16<4>(v[10]);
  v[14] = w16<6>(v[14]);
  v[7] = w16<3>(v[7]);
  v[11] = w16<6>(v[11]);
  v[15] = w16<9>(v[15]);
  float2 t[16];
#pragma unroll
  for (int m2 = 0; m2 < 4; ++m2) {
    float2 a = v[4 * m2], b = v[4 * m2 + 1], c = v[4 * m2 + 2], d = v[4 * m2 + 3];
    dft4(a, b, c, d);
    t[m2] = a;
    t[m2 + 4] = b;
    t[m2 + 8] = c;
    t[m2 + 12] = d;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = t[k];
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) dft2(v);
  else if constexpr (R == 4) dft4(v);
  else if constexpr (R == 8) dft8(v);
  else dft16(v);
}

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// a point's place in a padded row: one point of padding in 16
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

template <int Q>
__global__ void band_lag_add_kernel(const float2* __restrict__ cross,
                                    float* __restrict__ out,
                                    const float2* __restrict__ tab, int nb,
                                    int nf, int lead, int width, int L, int N,
                                    int lo, int hi, int log_p, int rs,
                                    float scale) {
  constexpr int kQ = ilog2(Q);
  constexpr int R0 = (kQ % 4) ? (1 << (kQ % 4)) : 16;   // first stage's radix
  constexpr int S = 1 + (kQ - ilog2(R0)) / 4;           // stages
  constexpr int B0 = 16 / R0;                            // its butterflies a thread
  constexpr int S0 = Q / R0;                             // their input stride

  const int j = blockIdx.x, i = blockIdx.y;
  const int row = i + j - lead;
  if (row < 0 || row >= nb) return;        // a receiver past the array's end
  const int t = threadIdx.x, T = blockDim.x;
  const int P = 1 << log_p, H = P >> 1;

  extern __shared__ float2 smem[];
  float2* xs = smem;                       // Q band bins, 0 elsewhere
  float2* buf = smem + Q;                  // P/2 rows of Q points, rs apart
  float* lags = reinterpret_cast<float*>(buf);   // then the N lags, padded
  const float2* spec = cross + (static_cast<long long>(i) * nb + row) * nf;
  const int top = min(hi, N / 2 - 1);
  for (int k = t; k < Q; k += T) {
    float2 x = make_float2(0.f, 0.f);
    if (k >= lo && k <= top) x = __ldcs(spec + k);
    if (k == 0) x.y = 0.f;                 // c2r drops Im X[0]
    xs[k] = x;
  }
  const float nyq = hi == N / 2 ? __ldcs(spec + N / 2).x : 0.f;
  __syncthreads();

  // the last stage writes lag n of the pair's real output at lag_at(n): one
  // float of padding in 32, so that its strided stores and the reads in lag
  // order below hit distinct banks
  auto lag_at = [](int n) { return n + (n >> 5); };
  auto store = [&](int p, int m, float2 z, bool last) {
    if (last) {
      lags[lag_at(p + P * m)] = z.x;
      lags[lag_at(p + H + P * m)] = z.y;
    } else {
      buf[p * rs + pad(m)] = z;
    }
  };

  float2 v[16];
  // stage 0: G from the bins, then a radix-R0 butterfly
  const float2* pre = tab;                 // w^{kp}: P rows of Q
  const float2* cp = tab + N;              // c_p: P
#pragma unroll
  for (int u = 0; u < B0; ++u) {
    const int b = t + T * u;
    const int p = b / S0, jj = b % S0;
    const float2 c = cp[p];
#pragma unroll
    for (int r = 0; r < R0; ++r) {
      const int k = jj + r * S0;
      if (r == 0 && jj == 0) {
        v[u * R0] = make_float2(xs[0].x, xs[0].x);
      } else {
        const float2 x = xs[k], yc = xs[Q - k];
        const float2 cy = cmul(c, make_float2(yc.x, -yc.y));
        const float2 h1 = cmul(pre[p * Q + k], cadd(x, cy));
        const float2 h2 = cmul(pre[(p + H) * Q + k], csub(x, cy));
        v[u * R0 + r] = make_float2(h1.x - h2.y, h1.y + h2.x);
      }
    }
    dft<R0>(v + u * R0);
  }
#pragma unroll
  for (int u = 0; u < B0; ++u) {
    const int b = t + T * u;
    const int p = b / S0, jj = b % S0;
#pragma unroll
    for (int r = 0; r < R0; ++r) store(p, jj * R0 + r, v[u * R0 + r], S == 1);
  }
  __syncthreads();

  // stages 1..S-1: radix 16, one butterfly a thread
  const float2* stw = tab + N + P;
  int ns = R0;
#pragma unroll
  for (int s = 1; s < S; ++s) {
    constexpr int S16 = Q / 16;
    const int p = t / S16, jj = t % S16;
    const int k = jj & (ns - 1);
    const float2* rowp = buf + p * rs;
#pragma unroll
    for (int r = 0; r < 16; ++r) v[r] = rowp[pad(jj + r * S16)];
#pragma unroll
    for (int r = 1; r < 16; ++r) v[r] = cmul(v[r], stw[r * ns + k]);
    dft16(v);
    __syncthreads();
    const int base = (jj - k) * 16 + k;
#pragma unroll
    for (int r = 0; r < 16; ++r) store(p, base + r * ns, v[r], s == S - 1);
    __syncthreads();
    stw += 16 * ns;
    ns *= 16;
  }

  // the 2L+1 lags in order (lag o - L is sample (o - L) mod N), added into
  // the stack's row, neighbouring threads on neighbouring floats, kV reads a
  // thread in flight
  const int W = 2 * L + 1;
  float* orow = out + (static_cast<long long>(i) * width + j) * W;
  constexpr int kV = 8;
  for (int o0 = t; o0 < W; o0 += kV * T) {
    float a[kV];
#pragma unroll
    for (int u = 0; u < kV; ++u)
      if (o0 + u * T < W) a[u] = __ldcs(orow + o0 + u * T);
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const int o = o0 + u * T;
      if (o < W) {
        const int n = (o + N - L) & (N - 1);
        const float y = lags[lag_at(n)] + ((n & 1) ? -nyq : nyq);
        __stcs(orow + o, fmaf(y, scale, a[u]));
      }
    }
  }
}

template <int Q>
int launch(const void* cross, void* out, const void* tab, int m, int nb, int nf,
           int lead, int width, int L, int N, int lo, int hi, int log_p,
           float scale, cudaStream_t s) {
  const int rs = Q + Q / 16;               // a padded row
  const int H = (N / Q) / 2;
  const size_t smem = sizeof(float2) * (static_cast<size_t>(Q) + static_cast<size_t>(H) * rs);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_lag_add_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(width, m);
  band_lag_add_kernel<Q><<<grid, N / 32, smem, s>>>(
      static_cast<const float2*>(cross), static_cast<float*>(out),
      static_cast<const float2*>(tab), nb, nf, lead, width, L, N, lo, hi, log_p,
      rs, scale);
  return static_cast<int>(cudaGetLastError());
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// cross: (m, nb, N/2+1) complex64, contiguous; out: (m, width, 2L+1)
// float32, contiguous; tab: the wrapper's twiddle table for (N, Q).  Adds
// every in-array pair's lags into out on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int band_lag_add(const void* cross, void* out, const void* tab,
                            int m, int nb, int nf, int lead, int width, int L,
                            int N, int Q, int lo, int hi, float scale,
                            void* stream) {
  if (!pow2(N) || N < 64 || N > 8192 || !pow2(Q) || Q < 16 || Q > N / 2 ||
      nf != N / 2 + 1 || lo < 0 || hi < lo || hi > N / 2 ||
      (lo < N / 2 && (hi < N / 2 ? hi : N / 2 - 1) >= Q) || L < 0 || 2 * L + 1 > N ||
      m > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || width == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int log_p = ilog2(N / Q);
  switch (Q) {
    case 16: return launch<16>(cross, out, tab, m, nb, nf, lead, width, L, N, lo, hi, log_p, scale, s);
    case 32: return launch<32>(cross, out, tab, m, nb, nf, lead, width, L, N, lo, hi, log_p, scale, s);
    case 64: return launch<64>(cross, out, tab, m, nb, nf, lead, width, L, N, lo, hi, log_p, scale, s);
    case 128: return launch<128>(cross, out, tab, m, nb, nf, lead, width, L, N, lo, hi, log_p, scale, s);
    case 256: return launch<256>(cross, out, tab, m, nb, nf, lead, width, L, N, lo, hi, log_p, scale, s);
    case 512: return launch<512>(cross, out, tab, m, nb, nf, lead, width, L, N, lo, hi, log_p, scale, s);
    case 1024: return launch<1024>(cross, out, tab, m, nb, nf, lead, width, L, N, lo, hi, log_p, scale, s);
    case 2048: return launch<2048>(cross, out, tab, m, nb, nf, lead, width, L, N, lo, hi, log_p, scale, s);
    default: return launch<4096>(cross, out, tab, m, nb, nf, lead, width, L, N, lo, hi, log_p, scale, s);
  }
}
