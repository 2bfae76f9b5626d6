// Trajectory-following window cut: the CUDA counterpart of the Pallas kernel
// das_diff_veh_tpu/ops/pallas_gather.py::_pack_kernel (entry
// traj_follow_windows).
//
// For window slot b and output channel k, cut `nwin` windows of `wlen`
// samples at `base + w*offset` from the channel row `row[b,k]` and from the
// pivot row of the same slot's record, and zero every window with
// `w*offset + wlen > avail[b,k]`.  Valid windows are exact copies of the
// record.  The wrapper (ops/traj_gather.py) computes the per-(b,k) scalars
// (base, avail, row) with the port's window_slice_avail, the same arithmetic
// the serialized cut uses.
//
// Design.  The Pallas kernel pads the record into 128-aligned grain blocks so
// that its BlockSpecs can fetch the two blocks covering a window; here the
// (B, nch, nt) record is read in place.  Valid windows never read past nt by
// the avail bound, and invalid windows read nothing.  Each output is one
// contiguous run of n = B*nk*nwin*wlen floats whose start is 16-byte
// aligned, so the kernel walks the flat index 4 floats at a time: a thread
// computes 4 consecutive outputs of both operands (channel and pivot) and
// writes each as one 16-byte store; the last n % 4 outputs are a scalar
// tail.  Rows are not 16-byte aligned in general (a row of 5 windows of 250
// samples is 5000 B), and a group of 4 may straddle windows and rows, so the
// thread walks (row, window, sample) forward one output at a time.  The
// sources start anywhere, so the loads are scalar: a warp's 4 loads cover
// 128 consecutive samples and coalesce in L1.  The grid fills the SMs a few
// blocks deep and each thread strides over the output; its position (row,
// window, sample) is divided out once and then advanced by the stride with
// carries, so a step of 32 output bytes divides once (the slot b = row / nk).
//
// Bound.  A pure copy: the card's memory rate bounds it.  At the main-path
// shapes (64 slots of 37 x 2000 samples, nsamp=999, wlen=500, offset=250, so
// nwin=2; 18 channels on the left side and 7 on the far side) the two
// launches of one chunk write 2*64*(18+7)*2*500*4 B = 12.8 MB and read at
// most 64*((18+1)+(7+1))*999*4 B = 6.9 MB of the record (channel rows plus
// each side's pivot row).  On the main-path scene the valid windows need
// 1.5 MB of it: 14.3 MB in all, 4.3 us at 3.35 TB/s (chip_smoke.py computes
// the count from the run's own scalars).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;

struct Cut {
  const float* rec;
  const int* scal;
  float* out_ch;
  float* out_pv;
  int nk, nch, nt, pivot_row, nwin, wlen, offset;
};

// One output row's source pointers and validity.
struct Row {
  const float* ch;
  const float* pv;
  int avail;
};

template <typename Index>
__device__ __forceinline__ Row load_row(const Cut& c, Index bk) {
  const int* sc = c.scal + 3 * bk;
  const long long b = static_cast<long long>(bk / c.nk);
  const int base = sc[0];
  Row r;
  r.avail = sc[1];
  r.ch = c.rec + (b * c.nch + sc[2]) * c.nt + base;
  r.pv = c.rec + (b * c.nch + c.pivot_row) * c.nt + base;
  return r;
}

// Outputs [4*v0, 4*n_vec) in steps of 4*stride_v, as 16-byte stores; the
// stride in (row, window, sample) is (step_b, step_w, step_j).
template <typename Index>
__global__ void __launch_bounds__(kThreads)
traj_gather_pack_kernel(Cut c, Index n_vec, Index n_total, Index stride_v,
                        int step_j, int step_w, Index step_b) {
  const Index v0 = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  if (v0 == 0) {                 // the scalar tail: n_total % 4 outputs
    for (Index i = 4 * n_vec; i < n_total; ++i) {
      const Index gw = i / c.wlen;
      const int j = static_cast<int>(i - gw * c.wlen);
      const Index bk = gw / c.nwin;
      const int w = static_cast<int>(gw - bk * c.nwin);
      const Row r = load_row(c, bk);
      const bool ok = w * c.offset + c.wlen <= r.avail;
      c.out_ch[i] = ok ? r.ch[w * c.offset + j] : 0.0f;
      c.out_pv[i] = ok ? r.pv[w * c.offset + j] : 0.0f;
    }
  }
  if (v0 >= n_vec) return;
  // position of output 4*v0: the one division of the thread
  const Index gw0 = (4 * v0) / c.wlen;
  int j = static_cast<int>(4 * v0 - gw0 * c.wlen);
  Index bk = gw0 / c.nwin;
  int w = static_cast<int>(gw0 - bk * c.nwin);
  for (Index v = v0; v < n_vec; v += stride_v) {
    int cj = j, cw = w;
    Index cbk = bk;
    Row r = load_row(c, cbk);
    bool ok = cw * c.offset + c.wlen <= r.avail;
    float vc[4], vp[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e > 0 && ++cj == c.wlen) {        // the next window, maybe the next row
        cj = 0;
        if (++cw == c.nwin) {
          cw = 0;
          r = load_row(c, ++cbk);
        }
        ok = cw * c.offset + c.wlen <= r.avail;
      }
      const int at = cw * c.offset + cj;
      vc[e] = ok ? r.ch[at] : 0.0f;
      vp[e] = ok ? r.pv[at] : 0.0f;
    }
    reinterpret_cast<float4*>(c.out_ch)[v] = make_float4(vc[0], vc[1], vc[2], vc[3]);
    reinterpret_cast<float4*>(c.out_pv)[v] = make_float4(vp[0], vp[1], vp[2], vp[3]);
    // advance by the stride with carries (step_j < wlen, step_w < nwin)
    j += step_j;
    int carry = 0;
    if (j >= c.wlen) {
      j -= c.wlen;
      carry = 1;
    }
    w += step_w + carry;
    if (w >= c.nwin) {
      w -= c.nwin;
      ++bk;
    }
    bk += step_b;
  }
}

template <typename Index>
int launch(const Cut& c, long long n_total, int sms, cudaStream_t s) {
  const long long n_vec = n_total / 4;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  blocks = blocks < cap ? blocks : cap;
  blocks = blocks > 1 ? blocks : 1;
  const long long stride_v = blocks * kThreads;
  const long long stride = 4 * stride_v;                 // outputs per step
  const long long q = stride / c.wlen;
  traj_gather_pack_kernel<Index><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      c, static_cast<Index>(n_vec), static_cast<Index>(n_total),
      static_cast<Index>(stride_v), static_cast<int>(stride - q * c.wlen),
      static_cast<int>(q % c.nwin), static_cast<Index>(q / c.nwin));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rec: (B, nch, nt) float32; scal: (B*nk, 3) int32 [base, avail, row];
// out_ch, out_pv: (B*nk, nwin, wlen) float32, 16-byte aligned.  Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a misaligned output.
extern "C" int traj_gather_pack(const void* rec, const void* scal, void* out_ch,
                                void* out_pv, int n_bk, int nk, int nch, int nt,
                                int pivot_row, int nwin, int wlen, int offset,
                                void* stream) {
  if (n_bk == 0 || nwin < 1 || wlen < 1) return 0;
  if ((reinterpret_cast<uintptr_t>(out_ch) | reinterpret_cast<uintptr_t>(out_pv)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cut c{static_cast<const float*>(rec), static_cast<const int*>(scal),
              static_cast<float*>(out_ch), static_cast<float*>(out_pv),
              nk, nch, nt, pivot_row, nwin, wlen, offset};
  const long long n_total = static_cast<long long>(n_bk) * nwin * wlen;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 32-bit index arithmetic while the index and one stride past it fit
  const long long headroom = 4LL * kThreads * kBlocksPerSm * sms;
  if (n_total + headroom < (1LL << 32)) return launch<uint32_t>(c, n_total, sms, s);
  return launch<uint64_t>(c, n_total, sms, s);
}
