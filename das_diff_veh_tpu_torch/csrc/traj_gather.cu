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
// the avail bound, and invalid windows read nothing.  One thread block per
// (b*nk + k, operand): operand 0 cuts the channel row, operand 1 the pivot
// row.  Its threads stride over the nwin*wlen outputs with neighbouring
// threads on neighbouring samples, so reads and writes coalesce.  The block
// loads its own three int32 scalars.  Float32 only.
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

namespace {

constexpr int kThreads = 256;

__global__ void traj_gather_pack_kernel(const float* __restrict__ rec,
                                        const int* __restrict__ scal,
                                        float* __restrict__ out_ch,
                                        float* __restrict__ out_pv,
                                        int nk, int nch, int nt, int pivot_row,
                                        int nwin, int wlen, int offset) {
  const int bk = blockIdx.x;            // b * nk + k
  const int operand = blockIdx.y;       // 0: channel row, 1: pivot row
  const int b = bk / nk;
  const int base = scal[3 * bk + 0];
  const int avail = scal[3 * bk + 1];
  const int row = operand == 0 ? scal[3 * bk + 2] : pivot_row;
  const float* src = rec + (static_cast<long long>(b) * nch + row) * nt + base;
  float* dst = (operand == 0 ? out_ch : out_pv)
               + static_cast<long long>(bk) * nwin * wlen;
  const int n = nwin * wlen;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int w = i / wlen;
    const int s = w * offset + (i - w * wlen);
    dst[i] = (w * offset + wlen <= avail) ? src[s] : 0.0f;
  }
}

}  // namespace

// rec: (B, nch, nt) float32; scal: (B*nk, 3) int32 [base, avail, row];
// out_ch, out_pv: (B*nk, nwin, wlen) float32.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int traj_gather_pack(const void* rec, const void* scal, void* out_ch,
                                void* out_pv, int n_bk, int nk, int nch, int nt,
                                int pivot_row, int nwin, int wlen, int offset,
                                void* stream) {
  if (n_bk == 0) return 0;
  dim3 grid(n_bk, 2);
  traj_gather_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rec), static_cast<const int*>(scal),
      static_cast<float*>(out_ch), static_cast<float*>(out_pv),
      nk, nch, nt, pivot_row, nwin, wlen, offset);
  return static_cast<int>(cudaGetLastError());
}
