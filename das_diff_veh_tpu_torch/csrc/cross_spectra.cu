// Window-mean cross-spectra of every source row against every receiver row:
// the CUDA counterpart of the Pallas kernel
// das_diff_veh_tpu/ops/pallas_xcorr.py::_spectra_tile_kernel (entry
// _pallas_cross_spectra, called by the all-pairs path's _make_cross_fn).
//
//   C[s, r, f] = sum over slabs of ( (sum_{w in slab} S[s,w,f] conj(R[r,w,f])) * (1/nwin) )
//
// with the window axis cut into slabs of `win_block` windows (the last one
// ragged).  Inputs are src (m, nwin, nf) and rcv (nall, nwin, nf) spectra,
// interleaved (re, im): complex64 as torch.fft.rfft leaves them (the f32
// tier), or bfloat16 pairs (the bf16 tier, the Pallas kernel's bf16 planes:
// 4 bytes a value).  The output is the complex64 (m, nall, nf) that
// torch.fft.irfft takes.
//
// 1. What bounds it.  At config 4 (a launch of m=64 source rows against
//    nall=10000 receivers, nwin=7, nf=513) it writes 2.63 GB and reads
//    0.29 GB (f32; 0.14 GB in bf16): 0.87 ms (0.83 ms) at 3.35 TB/s.  The
//    contract of section 3 costs 8 unfused float32 instructions per complex
//    multiply-add, 18.4 G a launch: 0.55 ms of issue on 132 SMs.  So issue
//    and the output stream must overlap, and nothing else may add bytes.
//
// 2. Design.  The Pallas kernel streams the window axis as its sequential
//    fourth grid dimension with the output tile resident in VMEM.  Here:
//    - Segments on the sector grid.  A main tile is 16 receivers x 32
//      frequencies, one receiver's 32 frequencies to a warp's lanes, so a
//      warp's store is one 256-byte run.  The rows are nf * 8 bytes apart
//      (4104 B at nf = 513, off the 32-byte sector grid), so each row's grid
//      of 32-frequency segments is shifted by delta = 0..3 frequencies to
//      start on a sector (rows r and r + 4 share delta, and so do a thread's
//      4 receivers).  What is left of each row, its first delta and last
//      (nf - delta) % 32 frequencies, joins the neighbouring row's leftovers
//      into runs that start and end on sectors: the tail columns, taken 512
//      at a time in memory order, one column a lane.  So every sector of the
//      output is written whole by one warp store.  (With segments on the
//      frequency grid instead, the sectors two segments share are written by
//      two blocks at different times and reach memory half-written: on an
//      H100 80GB HBM3 at 700 W config 4 took 2.58 ms that way, and 1.21 ms
//      at nf = 512, where the rows lie on the grid.)
//    - Persistent blocks, one per SM (512 threads, 16 warps).  Each main
//      block owns one segment and one group of 64 source rows for the whole
//      launch and walks a contiguous range of receiver tiles; the tail
//      tiles go to the SMs left over and then, a few each, to the main
//      blocks.
//    - Resident sources.  With nwin <= kWC (all of config 4) the block keeps
//      its 64 source rows x nwin windows x 36 frequencies (a segment and its
//      shift, 129,024 B in float32) in shared memory for the whole launch and
//      streams the receiver tiles through a 3-stage cp.async ring, one stage
//      ahead of the next: each receiver value leaves L2 about once a launch
//      (0.29 GB instead of the 3.4 GB a tile of 8 sources x 16 receivers
//      restaged).  One barrier a tile.
//    - Longer records stream the windows kWC at a time; the ring stage then
//      carries 16 source rows' windows beside the receivers'.  Exact, not
//      tuned.
//    - A thread owns 4 sources x 4 receivers at a time and walks the block's
//      source rows in such sub-tiles, writing each sub-tile's outputs before
//      the next one starts (streaming stores in the f32 tier, store_out).
//
// 3. Arithmetic and order.  Float32 on the CUDA cores, no TF32 and no tensor
//    cores: the f32 tier matches XLA's HIGHEST.  The bf16 tier converts each
//    bfloat16 value to float32 exactly and runs the same float32 arithmetic.
//    Each output's sum runs over windows in ascending order inside each slab,
//    is scaled by 1/nwin and added to the output, slab after slab:
//    (a+ib)(c-id) = (ac+bd) + i(bc-ad), each product and sum rounded on its
//    own (__fmul_rn/__fadd_rn keep nvcc from contracting them into FMAs).  So
//    one pair's result depends on neither the tiling, nor the number of
//    source rows, nor the receiver set, and it equals the plain PyTorch
//    version (ops/cross_spectra.py) bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

// Measurement builds only (tools/cross_spectra_variants.py); the port's build
// sets neither.  CS_ALIGN=0 keeps every segment on the 32-frequency grid (the
// rows' shared sectors then span two blocks); CS_TIMING records each block's
// start and end.
#ifndef CS_ALIGN
#define CS_ALIGN 1
#endif
#ifdef CS_TIMING
__device__ unsigned long long g_block_ns[2 * 4096];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#endif

constexpr int kThreads = 512;
constexpr int kPS = 4;                   // sources per thread and sub-tile
constexpr int kPR = 4;                   // columns per thread
constexpr int kSG = 4;                   // warp groups along the sources
constexpr int kCG = 4;                   // warp groups along the columns (= row classes)
constexpr int kCols = kCG * kPR * 32;    // columns per tile
constexpr int kRowsTile = kCG * kPR;     // receivers per main tile
constexpr int kSeg = 32;                 // frequencies per main segment
constexpr int kSlots = kSeg + 4;         // source frequencies a block holds: a
                                         // segment shifted by up to 3, or a tail
constexpr int kWC = 7;                   // windows per tile (all of config 4's)
constexpr int kStages = 3;               // receiver tiles in the ring
constexpr int kResRows = 64;             // resident source rows (4 sub-tiles)
constexpr int kStrRows = kSG * kPS;      // streamed source rows (1 sub-tile)
static_assert(kThreads == kCols, "each thread stages one column of a tile");
static_assert(kThreads == 32 * kSG * kCG, "warps cover the sub-tile grid");
static_assert(kCG == 4, "a column group's receivers share their row class (r mod 4)");
static_assert(kStages >= 2, "the ring needs a stage in flight");

struct Plan {
  int m, nall, nwin, nf, win_block;
  float inv_nwin;
  int aligned;           // segments shifted onto the output's sector grid
  int tcnt[8];           // tail columns of a 4-row period: head, end of each class
  int t4;                // tail columns per 4-row period
  int n_seg;             // main segments: nf / 32
  int n_sg;              // source groups: ceil(m / rows)
  int n_rt;              // main tiles of a segment: ceil(nall / 16)
  int n_tail_cols;
  int n_tail_tiles;      // ceil(n_tail_cols / 512)
  int bp;                // main blocks per (segment, source group)
  int n_main_blocks;     // n_seg * n_sg * bp
  int n_extra_blocks;    // blocks with tail tiles only
  int tail_a;            // tail tiles of an extra block
  int n_chunks;          // window chunks per tile: ceil(nwin / kWC)
};

__device__ __forceinline__ float2 to_f2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);          // exact: bf16 is a truncated float32
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(d), "l"(src), "n"(kBytes), "r"(ok ? kBytes : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// The output's stores: streaming (st.global.cs) in the f32 tier, plain in
// the bf16 tier, where the receiver tiles are half the bytes.  Measured at
// config 4 on an H100 80GB HBM3 at 700 W (tools/cross_spectra_variants.py):
// f32 1.2897 ms streaming, 1.3228 plain; bf16 1.3432 ms streaming, 1.2332
// plain.
template <typename In>
__device__ __forceinline__ void store_out(float2* p, float2 v) {
  if constexpr (sizeof(In) == sizeof(float2)) __stcs(p, v);
  else *p = v;
}

// One tile of work: a main segment (seg >= 0: 16 receivers x 32 frequencies)
// or 512 tail columns (seg = -1), against one source group.
struct Item {
  int seg, sg, tile;
};

struct Range {
  int n_main, tail0, n_tail;             // this block's main tiles and tail tiles
};

__device__ __forceinline__ Range range_of(const Plan& P, int b) {
  const int ti = P.n_sg * P.n_tail_tiles;
  const int ext = P.n_extra_blocks * P.tail_a < ti ? P.n_extra_blocks * P.tail_a : ti;
  if (b >= P.n_main_blocks) {            // extra blocks: tail tiles only
    const int e = b - P.n_main_blocks;
    const int t0 = e * P.tail_a < ext ? e * P.tail_a : ext;
    const int t1 = (e + 1) * P.tail_a < ext ? (e + 1) * P.tail_a : ext;
    return {0, t0, t1 - t0};
  }
  const int j = b % P.bp;                // main blocks: their receiver range, then
  const long long n = P.n_rt;            // a share of the tail tiles left over
  const long long rest = ti - ext;
  const int t0 = ext + static_cast<int>(b * rest / P.n_main_blocks);
  const int t1 = ext + static_cast<int>((b + 1) * rest / P.n_main_blocks);
  return {static_cast<int>((j + 1) * n / P.bp - j * n / P.bp), t0, t1 - t0};
}

__device__ __forceinline__ Item item_of(const Plan& P, const Range& R, int k) {
  const int b = blockIdx.x;
  if (k < R.n_main) {                    // fixed segment and source group
    const int pair = b / P.bp, j = b % P.bp;
    const int rt0 = static_cast<int>(static_cast<long long>(j) * P.n_rt / P.bp);
    return {pair % P.n_seg, pair / P.n_seg, rt0 + k};
  }
  const int i = R.tail0 + (k - R.n_main);
  return {-1, i / P.n_tail_tiles, i % P.n_tail_tiles};
}

// Tail column t (in memory order) -> receiver and frequency: each 4-row
// period holds, per row, the head [0, delta) and the end [nf - e, nf).
__device__ __forceinline__ bool tail_col(const Plan& P, int t, int& r, int& f) {
  if (t >= P.n_tail_cols) return false;
  const int per = t / P.t4;
  int o = t - per * P.t4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (o < P.tcnt[i]) {
      r = 4 * per + i / 2;
      f = (i & 1) ? P.nf - P.tcnt[i] + o : o;
      return true;
    }
    o -= P.tcnt[i];
  }
  return false;
}

// The shift of the segment grid in rows r = 4i + cls: the first frequency
// of such a row that lies on the output's 32-byte sector grid (0 unaligned).
__host__ __device__ __forceinline__ int delta_of(const Plan& P, int cls) {
  return P.aligned ? (4 - (cls * (P.nf & 3)) % 4) % 4 : 0;
}

// The frequency a block's source slot holds (-1: none).
__device__ __forceinline__ int slot_f(const Plan& P, int seg, int i) {
  int f;
  if (seg >= 0) f = seg * kSeg + i;
  else if (P.nf <= kSlots) f = i;
  else f = i < 4 ? i : P.nf - (kSlots - 4) + (i - 4);
  return f < P.nf ? f : -1;
}
__device__ __forceinline__ int tail_slot(const Plan& P, int f) {
  return (P.nf <= kSlots || f < 4) ? f : f - (P.nf - (kSlots - 4)) + 4;
}

template <typename In, bool kResident>
struct Smem {
  static constexpr int kRows = kResident ? kResRows : kStrRows;
  static constexpr int kSrcElems = kRows * kWC * kSlots;   // [row][window][slot]
  static constexpr int kRcvElems = kWC * kCols;            // [window][column]
  // resident: float32 sources, then the receiver ring; streamed: each stage
  // holds its receivers and its sources' windows
  static constexpr int kStageBytes =
      kRcvElems * static_cast<int>(sizeof(In)) +
      (kResident ? 0 : kSrcElems * static_cast<int>(sizeof(In)));
  static constexpr int kBytes =
      (kResident ? kSrcElems * static_cast<int>(sizeof(float2)) : 0) + kStages * kStageBytes;
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

template <bool B>
struct Tag {
  static constexpr bool value = B;
};

template <typename In, bool kResident, bool kOneSlab>
__global__ void __launch_bounds__(kThreads, 1)
cross_spectra_kernel(const In* __restrict__ src, const In* __restrict__ rcv,
                     float2* __restrict__ out, const Plan P) {
  using S = Smem<In, kResident>;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* const s_res = reinterpret_cast<float2*>(smem);      // resident sources
  unsigned char* const ring = smem + (kResident ? S::kSrcElems * sizeof(float2) : 0);
  auto stage_rcv = [&](int k) {
    return reinterpret_cast<In*>(ring + (k % kStages) * S::kStageBytes);
  };
  auto stage_src = [&](int k) { return stage_rcv(k) + S::kRcvElems; };

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int sgrp = warp / kCG, cgrp = warp % kCG;
  const Range R = range_of(P, blockIdx.x);
  const int n_steps = (R.n_main + R.n_tail) * P.n_chunks;
  const In* const src_any = src;

  // the row class of the columns this thread stages (column tid) and of
  // those it computes (its column group): their grid shift and segments
  const int ld_delta = delta_of(P, (warp / kPR) & 3), my_delta = delta_of(P, cgrp);
  const int ld_nseg = (P.nf - ld_delta) / kSeg, my_nseg = (P.nf - my_delta) / kSeg;
  // receiver and frequency of column c of a tile, whose rows have the given
  // grid shift and segment count (false: outside the data)
  auto column = [&](const Item& it, int c, int delta, int nseg, int& r, int& f) {
    if (it.seg < 0)
      return tail_col(P, it.tile * kCols + c, r, f);
    const int w = c >> 5;                // rows r0 + cls + 4q share a class
    r = it.tile * kRowsTile + ((w / kPR) & 3) + 4 * (w % kPR);
    f = it.seg * kSeg + delta + (c & 31);
    return r < P.nall && it.seg < nseg;
  };
  // Stage the source slots [row][window][slot] of rows sg * kRows.. for
  // windows w0..: (row, window) pairs over the warps, slots over the lanes.
  auto stage_source = [&](const Item& it, int w0, int nw, auto&& put) {
    const int f_lo = slot_f(P, it.seg, lane);
    const int f_hi = lane < kSlots - 32 ? slot_f(P, it.seg, 32 + lane) : -1;
    for (int pr = warp; pr < S::kRows * kWC; pr += kThreads / 32) {
      const int row = pr / kWC, j = pr % kWC;
      const int s = it.sg * S::kRows + row;
      const bool ok = j < nw && s < P.m;
      const long long base = (static_cast<long long>(s) * P.nwin + w0 + j) * P.nf;
      put(pr * kSlots + lane, ok && f_lo >= 0, base + f_lo);
      if (lane < kSlots - 32) put(pr * kSlots + 32 + lane, ok && f_hi >= 0, base + f_hi);
    }
  };

  // Stage the receiver tile (and, streamed, the source windows) of step k.
  auto issue = [&](int k) {
    if (k < n_steps) {
      const Item it = item_of(P, R, k / P.n_chunks);
      const int w0 = (k % P.n_chunks) * kWC, nw = min(kWC, P.nwin - w0);
      int r = 0, f = 0;
      const bool ok = column(it, tid, ld_delta, ld_nseg, r, f);
      const In* g = rcv + (static_cast<long long>(r) * P.nwin + w0) * P.nf + f;
      In* d = stage_rcv(k) + tid;
#pragma unroll
      for (int j = 0; j < kWC; ++j)
        if (j < nw) cp_async<sizeof(In)>(d + j * kCols, ok ? g + j * P.nf : src_any, ok);
      if (!kResident) {
        In* ds = stage_src(k);
        stage_source(it, w0, nw, [&](int e, bool sok, long long off) {
          cp_async<sizeof(In)>(ds + e, sok ? src + off : src_any, sok);
        });
      }
    }
    cp_async_commit();                   // one group a step, empty or not
  };

#ifdef CS_TIMING
  if (tid == 0 && blockIdx.x < 4096) g_block_ns[2 * blockIdx.x] = global_ns();
#endif
  for (int k = 0; k < kStages - 1; ++k) issue(k);

  float2 acc[kPS][kPR];
  float2 res[kOneSlab ? 1 : kPS][kOneSlab ? 1 : kPR];
  const float2 zero = make_float2(0.0f, 0.0f);
  int res_key = -2;                      // (segment, source group) held in s_res

  for (int k = 0; k < n_steps; ++k) {
    const Item it = item_of(P, R, k / P.n_chunks);
    const int chunk = k % P.n_chunks;
    const int w0 = chunk * kWC, nw = min(kWC, P.nwin - w0);
    if (kResident) {
      const int key = (it.seg + 1) * P.n_sg + it.sg;
      if (key != res_key) {              // a new segment or source group
        __syncthreads();                 // the old sources are no longer read
        stage_source(it, 0, nw, [&](int e, bool sok, long long off) {
          s_res[e] = sok ? to_f2(src[off]) : zero;
        });
        res_key = key;
      }
    }
    cp_async_wait<kStages - 2>();        // step k's group has landed
    __syncthreads();                     // ... for every thread; step k-1 is done
    issue(k + kStages - 1);              // into the stage step k-1 used

    const bool tail = it.seg < 0;
    if (!tail && it.seg >= my_nseg) continue;   // warp-uniform: no segment here
    // this thread's columns, once a tile: offset r * nf + f in a source's
    // output (-1: outside the data) and, for tail columns, the source slot
    int off[kPR], slot[kPR];
#pragma unroll
    for (int q = 0; q < kPR; ++q) {
      int r = 0, f = 0;
      const bool ok = column(it, (cgrp * kPR + q) * 32 + lane, my_delta, my_nseg, r, f);
      off[q] = ok ? r * P.nf + f : -1;
      slot[q] = tail && ok ? tail_slot(P, f) : 0;
    }
    const In* const rt_s = stage_rcv(k) + (cgrp * kPR) * 32 + lane;
    auto src_at = [&](int row, int j, int sl) {
      const int e = (row * kWC + j) * kSlots + sl;
      return kResident ? s_res[e] : to_f2(stage_src(k)[e]);
    };

    // One sub-tile: all windows of this step, then (last chunk) the stores.
    auto run = [&](auto tail_tag, int row0, int s0) {
      constexpr bool kTail = decltype(tail_tag)::value;
      if (chunk == 0) {
#pragma unroll
        for (int p = 0; p < kPS; ++p)
#pragma unroll
          for (int q = 0; q < kPR; ++q) {
            acc[p][q] = zero;
            if constexpr (!kOneSlab) res[p][q] = zero;
          }
      }
#pragma unroll
      for (int j = 0; j < kWC; ++j) {
        if (j < nw) {                    // windows in ascending order
          float2 a[kPS], c[kPR];
#pragma unroll
          for (int q = 0; q < kPR; ++q) c[q] = to_f2(rt_s[j * kCols + q * 32]);
          if constexpr (!kTail) {
#pragma unroll
            for (int p = 0; p < kPS; ++p) a[p] = src_at(row0 + p, j, my_delta + lane);
          }
#pragma unroll
          for (int q = 0; q < kPR; ++q) {
            if constexpr (kTail) {
#pragma unroll
              for (int p = 0; p < kPS; ++p) a[p] = src_at(row0 + p, j, slot[q]);
            }
#pragma unroll
            for (int p = 0; p < kPS; ++p) {
              // (a.x + i a.y)(c.x - i c.y) = (ac + bd) + i(bc - ad)
              const float re = __fadd_rn(__fmul_rn(a[p].x, c[q].x),
                                         __fmul_rn(a[p].y, c[q].y));
              const float im = __fsub_rn(__fmul_rn(a[p].y, c[q].x),
                                         __fmul_rn(a[p].x, c[q].y));
              acc[p][q].x = __fadd_rn(acc[p][q].x, re);
              acc[p][q].y = __fadd_rn(acc[p][q].y, im);
            }
          }
          if constexpr (!kOneSlab) {
            const int w = w0 + j;
            if ((w + 1) % P.win_block == 0 || w + 1 == P.nwin) {   // a slab ends
#pragma unroll
              for (int p = 0; p < kPS; ++p)
#pragma unroll
                for (int q = 0; q < kPR; ++q) {
                  res[p][q].x = __fadd_rn(res[p][q].x, __fmul_rn(acc[p][q].x, P.inv_nwin));
                  res[p][q].y = __fadd_rn(res[p][q].y, __fmul_rn(acc[p][q].y, P.inv_nwin));
                  acc[p][q] = zero;
                }
            }
          }
        }
      }
      if (chunk + 1 < P.n_chunks) return;    // streamed: more windows to come
#pragma unroll
      for (int p = 0; p < kPS; ++p) {
        const int s = s0 + p;
        if (s >= P.m) break;
        float2* const o = out + static_cast<long long>(s) * P.nall * P.nf;
#pragma unroll
        for (int q = 0; q < kPR; ++q) {
          if (off[q] < 0) continue;
          float2* const dst = o + off[q];
          if constexpr (kOneSlab) {
            // one slab: the output is 0 + acc * (1/nwin), as the plain version adds it
            store_out<In>(dst, make_float2(__fadd_rn(0.0f, __fmul_rn(acc[p][q].x, P.inv_nwin)),
                                    __fadd_rn(0.0f, __fmul_rn(acc[p][q].y, P.inv_nwin))));
          } else {
            store_out<In>(dst, res[p][q]);
          }
        }
      }
    };

    constexpr int kSub = S::kRows / kStrRows;
#pragma unroll 1
    for (int sub = 0; sub < kSub; ++sub) {
      const int row0 = (sub * kSG + sgrp) * kPS;   // first source row in the group
      const int s0 = it.sg * S::kRows + row0;
      if (s0 >= P.m) break;              // warp-uniform
      if (tail) run(Tag<true>{}, row0, s0);
      else run(Tag<false>{}, row0, s0);
    }
  }
  cp_async_wait<0>();
#ifdef CS_TIMING
  __syncthreads();
  if (tid == 0 && blockIdx.x < 4096) g_block_ns[2 * blockIdx.x + 1] = global_ns();
#endif
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

// aligned: every row's segments start on the 32-byte sector grid of the
// output, which holds when each source row's block of nall * nf values starts
// on it (nall * nf a multiple of 4 and an aligned output).
Plan make_plan(int m, int nall, int nwin, int nf, int win_block, float inv_nwin,
               bool resident, bool aligned) {
  Plan P{};
  P.m = m; P.nall = nall; P.nwin = nwin; P.nf = nf;
  P.win_block = win_block; P.inv_nwin = inv_nwin;
  // (the kernel keeps r * nf + f in 32 bits: nall * nf < 2^31, checked by the caller)
  P.aligned = aligned && CS_ALIGN && nf > kSlots &&
              (static_cast<long long>(nall) * nf) % 4 == 0;
  P.t4 = 0;
  for (int c = 0; c < 4; ++c) {
    P.tcnt[2 * c] = delta_of(P, c);
    P.tcnt[2 * c + 1] = (nf - delta_of(P, c)) % kSeg;
    P.t4 += P.tcnt[2 * c] + P.tcnt[2 * c + 1];
  }
  P.n_seg = nf / kSeg;
  P.n_sg = (m + (resident ? kResRows : kStrRows) - 1) / (resident ? kResRows : kStrRows);
  P.n_rt = (nall + kRowsTile - 1) / kRowsTile;
  P.n_tail_cols = (nall / 4) * P.t4;     // < 2^31: at most 34 columns a row
  for (int c = 0; c < nall % 4; ++c) P.n_tail_cols += P.tcnt[2 * c] + P.tcnt[2 * c + 1];
  P.n_tail_tiles = (P.n_tail_cols + kCols - 1) / kCols;
  P.n_chunks = (nwin + kWC - 1) / kWC;
  const int nsm = sm_count();
  const int pairs = P.n_seg * P.n_sg;
  const int tail_tiles = P.n_sg * P.n_tail_tiles;
  if (pairs == 0) {                      // narrower than one segment: tail tiles only
    P.bp = 1;
    P.n_main_blocks = 0;
    P.n_extra_blocks = tail_tiles < nsm ? tail_tiles : nsm;
  } else {
    P.bp = std::max(1, std::min(P.n_rt, nsm / pairs));
    P.n_main_blocks = pairs * P.bp;
    P.n_extra_blocks = std::min(tail_tiles, std::max(0, nsm - P.n_main_blocks));
  }
  // An extra block takes tail tiles up to a main block's load (a tail tile
  // reads four sources a column: ~1.4 main tiles, measured); main blocks
  // share what is left.
  const int main_load = pairs == 0 ? 0 : (P.n_rt + P.bp - 1) / P.bp;
  P.tail_a = P.n_extra_blocks == 0 ? 0
             : pairs == 0 ? (tail_tiles + P.n_extra_blocks - 1) / P.n_extra_blocks
             : std::max(1, std::min((tail_tiles + P.n_extra_blocks - 1) / P.n_extra_blocks,
                                    main_load * 10 / 14));
  return P;
}

template <typename In, bool kResident, bool kOneSlab>
int launch(const void* src, const void* rcv, void* out, const Plan& P, cudaStream_t stream) {
  const auto kernel = cross_spectra_kernel<In, kResident, kOneSlab>;
  constexpr int bytes = Smem<In, kResident>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = P.n_main_blocks + P.n_extra_blocks;
  if (blocks == 0) return 0;
  kernel<<<blocks, kThreads, bytes, stream>>>(static_cast<const In*>(src),
                                              static_cast<const In*>(rcv),
                                              static_cast<float2*>(out), P);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int dispatch(const void* src, const void* rcv, void* out, int m, int nall, int nwin,
             int nf, int win_block, float inv_nwin, cudaStream_t stream) {
  const bool resident = nwin <= kWC;
  const bool aligned = reinterpret_cast<std::uintptr_t>(out) % 32 == 0;
  const Plan P = make_plan(m, nall, nwin, nf, win_block, inv_nwin, resident, aligned);
  const bool one_slab = win_block >= nwin;
  if (resident)
    return one_slab ? launch<In, true, true>(src, rcv, out, P, stream)
                    : launch<In, true, false>(src, rcv, out, P, stream);
  return one_slab ? launch<In, false, true>(src, rcv, out, P, stream)
                  : launch<In, false, false>(src, rcv, out, P, stream);
}

}  // namespace

// src: (m, nwin, nf), rcv: (nall, nwin, nf), out: (m, nall, nf) complex64;
// src and rcv are complex64 (interleaved float2) when bf16 == 0 and
// interleaved bfloat16 pairs when bf16 == 1; all contiguous.  win_block in
// [1, nwin]; inv_nwin is float32(1/nwin).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int cross_spectra(const void* src, const void* rcv, void* out, int m,
                             int nall, int nwin, int nf, int win_block,
                             float inv_nwin, int bf16, void* stream) {
  if (m == 0 || nall == 0 || nf == 0) return 0;
  if (static_cast<long long>(nall) * nf >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);     // offsets are 32-bit
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat162>(src, rcv, out, m, nall, nwin, nf, win_block,
                                         inv_nwin, s)
              : dispatch<float2>(src, rcv, out, m, nall, nwin, nf, win_block, inv_nwin, s);
}

#ifdef CS_TIMING
// Each block's start and end (ns on the global timer) of the last launch.
extern "C" int cross_spectra_block_times(unsigned long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_block_ns,
                                               sizeof(unsigned long long) * 2 * n));
}
#endif

// The launch's grid for an aligned output: main blocks, blocks with tail
// tiles only, and main blocks per (segment, source group).
extern "C" void cross_spectra_plan(int m, int nall, int nwin, int nf, int* main_blocks,
                                   int* tail_blocks, int* bp) {
  const Plan P = make_plan(m, nall, nwin, nf, nwin, 1.0f, nwin <= kWC, true);
  *main_blocks = P.n_main_blocks;
  *tail_blocks = P.n_extra_blocks;
  *bp = P.bp;
}
