// K2: the fused analysis + synthesis kernel (roundtrip_hopped at hop = 1,
// roundtrip_block_fused).
//
// Replaces the TPU kernel _kernel (sdft_tpu/kernels/analysis_pallas.py:
// 147-251, tail _finish_tile :254-370, launched by _launch at :986).  That
// kernel walks the time tiles in order and carries the accumulator from one
// grid step to the next in VMEM scratch; CUDA blocks run in no order, so
// nothing is carried between blocks here.  Instead the wrapper's prologue
// (the one K1 uses, sdft_tpu_torch/kernels/spectra.py) derives every
// tile's carry up front with one exact-f32 totals GEMM and a prefix sum
// over tiles, together with the next accumulator acc'.  The kernel then
// shares K1's device code (common.cuh) and adds the synthesis reduction
//
//     y[k] = 2 * sum_i (Re out[k,i] * Re s[i] - Im out[k,i] * Im s[i])
//
// with s the synthesis twiddles (latency and ROI folded in).  The TPU
// kernel's cumsum modes (mxu2, mxu3, vpu, mxu_f32) are tricks for the
// TPU's matrix and vector units; this kernel has one exact-f32 scan.
//
// What bounds it on this card: at hop = 1 every sample emits its whole
// spectrum, so the O(M*m) spectra store bounds it as it bounds K1 (8 bytes
// per bin in the packed f32 layout roundtrip_hopped reads: 2.82 GB, 0.843
// ms at 3.35 TB/s, at m = 1000 on the hop-1 chain's 8 x 44100 block).  The
// y reduction adds 4 flops per bin.  What a design can lose beside the
// store is the work a lane does for its chunk rather than for its bins:
// the HALO guard recurrences every lane runs whatever its bins (+50 %
// recurrences at 2 bins a thread with Hann), the y butterfly (nine shuffles
// per eight rows and chunk) and the chunks' partial rows of y.
//
// How the design answers it: the spectra are written once, packed, by
// coalesced vector stores, and y is reduced from registers: each warp sums
// eight rows at a time by a transposed shuffle butterfly over its chunk of
// bins, so synthesis costs no second read of the spectra and no block
// barrier.  A thread owns two 2-bin strips 64 bins apart (K2_BINS = 4 in
// strips of K2_STRIP = 2), which halves the guard recurrences, butterflies
// and partial rows a bin against one strip a thread, while each store
// instruction of a warp still writes 512 contiguous bytes (4 contiguous
// bins a thread store two 16-byte halves 32 bytes apart: 1.100 ms at
// 8 x 44100, and slower than one strip at 1 x 8000).  On
// an NVIDIA H100 80GB HBM3 at 700 W (kernels/compare_bodies.py, m = 1000,
// Hann, in turns with one strip a thread): 8 x 44100 1.048-1.050 ms
// against 1.150-1.178, 80 % of the bound; y alone (NO_SPECTRA) 0.417-0.421
// against 0.503; 8 x 8000 0.183-0.184 against 0.198-0.199; 1 x 8000
// 0.025-0.026 against 0.027.  A one-wave grid whose last round of tile
// groups runs part full costs nothing measurable there: 8 x M for
// M = 38912 .. 50688 read the same time a sample whatever the last round's
// fill.  Eight bins a thread need 255 registers and spill.
//
// y in a fixed order: every (chunk, channel, row) has exactly one writer,
// so the tile kernel stores each chunk's partial row sum into a scratch
// buffer y_part[chunk, channel, row] (8 x 8 x 44128 f32, 11.3 MB, at m =
// 1000 on 8 x 44100) and a second small kernel, scan_kernel_rows, adds
// the chunks in ascending order.  Two launches on
// the same inputs give the same y bit for bit (an atomicAdd per row and
// warp, an earlier design, added them in an order that changed from run
// to run).  A channel's rows are y_rows = M rounded up to 32 apart, so the
// eight rows a warp stores at once fill one 32-byte sector: at M = 44100
// (M % 8 = 4) the odd channels' stores split sectors, and K2 ran 2-3 %
// slower a sample than at M = 44032 or 44160.

#include "common.cuh"

namespace sdft {

template <int STORE, bool VEC, int HALO>
__global__ void __launch_bounds__(WARPS * 32)
scan_kernel(TileArgs a, void* out0, void* out1, const float2* synth, float* y, float y_scale,
            int y_rows) {
  spectra_tiles<K2_BINS, K2_STRIP, HALO, STORE, true, VEC>(a, out0, out1, synth, y, y_scale,
                                                          y_rows);
}

template <int STORE, bool VEC>
int launch_halo(const TileArgs& a, cudaStream_t s, void* out0, void* out1,
                const float2* synth, float* y, float y_scale, int y_rows) {
  switch (a.halo) {
    case 0: return launch_tiles<K2_BINS, K2_STRIP>(scan_kernel<STORE, VEC, 0>, a, VEC, s, out0, out1, synth, y, y_scale, y_rows);
    case 1: return launch_tiles<K2_BINS, K2_STRIP>(scan_kernel<STORE, VEC, 1>, a, VEC, s, out0, out1, synth, y, y_scale, y_rows);
    case 2: return launch_tiles<K2_BINS, K2_STRIP>(scan_kernel<STORE, VEC, 2>, a, VEC, s, out0, out1, synth, y, y_scale, y_rows);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y[ch, i] = sum of the chunks' partial rows y_part[c, ch, i], c = 0, 1, ...
// in order, over the C channels' M rows (y_part's rows y_rows >= M apart):
// one thread per row, reads coalesced across the warp.
__global__ void scan_kernel_rows(const float* __restrict__ y_part, float* __restrict__ y,
                                 int chunks, int M, int y_rows, long long n) {
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    const long long ch = k / y_rows;
    const int i = (int)(k - ch * y_rows);
    if (i >= M) continue;
    float s = y_part[k];
    for (int c = 1; c < chunks; ++c) s += y_part[(size_t)c * n + k];
    y[ch * M + i] = s;
  }
}

template <int STORE>
int launch(const TileArgs& a, bool vec, cudaStream_t s, void* out0, void* out1,
           const float2* synth, float* y_part, int y_rows, float* y, float y_scale) {
  const int err = vec ? launch_halo<STORE, true>(a, s, out0, out1, synth, y_part, y_scale, y_rows)
                      : launch_halo<STORE, false>(a, s, out0, out1, synth, y_part, y_scale, y_rows);
  if (err != 0) return err;
  const int threads = 256, chunks = (a.m + chunk_bins(K2_BINS) - 1) / chunk_bins(K2_BINS);
  const long long n = (long long)a.C * y_rows;
  scan_kernel_rows<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      y_part, y, chunks, a.M, y_rows, n);
  return (int)cudaGetLastError();
}

}  // namespace sdft

// One launch for a batch of C channels of M samples (TileArgs).  y_part:
// (y_chunks, C, y_rows) float scratch; y_chunks must be
// ceil(m / chunk_bins(K2_BINS)), the chunks this build's kernels write, and
// y_rows >= M a multiple of 8; y: (C, M).
extern "C" int sdft_scan_launch(const void* c0, const void* delta,
                                const void* table, const void* synth,
                                void* out0, void* out1, void* y_part, int y_chunks,
                                int y_rows, void* y, int m, int C, int M,
                                int K, int nt, int halo, float w0, float w1,
                                float w2, int roi_first, int roi_last,
                                float y_scale, int store, int vector,
                                void* stream) {
  using namespace sdft;
  if (y_chunks != (m + chunk_bins(K2_BINS) - 1) / chunk_bins(K2_BINS) || y_rows < M ||
      y_rows % 8)
    return (int)cudaErrorInvalidValue;
  const TileArgs a{static_cast<const float2*>(c0),
                   static_cast<const float*>(delta),
                   static_cast<const float2*>(table),
                   m, C, M, K, nt, halo, w0, w1, w2, roi_first, roi_last, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* sy = static_cast<const float2*>(synth);
  float* yp = static_cast<float*>(y_part);
  float* yy = static_cast<float*>(y);
  const bool v = vector != 0;
  switch (store) {
    case PACKED_F32: return launch<PACKED_F32>(a, v, s, out0, out1, sy, yp, y_rows, yy, y_scale);
    case PLANAR_F32: return launch<PLANAR_F32>(a, v, s, out0, out1, sy, yp, y_rows, yy, y_scale);
    case NO_SPECTRA: return launch<NO_SPECTRA>(a, v, s, out0, out1, sy, yp, y_rows, yy, y_scale);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of the packed-f32 scan kernel for Hann (a
// diagnostic).
extern "C" int sdft_scan_occupancy(int K) {
  return sdft::occupancy<sdft::K2_BINS>(sdft::scan_kernel<sdft::PACKED_F32, true, 1>, K);
}
