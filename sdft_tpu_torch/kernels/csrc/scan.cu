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
// per bin in the packed f32 layout roundtrip_hopped reads: 64 MB, 0.020 ms, at
// m = 1000 and B = 8000).  The y reduction adds 4 flops per bin.  At that
// size one channel has only 16 chunks of 32 strips by 63 tiles of work, so
// latency, not the store, is what a design can lose; a channel batch is one
// launch over all its channels' tiles (common.cuh), C times the work.
//
// How the design answers it: the spectra are written once, packed, by
// coalesced vector stores, and y is reduced from registers: each warp sums
// eight rows at a time by a transposed shuffle butterfly (nine shuffles
// for eight rows) over its chunk of bins, so synthesis costs no second
// read of the spectra and no block barrier.  Strips of two bins
// (K2_STRIP) keep twice K1's warps in flight on these small blocks.
//
// y in a fixed order: every (chunk, channel, row) has exactly one writer,
// so the tile kernel stores each chunk's partial row sum into a scratch
// buffer y_part[chunk, channel * M + row] (16 x 8000 f32, 0.5 MB, per
// channel at m = 1000 and B = 8000) and a second small kernel,
// scan_kernel_rows, adds the chunks in ascending order.  Two launches on
// the same inputs give the same y bit for bit (an atomicAdd per row and
// warp, the previous design, added them in an order that changed from run
// to run).
//
// Device time at m = 1000, B = 8000 (NVIDIA H100 80GB HBM3, 700 W;
// kernels/compare_bodies.py, in turns with the atomic form): 0.0260-0.0264
// ms for both kernels, against 0.0244 with one atomicAdd per row and warp;
// 75 % of its bound (0.0196 ms).  The atomic form had taken 0.024-0.025 ms
// against 0.032-0.033 for the earlier body of one bin per thread with aux
// in shared memory.

#include "common.cuh"

namespace sdft {

template <int STORE, bool VEC, int HALO>
__global__ void __launch_bounds__(WARPS * 32)
scan_kernel(TileArgs a, void* out0, void* out1, const float2* synth,
            float* y, float y_scale) {
  spectra_tiles<K2_STRIP, HALO, STORE, true, VEC>(a, out0, out1, synth, y, y_scale);
}

template <int STORE, bool VEC>
int launch_halo(const TileArgs& a, cudaStream_t s, void* out0, void* out1,
                const float2* synth, float* y, float y_scale) {
  switch (a.halo) {
    case 0: return launch_tiles<K2_STRIP>(scan_kernel<STORE, VEC, 0>, a, VEC, s, out0, out1, synth, y, y_scale);
    case 1: return launch_tiles<K2_STRIP>(scan_kernel<STORE, VEC, 1>, a, VEC, s, out0, out1, synth, y, y_scale);
    case 2: return launch_tiles<K2_STRIP>(scan_kernel<STORE, VEC, 2>, a, VEC, s, out0, out1, synth, y, y_scale);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y[k] = sum of the chunks' partial rows y_part[c, k], c = 0, 1, ... in
// order, over the n = C*M rows of the batch: one thread per row, reads
// coalesced across the warp.
__global__ void scan_kernel_rows(const float* __restrict__ y_part, float* __restrict__ y,
                                 int chunks, long long n) {
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    float s = y_part[k];
    for (int c = 1; c < chunks; ++c) s += y_part[(size_t)c * n + k];
    y[k] = s;
  }
}

template <int STORE>
int launch(const TileArgs& a, bool vec, cudaStream_t s, void* out0, void* out1,
           const float2* synth, float* y_part, float* y, float y_scale) {
  const int err = vec ? launch_halo<STORE, true>(a, s, out0, out1, synth, y_part, y_scale)
                      : launch_halo<STORE, false>(a, s, out0, out1, synth, y_part, y_scale);
  if (err != 0) return err;
  const int threads = 256, chunks = (a.m + chunk_bins(K2_STRIP) - 1) / chunk_bins(K2_STRIP);
  const long long n = (long long)a.C * a.M;
  scan_kernel_rows<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(y_part, y,
                                                                              chunks, n);
  return (int)cudaGetLastError();
}

}  // namespace sdft

// One launch for a batch of C channels of M samples (TileArgs).  y_part:
// (y_chunks, C*M) float scratch, one row per chunk; y_chunks must be
// ceil(m / chunk_bins(K2_STRIP)), the chunks this build's kernels write;
// y: (C, M).
extern "C" int sdft_scan_launch(const void* c0, const void* delta,
                                const void* table, const void* synth,
                                void* out0, void* out1, void* y_part, int y_chunks,
                                void* y, int m, int C, int M,
                                int K, int nt, int halo, float w0, float w1,
                                float w2, int roi_first, int roi_last,
                                float y_scale, int store, int vector,
                                void* stream) {
  using namespace sdft;
  if (y_chunks != (m + chunk_bins(K2_STRIP) - 1) / chunk_bins(K2_STRIP))
    return (int)cudaErrorInvalidValue;
  const TileArgs a{static_cast<const float2*>(c0),
                   static_cast<const float*>(delta),
                   static_cast<const float2*>(table),
                   m, C, M, K, nt, halo, w0, w1, w2, roi_first, roi_last};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* sy = static_cast<const float2*>(synth);
  float* yp = static_cast<float*>(y_part);
  float* yy = static_cast<float*>(y);
  const bool v = vector != 0;
  switch (store) {
    case PACKED_F32: return launch<PACKED_F32>(a, v, s, out0, out1, sy, yp, yy, y_scale);
    case PLANAR_F32: return launch<PLANAR_F32>(a, v, s, out0, out1, sy, yp, yy, y_scale);
    case NO_SPECTRA: return launch<NO_SPECTRA>(a, v, s, out0, out1, sy, yp, yy, y_scale);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of the packed-f32 scan kernel for Hann (a
// diagnostic).
extern "C" int sdft_scan_occupancy(int K) {
  return sdft::occupancy<sdft::K2_STRIP>(sdft::scan_kernel<sdft::PACKED_F32, true, 1>, K);
}
