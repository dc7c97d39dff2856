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
// size a launch has only 16 chunks of 32 strips by 63 tiles of work, so
// latency, not the store, is what a design can lose.
//
// How the design answers it: the spectra are written once, packed, by
// coalesced vector stores, and y is reduced from registers: each warp sums
// eight rows at a time by a transposed shuffle butterfly (nine shuffles
// for eight rows) and adds each row with one atomicAdd, so synthesis
// costs no second read of the spectra and no block barrier.  Strips of
// two bins (K2_STRIP) keep twice K1's warps in flight on these small
// blocks.  The atomics sum the warps' partial rows in an order that
// changes from run to run, so y is reproducible only to f32 rounding.
// Device time at m = 1000, B = 8000 (NVIDIA H100 80GB HBM3, 700 W;
// kernels/compare_bodies.py, in turns with the previous body of one bin
// per thread and aux in shared memory): 0.024-0.025 ms (was 0.032-0.033),
// 77-81 % of its bound.

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

template <int STORE>
int launch(const TileArgs& a, bool vec, cudaStream_t s, void* out0, void* out1,
           const float2* synth, float* y, float y_scale) {
  return vec ? launch_halo<STORE, true>(a, s, out0, out1, synth, y, y_scale)
             : launch_halo<STORE, false>(a, s, out0, out1, synth, y, y_scale);
}

}  // namespace sdft

extern "C" int sdft_scan_launch(const void* c0, const void* delta,
                                const void* table, const void* synth,
                                void* out0, void* out1, void* y, int m, int M,
                                int K, int nt, int halo, float w0, float w1,
                                float w2, int roi_first, int roi_last,
                                float y_scale, int store, int vector,
                                void* stream) {
  using namespace sdft;
  const TileArgs a{static_cast<const float2*>(c0),
                   static_cast<const float*>(delta),
                   static_cast<const float2*>(table),
                   m, M, K, nt, halo, w0, w1, w2, roi_first, roi_last};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* sy = static_cast<const float2*>(synth);
  float* yy = static_cast<float*>(y);
  const bool v = vector != 0;
  switch (store) {
    case PACKED_F32: return launch<PACKED_F32>(a, v, s, out0, out1, sy, yy, y_scale);
    case PLANAR_F32: return launch<PLANAR_F32>(a, v, s, out0, out1, sy, yy, y_scale);
    case NO_SPECTRA: return launch<NO_SPECTRA>(a, v, s, out0, out1, sy, yy, y_scale);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of the packed-f32 scan kernel for Hann (a
// diagnostic).
extern "C" int sdft_scan_occupancy(int K) {
  return sdft::occupancy<sdft::K2_STRIP>(sdft::scan_kernel<sdft::PACKED_F32, true, 1>, K);
}
