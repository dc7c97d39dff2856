// K1: the forward spectra kernel (api.sdft, api.sdft_power).
//
// Replaces the TPU kernel _kernel_spectra_conv
// (sdft_tpu/kernels/analysis_pallas.py:509-629, launched by
// _launch_spectra_conv at :864).  The Pallas kernel contracts a bf16 hi/lo
// Toeplitz split of the tile's deltas against a bf16 split of the
// demodulation table on the TPU's matrix unit; those splits exist only to
// recover f32 accuracy on that unit and are not ported.  Here each bin runs
// the same sum as an f32 FMA recurrence over exact phase tables (see
// common.cuh for the algebra, the Hermitian guards and the ROI).
//
// What bounds it on this card: the O(M*m) spectra store.  Every input
// sample emits m bins — 32 KiB per sample at m = 4096 in packed or planar
// f32, 16 KiB in bf16 planes or f32 power, 8 KiB in bf16 power — while it
// reads one delta and, per tile of K = 128 samples, one carry row of 8
// bytes per bin.  About 25 flops per output bin: below the card's f32 rate
// for those bytes in every form, so each form's bound is its bytes over
// 3.35 TB/s.
//
// How the design answers it: every output byte is written once, in its
// final form, by vector stores of 512 contiguous bytes per warp (two planes
// of them in planar f32); no intermediate plane touches device memory, and
// the tile body (common.cuh) keeps aux in registers, runs no block barrier
// in its loop and gives each thread four independent running sums.  Where
// a row's bytes are no multiple of 256 (m = 1000 in every form), chunk edges
// split 256-byte units of the spectra between two blocks; in the forms
// where that pays (paceable below), the row's chunks run as one paced
// thread-block cluster, whose blocks store each 8-row step together
// (common.cuh, "Paced clusters").  Device times at m = 4096,
// M = 65536 (NVIDIA H100 80GB HBM3, 700 W; kernels/compare_bodies.py, in
// turns with the previous body of one bin per thread and aux in shared
// memory): planar f32 0.71-0.74 ms (was 0.80-0.81), packed f32 0.78
// (0.77), planar bf16 0.40 (0.64), power f32 0.40 (0.60), power bf16 0.30
// (0.60-0.61); 87, 83, 82, 83 and 55 % of their bounds in chip_smoke.py.
// torch.stft at hop 1 on the same samples, the nearest library call, took
// 2.36 ms there.

#include "common.cuh"

namespace sdft {

template <int STORE, bool VEC, int HALO, bool PACED>
__global__ void __launch_bounds__(WARPS * 32)
spectra_kernel(TileArgs a, void* out0, void* out1) {
  spectra_tiles<K1_STRIP, K1_STRIP, HALO, STORE, false, VEC, PACED>(a, out0, out1, nullptr,
                                                                   nullptr, 0.f, 0);
}

// Store forms with a paced instantiation: bit `store` of SDFT_PACED_STORES,
// which kernels/_build.py sets from kernels/spectra.py's PACED_FORMS (the
// forms whose time pacing shortens where their rows split 256-byte units).
#ifndef SDFT_PACED_STORES
#error "SDFT_PACED_STORES: build through kernels/_build.py"
#endif
constexpr bool paceable(int store) { return (SDFT_PACED_STORES >> store) & 1; }

template <int STORE, bool VEC, bool PACED>
int launch_halo(const TileArgs& a, cudaStream_t s, void* out0, void* out1) {
  switch (a.halo) {
    case 0: return launch_tiles<K1_STRIP>(spectra_kernel<STORE, VEC, 0, PACED>, a, VEC, s, out0, out1);
    case 1: return launch_tiles<K1_STRIP>(spectra_kernel<STORE, VEC, 1, PACED>, a, VEC, s, out0, out1);
    case 2: return launch_tiles<K1_STRIP>(spectra_kernel<STORE, VEC, 2, PACED>, a, VEC, s, out0, out1);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A paced launch needs a paceable form and vector stores.
template <int STORE>
int launch(const TileArgs& a, bool vec, cudaStream_t s, void* out0, void* out1) {
  if (a.paced) {
    if constexpr (paceable(STORE))
      if (vec) return launch_halo<STORE, true, true>(a, s, out0, out1);
    return (int)cudaErrorInvalidValue;
  }
  return vec ? launch_halo<STORE, true, false>(a, s, out0, out1)
             : launch_halo<STORE, false, false>(a, s, out0, out1);
}

}  // namespace sdft

// One launch for a batch of C channels of M samples (TileArgs); C = 1 is a
// single block.  paced: launch each row of bin chunks as one cluster, paced
// a FINE step at a time (kernels/spectra.py: paced).
extern "C" int sdft_spectra_launch(const void* c0, const void* delta,
                                   const void* table, void* out0, void* out1,
                                   int m, int C, int M, int K, int nt, int halo,
                                   float w0, float w1, float w2, int roi_first,
                                   int roi_last, int store, int vector, int paced,
                                   void* stream) {
  using namespace sdft;
  const TileArgs a{static_cast<const float2*>(c0),
                   static_cast<const float*>(delta),
                   static_cast<const float2*>(table),
                   m, C, M, K, nt, halo, w0, w1, w2, roi_first, roi_last, paced != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vector != 0;
  switch (store) {
    case PACKED_F32: return launch<PACKED_F32>(a, v, s, out0, out1);
    case PLANAR_F32: return launch<PLANAR_F32>(a, v, s, out0, out1);
    case PLANAR_BF16: return launch<PLANAR_BF16>(a, v, s, out0, out1);
    case POWER_F32: return launch<POWER_F32>(a, v, s, out0, out1);
    case POWER_BF16: return launch<POWER_BF16>(a, v, s, out0, out1);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM of the packed-f32 spectra kernel for Hann (a
// diagnostic).
extern "C" int sdft_spectra_occupancy(int K) {
  return sdft::occupancy<sdft::K1_STRIP>(sdft::spectra_kernel<sdft::PACKED_F32, true, 1, false>,
                                         K);
}

// Resident clusters of `chunks` blocks of the paced planar-f32 spectra
// kernel for Hann (a diagnostic).
extern "C" int sdft_spectra_clusters(int K, int chunks) {
  return sdft::clusters<sdft::K1_STRIP>(sdft::spectra_kernel<sdft::PLANAR_F32, true, 1, true>,
                                        K, chunks);
}
