// Shared device code of the two SDFT kernels (spectra.cu, scan.cu).
//
// Both kernels compute, for every sample k of a block and every bin i, the
// windowed spectrum of the modulated sliding DFT.  The sequential part (the
// carried accumulator) is derived up front by the wrapper's prologue
// (sdft_tpu_torch/kernels/spectra.py, spectra_prologue): for each tile t of
// K samples it hands over c0[t, i], the carry in the tile's demodulated
// frame.  Inside a tile the kernel needs only the tile's deltas and the
// exact phase table
//
//     table[k, i] = T_i^k,  k = 0..K,  T_i = exp(-j*pi*i/m)
//
// (integer exponents k*i mod 2m, evaluated in float64 on the host), and
// runs one f32 running sum per bin:
//
//     u[k, i]   = c0[t, i] + sum_{j<=k} delta[t*K + j] * T_i^j
//     aux[k, i] = u[k, i] * conj(T_i^(k+1))
//     out[k, i] = (w0*aux[i] + w1*(aux[i-1] + aux[i+1])
//                  + w2*(aux[i-2] + aux[i+2])) * roi(i)
//
// with the window taps w already scaled by 1/(2m).  The phasor of row
// k = 8a + b is the product of two exact table entries,
// T^k = T^(8a) * T^b: the K/8 + 1 coarse rows T^(8a) and the seven fine
// rows T^b (b = 1..7) of the block's bins sit in shared memory, laid out
// [row][pair of bins][lane] so that each lane's 16-byte loads are free of
// bank conflicts (in registers the fine rows took 56 registers a thread and
// spilled).  Each phasor carries one product's rounding and no error
// accumulates along the tile.
//
// The Hermitian guards of the reference (c/src/sdft/sdft.h:589-595) are
// applied explicitly: the bin -g reads conj(bin g) and the bin m-1+g reads
// conj(bin m-1-g) — the mirror at the top edge is around m-1, not m.  A
// mirrored bin runs its source bin's recurrence on the conjugated carry and
// phasors: negating an imaginary part is exact and round-to-nearest is
// symmetric, so its aux is bit for bit the conjugate of the source's, with
// no per-row select.  Bins outside the ROI are never accumulated: their
// phasors and carry are zero, so their aux is zero, and so are their guards;
// an output bin outside the ROI has zero window taps.
//
// Geometry.  A thread owns V bins in strips of SEG consecutive bins, 32*SEG
// bins apart (K1: one strip of K1_STRIP = 4; K2: two strips of K2_STRIP =
// 2, scan.cu), and runs their V independent running
// sums, so it has V-way instruction-level parallelism and no thread is a
// guard.  A warp's strips are one chunk of 32*V output bins, and each store
// instruction of a warp writes one strip of each of its lanes: 32*SEG
// contiguous elements.  K1's chunks of 128 bins are 256, 512 or 1024 bytes
// of a row, so a chunk starts on a 256-byte boundary exactly when its row
// does: every row where the row's bytes are a multiple of 256 (m = 1024,
// 4096), else rows in turn (planar f32 at m = 1000: row r starts 160*r mod
// 256 bytes into a unit, 7 rows in 8 off it; see "Paced clusters" below).
// The window stencil reads inner neighbours from the thread's own registers
// and the strip edges from lanes -1 and +1 by warp shuffles (rotated across
// the warp where a lane has several strips, so lane 0 and lane 31 read
// their other strips' neighbours from lane 31 and lane 0); the chunk's edges
// come from guard slots: every lane runs HALO extra recurrences, those of
// lanes 0-15 for the bins left of the chunk and those of lanes 16-31 for
// the bins right of it, and lane 0 and lane 31 read them.  So aux never
// touches shared memory and no block barrier runs inside the tile loop.
// A block's WARPS warps share one chunk, and its phasor rows, loaded once
// under the block's only barrier, and walk different tiles: those of every channel of a batch, one
// launch for the batch (the counterpart of the JAX package's vmap over the
// Pallas call, which prepends a channel axis to its grid).  Control flow
// depends on the block and the arguments only (a warp past the last tile
// recomputes it and stores nothing; rows past M run on zero deltas,
// unstored), so the compiler sees every shuffle converged.  The window's
// halo (0, 1, 2) is a template parameter: the stencil, the guard slots and
// the shuffles are unrolled.
//
// Stores: a strip of a row is V consecutive elements of each output plane,
// written by one vector store per plane (two for K1's packed form) when
// m % V == 0 — 16 bytes for K1's f32 planes and packed f32, 8 for bf16 and
// power bf16 — and element by element otherwise (the wrapper chooses, the
// launcher checks).  Stores are streaming (st.global.cs): the kernel never
// reads its output back, and default write-back stores (a build with
// -DSDFT_WB_STORES) ran 1-2 % slower at every m near 1000.
//
// Paced clusters (K1 only; kernels/spectra.py: paced).  Where a row's bytes
// are no multiple of 256, the edge between chunks c and c+1 of most rows
// splits a 256-byte unit of the spectra between blocks (c, y) and (c+1, y),
// which otherwise run unsynchronized on two SMs, so the unit's halves reach
// memory far apart.  On this card that costs store bandwidth: K1 planar f32
// on 8 channels at equal bytes read 86-88 % of its bound at m = 960 and
// 1024 (256-byte rows), 81 % at 992 (half its rows off the unit), 79-80 %
// at 1008 (3/4), 77 % at 1000 (7/8), and 87 % at m = 1000 written into rows
// padded to 1024 bins.  A paced launch makes each row of chunks (2 to
// MAX_CLUSTER of them, so 128 < m <= 1024: a row of one chunk has no edge
// between blocks) one thread-block cluster: every thread arrives
// on the cluster's barrier after a FINE step's stores and waits before the
// next step's, so the blocks sharing a unit store it within one step of each
// other.  At m = 1000 (8 x 44100) that took planar f32 from 77 to 84-85 % of
// its bound (1.090 to 0.99 ms), planar bf16 from 41 to 70 % and power f32
// from 74 to 79 %; packed f32 and power bf16 lost 1-5 points with it and
// are never paced (spectra.cu: paceable).  The pacing is a template
// parameter: a runtime flag around the barrier cost the unpaced forms up to
// 6 % at m = 4096.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// and kernels/compare_bodies.py): at m = 4096 and M = 65536 every store
// form is bound by its bytes (the f32 forms 2.17 GB, bf16 planar and power
// f32 1.10 GB, power bf16 0.56 GB, with 21 MB of carries and table read;
// about 25 flops per bin,
// 0.10 ms at the f32 peak).  Before this design the tile body, not the
// store, set the pace of the narrow forms: (a) each bin's aux went through
// shared memory and was read 1 + 2*halo times by the stencil, (b) two block
// barriers ran every 16 rows, (c) guard lanes ran a second running sum while
// three warps waited, (d) one bin per thread left one dependent FMA chain
// per thread, (e) bf16 and power stores were 2 bytes per thread.  Here
// (a)-(c) are gone (registers and shuffles, no barrier, guard slots on
// every lane), (d) is V chains per thread and (e) is 8- or 16-byte stores.
// Measured in turns with the previous body: planar f32 0.71-0.74 ms (87 %
// of its bound), packed f32 0.78 ms (83 %), planar bf16 0.40 ms (82 %),
// power f32 0.40 ms (83 %), power bf16 0.30 ms (55 %: its stores leave at
// 1.85 TB/s where the 1.1 GB forms reach 2.76 TB/s, so the instruction
// rate, not the store, bounds it).  A 30-strip chunk with guard lanes,
// tried first, left chunks that split a 32-byte sector (bf16, V = 4) or a
// 128-byte line, and those stores ran far below the aligned ones; 32-strip
// chunks fixed it.
//
// No tensor cores: the running sum costs O(1) flops per output bin; a
// Toeplitz product on the MMA units costs O(K) per bin and needs the bf16
// hi/lo splits of the TPU kernel, which are not ported.  No TMA stores:
// they would stage the output back through shared memory, the traffic
// this design removes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

// Bins per thread of K1 and of K2 (spectra.py: STRIP and scan.py: BINS,
// which must match).  -DSDFT_K1_STRIP=2 or 8 (and SDFT_K2_STRIP=2 or 8)
// builds another width for kernels/compare_bodies.py.
#ifndef SDFT_K1_STRIP
#define SDFT_K1_STRIP 4
#endif
#ifndef SDFT_K2_STRIP
#define SDFT_K2_STRIP 4
#endif

namespace sdft {

constexpr int K1_STRIP = SDFT_K1_STRIP;
// K2: each thread's K2_BINS bins lie in 2-bin strips (K2_STRIP, one 16-byte
// packed store a row), 64 bins apart (scan.cu)
constexpr int K2_STRIP = 2;
constexpr int K2_BINS = SDFT_K2_STRIP;
constexpr int WARPS = 4;     // warps per block, one bin chunk, different tiles
constexpr int FINE = 8;      // rows per coarse phasor
constexpr int MAX_HALO = 2;  // Blackman's two-bin stencil
constexpr int MAX_K = 256;   // largest tile the wrappers may request
constexpr int MAX_CLUSTER = 8;  // largest portable cluster: a paced launch's chunks
constexpr unsigned FULL = 0xffffffffu;

// Output forms of the spectra store.
enum Store {
  PACKED_F32 = 0,   // one (M, m, 2) float tensor, (re, im) interleaved
  PLANAR_F32 = 1,   // two (M, m) float planes
  PLANAR_BF16 = 2,  // two (M, m) bfloat16 planes
  POWER_F32 = 3,    // one (M, m) float plane of |dft|^2
  POWER_BF16 = 4,   // one (M, m) bfloat16 plane of |dft|^2
  NO_SPECTRA = 5,   // no spectra (synthesis only)
};

// A batch of C channels of M samples each: every channel has its own nt
// tiles, carries and deltas; the table is shared.  Channel c's arrays start
// c * (nt*m) carries, c * (nt*K) deltas and c * (M*m) output bins in.
struct TileArgs {
  const float2* c0;     // (C, nt, m) per-tile carry, demodulated frame
  const float* delta;   // (C, nt*K) comb deltas, each row zero padded past M
  const float2* table;  // (K+1, m) T_i^k
  int m, C, M, K, nt, halo;
  float w0, w1, w2;     // window taps times the analysis weight 1/(2m)
  int roi_first, roi_last;
  int paced;  // K1: clusters of a row of chunks, paced a FINE step at a time
};

// The output's row stride in bins: m.  A build with -DSDFT_ROW_STRIDE=<bins>
// writes every row that many bins apart instead (K1 and K2 alike), for
// kernels/compare_bodies.py's probe of rows padded past m; its launcher
// refuses m above it.
#ifdef SDFT_ROW_STRIDE
constexpr int ROW_STRIDE = SDFT_ROW_STRIDE;
#else
constexpr int ROW_STRIDE = 0;
#endif

__host__ __device__ __forceinline__ int row_stride(const TileArgs& a) {
  return ROW_STRIDE ? ROW_STRIDE : a.m;
}

// Output bins of one warp (and one block): 32 strips.
__host__ __device__ inline int chunk_bins(int V) { return 32 * V; }

// Shared memory of a block: K/8 + 1 coarse and seven fine phasor rows for
// the strips and the four guard bins, and each warp's K deltas.
inline size_t smem_bytes(int V, int K) {
  const size_t rows = K / FINE + FINE;
  return sizeof(float2) * rows * (32 * V + 2 * MAX_HALO) + sizeof(float) * (size_t)WARPS * K;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// The table or carry entry of a bin: its source bin's value, conjugated on
// a mirrored bin, zero on a bin that is not accumulated.
__device__ __forceinline__ float2 bin_value(const float2* row, int s, bool live,
                                            bool cj) {
  if (!live) return make_float2(0.f, 0.f);
  const float2 v = __ldg(row + s);
  return make_float2(v.x, cj ? -v.y : v.y);
}

// Phasor row c of this lane's strip: V/2 conflict-free 16-byte loads
// (layout [row][pair][lane]).
template <int V>
__device__ __forceinline__ void phasor_row(const float4* ph, int c, int lane,
                                           float2 (&r)[V]) {
#pragma unroll
  for (int q = 0; q < V / 2; ++q) {
    const float4 v = ph[((size_t)c * (V / 2) + q) * 32 + lane];
    r[2 * q] = make_float2(v.x, v.y);
    r[2 * q + 1] = make_float2(v.z, v.w);
  }
}

// Streaming (evict-first) store of one vector; -DSDFT_WB_STORES builds the
// default write-back store instead (kernels/compare_bodies.py's store-hint
// probe).
template <typename T>
__device__ __forceinline__ void st_out(T* p, T v) {
#ifdef SDFT_WB_STORES
  *p = v;
#else
  __stcs(p, v);
#endif
}

// The split barrier of a cluster (PTX barrier.cluster): arrive, then wait
// for every thread of the cluster to have arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

__device__ __forceinline__ unsigned bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// V consecutive values of one f32 plane, as 16-byte (or 8-byte) stores.
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
  if constexpr (V == 2) {
    st_out(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      st_out(reinterpret_cast<float4*>(p) + q,
             make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  }
}

// V consecutive values of one bf16 plane: 2*V bytes in one store.
template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 2) {
    st_out(reinterpret_cast<unsigned*>(p), bf16x2(v[0], v[1]));
  } else if constexpr (V == 4) {
    st_out(reinterpret_cast<uint2*>(p), make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3])));
  } else {
#pragma unroll
    for (int q = 0; q < V / 8; ++q)
      st_out(reinterpret_cast<uint4*>(p) + q,
             make_uint4(bf16x2(v[8 * q], v[8 * q + 1]), bf16x2(v[8 * q + 2], v[8 * q + 3]),
                        bf16x2(v[8 * q + 4], v[8 * q + 5]),
                        bf16x2(v[8 * q + 6], v[8 * q + 7])));
  }
}

template <int STORE>
__device__ __forceinline__ void store_bin(void* o0, void* o1, size_t idx,
                                          float x, float y) {
  if constexpr (STORE == PACKED_F32) {
    reinterpret_cast<float2*>(o0)[idx] = make_float2(x, y);
  } else if constexpr (STORE == PLANAR_F32) {
    reinterpret_cast<float*>(o0)[idx] = x;
    reinterpret_cast<float*>(o1)[idx] = y;
  } else if constexpr (STORE == PLANAR_BF16) {
    reinterpret_cast<__nv_bfloat16*>(o0)[idx] = __float2bfloat16(x);
    reinterpret_cast<__nv_bfloat16*>(o1)[idx] = __float2bfloat16(y);
  } else if constexpr (STORE == POWER_F32) {
    reinterpret_cast<float*>(o0)[idx] = x * x + y * y;
  } else if constexpr (STORE == POWER_BF16) {
    reinterpret_cast<__nv_bfloat16*>(o0)[idx] = __float2bfloat16(x * x + y * y);
  }
}

// One row of a strip, bins idx .. idx+V-1 (n of them inside the row).
template <int V, int STORE, bool VEC>
__device__ __forceinline__ void store_strip(void* o0, void* o1, size_t idx,
                                            const float2 (&o)[V], int n) {
  if constexpr (STORE == NO_SPECTRA) return;
  if constexpr (!VEC) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < n) store_bin<STORE>(o0, o1, idx + j, o[j].x, o[j].y);
    return;
  }
  float re[V], im[V], pw[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    re[j] = o[j].x;
    im[j] = o[j].y;
    pw[j] = o[j].x * o[j].x + o[j].y * o[j].y;
  }
  if constexpr (STORE == PACKED_F32) {
    float4* p = reinterpret_cast<float4*>(reinterpret_cast<float2*>(o0) + idx);
#pragma unroll
    for (int q = 0; q < V / 2; ++q)
      st_out(p + q, make_float4(re[2 * q], im[2 * q], re[2 * q + 1], im[2 * q + 1]));
  } else if constexpr (STORE == PLANAR_F32) {
    store_f32<V>(reinterpret_cast<float*>(o0) + idx, re);
    store_f32<V>(reinterpret_cast<float*>(o1) + idx, im);
  } else if constexpr (STORE == PLANAR_BF16) {
    store_bf16<V>(reinterpret_cast<__nv_bfloat16*>(o0) + idx, re);
    store_bf16<V>(reinterpret_cast<__nv_bfloat16*>(o1) + idx, im);
  } else if constexpr (STORE == POWER_F32) {
    store_f32<V>(reinterpret_cast<float*>(o0) + idx, pw);
  } else if constexpr (STORE == POWER_BF16) {
    store_bf16<V>(reinterpret_cast<__nv_bfloat16*>(o0) + idx, pw);
  }
}

// Warp sum of eight rows' partial y values: a transposed butterfly (nine
// shuffles for eight rows).  Afterwards lanes with (lane & 3) == 0 hold the
// warp's total of row row_of_lane(lane).
__device__ __forceinline__ float warp_sum8(const float (&v)[FINE], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (h16 ? v[i + 4] : v[i]) + __shfl_xor_sync(FULL, h16 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (h8 ? a[i + 2] : a[i]) + __shfl_xor_sync(FULL, h8 ? a[i] : a[i + 2], 8);
  float s = (h4 ? b[1] : b[0]) + __shfl_xor_sync(FULL, h4 ? b[0] : b[1], 4);
  s += __shfl_xor_sync(FULL, s, 2);
  s += __shfl_xor_sync(FULL, s, 1);
  return s;
}

__device__ __forceinline__ int row_of_lane(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

// Source bin and conjugation of signed bin p under the Hermitian mirror;
// returns whether p is accumulated (a valid bin whose source is in the ROI).
__device__ __forceinline__ bool source_bin(const TileArgs& a, int p, int& s, bool& cj) {
  s = p < 0 ? -p : (p > a.m - 1 ? 2 * (a.m - 1) - p : p);
  cj = p < 0 || p > a.m - 1;
  const bool acc = p >= -a.halo && p <= a.m - 1 + a.halo && s >= a.roi_first && s < a.roi_last;
  if (!acc) s = 0;
  return acc;
}

// Table row of phasor row r in shared memory: the K/8 + 1 coarse rows
// T^(8c), then the seven fine rows T^b, b = 1..7.
__device__ __forceinline__ int table_row(int r, int nc) { return r < nc ? r * FINE : r - nc + 1; }

// A strip-edge neighbour from lane - 1 (lane + 1).  With one strip a lane,
// lane 0 (31) keeps its own value, which the caller replaces by a guard; with
// several the lanes rotate, so lane 0 (31) reads lane 31's (0's) value of
// the same strip index, which is the neighbour of its next (previous) strip.
template <int NSTRIP>
__device__ __forceinline__ float2 from_prev(float2 v, int lane) {
  if constexpr (NSTRIP == 1)
    return make_float2(__shfl_up_sync(FULL, v.x, 1), __shfl_up_sync(FULL, v.y, 1));
  return make_float2(__shfl_sync(FULL, v.x, (lane + 31) & 31),
                     __shfl_sync(FULL, v.y, (lane + 31) & 31));
}

template <int NSTRIP>
__device__ __forceinline__ float2 from_next(float2 v, int lane) {
  if constexpr (NSTRIP == 1)
    return make_float2(__shfl_down_sync(FULL, v.x, 1), __shfl_down_sync(FULL, v.y, 1));
  return make_float2(__shfl_sync(FULL, v.x, (lane + 1) & 31),
                     __shfl_sync(FULL, v.y, (lane + 1) & 31));
}

// Lane-1 (lane+1) values of each strip h as the left (right) neighbours of
// the strips' edges: lane 0's left neighbour of strip h > 0 is lane 31's
// last bin of strip h-1, which the rotation handed lane 0 in slot h-1, and
// the chunk's own edges take the guard g.
template <int NSTRIP>
__device__ __forceinline__ void edge_left(float2 (&l)[NSTRIP], float2 g, int lane) {
#pragma unroll
  for (int h = NSTRIP - 1; h >= 1; --h)
    if (lane == 0) l[h] = l[h - 1];
  if (lane == 0) l[0] = g;
}

template <int NSTRIP>
__device__ __forceinline__ void edge_right(float2 (&r)[NSTRIP], float2 g, int lane) {
#pragma unroll
  for (int h = 0; h + 1 < NSTRIP; ++h)
    if (lane == 31) r[h] = r[h + 1];
  if (lane == 31) r[NSTRIP - 1] = g;
}

// The body both kernels run.  With EMIT_Y, every row's spectrum is also
// reduced against the synthesis row over the warp's chunk of bins:
// y[(chunk * C + c) * y_rows + k] = y_scale * sum_{i in chunk} (Re out[c,k,i]
// * Re s[i] - Im out[c,k,i] * Im s[i]), one plain store per row and warp (each
// (chunk, channel, row) has exactly one writer); scan.cu adds the chunks in
// order.  A warp stores eight consecutive rows at once, so with y_rows a
// multiple of 8 every such store fills one 32-byte sector.
template <int V, int SEG, int HALO, int STORE, bool EMIT_Y, bool VEC, bool PACED = false>
__device__ __forceinline__ void spectra_tiles(const TileArgs a, void* out0, void* out1,
                                              const float2* synth, float* y,
                                              float y_scale, int y_rows) {
  static_assert(V == 2 || V == 4 || V == 8, "bins per thread");
  static_assert(SEG >= 2 && V % SEG == 0, "strip width");
  static_assert(HALO >= 0 && HALO <= MAX_HALO, "window halo");
  constexpr int NSTRIP = V / SEG;  // strips a lane, 32 * SEG bins apart
  extern __shared__ float4 smem_raw[];
  const int nc = a.K / FINE + 1, nr = nc + FINE - 1;
  float4* ph = smem_raw;                                                    // [nr][V/2][32]
  float2* gph = reinterpret_cast<float2*>(ph + (size_t)nr * (V / 2) * 32);  // [nr][2*MAX_HALO]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* dl = reinterpret_cast<float*>(gph + (size_t)nr * 2 * MAX_HALO) + warp * a.K;

  // This lane's strips: strip h holds signed bins p0 + 32*SEG*h .. +SEG-1,
  // its j-th bin strip_bin(j); each is computed from source bin src[j] (bit
  // j of live: accumulated; of cj: conjugated; of keep: an output bin
  // inside the ROI).
  const int first = blockIdx.x * chunk_bins(V);
  const int p0 = first + lane * SEG;
  const auto strip_bin = [p0](int j) { return p0 + (j / SEG) * 32 * SEG + j % SEG; };
  int src[V];
  unsigned live = 0, cj = 0, keep = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int p = strip_bin(j);
    bool c;
    live |= (unsigned)source_bin(a, p, src[j], c) << j;
    cj |= (unsigned)c << j;
    keep |= (unsigned)(p < a.m && p >= a.roi_first && p < a.roi_last) << j;
  }
  // the window taps of each bin, zero on a bin outside the ROI (so the
  // stencil applies the mask; w * 1 is exact)
  float tw[V][HALO + 1];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float k = keep >> j & 1 ? 1.f : 0.f;
    tw[j][0] = a.w0 * k;
    if constexpr (HALO >= 1) tw[j][1] = a.w1 * k;
    if constexpr (HALO >= 2) tw[j][2] = a.w2 * k;
  }
  // Guard slot q: lanes 0-15 run the chunk's left guard bin first-1-q,
  // lanes 16-31 its right guard bin first+32V+q (lane 0 and lane 31 read
  // them); slots q >= halo are idle.
  const int side = lane >> 4;
  int gsrc[MAX_HALO];
  unsigned glive = 0, gcj = 0;
#pragma unroll
  for (int q = 0; q < MAX_HALO; ++q) {
    bool c;
    const bool acc = source_bin(a, side ? first + chunk_bins(V) + q : first - 1 - q, gsrc[q], c);
    glive |= (unsigned)(acc && q < HALO) << q;
    gcj |= (unsigned)c << q;
  }

  // phasor rows of the strips (each warp fills every WARPS-th row) and of
  // the four guard bins, then the block's only barrier
  for (int r = warp; r < nr; r += WARPS) {
    const float2* row = a.table + (size_t)table_row(r, nc) * a.m;
    float2 v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = bin_value(row, src[j], live >> j & 1, cj >> j & 1);
#pragma unroll
    for (int q = 0; q < V / 2; ++q)
      ph[((size_t)r * (V / 2) + q) * 32 + lane] =
          make_float4(v[2 * q].x, v[2 * q].y, v[2 * q + 1].x, v[2 * q + 1].y);
  }
  for (int i = threadIdx.x; i < nr * 2 * MAX_HALO; i += WARPS * 32) {
    const int r = i / (2 * MAX_HALO), g = i % (2 * MAX_HALO), q = g % MAX_HALO;
    int s;
    bool c;
    const bool acc = source_bin(a, g < MAX_HALO ? first - 1 - q : first + chunk_bins(V) + q, s, c);
    gph[i] = bin_value(a.table + (size_t)table_row(r, nc) * a.m, s, acc && q < HALO, c);
  }
  float2 s_i[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    s_i[j] = EMIT_Y && strip_bin(j) < a.m ? __ldg(&synth[strip_bin(j)]) : make_float2(0.f, 0.f);
  __syncthreads();

  // The tile groups of the whole batch, channel by channel: group g is
  // channel g / groups, whose tiles tg*WARPS .. tg*WARPS+WARPS-1 its warps
  // take, so a warp's tiles never straddle two channels.  Control flow
  // depends on the block and the arguments only, so the compiler sees every
  // shuffle converged: a warp past its channel's last tile runs that tile
  // again and stores nothing, and rows past M run on zero deltas unstored.
  // The same rule makes every block of a paced cluster (same blockIdx.y)
  // walk the same groups and steps, so each of its threads arrives on the
  // cluster barrier as often as every other: once before the walk, once
  // after each step's stores; it waits before the next step's stores and
  // once after the walk.
  const int groups = (a.nt + WARPS - 1) / WARPS;
  if constexpr (PACED) cluster_arrive();
  for (int g = blockIdx.y; g < a.C * groups; g += gridDim.y) {
    const int ch = g / groups, tg = g - ch * groups;
    const int t = min(tg * WARPS + warp, a.nt - 1);
    const size_t tile = (size_t)ch * a.nt + t;  // the tile's index in the batch
    const float2* c0 = a.c0 + tile * a.m;
    float2 u[V], gu[MAX_HALO];
#pragma unroll
    for (int j = 0; j < V; ++j) u[j] = bin_value(c0, src[j], live >> j & 1, cj >> j & 1);
#pragma unroll
    for (int q = 0; q < MAX_HALO; ++q) gu[q] = bin_value(c0, gsrc[q], glive >> q & 1, gcj >> q & 1);
    __syncwarp();  // the previous tile is done with dl
    const float4* dsrc = reinterpret_cast<const float4*>(a.delta + tile * a.K);
    for (int q = lane; q < a.K / 4; q += 32) reinterpret_cast<float4*>(dl)[q] = __ldg(dsrc + q);
    __syncwarp();

    const long long row0 = (long long)t * a.K;
    const int rows = tg * WARPS + warp >= a.nt ? 0 : (a.M - row0 < a.K ? (int)(a.M - row0) : a.K);
    const size_t crow0 = (size_t)ch * a.M + row0;  // row k0 = 0 in the batch's rows
    size_t idx = crow0 * row_stride(a) + p0;  // the strip's first bin in row k0
    float* yrow = EMIT_Y ? y + ((size_t)blockIdx.x * a.C + ch) * y_rows + row0 : nullptr;
    for (int k0 = 0; k0 < a.K; k0 += FINE, idx += (size_t)FINE * row_stride(a)) {
      const int c = k0 / FINE;
      float2 cc[V], f[V], gcc[MAX_HALO], gf[MAX_HALO];
      phasor_row<V>(ph, c, lane, cc);
#pragma unroll
      for (int q = 0; q < MAX_HALO; ++q) gf[q] = gcc[q] = gph[c * 2 * MAX_HALO + side * MAX_HALO + q];
      const float4 d0 = reinterpret_cast<const float4*>(dl + k0)[0];
      const float4 d1 = reinterpret_cast<const float4*>(dl + k0)[1];
      const float dk[FINE] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      float yv[FINE] = {};
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = cc[j];  // T^(8c) * T^0
#pragma unroll
      for (int b = 0; b < FINE; ++b) {
        // running sums and demodulation; the demodulator T^(k+1) is the
        // next row's phasor: the next coarse row, or coarse times fine
        const int nrow = b + 1 == FINE ? c + 1 : nc + b;
        float2 nx[V], e[V], ge[MAX_HALO];
        phasor_row<V>(ph, nrow, lane, nx);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          u[j].x = fmaf(dk[b], f[j].x, u[j].x);
          u[j].y = fmaf(dk[b], f[j].y, u[j].y);
          const float2 g = b + 1 < FINE ? cmul(cc[j], nx[j]) : nx[j];
          e[j] = make_float2(u[j].x * g.x + u[j].y * g.y,  // u * conj(g)
                             u[j].y * g.x - u[j].x * g.y);
          f[j] = g;
        }
#pragma unroll
        for (int q = 0; q < MAX_HALO; ++q) {
          ge[q] = e[0];
          if (q < HALO) {  // compile-time
            const float2 gn = gph[nrow * 2 * MAX_HALO + side * MAX_HALO + q];
            gu[q].x = fmaf(dk[b], gf[q].x, gu[q].x);
            gu[q].y = fmaf(dk[b], gf[q].y, gu[q].y);
            const float2 g = b + 1 < FINE ? cmul(gcc[q], gn) : gn;
            ge[q] = make_float2(gu[q].x * g.x + gu[q].y * g.y, gu[q].y * g.x - gu[q].x * g.y);
            gf[q] = g;
          }
        }
        // window stencil: strip-edge neighbours from lanes -1 and +1, the
        // chunk's edges from the guard slots
        float2 l1[NSTRIP], r1[NSTRIP], l2[NSTRIP], r2[NSTRIP];
#pragma unroll
        for (int h = 0; h < NSTRIP; ++h) l1[h] = r1[h] = l2[h] = r2[h] = e[0];
        if constexpr (HALO >= 1) {
#pragma unroll
          for (int h = 0; h < NSTRIP; ++h) {
            l1[h] = from_prev<NSTRIP>(e[h * SEG + SEG - 1], lane);
            r1[h] = from_next<NSTRIP>(e[h * SEG], lane);
          }
          edge_left<NSTRIP>(l1, ge[0], lane);
          edge_right<NSTRIP>(r1, ge[0], lane);
        }
        if constexpr (HALO >= 2) {
#pragma unroll
          for (int h = 0; h < NSTRIP; ++h) {
            l2[h] = from_prev<NSTRIP>(e[h * SEG + SEG - 2], lane);
            r2[h] = from_next<NSTRIP>(e[h * SEG + 1], lane);
          }
          edge_left<NSTRIP>(l2, ge[1], lane);
          edge_right<NSTRIP>(r2, ge[1], lane);
        }
        float2 o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int h = j / SEG, i = j % SEG;
          const float2 am1 = i >= 1 ? e[j - 1] : l1[h], ap1 = i + 1 < SEG ? e[j + 1] : r1[h];
          const float2 am2 = i >= 2 ? e[j - 2] : (i == 1 ? l1[h] : l2[h]);
          const float2 ap2 = i + 2 < SEG ? e[j + 2] : (i + 2 == SEG ? r1[h] : r2[h]);
          float ox = tw[j][0] * e[j].x, oy = tw[j][0] * e[j].y;
          if constexpr (HALO >= 1) {
            ox += tw[j][1] * (am1.x + ap1.x);
            oy += tw[j][1] * (am1.y + ap1.y);
          }
          if constexpr (HALO >= 2) {
            ox += tw[j][2] * (am2.x + ap2.x);
            oy += tw[j][2] * (am2.y + ap2.y);
          }
          o[j] = make_float2(ox, oy);
          if (EMIT_Y) yv[b] += ox * s_i[j].x - oy * s_i[j].y;
        }
        // the other blocks of the cluster are done with the previous step
        if constexpr (PACED)
          if (b == 0) cluster_wait();
#pragma unroll
        for (int h = 0; h < NSTRIP; ++h) {
          const int ph = p0 + h * 32 * SEG;
          if (ph < a.m && k0 + b < rows) {
            float2 oh[SEG];
#pragma unroll
            for (int i = 0; i < SEG; ++i) oh[i] = o[h * SEG + i];
            store_strip<SEG, STORE, VEC>(out0, out1,
                                         idx + (size_t)b * row_stride(a) + h * 32 * SEG, oh,
                                         a.m - ph);
          }
        }
      }
      if constexpr (PACED) cluster_arrive();
      if constexpr (EMIT_Y) {
        const float v = warp_sum8(yv, lane);
        const int r = row_of_lane(lane);
        if ((lane & 3) == 0 && k0 + r < rows)
          yrow[k0 + r] = y_scale * v;
      }
    }
  }
  if constexpr (PACED) cluster_wait();
}

// The launch configuration of a paced launch: clusters of `chunks` blocks
// along x, the whole row of bin chunks.
inline cudaLaunchConfig_t cluster_config(int chunks, int grid_y, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = chunks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, grid_y);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Validate the arguments, set the kernel's shared-memory attributes, size
// the grid and launch; returns the CUDA error code (0 on success).  The grid
// is (bin chunks, tile groups of the whole batch): one wave of resident
// blocks, each walking every gridDim.y-th group of its chunk.  The channels
// fold into the groups rather than into gridDim.z, so a block fills its
// phasor rows once for all of them.  A paced launch (a.paced; K1 only)
// groups each row of chunks into one cluster, which needs chunks <= 8 (the
// portable cluster size), and takes as many rows as clusters stay resident.
template <int V, int SEG = V, typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, const TileArgs& a, bool vec, cudaStream_t stream,
                 Args... args) {
  const int chunks = (a.m + chunk_bins(V) - 1) / chunk_bins(V);
  if (a.K <= 0 || a.K % FINE || a.K > MAX_K || a.halo < 0 || a.halo > MAX_HALO ||
      a.m < MAX_HALO + 1 || a.nt <= 0 || a.M <= 0 || (long long)a.nt * a.K < a.M ||
      a.C <= 0 || (long long)a.C * ((a.nt + WARPS - 1) / WARPS) > 0x7fffffff ||
      row_stride(a) < a.m || (vec && (a.m % SEG || row_stride(a) % SEG)) ||
      (a.paced && chunks > MAX_CLUSTER))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(V, a.K);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = a.C * ((a.nt + WARPS - 1) / WARPS);
  if (a.paced) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(chunks, 1, smem, stream, &attr);
    int clusters = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess)
      return (int)err;
    if (clusters <= 0) return (int)cudaErrorInvalidConfiguration;
    cfg.gridDim.y = clusters > groups ? groups : clusters;
    return (int)cudaLaunchKernelEx(&cfg, kernel, a, args...);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32,
                                                          smem)) != cudaSuccess)
    return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  int grid_y = per_sm * sms / chunks;
  grid_y = grid_y < 1 ? 1 : (grid_y > groups ? groups : grid_y);
  kernel<<<dim3(chunks, grid_y), WARPS * 32, smem, stream>>>(a, args...);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of `kernel` at tile depth K (0 on error).
template <int V, typename Kernel>
int occupancy(Kernel kernel, int K) {
  int blocks = 0;
  const size_t smem = smem_bytes(V, K);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, WARPS * 32, smem) !=
          cudaSuccess)
    return 0;
  return blocks;
}

// Resident clusters of `chunks` blocks of `kernel` on the card at tile
// depth K (0 on error).
template <int V, typename Kernel>
int clusters(Kernel kernel, int K, int chunks) {
  int n = 0;
  const size_t smem = smem_bytes(V, K);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(chunks, 1, smem, nullptr, &attr);
  if (chunks < 1 || chunks > MAX_CLUSTER ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace sdft
