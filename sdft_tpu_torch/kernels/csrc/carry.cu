// The carry front of the kernels' prologue (kernels.spectra.spectra_prologue
// on a CUDA tensor), in one pass: the comb deltas and the next delayline,
// the exact-FP32 tile totals, the tile phase rows and the prefix over
// tiles, for a batch of C channels of M samples in tiles of K = 128.
//
// Replaces no Pallas kernel: the JAX package leaves the launcher-side
// prologue of its kernels, _spectra_prologue
// (sdft_tpu/kernels/analysis_pallas.py:632-748), to XLA, and the port ran it
// as a dozen PyTorch kernels (ops/carry.py's carry: a cat and a pad for the
// comb, one GEMM for the totals, the phase rows, two cumsums, a cat, an add
// and two complex products), each moving the (C, nt, m) complex
// intermediate through device memory.  ops/carry.py stays the plain
// version; this kernel computes the same algebra:
//
//   delta[k]     = x[k] - x[k - 2m]                    (history in front,
//                                                        zero past M)
//   row0[t, i]   = T_i^offset * T_i^(t*K)              (T_i = exp(-j*pi*i/m))
//   rt[t, i]     = row0[t, i] * sum_k delta[t*K + k] * fine[k, i]
//   c0[t, i]     = (acc[i] + sum_{t' < t} rt[t', i]) * conj(row0[t, i])
//   end[i]       = acc[i] + sum_t rt[t, i]
//
// Both phase-row factors are entries of one table W[r] = exp(-j*pi*r/m),
// r in [0, 2m), built by the wrapper with ops.twiddle.phasors' float64 angle
// and cast, and indexed by exact integer exponents, (offset * i) mod 2m in
// 64-bit integers and t*K*i mod 2m stepped from tile to tile, so each
// factor equals the plain version's bit for bit.
// The deltas and the delayline are the plain version's bit for bit too (the
// same float32 subtraction, and copies).
//
// What bounds it on this card: the totals product, 2 * C*nt * K * 2m exact
// FP32 flops on the CUDA cores (1.41 GFLOP at 8 x 44100, m = 1000: 21 us at
// 67 TFLOP/s), against c0 written once (22 MB there, 6.6 us at 3.35 TB/s).
// No tensor core: the products are exact FP32, with no TF32 and no bf16
// split.  The next offset, (offset + M) mod 2m, is written here too.
//
// Design.  A block owns one channel and a strip of 64 bins and walks
// all its channel's tiles in order, in groups of G = 128, carrying the
// running sum of its bins in registers: no block waits for another, no
// scratch or flag crosses blocks, and every output element has one writer,
// so c0 and the end accumulator repeat bit for bit (every sum runs in a
// fixed order).  Per group:
//   * the totals are a (128 x 128) x (128 x 2*BINS) product in FFMA, each
//     thread a 4 x 8 register tile (four tiles; two 16-byte column quads,
//     so that its shared loads are free of bank conflicts), summed over k
//     in ascending order.  The strip's fine columns stay in shared memory
//     for the whole walk (loaded with the first group's steps);
//   * the samples and lagged samples reach shared memory by cp.async in
//     steps of KC samples of every tile, two steps ahead; a step forms the
//     next step's deltas (k-major) while it multiplies, so one barrier a
//     step.  Each step's deltas are also stored to device memory by one
//     strip block, in turn (a single storing block lagged the rest);
//   * the epilogue: the phase rows, from a shared table of the q = 2m /
//     gcd(K, 2m) roots a tile row can take (every row exponent t*K*i mod
//     2m is a multiple of gcd(K, 2m); held as the whole W, every lane read
//     the same bank), the rotated totals, a shuffle scan over a warp's four
//     thread rows, a chain over the eight warp rows, and c0 in 16-byte
//     stores.
// A block is 512 threads (one a multiprocessor, by its shared memory) and
// a pipeline step takes 32 samples of each tile.  The grid is (strips, C):
// 16 x 8 blocks at 8 x 44100, m = 1000.  Batches of more than 65535
// channels (the grid's second axis) take one launch per 65535 channels.
// Narrow batches leave the card part idle: one channel at m = 4096 is 64
// blocks on 132 multiprocessors.  ptxas (CUDA 12.8): 128 registers (the
// launch bound) and spill stores/loads of 20/20 bytes with vector copies
// and the roots in shared memory (as at m = 1000), 24/28 with the roots
// only, 44/68 without them; chip_smoke.py prints them.
//
// Device time at 8 x 44100, m = 1000 (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py phase 5): 0.063 ms, 34 % of the 0.021 ms bound, against
// 0.25 ms for the PyTorch front.  Of it, by removing one part at a time:
// the product 33.5 us (the FFMA rate at the card's clock under this load),
// the epilogue 11, staging and comb 10, launch and first loads 11.  The
// parts barely overlap: every block reaches the same phase at the same
// time.

#include <cuda_runtime.h>
#include <stddef.h>

namespace sdft {
namespace front {

constexpr int K = 128;           // samples per tile (spectra.py: TILE_K)
constexpr int G = 128;           // tiles per group
constexpr int BINS = 64;         // bins of a block's strip
constexpr int RT = 4;            // tiles of a thread's register tile
constexpr int TR = G / RT;       // thread rows
constexpr int ROWGROUPS = TR / 4;  // a warp's four thread rows: 16 tiles
constexpr int AST = G + 4;       // padded k-row of the transposed delta chunk
constexpr int MAX_SMEM_ROWS = 2048;  // most tile-row roots held in shared memory
constexpr int MAX_GRID_Y = 65535;    // most channels of one launch

// A block's geometry: TC thread columns of two column quads each (bins
// 2tc, 2tc+1, BINS/2+2tc, BINS/2+2tc+1), TR thread rows of RT tiles each; a
// warp is 8 thread columns by 4 thread rows.  A pipeline step takes KC
// samples of each of the G tiles of a group.
constexpr int COLS = 2 * BINS;   // (re, im) columns of the fine table
constexpr int TC = BINS / 4;
constexpr int THREADS = TR * TC;
constexpr int KC = 32;
constexpr int STEPS = K / KC;    // pipeline steps per group
constexpr int STAGE = G * KC;    // floats of one array of one stage
constexpr size_t FLOATS = K * COLS             // fine strip
                          + 2 * 2 * STAGE      // samples and lagged samples, two steps
                          + 2 * KC * AST       // deltas, k-major, two steps
                          + 2 * ROWGROUPS * BINS;  // per-warp-row sums
static_assert(TC % 8 == 0 && STAGE % (4 * THREADS) == 0, "whole warps and quads");

// bytes of shared memory of a block, with the q tile-row roots there or not
constexpr size_t smem_bytes(int q, bool shared_rows) {
  return (FLOATS + (shared_rows ? 2 * (size_t)q : 0)) * sizeof(float);
}

struct Args {
  const float* x;       // (C, M) samples
  const float* hist;    // (C, 2m) the 2m samples before the block
  const float2* acc;    // (C, m) accumulator in front of the block
  const int* offset;    // (C,) start exponents
  const float2* fine;   // (K, m) T_i^k on ROI bins, zero elsewhere
  const float2* roots;  // (2m) W[r] = exp(-j*pi*r/m)
  float* delta;         // (C, nt*K) comb deltas, zero past M
  float* line;          // (C, 2m) next delayline
  float2* c0;           // (C, nt, m) per-tile carry, demodulated frame
  float2* end;          // (C, m) accumulator after the block
  int* next;            // (C,) start exponents after the block, (offset + M) mod 2m
  int m, C, M, nt;
  int g, q;             // gcd(K, 2m) and 2m / g: tile rows' exponents are g * j, j < q
};

// cp.async of BYTES bytes, of which the first `valid` come from `src` and the
// rest are zero.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, int valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(BYTES), "r"(valid));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// Queue pipeline step `step` (group step / STEPS, samples (step % STEPS) * KC
// of each tile) of one channel: the G x KC samples and lagged samples, zero
// past M, row-major; in the first group also the step's KC rows of the
// strip's fine columns (zero past m).  16-byte copies of samples with VEC
// (the launcher checks alignment), else 4-byte ones.
template <bool VEC>
__device__ __forceinline__ void stage(const Args& a, const float* xc, const float* hc,
                                      int bin0, int step, float* xs, float* fine_s) {
  const long long n2 = 2LL * a.m;
  const long long base = (long long)(step / STEPS) * G * K + (step % STEPS) * KC;
#pragma unroll
  for (int h = 0; h < STAGE / 4 / THREADS; ++h) {
    const int e = 4 * (h * THREADS + threadIdx.x);
    const long long idx = base + (e / KC) * K + e % KC;
#pragma unroll
    for (int v = 0; v < (VEC ? 1 : 4); ++v) {
      const long long at = idx + v;
      const long long left = a.M - at;
      constexpr int W = VEC ? 4 : 1;
      const int valid = left >= W ? 4 * W : left > 0 ? 4 * (int)left : 0;
      const float* lag = !valid ? xc : at >= n2 ? xc + (at - n2) : hc + at;
      copy_async<4 * W>(xs + e + v, valid ? xc + at : xc, valid);
      copy_async<4 * W>(xs + STAGE + e + v, lag, valid);
    }
  }
  if (step < STEPS)
    for (int e = threadIdx.x; e < KC * BINS; e += THREADS) {
      const int k = step * KC + e / BINS, b = e % BINS;
      const bool in = bin0 + b < a.m;
      copy_async<8>(fine_s + 2 * (k * BINS + b),
                    in ? a.fine + (size_t)k * a.m + bin0 + b : a.fine, in ? 8 : 0);
    }
}

// The deltas of pipeline step `step` from its staged samples, k-major into
// `ds`; `store`: also into device memory (one block a step and channel).
__device__ __forceinline__ void comb(const Args& a, int c, int step, bool store,
                                    const float* xs, float* ds) {
  const int g = step / STEPS, k0 = (step % STEPS) * KC;
#pragma unroll
  for (int h = 0; h < STAGE / 4 / THREADS; ++h) {
    const int e = 4 * (h * THREADS + threadIdx.x);
    const int row = e / KC, k = e % KC;
    const float4 x = *reinterpret_cast<const float4*>(xs + e);
    const float4 l = *reinterpret_cast<const float4*>(xs + STAGE + e);
    const float4 d = make_float4(x.x - l.x, x.y - l.y, x.z - l.z, x.w - l.w);
    ds[k * AST + row] = d.x;
    ds[(k + 1) * AST + row] = d.y;
    ds[(k + 2) * AST + row] = d.z;
    ds[(k + 3) * AST + row] = d.w;
    const int t = g * G + row;
    if (store && t < a.nt)
      *reinterpret_cast<float4*>(a.delta + ((size_t)c * a.nt + t) * K + k0 + k) = d;
  }
}

template <bool VEC, bool WS>
__global__ void __launch_bounds__(THREADS, 1) carry_front(Args a) {
  extern __shared__ float4 smem4[];
  float* fine_s = reinterpret_cast<float*>(smem4);
  float* stages = fine_s + K * COLS;
  float* ds = stages + 2 * 2 * STAGE;
  float2* sums = reinterpret_cast<float2*>(ds + 2 * KC * AST);
  float2* w_s = sums + ROWGROUPS * BINS;  // W[g * j], j < q, when WS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.y, bin0 = blockIdx.x * BINS, strips = gridDim.x;
  const int m = a.m, nt = a.nt, n2 = 2 * m;
  const int steps = (nt + G - 1) / G * STEPS;
  const float* xc = a.x + (size_t)c * a.M;
  const float* hc = a.hist + (size_t)c * n2;

  // the tile-row roots and step 0 (with the fine rows it takes), then step 1
  // every tile row's exponent t*K*i mod 2m is a multiple of g: its root is
  // R(j) = W[g * j], j in [0, q), held contiguously in shared memory with WS
  // (else read from W in device memory, through L1)
  const int gq = a.g, q = a.q;
  if (WS)
    for (int j = tid; j < q; j += THREADS) copy_async<8>(w_s + j, a.roots + (size_t)gq * j, 8);
  auto R = [&](int j) { return WS ? w_s[j] : a.roots[(size_t)gq * j]; };
  stage<VEC>(a, xc, hc, bin0, 0, stages, fine_s);
  copy_commit();
  stage<VEC>(a, xc, hc, bin0, 1, stages + 2 * STAGE, fine_s);
  copy_commit();

  if (blockIdx.x == strips - 1) {  // the next delayline: the last 2m samples
    if (tid == 0) a.next[c] = (int)((((long long)a.offset[c] + a.M) % n2 + n2) % n2);
    for (int j = tid; j < n2; j += THREADS) {
      const long long src = (long long)a.M + j;
      a.line[(size_t)c * n2 + j] = src < n2 ? hc[src] : xc[src - n2];
    }
  }

  // the thread's register tile: tiles RT*tr.. of a group, and columns
  // 4tc..4tc+3 and COLS/2+4tc..COLS/2+4tc+3, i.e. the bins lb[0..3]
  const int tc = (lane & 7) + 8 * (warp % (TC / 8)), rg = warp / (TC / 8);
  const int sub = lane >> 3, tr = 4 * rg + sub;
  const int lb[4] = {2 * tc, 2 * tc + 1, BINS / 2 + 2 * tc, BINS / 2 + 2 * tc + 1};
  const long long off = ((long long)a.offset[c] % n2 + n2) % n2;
  // per bin: T_i^offset, and in units of g mod q the tile-row exponent's
  // step from one tile to the next (K*i), from one group to the next
  // (G*K*i), and that of the thread's first tile of the group (RT*tr*K*i)
  float2 orow[4], carry[4];
  int stride[4], gstride[4], first[4];
  bool live[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int i = bin0 + lb[b];
    live[b] = i < m;
    carry[b] = live[b] ? a.acc[(size_t)c * m + i] : make_float2(0.f, 0.f);
    orow[b] = a.roots[(off * i) % n2];
    // (K/g) * i < 2^25, G * stride and RT * tr * stride < 2^27: 32-bit products
    stride[b] = (int)((unsigned)((K / gq) * i) % (unsigned)q);
    gstride[b] = (int)((unsigned)(G * stride[b]) % (unsigned)q);
    first[b] = (int)((unsigned)(RT * tr * stride[b]) % (unsigned)q);
  }

  copy_wait<1>();
  __syncthreads();
  comb(a, c, 0, blockIdx.x == 0, stages, ds);

  // step s: its deltas (ds[s % 2]) were formed in step s - 1; it forms step
  // s + 1's and queues step s + 2's samples, so one barrier a step
  float s[RT][8];
  for (int step = 0; step < steps; ++step) {
    const int g = step / STEPS, j = step % STEPS;
    copy_wait<0>();
    __syncthreads();
    if (step + 2 < steps)
      stage<VEC>(a, xc, hc, bin0, step + 2, stages + (step % 2) * 2 * STAGE, fine_s);
    copy_commit();
    if (step + 1 < steps)
      comb(a, c, step + 1, (step + 1) % strips == blockIdx.x,
                 stages + ((step + 1) % 2) * 2 * STAGE, ds + ((step + 1) % 2) * KC * AST);

    // totals: s[r][q] = sum_k delta[tile RT*tr + r][k] * fine[k][column q], k ascending
    if (j == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int u = 0; u < 8; ++u) s[r][u] = 0.f;
    }
    if (g * G + 4 * RT * rg < nt) {  // the warp holds a tile of the block
      const float* dk = ds + (step % 2) * KC * AST;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(dk + k * AST + RT * tr);
        const float* frow = fine_s + (j * KC + k) * COLS;
        const float4 b0 = *reinterpret_cast<const float4*>(frow + 4 * tc);
        const float4 b1 = *reinterpret_cast<const float4*>(frow + COLS / 2 + 4 * tc);
        const float av[RT] = {a0.x, a0.y, a0.z, a0.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int u = 0; u < 8; ++u) s[r][u] = fmaf(av[r], bv[u], s[r][u]);
      }
    }
    if (j != STEPS - 1) continue;

    // the group's phase rows (kept), the rotated totals rt (in place of the
    // raw ones) and the sum of the thread's tiles per bin
    const long long t0 = (long long)g * G + RT * tr;
    float2 row0[RT][4], local[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int e = first[b];
      first[b] += gstride[b];
      if (first[b] >= q) first[b] -= q;
      local[b] = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        row0[r][b] = cmul(orow[b], R(e));
        const float2 rt = cmul(row0[r][b], make_float2(s[r][2 * b], s[r][2 * b + 1]));
        s[r][2 * b] = rt.x;
        s[r][2 * b + 1] = rt.y;
        local[b] = cadd(local[b], rt);
        e += stride[b];
        if (e >= q) e -= q;
      }
    }
    // the carry in front of the thread's first tile and in front of the
    // next group: the thread sums of the warp's four thread rows scanned by
    // shuffles, then the warp-row sums chained, each in a fixed order
    float2 run[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float2 p = make_float2(0.f, 0.f), ex = p;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u == sub) ex = p;
        p = cadd(p, make_float2(__shfl_sync(0xffffffffu, local[b].x, (lane & 7) + 8 * u),
                                __shfl_sync(0xffffffffu, local[b].y, (lane & 7) + 8 * u)));
      }
      run[b] = ex;
      if (sub == 0) sums[rg * BINS + lb[b]] = p;
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float2 before = carry[b];
#pragma unroll
      for (int w = 0; w < ROWGROUPS; ++w) {
        if (w == rg) before = carry[b];
        carry[b] = cadd(carry[b], sums[w * BINS + lb[b]]);
      }
      run[b] = cadd(before, run[b]);
    }
    // carries in each tile's frame; bins lb[0], lb[1] (and lb[2], lb[3]) are
    // neighbours, one 16-byte store where m is even
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float2 out[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        out[b] = cmul(run[b], make_float2(row0[r][b].x, -row0[r][b].y));
        run[b] = cadd(run[b], make_float2(s[r][2 * b], s[r][2 * b + 1]));
      }
      const long long t = t0 + r;
      if (t < nt) {
        float2* dst = a.c0 + ((size_t)c * nt + t) * m + bin0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (m % 2 == 0) {
            if (live[2 * h])
              *reinterpret_cast<float4*>(dst + lb[2 * h]) =
                  make_float4(out[2 * h].x, out[2 * h].y, out[2 * h + 1].x, out[2 * h + 1].y);
          } else {
            if (live[2 * h]) dst[lb[2 * h]] = out[2 * h];
            if (live[2 * h + 1]) dst[lb[2 * h + 1]] = out[2 * h + 1];
          }
        }
      }
    }
  }
  if (tr == 0) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (live[b]) a.end[(size_t)c * m + bin0 + lb[b]] = carry[b];
  }
}

// One launch per MAX_GRID_Y channels, each on its channels' slices.
int launch(const Args& a, bool vec, bool ws, cudaStream_t stream) {
  auto kernel = vec ? (ws ? carry_front<true, true> : carry_front<true, false>)
                    : (ws ? carry_front<false, true> : carry_front<false, false>);
  const size_t smem = smem_bytes(a.q, ws);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t n2 = 2 * (size_t)a.m, frame = (size_t)a.nt * a.m;
  for (int c = 0; c < a.C; c += MAX_GRID_Y) {
    Args p = a;
    p.C = a.C - c < MAX_GRID_Y ? a.C - c : MAX_GRID_Y;
    p.x += (size_t)c * a.M;
    p.hist += c * n2;
    p.acc += (size_t)c * a.m;
    p.offset += c;
    p.delta += (size_t)c * a.nt * K;
    p.line += c * n2;
    p.c0 += c * frame;
    p.end += (size_t)c * a.m;
    p.next += c;
    kernel<<<dim3((a.m + BINS - 1) / BINS, p.C), THREADS, smem, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace front
}  // namespace sdft

// One launch for a batch of C channels of M samples (one per 65535
// channels); C = 1 is a single block.  Returns the CUDA error code (0 on success).
extern "C" int sdft_carry_launch(const void* x, const void* hist, const void* acc,
                                 const void* offset, const void* fine, const void* roots,
                                 void* delta, void* line, void* c0, void* end, void* next,
                                 int m, int C, int M, int nt, void* stream) {
  using namespace sdft::front;
  if (m < 1 || m > (1 << 23) || C < 1 || M < 1 ||
      nt != (int)(((long long)M + K - 1) / K))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies where every quad of samples, of lagged samples and of
  // history starts aligned
  const bool vec = reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(hist) % 16 == 0 && m % 2 == 0 &&
                   (C == 1 || M % 4 == 0);
  int g = K, r = 2 * m;  // gcd(K, 2m)
  while (r) {
    const int t = g % r;
    g = r;
    r = t;
  }
  const Args a{static_cast<const float*>(x),     static_cast<const float*>(hist),
               static_cast<const float2*>(acc),  static_cast<const int*>(offset),
               static_cast<const float2*>(fine), static_cast<const float2*>(roots),
               static_cast<float*>(delta),       static_cast<float*>(line),
               static_cast<float2*>(c0),         static_cast<float2*>(end),
               static_cast<int*>(next),          m, C, M, nt, g, 2 * m / g};
  return launch(a, vec, a.q <= MAX_SMEM_ROWS, static_cast<cudaStream_t>(stream));
}
