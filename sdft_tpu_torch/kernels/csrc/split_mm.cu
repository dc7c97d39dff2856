// split_mm: the split products of a float32 activation and a split table
// on Hopper's bf16 tensor cores (the "high" and "split4" matmul classes).
//
// Replaces the TPU matrix unit's multi-pass dot, which has no Pallas
// source: the JAX package's "high" class is lax.Precision.HIGH on its
// float32 contractions (sdft_tpu/config.py:96-110; the collapsed round
// trip, the driver at hop > 1 and the hopped analysis read it,
// sdft_tpu/ops/lti.py:369-372, 679-751, 1085-1118), and its "split4" class
// is _dot4 (sdft_tpu/ops/lti.py:242-263).  Both split each operand into
// masked bf16 halves, hi + lo, and sum cross products of the halves in
// float32: hh, hl and lh for "high", and ll besides for "split4".
//
//   out (+)= sum_p A_p @ B_p    A (rows, K) float32, row-major;
//                               B = hi + lo (K, N), bf16, row-major,
//                               split once on the host;
//                               out (rows, N) float32, row-major.
//
// A is split here, tile by tile, with the integer operations of
// kernels/split_mm.py's split_mask (0x8000 added to the bit pattern, the low half-word
// masked off; lo = bf16(a - hi), rounded to nearest even), so its halves
// are bit for bit the plain version's.  Each product keeps its own float32
// accumulator, a running sum of the tensor core's 16-term partial sums,
// and the epilogue sums them in _dot4's order, (hh + hl) + lh [+ ll inside
// the second pair for split4]; the only freedom left against the plain
// version is the order of the float32 sums along K.  With
// ``accumulate`` the finished sum is added to what out holds (out + v),
// so _synthesize's d @ GLT + c @ PQ takes two launches and no add.
//
// What bounds it on this card: the bytes of the split table (4 bytes per
// element of B, read once) against 2*rows*K*N*passes bf16 operations.  At
// the collapsed round trip's shapes (K and N 1024-8192) 64 rows are bound
// by the bytes and 256 rows come near a tie (chip_smoke.py prints each
// shape's bound).  The design is the simple one: a 64 x 64 output tile
// per block of eight warps, each warp 32 x 16 in mma.sync m16n8k16 tiles
// fed by ldmatrix from shared memory, K in steps of 32 with the next
// step's loads in registers while the current one runs (two shared
// stages), two blocks on each SM (at most 128 registers a thread: ptxas
// spills 12-16 bytes at three products, 24-36 at four; without the cap
// one block fit and the 256-row products took 1.3-1.4x as long, NVIDIA
// H100 80GB HBM3, 700 W, scripts/split_mm_check_torch.py).  Where the
// output tiles fill less than half the card (64 rows, or N = 1024), K is
// cut into chunks across blocks (split-K); each chunk writes its
// per-product partial sums to a scratch buffer the wrapper allocates, and
// a second kernel adds the chunks in order, then the products in _dot4's
// order.  Nothing is added by atomics,
// so a launch repeats bit for bit.  wgmma, TMA and persistent tiles are
// for a later change (ROADMAP queue 2).

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace split_mm {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // K per pipeline step
constexpr int THREADS = 256;  // eight warps, 2 x 4, each 32 x 16 of the tile
constexpr int APAD = BK + 8;  // shared row of an A half: 80 bytes, ldmatrix without conflicts
constexpr int BPAD = BN + 8;  // shared row of a B half: 144 bytes

struct Args {
  const float* a;
  const __nv_bfloat16* bh;
  const __nv_bfloat16* bl;
  float* out;
  float* ws;       // (splits, passes, rows, N) partial sums, or null for one chunk
  int rows, K, N;
  int chunk;       // K per block along grid z
  int accumulate;  // out + v instead of v
  int vec_a;       // K % 4 == 0 and A 16-byte aligned: float4 loads
  int vec_b;       // N % 8 == 0 and B 16-byte aligned: 16-byte loads
};

struct Stage {
  __nv_bfloat16 a[2][BM][APAD];  // [half][row][k]
  __nv_bfloat16 b[2][BK][BPAD];  // [half][k][n]
};

// The masked split of split_mask (kernels/split_mm.py): hi keeps the top half-word of
// a's bits after adding 0x8000 (round half away from zero on the dropped
// half, a carry runs into the exponent); lo = a - hi, exact in float32,
// rounded to bf16.
__device__ __forceinline__ void split(float a, unsigned short& hi, unsigned short& lo) {
  const unsigned u = (__float_as_uint(a) + 0x8000u) & 0xffff0000u;
  hi = static_cast<unsigned short>(u >> 16);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(a - __uint_as_float(u)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += the m16n8k16 product, summed by the tensor core from zero and added
// to c in float32 with rounding to nearest: each accumulator is a float32
// running sum of 16-term partial sums.  (Accumulating in the tensor core
// itself, c as its addend, read 3.2e-6 of scale from the plain version
// over 2752 terms, outside the 2e-6 gate; NVIDIA H100 80GB HBM3, 700 W,
// scripts/split_mm_check_torch.py.)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  float d[4];
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

// _dot4's order: (hh + hl) + lh, or (hh + hl) + (lh + ll)
template <int P>
__device__ __forceinline__ float combine(const float (&s)[P]) {
  if constexpr (P == 4) return (s[0] + s[1]) + (s[2] + s[3]);
  else return (s[0] + s[1]) + s[2];
}

// this thread's two float4 of the A tile at K offset k0: rows
// (t + 256 i) / 8, columns 4 * ((t + 256 i) % 8), zero outside
__device__ __forceinline__ void load_a(const Args& g, float4 (&r)[2], int m0, int k0, int ke,
                                       int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    const int row = m0 + (idx >> 3);
    const int k = k0 + (idx & 7) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < g.rows) {
      const float* src = g.a + static_cast<size_t>(row) * g.K + k;
      if (g.vec_a && k + 3 < ke) {
        v = *reinterpret_cast<const float4*>(src);
      } else {
        if (k < ke) v.x = src[0];
        if (k + 1 < ke) v.y = src[1];
        if (k + 2 < ke) v.z = src[2];
        if (k + 3 < ke) v.w = src[3];
      }
    }
    r[i] = v;
  }
}

// this thread's 8-element piece of each B half at K offset k0: row t / 8,
// columns 8 * (t % 8), zero outside
__device__ __forceinline__ void load_b(const Args& g, uint4 (&r)[2], int n0, int k0, int ke,
                                       int tid) {
  const int k = k0 + (tid >> 3);
  const int n = n0 + (tid & 7) * 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned short* b = reinterpret_cast<const unsigned short*>(h ? g.bl : g.bh);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < ke) {
      const unsigned short* src = b + static_cast<size_t>(k) * g.N + n;
      if (g.vec_b && n + 7 < g.N) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        unsigned short e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = n + j < g.N ? src[j] : 0;
        v = make_uint4(e[0] | (unsigned(e[1]) << 16), e[2] | (unsigned(e[3]) << 16),
                       e[4] | (unsigned(e[5]) << 16), e[6] | (unsigned(e[7]) << 16));
      }
    }
    r[h] = v;
  }
}

// split the A registers into the stage's hi and lo tiles; copy B's
__device__ __forceinline__ void store_stage(Stage& st, const float4 (&ra)[2],
                                            const uint4 (&rb)[2], int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    const int row = idx >> 3, k = (idx & 7) * 4;
    unsigned short h[4], l[4];
    split(ra[i].x, h[0], l[0]);
    split(ra[i].y, h[1], l[1]);
    split(ra[i].z, h[2], l[2]);
    split(ra[i].w, h[3], l[3]);
    *reinterpret_cast<uint2*>(&st.a[0][row][k]) =
        make_uint2(h[0] | (unsigned(h[1]) << 16), h[2] | (unsigned(h[3]) << 16));
    *reinterpret_cast<uint2*>(&st.a[1][row][k]) =
        make_uint2(l[0] | (unsigned(l[1]) << 16), l[2] | (unsigned(l[3]) << 16));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<uint4*>(&st.b[h][tid >> 3][(tid & 7) * 8]) = rb[h];
}

// one stage's 32 K: two k16 steps of mma per product, on this warp's
// 32 x 16 (2 x 2 m16n8 tiles)
template <int P>
__device__ __forceinline__ void compute(const Stage& st, float (&acc)[P][2][2][4], int lane,
                                        int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    unsigned b[2][2][2];  // [half][n8 tile][k half]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned r[4];
      ldsm_x4_trans(r, &st.b[h][kk + (lane & 15)][wn * 16 + (lane >> 4) * 8]);
      b[h][0][0] = r[0];
      b[h][0][1] = r[1];
      b[h][1][0] = r[2];
      b[h][1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      unsigned ah[4], al[4];
      const int row = wm * 32 + mi * 16 + (lane & 15);
      const int k = kk + (lane >> 4) * 8;
      ldsm_x4(ah, &st.a[0][row][k]);
      ldsm_x4(al, &st.a[1][row][k]);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        mma(acc[0][mi][ni], ah, b[0][ni][0], b[0][ni][1]);  // hh
        mma(acc[1][mi][ni], ah, b[1][ni][0], b[1][ni][1]);  // hl
        mma(acc[2][mi][ni], al, b[0][ni][0], b[0][ni][1]);  // lh
        if constexpr (P == 4) mma(acc[3][mi][ni], al, b[1][ni][0], b[1][ni][1]);  // ll
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS, 2) split_mm_kernel(Args g) {
  __shared__ __align__(16) Stage stages[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * g.chunk;
  const int ke = min(g.K, kb + g.chunk);
  const int steps = (ke - kb + BK - 1) / BK;

  float acc[P][2][2][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][mi][ni][c] = 0.f;

  float4 ra[2];
  uint4 rb[2];
  load_a(g, ra, m0, kb, ke, tid);
  load_b(g, rb, n0, kb, ke, tid);
  store_stage(stages[0], ra, rb, tid);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const bool next = t + 1 < steps;
    if (next) {  // the next step's loads in flight under this step's products
      load_a(g, ra, m0, kb + (t + 1) * BK, ke, tid);
      load_b(g, rb, n0, kb + (t + 1) * BK, ke, tid);
    }
    compute<P>(stages[t & 1], acc, lane, wm, wn);
    if (next) store_stage(stages[(t + 1) & 1], ra, rb, tid);
    __syncthreads();
  }

  // c0, c1 at (lane / 4, 2 (lane % 4) + {0, 1}) of each m16n8 tile; c2, c3
  // eight rows below
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm * 32 + mi * 16 + (lane >> 2) + (c >> 1) * 8;
        const int col = n0 + wn * 16 + ni * 8 + (lane & 3) * 2 + (c & 1);
        if (row >= g.rows || col >= g.N) continue;
        const size_t i = static_cast<size_t>(row) * g.N + col;
        if (g.ws) {
          const size_t plane = static_cast<size_t>(g.rows) * g.N;
#pragma unroll
          for (int p = 0; p < P; ++p)
            g.ws[(static_cast<size_t>(blockIdx.z) * P + p) * plane + i] = acc[p][mi][ni][c];
        } else {
          float s[P];
#pragma unroll
          for (int p = 0; p < P; ++p) s[p] = acc[p][mi][ni][c];
          const float v = combine<P>(s);
          g.out[i] = g.accumulate ? g.out[i] + v : v;
        }
      }
}

// split-K: each product's chunks added in chunk order, then the products
// in _dot4's order
template <int P>
__global__ void __launch_bounds__(256) split_mm_reduce(const float* __restrict__ ws,
                                                       float* __restrict__ out, size_t plane,
                                                       int splits, int accumulate) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < plane;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float t = ws[p * plane + i];
      for (int z = 1; z < splits; ++z) t += ws[(static_cast<size_t>(z) * P + p) * plane + i];
      s[p] = t;
    }
    const float v = combine<P>(s);
    out[i] = accumulate ? out[i] + v : v;
  }
}

__global__ void split_mask_kernel(const float* __restrict__ a, unsigned short* __restrict__ hi,
                                  unsigned short* __restrict__ lo, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    split(a[i], hi[i], lo[i]);
}

template <int P>
int launch(const Args& g, int splits, cudaStream_t s) {
  const dim3 grid((g.N + BN - 1) / BN, (g.rows + BM - 1) / BM, splits);
  split_mm_kernel<P><<<grid, THREADS, 0, s>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t plane = static_cast<size_t>(g.rows) * g.N;
  const int blocks = static_cast<int>(std::min<size_t>((plane + 255) / 256, 132 * 8));
  split_mm_reduce<P><<<blocks, 256, 0, s>>>(g.ws, g.out, plane, splits, g.accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split_mm

// out (+)= the ``passes`` split products of a (rows, K) float32 and the
// split table (bh, bl) (K, N) bf16.  ``splits`` blocks along K of
// ``chunk`` each; with splits > 1, ws holds splits * passes * rows * N
// floats.  Returns the launch's cudaError_t.
extern "C" int sdft_split_mm_launch(const void* a, const void* bh, const void* bl, void* out,
                                    void* ws, int rows, int K, int N, int passes, int splits,
                                    int chunk, int accumulate, int vec_a, int vec_b,
                                    void* stream) {
  using namespace split_mm;
  if (rows < 1 || K < 1 || N < 1 || splits < 1 || chunk < 1 || chunk % BK ||
      static_cast<long long>(splits - 1) * chunk >= K || (splits > 1 && ws == nullptr) ||
      (rows + BM - 1) / BM > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(bh),
               static_cast<const __nv_bfloat16*>(bl), static_cast<float*>(out),
               splits > 1 ? static_cast<float*>(ws) : nullptr, rows, K, N, chunk, accumulate,
               vec_a, vec_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (passes) {
    case 3: return launch<3>(g, splits, s);
    case 4: return launch<4>(g, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the kernel's split alone, for holding its halves to the plain version's:
// n float32 of a -> n bf16 bit patterns each of hi and lo
extern "C" int sdft_split_mask_launch(const void* a, void* hi, void* lo, long long n,
                                      void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 132 * 8));
  split_mm::split_mask_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<unsigned short*>(hi),
      static_cast<unsigned short*>(lo), static_cast<size_t>(n));
  return static_cast<int>(cudaGetLastError());
}

// resident blocks per SM of the product kernel
extern "C" int sdft_split_mm_occupancy(int passes) {
  int n = 0;
  if (passes == 3)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_mm::split_mm_kernel<3>,
                                                  split_mm::THREADS, 0);
  else if (passes == 4)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_mm::split_mm_kernel<4>,
                                                  split_mm::THREADS, 0);
  return n;
}
