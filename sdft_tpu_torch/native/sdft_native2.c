/* sdft_native2: second native oracle engine (C99).
 *
 * Role: completes the reference-style differential triangle.  The reference
 * proves correctness by cross-checking three *independently written*
 * implementations of the same spec (reference: test/main.py:67-79); this
 * framework's triangle is the array code <-> engine #1 (sdft_native.cpp) <->
 * this engine.  Written from the algorithm spec (SURVEY.md section 0, Duda
 * 2010), not translated from the reference or from engine #1 — the
 * organization is deliberately different from both:
 *
 *   - block-first: the comb/delay stage materializes all n deltas up front
 *     in one pass over the ring buffer (the reference interleaves the comb
 *     with the bin loop per sample, c/src/sdft/sdft.h:562-598);
 *   - bin-major hot loop: each bin's modulated accumulation runs down the
 *     whole block with a phasor *recurrence* that is reset to exactly 1+0i
 *     at every 2m-sample stream boundary (the reference resets per cursor
 *     wrap inside a sample-major loop, c/src/sdft/sdft.h:566-576; engine #1
 *     uses an integer-exponent root table and never multiplies phasors);
 *   - frequency-domain windowing is a separate row pass whose Hermitian
 *     edge handling mirrors indices around DC and the Nyquist bin by index
 *     arithmetic (the reference and engine #1 use physical guard cells,
 *     c/src/sdft/sdft.h:589-595).
 *
 * Exposed as a plain C ABI (sdft_oracle2_*) for ctypes binding.
 */

#include <complex.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

typedef double complex cplx;

/* Window tap weights for the 3/5-tap bin convolution
 * (spec: c/src/sdft/sdft.h:350-402). */
enum { W_BOXCAR = 0, W_HANN = 1, W_HAMMING = 2, W_BLACKMAN = 3 };

typedef struct {
  int64_t m;        /* requested bins */
  int64_t period;   /* 2m: sliding window length and exact phase period */
  int32_t window;
  double latency;
  int td_single;    /* quantize TD values through float32 */
  int64_t t;        /* stream position mod period */
  double *ring;     /* delay line, length period, indexed by t */
  cplx *acc;        /* modulated accumulators, length m */
  double *delta;    /* per-block scratch, length cap */
  cplx *tmp;        /* row scratch for the window pass, length m */
  int64_t cap;      /* current delta scratch capacity */
} engine2;

static double td_cast(const engine2 *e, double v) {
  return e->td_single ? (double)(float)v : v;
}

void *sdft_oracle2_create(int64_t dftsize, int32_t window, double latency,
                          int32_t td_bits) {
  if (dftsize < 4) return NULL;
  engine2 *e = (engine2 *)calloc(1, sizeof(engine2));
  if (!e) return NULL;
  e->m = dftsize;
  e->period = 2 * dftsize;
  e->window = window;
  e->latency = latency;
  e->td_single = (td_bits == 32);
  e->ring = (double *)calloc((size_t)e->period, sizeof(double));
  e->acc = (cplx *)calloc((size_t)e->m, sizeof(cplx));
  e->tmp = (cplx *)calloc((size_t)e->m, sizeof(cplx));
  e->delta = NULL;
  e->cap = 0;
  e->t = 0;
  if (!e->ring || !e->acc || !e->tmp) {
    free(e->ring); free(e->acc); free(e->tmp); free(e);
    return NULL;
  }
  return e;
}

void sdft_oracle2_destroy(void *h) {
  engine2 *e = (engine2 *)h;
  if (!e) return;
  free(e->ring);
  free(e->acc);
  free(e->tmp);
  free(e->delta);
  free(e);
}

void sdft_oracle2_reset(void *h) {
  engine2 *e = (engine2 *)h;
  e->t = 0;
  memset(e->ring, 0, (size_t)e->period * sizeof(double));
  memset(e->acc, 0, (size_t)e->m * sizeof(cplx));
}

/* Mirrored-conjugate fetch for the window convolution: indices below DC
 * reflect around bin 0, indices above the top reflect around bin m-1, both
 * conjugated (the Hermitian symmetry the reference encodes as guard cells). */
static cplx edge(const cplx *row, int64_t m, int64_t j) {
  if (j < 0) return conj(row[-j]);
  if (j >= m) return conj(row[2 * (m - 1) - j]);
  return row[j];
}

void sdft_oracle2_sdft(void *h, int64_t n, const double *x, double *out_ri) {
  engine2 *e = (engine2 *)h;
  cplx *out = (cplx *)out_ri;
  const int64_t m = e->m, period = e->period;

  if (n > e->cap) {
    free(e->delta);
    e->delta = (double *)malloc((size_t)n * sizeof(double));
    if (!e->delta) { e->cap = 0; abort(); }
    e->cap = n;
  }

  /* Pass 1 — comb stage for the whole block.  delta[s] = x[t] - x[t-2m].
   * Note: at td_bits=32 the *difference* is rounded to float32 too — this is
   * the repo's TD-quantization convention shared with engine #1 (so the two
   * engines agree to 1e-12), slightly stricter than the reference, whose
   * c/src/sdft/sdft.h:564 keeps the difference of two TD floats in FD double
   * without rounding it; the ~1e-8 deviation sits far below the 1e-7 gate. */
  const int64_t t0 = e->t;
  {
    int64_t t = t0;
    for (int64_t s = 0; s < n; ++s) {
      const double sample = td_cast(e, x[s]);
      e->delta[s] = td_cast(e, sample - e->ring[t]);
      e->ring[t] = sample;
      t = (t + 1 == period) ? 0 : t + 1;
    }
    e->t = t;
  }

  /* Pass 2 — bin-major modulated accumulation.  For bin i the phasor walks
   * f <- f * exp(-i*pi*i/m) down the block, re-anchored to exactly 1 at
   * every 2m-sample stream boundary, so phase error cannot accumulate
   * across periods (the reference's reset trick in column form).  The
   * demodulated value acc*conj(f) lands directly in the output column;
   * windowing happens in pass 3. */
  for (int64_t i = 0; i < m; ++i) {
    const double ang = -M_PI * (double)i / (double)m;
    const cplx step = cos(ang) + sin(ang) * I;
    cplx f = cos(ang * (double)t0) + sin(ang * (double)t0) * I;
    cplx a = e->acc[i];
    int64_t tm = t0;
    cplx *col = out + i;
    for (int64_t s = 0; s < n; ++s) {
      a += f * e->delta[s];
      if (++tm == period) {
        tm = 0;
        f = 1.0;
        col[s * m] = a; /* conj(1) = 1 */
      } else {
        f *= step;
        col[s * m] = a * conj(f);
      }
    }
    e->acc[i] = a;
  }

  /* Pass 3 — frequency-domain window convolution per spectrum row with the
   * analysis normalization 1/(2m) (spec: c/src/sdft/sdft.h:350-402,422). */
  {
    double c0 = 1.0, c1 = 0.0, c2 = 0.0;
    int64_t halo = 0;
    switch (e->window) {
      case W_HANN:     c0 = 0.50; c1 = -0.25; halo = 1; break;
      case W_HAMMING:  c0 = 0.54; c1 = -0.23; halo = 1; break;
      case W_BLACKMAN: c0 = 0.42; c1 = -0.25; c2 = 0.04; halo = 2; break;
      default: break;
    }
    const double weight = 1.0 / (double)period;
    for (int64_t s = 0; s < n; ++s) {
      cplx *row = out + s * m;
      if (halo == 0) {
        for (int64_t i = 0; i < m; ++i) row[i] *= c0 * weight;
        continue;
      }
      memcpy(e->tmp, row, (size_t)m * sizeof(cplx));
      for (int64_t i = 0; i < m; ++i) {
        cplx v = c0 * e->tmp[i] +
                 c1 * (edge(e->tmp, m, i - 1) + edge(e->tmp, m, i + 1));
        if (halo >= 2)
          v += c2 * (edge(e->tmp, m, i - 2) + edge(e->tmp, m, i + 2));
        row[i] = v * weight;
      }
    }
  }
}

void sdft_oracle2_isdft(void *h, int64_t n, const double *dfts_ri, double *y) {
  engine2 *e = (engine2 *)h;
  const cplx *dfts = (const cplx *)dfts_ri;
  const int64_t m = e->m;

  if (e->latency == 1.0) {
    /* y = 2 * sum_i Re(dft[i]) * (-1)^i, organized as an even/odd split
     * (spec: c/src/sdft/sdft.h:639-645). */
    for (int64_t s = 0; s < n; ++s) {
      const cplx *row = dfts + s * m;
      double even = 0.0, odd = 0.0;
      for (int64_t i = 0; i < m; i += 2) even += creal(row[i]);
      for (int64_t i = 1; i < m; i += 2) odd += creal(row[i]);
      y[s] = td_cast(e, 2.0 * (even - odd));
    }
    return;
  }

  /* Reduced latency: per-bin synthesis phasors with the amplitude
   * demodulation weight, generated by recurrence instead of a table
   * (spec: c/src/sdft/sdft.h:440,445,647-653). */
  const double w = 2.0 / (1.0 - cos(M_PI * e->latency));
  const double ang = -M_PI * e->latency;
  const cplx step = cos(ang) + sin(ang) * I;
  for (int64_t s = 0; s < n; ++s) {
    const cplx *row = dfts + s * m;
    cplx ph = w; /* w * step^0 */
    double acc = 0.0;
    for (int64_t i = 0; i < m; ++i) {
      acc += creal(row[i] * ph);
      ph *= step;
    }
    y[s] = td_cast(e, 2.0 * acc);
  }
}
