// sdft_native: C++ oracle engine for the TPU SDFT framework.
//
// Role: the "native component" tier mirroring the reference's C/C++ header
// cores (reference: c/src/sdft/sdft.h, cpp/src/sdft/sdft.h) — a golden
// CPU implementation used for differential testing and as the host-side
// fallback engine.  Written from the algorithm spec (SURVEY.md §0, Duda
// 2010), not translated from the reference: phases are tracked as integer
// exponents of the primitive 2m-th root of unity and looked up in a
// precomputed root table, which is exact for endless streams — unlike the
// reference's multiply-and-reset phasor (c/src/sdft/sdft.h:566-576) this
// engine has zero phase drift *within* each 2m period as well.
//
// Exposed as a plain C ABI for ctypes binding (no pybind11 dependency).
//
// Build: see Makefile (g++ -O3 -shared -fPIC).

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using cplx = std::complex<double>;

enum WindowKind : int32_t { kBoxcar = 0, kHann = 1, kHamming = 2, kBlackman = 3 };

struct Taps {
  double c0, c1, c2;
  int halo;
};

Taps taps_for(int32_t window) {
  switch (window) {
    case kHann:     return {0.50, -0.25, 0.00, 1};
    case kHamming:  return {0.54, -0.23, 0.00, 1};
    case kBlackman: return {0.42, -0.25, 0.04, 2};
    default:        return {1.00, 0.00, 0.00, 0};
  }
}

// FD-precision-generic engine: F = double (reference FD default) or
// long double (the reference's extended tier, SDFT_FD_* long double at
// c/src/sdft/sdft.h:21-37,101-125 — x86-64 80-bit extended here).  The
// ctypes boundary stays complex128/f64; F is the internal accumulation
// and phase precision.
class EngineBase {
 public:
  virtual ~EngineBase() = default;
  virtual void reset() = 0;
  virtual void forward(int64_t n, const double* x, cplx* out) = 0;
  virtual void inverse(int64_t n, const cplx* dfts, double* y) = 0;
};

template <typename F>
class Engine : public EngineBase {
 public:
  using cf = std::complex<F>;

  Engine(int64_t dftsize, int32_t window, double latency, int td_bits)
      : m_(dftsize),
        n2_(2 * dftsize),
        window_(window),
        latency_(latency),
        td_single_(td_bits == 32),
        roots_(n2_),
        synth_(dftsize),
        ring_(n2_, F(0)),
        acc_(dftsize, cf(F(0), F(0))),
        expo_(dftsize, 0),
        aux_(dftsize + 4, cf(F(0), F(0))) {
    const F omega = -static_cast<F>(M_PI) / static_cast<F>(m_);
    for (int64_t r = 0; r < n2_; ++r) {
      roots_[r] = std::polar(F(1), omega * static_cast<F>(r));
    }
    // Synthesis phasors with amplitude demodulation
    // (spec: c/src/sdft/sdft.h:440,445,639-653).
    if (latency_ == 1.0) {
      for (int64_t i = 0; i < m_; ++i) synth_[i] = cf((i % 2) ? F(-1) : F(1), F(0));
    } else {
      const F w = F(2) / (F(1) - std::cos(static_cast<F>(M_PI) * static_cast<F>(latency_)));
      for (int64_t i = 0; i < m_; ++i) {
        synth_[i] = std::polar(w, -static_cast<F>(M_PI) * static_cast<F>(latency_) * static_cast<F>(i));
      }
    }
    reset();
  }

  void reset() override {
    pos_ = 0;
    std::fill(ring_.begin(), ring_.end(), 0.0);
    std::fill(acc_.begin(), acc_.end(), cplx(0.0, 0.0));
    for (int64_t i = 0; i < m_; ++i) expo_[i] = 0;
  }

  // Forward analysis for n samples; out is row-major (n, m) complex128.
  void forward(int64_t n, const double* x, cplx* out) override {
    const Taps t = taps_for(window_);
    const F weight = F(1) / static_cast<F>(n2_);
    for (int64_t s = 0; s < n; ++s) {
      // Comb stage in TD precision, then FD (spec: c/src/sdft/sdft.h:564).
      F sample = td_single_ ? static_cast<F>(static_cast<float>(x[s]))
                            : static_cast<F>(x[s]);
      F delta = sample - ring_[pos_];
      if (td_single_) delta = static_cast<F>(static_cast<float>(delta));
      ring_[pos_] = sample;
      pos_ = (pos_ + 1 == n2_) ? 0 : pos_ + 1;

      // Modulated accumulation with exact table phases.  expo_[i] holds
      // (t * i) mod 2m; advancing by one sample adds i.
      for (int64_t i = 0; i < m_; ++i) {
        int64_t r = expo_[i];
        acc_[i] += roots_[r] * delta;
        r += i;
        if (r >= n2_) r -= n2_;
        expo_[i] = r;
        aux_[i + 2] = acc_[i] * std::conj(roots_[r]);
      }

      // Hermitian guards around DC and Nyquist (spec: c/src/sdft/sdft.h:589-595).
      aux_[1] = std::conj(aux_[3]);
      aux_[0] = std::conj(aux_[4]);
      aux_[m_ + 2] = std::conj(aux_[m_]);
      aux_[m_ + 3] = std::conj(aux_[m_ - 1]);

      // Frequency-domain window convolution (spec: c/src/sdft/sdft.h:350-402).
      cplx* row = out + s * m_;
      for (int64_t i = 0; i < m_; ++i) {
        const cf mid = aux_[i + 2];
        cf v = static_cast<F>(t.c0) * mid;
        if (t.halo >= 1) v += static_cast<F>(t.c1) * (aux_[i + 1] + aux_[i + 3]);
        if (t.halo >= 2) v += static_cast<F>(t.c2) * (aux_[i] + aux_[i + 4]);
        v *= weight;
        row[i] = cplx(static_cast<double>(v.real()), static_cast<double>(v.imag()));
      }
    }
  }

  // Inverse synthesis for n spectra (spec: c/src/sdft/sdft.h:635-657).
  void inverse(int64_t n, const cplx* dfts, double* y) override {
    for (int64_t s = 0; s < n; ++s) {
      const cplx* row = dfts + s * m_;
      F acc = F(0);
      if (latency_ == 1.0) {
        for (int64_t i = 0; i < m_; ++i) {
          acc += static_cast<F>(row[i].real()) * ((i % 2) ? F(-1) : F(1));
        }
      } else {
        for (int64_t i = 0; i < m_; ++i) {
          const cf r(static_cast<F>(row[i].real()), static_cast<F>(row[i].imag()));
          acc += (r * synth_[i]).real();
        }
      }
      F out = F(2) * acc;
      y[s] = td_single_ ? static_cast<double>(static_cast<float>(out))
                        : static_cast<double>(out);
    }
  }

 private:
  int64_t m_, n2_;
  int32_t window_;
  double latency_;
  bool td_single_;
  std::vector<cf> roots_, synth_;
  std::vector<F> ring_;
  std::vector<cf> acc_;
  std::vector<int64_t> expo_;
  std::vector<cf> aux_;
  int64_t pos_ = 0;
};

}  // namespace

extern "C" {

// fd_bits selects the FD tier: 64 (double, reference default) or 80
// (long double — the reference's extended tier, c/src/sdft/sdft.h:21-37).
void* sdft_oracle_create_fd(int64_t dftsize, int32_t window, double latency,
                            int32_t td_bits, int32_t fd_bits) {
  if (dftsize < 4) return nullptr;
  if (fd_bits == 80) {
    return static_cast<EngineBase*>(new Engine<long double>(dftsize, window, latency, td_bits));
  }
  return static_cast<EngineBase*>(new Engine<double>(dftsize, window, latency, td_bits));
}

void* sdft_oracle_create(int64_t dftsize, int32_t window, double latency, int32_t td_bits) {
  return sdft_oracle_create_fd(dftsize, window, latency, td_bits, 64);
}

void sdft_oracle_destroy(void* h) { delete static_cast<EngineBase*>(h); }

void sdft_oracle_reset(void* h) { static_cast<EngineBase*>(h)->reset(); }

void sdft_oracle_sdft(void* h, int64_t n, const double* x, double* out) {
  static_cast<EngineBase*>(h)->forward(n, x, reinterpret_cast<cplx*>(out));
}

void sdft_oracle_isdft(void* h, int64_t n, const double* dfts, double* y) {
  static_cast<EngineBase*>(h)->inverse(n, reinterpret_cast<const cplx*>(dfts), y);
}

}  // extern "C"
