// Native pitch-epoch (GCI) detector — the C++ runtime piece replacing the
// reference's external REAPER binary (SURVEY.md §2.9).
//
// Algorithm (mirrors snickery_tpu/features/epochs.py so the two
// implementations can be cross-checked):
//   1. zero-phase low-pass (4th-order Butterworth as two cascaded biquads,
//      forward + backward),
//   2. frame-based f0 by normalised autocorrelation with parabolic
//      interpolation,
//   3. pitch-synchronous negative-peak picking through voiced regions,
//      constant-rate marks through unvoiced regions.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct Biquad {
  double b0, b1, b2, a1, a2;  // normalised (a0 == 1)
  double z1 = 0.0, z2 = 0.0;

  inline double step(double x) {
    // transposed direct form II
    double y = b0 * x + z1;
    z1 = b1 * x - a1 * y + z2;
    z2 = b2 * x - a2 * y;
    return y;
  }
  void reset() { z1 = z2 = 0.0; }
};

// Butterworth low-pass section coefficients via bilinear transform.
Biquad butter_lowpass_section(double cutoff_hz, double sr, double q) {
  double w0 = 2.0 * kPi * cutoff_hz / sr;
  double alpha = std::sin(w0) / (2.0 * q);
  double cw = std::cos(w0);
  double b0 = (1.0 - cw) / 2.0, b1 = 1.0 - cw, b2 = (1.0 - cw) / 2.0;
  double a0 = 1.0 + alpha, a1 = -2.0 * cw, a2 = 1.0 - alpha;
  Biquad s;
  s.b0 = b0 / a0;
  s.b1 = b1 / a0;
  s.b2 = b2 / a0;
  s.a1 = a1 / a0;
  s.a2 = a2 / a0;
  return s;
}

// Zero-phase 4th-order Butterworth low-pass (Q values of the two cascaded
// 2nd-order sections of a 4th-order Butterworth: 0.54120, 1.30656).
void lowpass_zero_phase(const float* x, int n, double sr, double cutoff,
                        std::vector<float>* out) {
  out->assign(x, x + n);
  Biquad s1 = butter_lowpass_section(cutoff, sr, 0.5411961);
  Biquad s2 = butter_lowpass_section(cutoff, sr, 1.3065630);
  auto run = [&](std::vector<float>& v, bool reverse) {
    s1.reset();
    s2.reset();
    if (!reverse) {
      for (int i = 0; i < n; ++i) v[i] = (float)s2.step(s1.step(v[i]));
    } else {
      for (int i = n - 1; i >= 0; --i) v[i] = (float)s2.step(s1.step(v[i]));
    }
  };
  run(*out, false);
  run(*out, true);
}

struct F0Track {
  std::vector<float> f0;  // per frame, 0 = unvoiced
  int hop = 0;
  int frame = 0;
};

// Frame-based f0 by normalised autocorrelation, two-stage: a COARSE pass on a
// decimated copy of the (already 1 kHz-low-passed) frame locates the
// autocorrelation peak at ~1/D² of the full cost, then a REFINE pass
// evaluates the exact full-rate autocorrelation only in a ±D-lag window
// around the coarse peak (plus one lag each side for the parabolic
// interpolation).  Decimating a 1 kHz-band signal to sr/D >= 4 kHz loses no
// usable correlation structure, and the pitch-synchronous peak-picking that
// consumes these f0 values tolerates far more than the coarse pass's worst
// peak-localisation error (the pick window spans ±25% of a period).
F0Track track_f0(const std::vector<float>& x, int n, double sr, double fmin,
                 double fmax, double frame_sec, double hop_sec,
                 double voicing_threshold) {
  F0Track tr;
  tr.frame = (int)std::lround(frame_sec * sr);
  tr.hop = (int)std::lround(hop_sec * sr);
  int lag_min = std::max(2, (int)(sr / fmax));
  int lag_max = std::min(tr.frame - 1, (int)(sr / fmin));
  int n_frames = std::max(1, (n - tr.frame) / tr.hop + 1);
  tr.f0.assign(n_frames, 0.0f);

  // decimation factor: keep the decimated rate >= 4 kHz (4x the 1 kHz
  // low-pass cutoff) and the decimated minimum lag >= 4 so the coarse peak
  // is localised to within one decimated sample
  int D = 1;
  while (sr / (D * 2) >= 4000.0 && lag_min / (D * 2) >= 4) D *= 2;

  int frame_d = tr.frame / std::max(D, 1);
  int lag_min_d = std::max(1, lag_min / D);
  int lag_max_d = std::min(frame_d - 1, lag_max / D);

  std::vector<double> seg(tr.frame);
  std::vector<double> seg_d(frame_d);
  std::vector<double> ac(lag_max + 1, 0.0);
  for (int fi = 0; fi < n_frames; ++fi) {
    const float* s = x.data() + fi * tr.hop;
    double mean = 0.0;
    for (int i = 0; i < tr.frame; ++i) mean += s[i];
    mean /= tr.frame;
    double denom = 0.0;
    for (int i = 0; i < tr.frame; ++i) {
      seg[i] = s[i] - mean;
      denom += seg[i] * seg[i];
    }
    if (denom < 1e-10) continue;

    int lo = lag_min, hi = lag_max;  // refine window (full range when D==1)
    if (D > 1 && lag_max_d >= lag_min_d) {
      double mean_d = 0.0;
      for (int i = 0; i < frame_d; ++i) mean_d += s[i * D];
      mean_d /= frame_d;
      double denom_d = 0.0;
      for (int i = 0; i < frame_d; ++i) {
        seg_d[i] = s[i * D] - mean_d;
        denom_d += seg_d[i] * seg_d[i];
      }
      if (denom_d < 1e-10) continue;
      int best_d = -1;
      double best_vd = -1.0;
      for (int lag = lag_min_d; lag <= lag_max_d; ++lag) {
        double acc = 0.0;
        for (int i = 0; i + lag < frame_d; ++i) acc += seg_d[i] * seg_d[i + lag];
        if (acc > best_vd) {
          best_vd = acc;
          best_d = lag;
        }
      }
      if (best_d < 0) continue;
      lo = std::max(lag_min, best_d * D - D - 1);
      hi = std::min(lag_max, best_d * D + D + 1);
    }

    int best_lag = -1;
    double best_val = -1.0;
    for (int lag = lo; lag <= hi; ++lag) {
      double acc = 0.0;
      for (int i = 0; i + lag < tr.frame; ++i) acc += seg[i] * seg[i + lag];
      ac[lag] = acc / denom;
      if (ac[lag] > best_val) {
        best_val = ac[lag];
        best_lag = lag;
      }
    }
    if (best_lag > 0 && best_val >= voicing_threshold) {
      double lag = best_lag;
      if (best_lag > lo && best_lag < hi) {
        double y0 = ac[best_lag - 1], y1 = ac[best_lag], y2 = ac[best_lag + 1];
        double d2 = y0 - 2.0 * y1 + y2;
        if (std::fabs(d2) > 1e-12) lag = best_lag + 0.5 * (y0 - y2) / d2;
      }
      tr.f0[fi] = (float)(sr / lag);
    }
  }
  return tr;
}

}  // namespace

extern "C" {

// Returns the number of epochs written to out_marks (<= max_marks), or -1.
int snickery_detect_epochs(const float* wave, int n, int sr, float fmin,
                           float fmax, float unvoiced_period_sec,
                           int32_t* out_marks, int max_marks) {
  if (n <= 0 || sr <= 0 || !wave || !out_marks) return -1;
  double unvoiced_step = (double)unvoiced_period_sec * sr;
  if (n < (int)(0.05 * sr)) {
    int step = std::max(1, (int)unvoiced_step);
    int cnt = 0;
    for (int pos = 0; pos < n && cnt < max_marks; pos += step)
      out_marks[cnt++] = pos;
    return cnt;
  }

  std::vector<float> lp;
  lowpass_zero_phase(wave, n, sr, 1000.0, &lp);
  F0Track tr = track_f0(lp, n, sr, fmin, fmax, 0.040, 0.010, 0.30);
  double hop_samples = 0.010 * sr;

  auto local_f0 = [&](double pos) -> double {
    int idx = (int)(pos / hop_samples);
    if (idx < 0) idx = 0;
    if (idx >= (int)tr.f0.size()) idx = (int)tr.f0.size() - 1;
    return tr.f0[idx];
  };

  int cnt = 0;
  int32_t last_mark = -1;
  double pos = 0.0;
  while (pos < n - 1 && cnt < max_marks) {
    double f0 = local_f0(pos);
    double nxt;
    if (f0 > 0.0) {
      double period = sr / f0;
      int lo = (int)std::max(pos + 0.75 * period, pos + 2.0);
      int hi = (int)std::min(pos + 1.25 * period, (double)n);
      if (hi - lo < 2) {
        nxt = pos + period;
      } else {
        int arg = lo;
        float best = lp[lo];
        for (int i = lo + 1; i < hi; ++i)
          if (lp[i] < best) {
            best = lp[i];
            arg = i;
          }
        nxt = arg;
      }
      int32_t mark = (int32_t)std::lround(nxt);
      if (mark >= 0 && mark < n && mark != last_mark) {
        out_marks[cnt++] = mark;
        last_mark = mark;
      }
      pos = nxt;
    } else {
      nxt = pos + unvoiced_step;
      if (nxt < n) {
        int32_t mark = (int32_t)std::lround(nxt);
        if (mark >= 0 && mark < n && mark != last_mark) {
          out_marks[cnt++] = mark;
          last_mark = mark;
        }
      }
      pos = nxt;
    }
  }
  return cnt;
}

// Batch variant: concatenated waves with offsets; parallel-friendly from the
// caller's thread pool (the function itself is thread-safe and reentrant).
int snickery_detect_epochs_batch(const float* waves, const int64_t* offsets,
                                 int n_utts, int sr, float fmin, float fmax,
                                 float unvoiced_period_sec, int32_t* out_marks,
                                 const int64_t* out_offsets_capacity,
                                 int32_t* out_counts) {
  for (int u = 0; u < n_utts; ++u) {
    const float* w = waves + offsets[u];
    int n = (int)(offsets[u + 1] - offsets[u]);
    int cap = (int)(out_offsets_capacity[u + 1] - out_offsets_capacity[u]);
    int cnt = snickery_detect_epochs(w, n, sr, fmin, fmax, unvoiced_period_sec,
                                     out_marks + out_offsets_capacity[u], cap);
    if (cnt < 0) return -1;
    out_counts[u] = cnt;
  }
  return 0;
}

// Multithreaded batch variant: utterances are independent, so the batch is
// carved over a work-stealing atomic index.  Per-utterance output is
// bit-identical to the serial entry (same scalar routine, disjoint output
// slices).  n_threads <= 1 falls through to the serial loop; errors from any
// worker (cnt < 0) fail the whole call, matching the serial contract.
int snickery_detect_epochs_batch_mt(const float* waves, const int64_t* offsets,
                                    int n_utts, int sr, float fmin, float fmax,
                                    float unvoiced_period_sec,
                                    int32_t* out_marks,
                                    const int64_t* out_offsets_capacity,
                                    int32_t* out_counts, int n_threads) {
  if (n_threads <= 1 || n_utts <= 1)
    return snickery_detect_epochs_batch(waves, offsets, n_utts, sr, fmin, fmax,
                                        unvoiced_period_sec, out_marks,
                                        out_offsets_capacity, out_counts);
  if (n_threads > n_utts) n_threads = n_utts;
  std::atomic<int> next(0);
  std::atomic<bool> failed(false);
  auto worker = [&]() {
    for (;;) {
      int u = next.fetch_add(1, std::memory_order_relaxed);
      if (u >= n_utts || failed.load(std::memory_order_relaxed)) return;
      const float* w = waves + offsets[u];
      int n = (int)(offsets[u + 1] - offsets[u]);
      int cap = (int)(out_offsets_capacity[u + 1] - out_offsets_capacity[u]);
      int cnt = snickery_detect_epochs(w, n, sr, fmin, fmax,
                                       unvoiced_period_sec,
                                       out_marks + out_offsets_capacity[u],
                                       cap);
      if (cnt < 0) {
        failed.store(true, std::memory_order_relaxed);
        return;
      }
      out_counts[u] = cnt;
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads - 1);
  for (int t = 0; t < n_threads - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failed.load() ? -1 : 0;
}

}  // extern "C"
