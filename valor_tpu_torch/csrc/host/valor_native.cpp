// valor_native: the C++ data-path runtime of the JAX package (native/), copied
// for the PyTorch port, which never loads the JAX package's build of it.
//
//   * decode_resize_batch: multi-threaded libjpeg decode -> antialiased
//     bilinear resize -> [0,1] normalise -> (x-mean)/std, NHWC float32 out.
//   * decode_resize_batch_u8: the same decode and resize with a uint8
//     epilogue (PIL's rounding); the normalisation runs on the card.
//   * fbank: kaldi-style log-mel (hanning, preemphasis 0.97, DC removal,
//     power spectrum via real radix-2 FFT, mel 1127*ln(1+f/700)).
//
// Built with g++ at first use by valor_tpu_torch/ops/kernels/_build.py
// (native/Makefile's flags) into valor_tpu_torch/_build/, and bound with
// ctypes by valor_tpu_torch/data/native.py, which falls back to PIL when
// the build fails.

#include <cstdio>  // must precede jpeglib.h (it needs FILE)

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG file into an RGB byte buffer. Returns false on failure.
bool decode_jpeg(const char* path, std::vector<uint8_t>& rgb, int& w, int& h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // NOTE: JDCT_IFAST and do_fancy_upsampling=FALSE were both tried for
  // the core-starved-host data path and rejected: either drops the
  // PIL-decode correlation below the 0.98 parity bar (test_native.py) —
  // full-quality decode is the parity contract.
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  rgb.resize(size_t(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// PIL-style antialiased triangle (bilinear) resampling: the kernel support
// widens by the scale factor on downscale, matching Image.BILINEAR and the
// torchvision Resize the reference uses (data/data.py:157-169).
struct Taps {
  std::vector<int> bounds;    // [out] start index
  std::vector<int> counts;    // [out] tap count
  std::vector<float> weights; // packed weights
  std::vector<int> offsets;   // [out] offset into weights
  int max_taps = 0;
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  const float scale = float(in_size) / out_size;
  const float support = scale < 1.f ? 1.f : scale;  // triangle radius
  t.bounds.resize(out_size);
  t.counts.resize(out_size);
  t.offsets.resize(out_size);
  for (int i = 0; i < out_size; ++i) {
    float center = (i + 0.5f) * scale;
    int lo = std::max(0, int(std::floor(center - support)));
    int hi = std::min(in_size, int(std::ceil(center + support)));
    t.bounds[i] = lo;
    t.counts[i] = hi - lo;
    t.offsets[i] = int(t.weights.size());
    float total = 0.f;
    for (int k = lo; k < hi; ++k) {
      float d = std::fabs((k + 0.5f - center) / support);
      float w = d < 1.f ? 1.f - d : 0.f;
      t.weights.push_back(w);
      total += w;
    }
    if (total > 0)
      for (int k = 0; k < t.counts[i]; ++k) t.weights[t.offsets[i] + k] /= total;
    t.max_taps = std::max(t.max_taps, t.counts[i]);
  }
  return t;
}

void resize_normalize(const uint8_t* src, int sw, int sh, float* dst, int dw,
                      int dh, const float* mean, const float* std) {
  Taps tx = make_taps(sw, dw);
  Taps ty = make_taps(sh, dh);
  // horizontal pass into a temp [sh, dw, 3]
  std::vector<float> tmp(size_t(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + size_t(y) * sw * 3;
    for (int x = 0; x < dw; ++x) {
      const float* w = tx.weights.data() + tx.offsets[x];
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < tx.counts[x]; ++k) {
        const uint8_t* px = row + size_t(tx.bounds[x] + k) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      float* o = tmp.data() + (size_t(y) * dw + x) * 3;
      o[0] = acc[0];
      o[1] = acc[1];
      o[2] = acc[2];
    }
  }
  // vertical pass + normalise
  for (int y = 0; y < dh; ++y) {
    const float* w = ty.weights.data() + ty.offsets[y];
    for (int x = 0; x < dw; ++x) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < ty.counts[y]; ++k) {
        const float* px = tmp.data() + (size_t(ty.bounds[y] + k) * dw + x) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      float* o = dst + (size_t(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c)
        o[c] = (acc[c] / 255.f - mean[c]) / std[c];
    }
  }
}

// Same two-pass antialiased resize with a uint8 epilogue — matches PIL
// exactly (PIL's Image.BILINEAR resize also rounds back to uint8; the
// reference normalises AFTER that quantisation, data/data.py:157-169).
// Shipping uint8 to the accelerator quarters H2D traffic; the
// (x/255-mean)/std normalisation runs on device.
void resize_u8(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw, int dh) {
  Taps tx = make_taps(sw, dw);
  Taps ty = make_taps(sh, dh);
  std::vector<float> tmp(size_t(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + size_t(y) * sw * 3;
    for (int x = 0; x < dw; ++x) {
      const float* w = tx.weights.data() + tx.offsets[x];
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < tx.counts[x]; ++k) {
        const uint8_t* px = row + size_t(tx.bounds[x] + k) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      float* o = tmp.data() + (size_t(y) * dw + x) * 3;
      o[0] = acc[0];
      o[1] = acc[1];
      o[2] = acc[2];
    }
  }
  for (int y = 0; y < dh; ++y) {
    const float* w = ty.weights.data() + ty.offsets[y];
    for (int x = 0; x < dw; ++x) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < ty.counts[y]; ++k) {
        const float* px = tmp.data() + (size_t(ty.bounds[y] + k) * dw + x) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      uint8_t* o = dst + (size_t(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = acc[c] + 0.5f;
        o[c] = uint8_t(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
      }
    }
  }
}

// In-place iterative radix-2 FFT over interleaved complex data.
void fft_radix2(float* re, float* im, int n) {
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (int len = 2; len <= n; len <<= 1) {
    float ang = -2.f * float(M_PI) / len;
    float wr = std::cos(ang), wi = std::sin(ang);
    for (int i = 0; i < n; i += len) {
      float cr = 1.f, ci = 0.f;
      for (int k = 0; k < len / 2; ++k) {
        float ur = re[i + k], ui = im[i + k];
        float vr = re[i + k + len / 2] * cr - im[i + k + len / 2] * ci;
        float vi = re[i + k + len / 2] * ci + im[i + k + len / 2] * cr;
        re[i + k] = ur + vr;
        im[i + k] = ui + vi;
        re[i + k + len / 2] = ur - vr;
        im[i + k + len / 2] = ui - vi;
        float ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
}

inline float mel_scale(float f) { return 1127.f * std::log(1.f + f / 700.f); }

}  // namespace

extern "C" {

// paths: n null-terminated strings; out: [n, dh, dw, 3] float32.
// mean/std: 3 floats each. Returns number of failed decodes (their slots
// are zero-filled; the python layer decides on resampling).
int decode_resize_batch(const char** paths, int n, int dw, int dh,
                        const float* mean, const float* stdv, float* out) {
  int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
  for (int i = 0; i < n; ++i) {
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    float* dst = out + size_t(i) * dw * dh * 3;
    if (decode_jpeg(paths[i], rgb, w, h)) {
      resize_normalize(rgb.data(), w, h, dst, dw, dh, mean, stdv);
    } else {
      std::memset(dst, 0, size_t(dw) * dh * 3 * sizeof(float));
      failures += 1;
    }
  }
  return failures;
}

// uint8 variant: out is [n, dh, dw, 3] uint8 (PIL-parity rounding);
// normalisation happens on the accelerator. Returns failed decode count.
int decode_resize_batch_u8(const char** paths, int n, int dw, int dh,
                           uint8_t* out) {
  int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
  for (int i = 0; i < n; ++i) {
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    uint8_t* dst = out + size_t(i) * dw * dh * 3;
    if (decode_jpeg(paths[i], rgb, w, h)) {
      resize_u8(rgb.data(), w, h, dst, dw, dh);
    } else {
      std::memset(dst, 0, size_t(dw) * dh * 3);
      failures += 1;
    }
  }
  return failures;
}

// Kaldi-style log-mel fbank. wav: [n_samples]; out: [n_frames, num_bins]
// with n_frames = 1 + (n_samples - win) / shift (snip_edges). Returns
// n_frames, or -1 on error.
int fbank(const float* wav, int n_samples, int sample_rate, int num_bins,
          float frame_shift_ms, float frame_length_ms, float preemph,
          float* out) {
  const int shift = int(sample_rate * frame_shift_ms / 1000.f);
  const int win = int(sample_rate * frame_length_ms / 1000.f);
  if (n_samples < win) return -1;
  int nfft = 1;
  while (nfft < win) nfft <<= 1;
  const int half = nfft / 2 + 1;
  const int n_frames = 1 + (n_samples - win) / shift;

  std::vector<float> window(win);
  for (int i = 0; i < win; ++i)
    window[i] = 0.5f - 0.5f * std::cos(2.f * float(M_PI) * i / (win - 1));

  // mel bank (triangles), low 20 Hz .. nyquist
  const float low = 20.f, high = 0.5f * sample_rate;
  const float mlo = mel_scale(low), mhi = mel_scale(high);
  const float delta = (mhi - mlo) / (num_bins + 1);
  std::vector<float> melw(size_t(half) * num_bins, 0.f);
  for (int k = 0; k < half; ++k) {
    float m = mel_scale(k * float(sample_rate) / nfft);
    for (int b = 0; b < num_bins; ++b) {
      float left = mlo + b * delta, center = left + delta, right = center + delta;
      float up = (m - left) / delta, down = (right - m) / delta;
      float v = std::min(up, down);
      if (v > 0) melw[size_t(k) * num_bins + b] = v;
    }
  }

#pragma omp parallel
  {
    std::vector<float> re(nfft), im(nfft);
#pragma omp for schedule(static)
    for (int t = 0; t < n_frames; ++t) {
      const float* frame = wav + size_t(t) * shift;
      double mean = 0;
      for (int i = 0; i < win; ++i) mean += frame[i];
      mean /= win;
      // dc removal + preemphasis + window
      re[0] = float((frame[0] - mean) - preemph * (frame[0] - mean)) * window[0];
      for (int i = 1; i < win; ++i)
        re[i] = float((frame[i] - mean) - preemph * (frame[i - 1] - mean)) * window[i];
      std::fill(re.begin() + win, re.end(), 0.f);
      std::fill(im.begin(), im.end(), 0.f);
      fft_radix2(re.data(), im.data(), nfft);
      float* dst = out + size_t(t) * num_bins;
      std::fill(dst, dst + num_bins, 0.f);
      for (int k = 0; k < half; ++k) {
        float p = re[k] * re[k] + im[k] * im[k];
        const float* mw = melw.data() + size_t(k) * num_bins;
        for (int b = 0; b < num_bins; ++b) dst[b] += p * mw[b];
      }
      for (int b = 0; b < num_bins; ++b)
        dst[b] = std::log(std::max(dst[b], 1.1920929e-07f));
    }
  }
  return n_frames;
}

}  // extern "C"
