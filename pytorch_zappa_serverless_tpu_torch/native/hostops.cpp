// Native host ops for the serving runtime: the port's copy of the JAX
// package's native/hostops.cpp, function for function.
//
// The reference's preprocessing is torchvision transforms on the CPU: PIL
// shorter-side resize -> center crop.  This is the request path's host hot
// loop — it runs once per image while the GPU is busy elsewhere — so the
// framework carries a native implementation: a separable antialiased
// bilinear resampler (PIL/torchvision triangle filter semantics) FUSED with
// the center crop, so only the pixels that survive the crop are ever
// computed (a 256->224 crop discards ~23% of the resize output; the fused
// kernel never produces it).
//
// Layout: uint8 HWC RGB in, uint8 HWC RGB out — the wire format the batcher
// ships to the GPU (normalization runs on the device, inside the bucket's
// captured CUDA graph; ops/preprocessing.py normalize_on_device).
//
// Built by ops/hostops.py with g++ -O3 at first use; no external deps.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

// Triangle (bilinear) filter with PIL's antialias support scaling: when
// downscaling by s>1 the support widens to s, averaging instead of skipping.
struct Weights {
    // For each output index: first source index and a span of weights.
    std::vector<int> first;
    std::vector<int> count;
    std::vector<float> w;     // rows of max_count, normalized to sum 1
    int max_count;
};

Weights precompute(int src, int dst_begin, int dst_end, double scale) {
    // scale = src_size / full_dst_size; output indices [dst_begin, dst_end).
    Weights W;
    double support = scale < 1.0 ? 1.0 : scale;   // filter radius in src px
    int kmax = (int)std::ceil(support) * 2 + 1;
    W.max_count = kmax;
    int n = dst_end - dst_begin;
    W.first.resize(n);
    W.count.resize(n);
    W.w.assign((size_t)n * kmax, 0.0f);
    for (int i = 0; i < n; i++) {
        double center = (dst_begin + i + 0.5) * scale;
        int lo = (int)std::floor(center - support);
        int hi = (int)std::ceil(center + support);
        lo = std::max(lo, 0);
        hi = std::min(hi, src);
        double sum = 0.0;
        std::vector<double> tmp(hi - lo);
        double inv = scale < 1.0 ? 1.0 : 1.0 / scale;  // filter x-compression
        for (int j = lo; j < hi; j++) {
            double x = ((double)j + 0.5 - center) * inv;
            double v = x < 0 ? 1.0 + x : 1.0 - x;      // triangle
            tmp[j - lo] = v > 0 ? v : 0.0;
            sum += tmp[j - lo];
        }
        W.first[i] = lo;
        W.count[i] = hi - lo;
        for (int j = 0; j < hi - lo; j++)
            W.w[(size_t)i * kmax + j] = sum > 0 ? (float)(tmp[j] / sum) : 0.0f;
    }
    return W;
}

inline uint8_t clamp_round(float v) {
    int r = (int)std::lround(v);
    return (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
}

}  // namespace

extern "C" {

// Shorter-side resize to `resize_to` (aspect preserved, torchvision long-side
// truncation) + center crop to (crop, crop), fused. src: uint8 HWC RGB
// (sh, sw, 3); dst: uint8 HWC RGB (crop, crop, 3). Returns 0 on success.
int resize_center_crop_u8(const uint8_t* src, int sh, int sw,
                          uint8_t* dst, int resize_to, int crop) {
    if (sh <= 0 || sw <= 0 || resize_to <= 0 || crop <= 0) return 1;
    int new_w, new_h;
    if (sw <= sh) {
        new_w = resize_to;
        new_h = (int)((int64_t)sh * resize_to / sw);
    } else {
        new_h = resize_to;
        new_w = (int)((int64_t)sw * resize_to / sh);
    }
    if (crop > new_w || crop > new_h) return 2;
    // torchvision center_crop: round((size - crop) / 2) with round-half-even.
    auto half = [](int outer, int inner) {
        double v = (outer - inner) / 2.0;
        double r = std::nearbyint(v);     // default FE_TONEAREST = half-even
        return (int)r;
    };
    int left = half(new_w, crop), top = half(new_h, crop);

    double sx = (double)sw / new_w, sy = (double)sh / new_h;
    Weights wx = precompute(sw, left, left + crop, sx);
    Weights wy = precompute(sh, top, top + crop, sy);

    // Horizontal pass over all source rows, crop columns only (float32 HWC).
    std::vector<float> mid((size_t)sh * crop * 3);
    for (int y = 0; y < sh; y++) {
        const uint8_t* srow = src + (size_t)y * sw * 3;
        float* mrow = mid.data() + (size_t)y * crop * 3;
        for (int x = 0; x < crop; x++) {
            const float* w = wx.w.data() + (size_t)x * wx.max_count;
            int f = wx.first[x], c = wx.count[x];
            float r = 0, g = 0, b = 0;
            for (int j = 0; j < c; j++) {
                const uint8_t* p = srow + (size_t)(f + j) * 3;
                r += w[j] * p[0];
                g += w[j] * p[1];
                b += w[j] * p[2];
            }
            mrow[x * 3 + 0] = r;
            mrow[x * 3 + 1] = g;
            mrow[x * 3 + 2] = b;
        }
    }
    // Vertical pass over crop rows.
    for (int y = 0; y < crop; y++) {
        const float* w = wy.w.data() + (size_t)y * wy.max_count;
        int f = wy.first[y], c = wy.count[y];
        uint8_t* drow = dst + (size_t)y * crop * 3;
        for (int x = 0; x < crop * 3; x++) {
            float acc = 0;
            for (int j = 0; j < c; j++)
                acc += w[j] * mid[(size_t)(f + j) * crop * 3 + x];
            drow[x] = clamp_round(acc);
        }
    }
    return 0;
}

// Windowed-sinc audio resampler (Hann window, per-output weight
// normalization).  The Whisper frontend needs 16 kHz mono; clients send
// 44.1/48 kHz WAVs, and naive decimation would alias >8 kHz content straight
// into the mel band.  ratio = dst_rate / src_rate; n_dst outputs are
// computed at src positions i/ratio with cutoff min(ratio, 1) and a support
// of 16 source-step radii (quality comparable to soxr's "quick" preset,
// plenty above what the 80-bin mel front end resolves).  Returns 0 on
// success.
int resample_f32(const float* src, int64_t n_src, double ratio,
                 float* dst, int64_t n_dst) {
    if (!src || !dst || n_src <= 0 || n_dst < 0 || ratio <= 0.0) return 1;
    const double step = 1.0 / ratio;                 // src samples per output
    const double cutoff = ratio < 1.0 ? ratio : 1.0; // of src Nyquist
    const double support = 16.0 * (step > 1.0 ? step : 1.0);
    const double pi = 3.14159265358979323846;
    for (int64_t i = 0; i < n_dst; i++) {
        const double center = (double)i * step;
        int64_t lo = (int64_t)std::ceil(center - support);
        int64_t hi = (int64_t)std::floor(center + support);
        lo = std::max<int64_t>(lo, 0);
        hi = std::min<int64_t>(hi, n_src - 1);
        double acc = 0.0, wsum = 0.0;
        for (int64_t j = lo; j <= hi; j++) {
            const double x = (double)j - center;
            const double sx = x * cutoff;
            const double s = sx == 0.0 ? 1.0 : std::sin(pi * sx) / (pi * sx);
            const double w = s * (0.5 + 0.5 * std::cos(pi * x / support));
            acc += w * src[j];
            wsum += w;
        }
        dst[i] = wsum != 0.0 ? (float)(acc / wsum) : 0.0f;
    }
    return 0;
}

// Pack n HWC uint8 images (each hw*hw*3, already preprocessed) into the
// leading rows of a padded batch buffer of capacity cap images — the
// batcher's bucket-pack step without a Python loop over numpy views.
int pack_batch_u8(const uint8_t* const* srcs, int n, int bytes_per_image,
                  uint8_t* dst, int cap) {
    if (n < 0 || n > cap) return 1;
    for (int i = 0; i < n; i++)
        std::memcpy(dst + (size_t)i * bytes_per_image, srcs[i],
                    (size_t)bytes_per_image);
    return 0;
}

}  // extern "C"
