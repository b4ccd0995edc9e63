// srcnn_host: native host-side runtime for the SRCNN framework.
//
// The accelerator owns the conv stack (JAX/XLA/Pallas); this library owns the
// host-side work around it, mirroring the native layer of the reference
// binary (reference src/srcnn.cpp pipeline stages, src/frawscale.{h,cpp}
// resize engine, src/tick.cpp timer) with a fresh implementation:
//
//  * srcnn_host_resize_cubic_u8  — OpenCV-4.6-bit-exact INTER_CUBIC uint8
//    resize (integer horizontal pass, float32 right-to-left vertical pass),
//    multi-threaded over output rows.  Same arithmetic as the JAX engine
//    (srcnn_cpp_tpu/ops/resize.py) so host preprocessing and device
//    preprocessing are interchangeable bit-for-bit.
//  * srcnn_host_resize_separable_f32 — general weights-table resampler
//    (box / bilinear / Mitchell / Catmull-Rom / Lanczos3), anti-aliased
//    downscale, normalized windows, clamp-to-edge — the capability of the
//    reference's standalone engine (frawscale.cpp:8-151,157-385),
//    re-derived from the resampling math.
//  * srcnn_host_bgr2ycrcb_u8 / ycrcb2bgr — OpenCV-bit-exact fixed-point
//    colorspace conversion.
//  * srcnn_host_tick_ms — monotonic milliseconds (tick.cpp equivalent).
//
// C ABI for ctypes; no dependency on OpenCV or the reference sources.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// Thread pool-lite: run fn(begin, end) over [0, n) split across hw threads.
// ---------------------------------------------------------------------------
template <typename F>
void parallel_rows(int n, F&& fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int nthreads = std::max(1, std::min<int>(hw ? (int)hw : 1, n));
    if (nthreads == 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    int chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        int b = t * chunk, e = std::min(n, b + chunk);
        if (b >= e) break;
        ts.emplace_back([=, &fn] { fn(b, e); });
    }
    for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// OpenCV-exact cubic tables (see srcnn_cpp_tpu/ops/resize_tables.py for the
// derivation; float32 coordinate math, a=-0.75, coeffs scaled by 2048 and
// rounded half-to-even).
// ---------------------------------------------------------------------------
struct CubicAxis {
    std::vector<int32_t> idx;    // [dst * 4] clamped tap indices
    std::vector<int32_t> icoef;  // [dst * 4] integer coefficients
    std::vector<float> fcoef;    // [dst * 4] icoef * (1/2048^2)
};

float rint_half_even(float x) { return std::nearbyintf(x); }

CubicAxis cubic_axis(int dst, int src) {
    CubicAxis ax;
    ax.idx.resize((size_t)dst * 4);
    ax.icoef.resize((size_t)dst * 4);
    ax.fcoef.resize((size_t)dst * 4);
    const double scale = (double)src / dst;
    const float A = -0.75f;
    for (int i = 0; i < dst; ++i) {
        float f = (float)((i + 0.5) * scale - 0.5);
        int s = (int)std::floor(f);
        float fx = f - (float)s;
        float c[4];
        c[0] = ((A * (fx + 1) - 5 * A) * (fx + 1) + 8 * A) * (fx + 1) - 4 * A;
        c[1] = ((A + 2) * fx - (A + 3)) * fx * fx + 1;
        c[2] = ((A + 2) * (1 - fx) - (A + 3)) * (1 - fx) * (1 - fx) + 1;
        c[3] = 1.f - c[0] - c[1] - c[2];
        for (int k = 0; k < 4; ++k) {
            int32_t ic = (int32_t)rint_half_even(c[k] * 2048.0f);
            ax.idx[(size_t)i * 4 + k] = clampi(s - 1 + k, 0, src - 1);
            ax.icoef[(size_t)i * 4 + k] = ic;
            ax.fcoef[(size_t)i * 4 + k] =
                (float)ic * (1.0f / (2048.0f * 2048.0f));
        }
    }
    return ax;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Timer (reference tick.cpp:28-37 equivalent; monotonic, ms).
// ---------------------------------------------------------------------------
double srcnn_host_tick_ms(void) {
    using namespace std::chrono;
    static const steady_clock::time_point t0 = steady_clock::now();
    return duration_cast<duration<double, std::milli>>(steady_clock::now() - t0)
        .count();
}

// ---------------------------------------------------------------------------
// OpenCV-4.6-bit-exact INTER_CUBIC uint8 resize.
// src: [ih*iw], dst: [oh*ow]; returns 0 on success.
// ---------------------------------------------------------------------------
int srcnn_host_resize_cubic_u8(const uint8_t* src, int ih, int iw,
                               uint8_t* dst, int oh, int ow) {
    if (!src || !dst || ih <= 0 || iw <= 0 || oh <= 0 || ow <= 0) return -1;
    CubicAxis xs = cubic_axis(ow, iw);
    CubicAxis ys = cubic_axis(oh, ih);

    // horizontal pass: integer rows buffer [ih][ow]
    std::vector<int32_t> rows((size_t)ih * ow);
    parallel_rows(ih, [&](int rb, int re) {
        for (int r = rb; r < re; ++r) {
            const uint8_t* srow = src + (size_t)r * iw;
            int32_t* drow = rows.data() + (size_t)r * ow;
            for (int c = 0; c < ow; ++c) {
                const int32_t* ic = &xs.icoef[(size_t)c * 4];
                const int32_t* id = &xs.idx[(size_t)c * 4];
                drow[c] = srow[id[0]] * ic[0] + srow[id[1]] * ic[1] +
                          srow[id[2]] * ic[2] + srow[id[3]] * ic[3];
            }
        }
    });

    // vertical pass: float32, right-to-left separate mul/add roundings
    parallel_rows(oh, [&](int rb, int re) {
        for (int r = rb; r < re; ++r) {
            const int32_t* id = &ys.idx[(size_t)r * 4];
            const float* fc = &ys.fcoef[(size_t)r * 4];
            const int32_t* s0 = rows.data() + (size_t)id[0] * ow;
            const int32_t* s1 = rows.data() + (size_t)id[1] * ow;
            const int32_t* s2 = rows.data() + (size_t)id[2] * ow;
            const int32_t* s3 = rows.data() + (size_t)id[3] * ow;
            uint8_t* drow = dst + (size_t)r * ow;
            for (int c = 0; c < ow; ++c) {
                float v = (float)s3[c] * fc[3];
                v = (float)s2[c] * fc[2] + v;
                v = (float)s1[c] * fc[1] + v;
                v = (float)s0[c] * fc[0] + v;
                float q = rint_half_even(v);
                drow[c] = (uint8_t)clampi((int)q, 0, 255);
            }
        }
    });
    return 0;
}

// ---------------------------------------------------------------------------
// Generic separable float resampler (frawscale-capability counterpart).
// filter: 0=box 1=bilinear 2=mitchell 3=catmull_rom 4=lanczos3
//         5=cubic_matlab (Keys a=-0.5, MATLAB imresize 'bicubic' —
//         the SRCNN evaluation degradation kernel, Pictures/Resize.m)
// ---------------------------------------------------------------------------
namespace {

double kernel_eval(int filter, double x) {
    double ax = std::fabs(x);
    switch (filter) {
        case 0:  // box
            return ax <= 0.5 ? 1.0 : 0.0;
        case 1:  // bilinear (triangle)
            return ax < 1.0 ? 1.0 - ax : 0.0;
        case 2: {  // Mitchell-Netravali b=c=1/3
            const double b = 1.0 / 3.0, c = 1.0 / 3.0;
            double x2 = ax * ax, x3 = x2 * ax;
            if (ax < 1.0)
                return ((12 - 9 * b - 6 * c) * x3 +
                        (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)) / 6.0;
            if (ax < 2.0)
                return ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 +
                        (-12 * b - 48 * c) * ax + (8 * b + 24 * c)) / 6.0;
            return 0.0;
        }
        case 3: case 5: {  // Catmull-Rom family (3: a=-0.75, 5: a=-0.5)
            const double a = filter == 3 ? -0.75 : -0.5;
            if (ax < 1.0) return ((a + 2) * ax - (a + 3)) * ax * ax + 1;
            if (ax < 2.0) return ((a * ax - 5 * a) * ax + 8 * a) * ax - 4 * a;
            return 0.0;
        }
        case 4: {  // Lanczos3
            if (ax >= 3.0) return 0.0;
            if (ax < 1e-12) return 1.0;
            double px = M_PI * ax;
            return 3.0 * std::sin(px) * std::sin(px / 3.0) / (px * px);
        }
        default:
            return 0.0;
    }
}

double kernel_support(int filter) {
    switch (filter) {
        case 0: return 0.5;
        case 1: return 1.0;
        case 2: case 3: case 5: return 2.0;
        case 4: return 3.0;
        default: return 1.0;
    }
}

struct SepAxis {
    int ntaps;
    std::vector<int32_t> idx;  // [dst * ntaps]
    std::vector<float> wgt;    // [dst * ntaps]
};

SepAxis sep_axis(int dst, int src, int filter) {
    SepAxis ax;
    double support = kernel_support(filter);
    double scale = (double)dst / src;
    double fwidth = support, fscale = 1.0;
    if (scale < 1.0) {
        fwidth = support / scale;  // anti-aliased downscale
        fscale = scale;
    }
    ax.ntaps = 2 * (int)std::ceil(fwidth) + 1;
    ax.idx.resize((size_t)dst * ax.ntaps);
    ax.wgt.resize((size_t)dst * ax.ntaps);
    for (int i = 0; i < dst; ++i) {
        double center = (i + 0.5) / scale - 0.5;
        long left = (long)std::ceil(center - fwidth);
        double sum = 0.0;
        std::vector<double> w(ax.ntaps);
        for (int t = 0; t < ax.ntaps; ++t) {
            w[t] = kernel_eval(filter, (center - (double)(left + t)) * fscale);
            sum += w[t];
        }
        if (sum == 0.0) sum = 1.0;
        for (int t = 0; t < ax.ntaps; ++t) {
            ax.idx[(size_t)i * ax.ntaps + t] =
                clampi((int)(left + t), 0, src - 1);
            ax.wgt[(size_t)i * ax.ntaps + t] = (float)(w[t] / sum);
        }
    }
    return ax;
}

}  // namespace

int srcnn_host_resize_separable_f32(const float* src, int ih, int iw,
                                    float* dst, int oh, int ow, int filter) {
    if (!src || !dst || ih <= 0 || iw <= 0 || oh <= 0 || ow <= 0) return -1;
    if (filter < 0 || filter > 5) return -2;
    SepAxis xs = sep_axis(ow, iw, filter);
    SepAxis ys = sep_axis(oh, ih, filter);

    // horizontal first when downscaling, vertical first when upscaling
    // (minimizes the intermediate, reference frawscale.cpp:195-278)
    if (ow <= iw) {
        std::vector<float> mid((size_t)ih * ow);
        parallel_rows(ih, [&](int rb, int re) {
            for (int r = rb; r < re; ++r)
                for (int c = 0; c < ow; ++c) {
                    double acc = 0.0;
                    for (int t = 0; t < xs.ntaps; ++t)
                        acc += (double)src[(size_t)r * iw +
                                           xs.idx[(size_t)c * xs.ntaps + t]] *
                               xs.wgt[(size_t)c * xs.ntaps + t];
                    mid[(size_t)r * ow + c] = (float)acc;
                }
        });
        parallel_rows(oh, [&](int rb, int re) {
            for (int r = rb; r < re; ++r)
                for (int c = 0; c < ow; ++c) {
                    double acc = 0.0;
                    for (int t = 0; t < ys.ntaps; ++t)
                        acc += (double)mid[(size_t)ys.idx[(size_t)r * ys.ntaps + t] *
                                               ow + c] *
                               ys.wgt[(size_t)r * ys.ntaps + t];
                    dst[(size_t)r * ow + c] = (float)acc;
                }
        });
    } else {
        std::vector<float> mid((size_t)oh * iw);
        parallel_rows(oh, [&](int rb, int re) {
            for (int r = rb; r < re; ++r)
                for (int c = 0; c < iw; ++c) {
                    double acc = 0.0;
                    for (int t = 0; t < ys.ntaps; ++t)
                        acc += (double)src[(size_t)ys.idx[(size_t)r * ys.ntaps + t] *
                                               iw + c] *
                               ys.wgt[(size_t)r * ys.ntaps + t];
                    mid[(size_t)r * iw + c] = (float)acc;
                }
        });
        parallel_rows(oh, [&](int rb, int re) {
            for (int r = rb; r < re; ++r)
                for (int c = 0; c < ow; ++c) {
                    double acc = 0.0;
                    for (int t = 0; t < xs.ntaps; ++t)
                        acc += (double)mid[(size_t)r * iw +
                                           xs.idx[(size_t)c * xs.ntaps + t]] *
                               xs.wgt[(size_t)c * xs.ntaps + t];
                    dst[(size_t)r * ow + c] = (float)acc;
                }
        });
    }
    return 0;
}

// ---------------------------------------------------------------------------
// OpenCV-bit-exact uint8 colorspace conversion (14-bit fixed point).
// Layout: interleaved [h*w*3]; BGR <-> YCrCb.
// ---------------------------------------------------------------------------
static inline int32_t descale14(int64_t x) {
    return (int32_t)((x + (1 << 13)) >> 14);
}

int srcnn_host_bgr2ycrcb_u8(const uint8_t* bgr, uint8_t* ycrcb, int64_t n_px) {
    if (!bgr || !ycrcb || n_px < 0) return -1;
    if (n_px > INT32_MAX) return -2;
    parallel_rows((int)n_px, [&](int b, int e) {
        for (int64_t i = b; i < e; ++i) {
            int32_t bb = bgr[i * 3 + 0], g = bgr[i * 3 + 1], r = bgr[i * 3 + 2];
            int32_t y = descale14(bb * 1868 + g * 9617 + r * 4899);
            int32_t cr = descale14((int64_t)(r - y) * 11682 + (128 << 14));
            int32_t cb = descale14((int64_t)(bb - y) * 9241 + (128 << 14));
            ycrcb[i * 3 + 0] = (uint8_t)clampi(y, 0, 255);
            ycrcb[i * 3 + 1] = (uint8_t)clampi(cr, 0, 255);
            ycrcb[i * 3 + 2] = (uint8_t)clampi(cb, 0, 255);
        }
    });
    return 0;
}

int srcnn_host_ycrcb2bgr_u8(const uint8_t* ycrcb, uint8_t* bgr, int64_t n_px) {
    if (!ycrcb || !bgr || n_px < 0) return -1;
    if (n_px > INT32_MAX) return -2;
    parallel_rows((int)n_px, [&](int b, int e) {
        for (int64_t i = b; i < e; ++i) {
            int32_t y = ycrcb[i * 3 + 0], cr = ycrcb[i * 3 + 1],
                    cb = ycrcb[i * 3 + 2];
            int32_t bb = y + descale14((int64_t)(cb - 128) * 29049);
            int32_t g = y + descale14((int64_t)(cb - 128) * -5636 +
                                      (int64_t)(cr - 128) * -11698);
            int32_t r = y + descale14((int64_t)(cr - 128) * 22987);
            bgr[i * 3 + 0] = (uint8_t)clampi(bb, 0, 255);
            bgr[i * 3 + 1] = (uint8_t)clampi(g, 0, 255);
            bgr[i * 3 + 2] = (uint8_t)clampi(r, 0, 255);
        }
    });
    return 0;
}

int srcnn_host_version(void) { return 10000; }  // 1.0.0

}  // extern "C"
