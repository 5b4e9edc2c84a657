// Native host image pipeline: fused JPEG decode + letterbox.
//
// Role (SURVEY.md §2.N): the reference gets its image input path from
// libjpeg-via-PIL plus a separate resize pass. On this framework's
// streaming path the host CPU is the throughput bound, so decode and
// letterbox are fused natively:
//   * libjpeg(-turbo) decode with DCT-domain prescale (scale_denom in
//     {1,2,4,8} chosen so the decoded image is the smallest size still
//     >= the letterbox target) — decoding a 640x480 JPEG straight to
//     320x240 costs a fraction of full decode;
//   * separable triangle-filter resample (the same adaptive-support
//     "bilinear" PIL uses for downscaling, float accumulation);
//   * gray-pad into the square canvas.
//
// Exposed as a plain C ABI consumed via ctypes (no CPython API — the
// GIL is released for the whole call automatically). Build:
//   g++ -O3 -shared -fPIC imagepipe.cpp -ljpeg -o libimagepipe.so
// (see mydetection_tpu/native/__init__.py, which builds on demand).

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

constexpr uint8_t kPadValue = 114;

struct ErrMgr {
    jpeg_error_mgr pub;
    jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
    ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
    longjmp(err->jump, 1);
}

// Triangle-filter tap table (PIL-style adaptive support).
struct Taps {
    int kmax;
    std::vector<int> starts;
    std::vector<int> counts;
    std::vector<float> weights;  // (out_len, kmax)
};

Taps make_taps(int in_len, int out_len) {
    const double scale = static_cast<double>(in_len) / out_len;
    const double support = scale < 1.0 ? 1.0 : scale;  // adaptive support
    Taps t;
    t.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
    t.starts.resize(out_len);
    t.counts.resize(out_len);
    t.weights.assign(static_cast<size_t>(out_len) * t.kmax, 0.0f);
    for (int xo = 0; xo < out_len; ++xo) {
        const double center = (xo + 0.5) * scale;
        int lo = std::max(static_cast<int>(std::floor(center - support)), 0);
        int hi = std::min(static_cast<int>(std::ceil(center + support)), in_len);
        double total = 0.0;
        float* w = &t.weights[static_cast<size_t>(xo) * t.kmax];
        for (int xi = lo; xi < hi; ++xi) {
            double v = 1.0 - std::abs((xi + 0.5 - center) / support);
            if (v < 0.0) v = 0.0;
            w[xi - lo] = static_cast<float>(v);
            total += v;
        }
        if (total > 0.0)
            for (int k = 0; k < hi - lo; ++k) w[k] /= static_cast<float>(total);
        t.starts[xo] = lo;
        t.counts[xo] = hi - lo;
    }
    return t;
}

// Resize (in_h, in_w, 3) u8 -> (out_h, out_w, 3) u8 via float passes.
// Vertical pass first as whole-row accumulation (contiguous, SIMD-
// friendly), then the horizontal pass touches only out_h rows.
void resize_rgb(const uint8_t* src, int in_h, int in_w, uint8_t* dst,
                int out_h, int out_w) {
    const Taps vt = make_taps(in_h, out_h);
    const Taps ht = make_taps(in_w, out_w);
    const int row_elems = in_w * 3;

    std::vector<float> mid(static_cast<size_t>(out_h) * row_elems);
    for (int yo = 0; yo < out_h; ++yo) {
        float* out_row = &mid[static_cast<size_t>(yo) * row_elems];
        std::memset(out_row, 0, sizeof(float) * row_elems);
        const float* w = &vt.weights[static_cast<size_t>(yo) * vt.kmax];
        const int lo = vt.starts[yo], n = vt.counts[yo];
        for (int k = 0; k < n; ++k) {
            const uint8_t* in_row = src + static_cast<size_t>(lo + k) * row_elems;
            const float wk = w[k];
            for (int i = 0; i < row_elems; ++i)  // auto-vectorizes
                out_row[i] += wk * in_row[i];
        }
    }

    for (int yo = 0; yo < out_h; ++yo) {
        const float* row_in = &mid[static_cast<size_t>(yo) * row_elems];
        uint8_t* row_out = dst + static_cast<size_t>(yo) * out_w * 3;
        for (int xo = 0; xo < out_w; ++xo) {
            const float* w = &ht.weights[static_cast<size_t>(xo) * ht.kmax];
            const int lo = ht.starts[xo], n = ht.counts[xo];
            float r = 0.f, g = 0.f, b = 0.f;
            const float* px = row_in + static_cast<size_t>(lo) * 3;
            for (int k = 0; k < n; ++k) {
                const float wk = w[k];
                r += wk * px[0];
                g += wk * px[1];
                b += wk * px[2];
                px += 3;
            }
            row_out[xo * 3 + 0] = static_cast<uint8_t>(
                r < 0.f ? 0.f : (r > 255.f ? 255.f : r + 0.5f));
            row_out[xo * 3 + 1] = static_cast<uint8_t>(
                g < 0.f ? 0.f : (g > 255.f ? 255.f : g + 0.5f));
            row_out[xo * 3 + 2] = static_cast<uint8_t>(
                b < 0.f ? 0.f : (b > 255.f ? 255.f : b + 0.5f));
        }
    }
}

// Letterbox an RGB buffer into the square canvas; geom = {ratio, pad_x,
// pad_y, ori_w, ori_h}. `ori_w`/`ori_h` are the TRUE pre-prescale image
// dims (a single width-derived ratio reconstructed ori_h wrongly by up
// to denom-1 rows when height % DCT-prescale-denominator != 0, skewing
// the inverse box mapping by several px on tall images).
void letterbox_into(const uint8_t* rgb, int h, int w, double ori_w,
                    double ori_h, int input_size, uint8_t* canvas,
                    float* geom) {
    const double ratio = input_size / std::max(ori_w, ori_h);
    // nearbyint: round-half-even, matching Python round() in image_ops
    int new_w = std::max(1, static_cast<int>(std::nearbyint(ori_w * ratio)));
    int new_h = std::max(1, static_cast<int>(std::nearbyint(ori_h * ratio)));
    const int x0 = (input_size - new_w) / 2;  // floor split (see image_ops)
    const int y0 = (input_size - new_h) / 2;

    std::memset(canvas, kPadValue,
                static_cast<size_t>(input_size) * input_size * 3);
    std::vector<uint8_t> resized(static_cast<size_t>(new_h) * new_w * 3);
    resize_rgb(rgb, h, w, resized.data(), new_h, new_w);
    for (int y = 0; y < new_h; ++y) {
        std::memcpy(canvas + (static_cast<size_t>(y0 + y) * input_size + x0) * 3,
                    resized.data() + static_cast<size_t>(y) * new_w * 3,
                    static_cast<size_t>(new_w) * 3);
    }
    geom[0] = static_cast<float>(ratio);
    geom[1] = static_cast<float>(x0);
    geom[2] = static_cast<float>(y0);
    geom[3] = static_cast<float>(ori_w);
    geom[4] = static_cast<float>(ori_h);
}

}  // namespace

extern "C" {

// Decode a JPEG byte buffer and letterbox to (input_size, input_size, 3).
// Returns 0 on success. geom: {ratio, pad_x, pad_y, ori_w, ori_h}.
int decode_letterbox_jpeg(const uint8_t* data, size_t len, int input_size,
                          uint8_t* canvas, float* geom) {
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    // malloc'd (not std::vector): libjpeg errors longjmp back here,
    // which would skip a vector's destructor (UB + a per-corrupt-image
    // heap leak of w*h*3 bytes in long-running eval/serving). volatile:
    // the pointer is written between setjmp and longjmp.
    uint8_t* volatile rgb = nullptr;
    if (setjmp(jerr.jump)) {
        std::free(rgb);
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    cinfo.out_color_space = JCS_RGB;
    // DCT prescale: largest 1/2^k whose decoded long side is still >=
    // the letterbox target (only ever downscale further afterwards)
    const int ow = cinfo.image_width, oh = cinfo.image_height;
    int denom = 1;
    while (denom < 8 && std::max(ow, oh) / (denom * 2) >= input_size) {
        denom *= 2;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;

    jpeg_start_decompress(&cinfo);
    const int w = cinfo.output_width, h = cinfo.output_height;
    rgb = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(w) * h * 3));
    if (rgb == nullptr) {
        jpeg_destroy_decompress(&cinfo);
        return 3;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = rgb +
                       static_cast<size_t>(cinfo.output_scanline) * w * 3;
        JSAMPROW rows[1] = {row};
        jpeg_read_scanlines(&cinfo, rows, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    letterbox_into(rgb, h, w, static_cast<double>(ow),
                   static_cast<double>(oh), input_size, canvas, geom);
    std::free(rgb);
    return 0;
}

// Letterbox an already-decoded HWC RGB u8 buffer.
int letterbox_rgb(const uint8_t* rgb, int h, int w, int input_size,
                  uint8_t* canvas, float* geom) {
    letterbox_into(rgb, h, w, static_cast<double>(w),
                   static_cast<double>(h), input_size, canvas, geom);
    return 0;
}

}  // extern "C"
