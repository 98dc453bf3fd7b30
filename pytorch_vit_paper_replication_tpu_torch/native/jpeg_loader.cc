// Native JPEG decode + resize for the input pipeline.
//
// The reference feeds its models from torchvision's PIL loaders
// (going_modular/data_setup.py:43-44); this framework's equivalent hot path
// (data/image_folder.py, data/imagenet.py pack ingest) is JPEG-decode bound
// on small hosts. This module is the native fast path:
//
//   * libjpeg(-turbo) DCT-domain scaled decode (scale_num/8): a 1024px JPEG
//     headed for 224px is decoded at 1/4 scale, skipping ~94% of the IDCT
//     and color-conversion work before any resize happens.
//   * fused resize+crop: bilinear sampling straight from the decoded buffer
//     into the target frame, never materializing the intermediate resized
//     image (and never touching pixels a center-crop would discard).
//
// Exposed as a C ABI for ctypes (see native/__init__.py, which compiles
// this file on demand with g++ and falls back to PIL when unavailable).
//
// Modes mirror the two deterministic pipelines in data/transforms.py:
//   mode 0 "squash":        Resize((T,T))                         -> [T,T,3]
//   mode 1 "shorter_crop":  ResizeShorter(R)+CenterCrop(T), T<=R  -> [T,T,3]

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void silence_output(j_common_ptr) {}

// Bilinear-resample a box [top,left,crop_h,crop_w] of a uint8 RGB frame
// into a target x target output. Affine follows PIL:
// src = box_origin + (dst + 0.5) * (box / target) - 0.5.
// Sampling coordinates clamp to [clamp_lo, clamp_hi] per axis — the full
// frame for decode's resize-then-crop semantics (edge pixels legitimately
// blend neighbors outside the crop window), the box itself for
// crop-then-resize semantics (PIL's crop().resize() sees nothing outside
// the box).
void resample_box(const uint8_t* in, int in_h, int in_w, double top,
                  double left, double crop_h, double crop_w, int target,
                  int clamp_x0, int clamp_x1, int clamp_y0, int clamp_y1,
                  uint8_t* out) {
  const double sx = crop_w / target;
  const double sy = crop_h / target;
  std::vector<int> xi0(target), xi1(target);
  std::vector<float> xf(target);
  for (int x = 0; x < target; ++x) {
    double fx = left + (x + 0.5) * sx - 0.5;
    if (fx < clamp_x0) fx = clamp_x0;
    if (fx > clamp_x1) fx = clamp_x1;
    const int x0 = static_cast<int>(fx);
    const int x1 = x0 + 1 < clamp_x1 + 1 ? x0 + 1 : clamp_x1;
    xi0[x] = x0 * 3;
    xi1[x] = x1 * 3;
    xf[x] = static_cast<float>(fx - x0);
  }
  for (int y = 0; y < target; ++y) {
    double fy = top + (y + 0.5) * sy - 0.5;
    if (fy < clamp_y0) fy = clamp_y0;
    if (fy > clamp_y1) fy = clamp_y1;
    const int y0 = static_cast<int>(fy);
    const int y1 = y0 + 1 < clamp_y1 + 1 ? y0 + 1 : clamp_y1;
    const float wy = static_cast<float>(fy - y0);
    const uint8_t* r0 = in + static_cast<size_t>(y0) * in_w * 3;
    const uint8_t* r1 = in + static_cast<size_t>(y1) * in_w * 3;
    uint8_t* dst = out + static_cast<size_t>(y) * target * 3;
    for (int x = 0; x < target; ++x) {
      const uint8_t* a = r0 + xi0[x];
      const uint8_t* b = r0 + xi1[x];
      const uint8_t* c = r1 + xi0[x];
      const uint8_t* d = r1 + xi1[x];
      const float fx = xf[x];
      for (int ch = 0; ch < 3; ++ch) {
        const float tp = a[ch] + (b[ch] - a[ch]) * fx;
        const float bt = c[ch] + (d[ch] - c[ch]) * fx;
        dst[x * 3 + ch] =
            static_cast<uint8_t>(tp + (bt - tp) * wy + 0.5f);
      }
    }
  }
}

// Float-output variant of resample_box for the training-augmentation hot
// path: bilinear sample, round to the uint8 grid (bit-parity with the
// uint8 path followed by a separate conversion), then apply the fused
// per-channel affine out = v * scale[ch] + offset[ch] ((v/255 - mean)/std
// with the constants folded), optionally mirroring x (horizontal flip).
// One pass replaces crop+resize, flip, and the float/normalize conversion
// that dominated the augmented pipeline's host time.
void resample_box_f32(const uint8_t* in, int in_h, int in_w, double top,
                      double left, double crop_h, double crop_w, int target,
                      int clamp_x0, int clamp_x1, int clamp_y0, int clamp_y1,
                      int hflip, const float* scale, const float* offset,
                      float* out) {
  const double sx = crop_w / target;
  const double sy = crop_h / target;
  std::vector<int> xi0(target), xi1(target);
  std::vector<float> xf(target);
  for (int x = 0; x < target; ++x) {
    // For a flipped output, destination x samples the mirrored source
    // column — identical pixels to flipping the resized crop afterwards.
    const int sxi = hflip ? target - 1 - x : x;
    double fx = left + (sxi + 0.5) * sx - 0.5;
    if (fx < clamp_x0) fx = clamp_x0;
    if (fx > clamp_x1) fx = clamp_x1;
    const int x0 = static_cast<int>(fx);
    const int x1 = x0 + 1 < clamp_x1 + 1 ? x0 + 1 : clamp_x1;
    xi0[x] = x0 * 3;
    xi1[x] = x1 * 3;
    xf[x] = static_cast<float>(fx - x0);
  }
  for (int y = 0; y < target; ++y) {
    double fy = top + (y + 0.5) * sy - 0.5;
    if (fy < clamp_y0) fy = clamp_y0;
    if (fy > clamp_y1) fy = clamp_y1;
    const int y0 = static_cast<int>(fy);
    const int y1 = y0 + 1 < clamp_y1 + 1 ? y0 + 1 : clamp_y1;
    const float wy = static_cast<float>(fy - y0);
    const uint8_t* r0 = in + static_cast<size_t>(y0) * in_w * 3;
    const uint8_t* r1 = in + static_cast<size_t>(y1) * in_w * 3;
    float* dst = out + static_cast<size_t>(y) * target * 3;
    for (int x = 0; x < target; ++x) {
      const uint8_t* a = r0 + xi0[x];
      const uint8_t* b = r0 + xi1[x];
      const uint8_t* c = r1 + xi0[x];
      const uint8_t* d = r1 + xi1[x];
      const float fx = xf[x];
      for (int ch = 0; ch < 3; ++ch) {
        const float tp = a[ch] + (b[ch] - a[ch]) * fx;
        const float bt = c[ch] + (d[ch] - c[ch]) * fx;
        const float v = static_cast<float>(
            static_cast<uint8_t>(tp + (bt - tp) * wy + 0.5f));
        dst[x * 3 + ch] = v * scale[ch] + offset[ch];
      }
    }
  }
}

}  // namespace

extern "C" {

// Resize the [top:top+crop_h, left:left+crop_w] box of a uint8 RGB HWC
// frame to target x target (RandomResizedCrop's crop+resize in one pass,
// no PIL round-trip). Returns 0 on success.
int psr_resize_crop(const uint8_t* in, int in_h, int in_w, int top,
                    int left, int crop_h, int crop_w, int target,
                    uint8_t* out) {
  if (in == nullptr || out == nullptr || target <= 0 || crop_h <= 0 ||
      crop_w <= 0 || top < 0 || left < 0 || top + crop_h > in_h ||
      left + crop_w > in_w) {
    return 1;
  }
  resample_box(in, in_h, in_w, top, left, crop_h, crop_w, target,
               left, left + crop_w - 1, top, top + crop_h - 1, out);
  return 0;
}

// Decode `data` (a complete JPEG stream) into `out` (target*target*3 bytes,
// RGB, row-major). mode 0 = squash to target x target (resize ignored);
// mode 1 = resize shorter side to `resize`, center-crop target (<= resize).
// Returns 0 on success, nonzero on any decode error (caller falls back).
int psr_decode_jpeg(const uint8_t* data, size_t len, int resize, int target,
                    int mode, uint8_t* out) {
  if (target <= 0 || data == nullptr || len < 4 || out == nullptr ||
      (mode != 0 && mode != 1) || (mode == 1 && resize < target)) {
    return 1;
  }

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silence_output;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  cinfo.out_color_space = JCS_RGB;

  // Pick the smallest DCT scale M/8 whose decoded frame still covers the
  // target (per the mode's constraint), so the IDCT does the bulk of any
  // large downscale for free.
  const int in_w = static_cast<int>(cinfo.image_width);
  const int in_h = static_cast<int>(cinfo.image_height);
  int m = 8;
  for (int cand = 1; cand <= 8; ++cand) {
    const int w = (in_w * cand + 7) / 8;
    const int h = (in_h * cand + 7) / 8;
    const bool covers =
        mode == 0 ? (w >= target && h >= target)
                  : ((w < h ? w : h) >= resize);
    if (covers) {
      m = cand;
      break;
    }
  }
  cinfo.scale_num = static_cast<unsigned int>(m);
  cinfo.scale_denom = 8;

  jpeg_start_decompress(&cinfo);
  const int dw = static_cast<int>(cinfo.output_width);
  const int dh = static_cast<int>(cinfo.output_height);
  const int comps = static_cast<int>(cinfo.output_components);
  if (comps != 3) {  // JCS_RGB guarantees 3; be defensive.
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 4;
  }
  // Decode buffer from libjpeg's own JPOOL_IMAGE pool: a mid-decode
  // error longjmps past any C++ destructor, but the pool is released by
  // jpeg_destroy_decompress on every path, so nothing leaks.
  uint8_t* decoded = static_cast<uint8_t*>((*cinfo.mem->alloc_large)(
      reinterpret_cast<j_common_ptr>(&cinfo), JPOOL_IMAGE,
      static_cast<size_t>(dw) * dh * 3));
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = decoded + static_cast<size_t>(cinfo.output_scanline) *
                                 dw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  // The resample below reads `decoded`, whose pool dies with the
  // decompress object — copy nothing; destroy only after sampling.

  // Fused resize(+crop): map every target pixel straight into the decoded
  // frame. Affine follows PIL: src = (dst + 0.5) * (in/out) - 0.5, with the
  // center-crop offset folded into dst for mode 1.
  double sx, sy, ox = 0.0, oy = 0.0;
  if (mode == 0) {
    sx = static_cast<double>(dw) / target;
    sy = static_cast<double>(dh) / target;
  } else {
    const int shorter = dw < dh ? dw : dh;
    // PIL ResizeShorter rounds the resized long side; reproduce that so
    // crop offsets match the PIL pipeline.
    const double scale = static_cast<double>(shorter) / resize;
    const int rw = dw <= dh ? resize
                            : static_cast<int>(dw / scale + 0.5);
    const int rh = dw <= dh ? static_cast<int>(dh / scale + 0.5)
                            : resize;
    sx = static_cast<double>(dw) / rw;
    sy = static_cast<double>(dh) / rh;
    ox = (rw - target) / 2;
    oy = (rh - target) / 2;
  }
  if (sx == 1.0 && sy == 1.0) {
    // Identity shortcut: decoded frame already matches the output grid
    // (common when sources are pre-sized) — copy the crop window directly.
    const int iox = static_cast<int>(ox), ioy = static_cast<int>(oy);
    for (int y = 0; y < target; ++y) {
      std::memcpy(out + static_cast<size_t>(y) * target * 3,
                  decoded +
                      (static_cast<size_t>(y + ioy) * dw + iox) * 3,
                  static_cast<size_t>(target) * 3);
    }
  } else {
    // No libjpeg call can longjmp from inside resample_box, so its C++
    // containers are safe. The crop box is the affine image of the
    // target grid: origin (oy*sy, ox*sx), extent (target*sy, target*sx).
    resample_box(decoded, dh, dw, oy * sy, ox * sx, target * sy,
                 target * sx, target, 0, dw - 1, 0, dh - 1, out);
  }

  // The decode pool (and `decoded` with it) dies here, after sampling.
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Fused RandomResizedCrop + horizontal flip + float32 normalize: resample
// the [top:top+crop_h, left:left+crop_w] box to target x target, mirror x
// when hflip, and write out[px] = round_u8(bilinear) * scale[ch] +
// offset[ch]. Bit-identical to psr_resize_crop followed by flip + per-
// channel affine, in one pass. Returns 0 on success.
int psr_resize_crop_f32(const uint8_t* in, int in_h, int in_w, int top,
                        int left, int crop_h, int crop_w, int target,
                        int hflip, const float* scale, const float* offset,
                        float* out) {
  if (in == nullptr || out == nullptr || scale == nullptr ||
      offset == nullptr || target <= 0 || crop_h <= 0 || crop_w <= 0 ||
      top < 0 || left < 0 || top + crop_h > in_h || left + crop_w > in_w) {
    return 1;
  }
  resample_box_f32(in, in_h, in_w, top, left, crop_h, crop_w, target,
                   left, left + crop_w - 1, top, top + crop_h - 1,
                   hflip ? 1 : 0, scale, offset, out);
  return 0;
}

// Plain uint8 HWC -> float32 per-channel affine (the ToFloatArray
// conversion the eval path runs): out[px] = in[px] * scale[ch] +
// offset[ch] over n_px RGB pixels. Returns 0 on success.
int psr_u8_to_f32(const uint8_t* in, size_t n_px, const float* scale,
                  const float* offset, float* out) {
  if (in == nullptr || out == nullptr || scale == nullptr ||
      offset == nullptr) {
    return 1;
  }
  const float s0 = scale[0], s1 = scale[1], s2 = scale[2];
  const float o0 = offset[0], o1 = offset[1], o2 = offset[2];
  for (size_t i = 0; i < n_px; ++i) {
    out[i * 3] = in[i * 3] * s0 + o0;
    out[i * 3 + 1] = in[i * 3 + 1] * s1 + o1;
    out[i * 3 + 2] = in[i * 3 + 2] * s2 + o2;
  }
  return 0;
}

// Probe symbol so the Python side can sanity-check the loaded library.
// v2: + psr_resize_crop. v3: + psr_resize_crop_f32, psr_u8_to_f32.
int psr_abi_version(void) { return 3; }

}  // extern "C"
