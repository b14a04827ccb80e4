/*
 * recordio.cc — dmlc-recordio scanning + batch decode/augment assembly.
 *
 * Role parity: reference `src/io/iter_image_recordio_2.cc` (952 LoC
 * ImageRecordIOParser2: N decoder threads over packed .rec chunks) and the
 * dmlc-core recordio reader. Payloads are either JPEG (decoded with
 * libjpeg-turbo, so reference-format ImageRecordIO `.rec` files written by
 * `tools/im2rec.py` are readable) or the raw container. The hot work —
 * record framing, header parse, JPEG decode, shorter-edge resize,
 * crop/mirror/normalize, HWC→CHW transpose — runs GIL-free with OpenMP
 * across the batch.
 *
 * This copy is built by mxnet_tpu_torch/_native.py with g++ into
 * build/native/. JPEG decoding needs libjpeg: it is compiled in only with
 * MXTPU_HAVE_JPEG (_native.py defines it, and links -ljpeg, where
 * <jpeglib.h> compiles); without it a JPEG payload counts as a decode
 * failure and the raw container is the only image format.
 */
#include "mxtpu.h"

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <random>
#include <string>
#include <vector>

#ifdef MXTPU_HAVE_JPEG
#include <jpeglib.h>
#endif

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

thread_local std::string g_error;

void set_error(const std::string &msg) { g_error = msg; }

constexpr uint32_t kMagic = 0xced7230a;
constexpr char kRawMagic[8] = {'M', 'X', 'T', 'P', 'U', 'R', 'A', 'W'};

struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
} __attribute__((packed));

std::vector<uint8_t> read_file(const char *path) {
  std::vector<uint8_t> buf;
  FILE *f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return buf;
  }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(n);
  if (n && std::fread(buf.data(), 1, n, f) != static_cast<size_t>(n)) {
    set_error(std::string("short read on ") + path);
    buf.clear();
  }
  std::fclose(f);
  return buf;
}

int64_t scan_blob(const uint8_t *data, int64_t size, int64_t *offsets,
                  int64_t *lengths, int64_t cap) {
  int64_t pos = 0, n = 0;
  while (pos + 8 <= size) {
    uint32_t magic, lrec;
    std::memcpy(&magic, data + pos, 4);
    std::memcpy(&lrec, data + pos + 4, 4);
    if (magic != kMagic) {
      set_error("bad record magic");
      return -1;
    }
    int64_t len = lrec & 0x1FFFFFFF;
    if (offsets && n < cap) {
      offsets[n] = pos + 8;
      lengths[n] = len;
    }
    ++n;
    pos += 8 + len + ((4 - len % 4) % 4);
  }
  return n;
}

#ifdef MXTPU_HAVE_JPEG
/* ---- JPEG decode (libjpeg-turbo; reference used OpenCV imdecode) ------- */

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr *e = reinterpret_cast<JpegErr *>(cinfo->err);
  longjmp(e->jump, 1);
}

/* Decode a JPEG buffer to RGB uint8 HWC. Returns 0 on success. */
int decode_jpeg(const uint8_t *buf, int64_t len, std::vector<uint8_t> *pixels,
                int *oh, int *ow) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t *>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  /* CMYK/YCCK sources can't be converted to RGB by libjpeg — decode to
   * CMYK and convert below (real ImageNet shards contain a few). */
  bool cmyk = cinfo.jpeg_color_space == JCS_CMYK ||
              cinfo.jpeg_color_space == JCS_YCCK;
  cinfo.out_color_space = cmyk ? JCS_CMYK : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int ih = cinfo.output_height, iw = cinfo.output_width;
  int nc = cinfo.output_components;  /* 3 (RGB) or 4 (CMYK) */
  pixels->resize(static_cast<size_t>(ih) * iw * nc);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels->data() +
                   static_cast<size_t>(cinfo.output_scanline) * iw * nc;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (cmyk) {  /* Adobe inverted-CMYK convention: RGB = C*K/255 etc. */
    std::vector<uint8_t> rgb(static_cast<size_t>(ih) * iw * 3);
    for (int64_t i = 0; i < static_cast<int64_t>(ih) * iw; ++i) {
      const uint8_t *s = pixels->data() + i * 4;
      uint8_t *d = rgb.data() + i * 3;
      int k = s[3];
      d[0] = static_cast<uint8_t>(s[0] * k / 255);
      d[1] = static_cast<uint8_t>(s[1] * k / 255);
      d[2] = static_cast<uint8_t>(s[2] * k / 255);
    }
    pixels->swap(rgb);
  }
  *oh = ih;
  *ow = iw;
  return 0;
}
#else
/* Built without libjpeg's headers: a JPEG record fails to decode (and is
 * zero-filled and counted, as a corrupt one is). */
int decode_jpeg(const uint8_t *, int64_t, std::vector<uint8_t> *, int *,
                int *) {
  return -4;
}
#endif

/* Bilinear resize (half-pixel centers, OpenCV INTER_LINEAR convention —
 * the reference's resize-shorter-edge augmenter, image_aug_default.cc). */
void resize_bilinear(const uint8_t *src, int ih, int iw, int ic,
                     uint8_t *dst, int oh, int ow) {
  float sy = static_cast<float>(ih) / oh, sx = static_cast<float>(iw) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) { y0 = 0; y1 = 0; wy = 0.f; }
    if (y1 >= ih) { y1 = ih - 1; if (y0 >= ih) y0 = ih - 1; }
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) { x0 = 0; x1 = 0; wx = 0.f; }
      if (x1 >= iw) { x1 = iw - 1; if (x0 >= iw) x0 = iw - 1; }
      for (int ch = 0; ch < ic; ++ch) {
        float v =
            (1 - wy) * ((1 - wx) * src[(static_cast<int64_t>(y0) * iw + x0) * ic + ch] +
                        wx * src[(static_cast<int64_t>(y0) * iw + x1) * ic + ch]) +
            wy * ((1 - wx) * src[(static_cast<int64_t>(y1) * iw + x0) * ic + ch] +
                  wx * src[(static_cast<int64_t>(y1) * iw + x1) * ic + ch]);
        dst[(static_cast<int64_t>(y) * ow + x) * ic + ch] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

/* Parse a record's header + payload and produce decoded pixels (HWC u8).
 * Shared front half of the float32 and uint8 emitters below. On success
 * *pp points at the pixels (into `rec` for raw, into *decoded for JPEG/
 * resized) and ih/iw/ic are set. */
int parse_record(const uint8_t *rec, int64_t len, int resize,
                 std::vector<uint8_t> *decoded, const uint8_t **pp,
                 int *ihp, int *iwp, int *icp, float *label) {
  if (len < static_cast<int64_t>(sizeof(IRHeader))) return -2;
  IRHeader hdr;
  std::memcpy(&hdr, rec, sizeof(hdr));
  const uint8_t *p = rec + sizeof(hdr);
  int64_t remain = len - sizeof(hdr);
  if (hdr.flag > 0) {  /* label vector precedes payload */
    if (remain < static_cast<int64_t>(hdr.flag * 4)) return -2;
    std::memcpy(label, p, 4); /* first label value */
    p += hdr.flag * 4;
    remain -= hdr.flag * 4;
  } else {
    *label = hdr.label;
  }
  int ih, iw, ic;
  if (remain >= 9 && std::memcmp(p, kRawMagic, 8) == 0) {
    int ndim = p[8];
    p += 9;
    remain -= 9;
    if (ndim < 2 || ndim > 3 ||
        remain < static_cast<int64_t>(ndim) * 4) return -3;
    int32_t shape[3] = {1, 1, 1};
    std::memcpy(shape, p, ndim * 4);
    p += ndim * 4;
    remain -= ndim * 4;
    ih = shape[0]; iw = shape[1]; ic = ndim == 3 ? shape[2] : 1;
    // plausibility bounds BEFORE the product: three crafted 32-bit dims
    // can overflow int64 (up to 2^93) and wrap past the size check,
    // turning a malicious .rec into an out-of-bounds read
    if (ih <= 0 || iw <= 0 || ic <= 0 ||
        ih > (1 << 20) || iw > (1 << 20) || ic > 4 ||
        remain < static_cast<int64_t>(ih) * iw * ic) return -3;
  } else if (remain >= 2 && p[0] == 0xFF && p[1] == 0xD8) {
    int r = decode_jpeg(p, remain, decoded, &ih, &iw);
    if (r != 0) return r;
    ic = 3;
    p = decoded->data();
  } else {
    return -3;
  }
  if (resize > 0 && std::min(ih, iw) != resize) {
    int nh, nw;
    if (ih < iw) { nh = resize; nw = static_cast<int>(
        static_cast<int64_t>(iw) * resize / ih); }
    else { nw = resize; nh = static_cast<int>(
        static_cast<int64_t>(ih) * resize / iw); }
    std::vector<uint8_t> resized(static_cast<size_t>(nh) * nw * ic);
    resize_bilinear(p, ih, iw, ic, resized.data(), nh, nw);
    decoded->swap(resized);
    p = decoded->data();
    ih = nh; iw = nw;
  }
  *pp = p;
  *ihp = ih;
  *iwp = iw;
  *icp = ic;
  return 0;
}

void pick_crop(int ih, int iw, int h, int w, int aug_flags, std::mt19937 *rng,
               int *y0, int *x0, bool *mirror) {
  *y0 = ih > h ? (ih - h) / 2 : 0;
  *x0 = iw > w ? (iw - w) / 2 : 0;
  *mirror = false;
  if (rng) {
    if ((aug_flags & 2) && ih >= h && iw >= w) {  /* random crop */
      *y0 = (*rng)() % (ih - h + 1);
      *x0 = (*rng)() % (iw - w + 1);
    }
    if (aug_flags & 1) *mirror = ((*rng)() & 1) != 0;
  }
}

/* ---- HLS color jitter (reference image_aug_default.cc:485-509:
 * convert to 8-bit HLS (H in [0,180], L/S in [0,255]), add per-image
 * offsets drawn from a pseudo-gaussian (u1+4*u2)/5 over
 * [-random_x, +random_x], clamp, convert back). Runs on the CROPPED
 * uint8 HWC buffer inside the OpenMP worker, so jitter costs h*w work
 * per image, not full-decode work. */

inline void rgb_to_hls(uint8_t r, uint8_t g, uint8_t b, int *H, int *L,
                       int *S) {
  float rf = r / 255.f, gf = g / 255.f, bf = b / 255.f;
  float vmax = std::max(rf, std::max(gf, bf));
  float vmin = std::min(rf, std::min(gf, bf));
  float l = (vmax + vmin) * 0.5f;
  float h = 0.f, sL = 0.f;
  float d = vmax - vmin;
  if (d > 1e-7f) {
    sL = l < 0.5f ? d / (vmax + vmin) : d / (2.f - vmax - vmin);
    if (vmax == rf)       h = 60.f * (gf - bf) / d;
    else if (vmax == gf)  h = 120.f + 60.f * (bf - rf) / d;
    else                  h = 240.f + 60.f * (rf - gf) / d;
    if (h < 0.f) h += 360.f;
  }
  *H = static_cast<int>(h * 0.5f + 0.5f);        /* [0,180] */
  *L = static_cast<int>(l * 255.f + 0.5f);
  *S = static_cast<int>(sL * 255.f + 0.5f);
}

inline float hue_to_rgb(float p, float q, float t) {
  if (t < 0.f) t += 1.f;
  if (t > 1.f) t -= 1.f;
  if (t < 1.f / 6.f) return p + (q - p) * 6.f * t;
  if (t < 0.5f) return q;
  if (t < 2.f / 3.f) return p + (q - p) * (2.f / 3.f - t) * 6.f;
  return p;
}

inline void hls_to_rgb(int H, int L, int S, uint8_t *r, uint8_t *g,
                       uint8_t *b) {
  float h = H * 2.f / 360.f, l = L / 255.f, sL = S / 255.f;
  float rf, gf, bf;
  if (sL <= 1e-7f) {
    rf = gf = bf = l;
  } else {
    float q = l < 0.5f ? l * (1.f + sL) : l + sL - l * sL;
    float p = 2.f * l - q;
    rf = hue_to_rgb(p, q, h + 1.f / 3.f);
    gf = hue_to_rgb(p, q, h);
    bf = hue_to_rgb(p, q, h - 1.f / 3.f);
  }
  *r = static_cast<uint8_t>(std::max(0.f, std::min(255.f, rf * 255.f + .5f)));
  *g = static_cast<uint8_t>(std::max(0.f, std::min(255.f, gf * 255.f + .5f)));
  *b = static_cast<uint8_t>(std::max(0.f, std::min(255.f, bf * 255.f + .5f)));
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

/* Per-image offsets: the reference's pseudo-gaussian (u1 + 4*u2)/5 mapped
 * to [-rng_x, rng_x] (image_aug_default.cc:490-495). */
inline int hls_offset(std::mt19937 *rng, int range) {
  if (range == 0 || !rng) return 0;
  const float inv = 1.0f / 4294967296.0f;
  float u1 = (*rng)() * inv, u2 = (*rng)() * inv;
  float r = (u1 + 4.f * u2) / 5.f;
  return static_cast<int>(r * range * 2) - range;
}

void apply_hls(uint8_t *hwc, int h, int w, int c, int dh, int ds, int dl) {
  if (c < 3 || (dh == 0 && ds == 0 && dl == 0)) return;
  for (int64_t i = 0; i < static_cast<int64_t>(h) * w; ++i) {
    uint8_t *px = hwc + i * c;
    int H, L, S;
    rgb_to_hls(px[0], px[1], px[2], &H, &L, &S);
    H = clampi(H + dh, 0, 180);
    L = clampi(L + dl, 0, 255);
    S = clampi(S + ds, 0, 255);
    hls_to_rgb(H, L, S, &px[0], &px[1], &px[2]);
  }
}

int decode_one_u8(const uint8_t *rec, int64_t len, int c, int h, int w,
                  int resize, int aug_flags, std::mt19937 *rng,
                  uint8_t *out, float *label,
                  int random_h = 0, int random_s = 0, int random_l = 0);

/* Decode one record into a float32 CHW plane with crop/mirror/normalize. */
int decode_one(const uint8_t *rec, int64_t len, int c, int h, int w,
               int resize, const float *mean, const float *stdv,
               int aug_flags, std::mt19937 *rng, float *out, float *label,
               int random_h = 0, int random_s = 0, int random_l = 0) {
  if (random_h || random_s || random_l) {
    /* HLS jitter operates on the uint8 crop: decode through the u8 path
     * into scratch, then normalize+transpose (reference order: crop ->
     * color-space aug -> normalize, image_aug_default.cc) */
    std::vector<uint8_t> crop(static_cast<size_t>(h) * w * c);
    int r = decode_one_u8(rec, len, c, h, w, resize, aug_flags, rng,
                          crop.data(), label, random_h, random_s,
                          random_l);
    if (r != 0) return r;
    for (int ch = 0; ch < c; ++ch) {
      float m = mean ? mean[ch < 3 ? ch : 2] : 0.f;
      float sdv = stdv ? stdv[ch < 3 ? ch : 2] : 1.f;
      float inv = sdv != 0.f ? 1.f / sdv : 1.f;
      for (int y = 0; y < h; ++y) {
        const uint8_t *srow = crop.data() +
            (static_cast<int64_t>(y) * w) * c + ch;
        float *dst = out + (static_cast<int64_t>(ch) * h + y) * w;
        for (int x = 0; x < w; ++x)
          dst[x] = (static_cast<float>(srow[static_cast<int64_t>(x) * c])
                    - m) * inv;
      }
    }
    return 0;
  }
  std::vector<uint8_t> decoded;
  const uint8_t *p;
  int ih, iw, ic;
  int r = parse_record(rec, len, resize, &decoded, &p, &ih, &iw, &ic, label);
  if (r != 0) return r;
  int y0, x0;
  bool mirror;
  pick_crop(ih, iw, h, w, aug_flags, rng, &y0, &x0, &mirror);
  for (int ch = 0; ch < c; ++ch) {
    int src_c = ic == 1 ? 0 : (ch < ic ? ch : ic - 1);
    float m = mean ? mean[ch < 3 ? ch : 2] : 0.f;
    float s = stdv ? stdv[ch < 3 ? ch : 2] : 1.f;
    float inv = s != 0.f ? 1.f / s : 1.f;
    for (int y = 0; y < h; ++y) {
      int sy = y0 + y;
      if (sy >= ih) sy = ih - 1;
      const uint8_t *row = p + (static_cast<int64_t>(sy) * iw) * ic + src_c;
      float *dst = out + (static_cast<int64_t>(ch) * h + y) * w;
      for (int x = 0; x < w; ++x) {
        int sx = x0 + (mirror ? (w - 1 - x) : x);
        if (sx >= iw) sx = iw - 1;
        dst[x] = (static_cast<float>(row[static_cast<int64_t>(sx) * ic]) - m)
                 * inv;
      }
    }
  }
  return 0;
}

/* Decode one record into a uint8 HWC crop (no normalize — the TPU-native
 * fast path: host ships uint8, normalize/transpose fuse into the jitted
 * step on device where HBM bandwidth is ~100× the host link). */
int decode_one_u8(const uint8_t *rec, int64_t len, int c, int h, int w,
                  int resize, int aug_flags, std::mt19937 *rng,
                  uint8_t *out, float *label,
                  int random_h, int random_s, int random_l) {
  std::vector<uint8_t> decoded;
  const uint8_t *p;
  int ih, iw, ic;
  int r = parse_record(rec, len, resize, &decoded, &p, &ih, &iw, &ic, label);
  if (r != 0) return r;
  int y0, x0;
  bool mirror;
  pick_crop(ih, iw, h, w, aug_flags, rng, &y0, &x0, &mirror);
  bool in_bounds = y0 + h <= ih && x0 + w <= iw;
  for (int y = 0; y < h; ++y) {
    int sy = y0 + y;
    if (sy >= ih) sy = ih - 1;
    const uint8_t *srow = p + static_cast<int64_t>(sy) * iw * ic;
    uint8_t *dst = out + static_cast<int64_t>(y) * w * c;
    if (ic == c && in_bounds && !mirror) {  /* contiguous row copy */
      std::memcpy(dst, srow + static_cast<int64_t>(x0) * ic,
                  static_cast<size_t>(w) * c);
      continue;
    }
    if (ic == c && in_bounds) {  /* mirrored: reversed pixel copy */
      const uint8_t *px = srow + static_cast<int64_t>(x0 + w - 1) * ic;
      for (int x = 0; x < w; ++x, px -= ic)
        for (int ch = 0; ch < c; ++ch) dst[x * c + ch] = px[ch];
      continue;
    }
    for (int x = 0; x < w; ++x) {
      int sx = x0 + (mirror ? (w - 1 - x) : x);
      if (sx >= iw) sx = iw - 1;
      const uint8_t *px = srow + static_cast<int64_t>(sx) * ic;
      for (int ch = 0; ch < c; ++ch)
        dst[x * c + ch] = px[ic == 1 ? 0 : (ch < ic ? ch : ic - 1)];
    }
  }
  if (random_h || random_s || random_l) {
    apply_hls(out, h, w, c, hls_offset(rng, random_h),
              hls_offset(rng, random_s), hls_offset(rng, random_l));
  }
  return 0;
}

}  // namespace

std::atomic<int64_t> g_decode_failures{0};

extern "C" {

const char *mxtpu_last_error(void) { return g_error.c_str(); }

int64_t mxtpu_decode_failures(void) { return g_decode_failures.load(); }

int mxtpu_version(void) { return 100; }

int mxtpu_num_threads(void) {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

int64_t mxtpu_recordio_scan(const char *path, int64_t *offsets,
                            int64_t *lengths, int64_t cap) {
  std::vector<uint8_t> buf = read_file(path);
  if (buf.empty() && !g_error.empty()) return -1;
  return scan_blob(buf.data(), buf.size(), offsets, lengths, cap);
}

int64_t mxtpu_recordio_count(const char *path) {
  return mxtpu_recordio_scan(path, nullptr, nullptr, 0);
}

/* A corrupt record is zero-filled (label -1) and counted rather than
 * failing the batch — the reference parser likewise skips bad images
 * (iter_image_recordio_2.cc). The batch only errors when EVERY record
 * fails (systematically wrong format, e.g. the ImageRecordIter probe). */
int mxtpu_assemble_batch(const uint8_t *blob, const int64_t *offsets,
                         const int64_t *lengths, int n, int c, int h, int w,
                         int resize, const float *mean, const float *std_,
                         int aug_flags, uint64_t seed, float *out_data,
                         float *out_labels) {
  return mxtpu_assemble_batch_aug(blob, offsets, lengths, n, c, h, w,
                                  resize, mean, std_, aug_flags, seed,
                                  0, 0, 0, out_data, out_labels);
}

/* Augmentation-complete variant: random_h/s/l are the reference
 * ImageRecordIter's HLS jitter ranges (image_aug_default.cc). */
int mxtpu_assemble_batch_aug(const uint8_t *blob, const int64_t *offsets,
                             const int64_t *lengths, int n, int c, int h,
                             int w, int resize, const float *mean,
                             const float *std_, int aug_flags,
                             uint64_t seed, int random_h, int random_s,
                             int random_l, float *out_data,
                             float *out_labels) {
  int err = 0, nfail = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) reduction(+:nfail)
#endif
  for (int i = 0; i < n; ++i) {
    std::mt19937 rng(static_cast<uint32_t>(seed + i * 2654435761u));
    bool need_rng = aug_flags || random_h || random_s || random_l;
    int r = decode_one(blob + offsets[i], lengths[i], c, h, w, resize,
                       mean, std_,
                       aug_flags, need_rng ? &rng : nullptr,
                       out_data + static_cast<int64_t>(i) * c * h * w,
                       out_labels + i, random_h, random_s, random_l);
    if (r != 0) {
      // Corrupt record -> zero image, label -1. Deviation from the
      // reference, which CHECK-fails the whole run on an undecodable
      // image (iter_image_recordio_2.cc:577); here training survives bad
      // records. label -1 is the ignore convention: the bundled
      // softmax losses mask label < 0 to zero loss (ops/loss_ops.py),
      // so bad records contribute nothing instead of training
      // 'black image = some class'.
      std::memset(out_data + static_cast<int64_t>(i) * c * h * w, 0,
                  static_cast<size_t>(c) * h * w * sizeof(float));
      out_labels[i] = -1.f;
      ++nfail;
#ifdef _OPENMP
#pragma omp atomic write
#endif
      err = r;
    }
  }
  g_decode_failures += nfail;
  if (nfail == n && n > 0) {
    set_error("record decode failed for every record in the batch");
    return err;
  }
  return 0;
}

int mxtpu_assemble_batch_u8(const uint8_t *blob, const int64_t *offsets,
                            const int64_t *lengths, int n, int c, int h,
                            int w, int resize, int aug_flags, uint64_t seed,
                            uint8_t *out_data, float *out_labels) {
  return mxtpu_assemble_batch_u8_aug(blob, offsets, lengths, n, c, h, w,
                                     resize, aug_flags, seed, 0, 0, 0,
                                     out_data, out_labels);
}

int mxtpu_assemble_batch_u8_aug(const uint8_t *blob, const int64_t *offsets,
                                const int64_t *lengths, int n, int c, int h,
                                int w, int resize, int aug_flags,
                                uint64_t seed, int random_h, int random_s,
                                int random_l, uint8_t *out_data,
                                float *out_labels) {
  int err = 0, nfail = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) reduction(+:nfail)
#endif
  for (int i = 0; i < n; ++i) {
    std::mt19937 rng(static_cast<uint32_t>(seed + i * 2654435761u));
    bool need_rng = aug_flags || random_h || random_s || random_l;
    int r = decode_one_u8(blob + offsets[i], lengths[i], c, h, w, resize,
                          aug_flags, need_rng ? &rng : nullptr,
                          out_data + static_cast<int64_t>(i) * h * w * c,
                          out_labels + i, random_h, random_s, random_l);
    if (r != 0) {
      std::memset(out_data + static_cast<int64_t>(i) * h * w * c, 0,
                  static_cast<size_t>(h) * w * c);
      out_labels[i] = -1.f;
      ++nfail;
#ifdef _OPENMP
#pragma omp atomic write
#endif
      err = r;
    }
  }
  g_decode_failures += nfail;
  if (nfail == n && n > 0) {
    set_error("record decode failed for every record in the batch");
    return err;
  }
  return 0;
}

}  /* extern "C" */
