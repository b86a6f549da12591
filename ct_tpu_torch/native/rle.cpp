// COCO-style run-length-encoded mask operations (C++): the port's copy of
// the JAX package's ct_tpu/native/rle.cpp, unchanged in what it computes.
// The API of the COCO mask library (maskApi.h): rleEncode / rleDecode /
// rleMerge / rleArea / rleIou / rleToBbox / rleFrBbox / rleFrPoly /
// rleToString / rleFrString / bbNms.
//
// RLE convention (standard COCO): masks are column-major (Fortran order)
// h×w binary images; counts alternate runs of 0s and 1s, starting with 0s.
// The string codec is the COCO 5-bit signed-delta varint (+48 ASCII).
//
// C ABI for ctypes. Variable-length outputs use caller-provided buffers
// with explicit capacities; functions return the required/written length.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

uint64_t area_of(const std::vector<uint32_t>& cnts) {
  uint64_t a = 0;
  for (size_t i = 1; i < cnts.size(); i += 2) a += cnts[i];
  return a;
}

// Merge two RLE streams over the same h*w domain with AND or OR.
std::vector<uint32_t> merge2(const std::vector<uint32_t>& a,
                             const std::vector<uint32_t>& b,
                             uint64_t total, bool intersect) {
  std::vector<uint32_t> out;
  size_t ia = 0, ib = 0;
  uint64_t ca = ia < a.size() ? a[ia] : total;
  uint64_t cb = ib < b.size() ? b[ib] : total;
  bool va = false, vb = false;
  uint64_t done = 0;
  bool first = true, vp = false;
  while (done < total) {
    // skip zero-length runs
    while (ca == 0 && ia + 1 < a.size()) { ++ia; ca = a[ia]; va = !va; }
    while (cb == 0 && ib + 1 < b.size()) { ++ib; cb = b[ib]; vb = !vb; }
    const uint64_t c = std::min(std::min(ca, cb), total - done);
    const bool v = intersect ? (va && vb) : (va || vb);
    if (first) {
      if (v) out.push_back(0);
      out.push_back(uint32_t(c));
      vp = v;
      first = false;
    } else if (v == vp) {
      out.back() += uint32_t(c);
    } else {
      out.push_back(uint32_t(c));
      vp = v;
    }
    done += c;
    ca -= c;
    cb -= c;
    if (ca == 0 && ia + 1 < a.size()) { ++ia; ca = a[ia]; va = !va; }
    if (cb == 0 && ib + 1 < b.size()) { ++ib; cb = b[ib]; vb = !vb; }
  }
  return out;
}

int encode_mask(const uint8_t* mask, uint64_t n, uint32_t* out, int cap) {
  int m = 0;
  uint64_t i = 0;
  uint8_t v = 0;
  while (i < n) {
    uint64_t run = 0;
    while (i < n && (mask[i] != 0) == (v != 0)) { ++run; ++i; }
    if (m < cap) out[m] = uint32_t(run);
    ++m;
    v = !v;
  }
  if (m == 0) {  // empty domain
    if (cap > 0) out[0] = 0;
    m = 1;
  }
  return m;
}

}  // namespace

extern "C" {

// ---- encode / decode / area ---------------------------------------------

// mask: h*w column-major uint8 → runs. Returns run count (call again with
// a larger buffer if the result exceeds cap).
int ct_rle_encode(const uint8_t* mask, int h, int w, uint32_t* cnts_out,
                  int cap) {
  return encode_mask(mask, uint64_t(h) * w, cnts_out, cap);
}

void ct_rle_decode(const uint32_t* cnts, int m, int h, int w,
                   uint8_t* mask_out) {
  uint64_t pos = 0;
  uint8_t v = 0;
  const uint64_t n = uint64_t(h) * w;
  for (int i = 0; i < m; ++i) {
    for (uint32_t k = 0; k < cnts[i] && pos < n; ++k) mask_out[pos++] = v;
    v = !v;
  }
  while (pos < n) mask_out[pos++] = 0;
}

uint64_t ct_rle_area(const uint32_t* cnts, int m) {
  uint64_t a = 0;
  for (int i = 1; i < m; i += 2) a += cnts[i];
  return a;
}

// ---- merge / IoU ---------------------------------------------------------

int ct_rle_merge(const uint32_t* cnts_a, int ma, const uint32_t* cnts_b,
                 int mb, int h, int w, int intersect, uint32_t* out,
                 int cap) {
  std::vector<uint32_t> a(cnts_a, cnts_a + ma), b(cnts_b, cnts_b + mb);
  auto r = merge2(a, b, uint64_t(h) * w, intersect != 0);
  if (int(r.size()) <= cap) std::copy(r.begin(), r.end(), out);
  return int(r.size());
}

// IoU of two RLE masks; iscrowd → intersection / area(a).
double ct_rle_iou(const uint32_t* cnts_a, int ma, const uint32_t* cnts_b,
                  int mb, int h, int w, int iscrowd) {
  std::vector<uint32_t> a(cnts_a, cnts_a + ma), b(cnts_b, cnts_b + mb);
  const double inter =
      double(area_of(merge2(a, b, uint64_t(h) * w, true)));
  const double aa = double(area_of(a)), ab = double(area_of(b));
  const double uni = iscrowd ? aa : aa + ab - inter;
  return uni > 0 ? inter / uni : 0.0;
}

// ---- bbox / polygon conversions -----------------------------------------

void ct_rle_to_bbox(const uint32_t* cnts, int m, int h, int w, double* bb) {
  uint32_t xs = uint32_t(w), xe = 0, ys = uint32_t(h), ye = 0;
  uint64_t pos = 0;
  bool v = false, any = false;
  for (int i = 0; i < m; ++i) {
    const uint32_t c = cnts[i];
    if (v && c > 0) {
      any = true;
      const uint64_t start = pos, end = pos + c - 1;
      const uint32_t x0 = uint32_t(start / h), x1 = uint32_t(end / h);
      xs = std::min(xs, x0);
      xe = std::max(xe, x1);
      if (x0 == x1) {
        ys = std::min(ys, uint32_t(start % h));
        ye = std::max(ye, uint32_t(end % h));
      } else {
        ys = 0;
        ye = uint32_t(h) - 1;
      }
    }
    pos += c;
    v = !v;
  }
  if (!any) { bb[0] = bb[1] = bb[2] = bb[3] = 0; return; }
  bb[0] = xs; bb[1] = ys; bb[2] = xe - xs + 1; bb[3] = ye - ys + 1;
}

// [x,y,w,h] → RLE of the filled axis-aligned box.
int ct_rle_from_bbox(const double* bb, int h, int w, uint32_t* out,
                     int cap) {
  const int xs = std::max(0, int(std::round(bb[0])));
  const int ys = std::max(0, int(std::round(bb[1])));
  const int xe = std::min(w, xs + int(std::round(bb[2])));
  const int ye = std::min(h, ys + int(std::round(bb[3])));
  std::vector<uint8_t> mask(size_t(h) * w, 0);
  for (int x = xs; x < xe; ++x)
    for (int y = ys; y < ye; ++y) mask[size_t(x) * h + y] = 1;
  return encode_mask(mask.data(), uint64_t(h) * w, out, cap);
}

// Polygon (k xy pairs, image coords) → RLE via per-column even-odd fill.
int ct_rle_from_poly(const double* xy, int k, int h, int w, uint32_t* out,
                     int cap) {
  std::vector<uint8_t> mask(size_t(h) * w, 0);
  std::vector<double> ys;
  for (int x = 0; x < w; ++x) {
    const double cx = x + 0.5;
    ys.clear();
    for (int i = 0; i < k; ++i) {
      const double x0 = xy[2 * i], y0 = xy[2 * i + 1];
      const double x1 = xy[2 * ((i + 1) % k)];
      const double y1 = xy[2 * ((i + 1) % k) + 1];
      if ((x0 <= cx && x1 > cx) || (x1 <= cx && x0 > cx))
        ys.push_back(y0 + (cx - x0) / (x1 - x0) * (y1 - y0));
    }
    std::sort(ys.begin(), ys.end());
    for (size_t i = 0; i + 1 < ys.size(); i += 2) {
      const int y_lo = std::max(0, int(std::ceil(ys[i] - 0.5)));
      const int y_hi = std::min(h - 1, int(std::floor(ys[i + 1] - 0.5)));
      for (int y = y_lo; y <= y_hi; ++y) mask[size_t(x) * h + y] = 1;
    }
  }
  return encode_mask(mask.data(), uint64_t(h) * w, out, cap);
}

// ---- string codec (COCO compressed RLE) ----------------------------------

int ct_rle_to_string(const uint32_t* cnts, int m, char* out, int cap) {
  std::string s;
  for (int i = 0; i < m; ++i) {
    int64_t x = int64_t(cnts[i]);
    if (i > 2) x -= int64_t(cnts[i - 2]);
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? x != -1 : x != 0;
      if (more) c |= 0x20;
      s.push_back(char(c + 48));
    }
  }
  if (int(s.size()) <= cap) std::memcpy(out, s.data(), s.size());
  return int(s.size());
}

int ct_rle_from_string(const char* str, int len, uint32_t* out, int cap) {
  std::vector<uint32_t> cnts;
  int i = 0;
  while (i < len) {
    int64_t x = 0;
    int shift = 0;
    bool more = true;
    while (more && i < len) {
      const int64_t c = int64_t(str[i]) - 48;
      x |= (c & 0x1f) << shift;
      more = (c & 0x20) != 0;
      ++i;
      shift += 5;
      if (!more && (c & 0x10)) x |= int64_t(-1) << shift;
    }
    if (cnts.size() > 2) x += int64_t(cnts[cnts.size() - 2]);
    cnts.push_back(uint32_t(x));
  }
  if (int(cnts.size()) <= cap) std::copy(cnts.begin(), cnts.end(), out);
  return int(cnts.size());
}

// ---- bbox NMS over xywh (maskApi bbNms semantics, no +1) ----------------

void ct_bb_nms(const double* bbs, int n, double thresh, uint8_t* keep_out) {
  for (int i = 0; i < n; ++i) keep_out[i] = 1;
  for (int i = 0; i < n; ++i) {
    if (!keep_out[i]) continue;
    for (int j = i + 1; j < n; ++j) {
      if (!keep_out[j]) continue;
      const double ax = bbs[i * 4], ay = bbs[i * 4 + 1];
      const double aw = bbs[i * 4 + 2], ah = bbs[i * 4 + 3];
      const double bx = bbs[j * 4], by = bbs[j * 4 + 1];
      const double bw = bbs[j * 4 + 2], bh = bbs[j * 4 + 3];
      const double iw =
          std::max(0.0, std::min(ax + aw, bx + bw) - std::max(ax, bx));
      const double ih =
          std::max(0.0, std::min(ay + ah, by + bh) - std::max(ay, by));
      const double inter = iw * ih;
      const double uni = aw * ah + bw * bh - inter;
      if (uni > 0 && inter / uni > thresh) keep_out[j] = 0;
    }
  }
}

}  // extern "C"
