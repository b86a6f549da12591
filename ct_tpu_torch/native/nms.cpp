// Host-side NMS (C++): the port's copy of the JAX package's
// ct_tpu/native/nms.cpp, unchanged in what it computes. Greedy IoU
// suppression with the legacy +1 pixel-area convention of the reference's
// Cython CPU NMS, plus soft-NMS (linear / gaussian / hard) and the
// exact-area bbIoU behind COCO evaluation.
//
// Exposed as a plain C ABI for ctypes; ct_tpu_torch/native/__init__.py
// builds it with g++ on first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Det {
  float x1, y1, x2, y2, score;
};

inline float iou_plus1(const Det& a, const Det& b) {
  const float area_a = (a.x2 - a.x1 + 1.f) * (a.y2 - a.y1 + 1.f);
  const float area_b = (b.x2 - b.x1 + 1.f) * (b.y2 - b.y1 + 1.f);
  const float w = std::max(0.f, std::min(a.x2, b.x2) - std::max(a.x1, b.x1) + 1.f);
  const float h = std::max(0.f, std::min(a.y2, b.y2) - std::max(a.y1, b.y1) + 1.f);
  const float inter = w * h;
  return inter / (area_a + area_b - inter);
}

}  // namespace

extern "C" {

// Greedy NMS over [n, 5] rows (x1,y1,x2,y2,score).
// keep_out must hold n ints; returns the number kept (indices into dets,
// in descending-score order).
int ct_cpu_nms(const float* dets, int n, float thresh, int* keep_out) {
  if (n <= 0) return 0;
  const Det* d = reinterpret_cast<const Det*>(dets);

  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return d[a].score > d[b].score; });

  std::vector<uint8_t> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      if (iou_plus1(d[i], d[j]) > thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

// Soft-NMS. method: 0 = hard (classic), 1 = linear, 2 = gaussian.
// dets is modified in place (scores decay); keep_out gets the indices of
// boxes whose final score exceeds score_thresh, ordered by processing.
int ct_cpu_soft_nms(float* dets, int n, float iou_thresh, float sigma,
                    float score_thresh, int method, int* keep_out) {
  if (n <= 0) return 0;
  Det* d = reinterpret_cast<Det*>(dets);
  std::vector<int> idx(n);
  std::iota(idx.begin(), idx.end(), 0);

  int kept = 0;
  for (int pos = 0; pos < n; ++pos) {
    // move the max-score remaining detection to position `pos`
    int max_at = pos;
    for (int k = pos + 1; k < n; ++k)
      if (d[idx[k]].score > d[idx[max_at]].score) max_at = k;
    std::swap(idx[pos], idx[max_at]);
    const Det& top = d[idx[pos]];
    if (top.score < score_thresh) break;
    keep_out[kept++] = idx[pos];

    for (int k = pos + 1; k < n; ++k) {
      Det& o = d[idx[k]];
      const float ov = iou_plus1(top, o);
      float weight = 1.f;
      if (method == 1) {  // linear
        if (ov > iou_thresh) weight = 1.f - ov;
      } else if (method == 2) {  // gaussian
        weight = std::exp(-(ov * ov) / sigma);
      } else {  // hard
        if (ov > iou_thresh) weight = 0.f;
      }
      o.score *= weight;
    }
  }
  return kept;
}

// Pairwise IoU between [n,4] and [m,4] xyxy boxes, exact-area convention
// (the bbIou backing COCO-style evaluation; crowd columns use
// intersection / det-area, matching pycocotools' iscrowd semantics).
void ct_bb_iou(const float* boxes_a, int n, const float* boxes_b, int m,
               const uint8_t* b_is_crowd, float* out) {
  for (int i = 0; i < n; ++i) {
    const float ax1 = boxes_a[i * 4], ay1 = boxes_a[i * 4 + 1];
    const float ax2 = boxes_a[i * 4 + 2], ay2 = boxes_a[i * 4 + 3];
    const float area_a = (ax2 - ax1) * (ay2 - ay1);
    for (int j = 0; j < m; ++j) {
      const float bx1 = boxes_b[j * 4], by1 = boxes_b[j * 4 + 1];
      const float bx2 = boxes_b[j * 4 + 2], by2 = boxes_b[j * 4 + 3];
      const float area_b = (bx2 - bx1) * (by2 - by1);
      const float w = std::max(0.f, std::min(ax2, bx2) - std::max(ax1, bx1));
      const float h = std::max(0.f, std::min(ay2, by2) - std::max(ay1, by1));
      const float inter = w * h;
      const float uni =
          (b_is_crowd && b_is_crowd[j]) ? area_a : area_a + area_b - inter;
      out[i * m + j] = uni > 0.f ? inter / uni : 0.f;
    }
  }
}

}  // extern "C"
