// Native evaluation core: pairwise IoU + COCO greedy matching.
//
// The torch port's own copy of the JAX package's host-side evaluator core,
// the analog of the reference's compiled evaluator backend (pycocotools
// `_mask.pyx`/`maskApi.c`, which detectron2's COCOeval and the embodied
// eval path sit on -- ref: Detic/train_mp3d.py:423 evaluator
// construction). Host-side C++ -- the device never touches evaluation;
// this removes the Python interpreter from the per-(image, category,
// threshold) matching loops, which dominate evaluation wall-time on long
// episode streams.
//
// Build: g++ -O3 -shared -fPIC (driven by native/build.py). Pure C ABI so
// ctypes can bind without pybind11.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Pairwise IoU of xywh boxes (pycocotools maskUtils.iou semantics,
// iscrowd=0): out[d*ng + g].
void iou_xywh(const double* dets, int64_t nd, const double* gts, int64_t ng,
              double* out) {
  for (int64_t d = 0; d < nd; ++d) {
    const double dx1 = dets[d * 4 + 0], dy1 = dets[d * 4 + 1];
    const double dw = dets[d * 4 + 2], dh = dets[d * 4 + 3];
    const double dx2 = dx1 + dw, dy2 = dy1 + dh;
    const double da = dw * dh;
    for (int64_t g = 0; g < ng; ++g) {
      const double gx1 = gts[g * 4 + 0], gy1 = gts[g * 4 + 1];
      const double gw = gts[g * 4 + 2], gh = gts[g * 4 + 3];
      const double ix = std::max(
          0.0, std::min(dx2, gx1 + gw) - std::max(dx1, gx1));
      const double iy = std::max(
          0.0, std::min(dy2, gy1 + gh) - std::max(dy1, gy1));
      const double inter = ix * iy;
      const double uni = da + gw * gh - inter;
      out[d * ng + g] = uni > 0 ? inter / uni : 0.0;
    }
  }
}

// COCOeval.evaluateImg greedy matching for all thresholds at once.
//
// ious:     [nd, ng] row-major (detections already score-sorted, gts
//           already ignore-sorted: non-ignored first)
// g_ignore: [ng] 0/1
// thrs:     [nt] IoU thresholds
// outputs:  dt_m [nt, nd] matched gt index + 1 (0 = unmatched)
//           gt_m [nt, ng] matched det index + 1
//           dt_ig [nt, nd] 0/1 ignore flag for matched-to-ignored dets
void greedy_match(const double* ious, int64_t nd, int64_t ng,
                  const uint8_t* g_ignore, const double* thrs, int64_t nt,
                  int64_t* dt_m, int64_t* gt_m, uint8_t* dt_ig) {
  std::memset(dt_m, 0, sizeof(int64_t) * nt * nd);
  std::memset(gt_m, 0, sizeof(int64_t) * nt * ng);
  std::memset(dt_ig, 0, sizeof(uint8_t) * nt * nd);
  for (int64_t t = 0; t < nt; ++t) {
    int64_t* gtm = gt_m + t * ng;
    int64_t* dtm = dt_m + t * nd;
    uint8_t* dtig = dt_ig + t * nd;
    for (int64_t d = 0; d < nd; ++d) {
      double best_iou = std::min(thrs[t], 1.0 - 1e-10);
      int64_t best_g = -1;
      const double* row = ious + d * ng;
      for (int64_t g = 0; g < ng; ++g) {
        if (gtm[g] > 0) continue;
        // once matched to a real gt, stop at the first ignored gt
        // (gts are sorted non-ignored first)
        if (best_g > -1 && !g_ignore[best_g] && g_ignore[g]) break;
        if (row[g] < best_iou) continue;
        best_iou = row[g];
        best_g = g;
      }
      if (best_g == -1) continue;
      dtig[d] = g_ignore[best_g];
      dtm[d] = best_g + 1;
      gtm[best_g] = d + 1;
    }
  }
}

// Whole-category evaluation: per-image det sort + cap, gt area-ignore +
// reorder, IoU, greedy match, out-of-range unmatched-det ignore — the
// full COCOeval.evaluateImg loop over all images in ONE call, so ctypes
// overhead is per-category, not per-(image,category).
//
// Inputs are concatenated over images with prefix offsets:
//   g_boxes [NG*4] xywh, g_areas [NG], g_ids [NG] global annotation ids,
//   g_off [n_imgs+1]; d_boxes [ND*4] xywh, d_scores [ND], d_off [n_imgs+1]
// Outputs (capped at max_dets per image, concatenated in image order):
//   out_scores [<=ND], out_dtm/out_dtig [nt, <=ND] (row stride = the
//   caller-computed capped total `nd_cap`), out_ngt = #non-ignored gts.
// out_dtm stores the matched gt's GLOBAL annotation id (pycocotools
// evaluateImg stores gt['id']); 0 doubles as "unmatched", so when ids
// start at 0 (the reference protocol, train_mp3d.py:149) the detection
// matched to annotation 0 accumulates as a false positive — the
// pycocotools quirk, reproduced deliberately for golden-number parity.
// Returns the number of detections written (== nd_cap).
int64_t evaluate_category(
    const double* g_boxes, const double* g_areas, const int64_t* g_ids,
    const int64_t* g_off,
    const double* d_boxes, const double* d_scores, const int64_t* d_off,
    int64_t n_imgs, const double* thrs, int64_t nt,
    double area_lo, double area_hi, int64_t max_dets, int64_t nd_cap,
    double* out_scores, int64_t* out_dtm, uint8_t* out_dtig,
    int64_t* out_ngt) {
  std::memset(out_dtm, 0, sizeof(int64_t) * nt * nd_cap);
  std::memset(out_dtig, 0, sizeof(uint8_t) * nt * nd_cap);
  int64_t ngt_total = 0;
  int64_t written = 0;
  // scratch buffers sized to the largest image
  int64_t max_ng = 0, max_nd = 0;
  for (int64_t i = 0; i < n_imgs; ++i) {
    max_ng = std::max(max_ng, g_off[i + 1] - g_off[i]);
    max_nd = std::max(max_nd, d_off[i + 1] - d_off[i]);
  }
  int64_t* gt_order = new int64_t[max_ng];
  uint8_t* g_ig = new uint8_t[max_ng];
  int64_t* dt_order = new int64_t[max_nd];
  double* ious = new double[std::max<int64_t>(1, max_ng) *
                            std::max<int64_t>(1, std::min(max_nd, max_dets))];
  int64_t* gtm = new int64_t[max_ng];

  for (int64_t img = 0; img < n_imgs; ++img) {
    const int64_t g0 = g_off[img], ng = g_off[img + 1] - g0;
    const int64_t d0 = d_off[img], nd_all = d_off[img + 1] - d0;
    const int64_t nd = std::min(nd_all, max_dets);
    if (ng == 0 && nd == 0) continue;

    // det order: score-descending, stable
    for (int64_t d = 0; d < nd_all; ++d) dt_order[d] = d;
    std::stable_sort(dt_order, dt_order + nd_all,
                     [&](int64_t a, int64_t b) {
                       return d_scores[d0 + a] > d_scores[d0 + b];
                     });

    // gt ignore by area; order: non-ignored first, stable
    for (int64_t g = 0; g < ng; ++g)
      g_ig[g] = (g_areas[g0 + g] < area_lo || g_areas[g0 + g] > area_hi);
    for (int64_t g = 0; g < ng; ++g) gt_order[g] = g;
    std::stable_sort(gt_order, gt_order + ng,
                     [&](int64_t a, int64_t b) {
                       return g_ig[a] < g_ig[b];
                     });

    // IoU [nd, ng] in sorted orders
    for (int64_t d = 0; d < nd; ++d) {
      const double* db = d_boxes + (d0 + dt_order[d]) * 4;
      const double dx1 = db[0], dy1 = db[1];
      const double dx2 = db[0] + db[2], dy2 = db[1] + db[3];
      const double da = db[2] * db[3];
      for (int64_t g = 0; g < ng; ++g) {
        const double* gb = g_boxes + (g0 + gt_order[g]) * 4;
        const double ix = std::max(
            0.0, std::min(dx2, gb[0] + gb[2]) - std::max(dx1, gb[0]));
        const double iy = std::max(
            0.0, std::min(dy2, gb[1] + gb[3]) - std::max(dy1, gb[1]));
        const double inter = ix * iy;
        const double uni = da + gb[2] * gb[3] - inter;
        ious[d * ng + g] = uni > 0 ? inter / uni : 0.0;
      }
    }

    for (int64_t t = 0; t < nt; ++t) {
      for (int64_t g = 0; g < ng; ++g) gtm[g] = 0;
      int64_t* dtm_row = out_dtm + t * nd_cap + written;
      uint8_t* dtig_row = out_dtig + t * nd_cap + written;
      for (int64_t d = 0; d < nd; ++d) {
        double best_iou = std::min(thrs[t], 1.0 - 1e-10);
        int64_t best_g = -1;
        const double* row = ious + d * ng;
        for (int64_t g = 0; g < ng; ++g) {
          if (gtm[g] > 0) continue;
          const uint8_t ig = g_ig[gt_order[g]];
          if (best_g > -1 && !g_ig[gt_order[best_g]] && ig) break;
          if (row[g] < best_iou) continue;
          best_iou = row[g];
          best_g = g;
        }
        const double darea =
            d_boxes[(d0 + dt_order[d]) * 4 + 2] *
            d_boxes[(d0 + dt_order[d]) * 4 + 3];
        const bool out_of_rng = darea < area_lo || darea > area_hi;
        if (best_g == -1) {
          dtig_row[d] = out_of_rng;  // unmatched + outside range -> ignore
          continue;
        }
        dtig_row[d] = g_ig[gt_order[best_g]];
        dtm_row[d] = g_ids[g0 + gt_order[best_g]];
        gtm[best_g] = d + 1;
        // pycocotools applies the unmatched-out-of-range ignore on
        // dtm == 0 AFTER matching — a det matched to annotation id 0
        // (the quirk) is included by that test
        if (dtm_row[d] == 0 && out_of_rng) dtig_row[d] = 1;
      }
    }
    for (int64_t d = 0; d < nd; ++d)
      out_scores[written + d] = d_scores[d0 + dt_order[d]];
    for (int64_t g = 0; g < ng; ++g) ngt_total += !g_ig[g];
    written += nd;
  }
  *out_ngt = ngt_total;
  delete[] gt_order;
  delete[] g_ig;
  delete[] dt_order;
  delete[] ious;
  delete[] gtm;
  return written;
}

// COCOeval.accumulate inner kernel for one (threshold, category):
// monotone precision envelope from the right + precision sampled at the
// 101 recall thresholds.
//
// tp/fp: [n] cumulative sums (score-descending order), n_gt > 0.
// rec_thrs: [nr]; out_q: [nr] sampled precisions.
void precision_at_recall(const double* tp, const double* fp, int64_t n,
                         double n_gt, const double* rec_thrs, int64_t nr,
                         double* out_q) {
  if (n == 0) {
    for (int64_t r = 0; r < nr; ++r) out_q[r] = 0.0;
    return;
  }
  double* pr = new double[n];
  double* rc = new double[n];
  for (int64_t i = 0; i < n; ++i) {
    rc[i] = tp[i] / n_gt;
    const double denom = tp[i] + fp[i];
    pr[i] = denom > 0 ? tp[i] / denom : 0.0;
  }
  for (int64_t i = n - 1; i > 0; --i)
    if (pr[i] > pr[i - 1]) pr[i - 1] = pr[i];
  // searchsorted(rc, rec_thrs, side='left') then sample
  for (int64_t r = 0; r < nr; ++r) {
    const double* pos = std::lower_bound(rc, rc + n, rec_thrs[r]);
    const int64_t idx = pos - rc;
    out_q[r] = idx < n ? pr[idx] : 0.0;
  }
  delete[] pr;
  delete[] rc;
}

}  // extern "C"
