// idmvton_tpu_torch host runtime (CPU, C++), bound through ctypes.
//
// The host-side counterparts of the reference's native kernel layer
// (SURVEY §2.4), with the same bodies as the JAX package's runtime
// (idmvton_tpu/runtime/csrc/native.cc):
//  - idm_roi_align_forward: detectron2 ROIAlign semantics (aligned=true),
//    the oracle of the port's ROIAlign (ops/roi_align.py);
//  - idm_nms: greedy IoU suppression (csrc/nms_rotated + torchvision nms
//    analog);
//  - idm_coco_average_precision: compact COCO-style AP@[.5:.95];
//  - idm_coco_evaluate: the full COCO box evaluator (pycocotools parity).
//
// The interface is plain C (extern "C", pointers and ints): no Python
// headers, no extension module. runtime/native.py builds this file with g++
// into idmvton_tpu_torch/_build/ and binds it with ctypes; it checks types,
// shapes and contiguity before passing pointers.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// ROIAlign forward (NHWC features)
// ---------------------------------------------------------------------------

inline float bilinear(const float* feat, int h, int w, int c, float y, float x,
                      int ch) {
  if (y < -1.f || y > (float)h || x < -1.f || x > (float)w) return 0.f;
  y = std::min(std::max(y, 0.f), (float)(h - 1));
  x = std::min(std::max(x, 0.f), (float)(w - 1));
  int y0 = (int)y, x0 = (int)x;
  int y1 = std::min(y0 + 1, h - 1), x1 = std::min(x0 + 1, w - 1);
  float wy1 = y - y0, wx1 = x - x0;
  auto at = [&](int yy, int xx) { return feat[(yy * w + xx) * c + ch]; };
  return (1 - wy1) * (1 - wx1) * at(y0, x0) + (1 - wy1) * wx1 * at(y0, x1) +
         wy1 * (1 - wx1) * at(y1, x0) + wy1 * wx1 * at(y1, x1);
}

inline float iou(const float* a, const float* b) {
  float ax = std::max(a[0], b[0]), ay = std::max(a[1], b[1]);
  float bx = std::min(a[2], b[2]), by = std::min(a[3], b[3]);
  float inter = std::max(bx - ax, 0.f) * std::max(by - ay, 0.f);
  float aa = std::max(a[2] - a[0], 0.f) * std::max(a[3] - a[1], 0.f);
  float ab = std::max(b[2] - b[0], 0.f) * std::max(b[3] - b[1], 0.f);
  float u = aa + ab - inter;
  return u > 1e-9f ? inter / u : 0.f;
}

struct ImgCatEval {
  // Row-major (T, D') / (T, G') match + ignore tables for one (cat, area, img)
  std::vector<int> dt_match;   // matched gt local index + 1, 0 = unmatched
  std::vector<char> dt_ignore;
  std::vector<char> gt_ignore;
  std::vector<double> dt_score;  // sorted desc, capped at max maxDet
  int n_dt = 0, n_gt = 0;
};

inline double iou_xyxy(const double* a, const double* b, bool crowd) {
  double ax = std::max(a[0], b[0]), ay = std::max(a[1], b[1]);
  double bx = std::min(a[2], b[2]), by = std::min(a[3], b[3]);
  double inter = std::max(bx - ax, 0.0) * std::max(by - ay, 0.0);
  double aa = std::max(a[2] - a[0], 0.0) * std::max(a[3] - a[1], 0.0);
  double ab = std::max(b[2] - b[0], 0.0) * std::max(b[3] - b[1], 0.0);
  double u = crowd ? aa : aa + ab - inter;  // crowd gt: union = det area
  return u > 1e-12 ? inter / u : 0.0;
}

}  // namespace

extern "C" {

// features (B, H, W, C) f32; boxes (R, 4) f32; box_indices (R,) i32
// -> out (R, n, n, C) f32
void idm_roi_align_forward(const float* fp, const float* bx,
                           const int32_t* bi, float* op, int b, int h, int w,
                           int c, int r, int n, int sampling, float scale,
                           int aligned) {
  const float offset = aligned ? 0.5f : 0.0f;

  for (int ri = 0; ri < r; ri++) {
    float* dst = op + (size_t)ri * n * n * c;
    if (bi[ri] < 0 || bi[ri] >= b) {
      std::fill(dst, dst + (size_t)n * n * c, 0.f);
      continue;
    }
    const float* img = fp + (size_t)bi[ri] * h * w * c;
    float x1 = bx[ri * 4 + 0] * scale - offset;
    float y1 = bx[ri * 4 + 1] * scale - offset;
    float x2 = bx[ri * 4 + 2] * scale - offset;
    float y2 = bx[ri * 4 + 3] * scale - offset;
    float rw = std::max(x2 - x1, aligned ? 1e-6f : 1.f);
    float rh = std::max(y2 - y1, aligned ? 1e-6f : 1.f);
    float bw = rw / n, bh = rh / n;
    for (int oy = 0; oy < n; oy++) {
      for (int ox = 0; ox < n; ox++) {
        for (int ch = 0; ch < c; ch++) {
          float acc = 0.f;
          for (int sy = 0; sy < sampling; sy++) {
            for (int sx = 0; sx < sampling; sx++) {
              float y = y1 + (oy + (sy + .5f) / sampling) * bh;
              float x = x1 + (ox + (sx + .5f) / sampling) * bw;
              acc += bilinear(img, h, w, c, y, x, ch);
            }
          }
          dst[(oy * n + ox) * c + ch] = acc / (sampling * sampling);
        }
      }
    }
  }
}

// boxes (N, 4), scores (N,) -> keep mask written into keep (N,) i32
void idm_nms(const float* bx, const float* sc, int32_t* keep, int n,
             float thr) {
  std::vector<int> order(n);
  for (int i = 0; i < n; i++) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return sc[a] > sc[b]; });
  std::vector<char> suppressed(n, 0);
  std::fill(keep, keep + n, 0);
  for (int oi = 0; oi < n; oi++) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep[i] = 1;
    for (int oj = oi + 1; oj < n; oj++) {
      int j = order[oj];
      if (!suppressed[j] && iou(bx + i * 4, bx + j * 4) > thr)
        suppressed[j] = 1;
    }
  }
}

// COCO-style AP@[.5:.95] for box detections, single category.
// dets (D, 6): image_id, score, x1, y1, x2, y2 (pre-sorted by score desc)
// gts  (G, 5): image_id, x1, y1, x2, y2
double idm_coco_average_precision(const float* dp, const float* gp, int nd,
                                  int ng) {
  double ap_sum = 0.0;
  int n_thr = 0;
  for (float thr = 0.5f; thr < 0.99f; thr += 0.05f, n_thr++) {
    std::vector<char> gt_used(ng, 0);
    std::vector<char> tp(nd, 0);
    for (int d = 0; d < nd; d++) {
      float best = thr;
      int best_g = -1;
      for (int g = 0; g < ng; g++) {
        if (gt_used[g] || gp[g * 5] != dp[d * 6]) continue;  // image match
        float v = iou(dp + d * 6 + 2, gp + g * 5 + 1);
        if (v >= best) {
          best = v;
          best_g = g;
        }
      }
      if (best_g >= 0) {
        gt_used[best_g] = 1;
        tp[d] = 1;
      }
    }
    // 101-point interpolated AP
    std::vector<double> prec, rec;
    int tps = 0;
    for (int d = 0; d < nd; d++) {
      tps += tp[d];
      prec.push_back((double)tps / (d + 1));
      rec.push_back(ng > 0 ? (double)tps / ng : 0.0);
    }
    for (int i = (int)prec.size() - 2; i >= 0; i--)
      prec[i] = std::max(prec[i], prec[i + 1]);
    double ap = 0.0;
    for (int ri = 0; ri <= 100; ri++) {
      double r = ri / 100.0;
      double p = 0.0;
      for (size_t i = 0; i < rec.size(); i++) {
        if (rec[i] >= r) {
          p = prec[i];
          break;
        }
      }
      ap += p / 101.0;
    }
    ap_sum += ap;
  }
  return ng == 0 ? 0.0 : ap_sum / n_thr;
}

// Full COCO evaluator: multi-category, area ranges, maxDets (behavioral
// parity with pycocotools accumulate()/evaluateImg(), which the reference
// vendors natively in gradio_demo/detectron2/layers/csrc/cocoeval/).
// dets (D, 8) f64: image_id, cat_id, score, area, x1, y1, x2, y2
// gts  (G, 9) f64: image_id, cat_id, iscrowd, ignore, area, x1, y1, x2, y2
// img_ids (I,) f64; cat_ids (K,) f64; iou_thrs (T,) f64; rec_thrs (R,) f64;
// area_rngs (A, 2) f64; max_dets (M,) i32 ascending.
// Outputs written in place: precision (T, R, K, A, M) f64 (init -1 by caller),
// recall (T, K, A, M) f64 (init -1), scores (T, R, K, A, M) f64 (init -1).
void idm_coco_evaluate(const double* dp, const double* gp,
                       const double* img_ids, const double* cat_ids,
                       const double* iou_thrs, const double* rec_thrs,
                       const double* area_rngs, const int32_t* max_dets,
                       double* prec_out, double* recall_out,
                       double* score_out, int nd, int ng, int ni, int nk,
                       int nt, int nr, int na, int nm) {
  const int max_det_cap = max_dets[nm - 1];

  // Per (cat, area, img) evaluations, indexed [k][a][i].
  std::vector<ImgCatEval> evals((size_t)nk * na * ni);
  std::vector<int> dt_order, gt_order;
  std::vector<double> iou_mat;

  for (int k = 0; k < nk; k++) {
    for (int i = 0; i < ni; i++) {
      // Collect this (img, cat)'s detections (stable sort by -score) and gts.
      dt_order.clear();
      gt_order.clear();
      for (int d = 0; d < nd; d++)
        if (dp[d * 8] == img_ids[i] && dp[d * 8 + 1] == cat_ids[k])
          dt_order.push_back(d);
      for (int g = 0; g < ng; g++)
        if (gp[g * 9] == img_ids[i] && gp[g * 9 + 1] == cat_ids[k])
          gt_order.push_back(g);
      std::stable_sort(dt_order.begin(), dt_order.end(), [&](int a, int b) {
        return dp[a * 8 + 2] > dp[b * 8 + 2];
      });
      if ((int)dt_order.size() > max_det_cap) dt_order.resize(max_det_cap);
      const int ndt = dt_order.size(), ngt = gt_order.size();
      // IoU matrix (ndt, ngt), area-range independent.
      iou_mat.assign((size_t)ndt * ngt, 0.0);
      for (int d = 0; d < ndt; d++)
        for (int g = 0; g < ngt; g++)
          iou_mat[(size_t)d * ngt + g] =
              iou_xyxy(dp + dt_order[d] * 8 + 4, gp + gt_order[g] * 9 + 5,
                       gp[gt_order[g] * 9 + 2] != 0.0);

      for (int a = 0; a < na; a++) {
        ImgCatEval& ev = evals[((size_t)k * na + a) * ni + i];
        ev.n_dt = ndt;
        ev.n_gt = ngt;
        ev.dt_score.resize(ndt);
        for (int d = 0; d < ndt; d++) ev.dt_score[d] = dp[dt_order[d] * 8 + 2];
        const double lo = area_rngs[a * 2], hi = area_rngs[a * 2 + 1];
        // gt ignore = explicit ignore | iscrowd | area outside range;
        // gts sorted ignores-last (stable), per pycocotools evaluateImg.
        std::vector<char> ign(ngt);
        std::vector<int> gsort(ngt);
        for (int g = 0; g < ngt; g++) {
          const double* row = gp + gt_order[g] * 9;
          ign[g] = (row[2] != 0.0) || (row[3] != 0.0) || row[4] < lo ||
                   row[4] > hi;
          gsort[g] = g;
        }
        std::stable_sort(gsort.begin(), gsort.end(), [&](int x, int y) {
          return (int)ign[x] < (int)ign[y];
        });
        ev.gt_ignore.resize(ngt);
        for (int g = 0; g < ngt; g++) ev.gt_ignore[g] = ign[gsort[g]];
        ev.dt_match.assign((size_t)nt * ndt, 0);
        ev.dt_ignore.assign((size_t)nt * ndt, 0);
        std::vector<int> gt_match((size_t)nt * ngt, 0);
        for (int t = 0; t < nt; t++) {
          for (int d = 0; d < ndt; d++) {
            double best = std::min(iou_thrs[t], 1 - 1e-10);
            int m = -1;
            for (int gs = 0; gs < ngt; gs++) {
              const int g = gsort[gs];
              const bool crowd = gp[gt_order[g] * 9 + 2] != 0.0;
              if (gt_match[(size_t)t * ngt + gs] > 0 && !crowd) continue;
              // past non-ignored gts with a match in hand: stop
              if (m > -1 && !ev.gt_ignore[m] && ev.gt_ignore[gs]) break;
              const double v = iou_mat[(size_t)d * ngt + g];
              if (v < best) continue;
              best = v;
              m = gs;
            }
            if (m < 0) continue;
            ev.dt_ignore[(size_t)t * ndt + d] = ev.gt_ignore[m];
            ev.dt_match[(size_t)t * ndt + d] = m + 1;
            gt_match[(size_t)t * ngt + m] = d + 1;
          }
          // unmatched detections with area outside the range are ignored
          for (int d = 0; d < ndt; d++) {
            const double darea = dp[dt_order[d] * 8 + 3];
            if (ev.dt_match[(size_t)t * ndt + d] == 0 &&
                (darea < lo || darea > hi))
              ev.dt_ignore[(size_t)t * ndt + d] = 1;
          }
        }
      }
    }
  }

  // Accumulate: per (k, a, m) build the cross-image score-sorted detection
  // list (per-image cap max_dets[m], stable sort to match numpy mergesort).
  std::vector<int> eval_of, local_of, order;
  std::vector<double> all_scores, pr_curve, rc_curve;
  for (int k = 0; k < nk; k++) {
    for (int a = 0; a < na; a++) {
      const ImgCatEval* row = &evals[((size_t)k * na + a) * ni];
      int npig = 0;
      for (int i = 0; i < ni; i++)
        for (int g = 0; g < row[i].n_gt; g++)
          if (!row[i].gt_ignore[g]) npig++;
      if (npig == 0) continue;  // precision/recall stay -1
      for (int m = 0; m < nm; m++) {
        const int cap = max_dets[m];
        eval_of.clear();
        local_of.clear();
        all_scores.clear();
        for (int i = 0; i < ni; i++) {
          const int take = std::min(row[i].n_dt, cap);
          for (int d = 0; d < take; d++) {
            eval_of.push_back(i);
            local_of.push_back(d);
            all_scores.push_back(row[i].dt_score[d]);
          }
        }
        order.resize(all_scores.size());
        for (size_t j = 0; j < order.size(); j++) order[j] = (int)j;
        std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
          return all_scores[x] > all_scores[y];
        });
        for (int t = 0; t < nt; t++) {
          pr_curve.clear();
          rc_curve.clear();
          int64_t tps = 0, fps = 0;
          for (int j : order) {
            const ImgCatEval& ev = row[eval_of[j]];
            const size_t di = (size_t)t * ev.n_dt + local_of[j];
            const bool ig = ev.dt_ignore[di];
            if (!ig && ev.dt_match[di] > 0) tps++;
            if (!ig && ev.dt_match[di] == 0) fps++;
            rc_curve.push_back((double)tps / npig);
            pr_curve.push_back(tps + fps > 0 ? (double)tps / (tps + fps)
                                             : 0.0);
          }
          const size_t ridx = (((size_t)t * nk + k) * na + a) * nm + m;
          recall_out[ridx] = rc_curve.empty() ? 0.0 : rc_curve.back();
          for (int64_t j = (int64_t)pr_curve.size() - 1; j > 0; j--)
            if (pr_curve[j] > pr_curve[j - 1]) pr_curve[j - 1] = pr_curve[j];
          for (int r = 0; r < nr; r++) {
            auto low = std::lower_bound(rc_curve.begin(), rc_curve.end(),
                                        rec_thrs[r]);
            const size_t pi = low - rc_curve.begin();
            const size_t oidx =
                ((((size_t)t * nr + r) * nk + k) * na + a) * nm + m;
            if (pi < pr_curve.size()) {
              prec_out[oidx] = pr_curve[pi];
              score_out[oidx] = all_scores[order[pi]];
            } else {
              prec_out[oidx] = 0.0;
              score_out[oidx] = 0.0;
            }
          }
        }
      }
    }
  }
}

}  // extern "C"
