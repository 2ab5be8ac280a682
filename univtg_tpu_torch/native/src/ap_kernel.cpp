// Detection-AP kernel: VOC-style AP with per-threshold GT locking.
//
// Native batched replacement for the evaluator's per-query Python loop
// (reference fans this out over multiprocessing.Pool(8), eval/eval.py:54-57;
// here a thread pool walks thousands of queries in-process). Semantics match
// univtg_tpu_torch/evals/ap.py::detection_ap with stable descending tie
// order. A copy of univtg_tpu/native/src/ap_kernel.cpp, held against the
// numpy path and the JAX package's kernel in tests/test_torch_native.py.
//
// Build: univtg_tpu_torch/native/build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <thread>
#include <vector>

namespace {

// Interpolated precision/recall area (VOC2011), eval/utils.py:66-82.
double interpolated_pr_auc(std::vector<double>& prec, std::vector<double>& rec) {
  const size_t n = prec.size();
  std::vector<double> mprec(n + 2), mrec(n + 2);
  mprec[0] = 0.0;
  mrec[0] = 0.0;
  for (size_t i = 0; i < n; ++i) {
    mprec[i + 1] = prec[i];
    mrec[i + 1] = rec[i];
  }
  mprec[n + 1] = 0.0;
  mrec[n + 1] = 1.0;
  for (size_t i = n + 1; i-- > 0;) {
    mprec[i] = std::max(mprec[i], mprec[i + 1]);
  }
  double ap = 0.0;
  for (size_t i = 1; i < n + 2; ++i) {
    if (mrec[i] != mrec[i - 1]) {
      ap += (mrec[i] - mrec[i - 1]) * mprec[i];
    }
  }
  return ap;
}

// One query: gt (n_gt, 2), pred (n_pred, 2) + scores, thds (n_thds).
// out: (n_thds,) AP values.
void detection_ap_one(const double* gt, int64_t n_gt, const double* pred,
                      const double* scores, int64_t n_pred, const double* thds,
                      int64_t n_thds, double* out) {
  for (int64_t t = 0; t < n_thds; ++t) out[t] = 0.0;
  if (n_pred == 0) return;

  // stable sort prediction indices by descending score
  std::vector<int64_t> order(n_pred);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return scores[a] > scores[b];
  });

  std::vector<double> tp(n_thds * n_pred, 0.0), fp(n_thds * n_pred, 0.0);
  std::vector<int64_t> lock_gt(n_thds * n_gt, -1);
  std::vector<double> iou(n_gt);
  std::vector<int64_t> iou_order(n_gt);

  for (int64_t rank = 0; rank < n_pred; ++rank) {
    const int64_t p = order[rank];
    const double ps = pred[2 * p], pe = pred[2 * p + 1];
    if (n_gt == 0) {
      for (int64_t t = 0; t < n_thds; ++t) fp[t * n_pred + rank] = 1.0;
      continue;
    }
    for (int64_t g = 0; g < n_gt; ++g) {
      const double gs = gt[2 * g], ge = gt[2 * g + 1];
      const double inter = std::max(0.0, std::min(pe, ge) - std::max(ps, gs));
      const double uni = (pe - ps) + (ge - gs) - inter;
      iou[g] = inter / uni;
    }
    std::iota(iou_order.begin(), iou_order.end(), 0);
    std::stable_sort(iou_order.begin(), iou_order.end(),
                     [&](int64_t a, int64_t b) { return iou[a] > iou[b]; });

    for (int64_t t = 0; t < n_thds; ++t) {
      bool assigned = false;
      for (int64_t gi : iou_order) {
        if (iou[gi] < thds[t]) {
          fp[t * n_pred + rank] = 1.0;
          assigned = true;
          break;
        }
        if (lock_gt[t * n_gt + gi] >= 0) continue;
        tp[t * n_pred + rank] = 1.0;
        lock_gt[t * n_gt + gi] = rank;
        assigned = true;
        break;
      }
      if (!assigned) fp[t * n_pred + rank] = 1.0;
    }
  }

  std::vector<double> prec(n_pred), rec(n_pred);
  for (int64_t t = 0; t < n_thds; ++t) {
    double tpc = 0.0, fpc = 0.0;
    for (int64_t r = 0; r < n_pred; ++r) {
      tpc += tp[t * n_pred + r];
      fpc += fp[t * n_pred + r];
      prec[r] = tpc / (tpc + fpc);
      rec[r] = n_gt > 0 ? tpc / static_cast<double>(n_gt) : 0.0;
    }
    out[t] = interpolated_pr_auc(prec, rec);
  }
}

}  // namespace

extern "C" {

// Batched entry: concatenated per-query arrays with offset tables.
//   gt:      (gt_off[n_queries], 2) flattened spans
//   pred:    (pred_off[n_queries], 2), scores: (pred_off[n_queries],)
//   *_off:   length n_queries+1 prefix offsets
//   out:     (n_queries, n_thds)
void detection_ap_batch(const double* gt, const int64_t* gt_off,
                        const double* pred, const double* scores,
                        const int64_t* pred_off, int64_t n_queries,
                        const double* thds, int64_t n_thds, int64_t n_threads,
                        double* out) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  const int64_t chunk = (n_queries + n_threads - 1) / n_threads;
  for (int64_t w = 0; w < n_threads; ++w) {
    const int64_t lo = w * chunk;
    const int64_t hi = std::min(n_queries, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      for (int64_t q = lo; q < hi; ++q) {
        detection_ap_one(gt + 2 * gt_off[q], gt_off[q + 1] - gt_off[q],
                         pred + 2 * pred_off[q], scores + pred_off[q],
                         pred_off[q + 1] - pred_off[q], thds, n_thds,
                         out + q * n_thds);
      }
    });
  }
  for (auto& t : pool) t.join();
}

}  // extern "C"
