// Host kernels of the text metrics that the JAX package runs in Python, built
// into the same library as native.cpp.  Each one computes what its Python
// fallback computes, operation for operation in IEEE double (no contraction
// into fused multiply-adds), so both give the same bits.
#include <cstdint>
#include <utility>
#include <vector>

extern "C" {

// Extended edit distance (Stanchev et al., WMT 2019) of each (hyp, ref) pair:
// the CDER grid over code points with a long jump at blanks and a coverage
// penalty, as metrics_tpu_torch/functional/text/eed.py::_eed_function runs it.
// hyp and ref are the pairs' code points back to back, *_lens their lengths.
void mtpu_eed_batch(const int32_t* hyp, const int64_t* hyp_lens, const int32_t* ref, const int64_t* ref_lens,
                    int64_t n_pairs, double alpha, double rho, double deletion, double insertion, double* out) {
  std::vector<double> row, nxt;
  std::vector<int64_t> visits;
  const int32_t* h = hyp;
  const int32_t* r = ref;
  for (int64_t p = 0; p < n_pairs; ++p) {
    const int64_t n = hyp_lens[p], m = ref_lens[p];
    visits.assign(n + 1, -1);
    row.assign(n + 1, 1.0);
    row[0] = 0.0;
    nxt.assign(n + 1, 0.0);
    for (int64_t w = 0; w < m; ++w) {
      const int32_t ch = r[w];
      double last = row[0] + 1.0;
      nxt[0] = last;
      for (int64_t i = 0; i < n; ++i) {
        last = last + deletion;
        double diag = row[i];
        if (h[i] != ch) diag = diag + 1.0;
        if (diag < last) last = diag;
        const double up = row[i + 1] + insertion;
        if (up < last) last = up;
        nxt[i + 1] = last;
      }
      int64_t best_at = 0;  // the first minimum, as list.index(min(...)) finds it
      for (int64_t i = 1; i <= n; ++i) {
        if (nxt[i] < nxt[best_at]) best_at = i;
      }
      const double best = nxt[best_at];
      visits[best_at] += 1;
      if (ch == ' ') {
        const double jump = alpha + best;
        for (int64_t i = 0; i <= n; ++i) {
          if (!(nxt[i] <= jump)) nxt[i] = jump;
        }
      }
      std::swap(row, nxt);
    }
    int64_t visited = 0;
    for (int64_t i = 0; i <= n; ++i) visited += visits[i] >= 0 ? visits[i] : 1;
    const double coverage = rho * static_cast<double>(visited);
    const double score = (row[n] + coverage) / (static_cast<double>(m) + coverage);
    out[p] = score < 1.0 ? score : 1.0;
    h += n;
    r += m;
  }
}

}  // extern "C"
