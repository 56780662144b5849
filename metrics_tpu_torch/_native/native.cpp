// metrics_tpu native host kernels.
//
// TPU-native framework design note: the XLA/jit path handles all tensor math;
// these kernels cover the host-orchestrated, genuinely sequential algorithms
// the reference delegates to pure Python (edit distances,
// reference functional/text/helper.py:333-354) or to third-party C extensions
// (pycocotools RLE, reference detection/mean_ap.py:127-142).  Built on demand
// with g++ into a shared library loaded via ctypes; every entry point has a
// pure-Python fallback so the library is optional.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Levenshtein distance over token-id sequences (two-row DP).
int64_t mtpu_edit_distance(const int64_t* a, int64_t na, const int64_t* b, int64_t nb) {
    if (na == 0) return nb;
    if (nb == 0) return na;
    std::vector<int64_t> prev(nb + 1), cur(nb + 1);
    for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
    for (int64_t i = 1; i <= na; ++i) {
        cur[0] = i;
        const int64_t ai = a[i - 1];
        for (int64_t j = 1; j <= nb; ++j) {
            const int64_t sub = prev[j - 1] + (ai == b[j - 1] ? 0 : 1);
            cur[j] = std::min(sub, std::min(prev[j] + 1, cur[j - 1] + 1));
        }
        std::swap(prev, cur);
    }
    return prev[nb];
}

// Batched edit distance: sequences are concatenated in `a`/`b` with per-pair
// lengths; writes one distance per pair into `out`.
void mtpu_edit_distance_batch(const int64_t* a, const int64_t* a_lens,
                              const int64_t* b, const int64_t* b_lens,
                              int64_t n_pairs, int64_t* out) {
    int64_t ao = 0, bo = 0;
    for (int64_t p = 0; p < n_pairs; ++p) {
        out[p] = mtpu_edit_distance(a + ao, a_lens[p], b + bo, b_lens[p]);
        ao += a_lens[p];
        bo += b_lens[p];
    }
}

// COCO-style uncompressed RLE over a column-major binary mask.
// Counts alternate runs of 0s and 1s starting with 0.  Returns the number of
// runs written (capacity must be h*w+1).
int64_t mtpu_rle_encode(const uint8_t* mask, int64_t h, int64_t w, uint32_t* counts) {
    const int64_t n = h * w;
    int64_t n_runs = 0;
    uint8_t prev = 0;
    uint32_t run = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t v = mask[i];  // caller passes column-major (Fortran) order
        if (v != prev) {
            counts[n_runs++] = run;
            run = 0;
            prev = v;
        }
        ++run;
    }
    counts[n_runs++] = run;
    return n_runs;
}

// Batched RLE encode: n C-contiguous (h, w) masks in one call.  Each mask is
// scanned in column-major (Fortran) order via stride arithmetic — no host-side
// transpose copy.  Runs for all masks are written back to back into
// `runs` (capacity n*(h*w+1)); per-mask run counts go to `runcounts`.
// Returns the total number of runs written.
int64_t mtpu_rle_encode_batch(const uint8_t* masks, int64_t n, int64_t h, int64_t w,
                              uint32_t* runs, int64_t* runcounts) {
    // A column-major scan of a row-major mask is cache-hostile (one byte per
    // cache line).  Instead: consecutive column-major elements are vertical
    // neighbours, so value changes are exactly the row[i] != row[i+1]
    // positions — detected row-major (sequential loads, 8-byte XOR fast
    // skip over equal spans), plus the column-seam comparisons
    // (h-1, j) -> (0, j+1).  Boundary positions are then sorted (masks have
    // few boundaries) and differenced into runs.
    int64_t total = 0;
    std::vector<int64_t> bnd;
    for (int64_t m = 0; m < n; ++m) {
        const uint8_t* M = masks + m * h * w;
        uint32_t* out = runs + total;
        int64_t n_runs = 0;
        if (h * w == 0) {
            out[n_runs++] = 0;
            runcounts[m] = n_runs;
            total += n_runs;
            continue;
        }
        bnd.clear();
        for (int64_t i = 0; i + 1 < h; ++i) {
            const uint8_t* r0 = M + i * w;
            const uint8_t* r1 = r0 + w;
            int64_t j = 0;
            // 64-byte fast path: one branch per cache line of equal bytes
            for (; j + 64 <= w; j += 64) {
                uint64_t acc = 0;
                for (int64_t c = 0; c < 64; c += 8) {
                    uint64_t a, b;
                    std::memcpy(&a, r0 + j + c, 8);
                    std::memcpy(&b, r1 + j + c, 8);
                    acc |= a ^ b;
                }
                if (acc == 0) continue;
                for (int64_t k = j; k < j + 64; ++k)
                    if ((r0[k] != 0) != (r1[k] != 0)) bnd.push_back(k * h + i + 1);
            }
            for (; j + 8 <= w; j += 8) {
                uint64_t a, b;
                std::memcpy(&a, r0 + j, 8);
                std::memcpy(&b, r1 + j, 8);
                if (a == b) continue;
                for (int64_t k = j; k < j + 8; ++k)
                    if ((r0[k] != 0) != (r1[k] != 0)) bnd.push_back(k * h + i + 1);
            }
            for (; j < w; ++j)
                if ((r0[j] != 0) != (r1[j] != 0)) bnd.push_back(j * h + i + 1);
        }
        const uint8_t* last = M + (h - 1) * w;
        for (int64_t j = 0; j + 1 < w; ++j)
            if ((last[j] != 0) != (M[j + 1] != 0)) bnd.push_back((j + 1) * h);
        std::sort(bnd.begin(), bnd.end());
        if (M[0] != 0) out[n_runs++] = 0;  // RLE starts with the zero run
        int64_t prev = 0;
        for (const int64_t p : bnd) {
            out[n_runs++] = (uint32_t)(p - prev);
            prev = p;
        }
        out[n_runs++] = (uint32_t)(h * w - prev);
        runcounts[m] = n_runs;
        total += n_runs;
    }
    return total;
}

void mtpu_rle_decode(const uint32_t* counts, int64_t n_runs, uint8_t* mask, int64_t n) {
    int64_t pos = 0;
    uint8_t v = 0;
    for (int64_t r = 0; r < n_runs && pos < n; ++r) {
        const int64_t end = std::min(pos + (int64_t)counts[r], n);
        if (v) std::memset(mask + pos, 1, end - pos);
        else   std::memset(mask + pos, 0, end - pos);
        pos = end;
        v = 1 - v;
    }
    // zero any canvas tail a truncated run list leaves uncovered
    if (pos < n) std::memset(mask + pos, 0, n - pos);
}

// Pairwise IoU between two RLE mask sets given per-mask areas and
// pre-decoded masks is cheaper done densely; for RLE-native IoU we
// intersect run lists directly (the pycocotools trick) to stay O(runs).
int64_t mtpu_rle_area(const uint32_t* counts, int64_t n_runs) {
    int64_t area = 0;
    for (int64_t r = 1; r < n_runs; r += 2) area += counts[r];
    return area;
}

// Per-mask areas over concatenated run arrays in one call.
void mtpu_rle_area_batch(const uint32_t* runs, const int64_t* runcounts,
                         int64_t n_masks, double* out) {
    int64_t off = 0;
    for (int64_t m = 0; m < n_masks; ++m) {
        out[m] = (double)mtpu_rle_area(runs + off, runcounts[m]);
        off += runcounts[m];
    }
}

// Intersection area of two RLEs over the same canvas.
int64_t mtpu_rle_intersection(const uint32_t* a, int64_t na, const uint32_t* b, int64_t nb) {
    int64_t ia = 0, ib = 0;          // run indices
    int64_t pa = 0, pb = 0;          // absolute end position of current run
    uint8_t va = 0, vb = 0;          // current run values
    int64_t pos = 0, inter = 0;
    pa = (na > 0) ? (int64_t)a[0] : 0;
    pb = (nb > 0) ? (int64_t)b[0] : 0;
    while (ia < na && ib < nb) {
        const int64_t nxt = std::min(pa, pb);
        if (va && vb) inter += nxt - pos;
        pos = nxt;
        if (pa == nxt) { ++ia; if (ia < na) pa += (int64_t)a[ia]; va = 1 - va; }
        if (pb == nxt) { ++ib; if (ib < nb) pb += (int64_t)b[ib]; vb = 1 - vb; }
    }
    return inter;
}

// Greedy COCO detection matching for all IoU thresholds in one call.
// ious is row-major (n_det, n_gt) with detections pre-sorted by score and
// ground truths sorted non-ignored-first; outputs are (T, n_det)/(T, n_gt).
void mtpu_coco_match(const double* ious, int64_t n_det, int64_t n_gt,
                     const uint8_t* gt_ignore, const double* thresholds, int64_t n_thr,
                     int64_t* det_match, uint8_t* det_ignore, uint8_t* gt_matched) {
    for (int64_t ti = 0; ti < n_thr; ++ti) {
        int64_t* dm = det_match + ti * n_det;
        uint8_t* dig = det_ignore + ti * n_det;
        uint8_t* gm = gt_matched + ti * n_gt;
        for (int64_t d = 0; d < n_det; ++d) {
            double best_iou = std::min(thresholds[ti], 1.0 - 1e-10);
            int64_t best_g = -1;
            const double* row = ious + d * n_gt;
            for (int64_t g = 0; g < n_gt; ++g) {
                if (gm[g]) continue;
                // gts sorted non-ignored first: stop at the ignored region
                // once a real match exists
                if (best_g > -1 && !gt_ignore[best_g] && gt_ignore[g]) break;
                if (row[g] < best_iou) continue;
                best_iou = row[g];
                best_g = g;
            }
            dm[d] = best_g;
            dig[d] = (best_g > -1) ? gt_ignore[best_g] : 0;
            if (best_g > -1) gm[best_g] = 1;
        }
    }
}

// Pairwise IoU for independent xyxy box blocks in one call (the per-
// (image,class) IoU blocks of COCO mAP).  dboxes/gboxes are the
// concatenated (sum_nd, 4)/(sum_ng, 4) tables; out receives the
// concatenated row-major nd[b] x ng[b] blocks.
void mtpu_box_iou_blocks(const double* dboxes, const int64_t* nd,
                         const double* gboxes, const int64_t* ng,
                         int64_t n_blocks, double* out) {
    int64_t d_off = 0, g_off = 0, o_off = 0;
    for (int64_t b = 0; b < n_blocks; ++b) {
        const double* D = dboxes + d_off * 4;
        const double* G = gboxes + g_off * 4;
        for (int64_t i = 0; i < nd[b]; ++i) {
            const double dx1 = D[i * 4], dy1 = D[i * 4 + 1];
            const double dx2 = D[i * 4 + 2], dy2 = D[i * 4 + 3];
            const double da = (dx2 - dx1) * (dy2 - dy1);
            double* row = out + o_off + i * ng[b];
            for (int64_t j = 0; j < ng[b]; ++j) {
                const double gx1 = G[j * 4], gy1 = G[j * 4 + 1];
                const double gx2 = G[j * 4 + 2], gy2 = G[j * 4 + 3];
                const double w = std::min(dx2, gx2) - std::max(dx1, gx1);
                const double h = std::min(dy2, gy2) - std::max(dy1, gy1);
                const double inter = (w > 0 && h > 0) ? w * h : 0.0;
                const double ga = (gx2 - gx1) * (gy2 - gy1);
                const double uni = da + ga - inter;
                row[j] = uni > 0 ? inter / std::max(uni, 1e-12) : 0.0;
            }
        }
        d_off += nd[b];
        g_off += ng[b];
        o_off += nd[b] * ng[b];
    }
}

// Pairwise RLE-mask IoU for independent blocks (segm mAP).  druns/gruns are
// every mask's run array concatenated in block order; drunlens/grunlens give
// each mask's run count; nd/ng give the masks per block.  Output layout
// matches mtpu_box_iou_blocks.
void mtpu_rle_iou_blocks(const uint32_t* druns, const int64_t* drunlens,
                         const uint32_t* gruns, const int64_t* grunlens,
                         const int64_t* nd, const int64_t* ng, int64_t n_blocks,
                         double* out) {
    int64_t dmask = 0, gmask = 0, o = 0;
    int64_t droff = 0, groff = 0;
    std::vector<int64_t> d_start, g_start, d_area, g_area;
    for (int64_t b = 0; b < n_blocks; ++b) {
        d_start.assign(nd[b], 0); d_area.assign(nd[b], 0);
        g_start.assign(ng[b], 0); g_area.assign(ng[b], 0);
        for (int64_t i = 0; i < nd[b]; ++i) {
            d_start[i] = droff;
            d_area[i] = mtpu_rle_area(druns + droff, drunlens[dmask + i]);
            droff += drunlens[dmask + i];
        }
        for (int64_t j = 0; j < ng[b]; ++j) {
            g_start[j] = groff;
            g_area[j] = mtpu_rle_area(gruns + groff, grunlens[gmask + j]);
            groff += grunlens[gmask + j];
        }
        for (int64_t i = 0; i < nd[b]; ++i)
            for (int64_t j = 0; j < ng[b]; ++j) {
                const int64_t inter = mtpu_rle_intersection(
                    druns + d_start[i], drunlens[dmask + i],
                    gruns + g_start[j], grunlens[gmask + j]);
                const int64_t uni = d_area[i] + g_area[j] - inter;
                out[o + i * ng[b] + j] = uni > 0 ? (double)inter / (double)uni : 0.0;
            }
        dmask += nd[b];
        gmask += ng[b];
        o += nd[b] * ng[b];
    }
}

// Batched greedy COCO matching over independent (nd[b], ng[b]) IoU blocks in
// ONE call (replaces one ctypes crossing per image x class x area).  Ground
// truths arrive in their block-original order with per-gt ignore flags; each
// block builds its own stable non-ignored-first visiting order.  codes is
// (n_thr, total_det) with block b's det columns at the running det offset:
// 0 = unmatched, 1 = matched to a counted gt, 2 = matched to an ignored gt.
void mtpu_coco_match_blocks(const double* ious, const int64_t* nd, const int64_t* ng,
                            int64_t n_blocks, const uint8_t* gt_ignore,
                            const double* thresholds, int64_t n_thr,
                            int64_t total_det, uint8_t* codes) {
    std::vector<int64_t> order;
    std::vector<uint8_t> gm;
    int64_t iou_off = 0, d_off = 0, g_off = 0;
    for (int64_t b = 0; b < n_blocks; ++b) {
        const int64_t NDb = nd[b], NGb = ng[b];
        const double* I = ious + iou_off;
        const uint8_t* gig = gt_ignore + g_off;
        order.clear();
        for (int64_t g = 0; g < NGb; ++g)
            if (!gig[g]) order.push_back(g);
        const int64_t n_real = (int64_t)order.size();
        for (int64_t g = 0; g < NGb; ++g)
            if (gig[g]) order.push_back(g);
        gm.assign(NGb, 0);
        for (int64_t ti = 0; ti < n_thr; ++ti) {
            std::fill(gm.begin(), gm.end(), 0);
            uint8_t* C = codes + ti * total_det + d_off;
            for (int64_t d = 0; d < NDb; ++d) {
                double best_iou = std::min(thresholds[ti], 1.0 - 1e-10);
                int64_t best = -1;  // position in visiting order
                const double* row = I + d * NGb;
                for (int64_t oi = 0; oi < NGb; ++oi) {
                    const int64_t g = order[oi];
                    if (gm[g]) continue;
                    // once a counted match exists, stop at the ignored region
                    if (best > -1 && best < n_real && oi >= n_real) break;
                    const double v = row[g];
                    if (v < best_iou) continue;
                    best_iou = v;
                    best = oi;
                }
                if (best == -1) {
                    C[d] = 0;
                    continue;
                }
                const int64_t g = order[best];
                gm[g] = 1;
                C[d] = gig[g] ? 2 : 1;
            }
        }
        iou_off += NDb * NGb;
        d_off += NDb;
        g_off += NGb;
    }
}

// COCO precision/recall tables for all class segments of one (area, max_det)
// cell in one call.  codes is the raw (n_thr, n_col_full) uint8 match-code
// table; `cols` (n_cols) selects and orders the columns by (class, score
// desc) — the kernel gathers on the fly, so the caller never materializes
// the reordered table.  Per-class segments live at seg_starts/seg_sizes
// (positions into `cols`); dout marks detections outside the area range
// (not counted as FP), indexed by original column id.  For every segment
// with npig > 0: cumulative TP/FP over score rank, recall at the last rank,
// monotone non-increasing precision envelope, and the R-point interpolation
// at rec_thrs (searchsorted-left semantics, matching pycocotools).
// Outputs: out_prec (n_thr, n_rec, n_seg), out_rec (n_thr, n_seg); segments
// with npig <= 0 are left untouched.
void mtpu_coco_tables(const uint8_t* codes, int64_t n_col_full,
                      const int64_t* cols, const uint8_t* dout,
                      const int64_t* seg_starts, const int64_t* seg_sizes,
                      const double* npig, const double* rec_thrs,
                      int64_t n_thr, int64_t n_seg, int64_t n_rec,
                      double* out_prec, double* out_rec) {
    // Recall/precision only change at TP steps, and searchsorted-left over a
    // step function always lands on a step position (the zero-tp prefix it
    // can land on has pr == 0, never the suffix max), so it suffices to
    // record rc/pr at the steps: O(#matches) float work over an O(#dets)
    // integer scan, outputs identical to the dense formulation.
    int64_t max_n = 0;
    for (int64_t s = 0; s < n_seg; ++s) max_n = std::max(max_n, seg_sizes[s]);
    std::vector<double> rcs(max_n), prs(max_n);
    for (int64_t s = 0; s < n_seg; ++s) {
        if (!(npig[s] > 0)) continue;
        const int64_t start = seg_starts[s], n = seg_sizes[s];
        const int64_t* I = cols + start;
        for (int64_t t = 0; t < n_thr; ++t) {
            const uint8_t* C = codes + t * n_col_full;
            int64_t tp = 0, fp = 0, ns = 0;
            for (int64_t i = 0; i < n; ++i) {
                const uint8_t v = C[I[i]];
                if (v == 1) {
                    ++tp;
                    rcs[ns] = (double)tp / npig[s];
                    prs[ns] = (double)tp / (double)(tp + fp);
                    ++ns;
                } else if (v == 0 && !dout[I[i]]) {
                    ++fp;
                }
            }
            out_rec[t * n_seg + s] = (double)tp / npig[s];
            // monotone non-increasing precision envelope over the steps
            for (int64_t i = ns - 2; i >= 0; --i) prs[i] = std::max(prs[i], prs[i + 1]);
            // rec_thrs ascends: searchsorted-left over all thresholds is one
            // monotone merge, O(#steps + R)
            double* P = out_prec + t * n_rec * n_seg;
            int64_t idx = 0;
            for (int64_t r = 0; r < n_rec; ++r) {
                while (idx < ns && rcs[idx] < rec_thrs[r]) ++idx;
                P[r * n_seg + s] = idx < ns ? prs[idx] : 0.0;
            }
        }
    }
}

// Batched minimum-cost linear assignment (Jonker-Volgenant style shortest
// augmenting paths with dual potentials, O(n^3) per matrix).  The audio PIT
// metric routes large speaker counts here instead of enumerating n!
// permutations (the reference delegates this regime to scipy's
// linear_sum_assignment, functional/audio/pit.py:28-49).
// cost: (batch, n, n) row-major; out_assign[b*n + i] = column chosen for row i.
void mtpu_lap_batch(const double* cost, int64_t batch, int64_t n, int64_t* out_assign) {
    const double INF = 1e300;
    std::vector<double> u(n + 1), v(n + 1), minv(n + 1);
    std::vector<int64_t> p(n + 1), way(n + 1);
    std::vector<uint8_t> used(n + 1);
    for (int64_t b = 0; b < batch; ++b) {
        const double* a = cost + b * n * n;
        std::fill(u.begin(), u.end(), 0.0);
        std::fill(v.begin(), v.end(), 0.0);
        std::fill(p.begin(), p.end(), 0);
        for (int64_t i = 1; i <= n; ++i) {
            p[0] = i;
            int64_t j0 = 0;
            std::fill(minv.begin(), minv.end(), INF);
            std::fill(used.begin(), used.end(), 0);
            do {
                used[j0] = 1;
                const int64_t i0 = p[j0];
                int64_t j1 = 0;
                double delta = INF;
                for (int64_t j = 1; j <= n; ++j) {
                    if (used[j]) continue;
                    const double cur = a[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
                    if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
                    if (minv[j] < delta) { delta = minv[j]; j1 = j; }
                }
                for (int64_t j = 0; j <= n; ++j) {
                    if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
                    else minv[j] -= delta;
                }
                j0 = j1;
            } while (p[j0] != 0);
            do { const int64_t j1 = way[j0]; p[j0] = p[j1]; j0 = j1; } while (j0);
        }
        for (int64_t j = 1; j <= n; ++j)
            if (p[j]) out_assign[b * n + (p[j] - 1)] = j - 1;
    }
}

}  // extern "C"
