"""The port's ``MultiStreamMetric`` against the JAX package's, on the CPU.

The same seeded batches go through both packages.  Integer states (counts,
``stream_rows``, ``stream_dropped``, sketch levels and keys) must match
bitwise.  Float states must match bitwise too: the port adds each stream's
rows in row order, as XLA's CPU scatter does (folding them one by one into
the live sum where the JAX package jits the update, summing them first where
it does not), so no tolerance is needed on the CPU.  Computed values are
compared bitwise as well (NaN equal to NaN).  Sketch states match leaf for
leaf, the per-stream PRNG keys included (``stacked_states`` folds the key per
stream as ``jax.random.fold_in`` does).
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu.checkpoint import codec as jcodec
from metrics_tpu_torch.checkpoint import codec as tcodec
from metrics_tpu_torch.interop import load_jax_state
from metrics_tpu_torch.multistream import MultiStreamMetric, shard_spans
from metrics_tpu_torch.parallel.backend import LoopbackBackend
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

S, B, C = 8, 96, 4
CPU = {"device": "cpu"}


def _batches(seed, n_batches=3, ids_lo=-1, ids_hi=S + 1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        logits = rng.normal(size=(B, C)).astype(np.float32)
        logits[:8] = np.round(logits[:8])  # tied maxima
        out.append(
            {
                "preds": rng.integers(0, C, B),
                "target": rng.integers(0, C, B),
                "logits": logits,
                "probs": rng.uniform(size=B).astype(np.float32),
                "binary": rng.integers(0, 2, B),
                "vals": rng.normal(size=B).astype(np.float32),
                "vals2": rng.normal(size=B).astype(np.float32),
                "ids": rng.integers(ids_lo, ids_hi, B),
            }
        )
    return out


def _make(jbase, tbase, num_streams=S, **kw):
    return (
        J.MultiStreamMetric(jbase, num_streams=num_streams, **kw),
        MultiStreamMetric(tbase, num_streams=num_streams, device="cpu", **kw),
    )


def _feed(jm, tm, batches, cols, **kw):
    for b in batches:
        jm.update(*[jnp.asarray(b[c]) for c in cols], stream_ids=jnp.asarray(b["ids"]), **kw)
        tm.update(*[torch.from_numpy(np.ascontiguousarray(b[c])) for c in cols], stream_ids=torch.from_numpy(b["ids"]), **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_states(jm, tm):
    js = {k: v for k, v in jm.state_pytree().items()}
    ts = {k: v for k, v in tm.state_pytree().items()}
    assert set(js) == set(ts)
    assert int(js.pop("_update_count")) == int(ts.pop("_update_count"))
    for k in js:
        a, b = np.asarray(js[k]), _np(ts[k])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


def _assert_bitwise(a, b):
    a, b = np.asarray(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)
    assert (np.signbit(a) == np.signbit(b)).all() if a.dtype.kind == "f" else True


BASES = {
    "accuracy_labels": (lambda m: m.Accuracy(num_classes=C), ("preds", "target")),
    "accuracy_logits": (lambda m: m.Accuracy(num_classes=C), ("logits", "target")),
    "accuracy_macro": (lambda m: m.Accuracy(num_classes=C, average="macro"), ("logits", "target")),
    "precision_macro": (lambda m: m.Precision(num_classes=C, average="macro"), ("preds", "target")),
    "recall_micro": (lambda m: m.Recall(num_classes=C), ("logits", "target")),
    "f1_macro": (lambda m: m.F1Score(num_classes=C, average="macro"), ("logits", "target")),
    "f1_binary_probs": (lambda m: m.F1Score(), ("probs", "binary")),
    "accuracy_ignore_index": (lambda m: m.Accuracy(num_classes=C, average="macro", ignore_index=1), ("preds", "target")),
    "mse": (lambda m: m.MeanSquaredError(), ("vals", "vals2")),
    "mae": (lambda m: m.MeanAbsoluteError(), ("vals", "vals2")),
    "mean": (lambda m: m.MeanMetric(), ("vals",)),
}


def _base(make, pkg):
    if pkg is J:
        return make(J)
    orig = {name: getattr(T, name) for name in ("Accuracy", "Precision", "Recall", "F1Score", "MeanSquaredError", "MeanAbsoluteError", "MeanMetric")}

    class _CPU:
        def __getattr__(self, name):
            return lambda *a, **kw: orig[name](*a, device="cpu", **kw)

    return make(_CPU())


@pytest.mark.parametrize("name", sorted(BASES))
def test_segment_bases_match_the_jax_package(name):
    make, cols = BASES[name]
    jm, tm = _make(_base(make, J), _base(make, T))
    batches = _batches(sorted(BASES).index(name))
    _feed(jm, tm, batches, cols)
    _assert_states(jm, tm)
    _assert_bitwise(jm.compute(), tm.compute())
    assert jm.dropped_rows() == tm.dropped_rows() > 0
    assert jm.active_streams() == tm.active_streams()
    for largest in (True, False):
        jv, ji = jm.top_k(3, largest=largest)
        tv, ti = tm.top_k(3, largest=largest)
        _assert_bitwise(ji, ti)
        _assert_bitwise(jv, tv)


def test_the_per_stream_counts_are_one_route_for_the_stat_scores_family():
    from metrics_tpu_torch.ops import stat_scores as ops

    before = (ops.fused_stream_stat_scores_logits_plain, ops.fused_stream_stat_scores_plain)
    tm = MultiStreamMetric(T.F1Score(num_classes=C, average="macro", device="cpu"), num_streams=S, device="cpu")
    b = _batches(3, n_batches=1)[0]
    calls = []
    sys_mod = __import__("sys").modules["metrics_tpu_torch.functional.classification.stat_scores"]
    real = sys_mod.fused_stream_stat_scores_logits
    sys_mod.fused_stream_stat_scores_logits = lambda *a, **kw: calls.append(a[3]) or real(*a, **kw)
    try:
        tm.update(torch.from_numpy(b["logits"]), torch.from_numpy(b["target"]), stream_ids=torch.from_numpy(b["ids"]))
    finally:
        sys_mod.fused_stream_stat_scores_logits = real
    assert calls == [S]  # one call for the whole batch: no loop over rows or streams
    assert (ops.fused_stream_stat_scores_logits_plain, ops.fused_stream_stat_scores_plain) == before


@pytest.mark.parametrize("micro", [False, True])
def test_the_per_stream_entry_points_equal_per_row_counts(micro):
    from metrics_tpu_torch.ops import (
        fused_stat_scores,
        fused_stat_scores_logits,
        fused_stream_stat_scores,
        fused_stream_stat_scores_logits,
    )

    rng = np.random.default_rng(5)
    for n, c, s in [(0, 3, 2), (1, 1, 1), (50, 7, 1), (60, 5, 4)]:
        logits = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
        if n > 10:
            logits[3, 1] = float("nan")
            logits[4] = 0.0  # all tied
        labels = torch.from_numpy(rng.integers(-1, c + 1, n))
        ids = torch.from_numpy(rng.integers(-1, s + 1, n))
        preds = torch.from_numpy(rng.integers(0, 2, (n, c)).astype(np.int32))
        target = torch.from_numpy(rng.integers(0, 2, (n, c)).astype(np.int32))
        got_l = fused_stream_stat_scores_logits(logits, labels, ids, s, micro=micro)
        got_c = fused_stream_stat_scores(preds, target, ids, s, micro=micro)
        for stream in range(s):
            rows = ids == stream
            want_l = fused_stat_scores_logits(logits[rows].contiguous(), labels[rows].contiguous())
            want_c = fused_stat_scores(preds[rows].contiguous(), target[rows].contiguous())
            for got, want in ((got_l, want_l), (got_c, want_c)):
                for g, w in zip(got, want):
                    assert torch.equal(g[stream], w.sum() if micro else w)


def test_stacked_states_match_the_jax_specs_and_fold_the_key():
    for jbase, tbase in [
        (J.Accuracy(num_classes=C, average="macro"), T.Accuracy(num_classes=C, average="macro", device="cpu")),
        (J.StreamingQuantile(q=0.5, capacity=8, max_items=256), T.StreamingQuantile(q=0.5, capacity=8, max_items=256, device="cpu")),
    ]:
        jspecs, tspecs = jbase.stacked_states(5), tbase.stacked_states(5)
        assert [(s["kind"], s["name"]) for s in jspecs] == [(s["kind"], s["name"]) for s in tspecs]
        for js, ts in zip(jspecs, tspecs):
            if js["kind"] == "tensor":
                assert js["reduce"] == ts["reduce"]
                _assert_bitwise(js["default"], ts["default"])
            else:
                assert set(js["tree"]) == set(ts["tree"])
                for leaf in js["tree"]:
                    _assert_bitwise(js["tree"][leaf], ts["tree"][leaf])
    key = T.StreamingQuantile(device="cpu").stacked_states(3)[0]["tree"]["key"]
    assert key.dtype == torch.uint32 and len({tuple(k.tolist()) for k in key.view(torch.int32)}) == 3
    with pytest.raises(MetricsTPUUserError, match="list/buffer"):
        T.CatMetric(device="cpu").stacked_states(2)
    with pytest.raises(ValueError, match="num_streams"):
        T.MeanMetric(device="cpu").stacked_states(0)


def test_quantile_streams_match_the_jax_package():
    jm, tm = _make(
        J.StreamingQuantile(q=(0.25, 0.5, 0.9), capacity=8, max_items=4096),
        T.StreamingQuantile(q=(0.25, 0.5, 0.9), capacity=8, max_items=4096, device="cpu"),
    )
    batches = _batches(11)
    for b in batches:
        b["vals"][::13] = np.nan
    _feed(jm, tm, batches, ("vals",))
    _assert_states(jm, tm)
    _assert_bitwise(jm.compute(), tm.compute())
    assert jm.dropped_rows() == tm.dropped_rows()
    _assert_bitwise(jm.top_k(3, key=1)[1], tm.top_k(3, key=1)[1])
    with pytest.raises(MetricsTPUUserError, match="key="):
        tm.top_k(2)


def test_quantile_row_overflow_dropped_and_counted():
    jm, tm = _make(J.StreamingQuantile(capacity=16, max_items=4096), T.StreamingQuantile(capacity=16, max_items=4096, device="cpu"),
                   num_streams=4, max_rows_per_stream=2)
    vals, ids = np.arange(5, dtype=np.float32), np.zeros(5, np.int64)
    jm.update(jnp.asarray(vals), stream_ids=jnp.asarray(ids))
    tm.update(torch.from_numpy(vals), stream_ids=torch.from_numpy(ids))
    assert jm.dropped_rows() == tm.dropped_rows() == 3
    _assert_states(jm, tm)
    assert float(tm.compute()[0]) == 0.0  # the first two rows (stable order) survived


def test_num_valid_padding_neither_routes_nor_counts_as_dropped():
    jm, tm = _make(J.Accuracy(num_classes=C), T.Accuracy(num_classes=C, device="cpu"))
    b = _batches(21, n_batches=1)[0]
    for nv in (B - 10, np.asarray([B // 2], np.int32)):
        jm.update(jnp.asarray(b["preds"]), jnp.asarray(b["target"]), stream_ids=jnp.asarray(b["ids"]), num_valid=jnp.asarray(nv))
        tm.update(torch.from_numpy(b["preds"]), torch.from_numpy(b["target"]), stream_ids=torch.from_numpy(b["ids"]),
                  num_valid=torch.as_tensor(nv))
    _assert_states(jm, tm)
    in_range = (b["ids"] >= 0) & (b["ids"] < S)
    assert tm.dropped_rows() == int((~in_range[: B - 10]).sum() + (~in_range[: B // 2]).sum())
    with pytest.raises(MetricsTPUUserError, match="single row count"):
        tm.update(torch.from_numpy(b["preds"]), torch.from_numpy(b["target"]), stream_ids=torch.from_numpy(b["ids"]),
                  num_valid=torch.tensor([1, 2]))


def test_queries_rank_nan_and_ties_as_the_jax_package():
    # eight streams: NaN (untouched), ties, -0.0 and +0.0
    jm, tm = _make(J.MeanMetric(), T.MeanMetric(device="cpu"))
    vals = np.array([1.0, 1.0, -0.0, 0.0, 2.0, 2.0, 0.5], np.float32)
    ids = np.array([0, 1, 2, 3, 4, 6, 7])
    jm.update(jnp.asarray(vals), stream_ids=jnp.asarray(ids))
    tm.update(torch.from_numpy(vals), stream_ids=torch.from_numpy(ids))
    for k in (1, 3, 8):
        for fn in ("top_k", "bottom_k"):
            jv, ji = getattr(jm, fn)(k)
            tv, ti = getattr(tm, fn)(k)
            _assert_bitwise(ji, ti)
            _assert_bitwise(jv, tv)
    for pred, k in ((lambda v: v > 0.25, 3), (lambda v: v >= 0, 8), (lambda v: v > 10, 2)):
        jids, jtotal = jm.where(pred, k)
        tids, ttotal = tm.where(pred, k)
        _assert_bitwise(jids, tids)
        assert int(jtotal) == int(ttotal)
    ids_q = np.array([7, 5, 0, 0])
    _assert_bitwise(jm.compute_streams(jnp.asarray(ids_q)), tm.compute_streams(torch.from_numpy(ids_q)))
    with pytest.raises(ValueError, match="k must be"):
        tm.top_k(S + 1)
    with pytest.raises(MetricsTPUUserError, match="elementwise"):
        tm.where(lambda v: v.sum() > 0, 2)


def test_stream_slice_adopts_bitwise_into_a_wider_recipient():
    jm, tm = _make(J.Accuracy(num_classes=C), T.Accuracy(num_classes=C, device="cpu"))
    _feed(jm, tm, _batches(31, n_batches=2), ("preds", "target"))
    jslice, tslice = jm.stream_slice(2, 6), tm.stream_slice(2, 6)
    assert set(jslice) == set(tslice) and "stream_dropped" not in tslice
    for k in jslice:
        _assert_bitwise(jslice[k], tslice[k])
    wide = MultiStreamMetric(T.Accuracy(num_classes=C, device="cpu"), num_streams=12, device="cpu")
    wide._base.mode = tm._base.mode
    assert wide.adopt_stream_slice(5, tslice) == 4
    assert wide.update_count == int(tslice["stream_rows"].sum())
    for k, v in tslice.items():
        assert torch.equal(getattr(wide, k)[5:9], v)
    _assert_bitwise(wide.compute()[5:9], tm.compute()[2:6])
    from metrics_tpu_torch.checkpoint.manager import decode_stream_span, encode_stream_span

    payload = encode_stream_span(tm, 2, 6)
    assert payload["rows"] == int(tslice["stream_rows"].sum())
    back = decode_stream_span(payload)
    assert all(torch.equal(back[k], tslice[k]) for k in tslice)
    with pytest.raises(MetricsTPUUserError, match="unknown state"):
        wide.adopt_stream_slice(0, {"nope": torch.zeros(2)})
    with pytest.raises(MetricsTPUUserError, match="outside"):
        wide.adopt_stream_slice(10, tslice)


class _JMax(J.Metric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("hi", jnp.asarray(-jnp.inf), dist_reduce_fx="max")
        self.add_state("lo", jnp.asarray(2**31 - 1, jnp.int32), dist_reduce_fx="min")

    def update(self, x, k):
        self.hi = jnp.maximum(self.hi, jnp.max(x))
        self.lo = jnp.minimum(self.lo, jnp.min(k))

    def compute(self):
        return self.hi


class _TMax(T.Metric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("hi", torch.tensor(float("-inf")), dist_reduce_fx="max")
        self.add_state("lo", torch.tensor(2**31 - 1, dtype=torch.int32), dist_reduce_fx="min")

    def update(self, x, k):
        self.hi = torch.maximum(self.hi, x.max())
        self.lo = torch.minimum(self.lo, k.min().to(torch.int32))

    def compute(self):
        return self.hi


def test_segment_max_and_min_match_including_nan_and_empty_streams():
    jm, tm = _make(_JMax(), _TMax(device="cpu"))
    rng = np.random.default_rng(41)
    for _ in range(2):
        x = rng.normal(size=20).astype(np.float32)
        x[3] = np.nan
        k = rng.integers(-50, 50, 20).astype(np.int32)
        ids = rng.integers(0, S - 2, 20)  # the last two streams stay empty
        jm.update(jnp.asarray(x), jnp.asarray(k), stream_ids=jnp.asarray(ids))
        tm.update(torch.from_numpy(x), torch.from_numpy(k), stream_ids=torch.from_numpy(ids))
    _assert_states(jm, tm)


def test_construction_errors():
    with pytest.raises(MetricsTPUUserError, match="list"):
        MultiStreamMetric(T.CatMetric(device="cpu"), num_streams=2, device="cpu")
    with pytest.raises(MetricsTPUUserError, match="stackable=False"):
        MultiStreamMetric(T.AUROC(device="cpu"), num_streams=2, device="cpu")  # buffer states
    used = T.Accuracy(num_classes=C, device="cpu")
    used.update(torch.tensor([1]), torch.tensor([1]))
    with pytest.raises(MetricsTPUUserError, match="fresh"):
        MultiStreamMetric(used, num_streams=2, device="cpu")
    inner = MultiStreamMetric(T.Accuracy(num_classes=C, device="cpu"), num_streams=2, device="cpu")
    with pytest.raises(MetricsTPUUserError, match="nest"):
        MultiStreamMetric(inner, num_streams=2, device="cpu")
    with pytest.raises(MetricsTPUUserError, match="full_state_update"):
        MultiStreamMetric(T.MaxMetric(device="cpu"), num_streams=2, device="cpu")

    class _NonZeroSum(T.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("s", torch.tensor(1.0), dist_reduce_fx="sum")

        def update(self, x):
            self.s = self.s + x.sum()

        def compute(self):
            return self.s

    with pytest.raises(MetricsTPUUserError, match="non-zero default"):
        MultiStreamMetric(_NonZeroSum(device="cpu"), num_streams=2, device="cpu")
    with pytest.raises(ValueError, match="num_streams"):
        MultiStreamMetric(T.MeanMetric(device="cpu"), num_streams=0, device="cpu")
    m = MultiStreamMetric(T.Accuracy(num_classes=C, device="cpu"), num_streams=2, device="cpu")
    with pytest.raises(MetricsTPUUserError, match="stream_ids"):
        m.update(torch.tensor([1]), torch.tensor([1]))
    with pytest.raises(MetricsTPUUserError, match="leading row axis"):
        m.update(torch.tensor([1, 2]), torch.tensor([1, 2]), stream_ids=torch.tensor([0]))
    with pytest.raises(MetricsTPUUserError, match="integers"):
        m.update(torch.tensor([1]), torch.tensor([1]), stream_ids=torch.tensor([0.0]))
    q = MultiStreamMetric(T.StreamingQuantile(capacity=16, max_items=256, device="cpu"), num_streams=2, device="cpu")
    with pytest.raises(MetricsTPUUserError, match="floating"):
        q.update(torch.tensor([1, 2]), stream_ids=torch.tensor([0, 1]))
    # a sketch base is refused only when it has no compute over stacked states (StreamingHistogram has one:
    # tests/test_torch_multistream_histogram.py holds it against the JAX package)
    from metrics_tpu_torch.streaming.quantile import SketchMetric

    class _SingleSketch(SketchMetric):
        def compute(self):
            return self.n_items

    with pytest.raises(MetricsTPUUserError, match="_SingleSketch holds sketch states but has no compute over stacked"):
        MultiStreamMetric(_SingleSketch(device="cpu"), num_streams=2, device="cpu")
    assert shard_spans(10, 3) == [(0, 4), (4, 7), (7, 10)]


def _fed_accuracy(seed, n_batches=2, num_streams=S):
    m = MultiStreamMetric(T.Accuracy(num_classes=C, device="cpu"), num_streams=num_streams, device="cpu")
    for b in _batches(seed, n_batches):
        m.update(torch.from_numpy(b["preds"]), torch.from_numpy(b["target"]), stream_ids=torch.from_numpy(b["ids"]))
    return m


def _fed_quantile(batches):
    m = MultiStreamMetric(T.StreamingQuantile(capacity=64, max_items=4096, device="cpu"), num_streams=S,
                          max_rows_per_stream=32, device="cpu")
    for b in batches:
        m.update(torch.from_numpy(b["vals"]), stream_ids=torch.from_numpy(b["ids"]))
    return m


class TestPersistence:
    """The seams of ``tests/multistream/test_persistence.py``, on the port."""

    def test_state_dict_round_trip_and_the_compute_cache(self):
        m = _fed_accuracy(10)
        want = m.compute()
        m.persistent(True)
        sd = m.state_dict()
        m2 = MultiStreamMetric(T.Accuracy(num_classes=C, device="cpu"), num_streams=S, device="cpu")
        m2.update(torch.tensor([0, 3]), torch.tensor([0, 3]), stream_ids=torch.tensor([0, 0]))
        stale = m2.compute()  # a cached value that the load must drop
        m2.persistent(True)
        m2.load_state_dict(sd)
        _assert_bitwise(want, m2.compute())
        assert not torch.equal(stale, m2.compute())
        assert (m2.active_streams(), m2.dropped_rows()) == (m.active_streams(), m.dropped_rows())

    def test_pickle_round_trip_and_resume(self):
        batches = _batches(12, 3)
        m = _fed_accuracy(12, 2)
        m2 = pickle.loads(pickle.dumps(m))
        _assert_bitwise(m.compute(), m2.compute())
        b = batches[2]
        m2.update(torch.from_numpy(b["preds"]), torch.from_numpy(b["target"]), stream_ids=torch.from_numpy(b["ids"]))
        _assert_bitwise(_fed_accuracy(12, 3).compute(), m2.compute())
        q = _fed_quantile(_batches(13, 2))
        _assert_bitwise(q.compute(), pickle.loads(pickle.dumps(q)).compute())

    def test_codec_restores_into_a_fresh_instance_with_the_base_mode(self):
        m = _fed_accuracy(14)
        enc = tcodec.encode_metric(m)
        dec = tcodec.decode_metric(enc.blob, enc.digests)
        assert not dec.failed
        m2 = MultiStreamMetric(T.Accuracy(num_classes=C, device="cpu"), num_streams=S, device="cpu")
        m2.load_state_pytree(tcodec.arrays_to_pytree(m2, dec.arrays))
        assert m2._base.mode == m._base.mode
        _assert_bitwise(m.compute(), m2.compute())
        q = _fed_quantile(_batches(15, 2))
        enc = tcodec.encode_metric(q)
        q2 = _fed_quantile([])
        q2.load_state_pytree(tcodec.arrays_to_pytree(q2, tcodec.decode_metric(enc.blob, enc.digests).arrays))
        _assert_bitwise(q.compute(), q2.compute())

    def test_corrupt_blob_reports_failed_states(self):
        enc = tcodec.encode_metric(_fed_accuracy(16))
        blob = bytearray(enc.blob)
        blob[len(blob) // 2] ^= 0xFF
        assert tcodec.decode_metric(bytes(blob), enc.digests).failed

    def test_merge_checkpointed_fleets(self):
        a, b = _fed_accuracy(17, 2), _fed_accuracy(18, 2)
        enc = tcodec.encode_metric(b)
        a.merge_state(tcodec.arrays_to_merge_state(a, tcodec.decode_metric(enc.blob, enc.digests).arrays), other_count=enc.update_count)
        ref = MultiStreamMetric(T.Accuracy(num_classes=C, device="cpu"), num_streams=S, device="cpu")
        for seed in (17, 18):
            for bb in _batches(seed, 2):
                ref.update(torch.from_numpy(bb["preds"]), torch.from_numpy(bb["target"]), stream_ids=torch.from_numpy(bb["ids"]))
        _assert_states_port(a, ref)
        batches = _batches(19, 2, ids_lo=0, ids_hi=S)
        qa, qb = _fed_quantile(batches[:1]), _fed_quantile(batches[1:])
        enc = tcodec.encode_metric(qb)
        qa.merge_state(tcodec.arrays_to_merge_state(qa, tcodec.decode_metric(enc.blob, enc.digests).arrays))
        got = qa.compute().numpy()
        for s in range(S):  # uncompacted at capacity 64: the union median is exact
            rows = np.concatenate([bb["vals"][bb["ids"] == s] for bb in batches])
            assert got[s] == np.quantile(rows, 0.5, method="lower")

    def test_the_codec_blobs_equal_the_jax_package(self):
        jm, tm = _make(J.Accuracy(num_classes=C), T.Accuracy(num_classes=C, device="cpu"))
        _feed(jm, tm, _batches(20, 2), ("preds", "target"))
        jenc, tenc = jcodec.encode_metric(jm), tcodec.encode_metric(tm)
        assert jenc.digests == tenc.digests and jenc.blob == tenc.blob and jenc.kinds == tenc.kinds

    def test_load_jax_state_of_a_mid_stream_jax_multistream(self):
        for make_j, make_t, cols in [
            (lambda: J.Accuracy(num_classes=C), lambda: T.Accuracy(num_classes=C, device="cpu"), ("logits", "target")),
            (lambda: J.StreamingQuantile(capacity=8, max_items=4096), lambda: T.StreamingQuantile(capacity=8, max_items=4096, device="cpu"), ("vals",)),
        ]:
            batches = _batches(22, 3)
            jm, twin = _make(make_j(), make_t())
            _feed(jm, twin, batches[:2], cols)
            loaded = MultiStreamMetric(make_t(), num_streams=S, device="cpu")
            load_jax_state(loaded, jm.state_pytree(), jm._ckpt_extra_state())
            _assert_states(jm, loaded)
            _feed(jm, loaded, batches[2:], cols)  # the stream continues bit for bit
            _assert_states(jm, loaded)
            _assert_bitwise(jm.compute(), loaded.compute())


def _assert_states_port(a, b):
    sa, sb = a.state_pytree(), b.state_pytree()
    assert set(sa) == set(sb)
    for k in sa:
        assert _np(torch.as_tensor(sa[k])).tobytes() == _np(torch.as_tensor(sb[k])).tobytes(), k


def test_sync_over_a_loopback_backend_keeps_the_local_state():
    m = MultiStreamMetric(T.Accuracy(num_classes=C, device="cpu"), num_streams=S, device="cpu", sync_backend=LoopbackBackend())
    ref = _fed_accuracy(6)
    for b in _batches(6, 2):
        m.update(torch.from_numpy(b["preds"]), torch.from_numpy(b["target"]), stream_ids=torch.from_numpy(b["ids"]))
    _assert_bitwise(ref.compute(), m.compute())
    assert not m._is_synced
    q = MultiStreamMetric(T.StreamingQuantile(capacity=64, max_items=4096, device="cpu"), num_streams=S,
                          max_rows_per_stream=32, device="cpu", sync_backend=LoopbackBackend())
    batches = _batches(7, 2)
    for b in batches:
        q.update(torch.from_numpy(b["vals"]), stream_ids=torch.from_numpy(b["ids"]))
    _assert_bitwise(_fed_quantile(batches).compute(), q.compute())


def test_forward_returns_the_batch_value_per_stream():
    m = MultiStreamMetric(T.MeanSquaredError(device="cpu"), num_streams=S, device="cpu")
    b = _batches(8, 1)[0]
    batch_value = m(torch.from_numpy(b["vals"]), torch.from_numpy(b["vals2"]), stream_ids=torch.from_numpy(b["ids"]))
    _assert_bitwise(batch_value, m.compute())
    assert batch_value.shape == (S,)
