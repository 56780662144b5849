"""Checkpoints cross between ``metrics_tpu`` and ``metrics_tpu_torch``, both ways, on the CPU.

The codec's per-state blobs and their blake2b digests must be byte-equal to
the JAX package's for every state kind (tensor, list, buffer, sketch, the
``__meta__`` pseudo-state, bf16 and 0-d), so a shard either package wrote
verifies in the other.  A checkpoint written by one package's
``CheckpointManager`` must restore into the other's metrics with every state
bitwise, for a ``Metric``, a ``MetricCollection`` with compute groups, a
``MetricTracker``, a ``WindowedMetric`` ring, a ``StreamingQuantile`` and a
``MultiStreamMetric``, and feeding both the same batches after the restore
must give the uninterrupted run's states.  Every float input is a multiple of
1/8, so float sums are exact in any order and states are compared bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu.checkpoint import CheckpointManager as JManager
from metrics_tpu.checkpoint import codec as jcodec
from metrics_tpu_torch.checkpoint import CheckpointManager as TManager
from metrics_tpu_torch.checkpoint import codec as tcodec

CPU = {"device": "cpu"}
N = 24


def _data(seed, n_batches):
    rng = np.random.default_rng(seed)
    return [
        {
            "x": (rng.integers(-40, 40, N) / 8).astype(np.float32),
            "p": (rng.integers(0, 9, N) / 8).astype(np.float32),
            "y": rng.integers(0, 2, N),
            "a": rng.integers(0, 3, N),
            "b": rng.integers(0, 3, N),
            "ids": rng.integers(0, 5, N),
        }
        for _ in range(n_batches)
    ]


def _in(pkg, x):
    return jnp.asarray(x) if pkg is J else torch.from_numpy(np.ascontiguousarray(x))


def _kw(pkg):
    return {} if pkg is J else CPU


# ---------------------------------------------------------------- targets
def _metric(pkg):
    return pkg.Accuracy(num_classes=3, **_kw(pkg))


def _feed_metric(pkg, m, b):
    m.update(_in(pkg, b["a"]), _in(pkg, b["b"]))


def _collection(pkg):
    return pkg.MetricCollection(
        {
            "p": pkg.Precision(num_classes=3, average="macro", **_kw(pkg)),
            "r": pkg.Recall(num_classes=3, average="macro", **_kw(pkg)),
            "mean": pkg.MeanMetric(**_kw(pkg)),
            "cat": pkg.CatMetric(**_kw(pkg)),
            "auroc": pkg.AUROC(**_kw(pkg)),
        },
        compute_groups=True,
        **_kw(pkg),
    )


def _feed_collection(pkg, col, b):
    col["p"].update(_in(pkg, b["a"]), _in(pkg, b["b"]))
    col["r"].update(_in(pkg, b["a"]), _in(pkg, b["b"]))
    col["mean"].update(_in(pkg, b["x"]))
    col["cat"].update(_in(pkg, b["x"]))
    col["auroc"].update(_in(pkg, b["p"]), _in(pkg, b["y"]))


def _tracker(pkg):
    return pkg.MetricTracker(pkg.MeanMetric(**_kw(pkg)), maximize=True)


def _feed_tracker(pkg, tr, b):
    tr.increment()
    tr.update(_in(pkg, b["x"]))


def _window(pkg):
    return pkg.WindowedMetric(pkg.MeanMetric(**_kw(pkg)), window_size=3, **_kw(pkg))


def _feed_window(pkg, w, b):
    w.update(_in(pkg, b["x"]))
    w.advance()


def _quantile(pkg):
    return pkg.StreamingQuantile(q=(0.1, 0.5), capacity=8, max_items=1 << 10, **_kw(pkg))


def _feed_quantile(pkg, q, b):
    q.update(_in(pkg, b["x"]))


def _multistream(pkg):
    return pkg.MultiStreamMetric(pkg.Accuracy(num_classes=3, **_kw(pkg)), num_streams=5, **_kw(pkg))


def _feed_multistream(pkg, m, b):
    m.update(_in(pkg, b["a"]), _in(pkg, b["b"]), stream_ids=_in(pkg, b["ids"]))


def _multistream_quantile(pkg):
    return pkg.MultiStreamMetric(pkg.StreamingQuantile(capacity=8, max_items=1 << 10, **_kw(pkg)), num_streams=5, **_kw(pkg))


def _feed_multistream_quantile(pkg, m, b):
    m.update(_in(pkg, b["x"]), stream_ids=_in(pkg, b["ids"]))


TARGETS = {
    "metric": (_metric, _feed_metric),
    "collection": (_collection, _feed_collection),
    "tracker": (_tracker, _feed_tracker),
    "window": (_window, _feed_window),
    "quantile": (_quantile, _feed_quantile),
    "multistream": (_multistream, _feed_multistream),
    "multistream_quantile": (_multistream_quantile, _feed_multistream_quantile),
}


def _flat(pkg, target):
    from metrics_tpu.checkpoint import flatten_target as jflat
    from metrics_tpu_torch.checkpoint import flatten_target as tflat

    return (jflat if pkg is J else tflat)(target)


def _states(pkg, target):
    out = {}
    for key, m in _flat(pkg, target).items():
        for name, v in m.state_pytree().items():
            arr = np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()
            if isinstance(v, list):  # an empty list state
                arr = np.zeros((0,), np.float32)
            out[f"{key}.{name}"] = arr
    return out


def _assert_same(j_target, t_target):
    js, ts = _states(J, j_target), _states(T, t_target)
    assert set(js) == set(ts)
    for k in js:
        a, b = np.asarray(js[k]), np.asarray(ts[k])
        if k.endswith("._update_count"):
            assert int(a) == int(b), k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", sorted(TARGETS))
def test_a_checkpoint_crosses_and_resumes_bitwise(tmp_path, name, direction):
    make, feed = TARGETS[name]
    batches = _data(sorted(TARGETS).index(name), 5)
    src_pkg, dst_pkg = (J, T) if direction == "jax_to_port" else (T, J)
    Manager = {J: JManager, T: TManager}
    src = make(src_pkg)
    for b in batches[:3]:
        feed(src_pkg, src, b)
    Manager[src_pkg](str(tmp_path), rank=0, world_size=1).save(src)
    dst = make(dst_pkg)
    result = Manager[dst_pkg](str(tmp_path), rank=0, world_size=1).restore(dst)
    assert result.step == 0 and not result.reset_metrics and not result.skipped_states
    jt, tt = (src, dst) if src_pkg is J else (dst, src)
    _assert_same(jt, tt)
    # the restored side and an uninterrupted twin of the other package carry on alike
    for b in batches[3:]:
        feed(J, jt, b)
        feed(T, tt, b)
    _assert_same(jt, tt)


class _JBf16(J.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("h", jnp.zeros((), jnp.bfloat16), dist_reduce_fx="sum")
        self.add_state("v", jnp.zeros((3,), jnp.bfloat16), dist_reduce_fx="sum")

    def update(self, x):
        self.h = self.h + jnp.asarray(x, jnp.bfloat16).sum()
        self.v = self.v + jnp.asarray(x, jnp.bfloat16)[:3]

    def compute(self):
        return self.h


class _TBf16(T.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("h", torch.zeros((), dtype=torch.bfloat16), dist_reduce_fx="sum")
        self.add_state("v", torch.zeros((3,), dtype=torch.bfloat16), dist_reduce_fx="sum")

    def update(self, x):
        self.h = self.h + x.to(torch.bfloat16).sum()
        self.v = self.v + x.to(torch.bfloat16)[:3]

    def compute(self):
        return self.h


KINDS = {
    "tensor": (lambda p: p.MeanMetric(**_kw(p)), lambda p, m, b: m.update(_in(p, b["x"]))),
    "list": (lambda p: p.CatMetric(**_kw(p)), lambda p, m, b: m.update(_in(p, b["x"]))),
    "list_empty": (lambda p: p.CatMetric(**_kw(p)), None),
    "buffer": (lambda p: p.AUROC(**_kw(p)), lambda p, m, b: m.update(_in(p, b["p"]), _in(p, b["y"]))),
    "sketch": (_quantile, _feed_quantile),
    "meta_mode": (_metric, _feed_metric),
    "bf16_and_0d": (lambda p: _JBf16() if p is J else _TBf16(**CPU), lambda p, m, b: m.update(_in(p, b["x"][:4]))),
    "stacked": (_multistream_quantile, _feed_multistream_quantile),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_codec_blobs_and_digests_equal_the_jax_package(kind):
    make, feed = KINDS[kind]
    jm, tm = make(J), make(T)
    for b in _data(7, 2 if feed else 0):
        feed(J, jm, b)
        feed(T, tm, b)
    jenc, tenc = jcodec.encode_metric(jm), tcodec.encode_metric(tm)
    assert tenc.kinds == jenc.kinds
    assert tenc.digests == jenc.digests
    assert tenc.blob == jenc.blob
    assert tenc.update_count == jenc.update_count
    # each package decodes the other's blob and verifies its digests
    tdec = tcodec.decode_metric(jenc.blob, jenc.digests)
    jdec = jcodec.decode_metric(tenc.blob, tenc.digests)
    assert not tdec.failed and not jdec.failed
    fresh = make(T)
    fresh.load_state_pytree(tcodec.arrays_to_pytree(fresh, tdec.arrays))
    assert tcodec.encode_metric(fresh).blob == jenc.blob


def test_a_sketch_key_packs_as_uint32():
    q = _quantile(T)
    arrays = tcodec.SERIALIZERS["sketch"].to_arrays(q, q.state_pytree(), "sketch")
    assert arrays["sketch__sk_key"].dtype == torch.uint32
    blob = tcodec._pack_state_blob(arrays)
    assert b"uint32" in blob and tcodec._unpack_state_blob(blob)["sketch__sk_key"].dtype == torch.uint32


def test_a_digest_mismatch_names_the_state():
    m = T.MeanMetric(**CPU)
    m.update(torch.tensor([1.0, 2.0]))
    enc = tcodec.encode_metric(m)
    digests = dict(enc.digests, weight="0" * 32)
    dec = tcodec.decode_metric(enc.blob, digests)
    assert dec.failed == ["weight"] and set(dec.arrays) == {"mean_value", "__meta__"}
    assert tcodec.decode_metric(b"garbage", enc.digests).failed == sorted(enc.digests)


def test_metric_transfer_round_trip_and_refusal():
    from metrics_tpu_torch.checkpoint.manager import apply_metric_transfer, encode_metric_transfer
    from metrics_tpu_torch.utils.exceptions import CheckpointIntegrityError

    src = _metric(T)
    for b in _data(9, 2):
        _feed_metric(T, src, b)
    payload = encode_metric_transfer(src)
    dst = _metric(T)
    apply_metric_transfer(dst, payload)
    assert torch.equal(src.compute(), dst.compute()) and dst.mode == src.mode
    bad = dict(payload, digests={k: "0" * 32 for k in payload["digests"]})
    with pytest.raises(CheckpointIntegrityError):
        apply_metric_transfer(_metric(T), bad)
