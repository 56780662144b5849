"""The port's ``ColumnRing`` (``metrics_tpu_torch.serve.columnar``): wraparound, two-phase drain/commit,
backpressure, validation.

Mirrors ``tests/serve/test_columnar.py`` case for case (the ring is host
numpy, no device), then drives the port's ring and the JAX package's with
one seeded sequence of framed and unframed puts, drains, partial commits
and parks: every call returns the same thing on both.
"""

import threading

import numpy as np
import pytest

from metrics_tpu.serve import ColumnRing as JColumnRing
from metrics_tpu_torch.obs import counter_value
from metrics_tpu_torch.serve import ColumnRing
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError


def _put(ring, values, ids=None):
    cols = [np.asarray(values, np.float32), -np.asarray(values, np.float32)]
    return ring.put(cols, None if ids is None else np.asarray(ids, np.int32))


class TestPutDrainCommit:
    def test_roundtrip_preserves_rows_and_order(self):
        ring = ColumnRing(arity=2, capacity=16, with_ids=True)
        _put(ring, [1, 2, 3], ids=[10, 11, 12])
        _put(ring, [4, 5], ids=[13, 14])
        views, ids, n = ring.drain(timeout=0.0)
        assert n == 5
        assert views[0].tolist() == [1, 2, 3, 4, 5]
        assert views[1].tolist() == [-1, -2, -3, -4, -5]
        assert ids.tolist() == [10, 11, 12, 13, 14]
        ring.commit(n)
        assert ring.depth() == 0

    def test_empty_put_is_a_noop(self):
        ring = ColumnRing(arity=1, capacity=4)
        assert ring.put([np.float32([])])
        assert ring.depth() == 0

    def test_drain_timeout_returns_none(self):
        ring = ColumnRing(arity=1, capacity=4)
        assert ring.drain(timeout=0.0) is None

    def test_wraparound_splits_into_two_contiguous_drains(self):
        ring = ColumnRing(arity=1, capacity=8)
        assert ring.put([np.arange(6, dtype=np.float32)])
        views, _ids, n = ring.drain(timeout=0.0)
        ring.commit(n)  # tail now at 6
        # 5 rows land as 2 at the end + 3 wrapped to the front
        assert ring.put([np.arange(10, 15, dtype=np.float32)])
        views, _ids, n = ring.drain(timeout=0.0)
        assert n == 2 and views[0].tolist() == [10.0, 11.0]
        ring.commit(n)
        views, _ids, n = ring.drain(timeout=0.0)
        assert n == 3 and views[0].tolist() == [12.0, 13.0, 14.0]
        ring.commit(n)

    def test_max_rows_caps_a_drain(self):
        ring = ColumnRing(arity=1, capacity=8)
        ring.put([np.arange(6, dtype=np.float32)])
        views, _ids, n = ring.drain(timeout=0.0, max_rows=4)
        assert n == 4 and views[0].tolist() == [0.0, 1.0, 2.0, 3.0]
        ring.commit(n)

    def test_commit_zero_parks_the_rows_for_retry(self):
        # the forwarder's park-and-retry path: a dead worker refuses the
        # batch, commit(0) keeps the rows buffered, the next drain
        # returns the very same rows
        ring = ColumnRing(arity=1, capacity=8)
        ring.put([np.float32([7, 8, 9])])
        first, _ids, n = ring.drain(timeout=0.0)
        assert first[0].tolist() == [7.0, 8.0, 9.0]
        ring.commit(0)
        assert ring.depth() == 3
        again, _ids, n2 = ring.drain(timeout=0.0)
        assert n2 == n and again[0].tolist() == [7.0, 8.0, 9.0]
        ring.commit(n2)

    def test_partial_commit_releases_a_prefix(self):
        ring = ColumnRing(arity=1, capacity=8)
        ring.put([np.arange(5, dtype=np.float32)])
        _views, _ids, n = ring.drain(timeout=0.0)
        ring.commit(2)
        views, _ids, n = ring.drain(timeout=0.0)
        assert views[0].tolist() == [2.0, 3.0, 4.0]
        ring.commit(n)

    def test_uncommitted_rows_block_overwrite_and_redrain(self):
        ring = ColumnRing(arity=1, capacity=4)
        ring.put([np.float32([1, 2, 3])])
        views, _ids, _n = ring.drain(timeout=0.0)
        with pytest.raises(MetricsTPUUserError):
            ring.drain(timeout=0.0)  # one outstanding drain at a time
        # pending rows still occupy capacity: a 2-row put cannot fit
        assert not ring.put([np.float32([8, 9])])
        assert views[0].tolist() == [1.0, 2.0, 3.0]  # views never clobbered

    def test_drain_wakes_on_concurrent_put(self):
        ring = ColumnRing(arity=1, capacity=4)
        timer = threading.Timer(0.05, lambda: ring.put([np.float32([5.0])]))
        timer.start()
        try:
            out = ring.drain(timeout=5.0)
        finally:
            timer.cancel()
        assert out is not None and out[0][0].tolist() == [5.0]
        ring.commit(out[2])


class TestBackpressure:
    def test_overfull_batch_rejected_whole(self):
        ring = ColumnRing(arity=1, capacity=4)
        before = counter_value("serve.records_rejected", reason="ring_full")
        assert ring.put([np.float32([1, 2, 3])])
        assert not ring.put([np.float32([4, 5])])  # only 1 slot free
        assert ring.depth() == 3  # nothing partially written
        assert (
            counter_value("serve.records_rejected", reason="ring_full")
            == before + 2
        )

    def test_burst_larger_than_ring_rejected(self):
        ring = ColumnRing(arity=1, capacity=4)
        before = counter_value("serve.records_rejected", reason="ring_burst")
        assert not ring.put([np.arange(5, dtype=np.float32)])
        assert (
            counter_value("serve.records_rejected", reason="ring_burst")
            == before + 5
        )


class TestValidation:
    def test_constructor_bounds(self):
        with pytest.raises(MetricsTPUUserError):
            ColumnRing(arity=0)
        with pytest.raises(MetricsTPUUserError):
            ColumnRing(arity=1, capacity=0)

    def test_ragged_and_mismatched_batches(self):
        ring = ColumnRing(arity=2, capacity=8, with_ids=True)
        with pytest.raises(MetricsTPUUserError):
            ring.put([np.float32([1.0])])  # wrong arity
        with pytest.raises(MetricsTPUUserError):
            ring.put(
                [np.float32([1, 2]), np.float32([1.0])], np.int32([0, 1])
            )  # ragged columns
        with pytest.raises(MetricsTPUUserError):
            ring.put(
                [np.float32([1, 2]), np.float32([3, 4])], np.int32([0])
            )  # ragged ids
        with pytest.raises(MetricsTPUUserError):
            ring.put([np.float32([1, 2]), np.float32([3, 4])])  # missing ids
        with pytest.raises(MetricsTPUUserError):
            ColumnRing(arity=1, capacity=8).put(
                [np.float32([1.0])], np.int32([0])
            )  # ids on a plain ring
        assert ring.depth() == 0  # raises never half-write

    def test_bad_commit_counts(self):
        ring = ColumnRing(arity=1, capacity=4)
        ring.put([np.float32([1.0])])
        _views, _ids, n = ring.drain(timeout=0.0)
        with pytest.raises(MetricsTPUUserError):
            ring.commit(n + 1)
        with pytest.raises(MetricsTPUUserError):
            ring.commit(-1)
        ring.commit(n)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def _result(out):
    """A ring call's result as plain data (views copied out)."""
    if out is None or isinstance(out, bool):
        return out
    cols, ids, n, *spans = out
    return ([c.tolist() for c in cols], None if ids is None else ids.tolist(), n, spans)


class TestParityWithJax:
    @pytest.mark.parametrize("seed", range(4))
    def test_one_op_sequence_same_results(self, seed):
        rng = np.random.default_rng(seed)
        rings = {pkg: cls(arity=2, capacity=32, with_ids=True) for pkg, cls in (("jax", JColumnRing), ("torch", ColumnRing))}
        seqs = {pkg: iter(range(10**6)) for pkg in rings}
        pending = 0
        for _ in range(300):
            op = rng.integers(0, 5)
            if op <= 1:  # a put, framed every other time
                n = int(rng.integers(0, 12))
                vals = (rng.integers(0, 64, n) / 8).astype(np.float32)
                ids = rng.integers(0, 9, n)
                framed = bool(rng.integers(0, 2))
                got = {
                    pkg: ring.put([vals, -vals], ids, frame=(lambda a, i, s=seqs[pkg]: next(s)) if framed else None)
                    for pkg, ring in rings.items()
                }
            elif pending == 0:  # a drain, whole frames or plain, capped at times
                max_rows = None if rng.integers(0, 2) else int(rng.integers(1, 9))
                frames = bool(rng.integers(0, 2))
                got = {
                    pkg: _result(ring.drain_frames(0.0, max_rows) if frames else ring.drain(0.0, max_rows))
                    for pkg, ring in rings.items()
                }
                pending = 0 if got["torch"] is None else got["torch"][2]
            else:  # commit all, a prefix, or park the drain
                n = int(rng.choice([pending, int(rng.integers(0, pending + 1)), 0]))
                got = {pkg: ring.commit(n) for pkg, ring in rings.items()}
                pending = 0
            assert got["torch"] == got["jax"]
            assert [r.depth() for r in rings.values()] == [rings["jax"].depth()] * 2
            assert rings["torch"].high_water() == rings["jax"].high_water()
