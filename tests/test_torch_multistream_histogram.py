"""``MultiStreamMetric(StreamingHistogram)`` in the port against the JAX package's, on the CPU.

The JAX package stacks every sketch base over the streams and runs the
base's update and compute under ``jax.vmap``: the histogram's sketch and its
``minv``/``maxv`` min/max states stack beside each other, and the NaN rows
that stage each stream's block drop out (``where(isfinite)``).  The port's
histogram takes the stacked ``(S, m)`` block in one batched ``kll_update`` and
reads every stream's edges and counts at once (``_stacked_compute``).

The same seeded batches, with ids out of range on both sides and one stream
that never gets a row, go through both packages.  Every state leaf (the
sketch's PRNG key included) and the computed edges and counts must match
bitwise, NaN signs included: the single-sketch histogram already matches
bitwise (``tests/test_torch_streaming.py``), and the stacked one keeps its
multiply-adds (``fma32``).  Checkpoints cross the packages both ways and the
streams carry on alike.  Two gloo ranks (this file run as a script:
``python tests/test_torch_multistream_histogram.py RANK STORE OUT``) sync
their halves and must hold what one process gets by merging the two ranks'
states in rank order.
"""

import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
S, B = 8, 96
EMPTY = S - 2  # the stream no row goes to
WORLD, LAUNCH_LIMIT = 2, 60.0
CONFIGS = {"bins20_cap16": dict(bins=20, capacity=16, max_items=4096), "bins5_cap64": dict(bins=5, capacity=64, max_items=1 << 12)}


def _batches(seed, n_batches=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        vals = np.round(rng.normal(size=B), 3).astype(np.float32)
        vals[::13] = np.nan
        vals[5], vals[6], vals[7] = -0.0, 0.0, np.inf
        ids = rng.integers(-1, S + 1, B)
        ids[ids == EMPTY] = S + 1  # out of range: dropped
        out.append((vals, ids))
    return out


def _port(config, **kw):
    import metrics_tpu_torch as T

    return T.MultiStreamMetric(T.StreamingHistogram(device="cpu", **config), num_streams=S, device="cpu", **kw)


def _jax(config):
    import metrics_tpu as J

    return J.MultiStreamMetric(J.StreamingHistogram(**config), num_streams=S)


def _feed_port(m, batches):
    for vals, ids in batches:
        m.update(torch.from_numpy(vals), stream_ids=torch.from_numpy(ids))


def _feed_jax(m, batches):
    import jax.numpy as jnp

    for vals, ids in batches:
        m.update(jnp.asarray(vals), stream_ids=jnp.asarray(ids))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_states(jm, tm):
    js, ts = jm.state_pytree(), tm.state_pytree()
    assert set(js) == set(ts) and {"minv", "maxv", "sketch__sk_key"} <= set(ts)
    assert int(js.pop("_update_count")) == int(ts.pop("_update_count"))
    for k in js:
        a, b = _np(js[k]), _np(ts[k])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


def _assert_values(want, got):
    for k in ("edges", "counts"):
        a, b = _np(want[k]), _np(got[k])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_histogram_streams_match_the_jax_package(name):
    config = CONFIGS[name]
    jm, tm = _jax(config), _port(config)
    batches = _batches(sorted(CONFIGS).index(name))
    _feed_jax(jm, batches)
    _feed_port(tm, batches)
    _assert_states(jm, tm)
    want, got = jm.compute(), tm.compute()
    _assert_values(want, got)
    assert got["edges"].shape == (S, config["bins"] + 1) and got["counts"].shape == (S, config["bins"])
    assert jm.dropped_rows() == tm.dropped_rows() > 0
    assert int(tm.stream_rows[EMPTY]) == 0 and float(got["counts"][EMPTY].abs().sum()) == 0.0
    # each stream's histogram is the single-sketch histogram's of that stream's rows, while nothing compacts
    if config["capacity"] >= 64:
        import metrics_tpu_torch as T

        for s in range(S):
            one = T.StreamingHistogram(device="cpu", **config)
            rows = [v[ids == s] for v, ids in batches if (ids == s).any()]
            if rows:
                one.update(torch.from_numpy(np.concatenate(rows)))
                value = one.compute()
                assert _np(value["edges"]).tobytes() == _np(got["edges"][s]).tobytes()
                np.testing.assert_array_equal(_np(value["counts"]), _np(got["counts"][s]))


def test_histogram_streams_compute_streams_and_the_codec_blob():
    from metrics_tpu.checkpoint import codec as jcodec
    from metrics_tpu_torch.checkpoint import codec as tcodec

    config = CONFIGS["bins20_cap16"]
    jm, tm = _jax(config), _port(config)
    batches = _batches(5, 2)
    _feed_jax(jm, batches)
    _feed_port(tm, batches)
    ids = np.array([3, EMPTY, 0, 3])
    got = tm.compute_streams(torch.from_numpy(ids))
    for k in ("edges", "counts"):
        assert _np(got[k]).tobytes() == _np(tm.compute()[k])[ids].tobytes()
    jenc, tenc = jcodec.encode_metric(jm), tcodec.encode_metric(tm)
    assert tenc.kinds == jenc.kinds and tenc.digests == jenc.digests and tenc.blob == jenc.blob


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_histogram_stream_checkpoints_cross_the_packages(tmp_path, direction):
    from metrics_tpu.checkpoint import CheckpointManager as JManager
    from metrics_tpu_torch.checkpoint import CheckpointManager as TManager

    config = CONFIGS["bins20_cap16"]
    batches = _batches(11, 5)
    jm, tm = _jax(config), _port(config)
    src, dst = (jm, tm) if direction == "jax_to_port" else (tm, jm)
    (_feed_jax if src is jm else _feed_port)(src, batches[:3])
    (JManager if src is jm else TManager)(str(tmp_path), rank=0, world_size=1).save(src)
    result = (TManager if dst is tm else JManager)(str(tmp_path), rank=0, world_size=1).restore(dst)
    assert result.step == 0 and not result.reset_metrics and not result.skipped_states
    _assert_states(jm, tm)
    _feed_jax(jm, batches[3:])  # the restored side and the other carry on alike
    _feed_port(tm, batches[3:])
    _assert_states(jm, tm)
    _assert_values(jm.compute(), tm.compute())


# ------------------------------------------------------------------ two gloo ranks
def _shard(rank: int) -> list:
    return _batches(21, 4)[rank::WORLD]


def _worker(rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    m = _port(CONFIGS["bins20_cap16"])
    _feed_port(m, _shard(rank))
    local = {k: _np(v).copy() for k, v in m.state_pytree().items()}
    value = m.compute()  # synced over the group, then the local state comes back
    saved = {"value." + k: _np(v) for k, v in value.items()}
    with m.sync_context():
        saved.update({"state." + k: _np(v).copy() for k, v in m.state_pytree().items() if k != "_update_count"})
    after = m.state_pytree()
    saved["local_kept"] = np.array(all(_np(after[k]).tobytes() == local[k].tobytes() for k in local))
    np.savez(out / f"rank{rank}.npz", **saved)
    dist.destroy_process_group()


def test_two_gloo_ranks_sync_histogram_streams_as_one_process_merges_them(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    deadline = time.monotonic() + LAUNCH_LIMIT
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(tmp_path / "store"), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(WORLD)]
    # meanwhile, one process: rank 0's state with rank 1's merged into it (sketches slot-wise, min, max, sums)
    ranks = []
    for rank in range(WORLD):
        m = _port(CONFIGS["bins20_cap16"])
        _feed_port(m, _shard(rank))
        ranks.append(m)
    ranks[0].merge_state(ranks[1].state_pytree())
    want = {"state." + k: _np(v) for k, v in ranks[0].state_pytree().items() if k != "_update_count"}
    want.update({"value." + k: _np(v) for k, v in ranks[0].compute().items()})
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} exited {proc.returncode}:\n{log}"
    for rank in range(WORLD):
        got = dict(np.load(out / f"rank{rank}.npz"))
        assert bool(got.pop("local_kept")), f"rank {rank}: compute() left the synced state in place"
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), (rank, k)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))
