"""Two processes syncing the port's regression metrics over ``torch.distributed`` (gloo) on the CPU.

Each scenario runs two ranks of this file as a script (``python
tests/test_torch_regression_ddp.py SCENARIO RANK STORE OUT``) that meet
through a ``FileStore`` in a temporary directory and write what they saw
under ``OUT``.  Both launches start together, each with a hard time limit.

* ``union``: a ``MetricCollection`` of ``MeanSquaredError``,
  ``MeanAbsoluteError``, ``R2Score``, ``PearsonCorrCoef`` and
  ``SpearmanCorrCoef``, and a ``CosineSimilarity``, on uneven shards.
  Pearson's synced value equals the JAX package's ``_final_aggregation`` of
  the same per-rank rows (the rows the ranks held before the sync) to
  ``CANCEL_ATOL``; the counts equal the JAX package's single-process pass
  bitwise; Spearman's and the cosine similarity's gathered rows are the
  single-process rows in rank order, so their values equal the port's own
  single-process values bitwise; float sums and scores hold to the
  tolerances of ``tests/test_torch_regression.py``.
* ``delta``: Pearson over three update-and-sync rounds: the delta cache
  refuses its prefix (the states are rewritten, not appended to) and every
  round equals a ``delta_sync=False`` twin bitwise.
"""

import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
SIZES = (40, 40, 40, 17)
SHARDS = {0: (0,), 1: (1, 2, 3)}  # uneven: 40 rows on rank 0, 97 on rank 1
WIDTH = 6  # the cosine similarity's row width
LAUNCH_LIMIT = 60.0
U = 2.0**-24
CANCEL_ATOL = 8 * sum(SIZES) * WIDTH * U
SUM_RTOL = sum(SIZES) * WIDTH * U


def _batches(seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for size in SIZES:
        target = rng.standard_normal(size)
        preds = np.round(target + 0.5 * rng.standard_normal(size), 1)  # ties for the ranks
        emb_t = rng.standard_normal((size, WIDTH))
        emb_p = emb_t + 0.3 * rng.standard_normal((size, WIDTH))
        out.append(tuple(a.astype(np.float32) for a in (preds, target, emb_p, emb_t)))
    return out


def _collection(pkg, **kwargs):
    return pkg.MetricCollection(
        {
            "mse": pkg.MeanSquaredError(**kwargs),
            "mae": pkg.MeanAbsoluteError(**kwargs),
            "r2": pkg.R2Score(**kwargs),
            "pearson": pkg.PearsonCorrCoef(**kwargs),
            "spearman": pkg.SpearmanCorrCoef(**kwargs),
        },
        **({"device": "cpu"} if pkg.__name__ == "metrics_tpu_torch" else {}),
    )


PEARSON = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


# ------------------------------------------------------------------ ranks
def _rank_union(rank: int, out: Path) -> None:
    import metrics_tpu_torch as mt

    col = _collection(mt, device="cpu")
    cos = mt.CosineSimilarity(reduction="mean", device="cpu")
    batches = _batches()
    for i in SHARDS[rank]:
        preds, target, emb_p, emb_t = batches[i]
        col.update(torch.from_numpy(preds), torch.from_numpy(target))
        cos.update(torch.from_numpy(emb_p), torch.from_numpy(emb_t))
    rows = {f"row.{n}": getattr(col["pearson"], n).clone() for n in PEARSON}
    results = {f"col.{k}": v for k, v in col.compute().items()}
    results["cos"] = cos.compute()
    with col["mse"].sync_context():
        results["mse.total"] = col["mse"].total.clone()
        results["mse.sum"] = col["mse"].sum_squared_error.clone()
    with col["spearman"].sync_context():
        results["spearman.preds"] = col["spearman"].buffer_values("preds").clone()
    with cos.sync_context():
        results["cos.preds"] = cos.buffer_values("preds").clone()
    np.savez(out / f"rank{rank}.npz", **{k: v.numpy() for k, v in {**results, **rows}.items()})
    (out / f"rank{rank}.json").write_text(json.dumps({"local": not any(m._is_synced for m in col.values())}))


def _rank_delta(rank: int, out: Path) -> None:
    import metrics_tpu_torch as mt

    metric = mt.PearsonCorrCoef(device="cpu")
    twin = mt.PearsonCorrCoef(device="cpu", delta_sync=False)
    seen = []
    for rnd, (preds, target, _, _) in enumerate(_batches(1)[:3]):
        part = slice(0, 25) if rank == 0 else slice(25, None)
        for m in (metric, twin):
            m.update(torch.from_numpy(preds[part]), torch.from_numpy(target[part]))
        value, twin_value = metric.compute(), twin.compute()
        seen.append({"value": value.numpy().tobytes().hex(), "twin": twin_value.numpy().tobytes().hex(),
                     "delta": metric.last_sync_report["delta"], "float": float(value)})
    (out / f"rank{rank}.json").write_text(json.dumps(seen))


def _worker(scenario: str, rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    {"union": _rank_union, "delta": _rank_delta}[scenario](rank, out)
    dist.destroy_process_group()


# ------------------------------------------------------------------ tests
class _Launch:
    """Both ranks of one scenario, started at once."""

    def __init__(self, scenario: str, where: Path):
        self.scenario, self.out = scenario, where / "out"
        self.out.mkdir()
        env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
        self.deadline = time.monotonic() + LAUNCH_LIMIT
        self.procs = [
            subprocess.Popen(
                [sys.executable, __file__, scenario, str(rank), str(where / "store"), str(self.out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in range(WORLD)
        ]

    def result(self) -> Path:
        """Wait for both ranks; fail on a non-zero exit or past the time limit."""
        try:
            logs = [p.communicate(timeout=max(self.deadline - time.monotonic(), 1.0))[0] for p in self.procs]
        finally:
            for proc in self.procs:
                proc.kill()
        for rank, (proc, log) in enumerate(zip(self.procs, logs)):
            assert proc.returncode == 0, f"rank {rank} of {self.scenario} exited {proc.returncode}:\n{log}"
        return self.out


_LAUNCHED: dict = {}


def _launched(tmp_path_factory, scenario: str) -> _Launch:
    """Both scenarios' ranks, all started by the first test that asks."""
    if not _LAUNCHED:
        _LAUNCHED.update({s: _Launch(s, tmp_path_factory.mktemp(s)) for s in ("union", "delta")})
    return _LAUNCHED[scenario]


def _close(have, want, rtol=0.0, atol=0.0, key=""):
    have, want = np.asarray(have), np.asarray(want)
    assert have.shape == want.shape and have.dtype == want.dtype, key
    np.testing.assert_allclose(have, want, rtol=rtol, atol=atol, err_msg=key)


def test_two_ranks_sync_regression_like_the_jax_package(tmp_path_factory):
    import jax.numpy as jnp

    import metrics_tpu as jm
    import metrics_tpu_torch as mt
    from metrics_tpu.functional.regression.pearson import _pearson_corrcoef_compute as jax_pearson_compute
    from metrics_tpu.regression.pearson import _final_aggregation as jax_final_aggregation

    launch = _launched(tmp_path_factory, "union")  # the references below run while the ranks do
    eager = {"jit_update": False, "jit_compute": False}
    batches = _batches()
    ref_col, ref_cos = _collection(jm, **eager), jm.CosineSimilarity(reduction="mean", **eager)
    one_col, one_cos = _collection(mt, device="cpu"), mt.CosineSimilarity(reduction="mean", device="cpu")
    for preds, target, emb_p, emb_t in batches:  # the union, in rank order
        ref_col.update(jnp.asarray(preds), jnp.asarray(target))
        ref_cos.update(jnp.asarray(emb_p), jnp.asarray(emb_t))
        one_col.update(torch.from_numpy(preds), torch.from_numpy(target))
        one_cos.update(torch.from_numpy(emb_p), torch.from_numpy(emb_t))
    ref = {f"col.{k}": np.asarray(v) for k, v in ref_col.compute().items()}
    one = {f"col.{k}": v.numpy() for k, v in one_col.compute().items()}
    out = launch.result()
    got = [dict(np.load(out / f"rank{rank}.npz")) for rank in range(WORLD)]
    rows = {n: np.concatenate([got[rank][f"row.{n}"] for rank in range(WORLD)]) for n in PEARSON}
    merged = jax_final_aggregation(*(jnp.asarray(rows[n]) for n in PEARSON))
    pearson_ref = np.asarray(jax_pearson_compute(*merged))
    for rank in range(WORLD):
        res = got[rank]
        assert json.loads((out / f"rank{rank}.json").read_text())["local"], "compute() left a rank synced"
        _close(res["col.pearson"], pearson_ref, atol=CANCEL_ATOL, key="pearson vs the JAX merge of the rows")
        _close(res["col.pearson"], ref["col.pearson"], atol=CANCEL_ATOL, key="pearson vs one JAX process")
        assert res["mse.total"].dtype == np.int32 and int(res["mse.total"]) == int(ref_col["mse"]._state["total"]) == sum(SIZES)
        _close(res["mse.sum"], np.asarray(ref_col["mse"]._state["sum_squared_error"]), rtol=SUM_RTOL, key="mse sum")
        for key in ("col.mse", "col.mae"):
            _close(res[key], ref[key], rtol=SUM_RTOL, key=key)
        _close(res["col.r2"], ref["col.r2"], atol=CANCEL_ATOL, key="r2")
        # the gathered rows are the single process's rows in rank order: the values are its values
        assert res["spearman.preds"].tobytes() == np.concatenate([b[0] for b in batches]).tobytes()
        assert res["cos.preds"].tobytes() == np.concatenate([b[2] for b in batches]).tobytes()
        assert res["col.spearman"].tobytes() == one["col.spearman"].tobytes()
        assert res["cos"].tobytes() == one_cos.compute().numpy().tobytes()
        _close(res["col.spearman"], ref["col.spearman"], atol=CANCEL_ATOL, key="spearman")
        _close(res["cos"], np.asarray(ref_cos.compute()), atol=(sum(SIZES) + 32) * U, key="cosine")
        for key in res:
            assert res[key].tobytes() == got[0][key].tobytes() or key.startswith("row."), f"{key}: ranks differ"


def test_pearson_delta_rounds_equal_a_full_gather_twin(tmp_path_factory):
    out = _launched(tmp_path_factory, "delta").result()
    seen = [json.loads((out / f"rank{rank}.json").read_text()) for rank in range(WORLD)]
    for rnd in range(3):
        for rank in range(WORLD):
            step = seen[rank][rnd]
            assert step["delta"] is False, (rank, rnd)  # overwritten states: never a delta round
            assert step["value"] == step["twin"] == seen[0][rnd]["value"], (rank, rnd)
    assert len({step["float"] for step in seen[0]}) == 3  # each round moved the value


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
