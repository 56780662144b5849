"""The port's sync layer against the JAX package's, in one process on the CPU.

* The packed state blob is byte-for-byte the JAX package's (the serve tier's
  write-ahead log will read one package's blobs with the other).
* Schema entries and their digests are equal for the same metric, so the two
  packages' preflights agree.
* ``ChaosBackend`` schedules give the same exception, the same ``injected``
  log, the same result and the same report fields in both packages: the
  port issues its collectives in the JAX package's order.  Each case of
  ``tests/bases/test_fault_injection.py`` runs over a ``LoopbackBackend``
  inner (real gather accounting), and the cases whose outcome it changes
  over a ``NullBackend`` inner too (simulated peers, where a scheduled desync
  raises).
* Delta sync of a ``CatMetric`` over five rounds: values equal a
  ``delta_sync=False`` twin and the JAX package every round, and
  ``bytes_gathered`` equals the JAX package's round by round.
* The aggregation metrics over each NaN strategy.

Floats compare to ``rtol=1e-6`` (float32 on both sides; torch and XLA may
sum in another order), integers and bytes exactly.
"""

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import ml_dtypes
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.parallel as jp
import metrics_tpu_torch as mt
import metrics_tpu_torch.parallel as tp
from metrics_tpu.metric import _pack_state_blob as jax_pack
from metrics_tpu_torch.metric import _pack_state_blob, _unpack_state_blob

REPORT_FIELDS = (
    "gather_calls", "bytes_gathered", "preflight_calls", "preflight_bytes",
    "attempts", "retries", "fallback", "delta", "world_size", "backend",
)
ERROR_ATTRS = ("rank", "state", "timeout", "attempts", "synced_states", "phase", "problem")
DROP_TIMEOUT = 0.05  # a dropped collective never completes: any watchdog fires
# the JAX reference runs eagerly (the same values, without a jit compile per instance)
EAGER = {"jit_update": False, "jit_compute": False}


def _as_numpy(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _as_numpy(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, list):
        return value
    return np.asarray(value)


def assert_same(port: Any, ref: Any) -> None:
    port, ref = _as_numpy(port), _as_numpy(ref)
    if isinstance(ref, dict):
        assert port.keys() == ref.keys()
        for key in ref:
            assert_same(port[key], ref[key])
        return
    if isinstance(ref, list):
        assert port == ref
        return
    assert port.shape == ref.shape and port.dtype == ref.dtype, (port.dtype, ref.dtype)
    if np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0, equal_nan=True)
    else:
        np.testing.assert_array_equal(port, ref)


# ------------------------------------------------------------- packed blob
BLOB_DTYPES = {
    "int32": (np.int32, torch.int32),
    "int64": (np.int64, torch.int64),
    "float32": (np.float32, torch.float32),
    "bool": (np.bool_, torch.bool),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
}
BLOB_SHAPES = {"0-d": (), "empty": (0, 3), "2-D": (3, 4)}


def _blob_arrays(dtype_name: str, shape: Tuple[int, ...]) -> Tuple[Dict[str, np.ndarray], Dict[str, torch.Tensor]]:
    np_dtype, torch_dtype = BLOB_DTYPES[dtype_name]
    values = np.asarray((np.arange(int(np.prod(shape))).reshape(shape) % 7 - 3) / 4)  # quarters: exact in bfloat16
    ref = {"r.x": values.astype(np_dtype), "c.rows": np.arange(5, dtype=np.int32)}
    port = {"r.x": torch.from_numpy(values).to(torch_dtype), "c.rows": torch.arange(5, dtype=torch.int32)}
    return ref, port


@pytest.mark.parametrize("shape", BLOB_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", BLOB_DTYPES, ids=str)
def test_packed_blob_equals_the_jax_package_bytes(dtype, shape):
    ref, port = _blob_arrays(dtype, BLOB_SHAPES[shape])
    blob = jax_pack(ref)
    assert _pack_state_blob(port) == blob
    back = _unpack_state_blob(blob)
    for key, value in port.items():
        assert back[key].dtype == value.dtype and back[key].shape == value.shape
        assert torch.equal(back[key], value)


# ----------------------------------------------------------- schema digests
SCHEMA_METRICS = {
    "Accuracy": lambda pkg, **kw: pkg.Accuracy(num_classes=5, average="macro", **kw),
    "ConfusionMatrix": lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=5, **kw),
    "CatMetric": lambda pkg, **kw: pkg.CatMetric(**kw),
    "MeanMetric": lambda pkg, **kw: pkg.MeanMetric(**kw),
}


@pytest.mark.parametrize("name", SCHEMA_METRICS)
def test_schema_entries_and_digests_equal_the_jax_package(name):
    ref, port = SCHEMA_METRICS[name](jm, **EAGER), SCHEMA_METRICS[name](mt, device="cpu")
    if name in ("CatMetric", "MeanMetric"):
        ref.update(np.arange(3, dtype=np.float32))
        port.update(torch.arange(3, dtype=torch.float32))
    else:
        preds, target = np.array([0, 1, 2, 3, 4]), np.array([0, 1, 1, 4, 4])
        ref.update(preds, target)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    entries = port._schema_entries()
    assert entries == ref._schema_entries()
    np.testing.assert_array_equal(tp.schema_digest_rows(entries), jp.schema_digest_rows(entries))


# ---------------------------------------------------------------- chaos
@dataclass
class ChaosCase:
    make: Callable  # (pkg, **kwargs) -> metric
    schedule: Dict[int, Any]
    inputs: Tuple = ()
    timeout: Optional[float] = None
    retries: int = 0
    world: int = 2
    kwargs: Dict[str, Any] = field(default_factory=dict)


def _sum(pkg, **kw):
    return pkg.SumMetric(**kw)


def _mean(pkg, **kw):
    return pkg.MeanMetric(**kw)


FLOATS = (np.array([1.0, 2.5], np.float32), np.array([-0.5], np.float32))

CHAOS_CASES = {
    "timeout": ChaosCase(_sum, {0: ("drop", 30.0)}, FLOATS, timeout=DROP_TIMEOUT),
    "timeout_names_state": ChaosCase(_sum, {1: ("drop", 30.0)}, FLOATS, timeout=DROP_TIMEOUT),
    "retry_then_succeed": ChaosCase(_sum, {0: ("delay", 1.0)}, FLOATS, timeout=0.1, retries=1),
    "transient_rethrow": ChaosCase(_sum, {0: "error", 1: "error"}, FLOATS, timeout=1.0),
    "desync": ChaosCase(_sum, {0: "desync"}, FLOATS, world=4),
    "corrupt_validated": ChaosCase(_mean, {1: "corrupt"}, FLOATS, kwargs={"validate_sync": True}),
    "corrupt_unvalidated": ChaosCase(_mean, {1: "corrupt"}, FLOATS),
    "local": ChaosCase(_sum, {0: ("drop", 30.0)}, FLOATS, timeout=DROP_TIMEOUT, kwargs={"on_sync_error": "local"}),
    "skip": ChaosCase(_sum, {0: ("drop", 30.0)}, FLOATS, timeout=DROP_TIMEOUT, kwargs={"on_sync_error": "skip"}),
    "local_on_desync": ChaosCase(_sum, {0: "desync"}, FLOATS, kwargs={"on_sync_error": "local"}),
    "clean": ChaosCase(_mean, {}, FLOATS),
}
INNERS = {"loopback": "LoopbackBackend", "null": "NullBackend"}


def _chaos(parallel, inner: str, case: ChaosCase, packed: bool = False):
    return parallel.ChaosBackend(
        getattr(parallel, INNERS[inner])(),
        schedule=dict(case.schedule),
        world_size=case.world,
        options=parallel.SyncOptions(timeout=case.timeout, max_retries=case.retries, backoff=0.01),
        packed=packed,
    )


def _outcome(compute: Callable[[], Any]) -> Dict[str, Any]:
    """What a compute gives: its value or its exception (class name and attributes), and its warnings."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value, error = compute(), None
        except Exception as err:  # noqa: BLE001 — the class is what is compared
            value, error = None, err
    out = {
        "value": value,
        "error": type(error).__name__ if error is not None else None,
        "warned": any("falling back" in str(w.message) for w in caught),
    }
    if error is not None:
        out["attrs"] = {a: getattr(error, a) for a in ERROR_ATTRS if hasattr(error, a)}
    return out


def _run_chaos(pkg, parallel, inner: str, case: ChaosCase, **metric_kwargs):
    chaos = _chaos(parallel, inner, case)
    metric = case.make(pkg, sync_backend=chaos, **case.kwargs, **metric_kwargs)
    for x in case.inputs:
        metric.update(x)
    out = _outcome(metric.compute)
    report = metric.last_sync_report or {}
    out["report"] = {k: report.get(k) for k in REPORT_FIELDS}
    out["error_text"] = (report.get("error") or "").split(":")[0]
    out["injected"] = list(chaos.injected)
    return out


# every case over a LoopbackBackend inner; over a NullBackend inner the cases whose
# outcome it changes (a desync raises; the chaos layer counts the bytes itself)
CHAOS_RUNS = [(case, "loopback") for case in CHAOS_CASES] + [
    (case, "null") for case in ("desync", "local_on_desync", "corrupt_validated", "clean", "timeout")
]


@pytest.mark.parametrize("case, inner", CHAOS_RUNS, ids=[f"{c}-{i}" for c, i in CHAOS_RUNS])
def test_chaos_schedule_gives_the_jax_package_outcome(case, inner):
    ref = _run_chaos(jm, jp, inner, CHAOS_CASES[case], **EAGER)
    port = _run_chaos(mt, tp, inner, CHAOS_CASES[case], device="cpu")
    for key in ("error", "attrs", "warned", "report", "error_text", "injected"):
        assert port.get(key) == ref.get(key), key
    if ref["value"] is None:
        assert port["value"] is None
    else:
        assert_same(port["value"], ref["value"])


def _collection(pkg, parallel, **kwargs):
    case = CHAOS_CASES["local"]
    return pkg.MetricCollection(
        {
            "acc": pkg.Accuracy(num_classes=3, sync_backend=parallel.LoopbackBackend(), **kwargs),
            "mean": pkg.MeanMetric(sync_backend=_chaos(parallel, "loopback", case), **kwargs),
            "sum": pkg.SumMetric(sync_backend=parallel.LoopbackBackend(), **kwargs),
        },
        compute_groups=False,
        on_sync_error="local",
        sync_timeout=DROP_TIMEOUT,
        validate_sync=True,
        **({"device": kwargs["device"]} if "device" in kwargs else {}),
    )


def test_collection_policy_and_aggregate_report_equal_the_jax_package():
    preds, target = np.array([0.0, 1.0, 2.0, 1.0], np.float32), np.array([0, 1, 1, 1])
    outs = {}
    for name, pkg, parallel, kwargs in (("ref", jm, jp, EAGER), ("port", mt, tp, {"device": "cpu"})):
        col = _collection(pkg, parallel, **kwargs)
        for m in col.values():
            assert (m.on_sync_error, m.sync_timeout, m.validate_sync) == ("local", DROP_TIMEOUT, True)
        col["acc"].update(preds.astype(np.int64), target)
        col["mean"].update(preds)
        col["sum"].update(preds)
        outs[name] = _outcome(col.compute)
        outs[name]["members"] = {
            k: {f: (r or {}).get(f) for f in REPORT_FIELDS} for k, r in col.last_sync_report.items()
        }
        agg = col.aggregate_sync_report()
        agg.pop("duration_secs")
        agg["errors"] = [(e["member"], e["error"].split(":")[0]) for e in agg["errors"]]
        outs[name]["aggregate"] = agg
        outs[name]["history"] = {k: len(v) for k, v in col.sync_report_history.items()}
    ref, port = outs["ref"], outs["port"]
    assert port["error"] is None and ref["error"] is None and port["warned"] and ref["warned"]
    assert port["members"] == ref["members"]
    assert port["history"] == ref["history"]
    assert {k: port["aggregate"][k] for k in ref["aggregate"] if k in port["aggregate"]} == {
        k: v for k, v in ref["aggregate"].items() if k in port["aggregate"]
    }
    assert port["aggregate"]["preflight_bytes"] == sum(
        m["preflight_bytes"] or 0 for m in port["members"].values()
    )
    assert_same(port["value"], ref["value"])
    with pytest.raises(ValueError, match="on_sync_error"):
        mt.MetricCollection({"s": mt.SumMetric(device="cpu")}, on_sync_error="explode", device="cpu")


# ------------------------------------------------------------- delta sync
def test_delta_sync_cat_metric_rounds_equal_the_jax_package():
    ref = jm.CatMetric(sync_backend=jp.LoopbackBackend(), **EAGER)
    port = mt.CatMetric(device="cpu", sync_backend=tp.LoopbackBackend())
    twin = mt.CatMetric(device="cpu", sync_backend=tp.LoopbackBackend(), delta_sync=False)
    rng = np.random.default_rng(0)
    port_bytes = []
    for step in range(5):
        rows = rng.standard_normal(4 + step).astype(np.float32)
        for m in (ref, port, twin):
            m.update(rows if m is ref else torch.from_numpy(rows))
            m._computed = None
        got, full, want = port.compute(), twin.compute(), ref.compute()
        assert torch.equal(got, full)
        assert_same(got, want)
        rep, jrep = port.last_sync_report, ref.last_sync_report
        assert {k: rep[k] for k in ("delta", "delta_round", "bytes_saved", "bytes_gathered", "gather_calls")} == {
            k: jrep[k] for k in ("delta", "delta_round", "bytes_saved", "bytes_gathered", "gather_calls")
        }
        assert rep["delta"] is (step > 0) and "delta" not in twin.last_sync_report
        port_bytes.append(rep["bytes_gathered"])
    # the blob carries only this round's rows: one row more per round, never the history
    assert np.diff(port_bytes).tolist() == [4] * 4


@pytest.mark.parametrize("advance", [True, False], ids=["opted_in", "default"])
def test_dist_sync_on_step_forward_and_delta_advance_equal_the_jax_package(advance):
    """``forward`` with ``dist_sync_on_step`` syncs each batch; a class that opts in
    advances the delta cache off those batch gathers, so the epoch's compute ships
    only the rows never gathered."""
    metrics = {}
    for name, pkg, parallel, kwargs in (("ref", jm, jp, EAGER), ("port", mt, tp, {"device": "cpu"})):
        cls = type("AdvancingCat", (pkg.CatMetric,), {"_forward_delta_advance": advance})
        metrics[name] = cls(dist_sync_on_step=True, sync_backend=parallel.LoopbackBackend(), **kwargs)
    for step in range(3):
        batch = np.arange(4, dtype=np.float32) + 10 * step
        outs = [metrics["ref"](batch), metrics["port"](torch.from_numpy(batch))]
        assert_same(outs[1], outs[0])
        assert_same(outs[1], batch)
        fields = ("bytes_gathered", "gather_calls", "preflight_bytes", "delta")
        assert {k: metrics["port"].last_sync_report.get(k) for k in fields} == {
            k: metrics["ref"].last_sync_report.get(k) for k in fields
        }
    port_dc, ref_dc = metrics["port"]._delta_cache, metrics["ref"]._delta_cache
    assert (port_dc.round, port_dc.watermarks) == (ref_dc.round, ref_dc.watermarks)
    assert port_dc.round == (3 if advance else 0)
    assert_same(metrics["port"].compute(), metrics["ref"].compute())
    for key in ("delta", "bytes_saved", "bytes_gathered"):
        assert metrics["port"].last_sync_report[key] == metrics["ref"].last_sync_report[key], key
    assert metrics["port"].last_sync_report["delta"] is advance


# ----------------------------------------------------------- aggregation
NAN_STRATEGIES = ("error", "warn", "ignore", 2.0)
AGGREGATORS = ("SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric")
AGG_BATCHES = (
    np.array([1.0, np.nan, 3.5], np.float32),
    np.float32(-2.25),
    np.array([0.5, 4.0, np.nan, -1.0], np.float32),
)


@pytest.mark.parametrize("strategy", NAN_STRATEGIES, ids=str)
@pytest.mark.parametrize("name", AGGREGATORS)
def test_aggregation_matches_the_jax_package(name, strategy):
    ref = getattr(jm, name)(nan_strategy=strategy, **EAGER)
    port = getattr(mt, name)(nan_strategy=strategy, device="cpu")
    for batch in AGG_BATCHES:
        outcomes = []
        for metric, x in ((ref, batch), (port, torch.from_numpy(np.asarray(batch)))):
            outcomes.append(_outcome(lambda: metric(x)))
        assert outcomes[1]["error"] == outcomes[0]["error"]
        if strategy == "error":
            assert outcomes[0]["error"] == "RuntimeError" or not np.isnan(batch).any()
        if outcomes[0]["error"] is None:
            assert_same(outcomes[1]["value"], outcomes[0]["value"])
    if name == "MeanMetric":  # weights broadcast against the values
        port.update(torch.tensor([1.0, 4.0]), weight=torch.tensor([3.0, 5.0]))
        ref.update(np.array([1.0, 4.0], np.float32), weight=np.array([3.0, 5.0], np.float32))
    assert_same(port.compute(), ref.compute())


def test_aggregation_rejects_an_unknown_nan_strategy():
    with pytest.raises(ValueError, match="nan_strategy"):
        mt.SumMetric(nan_strategy="explode", device="cpu")
