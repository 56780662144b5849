"""The public ``utils`` surface and four stray public names of the port, held against the JAX package.

The same inputs, made from a numpy seed, go through both packages:
``to_categorical``, ``class_reduce``, ``apply_to_collection``,
``get_group_indexes``, ``EnumStr.from_str``, ``rank_zero_info``/``debug``,
``check_forward_full_state_property``, ``jit_distributed_available``,
``default_weights_dir`` and ``MeshBackend.all_gather_list``.

Tolerances: labels, indexes and every float that the two packages compute by
one correctly rounded operation (a quotient, a ``nan_to_num``) bitwise; a
float32 sum or mean over a few per-class fractions to ``SUM_RTOL`` (the
packages may add them in another order: a few ulps of float32).

The two-rank cases start two gloo ranks of this file as a script
(``python tests/test_torch_utils.py RANK STORE OUT``), which imports neither
JAX nor ``metrics_tpu``.
"""

import logging
import os
import re
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu_torch.image.backbones.weights import default_weights_dir
from metrics_tpu_torch.metric import jit_distributed_available
from metrics_tpu_torch.utils import checks as tchecks
from metrics_tpu_torch.utils import data as tdata
from metrics_tpu_torch.utils import enums as tenums
from metrics_tpu_torch.utils import prints as tprints

ROOT = Path(__file__).resolve().parents[1]
SUM_RTOL = 8 * 2.0**-24  # a float32 sum of up to 16 fractions added in another order
LAUNCH_LIMIT = 120.0


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here, so the rank script never loads JAX)."""
    import types

    import jax.numpy as jnp

    from metrics_tpu.image.backbones import weights as jweights
    from metrics_tpu.utils import checks as jchecks
    from metrics_tpu.utils import data as jdata
    from metrics_tpu.utils import enums as jenums
    from metrics_tpu.utils import prints as jprints

    return types.SimpleNamespace(jnp=jnp, data=jdata, enums=jenums, prints=jprints, checks=jchecks, weights=jweights)


def _same(got: torch.Tensor, want) -> None:
    """Equal values, NaN-aware and bit for bit (float32 bits, so -0.0 differs from 0.0)."""
    want = np.asarray(want)
    got = got.detach().cpu().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got.astype(np.float32).view(np.uint32), want.astype(np.float32).view(np.uint32))
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ to_categorical
def _probabilities(seed: int) -> np.ndarray:
    """(6, 5, 4) float32 quarters: ties in most rows, a NaN in two, a signed zero tie in one."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=(6, 5, 4)).astype(np.float32) / 4
    x[1, 2, 3] = x[1, 0, 3] = np.nan  # two NaNs along dim 1: the first wins
    x[4, :, 0] = np.float32(-0.0)
    x[4, 3, 0] = np.float32(0.0)  # -0.0 and 0.0 tie
    x[5, 1, :] = np.nan
    return x


@pytest.mark.parametrize("argmax_dim", [0, 1, -1])
def test_to_categorical_matches_jnp_argmax_on_ties_and_nan(jx, argmax_dim):
    x = _probabilities(argmax_dim + 3)
    got = tdata.to_categorical(torch.from_numpy(x), argmax_dim=argmax_dim)
    want = np.asarray(jx.data.to_categorical(jx.jnp.asarray(x), argmax_dim=argmax_dim))
    assert got.dtype == torch.int64
    _same(got, want)


def test_to_categorical_of_one_hots_and_flags(jx):
    labels = np.random.default_rng(7).integers(0, 5, size=12)
    onehot = np.eye(5, dtype=np.int32)[labels]
    _same(tdata.to_categorical(torch.from_numpy(onehot)), labels)
    _same(tdata.to_categorical(torch.from_numpy(onehot.astype(bool))),
          np.asarray(jx.data.to_categorical(jx.jnp.asarray(onehot.astype(bool)))))


# ------------------------------------------------------------------ class_reduce
REDUCTIONS = ["micro", "macro", "weighted", "none", None]


def _class_counts(kind: str):
    """Per-class (num, denom, weights) of 9 classes: class 2 has num 0 and denom 0, class 5 num 3 and denom 0."""
    rng = np.random.default_rng(11)
    denom = rng.integers(1, 40, size=9)
    num = rng.integers(0, denom + 1)
    num[2], denom[2] = 0, 0
    num[5], denom[5] = 3, 0
    weights = rng.integers(0, 20, size=9)
    if kind == "int32":
        return num.astype(np.int32), denom.astype(np.int32), weights.astype(np.int32)
    return num.astype(np.float32) / 8, denom.astype(np.float32) / 8, weights.astype(np.float32) / 4


@pytest.mark.parametrize("kind", ["int32", "float32"])
@pytest.mark.parametrize("reduction", REDUCTIONS, ids=[str(r) for r in REDUCTIONS])
def test_class_reduce_matches_the_jax_package(jx, kind, reduction):
    num, denom, weights = _class_counts(kind)
    got = tdata.class_reduce(torch.from_numpy(num), torch.from_numpy(denom), torch.from_numpy(weights), reduction)
    want = np.asarray(jx.data.class_reduce(jx.jnp.asarray(num), jx.jnp.asarray(denom), jx.jnp.asarray(weights),
                                           reduction))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    if reduction in ("none", None):
        _same(got, want)  # one quotient and nan_to_num a class: correctly rounded in both
        assert got[2] == 0 and got[5] == np.finfo(np.float32).max
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL, atol=0)
        assert np.isfinite(got.numpy())


def test_class_reduce_maps_a_negative_numerator_over_zero_to_the_float32_minimum(jx):
    num = np.array([-1.5, 1.5, 0.0, -0.25], np.float32)
    denom = np.array([0.0, 0.0, 0.0, 0.5], np.float32)
    got = tdata.class_reduce(torch.from_numpy(num), torch.from_numpy(denom), torch.ones(4), "none")
    _same(got, jx.data.class_reduce(jx.jnp.asarray(num), jx.jnp.asarray(denom), jx.jnp.ones(4), "none"))
    f32 = np.finfo(np.float32)
    assert got.tolist() == [f32.min, f32.max, 0.0, -0.5]


def test_class_reduce_of_int64_counts_divides_to_float32(jx):
    num, denom, weights = (torch.from_numpy(a.astype(np.int64)) for a in _class_counts("int32"))
    for reduction in REDUCTIONS:
        assert tdata.class_reduce(num, denom, weights, reduction).dtype == torch.float32


def test_class_reduce_raises_on_an_unknown_reduction(jx):
    num, denom, weights = (torch.from_numpy(a) for a in _class_counts("int32"))
    with pytest.raises(ValueError, match="Reduction parameter samples unknown") as ours:
        tdata.class_reduce(num, denom, weights, "samples")
    with pytest.raises(ValueError) as theirs:
        jx.data.class_reduce(*(jx.jnp.asarray(t.numpy()) for t in (num, denom, weights)), "samples")
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------------ apply_to_collection
class _Pair(tuple):
    """A tuple subclass: apply_to_collection keeps its type."""


def _nested(rng: np.random.Generator):
    a, b, c = (rng.integers(-8, 8, size=s).astype(np.float32) / 8 for s in ((3,), (2, 2), ()))
    return {"rows": [a, (b, "tag", {"deep": [c, 5]}), _Pair((a, b))], "n": 3, "empty": [], "t": ()}


def _leaves(tree):
    """The tree's structure with every array as a (shape, values) pair, for comparison across packages."""
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_leaves(v) for v in tree])
    if hasattr(tree, "shape"):
        arr = np.asarray(tree.cpu() if isinstance(tree, torch.Tensor) else tree)
        return ("array", arr.shape, arr.tolist())
    return tree


def test_apply_to_collection_matches_the_jax_package(jx):
    import jax

    tree = _nested(np.random.default_rng(3))
    to_torch = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    to_jax = lambda x: jx.jnp.asarray(x)  # noqa: E731
    ours = tdata.apply_to_collection(tdata.apply_to_collection(tree, np.ndarray, to_torch), torch.Tensor,
                                     lambda t, k, bias: t * k + bias, 3, bias=0.5)
    theirs = jx.data.apply_to_collection(jx.data.apply_to_collection(tree, np.ndarray, to_jax), jax.Array,
                                         lambda t, k, bias: t * k + bias, 3, bias=0.5)
    assert _leaves(ours) == _leaves(theirs)
    assert type(ours["rows"][2]) is _Pair and type(ours["rows"][1]) is tuple and ours["rows"][1][1] == "tag"
    assert isinstance(ours["rows"][0], torch.Tensor) and ours["n"] == 3
    # a tuple of dtypes, and data that is itself of the dtype
    assert tdata.apply_to_collection([1, 2.5, "x"], (int, float), lambda v: v * 2) == [2, 5.0, "x"]
    assert tdata.apply_to_collection(4, int, lambda v: -v) == jx.data.apply_to_collection(4, int, lambda v: -v)


# ------------------------------------------------------------------ get_group_indexes
@pytest.mark.parametrize("as_numpy", [False, True])
def test_get_group_indexes_matches_the_jax_package(jx, as_numpy):
    ids = np.random.default_rng(5).integers(0, 9, size=60) * 7 - 20  # unsorted, repeated, negative ids
    ours = tdata.get_group_indexes(ids if as_numpy else torch.from_numpy(ids))
    theirs = jx.data.get_group_indexes(jx.jnp.asarray(ids.astype(np.int32)))
    assert len(ours) == len(theirs) == len(np.unique(ids))
    for got, want in zip(ours, theirs):
        assert got.dtype == torch.int64 and got.device == torch.device("cpu")
        _same(got, want)
    assert [int(ids[g[0]]) for g in ours] == list(dict.fromkeys(ids.tolist()))  # order of first appearance


def test_get_group_indexes_of_no_rows(jx):
    assert tdata.get_group_indexes(torch.zeros(0, dtype=torch.int64)) == []
    assert jx.data.get_group_indexes(np.zeros(0, np.int64)) == []


# ------------------------------------------------------------------ EnumStr.from_str
ENUMS = ["DataType", "AverageMethod", "MDMCAverageMethod"]


@pytest.mark.parametrize("enum_name", ENUMS)
def test_enum_from_str_matches_the_jax_package(jx, enum_name):
    ours, theirs = getattr(tenums, enum_name), getattr(jx.enums, enum_name)
    probes = [n for n in theirs.__members__] + [n.lower() for n in theirs.__members__]
    probes += [n.title() for n in theirs.__members__] + [m.value for m in theirs] + ["", "nope", None, 3]
    for probe in probes:
        got, want = ours.from_str(probe), theirs.from_str(probe)
        assert (got is None) == (want is None), probe
        if got is not None:
            assert type(got) is ours and got.name == want.name and got.value == want.value


# ------------------------------------------------------------------ rank_zero_info / rank_zero_debug
def test_rank_zero_info_and_debug_log_as_the_jax_package(jx, caplog, monkeypatch):
    caplog.set_level(logging.DEBUG)
    tprints.rank_zero_info("seen %d of %s", 3, "rows")
    tprints.rank_zero_debug("state %s", "ok")
    jx.prints.rank_zero_info("seen %d of %s", 3, "rows")
    jx.prints.rank_zero_debug("state %s", "ok")
    records = [(r.name, r.levelno, r.getMessage()) for r in caplog.records if r.name in ("metrics_tpu", "metrics_tpu_torch")]
    assert records == [
        ("metrics_tpu_torch", logging.INFO, "seen 3 of rows"),
        ("metrics_tpu_torch", logging.DEBUG, "state ok"),
        ("metrics_tpu", logging.INFO, "seen 3 of rows"),
        ("metrics_tpu", logging.DEBUG, "state ok"),
    ]
    caplog.clear()
    monkeypatch.setattr(tprints, "_process_index", lambda: 1)
    assert tprints.rank_zero_info("not on rank 1") is None and tprints.rank_zero_debug("nor this") is None
    assert not [r for r in caplog.records if r.name == "metrics_tpu_torch"]


def test_utils_all_is_the_jax_one(jx):
    import metrics_tpu.utils as jutils

    import metrics_tpu_torch.utils as tutils

    assert tutils.__all__ == jutils.__all__
    for name in tutils.__all__:
        assert callable(getattr(tutils, name)), name
    assert tutils.dim_zero_cat is tdata.dim_zero_cat and tutils.rank_zero_info is tprints.rank_zero_info


def test_importing_the_utils_alone_loads_neither_jax_nor_metrics_tpu():
    code = (
        "import sys\n"
        "from metrics_tpu_torch.utils import *\n"
        "import metrics_tpu_torch.utils as u\n"
        "star = globals()\n"
        "assert all(star[name] is getattr(u, name) for name in u.__all__)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------------ check_forward_full_state_property
def _skeleton(text: str) -> list:
    """The printed lines with their numbers blanked."""
    return [re.sub(r"[-+]?\d[\d.e+-]*", "#", line) for line in text.strip().splitlines()]


def test_check_forward_full_state_property_prints_as_the_jax_package(jx, capsys):
    import metrics_tpu as jm

    rng = np.random.default_rng(2)
    preds, target = (rng.integers(-16, 16, size=32).astype(np.float32) / 8 for _ in range(2))
    tchecks.check_forward_full_state_property(
        mt.MeanSquaredError, init_args={"device": "cpu"},
        input_args={"preds": torch.from_numpy(preds), "target": torch.from_numpy(target)},
        num_update_to_compare=(2, 3), reps=2,
    )
    ours = capsys.readouterr().out
    jx.checks.check_forward_full_state_property(
        jm.MeanSquaredError, input_args={"preds": jx.jnp.asarray(preds), "target": jx.jnp.asarray(target)},
        num_update_to_compare=(2, 3), reps=2,
    )
    theirs = capsys.readouterr().out
    assert _skeleton(ours) == _skeleton(theirs)
    assert len(ours.strip().splitlines()) == 5 and ours.strip().endswith(
        "Recommended setting `full_state_update=False` for MeanSquaredError (results match).")
    assert re.fullmatch(r"full_state_update=True: \S+s \+- \S+ for 2 steps", ours.splitlines()[0])


class _CallCounting(mt.Metric):
    """A metric whose update reads a count outside its states: the full-state forward updates twice."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.calls = 0
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.calls += 1
        self.total = self.total + self.calls * torch.as_tensor(x, dtype=torch.float32).sum()

    def compute(self):
        return self.total


def test_check_forward_full_state_property_raises_when_the_paths_differ(capsys):
    with pytest.raises(ValueError, match="full_state_update=True is required for _CallCounting"):
        tchecks.check_forward_full_state_property(
            _CallCounting, init_args={"device": "cpu"}, input_args={"x": torch.ones(4)},
            num_update_to_compare=(2,), reps=1,
        )
    assert capsys.readouterr().out == ""


def test_check_forward_compares_nested_results():
    close = tchecks._results_close
    a = {"x": torch.tensor([1.0, 2.0]), "y": (torch.tensor(3), [torch.tensor(0.5)])}
    assert close(a, {"x": torch.tensor([1.0, 2.0 + 1e-9]), "y": (torch.tensor(3), [torch.tensor(0.5)])})
    assert not close(a, {"x": torch.tensor([1.0, 2.5]), "y": (torch.tensor(3), [torch.tensor(0.5)])})
    assert not close(a, {"x": torch.tensor([1.0, 2.0])})
    assert not close([torch.tensor(1.0)], [torch.tensor(1.0), torch.tensor(1.0)])
    assert close(torch.tensor(2), torch.tensor(2.0)) and not close(torch.tensor(float("nan")), torch.tensor(float("nan")))


# ------------------------------------------------------------------ default_weights_dir
@pytest.mark.parametrize("env", [None, "/srv/weights"])
def test_default_weights_dir_is_the_jax_one(jx, monkeypatch, tmp_path, env):
    monkeypatch.setenv("HOME", str(tmp_path))
    if env is None:
        monkeypatch.delenv("METRICS_TPU_WEIGHTS_DIR", raising=False)
    else:
        monkeypatch.setenv("METRICS_TPU_WEIGHTS_DIR", env)
    assert default_weights_dir() == jx.weights.default_weights_dir()
    want = env or str(tmp_path / ".cache" / "metrics_tpu" / "weights")
    assert default_weights_dir() == want


@pytest.mark.parametrize("env", [None, "/srv/weights"])
def test_weight_search_starts_where_the_jax_package_searches(jx, monkeypatch, tmp_path, env):
    from metrics_tpu_torch.image.backbones.weights import weight_search_paths

    monkeypatch.setenv("HOME", str(tmp_path))
    if env is None:
        monkeypatch.delenv("METRICS_TPU_WEIGHTS_DIR", raising=False)
    else:
        monkeypatch.setenv("METRICS_TPU_WEIGHTS_DIR", env)
    got, jax_paths = weight_search_paths("lpips_vgg.npz"), jx.weights.weight_search_paths("lpips_vgg.npz")
    # the same directories in the same order; only the package's own _weights/ differs
    assert got[:-1] == jax_paths[:-1] and len(got) == len(jax_paths)
    assert got[0] == os.path.join(default_weights_dir(), "lpips_vgg.npz")
    assert got[-1].endswith(os.path.join("metrics_tpu_torch", "_weights", "lpips_vgg.npz"))


# ------------------------------------------------------------------ jit_distributed_available and all_gather_list
def test_jit_distributed_available_without_a_process_group(jx):
    import metrics_tpu.metric as jmetric

    assert not torch.distributed.is_initialized()
    assert jit_distributed_available() is False
    assert jit_distributed_available() == jmetric.jit_distributed_available()
    assert mt.metric.jit_distributed_available is jit_distributed_available


def _entries(rank: int, case: str) -> list:
    """Rank ``rank``'s list-state entries in ``case``: float32 rows of 0, 1 or 2 dimensions, and int64 rows."""
    rng = np.random.default_rng(100 + rank)
    if case == "none" or (case == "one_empty" and rank == 1):
        return []
    if case == "ints":
        return [torch.from_numpy(rng.integers(-50, 50, size=n)) for n in (3, 1, 4)[: 2 + rank]]
    if case == "matrices":
        return [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)) for n in (2 + rank, 1)]
    # scalars and vectors of several lengths, as update() appends them
    return [torch.tensor(np.float32(rng.standard_normal()))] + [
        torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for n in (4, 0, 2)[: 1 + 2 * rank]
    ]


GATHER_CASES = ("mixed", "ints", "matrices", "one_empty", "none")


def _rank_main(rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    from metrics_tpu_torch.parallel import MeshBackend
    from metrics_tpu_torch.parallel.mesh import default_mesh

    saved = {"before": np.array(jit_distributed_available())}
    store = dist.FileStore(store_path, 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2, timeout=timedelta(seconds=60))
    saved["inside"] = np.array(jit_distributed_available())
    backend = MeshBackend(default_mesh(device="cpu"))
    for case in GATHER_CASES:
        got = backend.all_gather_list(_entries(rank, case))
        saved[f"{case}.n"] = np.array(len(got))
        for i, entry in enumerate(got):
            saved[f"{case}.{i}"] = entry.numpy()
            saved[f"{case}.{i}.device"] = np.array(str(entry.device))
    saved["ticks"] = np.array(backend.pop_telemetry()["in_xla_reductions"])
    dist.barrier()
    dist.destroy_process_group()
    saved["after"] = np.array(jit_distributed_available())
    np.savez(out / f"r{rank}.npz", **saved)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("utils_ranks")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(base / "store"), str(base)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    deadline = time.monotonic() + LAUNCH_LIMIT
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for proc in procs:
            proc.kill()
    for rank, proc in enumerate(procs):
        assert proc.returncode == 0, f"rank {rank} exited {proc.returncode}:\n{logs[rank]}"
    return [dict(np.load(base / f"r{rank}.npz")) for rank in range(2)]


def test_jit_distributed_available_inside_a_two_rank_group(two_ranks):
    for got in two_ranks:
        assert not bool(got["before"]) and bool(got["inside"]) and not bool(got["after"])


def test_all_gather_list_takes_the_jax_packages_arguments(jx):
    import inspect

    from metrics_tpu.parallel.mesh import MeshBackend as JaxMeshBackend
    from metrics_tpu_torch.parallel import MeshBackend

    ours = list(inspect.signature(MeshBackend.all_gather_list).parameters)
    assert ours == list(inspect.signature(JaxMeshBackend.all_gather_list).parameters) == ["self", "entries"]


@pytest.mark.parametrize("case", GATHER_CASES)
def test_all_gather_list_gives_every_ranks_entries_in_rank_order(jx, two_ranks, case):
    from metrics_tpu.parallel.mesh import MeshBackend as JaxMeshBackend
    from metrics_tpu.parallel.mesh import default_mesh as jax_default_mesh

    # the JAX package's one controller holds every rank's entries already: its gather is the identity on them
    every = [e.numpy() for rank in range(2) for e in _entries(rank, case)]
    want = JaxMeshBackend(jax_default_mesh()).all_gather_list([jx.jnp.asarray(e) for e in every])
    assert len(want) == len(every)
    for got in two_ranks:
        assert int(got[f"{case}.n"]) == len(want)
        for i, entry in enumerate(want):
            entry = np.atleast_1d(np.asarray(entry))
            np.testing.assert_array_equal(got[f"{case}.{i}"], entry.astype(got[f"{case}.{i}"].dtype))
            assert got[f"{case}.{i}"].dtype == every[i].dtype and got[f"{case}.{i}"].shape == np.atleast_1d(every[i]).shape
            assert str(got[f"{case}.{i}.device"]) == "cpu"
        assert int(got["ticks"]) == len(GATHER_CASES)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))
