"""The JAX package's static-analysis passes (``tools/analyze``) run over the port.

* lock-order walks ``metrics_tpu_torch`` as it walks ``metrics_tpu``, with no
  baseline: it must report exactly the three contracts that
  ``tools/analyze/baseline.json`` justifies for the JAX package (matched by
  rule and by function and call, not by line), each pinned here with that
  entry's justification.
* serve-blocking scopes the literal prefix ``metrics_tpu/serve/``, so the
  port's modules go in as units whose ``rel`` maps ``metrics_tpu_torch/`` to
  ``metrics_tpu/``.  With the rel alone the pass sees the port's own spellings
  (blocking calls, ``analyze:`` markers), but not its imports: those name
  ``metrics_tpu_torch.*``, which neither the banned-import list nor the call
  graph resolves.  A second run also renames the package in the sources, so
  that both see them.  Both runs must give zero findings, and a blocking call,
  a banned import and a one-hop chain planted in a copy of
  ``serve/ingest.py`` must be flagged where each run can see them.

Nothing under ``tools/`` changes for this.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tools.analyze import PASSES, ModuleUnit, discover_units, load_baseline, run_passes  # noqa: E402

PORT = "metrics_tpu_torch"

#: (module, rule, function:call) of each lock-order finding over the port, with the
#: justification of its JAX baseline entry
LOCK_ORDER_PINNED = {
    ("metrics_tpu_torch/serve/server.py", "blocking-under-lock", "EvalServer.start:restore"):
        "restore-on-start runs before the consumer/http threads exist, so nothing can contend for the job locks it holds",
    ("metrics_tpu_torch/serve/server.py", "blocking-under-lock", "EvalServer.checkpoint_now:save_now"):
        "deliberate quiesce: snapshot consistency requires holding every job lock across the commit; the queue keeps "
        "absorbing records meanwhile and save paths carry their own timeouts",
    ("metrics_tpu_torch/serve/soak.py", "blocking-under-lock", "exercise_chaos_sync:sync_context"):
        "operator-initiated sync must exclude concurrent updates by design; the soak harness accepts the pause "
        "(LoopbackBackend, no real peers)",
}


@pytest.fixture(scope="module")
def port_units():
    return discover_units(package=PORT)


def _as_jax(rel: str) -> str:
    return rel.replace(f"{PORT}/", "metrics_tpu/", 1)


def _mapped(units, rename: bool = False, serve_only: bool = False, extra: dict = None):
    """The port's units under JAX rels; ``rename`` also renames the package in the sources."""
    out = []
    for u in units:
        if serve_only and not u.rel.startswith(f"{PORT}/serve/"):
            continue
        source = (extra or {}).get(u.rel, u.source)
        out.append(ModuleUnit(_as_jax(u.rel), source.replace(PORT, "metrics_tpu") if rename else source))
    for rel, source in (extra or {}).items():
        if not any(u.rel == rel for u in units):
            out.append(ModuleUnit(_as_jax(rel), source.replace(PORT, "metrics_tpu") if rename else source))
    return out


# ------------------------------------------------------------------ lock-order
def test_lock_order_over_the_port_finds_exactly_the_three_baselined_contracts(port_units):
    report = run_passes(["lock-order"], units=port_units, baseline_path=None)
    assert report.modules_analyzed == len(port_units) and len(port_units) > 200
    found = sorted((f.module, f.rule, f.detail) for f in report.findings)
    assert found == sorted(LOCK_ORDER_PINNED), [f.render() for f in report.findings]
    baseline = load_baseline()
    for (module, rule, detail), why in LOCK_ORDER_PINNED.items():
        entry = baseline["::".join(("lock-order", _as_jax(module), rule, detail))]
        assert entry["justification"] == why and entry["count"] == 1


# ------------------------------------------------------------------ serve-blocking
def _request_path(units) -> list:
    bk = PASSES["serve-blocking"]
    return sorted(u.rel for u in units if bk.applies(u) and not u.skips(bk.name))


def test_serve_blocking_scopes_the_ports_serve_modules(port_units):
    ours = _mapped(port_units, serve_only=True)
    serve = sorted(u.rel for u in port_units if u.rel.startswith(f"{PORT}/serve/"))
    assert [u.rel for u in ours] == [_as_jax(r) for r in serve] and len(serve) >= 16
    # every serve module is in the pass's scope, and the port opts the same modules out as the JAX package
    assert all(PASSES["serve-blocking"].applies(u) for u in ours)
    jax_units = [u for u in discover_units() if u.rel.startswith("metrics_tpu/serve/")]
    assert _request_path(ours) == _request_path(jax_units)
    assert len(_request_path(ours)) >= 10


@pytest.mark.parametrize("rename", [False, True], ids=["rel", "rel_and_imports"])
def test_serve_blocking_gives_the_ports_serve_modules_no_finding(port_units, rename):
    units = _mapped(port_units, rename=rename, serve_only=not rename)
    report = run_passes(["serve-blocking"], units=units, baseline_path=None)
    assert report.findings == [], [f.render() for f in report.findings]
    assert report.modules_analyzed == len(units)


def test_serve_blocking_honours_the_ports_wal_markers(port_units):
    """The four ``fsync`` calls of the WAL writer carry ``ignore[serve-blocking]``: without them, four findings."""
    wal = next(u for u in port_units if u.rel == f"{PORT}/serve/wal.py")
    assert sum("serve-blocking" in names for names in wal.ignores.values()) == 4
    stripped = wal.source.replace("# analyze: ignore[serve-blocking]", "#")
    report = run_passes(["serve-blocking"], units=_mapped(port_units, serve_only=True, extra={wal.rel: stripped}),
                        baseline_path=None)
    assert sorted((f.module, f.rule, f.detail.split(":")[-1]) for f in report.findings) == \
        [("metrics_tpu/serve/wal.py", "blocking-call", "fsync")] * 4


PLANTED_HELPER = f"{PORT}/_planted_helper.py"
PLANTS = {
    "call": ("\n\ndef _planted_call(metric):\n    return metric.sync()\n", None),
    "import": ("\n\nfrom metrics_tpu_torch.parallel import DistBackend  # noqa: E402\n", None),
    "chain": (
        "\n\nfrom metrics_tpu_torch._planted_helper import wait_for_peers  # noqa: E402\n\n\n"
        "def _planted_chain(group):\n    return wait_for_peers(group)\n",
        "def wait_for_peers(group):\n    return group.barrier()\n",
    ),
}
#: (rule, detail) each plant must give under each run; None where the run cannot see it
PLANT_FINDINGS = {
    ("call", False): ("blocking-call", "_planted_call:sync"),
    ("call", True): ("blocking-call", "_planted_call:sync"),
    ("import", False): None,  # the banned-import list names metrics_tpu.parallel, not metrics_tpu_torch.parallel
    ("import", True): ("banned-import", "<module>:metrics_tpu.parallel"),
    ("chain", False): None,  # the call graph cannot resolve a metrics_tpu_torch.* import under a metrics_tpu rel
    ("chain", True): ("blocking-reachable", "_planted_chain->wait_for_peers:barrier"),
}


@pytest.mark.parametrize("rename", [False, True], ids=["rel", "rel_and_imports"])
@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_serve_blocking_flags_a_plant_in_a_port_request_path_module(port_units, plant, rename):
    ingest = next(u for u in port_units if u.rel == f"{PORT}/serve/ingest.py")
    tail, helper = PLANTS[plant]
    extra = {ingest.rel: ingest.source + tail}
    if helper is not None:
        extra[PLANTED_HELPER] = helper
    report = run_passes(["serve-blocking"], units=_mapped(port_units, rename=rename, extra=extra), baseline_path=None)
    found = sorted((f.module, f.rule, f.detail) for f in report.findings)
    want = PLANT_FINDINGS[(plant, rename)]
    if want is None:
        assert found == []
    else:
        assert ("metrics_tpu/serve/ingest.py",) + want in found, found
        assert {f[0] for f in found} == {"metrics_tpu/serve/ingest.py"}
