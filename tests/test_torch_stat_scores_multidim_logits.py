"""Multi-dimensional logits counted in one pass (``fused_logits_counts``), on the CPU and on the card.

Float logits ``(N, C, X...)`` and integer labels ``(N, X...)`` reach the
confusion-matrix update (``form="confmat"``) and, under
``mdmc_reduce="global"``, the stat-scores update (``form="stat_scores"``)
without one-hots.  The CPU tests hold:

* the plain version, and the routed updates, bitwise against the one-hot
  route (``_input_format_classification``, then ``argmax`` and ``bincount``, or
  the canonical counts of the pixels as rows), on logits on a grid of eighths
  (ties in most pixels; exact in bfloat16 and float16) with pixels of NaN,
  -NaN, signed zeros and infinities, and labels outside ``[0, C)`` under
  ``validate_args=False``;
* the routed module metrics' states bitwise, and ``compute()`` to the
  tolerances of the other parity tests, against the JAX package;
* which updates take the route (``engine.logits_counts``), and that the others
  keep their outputs.

The tests marked ``cuda`` compare the kernel with its plain version on the
card and skip without one.  JAX is imported inside the tests that use it, so
the card's machine, which has no JAX, runs this file as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stat_scores_multidim_logits.py
"""

import math
import re

import numpy as np
import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.functional.classification.stat_scores import (
    _stat_scores,
    _stat_scores_stream_update,
    _stat_scores_update,
)
from metrics_tpu_torch.obs import core as obs
from metrics_tpu_torch.ops import stat_scores as ops
from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.data import _confusion_counts

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
NAN_BITS = {torch.bfloat16: (0x7FC0, -0x40), torch.float16: (0x7E00, -0x200)}  # (+NaN, -NaN) as int16
SPATIAL = [(1,), (7,), (64, 33), (4, 5, 6)]
SHAPES = [(n, c, x) for n in (1, 3) for c in (2, 19, 150) for x in SPATIAL]
FORMS = ("confmat", "stat_scores")


def make_case(n, c, spatial, dtype, label_dtype, seed, out_of_range=False, device="cpu"):
    """Logits on a grid of eighths in [-2, 2] and labels in [0, C); with eight pixels or more, image 0's
    first pixels are -inf, NaN at odd channels, signed zeros, a -NaN, infinities, all -NaN and the
    least-ordered NaN everywhere; ``out_of_range`` puts labels C, -1 and C + 100 on its first pixels."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-16, 17, (n, c) + spatial) / 8).astype(np.float32)
    labels = rng.integers(0, c, (n,) + spatial)
    flat, flat_labels = x.reshape(n, c, -1), labels.reshape(n, -1)  # views
    pixels = flat.shape[2]
    special = pixels >= 8 and c >= 4
    if special:
        flat[0, :, 0] = -np.inf
        flat[0, 1::2, 1] = np.nan
        flat[0, :, 2] = 0.0
        flat[0, 0, 2] = -0.0
        flat[0, 1, 3] = np.copysign(np.nan, -1.0)
        flat[0, 2:4, 4] = np.inf
        flat[0, :, 5] = np.copysign(np.nan, -1.0)
    if out_of_range:
        flat_labels[0, : min(3, pixels)] = (c, -1, c + 100)[: min(3, pixels)]
    logits = torch.from_numpy(x).to(dtype)
    bits = logits.view(torch.int32 if dtype == torch.float32 else torch.int16).reshape(n, c, -1)
    if special:
        if dtype in NAN_BITS:  # the conversion may not keep a NaN's sign
            bits[0, 1::2, 1], bits[0, 1, 3] = NAN_BITS[dtype]
            bits[0, :, 5] = NAN_BITS[dtype][1]
        bits[0, :, 6] = -1  # all bits set: the NaN whose order key is the least
    return logits.to(device), torch.from_numpy(labels).to(device=device, dtype=label_dtype)


def one_hot_route(logits, labels, form):
    """What the confusion-matrix and global stat-scores updates counted before the route: one-hots."""
    c = logits.shape[1]
    preds, target, _ = _input_format_classification(logits, labels, num_classes=c, validate_args=False)
    if form == "confmat":
        return _confusion_counts(torch.argmax(preds, dim=1), torch.argmax(target, dim=1), c)
    preds = torch.movedim(preds, 1, 2).reshape(-1, c)
    target = torch.movedim(target, 1, 2).reshape(-1, c)
    return _stat_scores(preds, target, reduce="macro")


def assert_counts_equal(got, expected):
    if isinstance(expected, torch.Tensor):
        got, expected = (got,), (expected,)
    assert len(got) == len(expected)
    for g, e in zip(got, expected):
        assert g.dtype == torch.int32 and g.shape == e.shape
        assert torch.equal(g.cpu(), e.cpu())


def flat(logits, labels):
    n, c = logits.shape[:2]
    return logits.reshape(n, c, -1), labels.reshape(n, -1)


@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,c,spatial", SHAPES)
def test_plain_and_routed_updates_match_the_one_hot_route(n, c, spatial, dtype, label_dtype):
    logits, labels = make_case(n, c, spatial, DTYPES[dtype], label_dtype, seed=n * 1000 + c + len(spatial))
    for form in FORMS:
        expected = one_hot_route(logits, labels, form)
        assert_counts_equal(ops.fused_logits_counts_plain(*flat(logits, labels), form), expected)
        assert_counts_equal(ops.fused_logits_counts(*flat(logits, labels), form), expected)
    assert_counts_equal(_confusion_matrix_update(logits, labels, c), one_hot_route(logits, labels, "confmat"))
    macro = _stat_scores_update(logits, labels, reduce="macro", mdmc_reduce="global", num_classes=c)
    assert_counts_equal(macro, expected)
    micro = _stat_scores_update(logits, labels, reduce="micro", mdmc_reduce="global")
    assert_counts_equal(micro, tuple(x.sum(dtype=torch.int32) for x in expected))


@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,c,spatial", [(1, 19, (7,)), (3, 19, (64, 33)), (3, 150, (4, 5, 6)), (3, 2, (1,))])
def test_labels_outside_the_classes_count_as_the_one_hot_route_counts_them(n, c, spatial, dtype, label_dtype):
    # to_onehot zeroes the label's row: the confusion route counts the pixel in row 0, the counts add no fn
    logits, labels = make_case(n, c, spatial, DTYPES[dtype], label_dtype, seed=7 + c, out_of_range=True)
    for form in FORMS:
        expected = one_hot_route(logits, labels, form)
        assert_counts_equal(ops.fused_logits_counts_plain(*flat(logits, labels), form), expected)
    assert_counts_equal(_confusion_matrix_update(logits, labels, c, validate_args=False),
                        one_hot_route(logits, labels, "confmat"))
    routed = _stat_scores_update(logits, labels, reduce="macro", mdmc_reduce="global", num_classes=c,
                                 validate_args=False)
    assert_counts_equal(routed, one_hot_route(logits, labels, "stat_scores"))
    inside = ((labels >= 0) & (labels < c)).sum()
    assert int(routed[0].sum() + routed[3].sum()) == int(inside)  # tp + fn: the labelled pixels alone
    assert int(_confusion_matrix_update(logits, labels, c, validate_args=False).sum()) == labels.numel()


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    logits, labels = make_case(2, 5, (9,), torch.float32, torch.int64, seed=1)
    with pytest.raises(ValueError, match="form"):
        ops.fused_logits_counts(logits, labels, "samples")
    with pytest.raises(TypeError):
        ops.fused_logits_counts(logits.double(), labels)
    with pytest.raises(ValueError, match=r"\(N, C, X\)"):
        ops.fused_logits_counts(logits, labels[:, :4])
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_logits_counts(torch.zeros(1, 227, 3), torch.zeros(1, 3, dtype=torch.int64), "confmat")
    assert ops.logits_counts_fit(226, "confmat") and not ops.logits_counts_fit(227, "confmat")
    assert ops.logits_counts_fit(227, "stat_scores")


def test_the_routes_bins_limit_is_the_kernels():
    """``MAX_PLANE_BINS``, by which the Engine routes, is the int32 bins of the kernel's ``kMaxBinBytes``."""
    found = re.findall(r"constexpr int kMaxBinBytes = ([0-9 *]+);", ops._SOURCE.read_text())
    assert len(found) == 1
    assert ops.MAX_PLANE_BINS * 4 == math.prod(int(factor) for factor in found[0].split("*"))


# ------------------------------------------------------------------------------------------------------------
# routed module metrics against the JAX package

MODULES = {  # name: (class, kwargs, states)
    "confusion_matrix": ("ConfusionMatrix", {}, ("confmat",)),
    "jaccard": ("JaccardIndex", {}, ("confmat",)),
    "cohen_kappa": ("CohenKappa", {}, ("confmat",)),
    "matthews": ("MatthewsCorrCoef", {}, ("confmat",)),
}
for _average in ("macro", "micro"):
    for _cls in ("Accuracy", "Precision", "Recall", "F1Score", "Specificity"):
        MODULES[f"{_cls.lower()}_{_average}"] = (_cls, {"average": _average, "mdmc_average": "global"},
                                                 ("tp", "fp", "tn", "fn"))
    MODULES[f"stat_scores_{_average}"] = ("StatScores", {"reduce": _average, "mdmc_reduce": "global"},
                                          ("tp", "fp", "tn", "fn"))


@pytest.mark.parametrize("name", list(MODULES))
def test_routed_module_states_match_jax(name):
    import jax.numpy as jnp

    import metrics_tpu as jm
    from tests.test_torch_classification import assert_same
    from tests.test_torch_confmat_family import assert_kappa, assert_mcc

    cls, kwargs, states = MODULES[name]
    c = 5
    ref = getattr(jm, cls)(num_classes=c, jit_update=False, jit_compute=False, **kwargs)
    port = getattr(mt, cls)(num_classes=c, device="cpu", **kwargs)
    obs.reset()
    obs.enable()
    try:
        for seed, spatial in enumerate([(6, 7), (6, 7), (3, 4)]):
            logits, labels = make_case(2, c, spatial, torch.float32, torch.int64, seed=seed + 40)
            ref.update(jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy().astype(np.int32)))
            port.update(logits, labels)
        form = "confmat" if states == ("confmat",) else "stat_scores"
        assert obs.counter_value("engine.logits_counts", form=form) == 3
    finally:
        obs.disable()
        obs.reset()
    for state in states:
        assert_same(getattr(port, state), getattr(ref, state))
    if cls == "MatthewsCorrCoef":
        assert_mcc(port.compute(), ref.compute(), np.asarray(ref.confmat))
    elif cls == "CohenKappa":
        assert_kappa(port.compute(), ref.compute(), c)
    else:
        assert_same(port.compute(), ref.compute())


# ------------------------------------------------------------------------------------------------------------
# which updates take the route

def _bypasses():
    """Updates the route leaves on their old path: (name, jax call, port call), each on one input."""
    import jax.numpy as jnp

    import metrics_tpu.functional as jf
    from metrics_tpu.functional.classification.stat_scores import _stat_scores_update as jax_update

    import metrics_tpu_torch.functional as tf

    c = 5
    logits, labels = make_case(3, c, (4, 6), torch.float32, torch.int64, seed=3)
    j_logits, j_labels = jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy().astype(np.int32))
    rows, row_labels = logits[:, :, 0, 0].contiguous(), labels[:, 0, 0].contiguous()  # 2-D logits
    multilabel = (rows > 0).to(torch.int64)
    j_multilabel = jnp.asarray(multilabel.numpy().astype(np.int32))
    return [
        ("samplewise", lambda: jf.accuracy(j_logits, j_labels, average="macro", num_classes=c, mdmc_average="samplewise"),
         lambda: tf.accuracy(logits, labels, average="macro", num_classes=c, mdmc_average="samplewise")),
        ("top_k", lambda: jax_update(j_logits, j_labels, reduce="macro", mdmc_reduce="global", num_classes=c, top_k=2),
         lambda: _stat_scores_update(logits, labels, reduce="macro", mdmc_reduce="global", num_classes=c, top_k=2)),
        ("ignore_index",
         lambda: jax_update(j_logits, j_labels, reduce="macro", mdmc_reduce="global", num_classes=c, ignore_index=1),
         lambda: _stat_scores_update(logits, labels, reduce="macro", mdmc_reduce="global", num_classes=c,
                                     ignore_index=1)),
        ("multilabel", lambda: jf.confusion_matrix(jnp.asarray(rows.numpy()), j_multilabel, num_classes=c,
                                                   multilabel=True),
         lambda: tf.confusion_matrix(rows, multilabel, num_classes=c, multilabel=True)),
        ("2-D logits", lambda: jf.confusion_matrix(jnp.asarray(rows.numpy()), jnp.asarray(row_labels.numpy()),
                                                   num_classes=c),
         lambda: tf.confusion_matrix(rows, row_labels, num_classes=c)),
        ("2-D logits, stat scores", lambda: jax_update(jnp.asarray(rows.numpy()), jnp.asarray(row_labels.numpy()),
                                                       reduce="macro", num_classes=c),
         lambda: _stat_scores_update(rows, row_labels, reduce="macro", num_classes=c)),
    ]


@pytest.mark.parametrize("index", range(6))
def test_updates_off_the_route_do_not_take_it_and_keep_their_outputs(index):
    from tests.test_torch_classification import assert_same

    name, jax_call, port_call = _bypasses()[index]
    obs.reset()
    obs.enable()
    try:
        got = port_call()
        assert obs.counter_value("engine.logits_counts", form="confmat") == 0, name
        assert obs.counter_value("engine.logits_counts", form="stat_scores") == 0, name
    finally:
        obs.disable()
        obs.reset()
    want = jax_call()
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        assert_same(got, want)


def test_the_per_stream_update_keeps_its_route():
    # each row's own update, summed into its stream: the per-stream update counts through the one-hots
    c, streams = 5, 2
    logits, labels = make_case(4, c, (3, 5), torch.float32, torch.int64, seed=11)
    ids = torch.tensor([1, 0, 1, 1])
    obs.reset()
    obs.enable()
    try:
        got = _stat_scores_stream_update(logits, labels, ids, streams, reduce="macro", mdmc_reduce="global",
                                         num_classes=c)
        assert obs.counter_value("engine.logits_counts", form="stat_scores") == 0
    finally:
        obs.disable()
        obs.reset()
    for s in range(streams):
        rows = (ids == s).nonzero().flatten()
        want = [torch.zeros(c, dtype=torch.int32) for _ in range(4)]
        for r in rows:
            counts = one_hot_route(logits[r : r + 1], labels[r : r + 1], "stat_scores")
            want = [w + x for w, x in zip(want, counts)]
        assert_counts_equal(tuple(x[s] for x in got), tuple(want))


def test_the_counter_is_silent_while_obs_is_disabled():
    obs.reset()
    logits, labels = make_case(1, 4, (8,), torch.float32, torch.int64, seed=2)
    _confusion_matrix_update(logits, labels, 4)
    _stat_scores_update(logits, labels, reduce="micro", mdmc_reduce="global")
    assert obs.counter_value("engine.logits_counts", form="confmat") == 0
    assert obs.counter_value("engine.logits_counts", form="stat_scores") == 0


# ------------------------------------------------------------------------------------------------------------
# the kernel on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,c,spatial", SHAPES)
def test_kernel_matches_plain_on_the_card(cuda, n, c, spatial, dtype, label_dtype):
    for out_of_range in (False, True):
        logits, labels = make_case(n, c, spatial, DTYPES[dtype], label_dtype, seed=n + c, out_of_range=out_of_range,
                                   device=cuda)
        for form in FORMS:
            before = ops.fused_logits_counts.launches
            got = ops.fused_logits_counts(*flat(logits, labels), form)
            torch.cuda.synchronize()
            assert ops.fused_logits_counts.launches == before + 1
            assert_counts_equal(got, ops.fused_logits_counts_plain(*flat(logits, labels), form))


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_kernel_at_the_cityscapes_shape_matches_plain_and_allocates_only_its_outputs(cuda, form):
    gen = torch.Generator(device=cuda).manual_seed(5)
    logits = torch.rand((1, 19, 1024 * 2048), generator=gen, device=cuda)
    labels = torch.randint(0, 19, (1, 1024 * 2048), generator=gen, device=cuda)
    logits[:, 3, ::3] += 1.0  # long runs of one argmax, as a segmentation's
    expected = ops.fused_logits_counts_plain(logits, labels, form)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = ops.fused_logits_counts(logits, labels, form)
    torch.cuda.synchronize()
    outputs = sum(x.numel() * 4 for x in (got if isinstance(got, tuple) else (got,)))
    assert torch.cuda.max_memory_allocated() - base - outputs < 2**20
    assert_counts_equal(got, expected)


@pytest.mark.cuda
def test_routed_updates_launch_the_planes_kernel_on_the_card(cuda):
    logits, labels = make_case(2, 19, (64, 33), torch.float32, torch.int64, seed=9, device=cuda)
    col = mt.MetricCollection([mt.JaccardIndex(num_classes=19), mt.ConfusionMatrix(num_classes=19),
                               mt.Accuracy(num_classes=19, average="macro", mdmc_average="global")], device="cuda")
    before = (ops.fused_logits_counts.launches, ops.fused_stat_scores.launches)
    col(logits, labels)
    torch.cuda.synchronize()
    assert (ops.fused_logits_counts.launches - before[0], ops.fused_stat_scores.launches - before[1]) == (3, 0)
    cpu = mt.MetricCollection([mt.JaccardIndex(num_classes=19, device="cpu"),
                               mt.ConfusionMatrix(num_classes=19, device="cpu"),
                               mt.Accuracy(num_classes=19, average="macro", mdmc_average="global", device="cpu")],
                              device="cpu")
    cpu(logits.cpu(), labels.cpu())
    assert torch.equal(col["ConfusionMatrix"].confmat.cpu(), cpu["ConfusionMatrix"].confmat)
    for state in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(col["Accuracy"], state).cpu(), getattr(cpu["Accuracy"], state))
