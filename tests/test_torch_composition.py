"""The port's operator algebra (``CompositionalMetric``) against the JAX package's.

Every case of ``tests/bases/test_composition.py`` runs in both packages on
the same inputs and the port's value must equal the JAX
``CompositionalMetric``'s in dtype and bits (both compute in float32; the
operators are single IEEE operations, so no tolerance is needed).  The
binary operators also run on seeded vectors with negative values, where
floor division and ``%`` must round as the JAX package does (``%`` as
Python's; a zero floor quotient signed as ``jnp.floor_divide`` signs it).
Then what a composition is as an ``nn.Module``: ``hash``,
``named_modules()``, ``.to()``, ``state_dict()`` (none of its operands'
states, as in the JAX package) and ``==`` no longer meaning identity.
"""

import numpy as np
import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu import CompositionalMetric as JaxCompositional
from tests.bases.dummies import DummyMetricDiff as JaxDiff
from tests.bases.dummies import DummyMetricSum as JaxSum


class DummyMetricSum(mt.Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + torch.as_tensor(x, dtype=torch.float32)

    def compute(self):
        return self.x


class DummyMetricDiff(DummyMetricSum):
    def update(self, y):
        self.x = self.x - torch.as_tensor(y, dtype=torch.float32)


PKGS = {"port": (DummyMetricSum, DummyMetricDiff), "jax": (JaxSum, JaxDiff)}


def _value(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_bitwise(port, ref):
    port, ref = _value(port), _value(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape, (port.dtype, ref.dtype, port.shape, ref.shape)
    assert port.tobytes() == ref.tobytes(), (port, ref)


def _both(case):
    """Run ``case(Sum, Diff)`` in both packages; returns (port value, JAX value)."""
    return case(*PKGS["port"]), case(*PKGS["jax"])


BINARY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "truediv": lambda a, b: a / b,
    "pow": lambda a, b: a**b,
    "mod": lambda a, b: a % b,
    "floordiv": lambda a, b: a // b,
}
EXPECTED = {"add": 6.0, "sub": 2.0, "mul": 8.0, "truediv": 2.0, "pow": 16.0, "mod": 0.0, "floordiv": 2.0}
COMPARE = {
    "gt": lambda a, b: a > b, "lt": lambda a, b: a < b, "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b, "ge": lambda a, b: a >= b, "le": lambda a, b: a <= b,
}


def test_add():
    def case(Sum, Diff):
        a, b = Sum(), Diff()
        c = a + b
        a.update(2.0)
        b.update(1.0)
        return c.compute()

    port, ref = _both(case)
    assert float(port) == 1.0
    assert_bitwise(port, ref)


@pytest.mark.parametrize("side", ["right", "left"])
def test_add_scalar(side):
    def case(Sum, Diff):
        a = Sum()
        c = a + 5.0 if side == "right" else 5.0 + a
        a.update(2.0)
        return c.compute()

    port, ref = _both(case)
    assert float(port) == 7.0
    assert_bitwise(port, ref)


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_ops(op):
    def case(Sum, Diff):
        a, b = Sum(), Sum()
        c = BINARY[op](a, b)
        a.update(4.0)
        b.update(1.0)
        b.update(1.0)
        return c.compute()

    port, ref = _both(case)
    assert float(port) == EXPECTED[op]
    assert_bitwise(port, ref)


@pytest.mark.parametrize("op", sorted(BINARY))
@pytest.mark.parametrize("reflected", [False, True], ids=["metric_scalar", "scalar_metric"])
def test_binary_ops_on_seeded_vectors(op, reflected):
    rng = np.random.default_rng(3)
    a_vals = (rng.standard_normal(6) * 4).astype(np.float32)
    b_vals = (rng.standard_normal(6) * 3).astype(np.float32)
    if op == "pow":
        a_vals = np.abs(a_vals)  # a real power of a negative base is NaN in both

    def case(Sum, Diff):
        a, b = Sum(), Sum()
        c = BINARY[op](a, b) if not reflected else BINARY[op](2.5, a)
        a.update(a_vals)
        b.update(b_vals)
        return c.compute()

    port, ref = _both(case)
    assert_bitwise(port, ref)


def test_comparison_ops():
    def case(Sum, Diff):
        a, b = Sum(), Sum()
        a.update(4.0)
        b.update(2.0)
        return [COMPARE[name](a, b).compute() for name in sorted(COMPARE)]

    port, ref = _both(case)
    assert [bool(v) for v in port] == [False, True, True, False, False, True]  # eq ge gt le lt ne
    for p, r in zip(port, ref):
        assert_bitwise(p, r)


@pytest.mark.parametrize("op", ["and", "or", "xor"])
def test_bitwise_ops_on_comparisons(op):
    def case(Sum, Diff):
        a, b = Sum(), Sum()
        gt, ne = a > b, a != b
        c = {"and": gt & ne, "or": gt | ne, "xor": gt ^ ne}[op]
        a.update(np.asarray([1.0, 2.0, 3.0], np.float32))
        b.update(np.asarray([1.0, 3.0, 2.0], np.float32))
        return c.compute()

    port, ref = _both(case)
    assert_bitwise(port, ref)


def test_matmul():
    def case(Sum, Diff):
        a, b = Sum(), Sum()
        a.update(np.asarray([1.0, 2.0, 3.0], np.float32))
        b.update(np.asarray([0.5, -1.0, 4.0], np.float32))
        return (a @ b).compute(), (b @ a).compute()

    port, ref = _both(case)
    for p, r in zip(port, ref):
        assert_bitwise(p, r)


def test_unary_ops():
    def case(Sum, Diff):
        a = Sum()
        a.update(-3.0)
        return abs(a).compute(), (-a).compute(), (+a).compute(), (~(a > 0.0)).compute()

    port, ref = _both(case)
    assert [float(v) for v in port[:3]] == [3.0, -3.0, 3.0]  # the reference's quirks: -x is -|x|, +x is |x|
    for p, r in zip(port, ref):
        assert_bitwise(p, r)


def test_neg_is_minus_abs_of_a_positive_value():
    def case(Sum, Diff):
        a = Sum()
        a.update(2.0)
        return (-a).compute()

    port, ref = _both(case)
    assert float(port) == -2.0
    assert_bitwise(port, ref)


def test_getitem():
    def case(Sum, Diff):
        a = Sum()
        a.update(np.asarray([1.0, 2.0, 3.0], np.float32))
        return a[1].compute()

    port, ref = _both(case)
    assert float(port) == 2.0
    assert_bitwise(port, ref)


def test_update_routes_to_children():
    def case(Sum, Diff):
        a, b = Sum(), Sum()
        c = a + b
        c.update(3.0)
        return a.x, b.x, c.compute()

    port, ref = _both(case)
    assert [float(v) for v in port] == [3.0, 3.0, 6.0]
    for p, r in zip(port, ref):
        assert_bitwise(p, r)


def test_forward_composition():
    def case(Sum, Diff):
        a, b = Sum(), Sum()
        return (a + b)(1.0)

    port, ref = _both(case)
    assert float(port) == 2.0
    assert_bitwise(port, ref)


def test_nested_composition():
    def case(Sum, Diff):
        a, b = Sum(), Sum()
        c = (a + b) * 2.0
        a.update(1.0)
        b.update(2.0)
        return c.compute()

    port, ref = _both(case)
    assert float(port) == 6.0
    assert_bitwise(port, ref)


def test_compositional_reset():
    def case(Sum, Diff):
        a = Sum()
        c = a + 1.0
        a.update(2.0)
        first = c.compute()
        c.reset()
        return first, a.x

    port, ref = _both(case)
    assert [float(v) for v in port] == [3.0, 0.0]
    for p, r in zip(port, ref):
        assert_bitwise(p, r)


def test_real_metrics_compose_like_jax():
    """``(F1 + Accuracy) / 2``, ``-Precision`` and ``Accuracy(average=None)[2]`` fed by ``forward``."""
    import jax.numpy as jnp

    import metrics_tpu as jm

    rng = np.random.default_rng(11)
    batches = [(rng.random((16, 4)).astype(np.float32), rng.integers(0, 4, 16)) for _ in range(3)]

    def build(pkg, **kw):
        return [
            (pkg.F1Score(num_classes=4, average="macro", **kw) + pkg.Accuracy(num_classes=4, **kw)) / 2,
            -pkg.Precision(num_classes=4, average="macro", **kw),
            pkg.Accuracy(num_classes=4, average=None, **kw)[2],
        ]

    port = build(mt, device="cpu")
    ref = build(jm, jit_update=False, jit_compute=False)
    for scores, labels in batches:
        for p, r in zip(port, ref):
            assert_bitwise(p(torch.from_numpy(scores), torch.from_numpy(labels)), r(jnp.asarray(scores), jnp.asarray(labels)))
    for p, r in zip(port, ref):
        assert_bitwise(p.compute(), r.compute())
    assert isinstance(ref[0], JaxCompositional) and isinstance(port[0], mt.CompositionalMetric)


# ------------------------------------------------------------ as a module
def test_hash_of_metrics_and_compositions():
    m1, m2 = DummyMetricSum(), DummyMetricSum()
    assert hash(m1) != hash(m2)
    h1 = hash(m1)
    m1.update(1.0)
    assert hash(m1) != h1  # the state was rebound, as in the JAX package
    c = m1 + m2
    assert isinstance(hash(c), int) and hash(c) != hash(m1 + m2)
    assert len({m1, m2, c}) == 3


def test_compute_group_members_keep_distinct_hashes():
    col = mt.MetricCollection(
        {"a": mt.Accuracy(num_classes=3, device="cpu"), "b": mt.Accuracy(num_classes=3, device="cpu")}, device="cpu"
    )
    col.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    assert col.compute_groups == {0: ["a", "b"]}
    assert col["a"].tp is col["b"].tp  # shared state tensors
    assert [name for name, _ in col.named_modules()] == ["", "a", "b"]


def test_named_modules_to_and_state_dict_of_a_composition():
    a, b = DummyMetricSum(), DummyMetricDiff()
    c = (a + b) * 2.0
    names = [name for name, _ in c.named_modules()]
    assert names == ["", "metric_a", "metric_a.metric_a", "metric_a.metric_b"]
    assert c.to("cpu") is c and c.to(torch.float32) is c
    a.persistent(True)
    b.persistent(True)
    a.update(1.0)
    assert set(a.state_dict()) == {"x"}
    # the JAX package's state_dict holds only the composition's own states, of which it has none
    assert dict(c.state_dict()) == {} and dict(c.metric_a.state_dict()) == {}
    assert JaxCompositional(np.add, JaxSum(), JaxSum()).state_dict() == {}
    c.load_state_dict(c.state_dict())
    with pytest.raises(RuntimeError, match="Unexpected key"):
        c.load_state_dict({"metric_a.metric_a.x": torch.tensor(1.0)})
    assert float(c.compute()) == 2.0 * (1.0 - 0.0)


def test_eq_builds_a_composition():
    a, b = DummyMetricSum(), DummyMetricSum()
    assert isinstance(a == b, mt.CompositionalMetric)
    assert isinstance(a != b, mt.CompositionalMetric)
    assert a in [a] and a in {a}  # identity still finds a metric in a container


def test_scalar_operand_is_a_tensor_on_the_metric_device():
    a = DummyMetricSum()
    c = a + 5
    assert isinstance(c.metric_b, torch.Tensor) and c.metric_b.device == a.device and c.metric_b.dtype == torch.int32
    assert (a * 0.5).metric_b.dtype == torch.float32
    assert c.device == a.device
    assert repr(a) == "DummyMetricSum()" and repr(c).startswith("CompositionalMetric(\n  add(\n    DummyMetricSum(),")
