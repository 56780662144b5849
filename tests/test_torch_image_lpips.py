"""The port's LPIPS (the VGG16, AlexNet and SqueezeNet-1.1 nets and the metric) against the JAX package's.

The JAX package's params trees are laid out by ``jax.eval_shape`` of its
``_LpipsBackbone`` and filled from a seeded numpy generator, then carried into
the port by ``lpips_state_dict_from_flax``.  Distances and the metric's sums:
``rtol=1e-4, atol=1e-6``; gradients with respect to the first image:
``rtol=1e-3, atol=1e-6`` (float32 through up to 13 convolutions and back).
"""

import numpy as np
import pytest
import torch

NETS = ("alex", "vgg", "squeeze")


def _params(net_type: str, seed: int) -> dict:
    """The JAX ``_LpipsBackbone(net_type)`` params: laid out by ``eval_shape`` of its init, filled
    from numpy (kernels normal over sqrt(fan-in), biases small)."""
    import jax
    import jax.numpy as jnp

    from metrics_tpu.image.lpip import _LpipsBackbone

    rng = np.random.default_rng(seed)
    image = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(_LpipsBackbone(net_type).init, jax.random.PRNGKey(0), image, image)["params"]

    def leaf(name, s):
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else leaf(k, v) for k, v in tree.items()}

    return walk(shapes)

@pytest.fixture(scope="module")
def lpips_pairs():
    rng = np.random.default_rng(4)
    return [rng.uniform(-1, 1, size=(2, 3, 64, 64)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("net_type", NETS)
def test_lpips_distances_and_gradients_match_the_jax_nets(lpips_pairs, net_type):
    import jax
    import jax.numpy as jnp

    from metrics_tpu.image.lpip import _LpipsBackbone, _clamp_head_weights
    from metrics_tpu_torch.image.lpip import make_lpips_net

    module = _LpipsBackbone(net_type)
    params = _params(net_type, seed=5)
    variables = _clamp_head_weights({"params": params})
    a, b = lpips_pairs
    a_nhwc, b_nhwc = (jnp.asarray(x.transpose(0, 2, 3, 1)) for x in (a, b))

    def total(x, v, y):
        out = module.apply(v, x, y)
        return out.sum(), out

    # the weights go in as arguments: as closure constants XLA would fold them for seconds
    (_, want), want_grad = jax.jit(jax.value_and_grad(total, has_aux=True))(a_nhwc, variables, b_nhwc)
    want, want_grad = np.asarray(want), np.asarray(want_grad).transpose(0, 3, 1, 2)
    net, pretrained = make_lpips_net(net_type, params)
    assert pretrained
    x = torch.from_numpy(a).requires_grad_(True)
    got = net(x, torch.from_numpy(b))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-3, atol=1e-6)
    assert all(p.grad is None for p in net.parameters())


@pytest.mark.parametrize("extractor_batch", [None, 3], ids=["per-call", "chunked"])
def test_the_metric_matches_the_jax_metric(extractor_batch):
    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    params = _params("alex", seed=6)
    rng = np.random.default_rng(7)
    pairs = [rng.uniform(0, 1, size=(2, 2, 3, 64, 64)).astype(np.float32) for _ in range(3)]
    for reduction in ("mean", "sum"):
        ref = jm.LearnedPerceptualImagePatchSimilarity("alex", reduction=reduction, normalize=True,
                                                       lpips_params=params, extractor_batch=extractor_batch)
        port = mt.LearnedPerceptualImagePatchSimilarity("alex", reduction=reduction, normalize=True,
                                                        lpips_params=params, extractor_batch=extractor_batch,
                                                        device="cpu")
        for a, b in pairs:
            ref.update(a, b)
            port.update(torch.from_numpy(a).permute(0, 2, 3, 1), torch.from_numpy(b).permute(0, 2, 3, 1))  # NHWC
        np.testing.assert_allclose(port.sum_scores.numpy(), np.asarray(ref.sum_scores), rtol=1e-4, atol=1e-6)
        assert float(port.total) == float(ref.total) == 6.0
        np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=1e-4, atol=1e-6)
    assert not any(k.startswith("_net") for k in port.state_dict())  # the net's weights are not states
