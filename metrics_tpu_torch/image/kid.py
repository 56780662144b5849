"""Kernel Inception Distance (counterpart of ``metrics_tpu/image/kid.py``).

The subsets are the JAX package's draws, bit for bit, from ``seed``:
``split(PRNGKey(seed))`` gives a key per distribution, ``split(k, subsets)`` a
key per subset, and each subset is the first ``subset_size`` entries of
``permutation(k, n)`` (:mod:`metrics_tpu_torch.streaming._threefry`).  The
subsets' MMD estimates run one after another, as the JAX package's
``lax.map`` runs them.
"""

from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.image._batching import ChunkedExtractorMixin
from metrics_tpu_torch.image.fid import _builtin_extractor
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.streaming import _threefry
from metrics_tpu_torch.utils.data import dim_zero_cat


def _integer_pow(x: torch.Tensor, degree: int) -> torch.Tensor:
    """``x ** degree`` by the square-and-multiply order of XLA's ``integer_pow``
    (``x * (x * x)`` for 3), so the float32 roundings are the JAX package's."""
    acc, base = None, x
    while degree > 0:
        if degree & 1:
            acc = base if acc is None else acc * base
        degree >>= 1
        if degree > 0:
            base = base * base
    return acc


def maximum_mean_discrepancy(k_xx: torch.Tensor, k_xy: torch.Tensor, k_yy: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD^2 estimate from kernel matrices."""
    m = k_xx.shape[0]
    kt_xx_sum = (k_xx.sum(dim=-1) - torch.diag(k_xx)).sum()
    kt_yy_sum = (k_yy.sum(dim=-1) - torch.diag(k_yy)).sum()
    k_xy_sum = k_xy.sum()
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def poly_kernel(f1: torch.Tensor, f2: torch.Tensor, degree: int = 3, gamma: Optional[float] = None,
                coef: float = 1.0) -> torch.Tensor:
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    return _integer_pow(f1 @ f2.T * gamma + coef, degree)


def poly_mmd(f_real: torch.Tensor, f_fake: torch.Tensor, degree: int = 3, gamma: Optional[float] = None,
             coef: float = 1.0) -> torch.Tensor:
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


def kid_subsets(seed: int, subsets: int, subset_size: int, n_real: int, n_fake: int,
                device: Any = "cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(subsets, subset_size)`` int64 row indices of the real and the fake features that
    the JAX package's KID draws from ``seed``."""
    k_real, k_fake = _threefry.split(_threefry.seed(seed, device))
    real_idx = _threefry.permutation(_threefry.split(k_real, subsets), n_real)[:, :subset_size]
    fake_idx = _threefry.permutation(_threefry.split(k_fake, subsets), n_fake)[:, :subset_size]
    return real_idx, fake_idx


class KernelInceptionDistance(ChunkedExtractorMixin, Metric):
    """KID: the polynomial-kernel MMD over random subsets of the features; ``compute()``
    returns their mean and (population) standard deviation.

    Args:
        extractor_batch: queue incoming images and run the extractor on chunks
            of this many (exact: the feature rows are per image).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KernelInceptionDistance
        >>> def features(imgs):
        ...     return imgs.flatten(1)[:, :4].float() / 255
        >>> kid = KernelInceptionDistance(feature=features, subsets=3, subset_size=8, device="cpu")
        >>> gen = torch.Generator().manual_seed(0)
        >>> kid.update(torch.randint(0, 256, (16, 3, 8, 8), generator=gen, dtype=torch.uint8), real=True)
        >>> kid.update(torch.randint(0, 200, (16, 3, 8, 8), generator=gen, dtype=torch.uint8), real=False)
        >>> [round(float(v), 4) for v in kid.compute()]
        [0.0279, 0.0502]
    """

    higher_is_better = False
    is_differentiable = False
    full_state_update = False

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        inception_params: Optional[dict] = None,
        seed: int = 17,
        extractor_batch: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        from metrics_tpu_torch.image.backbones.inception import VALID_FEATURE_DIMS

        super().__init__(**kwargs)
        self._init_chunking(extractor_batch)
        if isinstance(feature, int):
            if feature not in VALID_FEATURE_DIMS:
                raise ValueError(
                    f"Integer input to argument `feature` must be one of {list(VALID_FEATURE_DIMS)}, but got {feature}."
                )
            self.extractor = _builtin_extractor(self, feature, inception_params, "scores are")
        elif callable(feature):
            self.extractor = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.subsets = subsets
        self.subset_size = subset_size
        self.degree = degree
        self.gamma = gamma
        self.coef = coef
        self.reset_real_features = reset_real_features
        self.seed = seed
        self.add_state("real_features", default=[], dist_reduce_fx="cat")
        self.add_state("fake_features", default=[], dist_reduce_fx="cat")

    def update(self, imgs: Any, real: bool) -> None:
        self._push_or_ingest(bool(real), imgs)

    def _ingest_chunk(self, key: bool, imgs: Any) -> None:
        with _obs.span("extractor.forward", metric=type(self).__name__):
            features = torch.as_tensor(self.extractor(imgs), device=self.device)
        (self.real_features if key else self.fake_features).append(features)

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        real = dim_zero_cat(self.real_features)
        fake = dim_zero_cat(self.fake_features)
        n_real, n_fake = real.shape[0], fake.shape[0]
        if n_real < self.subset_size or n_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        real_idx, fake_idx = kid_subsets(self.seed, self.subsets, self.subset_size, n_real, n_fake, real.device)
        kid_scores = torch.stack([
            poly_mmd(real[ri], fake[fi], self.degree, self.gamma, self.coef) for ri, fi in zip(real_idx, fake_idx)
        ])
        return kid_scores.mean(), kid_scores.std(correction=0)

    def reset(self) -> None:
        self._drain_real_before_reset()
        self._reset_chunking()
        if self.reset_real_features:
            super().reset()
            return
        saved = self.real_features
        super().reset()
        self.real_features = saved

    def _reset_for_forward(self) -> None:
        # a full reset: forward's merge adds the kept real features back
        Metric.reset(self)
