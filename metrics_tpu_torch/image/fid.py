"""Frechet Inception Distance (counterpart of ``metrics_tpu/image/fid.py``).

The states are the sufficient statistics of the two Gaussian fits, per
distribution ``(sum, outer-product sum, count)`` in float32: fixed shape,
summed across processes, streaming for ever.  ``tr(sqrtm(S1 S2))`` is the sum
of the square roots of the eigenvalues of the symmetrised ``S1^1/2 S2 S1^1/2``
(two ``torch.linalg.eigh`` calls in float32, with clamped spectra), as the JAX
package computes it.
"""

from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.image._batching import ChunkedExtractorMixin
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import _sqrt
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _eigh(mat: torch.Tensor, vectors: bool = True):
    """``torch.linalg.eigh`` (or ``eigvalsh``), NaN where LAPACK refuses the matrix (a NaN
    covariance, from a distribution with no samples yet), as XLA's ``eigh`` gives NaN."""
    try:
        return torch.linalg.eigh(mat) if vectors else torch.linalg.eigvalsh(mat)
    except torch.linalg.LinAlgError:
        nan = torch.full_like(mat, float("nan"))
        return (nan[0], nan) if vectors else nan[0]


def _psd_sqrt(mat: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root through an eigendecomposition."""
    vals, vecs = _eigh((mat + mat.T) / 2.0)
    vals = torch.clamp(vals, min=0.0)
    return (vecs * _sqrt(vals)[None, :]) @ vecs.T


def _trace_sqrt_product(sigma1: torch.Tensor, sigma2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``tr(sqrtm(sigma1 @ sigma2))``: the eigenvalues of ``S1 S2`` are those of the
    symmetric PSD ``S1^1/2 S2 S1^1/2``, so the trace of the root is the sum of their roots."""
    s1_half = _psd_sqrt(sigma1 + eps * torch.eye(sigma1.shape[0], dtype=sigma1.dtype, device=sigma1.device))
    inner = s1_half @ sigma2 @ s1_half
    vals = _eigh((inner + inner.T) / 2.0, vectors=False)
    return _sqrt(torch.clamp(vals, min=0.0)).sum()


def _compute_fid(mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """``|mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 S2))``."""
    diff = mu1 - mu2
    tr_covmean = _trace_sqrt_product(sigma1, sigma2)
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean


def _builtin_extractor(metric: Metric, feature: Union[int, str], inception_params: Optional[dict], what: str):
    """The built-in Inception extractor of ``feature`` on the metric's device, with the JAX
    package's warning when no converted weights were found."""
    from metrics_tpu_torch.image.backbones.weights import make_inception_extractor

    extractor, pretrained = make_inception_extractor(str(feature), inception_params, device=metric.device)
    if not pretrained:
        rank_zero_warn(
            f"No converted Inception weights installed: {what} not comparable to published scores. "
            "Install a converted `inception_fid.npz` (see `metrics_tpu_torch.image.backbones.weights`) "
            "or pass `inception_params` for score parity.",
            UserWarning,
        )
    return extractor


class FrechetInceptionDistance(ChunkedExtractorMixin, Metric):
    """Streaming FID over a pluggable feature extractor.

    Args:
        feature: an integer (64 / 192 / 768 / 2048: a tap of the built-in
            Inception-v3, random-init unless weights are given or installed) or
            any callable mapping an image batch to ``(N, D)`` features.
        reset_real_features: keep the real distribution's statistics across
            ``reset()``.
        inception_params: the JAX package's Inception variables (or params).
        feature_dim: required when ``feature`` is a callable.
        extractor_batch: queue incoming images and run the extractor on chunks
            of this many (exact: the statistics are order-independent sums).
        extractor_dtype: compute dtype of the built-in Inception (e.g.
            ``torch.bfloat16``); ``None`` keeps full float32.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import FrechetInceptionDistance
        >>> def features(imgs):  # any callable to (N, D) features; feature=2048 is the built-in Inception
        ...     return imgs.flatten(1)[:, :4].float() / 255
        >>> fid = FrechetInceptionDistance(feature=features, feature_dim=4, device="cpu")
        >>> gen = torch.Generator().manual_seed(0)
        >>> fid.update(torch.randint(0, 256, (16, 3, 8, 8), generator=gen, dtype=torch.uint8), real=True)
        >>> fid.update(torch.randint(0, 200, (16, 3, 8, 8), generator=gen, dtype=torch.uint8), real=False)
        >>> round(float(fid.compute()), 4)
        0.1351
    """

    higher_is_better = False
    is_differentiable = False
    full_state_update = False

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        reset_real_features: bool = True,
        inception_params: Optional[dict] = None,
        feature_dim: Optional[int] = None,
        extractor_batch: Optional[int] = None,
        extractor_dtype: Optional[torch.dtype] = None,
        **kwargs: Any,
    ) -> None:
        from metrics_tpu_torch.image.backbones.inception import VALID_FEATURE_DIMS

        super().__init__(**kwargs)
        self._init_chunking(extractor_batch)
        if isinstance(feature, int):
            if feature not in VALID_FEATURE_DIMS:
                raise ValueError(
                    f"Integer input to argument `feature` must be one of {list(VALID_FEATURE_DIMS)},"
                    f" but got {feature}."
                )
            self.extractor = _builtin_extractor(self, feature, inception_params, "FID values will be "
                                                "architecture-consistent but")
            if extractor_dtype is not None:
                self.extractor.compute_dtype = extractor_dtype
            dim = feature
        elif callable(feature):
            if feature_dim is None:
                raise ValueError("`feature_dim` is required when `feature` is a callable")
            self.extractor = feature
            dim = feature_dim
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        self.feature_dim = dim
        for side in ("real", "fake"):
            self.add_state(f"{side}_sum", default=torch.zeros(dim), dist_reduce_fx="sum")
            self.add_state(f"{side}_outer", default=torch.zeros(dim, dim), dist_reduce_fx="sum")
            self.add_state(f"{side}_n", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, imgs: Any, real: bool) -> None:
        self._push_or_ingest(bool(real), imgs)

    def _ingest_chunk(self, key: bool, imgs: Any) -> None:
        features = torch.as_tensor(self.extractor(imgs), device=self.device).to(self.real_sum.dtype)
        side = "real" if key else "fake"
        setattr(self, f"{side}_sum", getattr(self, f"{side}_sum") + features.sum(dim=0))
        setattr(self, f"{side}_outer", getattr(self, f"{side}_outer") + features.T @ features)
        setattr(self, f"{side}_n", getattr(self, f"{side}_n") + features.shape[0])

    @staticmethod
    def _mean_cov(total: torch.Tensor, outer: torch.Tensor, n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = total / n
        # the unbiased covariance from the streaming moments
        cov = (outer - n * torch.outer(mean, mean)) / (n - 1)
        return mean, cov

    def compute(self) -> torch.Tensor:
        mu1, sigma1 = self._mean_cov(self.real_sum, self.real_outer, self.real_n)
        mu2, sigma2 = self._mean_cov(self.fake_sum, self.fake_outer, self.fake_n)
        return _compute_fid(mu1, sigma1, mu2, sigma2)

    def reset(self) -> None:
        self._drain_real_before_reset()
        self._reset_chunking()
        if self.reset_real_features:
            super().reset()
            return
        saved = {k: getattr(self, k) for k in ("real_sum", "real_outer", "real_n")}
        super().reset()
        for key, value in saved.items():
            setattr(self, key, value)

    def _reset_for_forward(self) -> None:
        # a full reset: forward's merge adds the kept real statistics back, so keeping them here would count them twice
        Metric.reset(self)
