"""Inception Score (counterpart of ``metrics_tpu/image/inception.py``).

The features are shuffled by the JAX package's ``permutation(PRNGKey(42), n)``
(:func:`metrics_tpu_torch.streaming._threefry.permutation`) and split as its
code splits them, ``jnp.array_split`` with the empty chunks dropped, that is
``torch.tensor_split`` (25 rows into 10 splits: five of 3, five of 2), not
``torch.chunk`` (eight of 3 and one of 1).
"""

from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.image._batching import ChunkedExtractorMixin
from metrics_tpu_torch.image.fid import _builtin_extractor
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.streaming import _threefry
from metrics_tpu_torch.utils.data import dim_zero_cat


class InceptionScore(ChunkedExtractorMixin, Metric):
    """IS = exp(E_x KL(p(y|x) || p(y))) over ``splits`` chunks; ``compute()`` returns the
    chunks' mean and (sample) standard deviation.  The per-sample logits are kept: the
    marginal p(y) depends on the final split.

    Args:
        extractor_batch: queue incoming images and run the extractor on chunks
            of this many (exact: the feature rows are per image).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import InceptionScore
        >>> def logits(imgs):  # feature="logits_unbiased" is the built-in Inception's
        ...     return imgs.flatten(1)[:, :10].float() / 64
        >>> metric = InceptionScore(feature=logits, splits=2, device="cpu")
        >>> metric.update(torch.randint(0, 256, (16, 3, 8, 8), generator=torch.Generator().manual_seed(0),
        ...                             dtype=torch.uint8))
        >>> [round(float(v), 4) for v in metric.compute()]
        [1.4621, 0.013]
    """

    higher_is_better = True
    is_differentiable = False
    full_state_update = False

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
        inception_params: Optional[dict] = None,
        extractor_batch: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        from metrics_tpu_torch.image.backbones.inception import VALID_FEATURE_DIMS

        super().__init__(**kwargs)
        self._init_chunking(extractor_batch)
        if isinstance(feature, (int, str)):
            valid = ("logits_unbiased",) + tuple(VALID_FEATURE_DIMS)
            if feature not in valid and str(feature) not in map(str, valid):
                raise ValueError(f"Input to argument `feature` must be one of {list(valid)}, but got {feature}.")
            self.extractor = _builtin_extractor(self, feature, inception_params, "scores are")
        elif callable(feature):
            self.extractor = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")
        self.splits = splits
        self.add_state("features", default=[], dist_reduce_fx="cat")

    def update(self, imgs: Any) -> None:
        self._push_or_ingest(None, imgs)

    def _ingest_chunk(self, key: Any, imgs: Any) -> None:
        with _obs.span("extractor.forward", metric=type(self).__name__):
            features = torch.as_tensor(self.extractor(imgs), device=self.device)
        self.features.append(features)

    def reset(self) -> None:
        self._reset_chunking()
        super().reset()

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        features = dim_zero_cat(self.features)
        features = features[_threefry.permutation(_threefry.seed(42, features.device), features.shape[0])]
        log_prob = torch.log_softmax(features, dim=1)
        prob = torch.exp(log_prob)
        kl_ = []
        for p, lp in zip(torch.tensor_split(prob, self.splits), torch.tensor_split(log_prob, self.splits)):
            if not p.shape[0]:
                continue
            mean_p = p.mean(dim=0, keepdim=True)
            kl = p * (lp - torch.log(mean_p))
            kl_.append(torch.exp(kl.sum(dim=1).mean()))
        kl = torch.stack(kl_)
        return kl.mean(), kl.std(correction=1)
