"""LPIPS (counterpart of ``metrics_tpu/image/lpip.py``).

Learned Perceptual Image Patch Similarity: deep features from several stages
of a backbone, each unit-normalised over its channels, their squared
difference weighted by a learned 1x1 head (clamped at >= 0), averaged over
space and summed over the stages.  The backbones are the VGG16, AlexNet and
SqueezeNet-1.1 feature stacks the ``lpips`` package taps, written here as
``torch.nn.Module``s with torchvision's ``features.*`` names and the lpips
package's ``lin{k}.model.1`` heads (torchvision itself is not imported).
Pass the JAX package's ``lpips_params`` (converted by
:func:`~metrics_tpu_torch.image.backbones.convert.lpips_state_dict_from_flax`),
install a converted ``.npz``, or any callable ``net(img1, img2) -> (N,)``.

The convolutions run in full float32 (cuDNN's TF32 off for these calls).
LPIPS is differentiable: gradients with respect to the images flow through
autograd; the backbone's weights take none.
"""

from typing import Any, Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.image._batching import ChunkedExtractorMixin
from metrics_tpu_torch.image.backbones.inception import _random_init, full_float32, load_weights
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn

# the lpips package's input normalisation (ImageNet statistics on [-1, 1] images)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision squeezenet1_1 ``features`` indices of the Fire modules with their
# (input, squeeze, expand) widths, and the fire outputs the lpips package taps
_SQUEEZE_FIRE_SPECS = {
    3: (64, 16, 64), 4: (128, 16, 64), 6: (128, 32, 128), 7: (256, 32, 128),
    9: (256, 48, 192), 10: (384, 48, 192), 11: (384, 64, 256), 12: (512, 64, 256),
}
_SQUEEZE_TAP_AFTER = (4, 7, 9, 10, 11, 12)
_CHANNELS = {"vgg": (64, 128, 256, 512, 512), "alex": (64, 192, 384, 256, 256),
             "squeeze": (64, 128, 256, 384, 384, 512, 512)}


class _Fire(nn.Module):
    """SqueezeNet Fire module: 1x1 squeeze, then 1x1 and 3x3 expands concatenated, ReLU after each."""

    def __init__(self, cin: int, squeeze: int, expand: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], 1)


class _Lin(nn.Module):
    """An lpips head: a 1x1 convolution to one channel, no bias (``lin{k}.model.1``)."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def _features(net_type: str) -> nn.Sequential:
    """torchvision's ``features`` stack of the backbone (the layers LPIPS runs)."""
    if net_type == "vgg":
        layers: List[nn.Module] = []
        cin = 3
        for stage, (ch, depth) in enumerate(zip((64, 128, 256, 512, 512), (2, 2, 3, 3, 3))):
            if stage:
                layers.append(nn.MaxPool2d(2, 2))
            for _ in range(depth):
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
        return nn.Sequential(*layers)
    if net_type == "alex":
        return nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
        )
    if net_type == "squeeze":
        layers = [nn.Conv2d(3, 64, 3, stride=2), nn.ReLU()]
        for idx in range(2, 13):  # a ceil-mode max pool at 2, 5 and 8, Fire modules elsewhere
            layers.append(_Fire(*_SQUEEZE_FIRE_SPECS[idx]) if idx in _SQUEEZE_FIRE_SPECS
                          else nn.MaxPool2d(3, 2, ceil_mode=True))
        return nn.Sequential(*layers)
    raise ValueError(f"unknown LPIPS net_type {net_type!r}")


class LpipsNet(nn.Module):
    """Backbone plus the clamped linear heads; ``forward(img0, img1)`` on NCHW images in
    [-1, 1] returns the per-pair distance ``(N,)``."""

    def __init__(self, net_type: str = "vgg") -> None:
        super().__init__()
        self.net_type = net_type
        self.features = _features(net_type)
        for k, ch in enumerate(_CHANNELS[net_type]):
            self.add_module(f"lin{k}", _Lin(ch))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def _tap_after(self) -> Tuple[int, ...]:
        """Indices of ``features`` whose outputs LPIPS taps."""
        if self.net_type == "vgg":
            return (3, 8, 15, 22, 29)
        if self.net_type == "alex":
            return (1, 4, 7, 9, 11)
        return (1,) + _SQUEEZE_TAP_AFTER

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x - self.shift) / self.scale
        out = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._tap_after():
                out.append(x)
        return out

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        total = torch.zeros(img0.shape[0], dtype=img0.dtype, device=img0.device)
        for k, (f0, f1) in enumerate(zip(self.taps(img0), self.taps(img1))):
            f0 = f0 / torch.clamp(torch.linalg.vector_norm(f0, dim=1, keepdim=True), min=1e-10)
            f1 = f1 / torch.clamp(torch.linalg.vector_norm(f1, dim=1, keepdim=True), min=1e-10)
            diff = getattr(self, f"lin{k}")((f0 - f1) ** 2)
            total = total + diff.mean(dim=(2, 3))[:, 0]
        return total

    def clamp_heads(self) -> "LpipsNet":
        """Clamp the heads' kernels at >= 0 (a no-op for trained weights; the random init needs it)."""
        with torch.no_grad():
            for k in range(len(_CHANNELS[self.net_type])):
                weight = getattr(self, f"lin{k}").model[1].weight
                weight.clamp_(min=0.0)
        return self


class _BuiltinNet:
    """The built-in backbone as a callable that keeps its weights out of the metric's module tree
    (they are not states: not in ``state_dict``, checkpoints or syncs) and runs in full float32."""

    def __init__(self, net: LpipsNet) -> None:
        self.module = net

    def to(self, device: Union[str, torch.device]) -> "_BuiltinNet":
        self.module.to(device)
        return self

    def __call__(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        with full_float32():
            return self.module(img0, img1)


def make_lpips_net(net_type: str, lpips_params: Optional[dict] = None, device: Any = "cpu") -> Tuple[LpipsNet, bool]:
    """The built-in LPIPS network of ``net_type`` (heads clamped at >= 0, eval mode, no gradient
    to its weights), from the JAX package's ``lpips_params``, else an installed converted file,
    else a seeded random init.  Returns ``(net, pretrained)``."""
    from metrics_tpu_torch.image.backbones.convert import lpips_state_dict_from_flax
    from metrics_tpu_torch.image.backbones.weights import load_lpips_params

    if lpips_params is None:
        lpips_params = load_lpips_params(net_type)
    net = LpipsNet(net_type)
    if lpips_params is None:
        _random_init(net)
    else:
        load_weights(net, lpips_state_dict_from_flax(lpips_params, net_type))
    net.clamp_heads().eval().requires_grad_(False)
    return net.to(device), lpips_params is not None


class LearnedPerceptualImagePatchSimilarity(ChunkedExtractorMixin, Metric):
    """Streaming LPIPS with scalar sum and count states.

    Args:
        net_type: ``'vgg' | 'alex' | 'squeeze'``, the built-in backbone; or pass
            ``net`` (a callable ``(img1, img2) -> (N,)``).
        reduction: ``'mean'`` or ``'sum'`` over the accumulated scores.
        normalize: inputs are in ``[0, 1]`` and are shifted to ``[-1, 1]``.
        lpips_params: the JAX package's converted params of the backbone.
        extractor_batch: queue incoming image pairs and run the backbone on
            chunks of this many pairs (exact: scores are per-pair sums; ``None``
            runs it at the caller's batch size).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LearnedPerceptualImagePatchSimilarity
        >>> metric = LearnedPerceptualImagePatchSimilarity(net_type="squeeze", device="cpu")  # random init: warns
        >>> gen = torch.Generator().manual_seed(0)
        >>> metric.update(torch.rand(2, 3, 64, 64, generator=gen) * 2 - 1, torch.rand(2, 3, 64, 64, generator=gen) * 2 - 1)
        >>> round(float(metric.compute()), 4)
        0.1083
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        net: Optional[Callable] = None,
        lpips_params: Optional[dict] = None,
        extractor_batch: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._init_chunking(extractor_batch)
        valid_net_type = ("vgg", "alex", "squeeze")
        if net is None:
            if net_type not in valid_net_type:
                raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
            module, pretrained = make_lpips_net(net_type, lpips_params, self.device)
            if not pretrained:
                rank_zero_warn(
                    "No converted LPIPS weights installed: scores are not comparable to "
                    "published numbers. Install a converted `lpips_<net>.npz` (see "
                    "`metrics_tpu_torch.image.backbones.weights`) or pass `lpips_params` for parity.",
                    UserWarning,
                )
            net = _BuiltinNet(module)
        self._net = net
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        self.normalize = normalize
        self.add_state("sum_scores", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def _prepare(self, img: Any) -> torch.Tensor:
        """Images as float32 NCHW (NHWC is read where ``shape[1] != 3 or shape[-1] == 3``)."""
        img = torch.as_tensor(img).to(torch.float32)
        if img.ndim != 4:
            raise ValueError(f"Expected 4d image batch, got shape {tuple(img.shape)}")
        if not (img.shape[1] == 3 and img.shape[-1] != 3):
            img = img.permute(0, 3, 1, 2)
        if self.normalize:
            img = 2 * img - 1
        return img

    def update(self, img1: torch.Tensor, img2: torch.Tensor) -> None:
        a, b = self._prepare(img1), self._prepare(img2)
        if self._queue is None:
            self._score(a, b)
            return
        # pairs stack along a new axis so both sides chunk in lockstep
        self._push_or_ingest(None, torch.stack([a, b], dim=1))

    def _ingest_chunk(self, key: Any, pairs: torch.Tensor) -> None:
        pairs = torch.as_tensor(pairs, device=self.device)
        self._score(pairs[:, 0], pairs[:, 1])

    def _score(self, a: torch.Tensor, b: torch.Tensor) -> None:
        scores = self._net(a, b)
        self.sum_scores = self.sum_scores + scores.sum()
        self.total = self.total + scores.shape[0]

    def reset(self) -> None:
        self._reset_chunking()
        super().reset()

    def compute(self) -> torch.Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores
