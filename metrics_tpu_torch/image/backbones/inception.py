"""Inception-v3 feature extractor (counterpart of ``metrics_tpu/image/backbones/inception.py``).

The standard Inception-v3 topology with feature taps at 64 / 192 / 768 / 2048
features and the 1008 unbiased logits, as torch-fidelity exposes them.
Parameters carry the torchvision / torch-fidelity names (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch1x1.bn``, ``fc``), so a torch-fidelity state dict loads
as it is, and the JAX package's variables load through
:func:`~metrics_tpu_torch.image.backbones.convert.inception_state_dict_from_flax`.

Two variants share the parameters:

* ``fid_variant=True`` (default), the TF-graph port the published FID / IS /
  KID weights were trained under: the 3x3 stride-1 average pools of the
  branches leave the padding out of the divisor, the last Inception-E block
  max-pools its pool branch, and inputs are resized with the legacy TF1
  bilinear kernel (:func:`tf1_resize_bilinear`) and scaled ``(x - 128) / 128``;
* ``fid_variant=False``, the textbook topology: padded average pools, a
  half-pixel bilinear resize (:func:`resize_bilinear`, as ``jax.image.resize``
  does it) and ``(x / 255 - 0.5) * 2``.

The convolutions run in full float32: PyTorch lets cuDNN convolve float32 in
TF32 by default, so the extractor switches it off for its own calls
(``compute_dtype=torch.bfloat16`` is the opt-in fast path).  The optimized path
(:class:`FoldedInceptionV3`) folds each batch norm into its convolution and
fuses the parallel 1x1 heads of a block into one convolution.
"""

import contextlib
import copy
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VALID_FEATURE_DIMS = (64, 192, 768, 2048)
TAPS = ("64", "192", "768", "2048", "logits_unbiased")
NUM_CLASSES = 1008
BN_EPS = 1e-3


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """cuDNN convolutions in full float32 inside the block (TF32 off), whatever the process-wide setting."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        yield


def _pool_branch(x: torch.Tensor, kind: str) -> torch.Tensor:
    """3x3 stride-1 SAME pooling of a branch: ``avg`` counts the padded zeros in the
    divisor, ``avg_excl`` divides by the true overlap, ``max`` is the TF port's
    last Inception-E block."""
    if kind == "max":
        return F.max_pool2d(x, 3, stride=1, padding=1)
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=kind == "avg")


def tf1_resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Legacy TF1 ``resize_bilinear(align_corners=False)`` of NCHW floats.

    The source coordinate is ``dst * (in / out)`` from the corner (no half-pixel
    offset), built as XLA builds it: ``arange(out, float32) * float32(in / out)``.
    Not ``F.interpolate``, whose grid is half-pixel.
    """

    def interp(t: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
        in_size = t.shape[dim]
        if in_size == out_size:
            return t
        scale = torch.tensor(in_size / out_size, dtype=torch.float32)
        src = (torch.arange(out_size, dtype=torch.float32) * scale).to(t.device)
        i0 = torch.clamp(torch.floor(src).to(torch.int64), max=in_size - 1)
        i1 = torch.clamp(i0 + 1, max=in_size - 1)
        frac = src - i0.to(torch.float32)
        shape = [1] * t.ndim
        shape[dim] = out_size
        frac = frac.reshape(shape).to(t.dtype)
        return t.index_select(dim, i0) * (1.0 - frac) + t.index_select(dim, i1) * frac

    return interp(interp(x, 2, out_h), 3, out_w)


def _resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """The ``(out, in)`` float32 weights of ``jax.image.resize(method="bilinear")`` along one axis:
    a triangle kernel at half-pixel centres, widened by the scale when it shrinks (antialiasing),
    each row normalised, rows of samples outside the input zeroed."""
    inv_scale = torch.tensor(in_size / out_size, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - dist, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).T.contiguous().to(device)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, ..., method="bilinear")`` (antialiased) of NCHW floats, one
    weight matrix per axis."""
    if x.shape[2] != out_h:
        x = torch.einsum("oh,nchw->ncow", _resize_weights(x.shape[2], out_h, x.device).to(x.dtype), x)
    if x.shape[3] != out_w:
        x = torch.einsum("ow,nchw->ncho", _resize_weights(x.shape[3], out_w, x.device).to(x.dtype), x)
    return x


class BasicConv2d(nn.Module):
    """Convolution (no bias), batch norm (eps 1e-3, running statistics) and ReLU.
    ``padding="same"`` pads each side by half the kernel (every kernel here is odd)."""

    def __init__(self, cin: int, cout: int, kernel: Union[int, Tuple[int, int]], stride: int = 1,
                 padding: str = "same") -> None:
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        pad = (kh // 2, kw // 2) if padding == "same" else (0, 0)
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride, padding=pad, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, pool_kind: str) -> None:
        super().__init__()
        self.pool_kind = pool_kind
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b2 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        b4 = self.branch_pool(_pool_branch(x, self.pool_kind))
        return torch.cat([b1, b2, b3, b4], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2, padding="valid")
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, padding="valid")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch3x3(x)
        b2 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b1, b2, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, pool_kind: str) -> None:
        super().__init__()
        self.pool_kind = pool_kind
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b2 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        b3 = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            b3 = layer(b3)
        b4 = self.branch_pool(_pool_branch(x, self.pool_kind))
        return torch.cat([b1, b2, b3, b4], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, padding="valid")
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, padding="valid")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch3x3_2(self.branch3x3_1(x))
        b2 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b1, b2, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_kind: str) -> None:
        super().__init__()
        self.pool_kind = pool_kind
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b2 = self.branch3x3_1(x)
        b2 = torch.cat([self.branch3x3_2a(b2), self.branch3x3_2b(b2)], 1)
        b3 = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        b3 = torch.cat([self.branch3x3dbl_3a(b3), self.branch3x3dbl_3b(b3)], 1)
        b4 = self.branch_pool(_pool_branch(x, self.pool_kind))
        return torch.cat([b1, b2, b3, b4], 1)


class InceptionV3(nn.Module):
    """The Inception-v3 trunk on NCHW float inputs of 299 x 299, scaled to [-1, 1].

    :meth:`forward` returns the taps up to ``upto`` (all of them by default),
    each the spatial mean of its stage (the logits a product with ``fc``'s
    weight, no bias), and runs no layer past the one it needs."""

    def __init__(self, fid_variant: bool = True) -> None:
        super().__init__()
        self.fid_variant = fid_variant
        pool = "avg_excl" if fid_variant else "avg"
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, padding="valid")
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, padding="valid")
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, padding="valid")
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, padding="valid")
        self.Mixed_5b = InceptionA(192, 32, pool)
        self.Mixed_5c = InceptionA(256, 64, pool)
        self.Mixed_5d = InceptionA(288, 64, pool)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, pool)
        self.Mixed_6c = InceptionC(768, 160, pool)
        self.Mixed_6d = InceptionC(768, 160, pool)
        self.Mixed_6e = InceptionC(768, 192, pool)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool)
        self.Mixed_7c = InceptionE(2048, "max" if fid_variant else "avg")
        self.fc = nn.Linear(2048, NUM_CLASSES, bias=False)

    def forward(self, x: torch.Tensor, upto: str = "logits_unbiased") -> Dict[str, torch.Tensor]:
        stop = TAPS.index(upto)
        taps: Dict[str, torch.Tensor] = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        taps["64"] = x.mean(dim=(2, 3))
        if stop == 0:
            return taps
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, stride=2)
        taps["192"] = x.mean(dim=(2, 3))
        if stop == 1:
            return taps
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        taps["768"] = x.mean(dim=(2, 3))
        if stop == 2:
            return taps
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        taps["2048"] = x.mean(dim=(2, 3))
        if stop == 3:
            return taps
        taps["logits_unbiased"] = taps["2048"] @ self.fc.weight.T
        return taps

    def convbn_slots(self) -> List[BasicConv2d]:
        """Every conv + batch-norm unit in definition order (the JAX package's slot order)."""
        return [m for m in self.modules() if isinstance(m, BasicConv2d)]


# each block's conv + bn units in definition order, and which of them (the
# parallel 1x1 heads on the block's input) fuse into one convolution
_BLOCK_SIZES = [1] * 5 + [7, 7, 7] + [4] + [10, 10, 10, 10] + [6] + [9, 9]
_BLOCK_KINDS = ["s"] * 5 + ["A", "A", "A", "B", "C", "C", "C", "C", "D", "E", "E"]
_FUSE_PLAN = {"A": (0, 1, 3), "C": (0, 1, 4), "D": (0, 2), "E": (0, 1, 4)}


class FoldedInceptionV3(nn.Module):
    """The optimized inference path (counterpart of the JAX package's
    ``fold_inception_variables`` / ``fast_inception_apply``), built once from a
    canonical :class:`InceptionV3`: each batch norm folded into its convolution
    (``w * g / sqrt(v + eps)``, ``b - m * g / sqrt(v + eps)``), and the parallel
    1x1 heads of each block concatenated into one convolution, split after the
    ReLU.  Equal to the canonical forward up to float rounding."""

    def __init__(self, canonical: InceptionV3) -> None:
        super().__init__()
        self.fid_variant = canonical.fid_variant
        slots = []
        for unit in canonical.convbn_slots():
            scale = unit.bn.weight.detach().float() * torch.rsqrt(unit.bn.running_var.detach().float() + BN_EPS)
            weight = unit.conv.weight.detach().float() * scale[:, None, None, None]
            bias = unit.bn.bias.detach().float() - unit.bn.running_mean.detach().float() * scale
            slots.append((weight, bias, unit.conv.stride, unit.conv.padding))
        convs = []
        cursor = 0
        for kind, size in zip(_BLOCK_KINDS, _BLOCK_SIZES):
            block = slots[cursor : cursor + size]
            cursor += size
            fused = _FUSE_PLAN.get(kind, ())
            if fused:
                convs.append((torch.cat([block[i][0] for i in fused]), torch.cat([block[i][1] for i in fused]),
                              (1, 1), (0, 0)))
            convs.extend(slot for i, slot in enumerate(block) if i not in fused)
        assert cursor == len(slots), (cursor, len(slots))
        self.weights = nn.ParameterList([nn.Parameter(w, requires_grad=False) for w, _, _, _ in convs])
        self.biases = nn.ParameterList([nn.Parameter(b, requires_grad=False) for _, b, _, _ in convs])
        self.geometry = [(stride, padding) for _, _, stride, padding in convs]
        self.fc = nn.Parameter(canonical.fc.weight.detach().float().clone(), requires_grad=False)

    def forward(self, x: torch.Tensor, upto: str = "logits_unbiased") -> Dict[str, torch.Tensor]:
        stop = TAPS.index(upto)
        cursor = [0]

        def conv(t: torch.Tensor) -> torch.Tensor:
            i = cursor[0]
            cursor[0] += 1
            stride, padding = self.geometry[i]
            w, b = self.weights[i], self.biases[i]
            return F.relu(F.conv2d(t, w.to(t.dtype), b.to(t.dtype), stride=stride, padding=padding))

        def heads(t: torch.Tensor, widths: Tuple[int, ...]) -> List[torch.Tensor]:
            return list(torch.split(conv(t), widths, dim=1))

        pool = "avg_excl" if self.fid_variant else "avg"
        taps: Dict[str, torch.Tensor] = {}
        x = F.max_pool2d(conv(conv(conv(x))), 3, stride=2)
        taps["64"] = x.mean(dim=(2, 3))
        if stop == 0:
            return taps
        x = F.max_pool2d(conv(conv(x)), 3, stride=2)
        taps["192"] = x.mean(dim=(2, 3))
        if stop == 1:
            return taps
        for _ in range(3):  # A blocks
            b1, b2, b3 = heads(x, (64, 48, 64))
            b2 = conv(b2)
            b3 = conv(conv(b3))
            b4 = conv(_pool_branch(x, pool))
            x = torch.cat([b1, b2, b3, b4], 1)
        b1 = conv(x)  # B block
        b2 = conv(conv(conv(x)))
        x = torch.cat([b1, b2, F.max_pool2d(x, 3, stride=2)], 1)
        for c in (128, 160, 160, 192):  # C blocks
            b1, b2, b3 = heads(x, (192, c, c))
            b2 = conv(conv(b2))
            b3 = conv(conv(conv(conv(b3))))
            b4 = conv(_pool_branch(x, pool))
            x = torch.cat([b1, b2, b3, b4], 1)
        taps["768"] = x.mean(dim=(2, 3))
        if stop == 2:
            return taps
        b1, b2 = heads(x, (192, 192))  # D block
        b1 = conv(b1)
        b2 = conv(conv(conv(b2)))
        x = torch.cat([b1, b2, F.max_pool2d(x, 3, stride=2)], 1)
        for kind in (pool, "max" if self.fid_variant else "avg"):  # E blocks
            b1, b2h, b3h = heads(x, (320, 384, 448))
            b2 = torch.cat([conv(b2h), conv(b2h)], 1)
            b3 = conv(b3h)
            b3 = torch.cat([conv(b3), conv(b3)], 1)
            b4 = conv(_pool_branch(x, kind))
            x = torch.cat([b1, b2, b3, b4], 1)
        assert cursor[0] == len(self.geometry), (cursor[0], len(self.geometry))
        taps["2048"] = x.mean(dim=(2, 3))
        if stop == 3:
            return taps
        taps["logits_unbiased"] = taps["2048"] @ self.fc.to(x.dtype).T
        return taps


def load_weights(model: nn.Module, state_dict: Dict[str, Any]) -> None:
    """Load ``state_dict`` (tensors or arrays) into ``model``: every weight of the model must be
    there; keys the model lacks (a torch-fidelity ``fc.bias``, torchvision's ``AuxLogits``) are skipped."""
    tensors = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
    missing, _ = model.load_state_dict(tensors, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"weights missing from the state dict: {missing[:5]}{' ...' if len(missing) > 5 else ''}")


def _random_init(model: nn.Module, seed: int = 0) -> None:
    """Seeded random weights from an explicit CPU generator: each convolution normal with variance
    2 / fan-in (He), so activations keep their scale through the ReLUs and a random-weight FID, KID
    or IS is not degenerate in float32; dense layers variance 1 / fan-in; batch norms the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                gain = 2.0 if isinstance(module, nn.Conv2d) else 1.0
                module.weight.copy_(torch.randn(module.weight.shape, generator=gen) * (gain / fan_in) ** 0.5)
                if module.bias is not None:
                    module.bias.zero_()


class InceptionFeatureExtractor:
    """Callable: uint8 images, NCHW (or NHWC: ``shape[1] == 3 and shape[-1] != 3`` is
    read as NCHW, anything else as NHWC) -> float32 features of the requested tap.

    The weights come from the JAX package's trees, ``variables`` (``{"params",
    "batch_stats"}``) or ``params`` with ``batch_vars``, converted; else a
    seeded random init (:func:`_random_init`).  A torch-fidelity state dict
    loads into ``.model`` through :func:`load_weights`.  Images are resized to 299 x 299 and scaled to
    [-1, 1] by the variant's rule.  ``compute_dtype`` (e.g. ``torch.bfloat16``)
    runs the network in that dtype; the features come back in float32.
    ``optimized`` (default: on exactly when ``compute_dtype`` is set) runs
    :class:`FoldedInceptionV3`.  The weights are not trained: no gradient flows.
    """

    def __init__(
        self,
        feature: str = "2048",
        params: Optional[Dict] = None,
        batch_vars: Optional[Dict] = None,
        variables: Optional[Dict] = None,
        fid_variant: bool = True,
        compute_dtype: Optional[torch.dtype] = None,
        optimized: Optional[bool] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        from metrics_tpu_torch.image.backbones.convert import inception_state_dict_from_flax
        from metrics_tpu_torch.metric import _resolve_device

        self.feature = str(feature)
        if self.feature not in TAPS:
            raise ValueError(f"Inception feature must be one of {list(TAPS)}, got {feature!r}")
        self.fid_variant = fid_variant
        self.compute_dtype = compute_dtype
        self.optimized = (compute_dtype is not None) if optimized is None else optimized
        self.device = _resolve_device(device)
        self.model = InceptionV3(fid_variant=fid_variant)
        if variables is None and params is not None:
            variables = {"params": params, **(batch_vars or {})}
        if variables is not None:
            load_weights(self.model, inception_state_dict_from_flax(variables))
        else:
            _random_init(self.model)
        self.model.eval().requires_grad_(False).to(self.device)
        self._folded: Optional[FoldedInceptionV3] = None
        self._cast: Dict[Tuple[bool, torch.dtype], nn.Module] = {}

    def to(self, device: Union[str, torch.device]) -> "InceptionFeatureExtractor":
        self.device = torch.device(device)
        self.model.to(self.device)
        self._folded = None
        self._cast = {}
        return self

    def network(self) -> nn.Module:
        """The module a call runs: the canonical or the folded one, in ``compute_dtype``."""
        net: nn.Module = self.model
        if self.optimized:
            if self._folded is None:
                with torch.no_grad():
                    self._folded = FoldedInceptionV3(self.model).to(self.device)
            net = self._folded
        if self.compute_dtype is not None and self.compute_dtype != torch.float32:
            key = (self.optimized, self.compute_dtype)
            if key not in self._cast:
                self._cast[key] = copy.deepcopy(net).to(self.compute_dtype)
            net = self._cast[key]
        return net

    def preprocess(self, imgs: Any) -> torch.Tensor:
        """Images as NCHW float32 on the extractor's device, resized to 299 and scaled to [-1, 1]."""
        imgs = torch.as_tensor(imgs, device=self.device)
        if imgs.ndim != 4:
            raise ValueError(f"Expected 4d image batch, got shape {tuple(imgs.shape)}")
        if not (imgs.shape[1] == 3 and imgs.shape[-1] != 3):
            imgs = imgs.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = imgs.to(torch.float32)
        if self.fid_variant:
            return (tf1_resize_bilinear(x, 299, 299) - 128.0) / 128.0
        return (resize_bilinear(x / 255.0, 299, 299) - 0.5) * 2.0

    def taps(self, imgs: Any, upto: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Every tap up to ``upto`` (default: the extractor's feature), float32."""
        x = self.preprocess(imgs)
        net = self.network()
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        with torch.no_grad(), full_float32():
            out = net(x, upto or self.feature)
        return {k: v.to(torch.float32) for k, v in out.items()}

    def __call__(self, imgs: Any) -> torch.Tensor:
        return self.taps(imgs)[self.feature]


def load_params_npz(path: str) -> Dict:
    """A converted checkpoint saved as a flat ``{"a/b/kernel": array}`` npz, as a nested tree of numpy arrays."""
    flat = np.load(path)
    tree: Dict = {}
    for key in flat.files:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(flat[key])
    return tree
