"""A plain Inception-v3 feature network in the FID variant (the TF graph the published FID weights come from).

Every unit is a convolution without bias, a batch norm in inference form (eps 1e-3) and a ReLU, kept
apart as the published graph has them; nothing is folded or fused.  Inputs are uint8 images, resized to
299 x 299 with the legacy TF1 bilinear kernel (source coordinate ``dst * in / out``, no half-pixel offset)
and scaled ``(x - 128) / 128``.  The 3 x 3 stride-1 average pools of the branches leave the padding out of
the divisor, and the last block max-pools its pool branch.  The output is the 2048-wide spatial mean of
the last block (the ``pool3`` features of FID).

:data:`UNITS` lists the units in the published definition order, which is also the order the weights are
made in and handed over.
"""

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
SIDE = 299

Unit = Tuple[str, int, int, Tuple[int, int], int, Tuple[int, int]]  # name, cin, cout, kernel, stride, padding


def _same(k: Tuple[int, int]) -> Tuple[int, int]:
    return (k[0] // 2, k[1] // 2)


def _u(name: str, cin: int, cout: int, k, stride: int = 1, valid: bool = False) -> Unit:
    k = (k, k) if isinstance(k, int) else tuple(k)
    return (name, cin, cout, k, stride, (0, 0) if valid else _same(k))


def _block_a(p: str, cin: int, pool: int) -> List[Unit]:
    return [_u(f"{p}.branch1x1", cin, 64, 1), _u(f"{p}.branch5x5_1", cin, 48, 1), _u(f"{p}.branch5x5_2", 48, 64, 5),
            _u(f"{p}.branch3x3dbl_1", cin, 64, 1), _u(f"{p}.branch3x3dbl_2", 64, 96, 3),
            _u(f"{p}.branch3x3dbl_3", 96, 96, 3), _u(f"{p}.branch_pool", cin, pool, 1)]


def _block_c(p: str, c7: int) -> List[Unit]:
    return [_u(f"{p}.branch1x1", 768, 192, 1), _u(f"{p}.branch7x7_1", 768, c7, 1),
            _u(f"{p}.branch7x7_2", c7, c7, (1, 7)), _u(f"{p}.branch7x7_3", c7, 192, (7, 1)),
            _u(f"{p}.branch7x7dbl_1", 768, c7, 1), _u(f"{p}.branch7x7dbl_2", c7, c7, (7, 1)),
            _u(f"{p}.branch7x7dbl_3", c7, c7, (1, 7)), _u(f"{p}.branch7x7dbl_4", c7, c7, (7, 1)),
            _u(f"{p}.branch7x7dbl_5", c7, 192, (1, 7)), _u(f"{p}.branch_pool", 768, 192, 1)]


def _block_e(p: str, cin: int) -> List[Unit]:
    return [_u(f"{p}.branch1x1", cin, 320, 1), _u(f"{p}.branch3x3_1", cin, 384, 1),
            _u(f"{p}.branch3x3_2a", 384, 384, (1, 3)), _u(f"{p}.branch3x3_2b", 384, 384, (3, 1)),
            _u(f"{p}.branch3x3dbl_1", cin, 448, 1), _u(f"{p}.branch3x3dbl_2", 448, 384, 3),
            _u(f"{p}.branch3x3dbl_3a", 384, 384, (1, 3)), _u(f"{p}.branch3x3dbl_3b", 384, 384, (3, 1)),
            _u(f"{p}.branch_pool", cin, 192, 1)]


UNITS: List[Unit] = (
    [_u("Conv2d_1a_3x3", 3, 32, 3, 2, True), _u("Conv2d_2a_3x3", 32, 32, 3, valid=True), _u("Conv2d_2b_3x3", 32, 64, 3),
     _u("Conv2d_3b_1x1", 64, 80, 1, valid=True), _u("Conv2d_4a_3x3", 80, 192, 3, valid=True)]
    + _block_a("Mixed_5b", 192, 32) + _block_a("Mixed_5c", 256, 64) + _block_a("Mixed_5d", 288, 64)
    + [_u("Mixed_6a.branch3x3", 288, 384, 3, 2, True), _u("Mixed_6a.branch3x3dbl_1", 288, 64, 1),
       _u("Mixed_6a.branch3x3dbl_2", 64, 96, 3), _u("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 2, True)]
    + _block_c("Mixed_6b", 128) + _block_c("Mixed_6c", 160) + _block_c("Mixed_6d", 160) + _block_c("Mixed_6e", 192)
    + [_u("Mixed_7a.branch3x3_1", 768, 192, 1), _u("Mixed_7a.branch3x3_2", 192, 320, 3, 2, True),
       _u("Mixed_7a.branch7x7x3_1", 768, 192, 1), _u("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7)),
       _u("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1)), _u("Mixed_7a.branch7x7x3_4", 192, 192, 3, 2, True)]
    + _block_e("Mixed_7b", 1280) + _block_e("Mixed_7c", 2048)
)
FC_SHAPE = (1008, 2048)  # the logits head: part of the published weights, not of the features


def tf1_resize(x: torch.Tensor, side: int = SIDE) -> torch.Tensor:
    """Legacy TF1 bilinear resize (``align_corners=False``) of NCHW float32 to ``side`` x ``side``."""
    for dim in (2, 3):
        size = x.shape[dim]
        if size == side:
            continue
        src = torch.arange(side, dtype=torch.float32, device=x.device) * torch.tensor(size / side, dtype=torch.float32)
        lo = src.floor().long().clamp(max=size - 1)
        hi = (lo + 1).clamp(max=size - 1)
        w = (src - lo.float()).view([-1 if d == dim else 1 for d in range(4)])
        x = x.index_select(dim, lo) * (1 - w) + x.index_select(dim, hi) * w
    return x


class PlainInception:
    """The network over a dict of weights: ``<unit>.conv.weight`` (OIHW), ``<unit>.bn.{weight,bias,running_mean,
    running_var}`` for every unit of :data:`UNITS`."""

    def __init__(self, weights: Dict[str, torch.Tensor]) -> None:
        self.w = weights
        self.geometry = {name: (stride, pad) for name, _, _, _, stride, pad in UNITS}

    def unit(self, name: str, x: torch.Tensor) -> torch.Tensor:
        stride, pad = self.geometry[name]
        y = F.conv2d(x, self.w[f"{name}.conv.weight"], stride=stride, padding=pad)
        mean, var = self.w[f"{name}.bn.running_mean"], self.w[f"{name}.bn.running_var"]
        gamma, beta = self.w[f"{name}.bn.weight"], self.w[f"{name}.bn.bias"]
        y = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS) * gamma[:, None, None] + beta[:, None, None]
        return F.relu(y)

    def chain(self, x: torch.Tensor, *names: str) -> torch.Tensor:
        for name in names:
            x = self.unit(name, x)
        return x

    @staticmethod
    def avg_pool(x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)

    def block_a(self, p: str, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.unit(f"{p}.branch1x1", x),
                          self.chain(x, f"{p}.branch5x5_1", f"{p}.branch5x5_2"),
                          self.chain(x, f"{p}.branch3x3dbl_1", f"{p}.branch3x3dbl_2", f"{p}.branch3x3dbl_3"),
                          self.unit(f"{p}.branch_pool", self.avg_pool(x))], 1)

    def block_c(self, p: str, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.unit(f"{p}.branch1x1", x),
                          self.chain(x, *(f"{p}.branch7x7_{i}" for i in (1, 2, 3))),
                          self.chain(x, *(f"{p}.branch7x7dbl_{i}" for i in (1, 2, 3, 4, 5))),
                          self.unit(f"{p}.branch_pool", self.avg_pool(x))], 1)

    def block_e(self, p: str, x: torch.Tensor, pool_max: bool) -> torch.Tensor:
        b2 = self.unit(f"{p}.branch3x3_1", x)
        b3 = self.chain(x, f"{p}.branch3x3dbl_1", f"{p}.branch3x3dbl_2")
        pooled = F.max_pool2d(x, 3, stride=1, padding=1) if pool_max else self.avg_pool(x)
        return torch.cat([self.unit(f"{p}.branch1x1", x),
                          self.unit(f"{p}.branch3x3_2a", b2), self.unit(f"{p}.branch3x3_2b", b2),
                          self.unit(f"{p}.branch3x3dbl_3a", b3), self.unit(f"{p}.branch3x3dbl_3b", b3),
                          self.unit(f"{p}.branch_pool", pooled)], 1)

    def network(self, x: torch.Tensor) -> torch.Tensor:
        """Scaled 299 x 299 inputs to the 2048 features."""
        x = self.chain(x, "Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3")
        x = F.max_pool2d(x, 3, stride=2)
        x = F.max_pool2d(self.chain(x, "Conv2d_3b_1x1", "Conv2d_4a_3x3"), 3, stride=2)
        for p in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self.block_a(p, x)
        x = torch.cat([self.unit("Mixed_6a.branch3x3", x),
                       self.chain(x, "Mixed_6a.branch3x3dbl_1", "Mixed_6a.branch3x3dbl_2", "Mixed_6a.branch3x3dbl_3"),
                       F.max_pool2d(x, 3, stride=2)], 1)
        for p in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self.block_c(p, x)
        x = torch.cat([self.chain(x, "Mixed_7a.branch3x3_1", "Mixed_7a.branch3x3_2"),
                       self.chain(x, *(f"Mixed_7a.branch7x7x3_{i}" for i in (1, 2, 3, 4))),
                       F.max_pool2d(x, 3, stride=2)], 1)
        x = self.block_e("Mixed_7b", x, pool_max=False)
        x = self.block_e("Mixed_7c", x, pool_max=True)
        return x.mean(dim=(2, 3))

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 NCHW images to float32 ``(N, 2048)`` features."""
        x = (tf1_resize(images.to(torch.float32)) - 128.0) / 128.0
        return self.network(x)


def conv_flops(side: int = SIDE) -> int:
    """Two FLOPs per multiply-add of every convolution of one image at ``side`` x ``side``.

    Inside a block every unit reads the block's input size (each chain's inner units are stride 1 with
    same padding), and the block's output is its smallest unit output; the stem chains its units, with a
    3 x 3 stride-2 max pool after ``Conv2d_2b_3x3`` and after ``Conv2d_4a_3x3``."""

    def out(size: int, k: int, stride: int, pad: int) -> int:
        return (size + 2 * pad - k) // stride + 1

    total = 0
    h = w = side
    block, block_in, block_out = None, (h, w), (h, w)
    for name, cin, cout, k, stride, pad in UNITS:
        prefix = name.split(".")[0]
        if "." not in name:  # the stem
            h, w = out(h, k[0], stride, pad[0]), out(w, k[1], stride, pad[1])
            total += 2 * cin * cout * k[0] * k[1] * h * w
            if name in ("Conv2d_2b_3x3", "Conv2d_4a_3x3"):
                h, w = out(h, 3, 2, 0), out(w, 3, 2, 0)
            continue
        if prefix != block:
            if block is not None:
                h, w = block_out
            block, block_in, block_out = prefix, (h, w), (h, w)
        ho, wo = out(block_in[0], k[0], stride, pad[0]), out(block_in[1], k[1], stride, pad[1])
        total += 2 * cin * cout * k[0] * k[1] * ho * wo
        block_out = (min(block_out[0], ho), min(block_out[1], wo))
    return total
