"""Carry the JAX package's extractor weights into the port.

The JAX package's backbones are Flax modules whose variables
``tools/convert_weights.py`` fills from torch checkpoints
(``convert_inception_v3``, ``convert_lpips_{vgg16,alexnet,squeezenet}``).
These functions are its exact inverse: they take such a variables tree (numpy
arrays, or anything ``numpy.asarray`` reads) and return this package's
``state_dict``, with Flax's HWIO convolution kernels as OIHW and a dense
kernel ``(in, out)`` as ``(out, in)``.  Every assignment is checked against the
shape the port's module holds; a topology mismatch raises.
"""

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

# torchvision layer indices of the convolutions inside ``features``, and the
# JAX package's names for them (stage-major)
VGG16_CONV_INDICES: Tuple[int, ...] = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
ALEXNET_CONV_INDICES: Tuple[int, ...] = (0, 3, 6, 8, 10)
SQUEEZENET_FIRE_INDICES: Tuple[int, ...] = (3, 4, 6, 7, 9, 10, 11, 12)
_VGG_FLAX_NAMES: Tuple[str, ...] = (
    "stage0_conv0", "stage0_conv1",
    "stage1_conv0", "stage1_conv1",
    "stage2_conv0", "stage2_conv1", "stage2_conv2",
    "stage3_conv0", "stage3_conv1", "stage3_conv2",
    "stage4_conv0", "stage4_conv1", "stage4_conv2",
)
_ALEX_FLAX_NAMES: Tuple[str, ...] = ("conv0", "conv1", "conv2", "conv3", "conv4")
LPIPS_HEADS = {"vgg": 5, "alex": 5, "squeeze": 7}


def conv_from_flax(kernel: Any) -> np.ndarray:
    """A Flax conv kernel HWIO as torch's OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def linear_from_flax(kernel: Any) -> np.ndarray:
    """A Flax dense kernel ``(in, out)`` as torch's ``(out, in)``."""
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (1, 0)))


def _natural_key(name: str) -> Tuple[str, int]:
    """``'_ConvBN_10'`` -> ``('_ConvBN_', 10)``: Flax's module order past index 9."""
    i = len(name)
    while i > 0 and name[i - 1].isdigit():
        i -= 1
    return name[:i], int(name[i:]) if i < len(name) else -1


def _flax_convbn_slots(tree: Mapping[str, Any], path: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """Paths of every Conv + BatchNorm unit of a Flax Inception in definition order."""
    if "Conv_0" in tree and "BatchNorm_0" in tree:
        return [path]
    slots: List[Tuple[str, ...]] = []
    for key in sorted(tree, key=_natural_key):
        if isinstance(tree[key], Mapping):
            slots.extend(_flax_convbn_slots(tree[key], path + (key,)))
    return slots


def _node(tree: Mapping[str, Any], path: Tuple[str, ...]) -> Mapping[str, Any]:
    for p in path:
        tree = tree[p]
    return tree


def _template(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _checked(out: Dict[str, np.ndarray], shapes: Dict[str, Tuple[int, ...]], key: str, value: Any, where: str) -> None:
    value = np.asarray(value, dtype=np.float32)
    if key not in shapes:
        raise ValueError(f"{where}: the port's module has no weight {key!r}")
    if tuple(value.shape) != shapes[key]:
        raise ValueError(f"Shape mismatch at {where} -> {key}: {tuple(value.shape)} vs {shapes[key]}")
    out[key] = value


def inception_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's ``FlaxInceptionV3`` variables (``{"params", "batch_stats"}``) as this
    package's :class:`~metrics_tpu_torch.image.backbones.inception.InceptionV3` ``state_dict``."""
    from metrics_tpu_torch.image.backbones.inception import BasicConv2d, InceptionV3

    with torch.device("meta"):
        model = InceptionV3()
    shapes = _template(model)
    units = [name for name, m in model.named_modules() if isinstance(m, BasicConv2d)]
    params, stats = variables["params"], variables["batch_stats"]
    slots = _flax_convbn_slots(params)
    if len(slots) != len(units):
        raise ValueError(f"Topology mismatch: the tree has {len(slots)} conv+bn units, the port's module {len(units)}")
    out: Dict[str, np.ndarray] = {}
    for path, unit in zip(slots, units):
        p, s = _node(params, path), _node(stats, path)
        where = "/".join(path)
        _checked(out, shapes, f"{unit}.conv.weight", conv_from_flax(p["Conv_0"]["kernel"]), where)
        _checked(out, shapes, f"{unit}.bn.weight", p["BatchNorm_0"]["scale"], where)
        _checked(out, shapes, f"{unit}.bn.bias", p["BatchNorm_0"]["bias"], where)
        _checked(out, shapes, f"{unit}.bn.running_mean", s["BatchNorm_0"]["mean"], where)
        _checked(out, shapes, f"{unit}.bn.running_var", s["BatchNorm_0"]["var"], where)
    _checked(out, shapes, "fc.weight", linear_from_flax(params["Dense_0"]["kernel"]), "Dense_0")
    return out


def _lpips_convs(net_type: str) -> List[Tuple[Tuple[str, ...], str]]:
    """(path in the JAX package's params, torch module name) of each convolution of a backbone."""
    if net_type == "vgg":
        return [((name,), f"features.{idx}") for name, idx in zip(_VGG_FLAX_NAMES, VGG16_CONV_INDICES)]
    if net_type == "alex":
        return [((name,), f"features.{idx}") for name, idx in zip(_ALEX_FLAX_NAMES, ALEXNET_CONV_INDICES)]
    if net_type == "squeeze":
        return [(("conv0",), "features.0")] + [
            ((f"fire{idx}", sub), f"features.{idx}.{sub}")
            for idx in SQUEEZENET_FIRE_INDICES for sub in ("squeeze", "expand1x1", "expand3x3")
        ]
    raise ValueError(f"unknown LPIPS net_type {net_type!r}")


def lpips_state_dict_from_flax(params: Mapping[str, Any], net_type: str) -> Dict[str, np.ndarray]:
    """The JAX package's ``_LpipsBackbone(net_type)`` params as this package's
    :class:`~metrics_tpu_torch.image.lpip.LpipsNet` ``state_dict``: torchvision's
    ``features.*`` names and the lpips package's ``lin{k}.model.1`` heads."""
    from metrics_tpu_torch.image.lpip import LpipsNet

    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    with torch.device("meta"):
        shapes = _template(LpipsNet(net_type))
    out: Dict[str, np.ndarray] = {}
    for path, name in _lpips_convs(net_type):
        node = _node(params, path)
        where = "/".join(path)
        _checked(out, shapes, f"{name}.weight", conv_from_flax(node["kernel"]), where)
        _checked(out, shapes, f"{name}.bias", node["bias"], where)
    for k in range(LPIPS_HEADS[net_type]):
        _checked(out, shapes, f"lin{k}.model.1.weight", conv_from_flax(params[f"lin{k}"]["kernel"]), f"lin{k}")
    if len(out) != len(shapes):
        raise ValueError(f"Topology mismatch: filled {len(out)} of the module's {len(shapes)} weights")
    return out
