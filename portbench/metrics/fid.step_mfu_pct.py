"""The FID update's share of the card's float32 peak: Inception-v3's FLOPs per image at 299 x 299 (two per
multiply-add of every convolution, counted over the layer shapes by the benchmark) times the images folded
per second of the traced window, over the float32 rate without tensor cores (the configuration's stated
precision: TF32 off)."""

from portbench.reference.inception import SIDE, conv_flops


def flops_per_image(side: int = SIDE) -> int:
    return conv_flops(side)


def read(r):
    c = r.outcome.counts
    if r.trace is None or not c.get("input_images"):
        return None
    lo, hi = r.trace.window()
    if hi <= lo:
        return None
    rate = c["rows"] / ((hi - lo) / 1e9)
    return 100.0 * flops_per_image() * rate / r.peaks["fp32_flops_per_s"]
