"""How far this host's PyTorch CPU float32 elementwise functions are from correctly rounded.

Run from the root of a checkout:

    python tools/cpu_rounding_probe.py [--jax]

For ``sqrt``, ``exp``, ``log``, ``log10`` and ``x ** 1.5`` on 200,000 float32
inputs (multiples of 1/8, and their negatives over 1000 for ``exp``) it
prints how many of PyTorch's, numpy's and (with ``--jax``) ``jax.numpy``'s
results differ from the correctly rounded one (the float64 result rounded
once, which is exact for ``sqrt`` and all but never off for the others) and
by how many units in the last place at most, then the same counts for
``metrics_tpu_torch.utils.compute._sqrt``.  The ATen kernels it reaches follow
``ATEN_CPU_CAPABILITY`` (printed first).
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from metrics_tpu_torch.utils.compute import _sqrt  # noqa: E402


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


def main() -> int:
    eighths = np.arange(1, 200_001, dtype=np.float32) / np.float32(8)
    cases = {
        "sqrt": (eighths, torch.sqrt, np.sqrt, "sqrt"),
        "exp": ((-eighths / np.float32(1000)).astype(np.float32), torch.exp, np.exp, "exp"),
        "log": (eighths, torch.log, np.log, "log"),
        "log10": (eighths, torch.log10, np.log10, "log10"),
        "pow1.5": (eighths, lambda t: t**1.5, lambda x: x ** np.float32(1.5), None),
    }
    jnp = None
    if "--jax" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
    print(f"torch {torch.__version__}, ATen CPU capability {torch.backends.cpu.get_cpu_capability()}")
    for name, (x, tf, nf, jname) in cases.items():
        t = torch.from_numpy(x)
        rounded = tf(t.double()).float().numpy()
        line = {"torch": tf(t).numpy(), "numpy": nf(x)}
        if jnp is not None:
            jfn = getattr(jnp, jname) if jname else (lambda v: v**1.5)
            line["jax"] = np.asarray(jfn(jnp.asarray(x)))
        shown = ", ".join(f"{k} {int((_ulps(v, rounded) > 0).sum())} off (max {int(_ulps(v, rounded).max())} ulp)"
                          for k, v in line.items())
        print(f"{name}: of {x.size}: {shown}")
    got = _sqrt(torch.from_numpy(eighths)).numpy()
    print(f"_sqrt: {int((_ulps(got, np.sqrt(eighths)) > 0).sum())} of {eighths.size} off numpy's sqrt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
