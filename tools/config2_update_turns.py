"""Configuration 2's update, unplaced, in two trees of the port, in turns, on one NVIDIA GPU.

Run from the root of a checkout, with the root of another tree of the port
(an unpacked ``git archive`` of an earlier commit, in a directory that
``.gitignore`` lists):

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/config2_update_turns.py build/parent .

The turns run A, B, B, A twice (``ROUNDS``), each in a fresh process that imports
``metrics_tpu_torch`` and ``chip_smoke`` from its own tree (the stat-scores
kernels build under that tree's ``build/`` on the first launch).  A turn
makes ``chip_smoke.py``'s ImageNet-1k pass (50,000 rows of float32 logits
over 1,000 classes and int64 labels from seed 0, batches of 1,024, the last
of 848), runs configuration 2 (``Accuracy``, ``F1Score``, ``Precision``,
``ConfusionMatrix``, macro, one ``MetricCollection``) over it once to warm,
then times ``REPS`` passes of ``update`` as host time between two
``torch.cuda.synchronize()`` calls, in ms per update.  It prints the card's
name and power limit and, as its last line, one JSON object
``{"turns": [{"root": ..., "ms": [...]}, ...], "mean_ms": {root: ms}}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPS = 5
ROUNDS = 2


def _turn(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import metrics_tpu_torch as mt

    if not Path(mt.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {mt.__file__}, not the package under {root}")
    _, _, batches = cs._imagenet_pass()
    col = cs._config2(mt)
    ms = []
    for rep in range(REPS + 1):
        col.reset()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for p, t in batches:
            col.update(p, t)
        torch.cuda.synchronize()
        if rep:  # the first pass builds the kernels and warms the caches
            ms.append((time.perf_counter() - start) * 1e3 / len(batches))
    return {"root": str(root), "ms": ms}


def main(argv) -> int:
    if argv[:1] == ["--turn"]:
        print(json.dumps(_turn(Path(argv[1]).resolve())))
        return 0
    a, b = (Path(x).resolve() for x in argv[:2])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    turns = []
    for root in (a, b, b, a) * ROUNDS:
        out = subprocess.run([sys.executable, __file__, "--turn", str(root)], capture_output=True, text=True,
                             timeout=600)
        if out.returncode:
            raise RuntimeError(f"the turn in {root} exited {out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(f"{root}: ms per config-2 update {turns[-1]['ms']}")
    mean = {str(r): statistics.mean(x for t in turns if t["root"] == str(r) for x in t["ms"]) for r in (a, b)}
    print(json.dumps({"card": card, "turns": turns, "mean_ms": mean}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
