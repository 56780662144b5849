"""Phase 14 of ``chip_smoke.py`` (detection and image) alone, through the script's own functions, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/chip_smoke_phase14.py

It builds the kernels and the C++ host library, runs the ``coco_match``
kernel and the card tests of ``tests/test_torch_cuda.py`` that cover it, then
phase 14 (COCO-shaped bbox and segm mAP on both routes, the two-rank
``dist_sync_on_step`` run, the kernel against its plain version, the image
passes), and prints the phase's lines, its ``{"detection_image": ...}`` JSON
line and the kernel's entry of the ``kernels`` line.  The quickest way to
iterate on phase 14.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import metrics_tpu_torch as mt  # noqa: E402
from metrics_tpu_torch.ops import stat_scores as ops  # noqa: E402


def main() -> int:
    card = cs._card_line()
    print(card)
    cs.phase_build(ops)
    entry, line = cs.phase_detection_image(mt, card)
    print(json.dumps(line))
    print(json.dumps({"kernels": [entry]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
