"""Phase 19 of ``chip_smoke.py`` (mesh-placed metric state) alone, through the script's own functions, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/chip_smoke_phase19.py

It builds the kernels, then runs phase 19: (a) a one-rank mesh on ``cuda:0``
over NCCL, configuration 2 and the per-class accuracy placed as DTensors,
bitwise their unplaced twins; (b) two gloo ranks on the card, the JAX
package's configuration 10 and a sketch placed on a mesh of the two, a sync
every 8 updates, against one process and the kernels' plain versions, and
configuration 2 synced through ``MeshBackend`` against ``DistBackend``.  It
prints the card's line, the phase's ``{"mesh": ...}`` JSON line and the
launches per entry point.  The quickest way to iterate on phase 19.
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
    launches, line = cs.phase_mesh(mt, ops, card)
    print(json.dumps(line))
    print(json.dumps({"mesh_launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
