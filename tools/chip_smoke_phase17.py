"""Phase 17 of ``chip_smoke.py`` (the serve tier) alone, through the script's own functions, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/chip_smoke_phase17.py

It builds the kernels, profiles one block dispatch of each columnar job,
then runs phase 17: one ``EvalServer`` on the card with four jobs fed over
localhost HTTP (the states bitwise direct-update twins', the launches what
the pieces imply, the answers of reads taken while ingest runs, the WAL
drill with a checkpoint, a kill, a restore and a replay, and the card's
checkpoint restored on the CPU).  It prints the card's line, the phase's
``{"serve": ...}`` JSON line and the launches per entry point.  The quickest
way to iterate on phase 17.
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
    profile = cs._serve_block_profile(mt)
    launches, line = cs.phase_serve(mt, card, profile)
    print(json.dumps(line))
    print(json.dumps({"serve_launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
