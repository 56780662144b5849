"""Phase 18 of ``chip_smoke.py`` (the serve fleet) alone, through the script's own functions, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/chip_smoke_phase18.py

It builds the kernels, then runs phase 18: (a) in-process fleets of four
shards on the card through ingest with reads, a checkpoint, a kill with
failover and WAL replay, and a resize, each stage bitwise a one-shard twin;
(b) two worker processes behind an ``HTTPShard`` coordinator through a
SIGKILL and failover, then process-mode load; (c) the soak drill.  It prints
the card's line, the phase's ``{"fleet": ...}`` JSON line and the launches
per entry point.  The quickest way to iterate on phase 18.
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
    launches, line = cs.phase_fleet(mt, card)
    print(json.dumps(line))
    print(json.dumps({"fleet_launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
