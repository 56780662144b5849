"""Phases 1-4 and 13 of ``chip_smoke.py`` alone, through the script's own functions, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/chip_smoke_phase13.py

It builds the kernels, checks them, drives the main path (phase 4's integer
states are what phase 13 (a) holds its runs to), profiles one update with obs
off and on, and runs phase 13 ("core and obs"); it prints the phase's lines and
its ``{"core_obs": ...}`` JSON line.  The quickest way to iterate on phase 13.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import metrics_tpu_torch as mt  # noqa: E402
from metrics_tpu_torch import obs  # noqa: E402
from metrics_tpu_torch.ops import stat_scores as ops  # noqa: E402


def main() -> int:
    card = cs._card_line()
    print(card)
    cs.phase_build(ops)
    cs.phase_kernels(ops)
    _, single, logits, labels = cs.phase_main_path(mt, ops)
    profiles = cs._obs_profiles(mt, obs, logits, labels)
    del logits, labels
    stat_launches, other_launches, line = cs.phase_core_obs(mt, ops, single, profiles, card)
    print(json.dumps(line))
    print(f"phase 13 launches: {stat_launches} and {other_launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
