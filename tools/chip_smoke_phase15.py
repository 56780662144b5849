"""Phase 15 of ``chip_smoke.py`` (FID, KID, IS, LPIPS and the WER family) alone, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/chip_smoke_phase15.py

It runs phase 15 through the script's own functions (no kernel of the port
lies on this path, so nothing is built): the generation metrics on CIFAR-10
test-shaped sets, LPIPS on BAPPS-shaped patches, FID and KID over two gloo
ranks on ``cuda:0``, and the WER family on LibriSpeech test-clean-shaped
transcripts, then prints the card's line and the phase's JSON line.  The
quickest way to iterate on phase 15.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import metrics_tpu_torch as mt  # noqa: E402


def main() -> int:
    card = cs._card_line()
    print(card)
    line = cs.phase_generation_text(mt, card)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
