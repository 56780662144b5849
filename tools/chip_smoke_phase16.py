"""Phase 16 of ``chip_smoke.py`` (the rest of text and audio) alone, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/chip_smoke_phase16.py

It runs phase 16 through the script's own functions (no kernel of the port
lies on this path, so nothing is built): the MT metrics on a newstest-shaped
corpus, ROUGE and SQuAD, BERTScore on an encoder of roberta-large's shape,
and SNR, SI-SNR, SI-SDR, SDR and PIT on WSJ0-2mix-shaped signals, with the
CPU twin of the text passes beside it; then it prints the card's line and the
phase's JSON line.  The quickest way to iterate on phase 16.
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
    line = cs.phase_text_audio(mt, card)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
