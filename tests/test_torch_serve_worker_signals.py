"""A fleet worker stopped the moment it reports READY drains and writes its final checkpoint.

``python -m metrics_tpu_torch.serve.worker`` installs its SIGTERM/SIGINT
handlers before it prints ``READY <port>``: a parent that stops a worker as
soon as it reads that line must reach the graceful drain, not the default
action of SIGTERM (which would kill the process with no drain and no final
checkpoint).  The JAX package's worker keeps the other order.
"""

import signal
import subprocess
import sys
from pathlib import Path

from metrics_tpu_torch.checkpoint.manager import MANIFEST_NAME

ROOT = Path(__file__).resolve().parents[1]

RUNS = 5


def _start(root: Path) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "metrics_tpu_torch.serve.worker", "--shard", "0", "--num-shards", "1",
           "--device", "cpu", "--checkpoint-root", str(root)]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_sigterm_at_ready_drains_and_commits_the_final_checkpoint(tmp_path):
    roots = [tmp_path / f"run{i}" for i in range(RUNS)]
    procs = [_start(root) for root in roots]  # started together: each pays its own interpreter start
    try:
        for root, proc in zip(roots, procs):
            ready = proc.stdout.readline().strip()
            assert ready.startswith("READY "), (ready, proc.stderr.read() if proc.poll() is not None else "")
            proc.send_signal(signal.SIGTERM)  # the instant READY is read
        for root, proc in zip(roots, procs):
            out, err = proc.communicate(timeout=60)
            assert proc.returncode == 0, (proc.returncode, out, err)
            manifests = sorted((root / "shard_0000").glob(f"step_*/{MANIFEST_NAME}"))
            assert manifests, (sorted(str(p) for p in root.rglob("*")), err)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
