"""Stdlib-only ingest child for the multi-process load generator
(counterpart of ``metrics_tpu/serve/_loadgen_child.py``, the same records).

Run BY PATH (``python .../_loadgen_child.py``), never with ``-m``: invoking
it as a module would execute the ``metrics_tpu_torch`` package ``__init__``
and pay the full PyTorch import (~seconds) in every child.  By path it is a plain
``__main__`` script whose imports are all stdlib, so a child is live in
tens of milliseconds — the point of process-mode load is measuring the
*server*, not the client's import time.

Emits one JSON line on stdout:
``{"sent": n, "accepted": a, "rejected": r, "elapsed_s": t, "errors": e}``.
"""

import argparse
import json
import random
import time
import urllib.error
import urllib.request


def make_batch(seed, lo, hi, arity, num_streams):
    """Deterministic records for [lo, hi): pure function of the args."""
    rng = random.Random((seed << 20) ^ lo)
    records = []
    for _ in range(hi - lo):
        rec = {"values": [rng.random() for _ in range(arity)]}
        if num_streams:
            rec["stream_id"] = rng.randrange(num_streams)
        records.append(rec)
    return records


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", required=True, help="server base, e.g. http://127.0.0.1:9100")
    parser.add_argument("--job", required=True)
    parser.add_argument("--lo", type=int, required=True)
    parser.add_argument("--hi", type=int, required=True)
    parser.add_argument("--batch-rows", type=int, default=256)
    parser.add_argument("--arity", type=int, default=2)
    parser.add_argument("--num-streams", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--timeout", type=float, default=10.0)
    args = parser.parse_args()

    sent = accepted = rejected = errors = 0
    t0 = time.monotonic()
    for lo in range(args.lo, args.hi, args.batch_rows):
        hi = min(lo + args.batch_rows, args.hi)
        records = make_batch(args.seed, lo, hi, args.arity, args.num_streams)
        body = json.dumps({"job": args.job, "records": records}).encode()
        req = urllib.request.Request(
            args.url + "/ingest",
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        sent += len(records)
        try:
            with urllib.request.urlopen(req, timeout=args.timeout) as resp:
                payload = json.loads(resp.read().decode())
        except urllib.error.HTTPError as err:
            raw = err.read()
            try:
                payload = json.loads(raw.decode()) if raw else {}
            except ValueError:
                payload = {}
            if err.code not in (200, 429):
                errors += 1
        except (OSError, ValueError):
            errors += 1
            payload = {}
        accepted += int(payload.get("accepted", 0))
        rejected += int(payload.get("rejected", 0))
    print(
        json.dumps(
            {
                "sent": sent,
                "accepted": accepted,
                "rejected": rejected,
                "elapsed_s": time.monotonic() - t0,
                "errors": errors,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
