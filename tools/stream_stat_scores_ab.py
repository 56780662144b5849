"""The per-stream stat-scores kernel against earlier versions of it, in turns, on one NVIDIA GPU.

Run from the root of a checkout, with the earlier sources' paths:

    git show <commit>:metrics_tpu_torch/ops/csrc/stat_scores.cu > build/ab/old_stat_scores.cu
    python3 tools/stream_stat_scores_ab.py build/ab/old_stat_scores.cu [OTHER.cu ...] [--variants]

``--variants`` adds three variants of the current source, written under
``build/ab/``: ``four_wide`` (the canonical route's tiles four threads wide
at every S, not two), and two diagnostic cuts that are timed but not checked
(their counts are wrong): ``timing_no_push`` (no block adds its counts into
the owner's) and ``timing_no_count`` (no shared-memory count per element).

Each earlier source is built with the package's own ``nvcc`` flags under
``build/ab/`` and bound with ``ctypes`` (entry point C takes the same
arguments in every version; each is given ``4 * S * W + max(S, 3 * N)``
int32 of buffer, which covers PR 10's row counts and the current logits
route's scratch).  For each call below, every version's result is first
held bitwise against the plain version; then each version's device time is
taken in turns (the earlier ones in order, the current one twice, the
earlier ones in reverse), by CUDA events behind a sleep
(``chip_smoke.py::_device_ms``) and as the kernel's own time from
``torch.profiler`` (the median of 20 calls).  The calls are the timing shape
of ``chip_smoke.py`` (``(1024, 1000)`` into S = 64, random operands, ``(S,
C)`` and micro outputs), phase 12's own three calls on its first ImageNet
batch, the large-S branch (S = 600, 1,000 and 5,000, random int32 operands)
and tall logits batches (N = 2,048 to 65,536, S = 64) for phase 2's scan.  It
prints the card's name and power limit, a line per call and one JSON object,
and writes the JSON to ``chiprun_out/stream_stat_scores_ab.json``.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _build_old(source: Path) -> ctypes.CDLL:
    from metrics_tpu_torch.ops import _build

    out = ROOT / "build" / "ab" / f"lib{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in ("stream_stat_scores_logits_f32",):
        getattr(lib, name).argtypes = [p, p, i32, p, i32, i64, i64, i64, i32, p, p]
    for name in ("stream_stat_scores_i32", "stream_stat_scores_u8"):
        getattr(lib, name).argtypes = [p, p, p, i32, i64, i64, i64, i32, p, p]
    return lib


def _old_call(lib, logits: bool, a, b, ids, s: int, micro: bool):
    n, c = a.shape
    w = 1 if micro else c
    buffer = torch.empty(4 * s * w + max(s, 3 * n), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream().cuda_stream
    if logits:
        err = lib.stream_stat_scores_logits_f32(a.data_ptr(), b.data_ptr(), b.dtype == torch.int64, ids.data_ptr(),
                                                ids.dtype == torch.int64, n, c, s, int(micro), buffer.data_ptr(), stream)
    else:
        fn = lib.stream_stat_scores_i32 if a.dtype == torch.int32 else lib.stream_stat_scores_u8
        err = fn(a.data_ptr(), b.data_ptr(), ids.data_ptr(), ids.dtype == torch.int64, n, c, s, int(micro), buffer.data_ptr(), stream)
    if err:
        raise RuntimeError(f"the earlier kernel failed with CUDA error {err}")
    return tuple(x.reshape(s) if micro else x for x in buffer[: 4 * s * w].view(4, s, w).unbind(0))


def _calls(smoke):
    """(name, logits route?, a, b, ids, S, micro) of every timed call."""
    from metrics_tpu_torch.utils.data import select_topk, to_onehot

    n, c = smoke.BATCH, smoke.N_CLASSES
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 24)
    rand_logits = torch.randn((n, c), generator=gen, device="cuda")
    rand_labels = torch.randint(0, c, (n,), generator=gen, device="cuda")
    ids = torch.randint(0, 64, (n,), generator=gen, device="cuda")
    preds = torch.randint(0, 2, (n, c), generator=gen, device="cuda", dtype=torch.int32)
    target = torch.randint(0, 2, (n, c), generator=gen, device="cuda", dtype=torch.int32)
    logits, labels, _ = smoke._imagenet_pass()
    x, y, src = logits[:n], labels[:n], smoke._ms_sources()[:n]
    out = [
        ("timing shape, logits, (S, C), S = 64", True, rand_logits, rand_labels, ids, 64, False),
        ("timing shape, logits, micro, S = 64", True, rand_logits, rand_labels, ids, 64, True),
        ("timing shape, canonical int32, (S, C), S = 64", False, preds, target, ids, 64, False),
        ("timing shape, canonical int32, micro, S = 64", False, preds, target, ids, 64, True),
        ("phase 12 per-class accuracy, logits, micro, S = 1000", True, x, y, y, c, True),
        ("phase 12 per-source F1, logits, (S, C), S = 64", True, x, y, src, 64, False),
        ("phase 12 per-class top-5, canonical int32, micro, S = 1000", False, select_topk(x, 5), to_onehot(y, c), y, c, True),
    ]
    for s in (600, 1000, 5000):
        big_ids = torch.randint(0, s, (n,), generator=gen, device="cuda")
        out.append((f"large S, canonical int32, (S, C), S = {s}", False, preds, target, big_ids, s, False))
    for rows in (2048, 4096, 8192, 16_384, 65_536):
        tall = torch.randn((rows, c), generator=gen, device="cuda")
        out.append((f"tall batch, logits, (S, C), N = {rows}, S = 64", True, tall,
                    torch.randint(0, c, (rows,), generator=gen, device="cuda"),
                    torch.randint(0, 64, (rows,), generator=gen, device="cuda"), 64, False))
    return out


VARIANTS = {  # name: (text of the current source, its replacement)
    "four_wide": ("kGrouped ? 4 : 2>", "kGrouped ? 4 : 4>"),
    "timing_no_push": ("if (v != 0) atomicAdd(cluster.map_shared_rank(cnt, owner) + i, v);",
                       "if (v == INT_MIN) atomicAdd(cluster.map_shared_rank(cnt, owner) + i, v);"),
    "timing_no_count": ("        atomicAdd(cnt + (kind * sl + q) * L::kStride + v * Sh::kSeg + seg, 1);",
                        "        if (kind > 2) atomicAdd(cnt + (kind * sl + q) * L::kStride + v * Sh::kSeg + seg, 1);"),
}


def _variants() -> list:
    from metrics_tpu_torch.ops import _build

    text = (_build.CSRC / "stat_scores.cu").read_text()
    paths = []
    for name, (old, new) in VARIANTS.items():
        if text.count(old) != 1:
            raise AssertionError(f"variant {name}: its text is not in the source once")
        path = ROOT / "build" / "ab" / f"{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text.replace(old, new))
        paths.append(str(path))
    return paths


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--variants"]
    if not torch.cuda.is_available() or not args:
        print("usage: python3 tools/stream_stat_scores_ab.py OLD.cu [OTHER.cu ...] [--variants] (needs an NVIDIA GPU)",
              file=sys.stderr)
        return 1
    if "--variants" in sys.argv:
        args += _variants()
    import chip_smoke as smoke
    from metrics_tpu_torch.ops import stat_scores as ops

    card = smoke._card_line()
    print(card)
    olds = {Path(p).stem: _build_old(Path(p)) for p in args}
    results = []
    for name, logits, a, b, ids, s, micro in _calls(smoke):
        fns = {stem: (lambda lib=lib: _old_call(lib, logits, a, b, ids, s, micro)) for stem, lib in olds.items()}
        fns["current"] = (lambda: ops.fused_stream_stat_scores_logits(a, b, ids, s, micro)) if logits \
            else (lambda: ops.fused_stream_stat_scores(a, b, ids, s, micro))
        plain = (ops.fused_stream_stat_scores_logits_plain if logits else ops.fused_stream_stat_scores_plain)(a, b, ids, s, micro)
        for version, fn in fns.items():  # a source named timing_* is a diagnostic cut: timed, not checked
            if not version.startswith("timing_") and not all(torch.equal(g, p) for g, p in zip(fn(), plain)):
                raise AssertionError(f"{name}: the {version} kernel differs from the plain version")
        events = {version: [] for version in fns}
        own = {version: [] for version in fns}
        for version in list(olds) + ["current", "current"] + list(olds)[::-1]:
            events[version].append(smoke._device_ms(fns[version])[0])
            seen = smoke._device_ops(fns[version], 20) or []
            own[version].append(statistics.median(ms for _, ms in seen) if len(seen) == 20 else None)
        results.append({"call": name, "events_ms": events, "own_ms": own})
        print(f"{name}: " + "; ".join(f"{v} events {events[v]!r} own {own[v]!r}" for v in fns) + " (ms)")
    line = {"card": card, "device": torch.cuda.get_device_name(0), "calls": results}
    out = ROOT / "chiprun_out" / "stream_stat_scores_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
