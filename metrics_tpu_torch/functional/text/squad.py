"""SQuAD v1.1 exact match and F1 (counterpart of ``metrics_tpu/functional/text/squad.py``)."""

import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Tuple, Union

import numpy as np
import torch

PREDS_TYPE = Union[Dict[str, Any], List[Dict[str, Any]]]
TARGETS_TYPE = Union[Dict[str, Any], List[Dict[str, Any]]]

SQuAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}


def _normalize_text(s: str) -> str:
    """Lowercase, strip punctuation/articles, collapse whitespace."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def _get_tokens(s: str) -> List[str]:
    return _normalize_text(s).split() if s else []


def _f1_score(prediction: str, target: str) -> float:
    target_tokens = _get_tokens(target)
    pred_tokens = _get_tokens(prediction)
    if len(target_tokens) == 0 or len(pred_tokens) == 0:
        return float(target_tokens == pred_tokens)
    common = Counter(target_tokens) & Counter(pred_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(target_tokens)
    return 2 * precision * recall / (precision + recall)


def _exact_match_score(prediction: str, target: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(target))


def _max_over_ground_truths(
    metric_fn: Callable[[str, str], float], prediction: str, ground_truths: List[str]
) -> float:
    return max(metric_fn(prediction, truth) for truth in ground_truths)


def _squad_input_check(
    preds: PREDS_TYPE, targets: TARGETS_TYPE
) -> Tuple[Dict[str, str], Dict[str, List[str]]]:
    """Normalize inputs to {id: prediction_text} and {id: [answer texts]}."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]
    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key "
                f"string.\nSQuAD Format: {SQuAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                "Please make sure that 'answer' maps to a `SQuAD` format dictionary.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )
    preds_dict = {p["id"]: p["prediction_text"] for p in preds}
    targets_dict = {t["id"]: list(t["answers"]["text"]) for t in targets}
    return preds_dict, targets_dict


def _squad_update(
    preds_dict: Dict[str, str], targets_dict: Dict[str, List[str]]
) -> Tuple[float, float, int]:
    """(f1 sum, exact-match sum, count) over answered questions."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for qid, answers in targets_dict.items():
        if qid not in preds_dict:
            continue
        total += 1
        pred = preds_dict[qid]
        ground_truths = answers if answers else [""]
        exact_match += _max_over_ground_truths(_exact_match_score, pred, ground_truths)
        f1 += _max_over_ground_truths(_f1_score, pred, ground_truths)
    return f1, exact_match, total


def _squad_compute(f1: torch.Tensor, exact_match: torch.Tensor, total: torch.Tensor) -> Dict[str, torch.Tensor]:
    denom = torch.clamp_min(total, 1.0)
    return {
        "exact_match": 100.0 * exact_match / denom,
        "f1": 100.0 * f1 / denom,
    }


def squad(preds: PREDS_TYPE, target: TARGETS_TYPE) -> Dict[str, torch.Tensor]:
    """SQuAD v1.1 exact match and F1, in percent (float32 CPU tensors).

    Example:
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> {k: float(v) for k, v in squad(preds, target).items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    preds_dict, targets_dict = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, targets_dict)
    return _squad_compute(*(torch.as_tensor(np.float32(v)) for v in (f1, exact_match, total)))
