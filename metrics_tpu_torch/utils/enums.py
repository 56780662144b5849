"""Enums (counterpart of ``metrics_tpu/utils/enums.py``)."""

from enum import Enum
from typing import Optional, Union


class EnumStr(str, Enum):
    """Case-insensitive string enum."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        """The member whose name is ``value`` in any case, or None."""
        try:
            keys = [name.lower() for name in cls.__members__]
            return list(cls.__members__.values())[keys.index(str(value).lower())]
        except ValueError:
            return None

    def __eq__(self, other: Union[str, "EnumStr", None]) -> bool:  # type: ignore[override]
        other = other.value if isinstance(other, Enum) else str(other)
        return self.value.lower() == other.lower()

    def __hash__(self) -> int:
        return hash(self.value.lower())


class DataType(EnumStr):
    """Classification input case."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """Reduction over classes."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """Multi-dim multi-class handling."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"
