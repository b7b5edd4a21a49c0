"""Label space for driving-event classification (copy of
``sldm_gnn_tpu/labels.py``: 4-event bitmask label space)."""

from enum import IntEnum


class LabelsEnum(IntEnum):
    LANE_CHANGE = 0
    OVERTAKE = 1
    TURN = 2
    COLLISION = 3


ALL_LABELS = [lb.value for lb in LabelsEnum]


def decode_bitmask(mlb: int, active_labels: list[int]) -> list[float]:
    """Decode an ``MLBEncoded`` integer bitmask into a multi-hot vector
    over ``active_labels``."""
    return [1.0 if (int(mlb) & (1 << int(c))) else 0.0 for c in active_labels]


def label_name(value: int) -> str:
    """Human-readable label name."""
    try:
        return LabelsEnum(value).name
    except ValueError:
        return "UNKNOWN_LABEL"
