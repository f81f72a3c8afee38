"""Query-accuracy metrics (L6).

Port of the reference analytics layer (reference: parse/parse.py,
parse/common/time.py): binary-predicate (BP) and count (GC) queries over
the aggregator CSVs vs a full-decode ground truth, globally and on a
quadrant region, with per-dataset exclusion regions.

Timestamps here are float seconds; the evaluation grid keeps the
reference's structure of 3 slots per 100 ms (common/time.py:11-21).
"""

from __future__ import annotations

import csv
import dataclasses
import pathlib
from typing import Iterable, Sequence

import numpy as np

SLOT = 1.0 / 30.0
STEP3 = 0.1


def arange_ts(start: float, end: float) -> np.ndarray:
    """3 evaluation slots per 100 ms (reference: common/time.py arange_ts)."""
    base = np.arange(start, end, STEP3)
    out = np.empty(base.size * 3)
    out[0::3] = base
    out[1::3] = base + SLOT
    out[2::3] = base + 2 * SLOT
    return out


@dataclasses.dataclass(frozen=True)
class Boxes:
    """Detections or track boxes as columns, sorted by timestamp (the
    rows of a dnn/assoc/stationary CSV)."""

    left: np.ndarray
    top: np.ndarray
    width: np.ndarray
    height: np.ndarray
    timestamp: np.ndarray
    class_id: np.ndarray

    def __len__(self) -> int:
        return len(self.timestamp)

    def take(self, idx) -> "Boxes":
        return Boxes(*(getattr(self, f.name)[idx] for f in dataclasses.fields(self)))


_COLUMNS = ("left", "top", "width", "height", "timestamp", "class_id")
_POW10 = [10.0**i for i in range(309)]


def parse_float(s: str) -> float:
    """Decimal string -> float the way pandas.read_csv's C converter
    does it (the reference's parse.py reads its CSVs with pandas): up to
    17 significant digits accumulated in a double, then one multiply or
    divide by a power of ten. That result can differ from the correctly
    rounded float() in the last bit, and slots match timestamps by exact
    equality, so the converter decides which detections count."""
    p, n = 0, len(s)
    while p < n and s[p].isspace():
        p += 1
    neg = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while p < n and "0" <= s[p] <= "9":
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while digits < 17 and p < n and "0" <= s[p] <= "9":
            number = number * 10.0 + (ord(s[p]) - 48)
            p, digits, decimals = p + 1, digits + 1, decimals + 1
        while p < n and "0" <= s[p] <= "9":
            p += 1
        exponent -= decimals
    if digits == 0:
        return float(s)  # nan, inf
    if neg:
        number = -number
    if p < n and s[p] in "eE":
        p += 1
        eneg = p < n and s[p] == "-"
        if p < n and s[p] in "+-":
            p += 1
        e = 0
        while p < n and "0" <= s[p] <= "9":
            e = e * 10 + (ord(s[p]) - 48)
            p += 1
        exponent += -e if eneg else e
    if exponent > 308:
        return -float("inf") if neg else float("inf")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _read_rows(path) -> dict:
    cols = {c: [] for c in _COLUMNS}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            for c in _COLUMNS:
                cols[c].append(parse_float(row[c]))
    return cols


def _boxes(cols: dict) -> Boxes:
    arrays = {c: np.asarray(cols[c], np.float64) for c in _COLUMNS}
    order = np.argsort(arrays["timestamp"], kind="stable")
    arrays = {c: a[order] for c, a in arrays.items()}
    arrays["class_id"] = arrays["class_id"].astype(np.int64)
    return Boxes(**arrays)


def load_boxes_csv(path) -> Boxes:
    return _boxes(_read_rows(path))


def load_cova(output_dir) -> Boxes:
    root = pathlib.Path(output_dir)
    cols = _read_rows(root / "assoc.csv")
    st = root / "stationary.csv"
    if st.exists():
        for c, vals in _read_rows(st).items():
            cols[c].extend(vals)
    return _boxes(cols)


def exclude_regions(boxes: Boxes, regions: Iterable) -> Boxes:
    """Drop detections fully inside any exclusion rectangle
    (reference: parse.py get_exclude_df — noise suppression for small
    unstable YOLO detections)."""
    right = boxes.left + boxes.width
    bottom = boxes.top + boxes.height
    keep = np.ones(len(boxes), bool)
    for (left, top), (r, b) in regions:
        keep &= ~(
            (boxes.left >= left) & (boxes.top >= top)
            & (right <= r) & (bottom <= b)
        )
    return boxes.take(keep)


def local_region(
    boxes: Boxes, region: str, width: int = 1280, height: int = 640
) -> Boxes:
    """Quadrant filter (reference: parse.py get_local_df — note the
    reference's 'lower right' uses left <= w/2, preserved)."""
    right = boxes.left + boxes.width
    bottom = boxes.top + boxes.height
    if region == "upper left":
        idx = (right <= width / 2) & (bottom <= height / 2)
    elif region == "upper right":
        idx = (boxes.left >= width / 2) & (bottom <= height / 2)
    elif region == "lower left":
        idx = (right <= width / 2) & (boxes.top >= height / 2)
    elif region == "lower right":
        idx = (boxes.left <= width / 2) & (boxes.top >= height / 2)
    else:
        raise ValueError(f"unknown region {region!r}")
    return boxes.take(idx)


def calculate_query(
    boxes: Boxes, ts_range: np.ndarray, targets: Sequence[int]
):
    """BP series + GC scalar (reference: parse.py calculate_query).

    A slot takes the boxes whose timestamp equals it exactly (the
    reference aligns the grouped detections on the slot index); slots
    without boxes are False / count 0."""
    bp = np.zeros(len(ts_range), bool)
    if len(boxes) == 0:
        return bp, 0.0
    uniq, inv = np.unique(boxes.timestamp, return_inverse=True)
    is_target = np.isin(boxes.class_id, targets)
    counts = np.bincount(inv, weights=is_target, minlength=len(uniq))
    pos = np.searchsorted(uniq, ts_range)
    hit = pos < len(uniq)
    hit[hit] = uniq[pos[hit]] == ts_range[hit]
    gc = np.zeros(len(ts_range))
    gc[hit] = counts[pos[hit]]
    bp[hit] = counts[pos[hit]] > 0
    return bp, float(gc.mean())


@dataclasses.dataclass
class QueryResult:
    bp_accuracy: float
    gc_error: float
    bp_accuracy_local: float
    gc_error_local: float
    num_slots: int


def parse_query(
    gt: Boxes,
    cova: Boxes,
    duration_seconds: float,
    targets: Sequence[int],
    exclude: Iterable = (),
    region: str = "upper left",
    frame_size=(1280, 640),
    ts_start: float = 0.0,
    ts_end: float | None = None,
) -> QueryResult:
    """Full BP/GC/BPL/GCL evaluation (reference: parse.py parse_query).

    ts_start/ts_end restrict the evaluation grid to slots in
    [ts_start, ts_end) — used for held-out evaluation (train/tune on a
    clip prefix, score the unseen suffix; the offline analog of the
    reference's train-one-day/eval-other-days methodology,
    parse/accuracy.py:27-92). The grid is still generated from 0 and
    then filtered, so slot values stay float-identical to the full-clip
    evaluation (detection timestamps must equal grid values exactly to
    count in a slot)."""
    ts_max = max(
        duration_seconds,
        float(gt.timestamp.max()) if len(gt) else 0.0,
    )
    ts_range = arange_ts(0.0, ts_max)
    if ts_start > 0.0:
        ts_range = ts_range[ts_range >= ts_start - 1e-9]
    if ts_end is not None:
        ts_range = ts_range[ts_range < ts_end - 1e-9]

    gt = exclude_regions(gt, exclude)
    cova = exclude_regions(cova, exclude)

    gt_bp, gt_gc = calculate_query(gt, ts_range, targets)
    cv_bp, cv_gc = calculate_query(cova, ts_range, targets)
    bp_acc = float((gt_bp == cv_bp).sum() / len(gt_bp))
    gc_err = abs(gt_gc - cv_gc)

    gt_l = local_region(gt, region, *frame_size)
    cv_l = local_region(cova, region, *frame_size)
    gt_bp_l, gt_gc_l = calculate_query(gt_l, ts_range, targets)
    cv_bp_l, cv_gc_l = calculate_query(cv_l, ts_range, targets)
    bp_acc_l = float((gt_bp_l == cv_bp_l).sum() / len(gt_bp_l))
    gc_err_l = abs(gt_gc_l - cv_gc_l)

    return QueryResult(bp_acc, gc_err, bp_acc_l, gc_err_l, len(ts_range))
