"""Query metrics without pandas: the CSV float converter and the
slot-matching semantics the committed goldens were scored with."""

import subprocess
import sys

import numpy as np
import pytest

from cova_tpu.query.metrics import Boxes, calculate_query, parse_float


class TestParseFloat:
    @pytest.mark.parametrize("text", ["0", "12.5", "-3.25", "1e3", "2.5E-2",
                                      "700.0", "+4"])
    def test_exact_values(self, text):
        assert parse_float(text) == float(text)

    def test_matches_pandas_converter_not_strtod(self):
        # 17 significant digits accumulated in a double, then divided by
        # 1e16: one ulp away from the correctly rounded value (this is a
        # timestamp of golden/synth/dnn_gt.csv).
        text = "1.4333333333333333"
        got = parse_float(text)
        assert got != float(text)
        assert abs(got - float(text)) <= 2 * np.spacing(float(text))
        digits = 0.0
        for ch in "14333333333333333":
            digits = digits * 10.0 + int(ch)
        assert got == digits / 1e16

    def test_nan(self):
        assert np.isnan(parse_float("nan"))


def _boxes(ts, cls):
    n = len(ts)
    z = np.zeros(n)
    return Boxes(z, z, z + 1, z + 1, np.asarray(ts, float),
                 np.asarray(cls, np.int64))


class TestCalculateQuery:
    def test_slots_take_boxes_at_exact_timestamps(self):
        ts_range = np.array([0.0, 0.5, 1.0, 1.5])
        boxes = _boxes([0.5, 0.5, 1.0, 1.2, 1.5], [2, 2, 0, 2, 2])
        bp, gc = calculate_query(boxes, ts_range, [2])
        # 1.2 is not a slot; 1.0 holds only a non-target.
        assert bp.tolist() == [False, True, False, True]
        assert gc == pytest.approx((0 + 2 + 0 + 1) / 4)

    def test_empty(self):
        bp, gc = calculate_query(_boxes([], []), np.arange(3.0), [2])
        assert bp.tolist() == [False] * 3 and gc == 0.0


def test_metrics_import_no_pandas():
    code = ("import sys, cova_tpu.query.metrics; "
            "print('pandas' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "False", out.stderr
