"""Tests for the algorithm ops (L2) — ports of the reference's cargo unit
tests (cova-rs/sort/src/lib.rs:227-408, cova-rs/bbox/src/bbox.rs:93-131)
plus randomized cross-checks against scipy."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.ndimage
import scipy.optimize

from cova_tpu.ops import (
    iou_matrix,
    iou_pairwise,
    solve_assignment,
    connected_components,
    mask_to_boxes,
    temporal_stack,
    metapreprocess,
    batched_nms,
)


class TestIoU:
    # Reference: bbox.rs tests — same box, quarter overlap, no overlap.
    def test_same(self):
        a = jnp.array([0.0, 0.0, 2.0, 2.0])
        assert float(iou_pairwise(a, a)) == pytest.approx(1.0)

    def test_quarter(self):
        a = jnp.array([0.0, 0.0, 2.0, 2.0])
        b = jnp.array([1.0, 1.0, 2.0, 2.0])
        assert float(iou_pairwise(a, b)) == pytest.approx(1.0 / 7.0)

    def test_none(self):
        a = jnp.array([0.0, 0.0, 2.0, 2.0])
        b = jnp.array([5.0, 5.0, 2.0, 2.0])
        assert float(iou_pairwise(a, b)) == 0.0

    def test_matrix_matches_reference(self):
        # Reference: test_generate_iou_matrix — dets x preds values.
        dets = jnp.array([[0.0, 0.0, 2.0, 2.0], [1.0, 1.0, 1.0, 1.0]])
        preds = jnp.array([[1.0, 1.0, 1.0, 1.0]])
        m = iou_matrix(preds, dets)
        assert m.shape == (1, 2)
        assert float(m[0, 0]) == pytest.approx(0.25)
        assert float(m[0, 1]) == pytest.approx(1.0)


def _assignment_cost(cost, r2c):
    return sum(cost[i, int(j)] for i, j in enumerate(r2c))


class TestAssignment:
    # The four reference Hungarian cases (lib.rs:268-369), zero-padded to
    # square exactly as the reference does.
    def _solve_and_filter(self, cost, n_rows, n_cols):
        n = max(n_rows, n_cols)
        sq = np.zeros((n, n), np.float32)
        sq[:n_rows, :n_cols] = cost
        r2c = np.asarray(solve_assignment(jnp.asarray(sq)))
        pairs = [
            (i, int(j))
            for i, j in enumerate(r2c)
            if i < n_rows and j < n_cols and cost[i, int(j)] != 2.0
        ]
        return sorted(pairs)

    def test_5x5(self):
        base = np.full((5, 5), 2.0, np.float32)
        for i, j in [(0, 0), (1, 1), (2, 3)]:
            base[i, j] = 1.0
        pairs = self._solve_and_filter(base, 5, 5)
        assert pairs == [(0, 0), (1, 1), (2, 3)]

    def test_2x3(self):
        base = np.full((2, 3), 1.0, np.float32)
        base[0, 0] = 0.0
        base[1, 2] = 0.0
        n = 3
        sq = np.zeros((n, n), np.float32)
        sq[:2, :3] = base
        r2c = np.asarray(solve_assignment(jnp.asarray(sq)))
        pairs = sorted((i, int(j)) for i, j in enumerate(r2c) if i < 2)
        assert pairs == [(0, 0), (1, 2)]

    def test_3x2(self):
        base = np.full((3, 2), 1.0, np.float32)
        base[0, 0] = 0.0
        base[2, 1] = 0.0
        sq = np.zeros((3, 3), np.float32)
        sq[:3, :2] = base
        r2c = np.asarray(solve_assignment(jnp.asarray(sq)))
        pairs = sorted(
            (i, int(j)) for i, j in enumerate(r2c) if int(r2c[i]) < 2 and base[i, int(j)] == 0.0
        )
        assert pairs == [(0, 0), (2, 1)]

    def test_9x8(self):
        base = np.full((9, 8), 1.0, np.float32)
        hits = [(0, 0), (1, 1), (2, 2), (4, 3), (5, 4), (6, 5), (7, 6), (8, 7)]
        for i, j in hits:
            base[i, j] = 0.0
        sq = np.zeros((9, 9), np.float32)
        sq[:9, :8] = base
        r2c = np.asarray(solve_assignment(jnp.asarray(sq)))
        pairs = sorted(
            (i, int(j)) for i, j in enumerate(r2c) if int(r2c[i]) < 8 and base[i, int(j)] == 0.0
        )
        assert pairs == hits

    @pytest.mark.parametrize("seed", range(5))
    def test_random_optimality(self, seed):
        # Auction must match scipy's optimal total cost.
        rng = np.random.default_rng(seed)
        n = 16
        cost = rng.uniform(0, 2, (n, n)).astype(np.float32)
        r2c = np.asarray(solve_assignment(jnp.asarray(cost), eps=1e-5))
        assert sorted(r2c.tolist()) == list(range(n))  # permutation
        _, cols = scipy.optimize.linear_sum_assignment(cost)
        ours = _assignment_cost(cost, r2c)
        best = _assignment_cost(cost, cols)
        assert ours <= best + 1e-3


class TestAssignmentOverflow:
    """solve_assignment_overflow must solve the same problem as the
    square zero-padded LAP sort_step used to build (its docstring's
    reduction argument, checked by total-cost equality — eps-level ties
    may pick different but equally-cheap matchings)."""

    @staticmethod
    def _total(cost, row_mask, col_mask, ovf, matched):
        tot = 0.0
        for i in range(len(row_mask)):
            if not row_mask[i]:
                continue
            j = int(matched[i])
            tot += cost[i, j] if j >= 0 else ovf
        return tot

    @pytest.mark.parametrize("seed", range(8))
    def test_matches_padded_square_lap(self, seed):
        from cova_tpu.ops.assignment import solve_assignment_overflow

        rng = np.random.default_rng(seed)
        mt, md, ovf = 24, 8, 3.0
        row_mask = rng.random(mt) < rng.uniform(0.2, 0.9)
        col_mask = rng.random(md) < rng.uniform(0.3, 1.0)
        # SORT-shaped costs: weight (1 or 2) minus IoU-like values with
        # plenty of exact ties (quantized) to exercise tie handling.
        weight = rng.choice([1.0, 2.0], mt)
        iou = np.round(rng.uniform(0, 1, (mt, md)) * 4) / 4
        cost = (weight[:, None] - iou).astype(np.float32)

        # eps must be coarse enough that the contested price climb
        # (~overflow/eps iterations; see the op docstring) fits the
        # iteration bound; optimality tolerance below is rows*eps.
        eps = 1e-3
        matched = np.asarray(
            solve_assignment_overflow(
                jnp.asarray(cost),
                jnp.asarray(row_mask),
                jnp.asarray(col_mask),
                ovf,
                eps=eps,
                max_iters=8192,
            )
        )
        # Validity: masked-out rows unmatched; real matches hit masked
        # columns, each at most once.
        real = matched[matched >= 0]
        assert len(set(real.tolist())) == len(real)
        for i in range(mt):
            if matched[i] >= 0:
                assert row_mask[i] and col_mask[matched[i]]
            if not row_mask[i]:
                assert matched[i] == -1

        # Optimality: equal total to scipy on the equivalent square
        # LAP (rows = masked rows, columns = masked cols + one overflow
        # column per row).
        rows = np.where(row_mask)[0]
        cols = np.where(col_mask)[0]
        nr, nc = len(rows), len(cols)
        n = nr + nc  # enough overflow columns for every row
        sq = np.full((n, n), 0.0, np.float32)
        sq[:nr, :nc] = cost[np.ix_(rows, cols)]
        sq[:nr, nc:] = ovf
        import scipy.optimize

        _, jc = scipy.optimize.linear_sum_assignment(sq)
        best = sum(
            sq[i, jc[i]] for i in range(nr)
        )
        ours = self._total(cost, row_mask, col_mask, ovf, matched)
        assert ours == pytest.approx(best, abs=int(row_mask.sum()) * eps)

    def test_all_rows_overflow_when_no_columns(self):
        from cova_tpu.ops.assignment import solve_assignment_overflow

        cost = jnp.ones((6, 4), jnp.float32)
        m = np.asarray(
            solve_assignment_overflow(
                cost,
                jnp.ones(6, bool),
                jnp.zeros(4, bool),
                3.0,
            )
        )
        assert (m == -1).all()


class TestConnectedComponents:
    def test_simple(self):
        mask = np.zeros((6, 8), bool)
        mask[1:3, 1:3] = True  # blob A
        mask[4:6, 5:8] = True  # blob B
        lab = np.asarray(connected_components(jnp.asarray(mask)))
        assert lab[1, 1] == lab[2, 2]
        assert lab[4, 5] == lab[5, 7]
        assert lab[1, 1] != lab[4, 5]
        assert lab[0, 0] == 48  # background sentinel

    def test_diagonal_connectivity(self):
        # 8-connectivity joins diagonal pixels.
        mask = np.zeros((4, 4), bool)
        mask[0, 0] = mask[1, 1] = mask[2, 2] = True
        lab = np.asarray(connected_components(jnp.asarray(mask)))
        assert lab[0, 0] == lab[1, 1] == lab[2, 2]

    def test_spiral_exactness(self):
        # A long spiral path must still collapse to one component.
        mask = np.zeros((15, 15), bool)
        mask[0, :] = True
        mask[:, 14] = True
        mask[14, 2:] = True
        mask[4:15, 2] = True
        mask[4, 2:10] = True
        lab = np.asarray(connected_components(jnp.asarray(mask)))
        vals = np.unique(lab[mask])
        assert len(vals) == 1

    @pytest.mark.parametrize("seed", range(3))
    def test_random_vs_scipy(self, seed):
        rng = np.random.default_rng(seed)
        mask = rng.uniform(size=(45, 80)) < 0.3
        lab = np.asarray(connected_components(jnp.asarray(mask)))
        ref_lab, n_ref = scipy.ndimage.label(mask, structure=np.ones((3, 3)))
        # Same partition: count distinct labels and co-membership.
        ours = len(np.unique(lab[mask]))
        assert ours == n_ref
        # Each reference component maps to exactly one of our labels.
        for c in range(1, n_ref + 1):
            sel = ref_lab == c
            assert len(np.unique(lab[sel])) == 1

    def test_boxes_match_scipy_stats(self):
        rng = np.random.default_rng(7)
        mask = rng.uniform(size=(45, 80)) < 0.25
        boxes = mask_to_boxes(jnp.asarray(mask), area_threshold=5, max_boxes=32)
        ref_lab, n_ref = scipy.ndimage.label(mask, structure=np.ones((3, 3)))
        slices = scipy.ndimage.find_objects(ref_lab)
        ref_boxes = []
        for c, sl in enumerate(slices, 1):
            area = int((ref_lab == c).sum())
            if area >= 5:
                ref_boxes.append(
                    (
                        sl[1].start,
                        sl[0].start,
                        sl[1].stop - sl[1].start,
                        sl[0].stop - sl[0].start,
                    )
                )
        got = [
            tuple(map(int, np.asarray(boxes.ltwh[i])))
            for i in range(32)
            if bool(boxes.valid[i])
        ]
        # scipy labels in raster order of first pixel too, so order matches.
        assert got == ref_boxes[:32]

    def test_area_threshold(self):
        mask = np.zeros((10, 10), bool)
        mask[0, 0] = True  # area 1
        mask[5:8, 5:8] = True  # area 9
        boxes = mask_to_boxes(jnp.asarray(mask), area_threshold=2, max_boxes=8)
        assert int(boxes.count()) == 1
        assert tuple(map(int, np.asarray(boxes.ltwh[0]))) == (5, 5, 3, 3)

    def test_batched(self):
        mask = np.zeros((3, 12, 12), bool)
        mask[0, 2:4, 2:4] = True
        mask[2, 5:9, 5:9] = True
        boxes = mask_to_boxes(jnp.asarray(mask), area_threshold=1, max_boxes=4)
        counts = np.asarray(boxes.count())
        assert counts.tolist() == [1, 0, 1]


class TestPreprocess:
    def test_stack_newest_first(self):
        f = 8
        frames = np.arange(f, dtype=np.uint8)[:, None, None, None] * np.ones(
            (1, 2, 2, 3), np.uint8
        )
        out = np.asarray(temporal_stack(jnp.asarray(frames), timestep=4, gamma=1))
        assert out.shape == (5, 4, 2, 2, 3)
        # window 0 covers frames 0..3 newest-first
        assert out[0, :, 0, 0, 0].tolist() == [3, 2, 1, 0]
        assert out[4, :, 0, 0, 0].tolist() == [7, 6, 5, 4]

    def test_gamma(self):
        frames = np.arange(10, dtype=np.uint8)[:, None, None, None] * np.ones(
            (1, 1, 1, 1), np.uint8
        )
        out = np.asarray(temporal_stack(jnp.asarray(frames), timestep=4, gamma=2))
        assert out.shape[0] == 4
        assert out[1, 0, 0, 0, 0] == 5  # window 1 starts at frame 2, newest=5

    def test_normalize(self):
        frames = np.full((4, 1, 1, 3), 12, np.uint8)
        out = np.asarray(metapreprocess(jnp.asarray(frames), timestep=4))
        assert out.max() == pytest.approx(1.0)
        frames = np.full((4, 1, 1, 3), 3, np.uint8)
        out = np.asarray(metapreprocess(jnp.asarray(frames), timestep=4))
        assert out.max() == pytest.approx(0.5)


class TestNMS:
    def test_suppression(self):
        boxes = jnp.asarray(
            np.array(
                [
                    [0, 0, 10, 10],
                    [1, 1, 10, 10],  # overlaps box 0 heavily
                    [50, 50, 10, 10],
                ],
                np.float32,
            )
        )
        scores = jnp.asarray(np.array([0.9, 0.8, 0.7], np.float32))
        cls = jnp.asarray(np.array([0, 0, 0], np.int32))
        ltwh, sc, c, valid = batched_nms(boxes, scores, cls, 0.2, 0.25, 4)
        assert int(valid.sum()) == 2
        assert float(sc[0]) == pytest.approx(0.9)

    def test_class_aware(self):
        boxes = jnp.asarray(
            np.array([[0, 0, 10, 10], [1, 1, 10, 10]], np.float32)
        )
        scores = jnp.asarray(np.array([0.9, 0.8], np.float32))
        cls = jnp.asarray(np.array([0, 1], np.int32))
        _, _, _, valid = batched_nms(boxes, scores, cls, 0.2, 0.25, 4)
        assert int(valid.sum()) == 2  # different classes don't suppress
