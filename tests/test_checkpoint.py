"""Checkpoint/resume (SURVEY.md §5.4) and naive-baseline smoke tests.

The reference's only training checkpoint is Keras save_model
(reference: utils/train-blobnet.py:117-119) and its runtime artifacts
are cached TensorRT engines; here one self-describing .npz file is the
single artifact format — these tests pin the save/restore round trip
that examples/train_blobnet.py (save) and examples/run_cova.py
(COVA_BLOBNET_CKPT load) rely on.
"""

import csv
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

DEMO = "/root/reference/demo/1m.mp4"


class TestOrbaxRoundTrip:
    """(Named for the checkpoint format it replaced.)"""

    def test_blobnet_variables_roundtrip(self, tmp_path):
        from cova_tpu.models.blobnet import (
            BlobNetConfig,
            create_blobnet,
            load_artifact,
            save_params_npz,
        )

        model, variables = create_blobnet(
            jax.random.PRNGKey(3), BlobNetConfig()
        )

        path = os.path.join(tmp_path, "weights.npz")
        save_params_npz(path, variables, meta={"in_channels": 3})
        _, restored, meta = load_artifact(path)
        assert meta == {"in_channels": 3}

        flat_a = jax.tree_util.tree_leaves_with_path(variables)
        flat_b_map = dict(jax.tree_util.tree_leaves_with_path(restored))
        assert len(flat_a) == len(flat_b_map)
        for key, leaf in flat_a:
            np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b_map[key]))

        # The restored tree must drive the same forward pass.
        x = jnp.asarray(
            np.random.default_rng(0).uniform(0, 1, (2, 4, 45, 80, 3)),
            jnp.float32,
        )
        fwd = jax.jit(lambda v: model.apply(v, x, train=False))
        np.testing.assert_allclose(
            np.asarray(fwd(variables)), np.asarray(fwd(restored)), rtol=1e-6
        )


@pytest.mark.skipif(not os.path.exists(DEMO), reason="demo clip not mounted")
class TestNaivePipeline:
    def test_smoke_dnn_csv(self, tmp_path):
        from cova_tpu.aggregator.associator import BoxRec
        from cova_tpu.pipeline.naive import NaivePipeline

        calls = {"frames": 0}

        def fake_detector(frames):
            # One fixed detection per decoded frame.
            out = []
            for pts, y, u, v in frames:
                calls["frames"] += 1
                assert y.shape == (720, 1280)
                # Timestamps arrive in seconds (25 frames @30fps < 1s).
                assert 0.0 <= pts < 1.0
                out.append(
                    BoxRec(
                        left=10.0,
                        top=20.0,
                        width=30.0,
                        height=40.0,
                        area=1200.0,
                        track_id=None,
                        timestamp=pts,
                        class_id=2,
                        confidence=0.9,
                    )
                )
            return out

        pipe = NaivePipeline(DEMO, str(tmp_path), fake_detector, batch=8)
        res = pipe.run(max_frames=25)
        assert res.num_frames == 25
        assert calls["frames"] == 25
        assert res.num_detections == 25

        rows = list(csv.reader(open(tmp_path / "dnn.csv")))
        # header + one row per decoded frame, bboxsink-style columns
        # (cova-rs/gst-plugins/src/bboxsink/imp.rs).
        assert len(rows) == 26
        assert float(rows[1][0]) == 10.0 and float(rows[1][3]) == 40.0
        assert int(rows[1][7]) == 2
