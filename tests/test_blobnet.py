"""BlobNet model tests: shapes at reference geometry, parity with the
stored outputs of the earlier Flax module, gradient flow, the train
step, and loss parity properties."""

import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

from cova_tpu.models.blobnet import BlobNet, BlobNetConfig, create_blobnet
from cova_tpu.models.losses import jaccard_distance_loss, precision_recall


class TestBlobNet:
    @pytest.fixture(scope="class")
    def model_vars(self):
        return create_blobnet(jax.random.PRNGKey(0))

    def test_output_shape(self, model_vars):
        model, variables = model_vars
        x = jnp.zeros((2, 4, 45, 80, 3))
        y = model.apply(variables, x, train=False)
        assert y.shape == (2, 45, 80)
        assert float(y.min()) >= 0.0 and float(y.max()) <= 1.0

    def test_encoder_shapes_match_reference(self, model_vars):
        # Reference encoder ladder: 45x80 -> 23x40 -> 12x20 -> 6x10 -> 3x5
        # (pool + odd-dim zero-pad, encoder.py:63-71).
        model, variables = model_vars
        x = jnp.zeros((1, 4, 45, 80, 3))
        assert model.apply(variables, x, train=False).shape == (1, 45, 80)
        # Verify the skip geometry via a manual trace of _pool_pad.
        from cova_tpu.models.blobnet import _pool_pad

        h, w = 45, 80
        expect = [(23, 40), (12, 20), (6, 10), (3, 5)]
        cur = jnp.zeros((1, 4, h, w, 1))
        got = []
        for _ in range(4):
            cur = _pool_pad(cur)
            got.append(cur.shape[2:4])
        assert got == expect

    def test_gradients_flow(self, model_vars):
        model, variables = model_vars
        x = jnp.asarray(np.random.default_rng(0).uniform(size=(1, 4, 45, 80, 3)), jnp.float32)
        y = jnp.zeros((1, 45, 80))

        def loss_fn(params):
            out = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x,
                train=False,
            )
            return jaccard_distance_loss(y, out)

        g = jax.grad(loss_fn)(variables["params"])
        norms = jax.tree_util.tree_map(lambda a: float(jnp.abs(a).sum()), g)
        total = sum(jax.tree_util.tree_leaves(norms))
        assert np.isfinite(total) and total > 0

    def test_bfloat16_forward(self):
        model, variables = create_blobnet(
            jax.random.PRNGKey(0), dtype=jnp.bfloat16
        )
        x = jnp.zeros((1, 4, 45, 80, 3))
        y = model.apply(variables, x, train=False)
        assert y.dtype == jnp.float32  # output upcast
        assert y.shape == (1, 45, 80)

    def test_nnz_fourth_channel(self):
        # use_nnz_channel feeds [mb_class, |mv|, |mv|, nnz/4] — a
        # 4-channel BlobNet must init and run on the same geometry.
        model, variables = create_blobnet(
            jax.random.PRNGKey(0), BlobNetConfig(in_channels=4)
        )
        x = jnp.zeros((2, 4, 45, 80, 4))
        y = model.apply(variables, x, train=False)
        assert y.shape == (2, 45, 80)

    def test_1080p_geometry(self):
        # 1920x1080 -> 120x68 macroblock grid must also work.
        cfg = BlobNetConfig()
        model = BlobNet(cfg)
        x = jnp.zeros((1, 4, 68, 120, 3))
        variables = model.init(jax.random.PRNGKey(0))
        y = model.apply(variables, x, train=False)
        assert y.shape == (1, 68, 120)


FIXTURE = pathlib.Path(__file__).parent / "data" / "blobnet_flax_fixture.npz"


def _fixture_input(channels):
    return np.random.default_rng(7).uniform(
        -1, 1, (2, 4, 45, 80, channels)
    ).astype(np.float32)


def _synth_variables(channels):
    """artifacts/blobnet_synth.npz; with channels=3 its nnz input
    channel is dropped, which makes a 3-channel BlobNet."""
    from cova_tpu.models.blobnet import load_artifact

    _, v, _ = load_artifact(REPO / "artifacts" / "blobnet_synth.npz")
    if channels == 3:
        params = dict(v["params"])
        params["Conv_0"] = {
            "kernel": v["params"]["Conv_0"]["kernel"][:, :, :3, :],
            "bias": v["params"]["Conv_0"]["bias"],
        }
        v = {"params": params, "batch_stats": v["batch_stats"]}
    return v


class TestFlaxParity:
    """tests/data/blobnet_flax_fixture.npz holds what the earlier Flax
    BlobNet module computed, on the CPU at "highest" matmul precision,
    from the committed synth weights on a seeded input: eval
    probabilities for the 4-channel artifact and its 3-channel cut, and
    a train-mode forward (dropout 0) with its updated running
    statistics. The plain-JAX module must reproduce them."""

    @pytest.fixture(scope="class")
    def fixture(self):
        return np.load(FIXTURE)

    @pytest.mark.parametrize("channels", [4, 3])
    def test_eval_probabilities(self, fixture, channels):
        x = _fixture_input(channels)
        assert x.astype(np.float64).sum() == pytest.approx(
            float(fixture[f"x_checksum{channels}"]), rel=1e-12
        )
        model = BlobNet(BlobNetConfig(in_channels=channels))
        with jax.default_matmul_precision("highest"):
            got = model.apply(_synth_variables(channels), jnp.asarray(x))
        np.testing.assert_allclose(
            np.asarray(got), fixture[f"probs_synth{channels}"], atol=1e-6
        )

    def test_train_forward_and_batch_stats(self, fixture):
        model = BlobNet(BlobNetConfig(in_channels=4, dropout=0.0))
        with jax.default_matmul_precision("highest"):
            got, stats = model.apply(
                _synth_variables(4), jnp.asarray(_fixture_input(4)),
                train=True,
            )
        np.testing.assert_allclose(
            np.asarray(got), fixture["probs_train4"], atol=1e-6
        )
        assert sorted(stats) == [f"BatchNorm_{i}" for i in range(7)]
        for name, s in stats.items():
            for k in ("mean", "var"):
                np.testing.assert_allclose(
                    np.asarray(s[k]), fixture[f"stats/{name}/{k}"],
                    rtol=1e-5, atol=1e-6,
                )

    def test_artifacts_load_unchanged(self):
        """Every committed weight file restores into the plain-JAX
        parameter tree with no key or shape left over."""
        from cova_tpu.models.blobnet import load_artifact

        for path in sorted((REPO / "artifacts").glob("blobnet_*.npz")):
            _, v, meta = load_artifact(path)
            keys = set(np.load(path).files) - {"__meta__"}
            flat = jax.tree_util.tree_flatten_with_path(v)[0]
            got = {"/".join(p.key for p in kp) for kp, _ in flat}
            assert got == keys, path.name
            assert v["params"]["Conv_0"]["kernel"].shape[2] == meta["in_channels"]


class TestTrainStep:
    def _setup(self):
        import optax

        from cova_tpu.models.train_blobnet import make_train_step

        model, variables = create_blobnet(jax.random.PRNGKey(1))
        tx = optax.adam(1e-3)
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.integers(0, 256, (2, 4, 45, 80, 3)), jnp.float32)
        y = jnp.asarray(rng.uniform(size=(2, 45, 80)) > 0.8, jnp.float32)

        def state():
            p = jax.tree_util.tree_map(jnp.array, variables["params"])
            s = jax.tree_util.tree_map(jnp.array, variables["batch_stats"])
            return (p, s, tx.init(p))

        return make_train_step(model, tx), state, (x, y), variables

    def test_updates_batch_stats_deterministically(self):
        step, state, batch, variables = self._setup()
        key = jax.random.PRNGKey(5)
        (p1, s1, _), m1 = step(state(), batch, key)
        (p2, s2, _), m2 = step(state(), batch, key)
        # Same dropout key: the same step, bit for bit.
        assert float(m1["loss"]) == float(m2["loss"])
        for a, b in zip(jax.tree_util.tree_leaves((p1, s1)),
                        jax.tree_util.tree_leaves((p2, s2))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # Running statistics moved toward the batch's.
        for name, s in s1.items():
            before = variables["batch_stats"][name]["mean"]
            assert not np.array_equal(np.asarray(s["mean"]), np.asarray(before)), name

    def test_dropout_key_changes_step(self):
        step, state, batch, _ = self._setup()
        _, m1 = step(state(), batch, jax.random.PRNGKey(5))
        _, m2 = step(state(), batch, jax.random.PRNGKey(6))
        assert float(m1["loss"]) != float(m2["loss"])

    def test_train_needs_dropout_key(self):
        model, variables = create_blobnet(jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match="dropout_key"):
            model.apply(variables, jnp.zeros((1, 4, 45, 80, 3)), train=True)


class TestLosses:
    def test_jaccard_perfect(self):
        y = jnp.ones((2, 8, 8))
        assert float(jaccard_distance_loss(y, y)) == pytest.approx(0.0, abs=1e-4)

    def test_jaccard_disjoint_worse(self):
        t = jnp.zeros((1, 8, 8)).at[0, :4].set(1.0)
        good = t
        bad = 1.0 - t
        assert float(jaccard_distance_loss(t, bad)) > float(
            jaccard_distance_loss(t, good)
        )

    def test_precision_recall(self):
        t = jnp.zeros((4, 4)).at[:2].set(1.0)
        p = jnp.zeros((4, 4)).at[:1].set(1.0)
        prec, rec = precision_recall(t, p)
        assert float(prec) == pytest.approx(1.0)
        assert float(rec) == pytest.approx(0.5)


class TestTrainInferenceContract:
    """The train step and the inference pipeline must agree on input
    normalization: metapreprocess feeds the model clip(x,0,6)/6, so the
    train step must apply the same to its raw u8-valued windows.
    (Round-2 regression: a trained checkpoint produced empty masks in
    the pipeline because training saw raw 0-255 inputs.)"""

    def test_train_step_normalizes_input(self):
        import numpy as np
        import optax

        from cova_tpu.models.blobnet import BlobNetConfig, create_blobnet
        from cova_tpu.models.losses import jaccard_distance_loss
        from cova_tpu.models.train_blobnet import make_train_step
        from cova_tpu.ops.preprocess import clip6_normalize

        cfg = BlobNetConfig()
        model, variables = create_blobnet(jax.random.PRNGKey(0), cfg)
        tx = optax.adam(1e-3)
        step = make_train_step(model, tx)

        rng = np.random.default_rng(0)
        x = rng.integers(0, 256, (2, 4, 45, 80, 3)).astype(np.float32)
        y = (rng.uniform(size=(2, 45, 80)) > 0.8).astype(np.float32)

        # Reference loss computed with explicit normalization outside —
        # before the step call, which donates (deletes) its input state.
        key = jax.random.PRNGKey(0)
        out = model.apply(
            {"params": variables["params"],
             "batch_stats": variables["batch_stats"]},
            clip6_normalize(jnp.asarray(x)),
            train=True,
            dropout_key=key,
        )[0]
        expected = float(jaccard_distance_loss(jnp.asarray(y), out))

        params = variables["params"]
        state = (params, variables["batch_stats"], tx.init(params))
        _, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)), key)
        assert float(metrics["loss"]) == pytest.approx(expected, rel=1e-5)


class TestAugmentation:
    """augment_training_set (utils/dataset.py): label-consistent
    mirrored views with sign-corrected signed-MV channels — the offline
    substitute for the reference's multi-day training content
    (ACCURACY.md held-out evaluation)."""

    def _base(self):
        rng = np.random.default_rng(7)
        x = rng.integers(0, 256, (5, 4, 6, 8, 4), dtype=np.uint8)
        y = (rng.uniform(size=(5, 6, 8)) > 0.7).astype(np.uint8)
        return x, y

    def test_views_and_shapes(self):
        from cova_tpu.utils.dataset import augment_training_set

        x, y = self._base()
        xa, ya = augment_training_set(x, y, signed_mv=True)
        assert xa.shape == (20, 4, 6, 8, 4) and ya.shape == (20, 6, 8)
        # Original first, untouched.
        assert np.array_equal(xa[:5], x) and np.array_equal(ya[:5], y)

    def test_hflip_geometry_and_mv_sign(self):
        from cova_tpu.utils.dataset import augment_training_set

        x, y = self._base()
        xa, ya = augment_training_set(x, y, signed_mv=True, vflip=False)
        xf, yf = xa[5:], ya[5:]
        # W mirrored on every non-MV channel and the label.
        assert np.array_equal(xf[..., 0], x[..., ::-1, 0])
        assert np.array_equal(xf[..., 3], x[..., ::-1, 3])
        assert np.array_equal(yf, y[:, :, ::-1])
        # mv_x negated around the offset-128 packing (saturated)...
        exp = np.clip(256 - x[..., ::-1, 1].astype(np.int16), 0, 255)
        assert np.array_equal(xf[..., 1], exp.astype(np.uint8))
        # ...and mv_y untouched.
        assert np.array_equal(xf[..., 2], x[..., ::-1, 2])

    def test_vflip_composes_with_hflip(self):
        from cova_tpu.utils.dataset import augment_training_set

        x, y = self._base()
        xa, ya = augment_training_set(x, y, signed_mv=True)
        xb, yb = xa[15:], ya[15:]  # hflip + vflip composite
        base = x[:, :, ::-1, :][:, :, :, ::-1]  # H then W mirror
        assert np.array_equal(xb[..., 0], base[..., 0])
        assert np.array_equal(yb, y[:, ::-1, :][:, :, ::-1])
        for chan in (1, 2):  # both MV channels negated once
            exp = np.clip(256 - base[..., chan].astype(np.int16), 0, 255)
            assert np.array_equal(xb[..., chan], exp.astype(np.uint8))

    def test_unsigned_mv_flip_invariant(self):
        from cova_tpu.utils.dataset import augment_training_set

        x, y = self._base()
        xa, _ = augment_training_set(x, y, signed_mv=False, vflip=False)
        # |mv| channels mirror geometrically but keep their values.
        assert np.array_equal(xa[5:][..., 1], x[..., ::-1, 1])
