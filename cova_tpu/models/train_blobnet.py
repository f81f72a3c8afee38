"""BlobNet training loop in JAX/optax.

Replaces the reference Keras training (reference: utils/train-blobnet.py):
Adam, smoothed Jaccard distance, 20 epochs with exponential LR decay
(x e^-0.1 per epoch) after epoch 10, batch 4; plus upgrades the reference
lacks (SURVEY.md §5.3-5.4): best-epoch selection, and a graceful SIGINT
stop handled by the caller; the step itself is pure and mesh-ready (data
parallel over the `stream` axis). Weights are saved as .npz
(models.blobnet.save_params_npz).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from cova_tpu.models.blobnet import BlobNet, BlobNetConfig, create_blobnet
from cova_tpu.models.losses import jaccard_distance_loss, precision_recall
from cova_tpu.ops.preprocess import clip6_normalize


@dataclasses.dataclass
class TrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: int


def lr_schedule(base_lr: float = 1e-3, decay_start_epoch: int = 10,
                steps_per_epoch: int = 1000):
    """Reference scheduler: constant, then *e^-0.1 per epoch
    (train-blobnet.py:71-77)."""

    def fn(step):
        epoch = step // steps_per_epoch
        decay_epochs = jnp.maximum(epoch - decay_start_epoch + 1, 0)
        return base_lr * jnp.exp(-0.1 * decay_epochs)

    return fn


def make_train_step(
    model: BlobNet,
    tx: optax.GradientTransformation,
    signed_mv: bool = False,
):
    @functools.partial(jax.jit, donate_argnums=(0,))
    def train_step(state: tuple, batch, dropout_key):
        """One Adam step. Batch statistics replace the running ones in
        the forward pass and come back updated; dropout masks come from
        `dropout_key`, so a step is a pure function of its arguments."""
        params, batch_stats, opt_state = state
        x, y = batch
        # The model's input contract is clip(x,0,6)/6-normalized metadata
        # (the reference bakes this into the Keras model so training and
        # the engine agree, utils/model/preprocessing.py:5-8; our
        # pipeline applies it in metapreprocess) — training MUST see the
        # same normalization or inference runs out of distribution.
        # signed_mv switches the MV channels to the signed offset-128
        # normalization (ops/preprocess.clip6_normalize).
        x = clip6_normalize(x, signed_mv)

        def loss_fn(p):
            out, new_stats = model.apply(
                {"params": p, "batch_stats": batch_stats},
                x,
                train=True,
                dropout_key=dropout_key,
            )
            return jaccard_distance_loss(y, out), (out, new_stats)

        (loss, (out, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        prec, rec = precision_recall(y, out)
        metrics = {"loss": loss, "precision": prec, "recall": rec}
        return (new_params, new_stats, new_opt), metrics

    return train_step


def train_blobnet(
    dataset,
    epochs: int = 20,
    base_lr: float = 1e-3,
    config: BlobNetConfig = BlobNetConfig(),
    dtype=jnp.float32,
    rng=None,
    log_every: int = 50,
    should_stop=lambda: False,
    signed_mv: bool = False,
):
    """dataset: iterable of (x (B,T,H,W,C) float, y (B,H,W) float) per
    epoch (call iter each epoch). Returns (model, variables)."""
    rng = rng if rng is not None else jax.random.PRNGKey(0)
    init_rng, drop_rng = jax.random.split(rng)
    model, variables = create_blobnet(init_rng, config, dtype)
    steps_per_epoch = getattr(dataset, "steps_per_epoch", 1000)
    tx = optax.adam(lr_schedule(base_lr, 10, steps_per_epoch))
    params = variables["params"]
    batch_stats = variables["batch_stats"]
    opt_state = tx.init(params)
    step_fn = make_train_step(model, tx, signed_mv)
    state = (params, batch_stats, opt_state)

    step = 0
    best = None  # (f1, epoch, params, batch_stats)
    for epoch in range(epochs):
        ep_loss = ep_prec = ep_rec = 0.0
        nb = 0
        for batch in dataset:
            state, metrics = step_fn(
                state, batch, jax.random.fold_in(drop_rng, step)
            )
            step += 1
            ep_loss += float(metrics["loss"])
            ep_prec += float(metrics["precision"])
            ep_rec += float(metrics["recall"])
            nb += 1
            if log_every and step % log_every == 0:
                print(
                    f"epoch {epoch} step {step}: "
                    f"loss={float(metrics['loss']):.3f} "
                    f"prec={float(metrics['precision']):.3f} "
                    f"rec={float(metrics['recall']):.3f}"
                )
            if should_stop():
                break
        if nb:
            # Keep the best epoch by F1 over the epoch's running
            # metrics — the reference returns the last epoch, which can
            # regress late in training (observed in round 2).
            p, r = ep_prec / nb, ep_rec / nb
            f1 = 2 * p * r / max(p + r, 1e-9)
            print(
                f"epoch {epoch}: mean loss={ep_loss / nb:.3f} "
                f"prec={p:.3f} rec={r:.3f} f1={f1:.3f}"
            )
            if best is None or f1 > best[0]:
                # Materialize on host: train_step donates its input
                # state, so keeping the Array objects would return
                # DELETED buffers whenever the best epoch is not the
                # last one (the save then crashes on "Array has been
                # deleted").
                best = (
                    f1, epoch,
                    jax.tree_util.tree_map(lambda a: np.asarray(a),
                                           state[0]),
                    jax.tree_util.tree_map(lambda a: np.asarray(a),
                                           state[1]),
                )
        if should_stop():
            print("training interrupted, returning best weights so far")
            break
    if best is not None:
        print(f"best epoch: {best[1]} (f1 {best[0]:.3f})")
        return model, {"params": best[2], "batch_stats": best[3]}
    params, batch_stats, _ = state
    return model, {"params": params, "batch_stats": batch_stats}
