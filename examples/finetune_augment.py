#!/usr/bin/env python3
"""Augmented fine-tune: adapt trained BlobNet weights to mirrored views.

The held-out evaluation (ACCURACY.md) showed the prefix-trained
BlobNet loses recall on content it never saw (suffix GC 0.2172, pure
undercount). Offline, mirroring is the available substitute for the
reference's multi-day training content (parse/accuracy.py trains one
day, evaluates others): utils/dataset.augment_training_set produces 4
label-consistent views per window (hflip/vflip with sign-corrected
signed-MV channels).

Training from scratch ON augmented data collapses: this recipe
(jaccard + ~2.5% foreground) routinely dips to predict-nothing around
epoch 1-2 and recovers after the epoch-10 LR decay, but with the
mirrored views mixed in the recovery never happens (measured: 20
epochs flat at the all-zero plateau, best epoch 0). Fine-tuning the
already-converged unaugmented weights at a low constant LR sidesteps
the collapse entirely and buys the generalization: suffix BP
0.8955 -> 0.9221, GC 0.2172 -> 0.0862 (ACCURACY.md "held-out").

Usage:
  python examples/finetune_augment.py BASE.npz OUT.npz [VIDEO]
      [epochs=6] [max_frames=1200] [--extra V.mp4 [--extra ...]]

BASE.npz: a trained artifact (examples/train_blobnet.py output); its
stored input contract (in_channels/signed_mv) drives the dataset
packing. Deterministic: dataset shuffle seed 1, Adam lr 1e-4.

--extra mixes additional VIDEOS' full training sets (also augmented)
into the fine-tune — genuinely different CONTENT on top of the
mirrored views (round 5: the synthetic third scene,
examples/make_synth.py, attacking the held-out suffix GC — the
offline analog of the reference's multi-scene training corpus,
config/blobnet/{amsterdam,archie,...}).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if len(args) < 2:
        sys.exit(__doc__)
    base, out = args[0], args[1]
    video = args[2] if len(args) > 2 else "/root/reference/demo/1m.mp4"
    epochs = int(args[3]) if len(args) > 3 else 6
    max_frames = int(args[4]) if len(args) > 4 else 1200
    extras = [sys.argv[i + 1] for i, a in enumerate(sys.argv)
              if a == "--extra"]

    import jax
    import numpy as np
    import optax

    from cova_tpu.models.blobnet import load_artifact, save_params_npz
    from cova_tpu.models.train_blobnet import make_train_step
    from cova_tpu.utils.dataset import (
        ArrayDataset,
        augment_training_set,
        build_training_set,
    )

    model, variables, meta = load_artifact(base)
    use_nnz = bool(meta.get("use_nnz_channel", False))
    signed = bool(meta.get("signed_mv", False))
    print(f"base contract: {meta}")

    x, y = build_training_set(
        video, max_frames=max_frames, use_nnz=use_nnz, signed_mv=signed
    )
    for ev in extras:
        ex, ey = build_training_set(
            ev, use_nnz=use_nnz, signed_mv=signed
        )
        x = np.concatenate([x, ex])
        y = np.concatenate([y, ey])
        print(f"mixed in {ev}: +{len(ex)} windows")
    x, y = augment_training_set(x, y, signed_mv=signed)
    print(f"augmented dataset x {x.shape} (hflip x vflip)")

    ds = ArrayDataset(x, y, batch=4, seed=1)
    tx = optax.adam(1e-4)
    step = make_train_step(model, tx, signed_mv=signed)
    params = variables["params"]
    state = (params, variables["batch_stats"], tx.init(params))
    drop_key, n_step = jax.random.PRNGKey(0), 0
    for epoch in range(epochs):
        el = ep = er = nb = 0
        for batch in ds:
            state, m = step(state, batch, jax.random.fold_in(drop_key, n_step))
            n_step += 1
            el += float(m["loss"])
            ep += float(m["precision"])
            er += float(m["recall"])
            nb += 1
        print(
            f"ft epoch {epoch}: loss={el / nb:.3f} prec={ep / nb:.3f} "
            f"rec={er / nb:.3f}",
            flush=True,
        )

    save_params_npz(
        out,
        {
            "params": jax.tree_util.tree_map(np.asarray, state[0]),
            "batch_stats": jax.tree_util.tree_map(np.asarray, state[1]),
        },
        meta={
            **meta,
            "trained_on": f"{meta.get('trained_on', base)} "
            f"+ {epochs}-epoch hflip/vflip-augmented fine-tune lr 1e-4"
            + ("".join(f" + {os.path.basename(e)}" for e in extras)),
        },
    )
    print(f"saved {out}")


if __name__ == "__main__":
    main()
