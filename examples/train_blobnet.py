#!/usr/bin/env python3
"""Train BlobNet on a video, end to end, fully offline.

Replaces the reference's three-step flow (generate-mog.py ->
generate-record.sh -> train-blobnet.py) with one command: full decode +
MOG2 labels (on the accelerator), entropy-decoded metadata windows,
Jaccard-loss training, weights saved as OUT_DIR/weights.npz (the
artifacts/*.npz format that models.blobnet.load_artifact reads).

Usage:
  python examples/train_blobnet.py VIDEO.mp4 OUT_DIR [epochs] [max_frames]
      [--nnz] [--signed] [--augment]

--nnz adds the residual-density 4th input channel; --signed trains on
mean signed offset-128 MV channels instead of mean |mv| (the reference
metadata contract, utils/data/parse.py:5-31 — ablation in ACCURACY.md).
--augment mirrors the training windows horizontally and vertically
(MV channels sign-corrected) — 4 label-consistent views per window,
the offline substitute for the reference's multi-day training content
(ACCURACY.md held-out evaluation).
"""

import os
import signal
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    use_nnz = "--nnz" in sys.argv
    signed_mv = "--signed" in sys.argv
    augment = "--augment" in sys.argv
    if len(args) < 2:
        sys.exit(__doc__)
    video, ckpt_dir = args[0], args[1]
    epochs = int(args[2]) if len(args) > 2 else 20
    max_frames = int(args[3]) if len(args) > 3 else None

    import numpy as np

    from cova_tpu.models.blobnet import BlobNetConfig
    from cova_tpu.models.train_blobnet import train_blobnet
    from cova_tpu.utils.dataset import ArrayDataset, build_training_set

    # Two-stage SIGINT like the reference (train-blobnet.py:21-42).
    stop = {"flag": False}

    def handler(signum, frame):
        if not stop["flag"]:
            print("stopping after current step; ^C again to abort")
            stop["flag"] = True
        else:
            sys.exit(1)

    signal.signal(signal.SIGINT, handler)

    cache = os.path.join(ckpt_dir, "dataset.npz")
    if os.path.exists(cache):
        d = np.load(cache)
        x, y = d["x"], d["y"]
        print(f"loaded cached dataset x {x.shape}")
    else:
        x, y = build_training_set(
            video, out_path=cache, max_frames=max_frames,
            use_nnz=use_nnz, signed_mv=signed_mv,
        )

    if augment:
        from cova_tpu.utils.dataset import augment_training_set

        x, y = augment_training_set(x, y, signed_mv=signed_mv)
        print(f"augmented dataset x {x.shape} (hflip x vflip)")

    ds = ArrayDataset(x, y, batch=4)
    model, variables = train_blobnet(
        ds,
        epochs=epochs,
        config=BlobNetConfig(in_channels=4 if use_nnz else 3),
        should_stop=lambda: stop["flag"],
        log_every=100,
        signed_mv=signed_mv,
    )

    from cova_tpu.models.blobnet import save_params_npz

    npz_path = os.path.join(ckpt_dir, "weights.npz")
    save_params_npz(
        npz_path,
        variables,
        meta={
            "in_channels": 4 if use_nnz else 3,
            "signed_mv": signed_mv,
            "use_nnz_channel": use_nnz,
        },
    )
    print(f"npz weights saved to {npz_path}")


if __name__ == "__main__":
    main()
