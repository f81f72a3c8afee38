#!/usr/bin/env python3
"""The reference's headline figure, committed: end-to-end elapsed time of
the naive full-decode baseline vs the CoVA pipeline on the same input
(reference paper Fig. 8; the reference measures both as the "Elapsed
seconds" line each pipeline prints — pipeline/cova/pipeline.py:408-411,
pipeline/naive/pipeline.py, README.md:290 — but commits no artifact).

Both sides run the SAME oracle detector (the deterministic stand-in,
cova_tpu/models/bgdet.py) on the same machine: naive decodes and infers
every frame; CoVA entropy-decodes every frame on the host, runs
BlobNet on the accelerator, and fully decodes + infers only the frames its
selector schedules. The speedup is therefore the measured value of the
compressed-domain premise at system level, not a stage microbenchmark.

Per bench.py's convention both wall and process-CPU elapsed are
recorded, plus the fixed-work cpu_calib_mips probe.

Usage: python examples/fig8.py [--out FIG8.json] [--inputs demo,1080p,...]
Writes one JSON artifact with a row per input:
  {naive_s, naive_cpu_s, cova_s, cova_cpu_s, speedup, speedup_cpu,
   decode_filter_rate, inference_filter_rate, ...}
"""

import dataclasses
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = pathlib.Path(__file__).resolve().parent.parent

from examples.bench_decode_baseline import cpu_probe  # noqa: E402


def resolve_input(token):
    """Map an input token to (label, path). Tokens: demo, 1080p, demo2,
    or any mp4 path."""
    if token == "demo":
        return "demo", "/root/reference/demo/1m.mp4"
    if token == "1080p":
        from examples.make_dataset2 import build_1080p

        return "1080p", build_1080p()
    if token == "demo2":
        from examples.make_dataset2 import build as build_ds2

        path = "/tmp/cova_ds2/demo2.mp4"
        if not os.path.exists(path):
            build_ds2(path)
        return "demo2", path
    return pathlib.Path(token).stem, token


def run_input(label, video, work_root):
    import numpy as np

    from cova_tpu.codec import Mp4Demuxer
    from cova_tpu.config import (
        CompressedStageConfig,
        CovaConfig,
        ParallelConfig,
    )
    from cova_tpu.models.bgdet import (
        StaticBackgroundDetector,
        build_background,
        load_background,
        save_background,
    )
    from cova_tpu.models.blobnet import load_artifact
    from cova_tpu.pipeline.cova import CovaPipeline
    from cova_tpu.pipeline.naive import NaivePipeline

    out = pathlib.Path(work_root) / label
    out.mkdir(parents=True, exist_ok=True)
    demux = Mp4Demuxer(video)
    w, h, n = demux.width, demux.height, demux.num_samples
    demux.close()

    # Background model: the committed 720p artifact for the demo clip,
    # built + cached next to the outputs otherwise. Detector area knobs
    # scale with pixel count so the stand-in oracle means the same thing
    # at every resolution (they are tuned at 1280x720).
    bg_path = (
        REPO / "artifacts" / "demo_bg.npy"
        if (w, h) == (1280, 720)
        else out / "background.npy"
    )
    if bg_path.exists():
        bg = load_background(bg_path)
    else:
        bg = build_background(video)
        save_background(bg_path, bg)
    s = (w * h) / float(1280 * 720)
    det = StaticBackgroundDetector(
        bg,
        min_area=int(round(60 * s)),
        car_area=int(round(700 * s)),
    )

    def detector(frames):
        recs = []
        for ts, y, u, v in frames:
            recs.extend(det.detect_frame(ts, y))
        return recs

    calib0 = cpu_probe()

    print(f"== {label}: naive (full decode + infer every frame) ==",
          flush=True)
    c0, t0 = time.process_time(), time.perf_counter()
    nres = NaivePipeline(video, str(out / "naive"), detector).run()
    naive_s = time.perf_counter() - t0
    naive_cpu = time.process_time() - c0

    print(f"== {label}: cova ==", flush=True)
    # Resolution-matched committed configuration: the 1080p golden's
    # weights + operating point on the 120x68 grid (ACCURACY.md
    # "1080p"), the demo golden's at 720p — so each row measures the
    # SAME configuration its accuracy golden pins.
    w1080 = REPO / "artifacts" / "blobnet_demo1080.npz"
    if h > 720 and w1080.exists():
        weights, ckw = w1080, dict(cc_threshold=7, mask_threshold=0.6)
    else:
        weights, ckw = REPO / "artifacts" / "blobnet_demo.npz", dict(
            cc_threshold=3
        )
    _, variables, wmeta = load_artifact(weights)
    cfg = CovaConfig(
        parallel=ParallelConfig(num_ranges=4),
        compressed=CompressedStageConfig(
            **ckw,
            use_nnz_channel=bool(wmeta.get("use_nnz_channel", False)),
            signed_mv=bool(wmeta.get("signed_mv", False)),
        ),
    )
    pipe = CovaPipeline(
        video, str(out / "cova"), cfg, variables=variables, detector=detector
    )
    # Warm the jitted device program outside the timed window: the
    # reference's elapsed likewise excludes TensorRT engine builds
    # (engines are prebuilt and cached — README.md:173-179).
    pipe.warmup()
    c0, t0 = time.process_time(), time.perf_counter()
    cres = pipe.run()
    cova_s = time.perf_counter() - t0
    cova_cpu = time.process_time() - c0
    calib1 = cpu_probe()

    row = {
        "input": label,
        "path": video,
        "width": w,
        "height": h,
        "frames": n,
        "naive_s": round(naive_s, 2),
        "naive_cpu_s": round(naive_cpu, 2),
        "cova_s": round(cova_s, 2),
        "cova_cpu_s": round(cova_cpu, 2),
        "speedup": round(naive_s / cova_s, 2),
        "speedup_cpu": round(naive_cpu / cova_cpu, 2),
        "decode_filter_rate": round(cres.decode_filter_rate, 4),
        "inference_filter_rate": round(cres.inference_filter_rate, 4),
        "naive_detections": nres.num_detections,
        "weights": weights.name,
        "cc_threshold": cfg.compressed.cc_threshold,
        "cpu_calib_mips": [round(calib0, 2), round(calib1, 2)],
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    out_path = REPO / "FIG8.json"
    tokens = ["demo", "1080p"]
    argv = sys.argv[1:]
    if "--out" in argv:
        out_path = pathlib.Path(argv[argv.index("--out") + 1])
    if "--inputs" in argv:
        tokens = argv[argv.index("--inputs") + 1].split(",")

    rows = [
        run_input(*resolve_input(tok), work_root="/tmp/cova_fig8")
        for tok in tokens
    ]
    artifact = {
        "metric": "fig8_elapsed_speedup",
        "description": (
            "end-to-end elapsed: naive full-decode+infer vs CoVA, same "
            "input, same stand-in oracle detector, one accelerator "
            "(reference paper Fig. 8 analog)"
        ),
        "value_basis": "wall (speedup) + process-cpu (speedup_cpu)",
        "rows": rows,
    }
    out_path.write_text(json.dumps(artifact, indent=1))
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
