#!/usr/bin/env python3
"""Run the end-to-end CoVA pipeline on a video.

Equivalent of the reference's `python launch.py INPUT OUTPUT DATASET`
(reference: experiment/cova/launch.py).

With no arguments it runs the repo's full-size configuration: the
committed synthetic scene (artifacts/synth.mp4, 1280x720, 1800 frames,
examples/make_synth.py seed 11), the synth-trained BlobNet
(artifacts/blobnet_synth.npz), the committed synth operating point
(examples/reproduce_synth.py) and the host stand-in oracle
(models/bgdet.py with artifacts/synth_bg.npy); it then scores BP/GC
against golden/synth.

With INPUT it runs that file with the weights in $COVA_BLOBNET_CKPT
(an .npz artifact; default artifacts/blobnet_synth.npz) and the oracle
in $COVA_YOLO_WEIGHTS (the Flax YOLOv4, which needs flax installed), or
no oracle — then the run exercises plumbing and filter rates, not
accuracy.

Usage: python examples/run_cova.py [INPUT.mp4 OUTPUT_DIR [max_frames_per_range]]
"""

import dataclasses
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SYNTH_CLIP = REPO / "artifacts" / "synth.mp4"
SYNTH_WEIGHTS = REPO / "artifacts" / "blobnet_synth.npz"
SYNTH_BG = REPO / "artifacts" / "synth_bg.npy"
SYNTH_GOLDEN = REPO / "golden" / "synth"


def synth_pipeline(out_dir, num_devices=1, batch_frames=128, log=print):
    """CovaPipeline over the committed synth clip at the committed synth
    operating point (4 GoP ranges, CC 2, mask 0.6, min_hits 40,
    max_age 45, bus_area 2500) with the bgdet oracle."""
    from cova_tpu.config import (
        CompressedStageConfig,
        CovaConfig,
        ParallelConfig,
        SortConfig,
    )
    from cova_tpu.models.bgdet import StaticBackgroundDetector, load_background
    from cova_tpu.models.blobnet import load_artifact
    from cova_tpu.pipeline.cova import CovaPipeline
    from examples.reproduce_synth import BUS_AREA, CC, MASK, MAX_AGE, MIN_HITS

    _, variables, wmeta = load_artifact(SYNTH_WEIGHTS)
    compressed = CompressedStageConfig(
        cc_threshold=CC,
        mask_threshold=MASK,
        use_nnz_channel=bool(wmeta.get("use_nnz_channel", False)),
        signed_mv=bool(wmeta.get("signed_mv", False)),
        batch_frames=batch_frames,
    )
    cfg = CovaConfig(
        parallel=ParallelConfig(num_ranges=4, num_devices=num_devices),
        sort=SortConfig(min_hits=MIN_HITS, max_age=MAX_AGE),
        compressed=compressed,
    )
    detector = StaticBackgroundDetector(
        load_background(SYNTH_BG), bus_area=BUS_AREA
    )
    return CovaPipeline(
        str(SYNTH_CLIP), str(out_dir), cfg, variables=variables,
        detector=detector, log=log,
    )


def score_synth(out_dir):
    """BP/GC of a synth run's CSVs against golden/synth's naive ground
    truth (the full-decode oracle run over every frame)."""
    from cova_tpu.query.datasets import DATASETS
    from cova_tpu.query.metrics import load_boxes_csv, load_cova, parse_query

    report = json.loads((SYNTH_GOLDEN / "report.json").read_text())
    ds = DATASETS["synth"]
    return parse_query(
        load_boxes_csv(SYNTH_GOLDEN / "dnn_gt.csv"),
        load_cova(out_dir),
        report["duration_seconds"],
        list(ds.targets),
        exclude=ds.exclude,
        region=ds.region,
        frame_size=ds.frame_size,
    )


def print_result(result, output_dir):
    total = result.num_frames
    print(f"Elapsed seconds: {result.elapsed_seconds:.2f}")
    print(f"Frames: {total} ({total / max(result.elapsed_seconds, 1e-9):.0f} fps)")
    print(
        f"Dropped: {result.dropped}, decoded (dependency): "
        f"{result.decoded_dependency}, decoded (inference): "
        f"{result.decoded_inference}"
    )
    print(f"Decode filter rate: {result.decode_filter_rate:.3f}")
    print(f"Inference filter rate: {result.inference_filter_rate:.3f}")
    print(f"Dead tracks reported: {result.dead_tracks}")
    tm = result.timers
    print(
        f"Stage seconds: entdec={tm.entropy_decode:.2f} "
        f"device={tm.device_dispatch:.2f} mirror={tm.host_mirror:.2f} "
        f"pixel={tm.pixel_stage:.2f}"
    )
    print(f"CSV outputs in {output_dir}: track, dnn, assoc, stationary")


def main():
    from cova_tpu.config import CovaConfig
    from cova_tpu.pipeline.cova import CovaPipeline

    if len(sys.argv) < 2:
        out = REPO / "build_out" / "run_cova_synth"
        pipe = synth_pipeline(out)
        t0 = time.perf_counter()
        pipe.warmup()
        print(f"warmup (compile) seconds: {time.perf_counter() - t0:.2f}")
        result = pipe.run()
        print_result(result, out)
        q = score_synth(out)
        print(f"BP {q.bp_accuracy:.4f}  GC {q.gc_error:.4f}  "
              f"BPL {q.bp_accuracy_local:.4f}  GCL {q.gc_error_local:.4f}")
        return

    input_path = sys.argv[1]
    output_dir = sys.argv[2] if len(sys.argv) > 2 else str(REPO / "build_out" / "cova_out")
    max_frames = int(sys.argv[3]) if len(sys.argv) > 3 else None

    from cova_tpu.models.blobnet import load_artifact

    ckpt = os.environ.get("COVA_BLOBNET_CKPT") or str(SYNTH_WEIGHTS)
    _, variables, wmeta = load_artifact(ckpt)
    print(f"loaded BlobNet weights from {ckpt} ({wmeta or '3ch'})")

    # Optional real oracle: COVA_YOLO_WEIGHTS=yolov4.weights (darknet);
    # COVA_YOLO_CFG=yolov4.cfg builds the topology from the cfg file the
    # weights were trained for (other darknet variants load too).
    detector = None
    yolo = os.environ.get("COVA_YOLO_WEIGHTS")
    if yolo:
        from cova_tpu.models.yolov4 import make_yolo_detector

        detector = make_yolo_detector(
            yolo, cfg_path=os.environ.get("COVA_YOLO_CFG")
        )
        print(f"using YOLOv4 oracle from {yolo}")

    cfg = CovaConfig()
    # Metadata channels follow the weight artifact's stored contract.
    cfg = dataclasses.replace(
        cfg,
        compressed=dataclasses.replace(
            cfg.compressed,
            use_nnz_channel=bool(wmeta.get("use_nnz_channel", False)),
            signed_mv=bool(wmeta.get("signed_mv", False)),
        ),
    )
    pipe = CovaPipeline(
        input_path, output_dir, cfg, variables=variables, detector=detector
    )
    result = pipe.run(max_frames=max_frames)
    print_result(result, output_dir)


if __name__ == "__main__":
    main()
