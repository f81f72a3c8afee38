#!/usr/bin/env python3
"""Cross-scene accuracy on the synthetic third scene (VERDICT r4 #3).

Every other committed dataset derives from the single 60-second
amsterdam demo clip; this one is a genuinely different SCENE —
examples/make_synth.py's procedural intersection, rendered and encoded
offline through the first-party libx264 path (committed as
artifacts/synth.mp4). The full
naive-GT -> CoVA -> BP/GC flow of examples/reproduce_accuracy.py runs
here with the synth-trained weights (artifacts/blobnet_synth.npz) at
the synth operating point, and the report additionally records the
ZERO-SHOT transfer row: the committed demo-trained weights on this
scene, same knobs — the quantified reason the reference trains BlobNet
per scene (config/blobnet/{amsterdam,archie,...}.txt) and never claims
cross-scene weight transfer.

Scene difficulty is deliberately HIGHER than demo: ~5.4 concurrent
target cars per slot at steady state (demo ~1.5), two-way traffic,
an intersection with crossing vehicles, a bus, pedestrians, and a
park-and-leave car. Absolute GC is correspondingly larger; the GT
instrument itself is validated against the generator's exact object
schedule (94-98% of frames match the expected car count exactly —
ACCURACY.md "Cross-scene").

Operating point: the offline knob sweep re-run on this dataset
(examples/sweep_accuracy.py --video <synth> --dataset synth
--gt <naive dnn.csv> --wide) exposes a three-way BP/GC/filter-rate
trade-off that the quieter demo scene never shows (high object
turnover means short tracker horizons count better but trigger far
more selective decode). Committed point = the pareto knee, max BP
with the filter premise intact: mask 0.6 / cc 2 / min_hits 40 /
max_age 45 -> BP 0.9878 / GC 1.5829 / decode filter 0.69. The two
endpoints are recorded in ACCURACY.md "Cross-scene": the counting
point (mask 0.3/cc 1/mh 10/ma 30: GC 0.8979 but filter 0.27) and the
filtering point (mask 0.6/cc 2/mh 40/ma 60: filter 0.85 but
BP 0.9157). The reference likewise retunes segmentation + tracker
knobs per dataset (config/blobnet/*.txt).

Usage:
  python examples/reproduce_synth.py [OUT_DIR] [--golden] [--no-zeroshot]
Writes OUT_DIR/{naive/dnn.csv, cova/*.csv, report.json}; --golden
refreshes golden/synth/. The naive GT run is cached (delete
OUT_DIR/naive to regenerate).
"""

import json
import os
import pathlib
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = pathlib.Path(__file__).resolve().parent.parent
BG_PATH = REPO / "artifacts" / "synth_bg.npy"

# Committed synth operating point (see module docstring).
CC, MASK, MIN_HITS, MAX_AGE = 2, 0.6, 40, 45
BUS_AREA = 2500


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    golden = "--golden" in sys.argv
    zeroshot = "--no-zeroshot" not in sys.argv
    out_dir = pathlib.Path(args[0] if args else "/tmp/cova_accuracy_synth")
    out_dir.mkdir(parents=True, exist_ok=True)

    # The committed clip is make_synth.build_synth()'s output
    # (golden/synth/inputs.json), so no encoder is needed here.
    video = str(REPO / "artifacts" / "synth.mp4")

    from cova_tpu.codec import Mp4Demuxer
    from cova_tpu.config import (
        CompressedStageConfig,
        CovaConfig,
        ParallelConfig,
        SortConfig,
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
    from cova_tpu.query.datasets import DATASETS
    from cova_tpu.query.metrics import load_boxes_csv, load_cova, parse_query

    if BG_PATH.exists():
        bg = load_background(BG_PATH)
        print(f"loaded background model {BG_PATH}")
    else:
        bg = build_background(video)
        save_background(BG_PATH, bg)
        print(f"built + saved background model {BG_PATH}")
    detector_obj = StaticBackgroundDetector(bg, bus_area=BUS_AREA)

    def detector(frames):
        recs = []
        for ts, y, u, v in frames:
            recs.extend(detector_obj.detect_frame(ts, y))
        return recs

    demux = Mp4Demuxer(video)
    duration = (demux.sample(demux.num_samples - 1).pts / demux.timescale) + (
        1.0 / 30.0
    )
    demux.close()

    gt_csv = out_dir / "naive" / "dnn.csv"
    if gt_csv.exists():
        print(f"naive GT cached at {gt_csv}")
    else:
        print("== naive baseline (full decode, every frame) ==")
        t0 = time.perf_counter()
        nres = NaivePipeline(video, str(out_dir / "naive"), detector).run()
        print(
            f"naive: {nres.num_frames} frames, {nres.num_detections} "
            f"detections, {time.perf_counter() - t0:.1f}s"
        )

    ds = DATASETS["synth"]
    gt = load_boxes_csv(gt_csv)

    def cova_pass(weights, tag):
        _, variables, wmeta = load_artifact(weights)
        cfg = CovaConfig(
            parallel=ParallelConfig(num_ranges=4),
            sort=SortConfig(min_hits=MIN_HITS, max_age=MAX_AGE),
            compressed=CompressedStageConfig(
                cc_threshold=CC,
                mask_threshold=MASK,
                use_nnz_channel=bool(wmeta.get("use_nnz_channel", False)),
                signed_mv=bool(wmeta.get("signed_mv", False)),
            ),
        )
        cdir = out_dir / tag
        pipe = CovaPipeline(
            video, str(cdir), cfg, variables=variables, detector=detector
        )
        cres = pipe.run()
        res = parse_query(
            gt, load_cova(cdir), duration, list(ds.targets),
            exclude=ds.exclude, region=ds.region, frame_size=ds.frame_size,
        )
        print(
            f"{tag}: BP {res.bp_accuracy:.4f}  GC {res.gc_error:.4f}  "
            f"BPL {res.bp_accuracy_local:.4f}  GCL {res.gc_error_local:.4f}  "
            f"filters {cres.decode_filter_rate:.3f}/"
            f"{cres.inference_filter_rate:.3f}"
        )
        return cres, res

    synth_w = str(REPO / "artifacts" / "blobnet_synth.npz")
    print(f"== cova (in-domain weights {os.path.basename(synth_w)}) ==")
    cres, res = cova_pass(synth_w, "cova")

    report = {
        "input": video,
        "scene": "procedural intersection (make_synth.py)",
        "duration_seconds": duration,
        "weights": os.path.basename(synth_w),
        "cc_threshold": CC,
        "mask_threshold": MASK,
        "min_hits": MIN_HITS,
        "max_age": MAX_AGE,
        "bus_area": BUS_AREA,
        "bp_accuracy": round(res.bp_accuracy, 4),
        "gc_error": round(res.gc_error, 4),
        "bp_accuracy_local": round(res.bp_accuracy_local, 4),
        "gc_error_local": round(res.gc_error_local, 4),
        "num_slots": res.num_slots,
        "decode_filter_rate": round(cres.decode_filter_rate, 4),
        "inference_filter_rate": round(cres.inference_filter_rate, 4),
        "frames": cres.num_frames,
        "dead_tracks": cres.dead_tracks,
    }

    if zeroshot:
        demo_w = str(REPO / "artifacts" / "blobnet_demo.npz")
        print(f"== cova (ZERO-SHOT demo weights {os.path.basename(demo_w)}) ==")
        _, zres = cova_pass(demo_w, "cova_zeroshot")
        report["zeroshot_demo_weights"] = {
            "bp_accuracy": round(zres.bp_accuracy, 4),
            "gc_error": round(zres.gc_error, 4),
            "bp_accuracy_local": round(zres.bp_accuracy_local, 4),
            "gc_error_local": round(zres.gc_error_local, 4),
        }

    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    if golden:
        import shutil

        gdir = REPO / "golden" / "synth"
        gdir.mkdir(parents=True, exist_ok=True)
        shutil.copy(gt_csv, gdir / "dnn_gt.csv")
        shutil.copy(out_dir / "cova" / "assoc.csv", gdir / "assoc.csv")
        shutil.copy(
            out_dir / "cova" / "stationary.csv", gdir / "stationary.csv"
        )
        shutil.copy(out_dir / "report.json", gdir / "report.json")
        print(f"golden CSVs refreshed under {gdir}")
    print("== report (cross-scene accuracy, synth) ==")
    for k in ("bp_accuracy", "gc_error", "bp_accuracy_local",
              "gc_error_local", "decode_filter_rate",
              "inference_filter_rate"):
        print(f"{k}: {report[k]:.4f}")
    print(f"report written to {out_dir / 'report.json'}")


if __name__ == "__main__":
    main()
