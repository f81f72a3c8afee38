#!/usr/bin/env python3
"""Smoke test of the CoVA pipeline on NVIDIA GPUs, as one process.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --devices 4   # four GPUs: the sharded pipeline only

Phases on one GPU, each fatal on failure:
  1. build     make -C cova_tpu/csrc clean all, from the committed sources
  2. input     the committed synth clip (artifacts/synth.mp4) matches the
               hash recorded in golden/synth/inputs.json
  3. pixels    the selective pixel decoder decodes GoP 0 of the clip to the
               luma recorded in golden/synth/inputs.json
  4. numerics  BlobNet on one full chunk (R=8, F=128, 45x80, synth
               metadata) on the GPU against the same program on the CPU
               device of this process: max |dprob| <= 1e-4 at "highest";
               the share of mask cells that flip at the pipeline's
               threshold, at each convolution precision; the XLA
               mask_to_boxes on the GPU against host cc_boxes (identical)
  5. pipeline  CovaPipeline end to end over all 1800 frames after
               warmup(), scored against golden/synth: BP >= 0.98,
               GC <= 1.7, decode filter >= 0.65, inference filter >= 0.98

With --devices 4 it runs only the synth pipeline sharded over four GPUs
(ParallelConfig.num_devices=4) and the same run on one GPU, and
compares their CSVs.

Exits non-zero, printing no result, when JAX finds no GPU. The last
line of stdout is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN = REPO / "golden" / "synth"
BANDS = {"bp_accuracy": 0.98, "gc_error": 1.7,
         "decode_filter_rate": 0.65, "inference_filter_rate": 0.98}
HIGHEST_TOL = 1e-4  # f32 on both sides, different summation order
CSV_NAMES = ("track.csv", "dnn.csv", "assoc.csv", "stationary.csv")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_build():
    csrc = REPO / "cova_tpu" / "csrc"
    subprocess.run(["make", "-s", "-C", str(csrc), "clean"], check=True)
    subprocess.run(["make", "-s", "-j8", "-C", str(csrc), "all"], check=True)
    from cova_tpu.codec import _KEY_PATH, host_build_key

    _KEY_PATH.write_text(host_build_key())


def inputs_record() -> dict:
    return json.loads((GOLDEN / "inputs.json").read_text())


def phase_input(clip: pathlib.Path, record: dict):
    digest = hashlib.sha256(clip.read_bytes()).hexdigest()
    check(digest == record["clip_sha256"],
          f"{clip} sha256 {digest} != recorded {record['clip_sha256']}")


def gop_luma_sha256(clip, gop=0) -> str:
    """sha256 over the Y planes of one GoP decoded by PixelDecoder, in
    display order."""
    from cova_tpu.codec import Mp4Demuxer, PixelDecoder

    d = Mp4Demuxer(str(clip))
    g = d.gop(gop)
    dec = PixelDecoder(d.extradata())
    h = hashlib.sha256()

    def drain():
        while (f := dec.pop(d.width, d.height)) is not None:
            h.update(f[1].tobytes())

    for i in range(g.first_sample, g.first_sample + g.num_samples):
        dec.send(d.read_sample(i), d.sample(i).pts)
        drain()
    dec.flush()
    drain()
    return h.hexdigest()


def phase_pixels(clip, record):
    from cova_tpu.codec import find_libavcodec

    got = gop_luma_sha256(clip)
    check(got == record["gop0_luma_sha256"],
          f"GoP 0 luma sha256 {got} != recorded {record['gop0_luma_sha256']}")
    return find_libavcodec()


def synth_chunk(clip, num_ranges=8, frames=128):
    """(R, F+T-1, H, W, 2) wire-format metadata: the first F+T-1 display
    frames of R GoP-aligned ranges of the clip, plus the config the
    committed synth weights expect."""
    import math

    import numpy as np

    from cova_tpu.codec import Mp4Demuxer
    from cova_tpu.config import CompressedStageConfig, CovaConfig
    from cova_tpu.models.blobnet import load_artifact
    from examples.reproduce_synth import CC, MASK
    from examples.run_cova import SYNTH_WEIGHTS

    model, variables, wmeta = load_artifact(SYNTH_WEIGHTS)
    cfg = CovaConfig(compressed=CompressedStageConfig(
        cc_threshold=CC, mask_threshold=MASK, batch_frames=frames,
        use_nnz_channel=bool(wmeta.get("use_nnz_channel", False)),
        signed_mv=bool(wmeta.get("signed_mv", False)),
    ))
    t = cfg.video.timestep
    d = Mp4Demuxer(str(clip))
    gops = d.gops()
    per = max(1, math.ceil(len(gops) / num_ranges))
    starts = [gops[i].first_sample for i in range(0, len(gops), per)]
    starts = (starts * num_ranges)[:num_ranges]
    chunk = np.zeros((num_ranges, frames + t - 1, d.mb_height, d.mb_width, 2),
                     np.uint8)
    chunk[..., 1] = 0x88
    for ri, s0 in enumerate(starts):
        n = min(frames + t - 1, d.num_samples - s0)
        d.entropy_decode_packed16(
            d.display_order(s0, n), with_nnz=cfg.compressed.use_nnz_channel,
            signed_mv=cfg.compressed.signed_mv, out=chunk[ri, :n],
        )
    return model, variables, cfg, chunk


def blobnet_probs_on(device, model, variables, cfg, chunk, precision):
    """(R*F, H, W) probabilities of the device program's BlobNet prefix,
    compiled for `device`, and the seconds one warm call takes."""
    import jax
    import numpy as np

    from cova_tpu.pipeline.compressed import compressed_probs_step

    v = jax.device_put(variables, device)
    x = jax.device_put(chunk, device)
    out = compressed_probs_step(model, v, cfg, x, precision)
    out.block_until_ready()
    t0 = time.perf_counter()
    compressed_probs_step(model, v, cfg, x, precision).block_until_ready()
    dt = time.perf_counter() - t0
    r, ft, h, w = chunk.shape[:4]
    return np.asarray(out).reshape(-1, h, w), dt


def phase_numerics(device, ref_device, model, variables, cfg, chunk, log):
    """GPU against CPU on one chunk; returns a dict of what it measured."""
    import jax
    import numpy as np

    from cova_tpu.ops.cc import connected_components, mask_to_boxes
    from cova_tpu.pipeline.compressed import CONV_PRECISION
    from cova_tpu.tracker.host import cc_boxes

    thr = cfg.compressed.mask_threshold
    ref, ref_s = blobnet_probs_on(ref_device, model, variables, cfg, chunk,
                                  "highest")
    out = {"ref_seconds": ref_s}
    for precision in ("highest", "default"):  # f32; TF32 on the GPU
        got, secs = blobnet_probs_on(device, model, variables, cfg, chunk,
                                     precision)
        delta = float(np.abs(got - ref).max())
        flips = float(np.mean((got > thr) != (ref > thr)))
        out[precision] = {"max_abs_dprob": delta, "mask_flip_share": flips,
                          "blobnet_seconds": secs}
        used = " (the pipeline's)" if precision == CONV_PRECISION else ""
        log(f"numerics: precision={precision}{used} max|dprob|={delta!r} "
            f"mask flip share at {thr}={flips!r} chunk seconds={secs!r}")
    check(out["highest"]["max_abs_dprob"] <= HIGHEST_TOL,
          f"BlobNet GPU vs CPU at highest: max|dprob| "
          f"{out['highest']['max_abs_dprob']} > {HIGHEST_TOL}")

    masks = ref > thr
    cct, k = cfg.compressed.cc_threshold, 16
    boxes_fn = jax.jit(mask_to_boxes, static_argnums=(1, 2))
    dmasks = jax.device_put(masks, device)
    dev = boxes_fn(dmasks, cct, k)
    host_ltwh, _, host_valid = cc_boxes(masks, cct, k)
    dev_valid = np.asarray(dev.valid)
    check(np.array_equal(dev_valid, host_valid),
          "mask_to_boxes valid slots differ from host cc_boxes")
    check(np.array_equal(np.asarray(dev.ltwh)[dev_valid], host_ltwh[host_valid]),
          "mask_to_boxes boxes differ from host cc_boxes")
    label_fn = jax.jit(jax.vmap(connected_components))
    label_fn(dmasks).block_until_ready()
    t0 = time.perf_counter()
    label_fn(dmasks).block_until_ready()
    out["xla_cc_label_seconds"] = time.perf_counter() - t0
    out["boxes"] = int(host_valid.sum())
    log(f"numerics: mask_to_boxes == cc_boxes on {masks.shape} masks "
        f"({out['boxes']} boxes); XLA labelling seconds="
        f"{out['xla_cc_label_seconds']!r}")
    return out


def run_synth(out_dir, num_devices=1, max_frames=None, batch_frames=128,
              log=print):
    """The synth pipeline end to end; returns (result, query, compile_s)."""
    from examples.run_cova import score_synth, synth_pipeline

    pipe = synth_pipeline(out_dir, num_devices=num_devices,
                          batch_frames=batch_frames, log=log)
    t0 = time.perf_counter()
    pipe.warmup()
    compile_s = time.perf_counter() - t0
    result = pipe.run(max_frames=max_frames)
    return result, score_synth(out_dir), compile_s


def check_bands(result, query):
    values = {
        "bp_accuracy": query.bp_accuracy,
        "gc_error": query.gc_error,
        "decode_filter_rate": result.decode_filter_rate,
        "inference_filter_rate": result.inference_filter_rate,
    }
    for key, bound in BANDS.items():
        ok = values[key] <= bound if key == "gc_error" else values[key] >= bound
        check(ok, f"{key} {values[key]} outside its band ({bound})")
    return values


def compare_csvs(a, b):
    """Names of the CSVs that differ between two output directories."""
    return [n for n in CSV_NAMES
            if (pathlib.Path(a) / n).read_bytes()
            != (pathlib.Path(b) / n).read_bytes()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    ap.add_argument("--out", default=str(REPO / "build_out" / "smoke"))
    args = ap.parse_args(argv)

    import jax

    from cova_tpu.device import NoAcceleratorError, card_line, require_gpu

    try:
        gpu = require_gpu()
    except NoAcceleratorError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    devices = jax.devices()
    check(len(devices) >= args.devices,
          f"--devices {args.devices} but JAX sees {len(devices)}")
    card = card_line()
    log = lambda msg: print(msg, flush=True)  # noqa: E731
    log(f"device: {gpu.device_kind} x{len(devices)} ({gpu.platform}); "
        f"card: {card}")

    if args.devices == 1:
        t0 = time.perf_counter()
        phase_build()  # before any native library is loaded
        log(f"phase build: ok ({time.perf_counter() - t0:.1f} s)")

    from cova_tpu.codec import find_libavcodec, pixel_lib

    try:
        pixel_lib()
    except (RuntimeError, OSError) as e:
        log(f"stages: cannot run pixels, pipeline (its pixel stage): {e}")
        raise
    log(f"stages: all runnable; pixel decode via {find_libavcodec()}")

    out = pathlib.Path(args.out)
    if args.devices == 4:
        runs = {}
        for n in (4, 1):
            res, q, c = run_synth(out / f"dev{n}", num_devices=n, log=log)
            log(f"{n} device(s) on {card}: BP {q.bp_accuracy!r} "
                f"GC {q.gc_error!r} decode filter {res.decode_filter_rate!r} "
                f"inference filter {res.inference_filter_rate!r} "
                f"wall {res.elapsed_seconds!r} s compile {c!r} s")
            runs[n] = (res, q)
        for res, q in runs.values():
            check_bands(res, q)
        diff = compare_csvs(out / "dev4", out / "dev1")
        log(f"CSVs differing between 4 and 1 devices: {diff or 'none'}")
        check(not diff, f"4-device CSVs differ from 1-device: {diff}")
        count = 4
    else:
        record = inputs_record()
        clip = REPO / record["clip"]
        phase_input(clip, record)
        log(f"phase input: ok ({clip.name}, {record['made_by']})")
        used = phase_pixels(clip, record)
        log(f"phase pixels: ok (GoP 0 luma matches; libavcodec {used})")
        model, variables, cfg, chunk = synth_chunk(clip)
        num = phase_numerics(gpu, jax.devices("cpu")[0], model, variables,
                             cfg, chunk, log)
        log(f"phase numerics: ok {json.dumps(num)}")
        res, q, compile_s = run_synth(out / "dev1", log=log)
        tm = res.timers
        peak = gpu.memory_stats().get("peak_bytes_in_use")
        log(f"phase pipeline on {card}: frames {res.num_frames} "
            f"BP {q.bp_accuracy!r} GC {q.gc_error!r} "
            f"BPL {q.bp_accuracy_local!r} GCL {q.gc_error_local!r} "
            f"decode filter {res.decode_filter_rate!r} "
            f"inference filter {res.inference_filter_rate!r} "
            f"dead tracks {res.dead_tracks}")
        log(f"phase pipeline timing on {card}: compile {compile_s!r} s, "
            f"wall {res.elapsed_seconds!r} s, stages entropy_decode "
            f"{tm.entropy_decode!r} device_dispatch {tm.device_dispatch!r} "
            f"host_mirror {tm.host_mirror!r} pixel_stage {tm.pixel_stage!r}, "
            f"peak_bytes_in_use {peak}")
        check_bands(res, q)
        log("phase pipeline: ok (within the golden/synth bands)")
        count = 1
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
