#!/usr/bin/env python3
"""Per-op cost profile of the ALL-DEVICE compressed-stage program.

The production pipeline runs host_tracking=True (device = metapreprocess
+ BlobNet + threshold; CC + SORT native on host — the reference's own
split). The all-device variant (cfg.compressed.host_tracking=False,
compressed_stage_step) keeps CC + SORT inside the jit — it is the
fully-device-resident multi-chip program. This profiler breaks its cost
into cumulative probes, each a separate jitted program synchronized by
a host pull of its result:

  masks      unpack_wire16 + metapreprocess + BlobNet + threshold
  +labels    ... + connected-component labeling (XLA label propagation)
  +stats     ... + region stats / box extraction (mask_to_boxes)
  +sort      the full compressed_stage_step (adds the vmapped SORT scan)
  full+pull  production-shaped call incl. the packed outputs transfer
  pipelined  steady-state fps, two-deep pipelined (chunk i+1 dispatched
             before chunk i's outputs are pulled — how the pipeline
             actually drives the stage, so upload/pull overlap compute)

Deltas between consecutive rows are the per-op costs. Run on a real
chip (defaults) or on CPU for shape-checking. Usage:

  python examples/profile_device.py [--chunks N] [--reps N] [--input F]

Writes one JSON line per probe; VERDICT r3 next #4 is the consumer
(decide: optimize the all-device program or formally demote it).
"""

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--input", default=os.path.join(repo, "artifacts", "synth.mp4"))
    ap.add_argument("--weights",
                    default=os.path.join(repo, "artifacts", "blobnet_synth.npz"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from cova_tpu.codec import Mp4Demuxer
    from cova_tpu.config import CovaConfig
    from cova_tpu.models.blobnet import load_artifact
    from cova_tpu.ops.cc import mask_to_boxes
    from cova_tpu.ops.preprocess import metapreprocess, unpack_wire16
    from cova_tpu.pipeline.compressed import (
        CompressedStage,
        compressed_stage_step,
    )

    model, variables, wmeta = load_artifact(args.weights)
    cfg = CovaConfig()
    cfg = dataclasses.replace(
        cfg,
        compressed=dataclasses.replace(
            cfg.compressed,
            cc_threshold=3,
            host_tracking=False,
            use_nnz_channel=bool(wmeta.get("use_nnz_channel", False)),
            signed_mv=bool(wmeta.get("signed_mv", False)),
        ),
    )
    r = cfg.parallel.num_ranges
    f = cfg.compressed.batch_frames
    t = cfg.video.timestep

    demux = Mp4Demuxer(args.input)
    mh, mw = demux.mb_height, demux.mb_width
    gops = demux.gops()
    import math

    per_gop = max(1, math.ceil(len(gops) / r))
    bounds = []
    for i in range(0, len(gops), per_gop):
        g = gops[i : i + per_gop]
        bounds.append((g[0].first_sample, sum(x.num_samples for x in g)))
    bounds = bounds[:r]
    chunk = np.zeros((r, f + t - 1, mh, mw, 2), np.uint8)
    if cfg.compressed.signed_mv:
        chunk[..., 1] = 0x88
    for ri, (s0, cnt) in enumerate(bounds):
        count = min(f + t - 1, cnt)
        disp = demux.display_order(s0, count)
        demux.entropy_decode_packed16(
            disp,
            with_nnz=cfg.compressed.use_nnz_channel,
            signed_mv=cfg.compressed.signed_mv,
            threads=min(os.cpu_count() or 8, 16),
            out=chunk[ri, :count],
        )

    signed = cfg.compressed.signed_mv
    nnz = cfg.compressed.use_nnz_channel
    thr = cfg.compressed.mask_threshold
    cct = cfg.compressed.cc_threshold

    def front(metadata):
        m = unpack_wire16(metadata, nnz, signed)
        x = jax.vmap(lambda a: metapreprocess(a, t, 1, signed))(m)
        x = x.reshape(r * f, t, mh, mw, x.shape[-1])
        probs = model.apply(variables, x, train=False)
        return probs > thr

    @jax.jit
    def p_masks(metadata):
        return jnp.sum(front(metadata).astype(jnp.int32))

    @jax.jit
    def p_labels(metadata):
        from cova_tpu.ops.cc import connected_components

        labs = jax.vmap(lambda m: connected_components(m))(front(metadata))
        return jnp.sum(labs)

    @jax.jit
    def p_stats(metadata):
        masks = front(metadata)
        boxes = mask_to_boxes(masks, cct)
        return jnp.sum(boxes.area) + jnp.sum(boxes.valid)

    stage = CompressedStage(model, variables, cfg, r)

    @jax.jit
    def p_sort(metadata, state, ts0):
        out = compressed_stage_step(
            model, variables, cfg, metadata, state, ts0
        )
        return jnp.sum(out[1].astype(jnp.int32))

    ts0 = jnp.zeros((r,), jnp.int32)

    def bench(name, fn, *a):
        fn(*a)  # compile + warm
        np.asarray(fn(*a))
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            np.asarray(fn(*a))
            times.append(time.perf_counter() - t0)
        med = sorted(times)[len(times) // 2]
        print(json.dumps({"probe": name, "seconds": round(med, 4),
                          "all": [round(x, 4) for x in times]}),
              flush=True)
        return med

    jchunk = jnp.asarray(chunk)
    np.asarray(jchunk)  # upload fence
    res = {}
    res["masks"] = bench("masks", p_masks, jchunk)
    res["labels"] = bench("+labels", p_labels, jchunk)
    res["stats"] = bench("+stats", p_stats, jchunk)
    res["sort"] = bench("+sort", p_sort, jchunk, stage.sort_state, ts0)

    st = CompressedStage(model, variables, cfg, r)

    def full():
        # Production-shaped: the evolving SORT state is part of the
        # real workload; the packed outputs buffer is actually pulled.
        packed, masks, boxes = st.run_chunk(chunk, np.zeros(r, np.int32))
        return np.asarray(packed).sum()

    full()
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        full()
        times.append(time.perf_counter() - t0)
    res["full_pull"] = sorted(times)[len(times) // 2]
    print(json.dumps({"probe": "full+pull",
                      "seconds": round(res["full_pull"], 4),
                      "all": [round(x, 4) for x in times]}), flush=True)

    # Steady-state: two-deep pipelined like CovaPipeline/bench.py —
    # chunk i's packed pull rides chunk i+1's upload+compute, so the
    # per-chunk cost converges to max(compute, transfer), not their sum.
    import threading

    def pipelined(n=8):
        st2 = CompressedStage(model, variables, cfg, r)
        np.asarray(st2.run_chunk(chunk, np.zeros(r, np.int32))[0])  # warm
        start = time.perf_counter()
        pending = None
        for _ in range(n):
            packed, _, _ = st2.run_chunk(chunk, np.zeros(r, np.int32))
            box = []
            th = threading.Thread(
                target=lambda a=packed: box.append(np.asarray(a))
            )
            th.start()
            if pending is not None:
                pending.join()
            pending = th
        pending.join()
        return n * r * f / (time.perf_counter() - start)

    pipe_rates = sorted(pipelined() for _ in range(3))
    res["pipelined_fps"] = pipe_rates[1]
    print(json.dumps({"probe": "pipelined",
                      "fps": round(pipe_rates[1], 1),
                      "all": [round(x, 1) for x in pipe_rates]}),
          flush=True)

    print(json.dumps({
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "chunk": [r, f, mh, mw],
        "deltas": {
            "blobnet_masks": round(res["masks"], 4),
            "cc_labeling": round(res["labels"] - res["masks"], 4),
            "cc_stats": round(res["stats"] - res["labels"], 4),
            "sort_scan": round(res["sort"] - res["stats"], 4),
            "packed_transfer+rebuild": round(
                res["full_pull"] - res["sort"], 4),
        },
        "pipelined_fps": round(res["pipelined_fps"], 1),
    }))


if __name__ == "__main__":
    main()
