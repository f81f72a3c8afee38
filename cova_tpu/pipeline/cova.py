"""End-to-end CoVA pipeline orchestration.

The equivalent of the reference's CovaPipeline + launch script
(reference: pipeline/cova/pipeline.py, experiment/cova/launch.py): wires
the codec host layer, the jitted compressed-domain device stage, the
frame selector, the selective pixel decoder, the oracle detector, and
the in-process aggregator into one driver.

Data flow per chunk of F frames (SURVEY.md §3.2-3.3 re-architected;
default cfg.compressed.host_tracking=True):

  host   entropy decode (C++)          -> (R, F+T-1, H, W, 3) u8
  device metapreprocess+BlobNet+mask   -> flat u8 masks (R*F*H*W)
  host   native CC + SORT (cctrack.cc), FrameSelector schedules decodes
  host   selective pixel decode (libavcodec), droppable frames discarded
  device oracle detector on surviving frames (optional)
  host   Associator -> track/dnn/assoc/stationary CSVs

With host_tracking=False the device program also runs CC + SORT (the
sharded multi-chip variant) and the host mirrors its packed outputs.

The `last` config key stops the pipeline after a named stage for
debugging, like the reference's `last:` convention
(pipeline/cova/pipeline.py:36-405): one of "entdec", "mask", "boxes",
"track", "select", "full".
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Optional

import jax
import numpy as np

from cova_tpu.aggregator import Associator, BoxRec
from cova_tpu.codec import Mp4Demuxer, PixelDecoder
from cova_tpu.config import CovaConfig
from cova_tpu.models.blobnet import create_blobnet
from cova_tpu.pipeline.compressed import CompressedStage
from cova_tpu.scheduler import FrameSelector, HostTracker


@dataclasses.dataclass
class StageTimers:
    """Wall-clock seconds per pipeline stage (the structured upgrade of
    the reference's single out.txt elapsed figure — SURVEY.md §5.1).
    Stages overlap (device work is async), so the parts can exceed
    elapsed_seconds."""

    entropy_decode: float = 0.0
    device_dispatch: float = 0.0
    host_mirror: float = 0.0
    pixel_stage: float = 0.0


@dataclasses.dataclass
class CovaResult:
    num_frames: int
    elapsed_seconds: float
    dropped: int
    decoded_dependency: int
    decoded_inference: int
    dead_tracks: int
    # Frames actually produced by the selective pixel stage and handed
    # to the detector. On PAFF input this counts WOVEN frames (a field
    # pair is one decode unit), so it can be below decoded_inference.
    pixel_frames: int = 0
    timers: StageTimers = dataclasses.field(default_factory=StageTimers)

    @property
    def decode_filter_rate(self) -> float:
        t = max(self.num_frames, 1)
        return 1.0 - (self.decoded_dependency + self.decoded_inference) / t

    @property
    def inference_filter_rate(self) -> float:
        return 1.0 - self.decoded_inference / max(self.num_frames, 1)


@dataclasses.dataclass
class _Stream:
    """Per-input state for multi-stream ingest (BASELINE config 5: N
    concurrent files sharing one device program, each with independent
    tracker/selector/aggregator state — the deployment shape the
    reference scales to with 16 nvstreammux groups)."""

    demux: Mp4Demuxer
    aggregator: Associator
    detector: Optional[Callable]


class CovaPipeline:
    """End-to-end pipeline (R ranges batched on device).

    detector: optional callable (frames_yuv, timestamps) -> list[BoxRec]
    standing in for the YOLO oracle; None runs the pixel decoder without
    inference (useful until trained weights exist).

    Multi-stream ingest: `CovaPipeline.multi([(path, out_dir, detector),
    ...], cfg)` runs N files through ONE device program — each stream
    contributes cfg.parallel.num_ranges ranges to the device batch axis
    (R_total = N * num_ranges) and keeps fully independent host state
    (trackers, selectors, aggregator CSVs per stream), so per-stream
    outputs are identical to solo runs. All streams must share one MB
    grid (one compiled program per shape; mixed resolutions run as
    separate pipelines).
    """

    def __init__(
        self,
        input_path: Optional[str],
        output_dir: Optional[str],
        cfg: CovaConfig = CovaConfig(),
        variables=None,
        detector: Optional[Callable] = None,
        log=print,
        _streams=None,
    ):
        self.cfg = cfg
        self.log = log
        if _streams is None:
            _streams = [(input_path, output_dir, detector)]
        self.streams = [
            _Stream(
                demux=Mp4Demuxer(path),
                aggregator=Associator(out, cfg.aggregator),
                detector=det,
            )
            for path, out, det in _streams
        ]
        # Back-compat aliases (single-stream callers/tests).
        self.demux = self.streams[0].demux
        self.aggregator = self.streams[0].aggregator
        self.detector = self.streams[0].detector
        for s in self.streams[1:]:
            if (s.demux.mb_width, s.demux.mb_height) != (
                self.demux.mb_width,
                self.demux.mb_height,
            ):
                raise ValueError(
                    "multi-stream ingest requires one MB grid across "
                    "streams (one compiled device program per shape)"
                )

        from cova_tpu.models.blobnet import BlobNetConfig

        in_ch = 4 if cfg.compressed.use_nnz_channel else 3
        model, default_vars = create_blobnet(
            jax.random.PRNGKey(0), BlobNetConfig(in_channels=in_ch)
        )
        self.model = model
        self.variables = variables if variables is not None else default_vars

        r = cfg.parallel.num_ranges * len(self.streams)
        self.num_ranges = r
        mesh = None
        if cfg.parallel.num_devices > 1:
            from cova_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(cfg.parallel.num_devices, cfg.parallel.mesh_axis)
        self.stage = CompressedStage(model, self.variables, cfg, r, mesh=mesh)

        self.trackers = []
        self.selectors = []
        self._pixdec = None

    @classmethod
    def multi(
        cls,
        streams,
        cfg: CovaConfig = CovaConfig(),
        variables=None,
        log=print,
    ) -> "CovaPipeline":
        """streams: list of (input_path, output_dir, detector)."""
        return cls(None, None, cfg, variables, None, log, _streams=streams)

    def _range_bounds(self):
        """Split each stream's GoPs into num_ranges contiguous ranges
        (the reference deals GoP blocks round-robin across branches,
        gstgopsplit.cpp:501-661; we keep them contiguous so each range
        is one coherent timeline). Returns (stream_idx, start, count)
        triples, num_ranges per stream."""
        r = self.cfg.parallel.num_ranges
        bounds = []
        for sidx, s in enumerate(self.streams):
            gops = s.demux.gops()
            per = max(1, math.ceil(len(gops) / r))
            sb = []
            for i in range(0, len(gops), per):
                chunk = gops[i : i + per]
                first = chunk[0].first_sample
                count = sum(g.num_samples for g in chunk)
                sb.append((sidx, first, count))
            while len(sb) < r:
                sb.append((sidx, s.demux.num_samples, 0))
            bounds.extend(sb[:r])
        return bounds

    def warmup(self) -> None:
        """Compile + execute the jitted device program once on a zeroed
        chunk, so a subsequent timed run() measures steady-state work,
        not XLA compilation (the reference's elapsed likewise excludes
        TensorRT engine builds — engines are prebuilt and cached,
        reference README.md:173-179)."""
        cfg = self.cfg
        nf = cfg.compressed.batch_frames + cfg.video.timestep - 1
        chunk = np.zeros(
            (self.num_ranges, nf, self.demux.mb_height, self.demux.mb_width, 2),
            np.uint8,
        )
        if cfg.compressed.signed_mv:
            chunk[..., 1] = 0x88
        if cfg.compressed.host_tracking:
            np.asarray(self.stage.run_chunk_masks(chunk))
        else:
            ts0 = np.zeros(self.num_ranges, np.int32)
            nwin = np.zeros(self.num_ranges, np.int32)
            pulled, _, _ = self.stage.run_chunk(chunk, ts0, nwin)
            np.asarray(pulled)

    def run(self, max_frames: Optional[int] = None) -> CovaResult:
        # Structured tracing (SURVEY §5.1 — the reference only has
        # GST_DEBUG categories + wall-clock): COVA_PROFILE=<dir> wraps
        # the run in a JAX profiler trace viewable in TensorBoard /
        # Perfetto, capturing XLA device ops alongside the host stage
        # timers in CovaResult.timers.
        prof_dir = os.environ.get("COVA_PROFILE")
        if prof_dir:
            with jax.profiler.trace(prof_dir):
                return self._run(max_frames)
        return self._run(max_frames)

    def _run(self, max_frames: Optional[int] = None) -> CovaResult:
        cfg = self.cfg
        t = cfg.video.timestep
        f = cfg.compressed.batch_frames
        fps = cfg.video.fps
        demux = self.demux
        last = cfg.last or "full"

        bounds = self._range_bounds()
        if max_frames:
            bounds = [(sx, s, min(c, max_frames)) for sx, s, c in bounds]
        # Absolute display rank -> presentation seconds, PER STREAM. The
        # aggregator associates oracle detections with track boxes by
        # EXACT timestamp equality (assoc.rs:311-316), and detections
        # carry container pts (which start at a nonzero B-frame delay
        # offset — e.g. 2 frames on the demo clip), so every timestamp
        # that reaches the aggregator must come from the container
        # clock, not from rank/fps. The selector/tracker keep working in
        # the rank/fps domain internally.
        pts_sec_s = []
        for s in self.streams:
            d = s.demux
            all_pts = np.sort(
                np.array(
                    [d.sample(i).pts for i in range(d.num_samples)],
                    dtype=np.int64,
                )
            )
            ps = all_pts / float(d.timescale)
            if len(ps) == 0:
                ps = np.zeros(1)
            # Extrapolate past EOS for empty-range placeholders.
            ps = np.concatenate(
                [ps, ps[-1] + np.arange(1, len(bounds) + 2) / fps]
            )
            pts_sec_s.append(ps)
        range_starts = [
            float(pts_sec_s[sx][s]) for sx, s, _ in bounds
        ]
        for sidx, s in enumerate(self.streams):
            s.aggregator.set_ranges(
                [
                    rs
                    for rs, (sx, _, _) in zip(range_starts, bounds)
                    if sx == sidx
                ]
            )
        # Display-order sample indices per range (B-frame reordering):
        # the temporal stack must see frames in presentation order, while
        # the frame selector consumes frames in decode order with their
        # display-position pts (the reference's sink_enc receives the
        # encoded stream in decode order and tracks min/max pts per GoP).
        disp = [
            self.streams[sx].demux.display_order(s, c)
            if c
            else np.zeros(0, np.int32)
            for sx, s, c in bounds
        ]
        # display position (absolute frame rank) per sample index
        pos_of = []
        for ri, (sx_, s_, c_) in enumerate(bounds):
            m = {}
            for rel, si in enumerate(disp[ri]):
                m[int(si)] = s_ + rel
            pos_of.append(m)

        dead_count = [0]

        def on_dead_factory(range_start, sample_start, stream):
            # HostTracker operates in range-relative frame indices (the
            # device SORT's ts domain); convert to absolute seconds at
            # the aggregator boundary. `box` is filled with the tracker
            # right after construction (the callback is handed to the
            # tracker's ctor, so it cannot capture it directly).
            box = {}
            pts_sec = pts_sec_s[stream]
            agg = self.streams[stream].aggregator

            def cb(rec):
                dead_count[0] += 1
                ht = box["ht"]
                oldest = ht.oldest

                def sec(frame_idx):
                    return float(
                        pts_sec[min(sample_start + int(round(frame_idx)),
                                    len(pts_sec) - 1)]
                    )

                oldest_s = sec(oldest) if math.isfinite(oldest) else 1e18
                rec = dataclasses.replace(
                    rec,
                    start_ts=sec(rec.start_ts),
                    end_ts=sec(rec.end_ts),
                    history=[(sec(fi), box_) for fi, box_ in rec.history],
                )
                agg.submit_track(range_start, oldest_s, rec)

            return cb, box

        selectors = []
        trackers = []
        # Scheduled decodes, grouped by range so the pixel stage can run
        # one independent decoder per range (GoP-prefix order holds
        # within a range).
        pix_jobs: list[list] = [[] for _ in bounds]

        def emit_factory(selector_idx):
            def emit(frames):
                pix_jobs[selector_idx].extend(frames)

            return emit

        host_tracking = cfg.compressed.host_tracking
        for ri, (sx, start, count) in enumerate(bounds):
            rs = range_starts[ri]
            cb, cb_box = on_dead_factory(rs, start, sx)
            if host_tracking:
                from cova_tpu.tracker.host import HostSort

                ht = HostSort(cfg.sort, on_dead=cb)
            else:
                ht = HostTracker(on_dead=cb)
            cb_box["ht"] = ht
            trackers.append(ht)

            def mk_seen(ht=ht, start=start):
                # selector pts (seconds) -> range-relative frame index
                return lambda pts: ht.mark_seen(round(pts * fps) - start)

            sel = FrameSelector(
                cfg.selector,
                cfg.sort,
                fps=fps,
                mark_seen=mk_seen(),
                emit=emit_factory(ri),
            )
            selectors.append(sel)

        # Pre-feed the selectors with every encoded frame in decode order
        # (the reference's gopsplit also buffers the full stream).
        for ri, (sx, start, count) in enumerate(bounds):
            sel = selectors[ri]
            d = self.streams[sx].demux
            for si in range(start, start + count):
                info = d.sample(si)
                sel.push_frame(si, pos_of[ri][si] / fps, info.keyframe)

        start_time = time.perf_counter()
        # Window accounting: window j of a range covers source frames
        # [j*gamma, j*gamma + t) and is attributed to its NEWEST frame
        # j*gamma + t - 1 (the reference's metapreprocess emits each
        # stack with the current frame's pts). Chunk count follows the
        # longest range; shorter ranges simply stop contributing (their
        # slots process zero-filled metadata which the host mirror skips).
        g = cfg.compressed.gamma
        wmax = [max(0, (c - t) // g + 1) for _, _, c in bounds]
        longest_w = max(wmax, default=0)
        n_chunks = -(-longest_w // f) if longest_w > 0 else 0
        nf_chunk = (f - 1) * g + t  # source frames fed per chunk
        total_frames = sum(c for _, _, c in bounds)

        threads = cfg.parallel.decode_threads
        mh, mw = demux.mb_height, demux.mb_width

        from cova_tpu.pipeline.compressed import unpack_outputs_np
        import types as _t

        def host_track(masks_flat, win0, skipped):
            """host_tracking mode: pull the chunk's thresholded masks,
            run native CC + SORT (csrc/cctrack.cc) per range/window, and
            drive the selector — the reference's bboxcc + sort-crate
            CPU path, fed by the GPU's BlobNet masks."""
            from cova_tpu.pipeline.compressed import unpack_masks
            from cova_tpu.tracker.host import cc_boxes

            r_, f_, mh_, mw_ = self.stage.masks_shape
            masks = unpack_masks(masks_flat, self.stage.masks_shape)
            masks = masks.reshape(r_ * f_, mh_, mw_)
            ltwh, _, valid = cc_boxes(
                masks, cfg.compressed.cc_threshold, 16
            )
            ltwh = ltwh.reshape(r_, f_, 16, 4)
            valid = valid.reshape(r_, f_, 16)
            for ri, (sx, start, count) in enumerate(bounds):
                if skipped[ri]:
                    continue
                sel = selectors[ri]
                hs = trackers[ri]
                for k in range(f):
                    if win0 + k >= wmax[ri]:
                        break
                    frame_idx = (win0 + k) * g + t - 1
                    pts = (start + frame_idx) / fps
                    dets = ltwh[ri, k][valid[ri, k]]
                    min_required_frame = hs.update(dets, float(frame_idx))
                    if last == "track":
                        continue
                    min_required = (
                        None
                        if min_required_frame is None
                        else (start + min_required_frame) / fps
                    )
                    sel.on_mask_frame(pts, min_required)

        def host_mirror(outputs, win0, skipped):
            """Consume one chunk's pulled SortOutputs: HostTracker
            histories/deaths + FrameSelector scheduling per window."""
            out_np = unpack_outputs_np(outputs, self.stage.packed_shape)

            def row_view(ri, k):
                ns = _t.SimpleNamespace()
                for name in (
                    "track_ltwh", "track_id", "track_id_post", "exists",
                    "active", "predicted",
                    "death", "death_id", "death_start", "death_last_match",
                    "death_tsu", "death_active",
                ):
                    setattr(ns, name, getattr(out_np, name)[ri, k])
                return ns

            for ri, (sx, start, count) in enumerate(bounds):
                if skipped[ri]:
                    continue
                sel = selectors[ri]
                ht = trackers[ri]
                for k in range(f):
                    if win0 + k >= wmax[ri]:
                        break
                    # Range-relative display index of the window's
                    # newest frame (the frame this mask describes).
                    frame_idx = (win0 + k) * g + t - 1
                    pts = (start + frame_idx) / fps

                    row = row_view(ri, k)
                    min_required_frame = ht.update(float(frame_idx), row)
                    if last == "track":
                        continue
                    # Selector works in the rank/fps domain (its pushed
                    # frame pts are display ranks / fps).
                    min_required = (
                        None
                        if min_required_frame is None
                        else (start + min_required_frame) / fps
                    )
                    sel.on_mask_frame(pts, min_required)

        # Software-pipelined chunk loop: while chunk i's outputs cross
        # to the host, the host entropy-decodes chunk i+1 and the device
        # crunches it; the host mirror for chunk i runs one iteration
        # later, when its transfer has landed. (The SORT scan itself
        # stays strictly sequential device-side via its carried state.)
        timers = StageTimers()
        pending_mirror = None  # (outputs, win0, skipped) awaiting mirror
        for chunk_i in range(max(n_chunks, 0)):
            win0 = chunk_i * f
            off = win0 * g  # first source frame of the chunk
            t_dec = time.perf_counter()
            # 2-byte/cell wire format (entropy_decode_packed16) halves
            # the chunk upload; the stage unpacks on device bit-exactly
            # (ops.preprocess.unpack_wire16).
            meta_chunk = np.zeros(
                (self.num_ranges, nf_chunk, mh, mw, 2), np.uint8
            )
            if cfg.compressed.signed_mv:
                # zero motion (mv_x=mv_y=8 -> offset 128) in padding
                meta_chunk[..., 1] = 0x88
            skipped = []
            for ri, (sx, start, count) in enumerate(bounds):
                n = min(nf_chunk, count - off)
                if win0 >= wmax[ri] or n <= 0:
                    skipped.append(True)
                    continue
                self.streams[sx].demux.entropy_decode_packed16(
                    disp[ri][off : off + n],
                    with_nnz=cfg.compressed.use_nnz_channel,
                    signed_mv=cfg.compressed.signed_mv,
                    threads=threads,
                    out=meta_chunk[ri, :n],
                )
                skipped.append(False)
            timers.entropy_decode += time.perf_counter() - t_dec
            if last == "entdec":
                continue

            t_dev = time.perf_counter()
            if host_tracking:
                pulled = self.stage.run_chunk_masks(meta_chunk)
            else:
                ts0 = np.full(self.num_ranges, off + t - 1, np.int32)
                nwin = np.array(
                    [max(0, min(f, wm - win0)) for wm in wmax], np.int32
                )
                pulled, masks, boxes = self.stage.run_chunk(
                    meta_chunk, ts0, nwin
                )
            timers.device_dispatch += time.perf_counter() - t_dev
            if last in ("mask", "boxes"):
                continue
            try:
                pulled.copy_to_host_async()
            except AttributeError:
                pass  # non-jax array (tests stub the stage)

            mirror = host_track if host_tracking else host_mirror
            if pending_mirror is not None:
                t_mir = time.perf_counter()
                mirror(*pending_mirror)
                timers.host_mirror += time.perf_counter() - t_mir
            pending_mirror = (pulled, win0, skipped)
        if pending_mirror is not None:
            t_mir = time.perf_counter()
            mirror = host_track if host_tracking else host_mirror
            mirror(*pending_mirror)
            timers.host_mirror += time.perf_counter() - t_mir

        # EOS: flush selectors + trackers, then decode scheduled frames.
        for sel, ht in zip(selectors, trackers):
            sel.finish()
            if host_tracking:
                ht.finalize()
            else:
                ht.finalize(cfg.sort.min_hits)

        pixel_frames = 0
        if last == "full" and any(pix_jobs):
            t_pix = time.perf_counter()
            pixel_frames = self._run_pixel_stage(
                pix_jobs, [sx for sx, _, _ in bounds]
            )
            timers.pixel_stage += time.perf_counter() - t_pix

        for s in self.streams:
            s.aggregator.terminate()
        elapsed = time.perf_counter() - start_time

        counts = [s.counts for s in selectors]
        return CovaResult(
            num_frames=total_frames,
            elapsed_seconds=elapsed,
            dropped=sum(c.dropped for c in counts),
            decoded_dependency=sum(c.decoded_dependency for c in counts),
            decoded_inference=sum(c.decoded_inference for c in counts),
            dead_tracks=dead_count[0],
            pixel_frames=pixel_frames,
            timers=timers,
        )

    def _run_pixel_stage(self, jobs_per_range, stream_of_range=None):
        """Selective decode: feed scheduled frames GoP-prefix order to
        libavcodec (codec.PixelDecoder), drop droppable (dependency-only) outputs, hand the
        rest to the detector (reference: funnel->nvdec->identity->YOLO,
        pipeline/cova/pipeline.py:263-344). Ranges decode concurrently —
        one decoder per range (the reference fans decode across its 32
        branch threads); ctypes drops the GIL inside libavcodec."""
        import concurrent.futures

        if stream_of_range is None:
            stream_of_range = [0] * len(jobs_per_range)
        # Prefetch bitstream payloads serially: the demuxer's FILE* is
        # seek-position stateful, so only the libavcodec work is fanned
        # out to threads.
        prefetched = []
        for ri, jobs in enumerate(jobs_per_range):
            demux = self.streams[stream_of_range[ri]].demux
            ordered = sorted(jobs, key=lambda x: x.sample_index)
            drop = {fr.sample_index: fr.droppable for fr in ordered}
            # PAFF: one sample = one FIELD; libavcodec weaves the
            # complementary pair (adjacent samples, opposite parity)
            # into ONE output frame carrying the FIRST field's pts.
            # Decode pairs atomically: pull in the complement of every
            # scheduled field, and keep the woven frame iff EITHER
            # field was scheduled non-droppable. field_parity() is 0
            # for every progressive/MBAFF sample (frame pictures), so
            # this is a no-op off PAFF streams.
            for si in sorted(drop):
                p = demux.field_parity(si)
                if p == 0:
                    continue
                for cand in (si + 1, si - 1):
                    if (0 <= cand < demux.num_samples
                            and demux.field_parity(cand) == 3 - p):
                        if cand not in drop:
                            drop[cand] = True
                        merged = drop[si] and drop[cand]
                        drop[si] = drop[cand] = merged
                        break
            prefetched.append(
                [(demux.read_sample(si), demux.sample(si).pts, drop[si])
                 for si in sorted(drop)]
            )

        def decode_range(args):
            items, sx = args
            if not items:
                return []
            demux = self.streams[sx].demux
            dec = PixelDecoder(demux.extradata())
            frames = []
            droppable_by_pts = {pts: d for _, pts, d in items}

            def drain():
                got = dec.pop(demux.width, demux.height)
                while got is not None:
                    pts, y, u, v = got
                    d = droppable_by_pts.get(pts)
                    if d is not None and not d:
                        # Detector timestamps are seconds (the
                        # aggregator's association domain); container
                        # pts are timescale ticks.
                        frames.append((pts / float(demux.timescale), y, u, v))
                    got = dec.pop(demux.width, demux.height)

            for payload, pts, _ in items:
                dec.send(payload, pts)
                drain()
            dec.flush()
            drain()
            return frames

        workers = max(1, min(len(prefetched), self.cfg.parallel.decode_threads))
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            per_range = list(
                ex.map(decode_range, zip(prefetched, stream_of_range))
            )

        # Inference + aggregation per stream (independent detector and
        # aggregator state; a solo run is the 1-stream special case).
        total = 0
        for sidx, s in enumerate(self.streams):
            infer_frames = [
                f
                for ri, frames in enumerate(per_range)
                if stream_of_range[ri] == sidx
                for f in frames
            ]
            total += len(infer_frames)
            self.log(
                f"pixel stage: decoded {len(infer_frames)} inference frames"
                + (f" (stream {sidx})" if len(self.streams) > 1 else "")
            )
            if s.detector is not None and infer_frames:
                dets = s.detector(infer_frames)
                if dets:
                    s.aggregator.update_dnn(dets)
        return total
