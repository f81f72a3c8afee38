"""The compressed-domain stage as one jitted device program.

The reference runs this stage as a GStreamer graph of threads:
metapreprocess -> nvinfer(BlobNet, batch 512) -> maskcopy -> bboxcc ->
cova's SORT update (reference: pipeline/cova/pipeline.py:33-405, call
stack SURVEY.md §3.2). Here the whole chain is a single program over a
chunk of F frames per stream:

  metadata (R, F+T-1, H, W, C) u8
    -> temporal stack + clip normalize          (gather, fused)
    -> BlobNet                                   (batched (R*F) convolutions)
    -> threshold -> connected components -> boxes (vmapped label prop)
    -> SORT                                      (lax.scan over F, vmapped over R)

R is the number of independent GoP ranges ("virtual streams") — the
batch-parallel equivalent of the reference's 32-way gopsplit fan-out
(§2.3); on multiple chips R is sharded over the mesh (see
cova_tpu.parallel).

Outputs are the fixed-shape per-frame SortOutputs stacked over (R, F),
pulled to host once per chunk for the scheduler/aggregator.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp

from cova_tpu.config import CovaConfig
from cova_tpu.models.blobnet import BlobNet
from cova_tpu.ops.cc import mask_to_boxes
from cova_tpu.ops.preprocess import metapreprocess, unpack_wire16
from cova_tpu.tracker.sort import SortState, sort_init, sort_step
from cova_tpu.types import MAX_BOXES_PER_FRAME

# Precision of BlobNet's convolutions in the device program
# (jax.default_matmul_precision). "highest" keeps f32 convolutions in
# full f32; "default" lets the GPU run them in TF32. Measured on an H100
# (chip_smoke.py numerics phase, one 1024-window synth chunk): TF32
# flips 2.4e-6 of the mask cells at threshold 0.6 and runs BlobNet in
# 8.6 ms instead of 24.3 ms, but BlobNet is ~2% of the synth pipeline's
# wall time, so "highest" — the CPU reference's masks bit for bit, and
# the goldens — costs about 1% end to end.
CONV_PRECISION = "highest"


def blobnet_probs(model: BlobNet, variables: Any, cfg: CovaConfig, metadata,
                  precision: str = CONV_PRECISION):
    """The prefix every device entry point shares: unpack the 2-byte/cell
    wire format (bit-exact post-normalize), stack T-frame windows,
    normalize, run BlobNet over the folded (R*F) batch at `precision`.
    Returns ((R*F, H, W) probabilities, F)."""
    if metadata.shape[-1] == 2:
        metadata = unpack_wire16(
            metadata, cfg.compressed.use_nnz_channel, cfg.compressed.signed_mv
        )
    r, ft, h, w, c = metadata.shape
    t = cfg.video.timestep
    g = cfg.compressed.gamma
    f = (ft - t) // g + 1
    x = jax.vmap(
        lambda m: metapreprocess(m, t, g, cfg.compressed.signed_mv)
    )(metadata)
    x = x.reshape(r * f, t, h, w, c)
    with jax.default_matmul_precision(precision):
        probs = model.apply(variables, x, train=False)
    return probs, f


@functools.partial(
    jax.jit,
    static_argnames=("model", "cfg", "max_boxes"),
)
def compressed_stage_step(
    model: BlobNet,
    variables: Any,
    cfg: CovaConfig,
    metadata: jnp.ndarray,  # (R, F + T - 1, H, W, C) u8
    sort_state: SortState,  # vmapped over R
    ts0: jnp.ndarray,  # (R,) int32 — frame index of window 0 per range
    max_boxes: int = MAX_BOXES_PER_FRAME,
    nwin: jnp.ndarray | None = None,  # (R,) int32 — real windows per range
):
    """Run one chunk. Returns (new_sort_state, outputs, masks, boxes).

    With gamma > 1 only every gamma-th temporal window is emitted
    (reference: metapreprocess/imp.rs:302-330), so the number of windows
    per chunk is F = (ft - t)//gamma + 1 and SORT steps carry frame
    timestamps spaced gamma apart. ts0 is the frame index of window 0's
    NEWEST frame (the reference attributes each stack to the current
    frame's pts).

    nwin bounds the SORT scan per range: windows >= nwin (a short
    range's zero-padding tail) leave the tracker state untouched —
    without the bound, padding windows age every track through empty
    frames and their deaths are silently lost (the host consumer stops
    at the real window count)."""
    r, _, h, w, _ = metadata.shape
    g = cfg.compressed.gamma
    probs, f = blobnet_probs(model, variables, cfg, metadata)  # (R*F, H, W)
    if nwin is None:
        nwin = jnp.full((r,), f, jnp.int32)
    masks = probs > cfg.compressed.mask_threshold
    boxes = mask_to_boxes(
        masks, cfg.compressed.cc_threshold, max_boxes
    )  # leading dim R*F
    boxes = jax.tree_util.tree_map(
        lambda a: a.reshape((r, f) + a.shape[1:]), boxes
    )

    def per_range(state, range_boxes, start_ts, nw):
        def step(st, inp):
            frame_boxes, i = inp
            st2, out = sort_step(st, frame_boxes, start_ts + i * g, cfg.sort)
            live = i < nw
            st3 = jax.tree_util.tree_map(
                lambda a, b: jnp.where(live, a, b), st2, st
            )
            return st3, out

        return jax.lax.scan(
            step, state, (range_boxes, jnp.arange(f, dtype=jnp.int32))
        )

    new_state, outputs = jax.vmap(per_range)(sort_state, boxes, ts0, nwin)
    # The packed buffer crosses to the host as one flat array; the host
    # reshapes it for free (unpack_outputs_np).
    packed = pack_outputs(outputs)
    return new_state, packed.reshape(-1), masks.reshape(r, f, h, w), boxes


@functools.partial(jax.jit, static_argnames=("model", "cfg"))
def compressed_masks_step(
    model: BlobNet,
    variables: Any,
    cfg: CovaConfig,
    metadata: jnp.ndarray,  # (R, F + T - 1, H, W, C) u8
):
    """metapreprocess + BlobNet + threshold only — the dense-FLOP part
    of the compressed stage. Returns the thresholded masks BIT-PACKED
    (8 pixels/byte along W, MSB first — np.unpackbits order) as a FLAT
    u8 array of R*F*H*(W/8) bytes: packed because the device->host copy
    is paid per byte. The
    host runs connected components + SORT natively (cctrack.cc), which
    is where the reference runs them too (bboxcc/OpenCV + cova-rs/sort
    are CPU code). Used when cfg.compressed.host_tracking."""
    r, _, h, w, _ = metadata.shape
    assert w % 8 == 0, "mask width must be a multiple of 8 for bit-packing"
    probs, f = blobnet_probs(model, variables, cfg, metadata)
    masks = probs > cfg.compressed.mask_threshold
    pow2 = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    packed = (masks.astype(jnp.uint8).reshape(r * f, h, w // 8, 8) * pow2)
    return packed.sum(axis=-1, dtype=jnp.uint8).reshape(-1)


@functools.partial(jax.jit, static_argnames=("model", "cfg", "precision"))
def compressed_probs_step(
    model: BlobNet,
    variables: Any,
    cfg: CovaConfig,
    metadata: jnp.ndarray,  # (R, F + T - 1, H, W, C) u8
    precision: str = CONV_PRECISION,
):
    """metapreprocess + BlobNet WITHOUT thresholding — the sweep/ablation
    variant of compressed_masks_step: returns the raw per-window mask
    probabilities as a flat f32 array of R*F*H*W. Lets an offline harness sweep
    mask_threshold / cc_threshold / tracker knobs against one cached
    forward pass instead of re-running BlobNet per configuration
    (reference analog: nvinfer's segmentation threshold is a config
    knob applied to the same engine output, config/blobnet/*.txt).
    `precision` lets a numerics check run the prefix at another
    convolution precision than the pipeline's."""
    probs, _ = blobnet_probs(model, variables, cfg, metadata, precision)
    return probs.reshape(-1)


def unpack_masks(packed_flat, shape):
    """Host-side inverse of compressed_masks_step's bit-packing:
    (R, F, H, W) bool masks from the pulled flat buffer."""
    import numpy as _np

    r, f, h, w = shape
    buf = _np.asarray(packed_flat).reshape(r * f, h, w // 8)
    return _np.unpackbits(buf, axis=-1).reshape(r, f, h, w)


# Byte layout of one packed track slot (little-endian, 30 bytes):
#   [0:8)   track_ltwh  4 x f16
#   [8:12)  track_id    i32 (pre-birth id, for history pushes)
#   [12:16) track_id_post i32 (post-birth id, for liveness)
#   [16:20) death_id    i32
#   [20:24) death_start i32
#   [24:28) death_last_match i32
#   [28]    flags u8: exists | active<<1 | predicted<<2 | death<<3
#                     | death_active<<4
#   [29]    death_tsu u8 (clipped at 255)
PACKED_SLOT_BYTES = 30


def _to_u8(x):
    """Bitcast any fixed-width array to u8 with the byte axis appended."""
    if x.dtype == jnp.uint8:
        return x[..., None]
    y = jax.lax.bitcast_convert_type(x, jnp.uint8)
    return y.reshape(x.shape + (x.dtype.itemsize,))


def pack_outputs(o):
    """Compact the per-frame SortOutputs into ONE contiguous u8 buffer
    for the host pull — one transfer per chunk — boxes as f16, counters
    as u8/i32, the five booleans as one bitmask byte (layout above)."""
    flags = (
        o.exists.astype(jnp.uint8)
        | (o.active.astype(jnp.uint8) << 1)
        | (o.predicted.astype(jnp.uint8) << 2)
        | (o.death.astype(jnp.uint8) << 3)
        | (o.death_active.astype(jnp.uint8) << 4)
    )
    parts = [
        _to_u8(o.track_ltwh.astype(jnp.float16)).reshape(o.track_id.shape + (8,)),
        _to_u8(o.track_id),
        _to_u8(o.track_id_post),
        _to_u8(o.death_id),
        _to_u8(o.death_start),
        _to_u8(o.death_last_match),
        _to_u8(flags),
        _to_u8(jnp.clip(o.death_tsu, 0, 255).astype(jnp.uint8)),
    ]
    return jnp.concatenate(parts, axis=-1)  # (..., slots, 30) u8


def unpack_outputs_np(packed, shape=None):
    """Host-side view over the pulled packed buffer (numpy), exposing
    the SortOutputs field names HostTracker consumes.

    `shape`: the logical (..., slots, PACKED_SLOT_BYTES) shape when
    `packed` arrives flattened from the device; CompressedStage exposes
    it as `packed_shape`."""
    import types as _types

    import numpy as _np

    buf = _np.ascontiguousarray(_np.asarray(packed))  # one transfer
    if shape is not None:
        buf = buf.reshape(shape)
    elif buf.ndim == 1:
        raise ValueError("flat packed buffer needs an explicit shape")

    def _f(lo, hi, dt):
        return _np.ascontiguousarray(buf[..., lo:hi]).view(dt)[..., 0]

    flags = buf[..., 28]
    ns = _types.SimpleNamespace(
        track_ltwh=_np.ascontiguousarray(buf[..., 0:8])
        .view(_np.float16)
        .astype(_np.float32),
        track_id=_f(8, 12, _np.int32),
        track_id_post=_f(12, 16, _np.int32),
        exists=(flags & 1) != 0,
        active=(flags & 2) != 0,
        predicted=(flags & 4) != 0,
        death=(flags & 8) != 0,
        death_active=(flags & 16) != 0,
        death_id=_f(16, 20, _np.int32),
        death_start=_f(20, 24, _np.int32),
        death_last_match=_f(24, 28, _np.int32),
        death_tsu=buf[..., 29].astype(_np.int32),
    )
    return ns


class CompressedStage:
    """Host wrapper holding model variables and per-range SORT state.

    With a mesh (ParallelConfig.num_devices > 1) the range axis R is
    sharded over the `stream` mesh axis and parameters are replicated —
    the multi-chip equivalent of the reference's 32-branch gopsplit
    fan-out (SURVEY.md §2.3); XLA inserts any needed collectives."""

    def __init__(
        self,
        model: BlobNet,
        variables,
        cfg: CovaConfig,
        num_ranges: int,
        mesh=None,
    ):
        self.model = model
        self.variables = variables
        self.cfg = cfg
        self.num_ranges = num_ranges
        self.mesh = mesh
        mt = cfg.sort.max_tracks
        self.sort_state = jax.jit(
            lambda: jax.vmap(lambda _: sort_init(mt))(jnp.arange(num_ranges))
        )()
        if mesh is not None:
            from cova_tpu.parallel.mesh import replicate, shard_batch

            if num_ranges % mesh.size:
                raise ValueError(
                    f"num_ranges {num_ranges} not divisible by mesh size "
                    f"{mesh.size}"
                )
            self.variables = replicate(mesh, self.variables)
            self.sort_state = shard_batch(mesh, self.sort_state)

    def _shard(self, x):
        from cova_tpu.parallel.mesh import shard_batch

        return shard_batch(self.mesh, x) if self.mesh is not None else x

    def run_chunk(self, metadata, ts0, nwin=None):
        """metadata: (R, F+T-1, H, W, C) u8; ts0: (R,) int32; nwin:
        optional (R,) int32 real-window bound (see compressed_stage_step).

        Returns (packed_flat, masks, boxes); packed_flat is the 1-D u8
        outputs buffer — reshape with `self.packed_shape` (or pass it to
        unpack_outputs_np) after pulling."""
        r, ft = metadata.shape[:2]
        t = self.cfg.video.timestep
        f = (ft - t) // self.cfg.compressed.gamma + 1
        self.packed_shape = (
            r, f, self.cfg.sort.max_tracks, PACKED_SLOT_BYTES,
        )
        if nwin is None:
            nwin_arr = jnp.full((r,), f, jnp.int32)
        else:
            nwin_arr = jnp.asarray(nwin, jnp.int32)
        self.sort_state, outputs, masks, boxes = compressed_stage_step(
            self.model,
            self.variables,
            self.cfg,
            self._shard(jnp.asarray(metadata)),
            self.sort_state,
            self._shard(jnp.asarray(ts0, jnp.int32)),
            nwin=self._shard(nwin_arr),
        )
        return outputs, masks, boxes

    def run_chunk_masks(self, metadata):
        """Masks-only device step (host_tracking mode): metadata
        (R, F+T-1, H, W, C) u8 -> flat bit-packed u8 masks; recover
        (R, F, H, W) with unpack_masks(pulled, self.masks_shape)."""
        r, ft = metadata.shape[:2]
        t = self.cfg.video.timestep
        f = (ft - t) // self.cfg.compressed.gamma + 1
        h, w = metadata.shape[2], metadata.shape[3]
        self.masks_shape = (r, f, h, w)
        return compressed_masks_step(
            self.model,
            self.variables,
            self.cfg,
            self._shard(jnp.asarray(metadata)),
        )
