"""Core array types for the compressed-domain pipeline.

The reference keeps boxes as ``Vec<Bbox>`` with per-box structs serialized
with bincode (reference: cova-rs/bbox/src/bbox.rs:1-131).  Here variable
length box lists become fixed-capacity struct-of-arrays with a validity
mask so every shape is static under jit.

Geometry convention matches the reference: ``(left, top, width, height)``
in whatever unit the stage runs at (macroblock units for the compressed
stage — the 80x45 grid for 1280x720 video — pixels after the x16 upscale
in the aggregator; reference: analysis-aggregator/src/server/track.rs:58).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# Macroblock size in pixels (H.264 16x16 macroblocks).
MB_SIZE = 16

# Fixed capacities — padding discipline so jit never recompiles.
MAX_BOXES_PER_FRAME = 32  # CC components surviving the area threshold
MAX_TRACKS = 64  # concurrent SORT track slots per stream

# Sentinel for invalid / padded entries.
INVALID_ID = -1


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Boxes:
    """A fixed-capacity batch of boxes (struct-of-arrays).

    Attributes all share leading dims ``(...)`` and a capacity axis ``K``:
      ltwh:  (..., K, 4) float32 — left, top, width, height
      valid: (..., K)    bool
      area:  (..., K)    float32 — component pixel count (CC) or w*h
      class_id: (..., K) int32
      conf:  (..., K)    float32
      track_id: (..., K) int32 (INVALID_ID if unassigned)
    """

    ltwh: jax.Array
    valid: jax.Array
    area: jax.Array
    class_id: jax.Array
    conf: jax.Array
    track_id: jax.Array

    @staticmethod
    def empty(k: int, leading: tuple[int, ...] = ()) -> "Boxes":
        sh = leading + (k,)
        return Boxes(
            ltwh=jnp.zeros(sh + (4,), jnp.float32),
            valid=jnp.zeros(sh, bool),
            area=jnp.zeros(sh, jnp.float32),
            class_id=jnp.full(sh, INVALID_ID, jnp.int32),
            conf=jnp.zeros(sh, jnp.float32),
            track_id=jnp.full(sh, INVALID_ID, jnp.int32),
        )

    @property
    def left(self):
        return self.ltwh[..., 0]

    @property
    def top(self):
        return self.ltwh[..., 1]

    @property
    def width(self):
        return self.ltwh[..., 2]

    @property
    def height(self):
        return self.ltwh[..., 3]

    def count(self):
        return jnp.sum(self.valid, axis=-1)

    def scale_dim(self, factor: float) -> "Boxes":
        """Uniformly scale all geometry (reference: bbox.rs `scale_dim`,
        used for the x16 macroblock->pixel conversion,
        analysis-aggregator/src/server/track.rs:58)."""
        return dataclasses.replace(
            self, ltwh=self.ltwh * factor, area=self.area * factor * factor
        )

    def scale(self, factor: float) -> "Boxes":
        """Grow boxes around their center by `factor` (reference:
        bbox.rs `scale`, used by the associator's match inflation with
        scale_factor 1.3)."""
        l, t, w, h = (self.ltwh[..., i] for i in range(4))
        nw, nh = w * factor, h * factor
        nl = l - (nw - w) / 2.0
        nt = t - (nh - h) / 2.0
        return dataclasses.replace(self, ltwh=jnp.stack([nl, nt, nw, nh], axis=-1))

    def tree_flatten(self):
        return (
            (self.ltwh, self.valid, self.area, self.class_id, self.conf, self.track_id),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux: Any, children):
        return cls(*children)


def boxes_from_numpy(arr: np.ndarray, k: int = MAX_BOXES_PER_FRAME) -> Boxes:
    """Pack an (N,4) ltwh float array into a fixed-capacity Boxes."""
    arr = np.asarray(arr, np.float32).reshape(-1, 4) if np.size(arr) else np.zeros(
        (0, 4), np.float32
    )
    n = min(len(arr), k)
    ltwh = np.zeros((k, 4), np.float32)
    valid = np.zeros((k,), bool)
    ltwh[:n] = arr[:n, :4]
    valid[:n] = True
    area = ltwh[:, 2] * ltwh[:, 3]
    return Boxes(
        ltwh=jnp.asarray(ltwh),
        valid=jnp.asarray(valid),
        area=jnp.asarray(area),
        class_id=jnp.full((k,), INVALID_ID, jnp.int32),
        conf=jnp.zeros((k,), jnp.float32),
        track_id=jnp.full((k,), INVALID_ID, jnp.int32),
    )


@dataclasses.dataclass
class TrackRecord:
    """Host-side record of a finished track (reference: the `Frame`
    payload the cova element sends to the aggregator,
    cova-rs/gst-plugins/src/cova/tracker.rs:62-81).

    history: list of (timestamp_seconds, ltwh-in-MB-units) samples.
    """

    track_id: int
    start_ts: float
    end_ts: float
    seen: bool
    history: list  # [(ts, (l, t, w, h)), ...]


@dataclasses.dataclass
class Detection:
    """Host-side oracle detection (reference: tcpprobe CSV line,
    gst-plugins/gst-tcpprobe/gsttcpprobe.cpp:223-229)."""

    ts: float
    left: float
    top: float
    width: float
    height: float
    class_id: int
    conf: float = 0.0
