"""Batched 8-connected components + region stats as XLA ops.

Replaces the reference's OpenCV `connected_components_with_stats` call in
the bboxcc element (reference: cova-rs/gst-plugins/src/bboxcc/process.rs:5-49)
with a label-propagation algorithm XLA compiles for any device:

* labels start as each foreground pixel's linear index;
* each sweep takes the min over the 8-neighborhood (one hop) followed by
  two pointer-jumping steps (``label = label[label]``), contracting label
  chains geometrically;
* a FIXED number of sweeps (default 32) runs as a `fori_loop` — no
  convergence check, so the batch never serializes on its slowest frame
  and the program contains no data-dependent control flow. The spiral
  exactness test needs 24 sweeps; 32 gives margin, and the bound is
  validated against scipy in tests/test_ops.py.

Region stats: component areas come from one scatter-add over the label
grid, and the fixed-capacity box extents from K masked reductions.

Component ordering matches OpenCV's: labels are compacted in raster order
of each component's first (minimum linear index) pixel, so box K of a
frame corresponds to the reference's label K+1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cova_tpu.types import MAX_BOXES_PER_FRAME, Boxes


def _neighbor_min(lab: jnp.ndarray, big: int) -> jnp.ndarray:
    """Min of the 8-neighborhood (and self) with `big` padding."""
    h, w = lab.shape
    p = jnp.pad(lab, 1, constant_values=big)
    m = lab
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            m = jnp.minimum(m, jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w)))
    return m


@functools.partial(jax.jit, static_argnames=("num_iters",))
def connected_components(mask: jnp.ndarray, num_iters: int = 32) -> jnp.ndarray:
    """8-connected labeling of a 2D boolean mask.

    Returns (H, W) int32 where each foreground pixel holds the linear
    index of its component's root (first pixel in raster order) and
    background pixels hold H*W.
    """
    h, w = mask.shape
    big = h * w
    idx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w + jax.lax.broadcasted_iota(
        jnp.int32, (h, w), 1
    )
    lab0 = jnp.where(mask, idx, big)

    def body(_, lab):
        hop = jnp.where(mask, _neighbor_min(lab, big), big)
        # Double pointer jump: follow label chains two levels. Labels of
        # foreground pixels always reference foreground pixels of the
        # same component, so lookups stay in-component.
        flat = jnp.concatenate([hop.reshape(-1), jnp.array([big], jnp.int32)])
        j1 = flat[jnp.minimum(hop.reshape(-1), big)]
        j2 = flat[jnp.minimum(j1, big)].reshape(h, w)
        return jnp.where(mask, jnp.minimum(hop, j2), big)

    return jax.lax.fori_loop(0, num_iters, body, lab0)


@functools.partial(jax.jit, static_argnames=("max_boxes",))
def _stats_from_labels(
    mask: jnp.ndarray,
    labels: jnp.ndarray,
    area_threshold: jnp.ndarray,
    max_boxes: int,
) -> Boxes:
    """Component areas via one scatter-add over the label grid, box
    extents via max_boxes masked reductions."""
    h, w = mask.shape
    n = h * w
    flat_lab = labels.reshape(-1)  # background = n

    fg = mask.reshape(-1)
    is_root = fg & (flat_lab == jnp.arange(n, dtype=jnp.int32))

    # Pixel count per root (background pixels land in bucket n).
    area_by_root = (
        jnp.zeros((n + 1,), jnp.int32).at[flat_lab].add(fg.astype(jnp.int32))
    )
    eligible = is_root & (area_by_root[:n] >= area_threshold)

    # Compact eligible roots in raster order.
    order_key = jnp.where(eligible, jnp.arange(n, dtype=jnp.int32), n)
    root_idx = jax.lax.top_k(-order_key, max_boxes)[1]
    valid = eligible[root_idx]
    roots = jnp.where(valid, root_idx, -1)
    areas = jnp.where(valid, area_by_root[root_idx], 0)

    # Box extents: K masked reductions (K x H x W elementwise + reduce).
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

    def extents(root):
        m = labels == root
        min_r = jnp.min(jnp.where(m, rows, n))
        max_r = jnp.max(jnp.where(m, rows, -1))
        min_c = jnp.min(jnp.where(m, cols, n))
        max_c = jnp.max(jnp.where(m, cols, -1))
        return min_r, max_r, min_c, max_c

    min_r, max_r, min_c, max_c = jax.vmap(extents)(roots)

    left_f = min_c.astype(jnp.float32)
    top_f = min_r.astype(jnp.float32)
    width = (max_c - min_c + 1).astype(jnp.float32)
    height = (max_r - min_r + 1).astype(jnp.float32)
    ltwh = jnp.stack([left_f, top_f, width, height], axis=-1)
    ltwh = jnp.where(valid[:, None], ltwh, 0.0)

    return Boxes(
        ltwh=ltwh,
        valid=valid,
        # Reference boxes carry area = w*h (Bbox::new), not the CC pixel
        # count — the pixel count is only used for thresholding.
        area=jnp.where(valid, ltwh[..., 2] * ltwh[..., 3], 0.0),
        class_id=jnp.full((max_boxes,), -1, jnp.int32),
        conf=jnp.zeros((max_boxes,), jnp.float32),
        track_id=jnp.full((max_boxes,), -1, jnp.int32),
    )


def mask_to_boxes(
    mask: jnp.ndarray,
    area_threshold: int = 1,
    max_boxes: int = MAX_BOXES_PER_FRAME,
    num_iters: int = 32,
) -> Boxes:
    """Full bboxcc equivalent: label a (..., H, W) boolean mask batch and
    return fixed-capacity per-frame boxes with area >= threshold."""
    batch_shape = mask.shape[:-2]
    flat = mask.reshape((-1,) + mask.shape[-2:])

    def one(m):
        lab = connected_components(m, num_iters)
        return _stats_from_labels(
            m, lab, jnp.asarray(area_threshold, jnp.int32), max_boxes
        )

    out = jax.vmap(one)(flat)
    return jax.tree_util.tree_map(
        lambda x: x.reshape(batch_shape + x.shape[1:]), out
    )
