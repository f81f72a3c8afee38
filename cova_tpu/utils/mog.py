"""Background-subtraction label generation, on device.

Replaces the reference's OpenCV MOG2 pseudo-label pipeline (reference:
utils/generate-mog.py: MOG2(history=9000, varThreshold=32, no shadows)
on 640x360 frames, fgMask>0, morph close 4x4, open 6x6, contour fill,
then [::8,::8] downsample to the 80x45 macroblock grid).

On the accelerator: the Gaussian-mixture update (Zivkovic 2004, the algorithm
behind cv2's MOG2) is pure per-pixel arithmetic, so it runs as a
`lax.scan` over frames with (K=4)-component mixture state per pixel —
the whole video's labels are produced in one jitted pass. Morphology is
expressed with max/min pools; hole filling happens host-side with
scipy.ndimage (cheap at 640x360). Luma-only input (the reference feeds
BGR; foreground energy is dominated by luma, and labels are only
pseudo-ground-truth for BlobNet training).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(
    jax.jit, static_argnames=("k", "history", "var_threshold", "bg_ratio")
)
def mog2_scan(
    frames: jnp.ndarray,  # (F, H, W) uint8 luma
    k: int = 4,
    history: int = 9000,
    var_threshold: float = 32.0,
    bg_ratio: float = 0.9,
    var_init: float = 15.0,
    var_min: float = 4.0,
    var_max: float = 75.0,
):
    """Run MOG2 over a frame sequence; returns (F, H, W) bool foreground."""
    f, h, w = frames.shape

    def step(st, x):
        return _mog2_step(
            st, x, k, history, var_threshold, bg_ratio, var_init, var_min,
            var_max,
        )

    init = (
        jnp.full((h, w, k), 1.0 / k, jnp.float32),
        jnp.broadcast_to(
            frames[0].astype(jnp.float32)[..., None], (h, w, k)
        ).copy(),
        jnp.full((h, w, k), var_init, jnp.float32),
    )
    _, fg = jax.lax.scan(step, init, frames)
    return fg


def _binary_pool(x, kh, kw, op):
    """Morphological dilate (max) / erode (min) with a kh x kw kernel."""
    import jax.lax as lax

    pad_h, pad_w = kh // 2, kw // 2
    init = -jnp.inf if op == "max" else jnp.inf
    fn = lax.max if op == "max" else lax.min
    y = lax.reduce_window(
        x.astype(jnp.float32),
        init,
        fn,
        (1, kh, kw),
        (1, 1, 1),
        [(0, 0), (pad_h, kh - 1 - pad_h), (pad_w, kw - 1 - pad_w)],
    )
    return y > 0.5


@jax.jit
def morph_close_open(fg: jnp.ndarray) -> jnp.ndarray:
    """close(4x4) then open(6x6) (reference kernels)."""
    x = _binary_pool(fg, 4, 4, "max")
    x = _binary_pool(x, 4, 4, "min")
    x = _binary_pool(x, 6, 6, "min")
    x = _binary_pool(x, 6, 6, "max")
    return x


def generate_labels(
    luma_frames: np.ndarray,  # (F, H/2, W/2) uint8 (downscaled luma)
    chunk: int = 256,
) -> np.ndarray:
    """Full reference label pipeline -> (F, ceil(H/16), ceil(W/16))
    uint8 {0,1} — the MB grid (45x80 at 720p, 68x120 at 1080p; the
    half-res luma strided by 8 lands exactly on ceil(H/16) rows, the
    same grid the entropy decoder exports for non-multiple-of-16
    heights)."""
    import scipy.ndimage

    f, hh, hw = luma_frames.shape
    out = np.empty((f, (hh + 7) // 8, (hw + 7) // 8), np.uint8)
    state = None
    pos = 0
    # Chunked scan to bound memory; carry mixture state across chunks.
    mog = _StatefulMog2()
    for start in range(0, f, chunk):
        part = jnp.asarray(luma_frames[start : start + chunk])
        fg = mog.run(part)
        fg = morph_close_open(fg)
        fg_np = np.asarray(fg)
        for i in range(fg_np.shape[0]):
            filled = scipy.ndimage.binary_fill_holes(fg_np[i])
            out[pos] = filled[::8, ::8].astype(np.uint8)
            pos += 1
    return out


class _StatefulMog2:
    """Chunked wrapper keeping mixture state between scan calls."""

    def __init__(self, k=4, history=9000, var_threshold=32.0, bg_ratio=0.9,
                 var_init=15.0, var_min=4.0, var_max=75.0):
        self.args = (k, history, var_threshold, bg_ratio, var_init, var_min,
                     var_max)
        self.state = None
        self._step = None

    def run(self, frames: jnp.ndarray) -> jnp.ndarray:
        k, history, var_threshold, bg_ratio, var_init, var_min, var_max = self.args
        f, h, w = frames.shape
        if self.state is None:
            self.state = (
                jnp.full((h, w, k), 1.0 / k, jnp.float32),
                jnp.broadcast_to(
                    frames[0].astype(jnp.float32)[..., None], (h, w, k)
                ).copy(),
                jnp.full((h, w, k), var_init, jnp.float32),
            )
        if self._step is None:
            @jax.jit
            def scan_chunk(state, frames):
                def step(st, x):
                    return _mog2_step(
                        st, x, k, history, var_threshold, bg_ratio,
                        var_init, var_min, var_max,
                    )
                return jax.lax.scan(step, state, frames)

            self._step = scan_chunk
        self.state, fg = self._step(self.state, frames)
        return fg


def _mog2_step(state, x, k, history, var_threshold, bg_ratio, var_init,
               var_min, var_max):
    weight, mean, var = state
    alpha = 1.0 / history
    xf = x.astype(jnp.float32)[..., None]
    d2 = (xf - mean) ** 2
    match = d2 < var_threshold * var
    dist_key = jnp.where(match, d2 / jnp.maximum(var, 1e-6), jnp.inf)
    owner = jnp.argmin(dist_key, axis=-1)
    any_match = jnp.any(match, axis=-1)
    onehot = jax.nn.one_hot(owner, k, dtype=jnp.float32) * any_match[..., None]

    weight = weight + alpha * (onehot - weight)
    rho = alpha / jnp.maximum(weight, 1e-6)
    mean = mean + onehot * rho * (xf - mean)
    var = var + onehot * rho * (d2 - var)
    var = jnp.clip(var, var_min, var_max)

    weakest = jnp.argmin(weight, axis=-1)
    repl = jax.nn.one_hot(weakest, k, dtype=jnp.float32) * (~any_match)[..., None]
    weight = jnp.where(repl > 0, alpha, weight)
    mean = jnp.where(repl > 0, xf, mean)
    var = jnp.where(repl > 0, var_init, var)
    weight = weight / jnp.sum(weight, axis=-1, keepdims=True)

    order = jnp.argsort(-weight, axis=-1)
    w_sorted = jnp.take_along_axis(weight, order, axis=-1)
    cum = jnp.cumsum(w_sorted, axis=-1)
    n_bg = jnp.sum(cum < bg_ratio, axis=-1) + 1
    rank_of = jnp.argsort(order, axis=-1)
    owner_rank = jnp.take_along_axis(rank_of, owner[..., None], axis=-1)[..., 0]
    fg = ~any_match | (owner_rank >= n_bg)
    return (weight, mean, var), fg
