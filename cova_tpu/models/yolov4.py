"""YOLOv4 detector in Flax — the pixel-domain oracle.

Replaces the reference's TensorRT YOLOv4-608 engine (reference:
config/dnn/yolov4_b2.txt, weights/cfg from third_parties/tensorrt_demos)
with a native JAX implementation: CSPDarknet53 backbone, SPP neck, PANet
feature aggregation and three YOLO heads, matching the standard
yolov4-608 topology so released darknet weights load directly (see
`load_darknet_weights`).

Design notes: NHWC layout, bfloat16 compute with float32
params/statistics, static 608x608 input, decode + NMS on device
(cova_tpu.ops.nms, nms-iou 0.2 per the reference config). Mish is
computed as x * tanh(softplus(x)) which XLA fuses into the conv
epilogue.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

# Standard yolov4.cfg anchors/strides (reference: tensorrt_demos yolo cfg).
ANCHORS = (
    ((12, 16), (19, 36), (40, 28)),      # stride 8
    ((36, 75), (76, 55), (72, 146)),     # stride 16
    ((142, 110), (192, 243), (459, 401)),  # stride 32
)
STRIDES = (8, 16, 32)
SCALE_XY = (1.2, 1.1, 1.05)


def mish(x):
    return x * jnp.tanh(jax.nn.softplus(x))


class ConvBN(nn.Module):
    filters: int
    kernel: int = 3
    stride: int = 1
    act: str = "mish"  # "mish" | "leaky" | "linear"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = False):
        use_bias = self.act == "linear"
        pad = "SAME" if self.stride == 1 else [(self.kernel // 2,) * 2] * 2
        x = nn.Conv(
            self.filters,
            (self.kernel, self.kernel),
            strides=(self.stride, self.stride),
            padding=pad,
            use_bias=use_bias,
            dtype=self.dtype,
        )(x)
        if not use_bias:
            x = nn.BatchNorm(use_running_average=not train, dtype=self.dtype)(x)
        if self.act == "mish":
            x = mish(x)
        elif self.act == "leaky":
            x = nn.leaky_relu(x, 0.1)
        return x


class CSPBlock(nn.Module):
    """One CSP stage of CSPDarknet53."""

    filters: int
    blocks: int
    first: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = False):
        f = self.filters
        inner = f if self.first else f // 2
        x = ConvBN(f, 3, 2, dtype=self.dtype)(x, train)  # downsample
        route = ConvBN(inner, 1, dtype=self.dtype)(x, train)
        x = ConvBN(inner, 1, dtype=self.dtype)(x, train)
        for _ in range(self.blocks):
            y = ConvBN(f // 2, 1, dtype=self.dtype)(x, train)
            y = ConvBN(inner, 3, dtype=self.dtype)(y, train)
            x = x + y
        x = ConvBN(inner, 1, dtype=self.dtype)(x, train)
        x = jnp.concatenate([x, route], axis=-1)
        return ConvBN(f, 1, dtype=self.dtype)(x, train)


class CSPDarknet53(nn.Module):
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = ConvBN(32, 3, dtype=self.dtype)(x, train)
        x = CSPBlock(64, 1, first=True, dtype=self.dtype)(x, train)
        x = CSPBlock(128, 2, dtype=self.dtype)(x, train)
        x = CSPBlock(256, 8, dtype=self.dtype)(x, train)
        c3 = x  # stride 8
        x = CSPBlock(512, 8, dtype=self.dtype)(x, train)
        c4 = x  # stride 16
        x = CSPBlock(1024, 4, dtype=self.dtype)(x, train)
        return c3, c4, x


class SPP(nn.Module):
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = ConvBN(512, 1, act="leaky", dtype=self.dtype)(x, train)
        x = ConvBN(1024, 3, act="leaky", dtype=self.dtype)(x, train)
        x = ConvBN(512, 1, act="leaky", dtype=self.dtype)(x, train)
        pools = [x] + [
            nn.max_pool(x, (k, k), strides=(1, 1), padding="SAME")
            for k in (5, 9, 13)
        ]
        x = jnp.concatenate(pools[::-1], axis=-1)
        x = ConvBN(512, 1, act="leaky", dtype=self.dtype)(x, train)
        x = ConvBN(1024, 3, act="leaky", dtype=self.dtype)(x, train)
        return ConvBN(512, 1, act="leaky", dtype=self.dtype)(x, train)


def _conv5(x, f, dtype, train, mk):
    for i, (ff, k) in enumerate([(f, 1), (f * 2, 3), (f, 1), (f * 2, 3), (f, 1)]):
        x = mk(ff, k)(x, train)
    return x


class YOLOv4(nn.Module):
    num_classes: int = 80
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = False):
        dt = self.dtype

        def leaky(f, k, s=1):
            return ConvBN(f, k, s, act="leaky", dtype=dt)

        c3, c4, c5 = CSPDarknet53(dtype=dt)(x, train)
        p5 = SPP(dtype=dt)(c5, train)

        # PAN top-down
        u5 = leaky(256, 1)(p5, train)
        u5 = jax.image.resize(
            u5, (u5.shape[0], u5.shape[1] * 2, u5.shape[2] * 2, u5.shape[3]),
            "nearest",
        )
        c4p = leaky(256, 1)(c4, train)
        p4 = _conv5(jnp.concatenate([c4p, u5], -1), 256, dt, train, leaky)

        u4 = leaky(128, 1)(p4, train)
        u4 = jax.image.resize(
            u4, (u4.shape[0], u4.shape[1] * 2, u4.shape[2] * 2, u4.shape[3]),
            "nearest",
        )
        c3p = leaky(128, 1)(c3, train)
        p3 = _conv5(jnp.concatenate([c3p, u4], -1), 128, dt, train, leaky)

        # Heads + PAN bottom-up
        na = 3
        out_ch = na * (5 + self.num_classes)
        h3 = leaky(256, 3)(p3, train)
        o3 = ConvBN(out_ch, 1, act="linear", dtype=dt)(h3, train)

        d3 = leaky(256, 3, 2)(p3, train)
        p4 = _conv5(jnp.concatenate([d3, p4], -1), 256, dt, train, leaky)
        h4 = leaky(512, 3)(p4, train)
        o4 = ConvBN(out_ch, 1, act="linear", dtype=dt)(h4, train)

        d4 = leaky(512, 3, 2)(p4, train)
        p5 = _conv5(jnp.concatenate([d4, p5], -1), 512, dt, train, leaky)
        h5 = leaky(1024, 3)(p5, train)
        o5 = ConvBN(out_ch, 1, act="linear", dtype=dt)(h5, train)

        return o3, o4, o5


def decode_head(raw, anchors, stride, scale_xy, num_classes, input_size):
    """Raw head output (B, H, W, 3*(5+C)) -> boxes/scores in input pixels."""
    b, h, w, _ = raw.shape
    raw = raw.reshape(b, h, w, 3, 5 + num_classes).astype(jnp.float32)
    gy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    gx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    grid = jnp.stack([gx, gy], axis=-1)[None, :, :, None, :]

    xy = (jax.nn.sigmoid(raw[..., 0:2]) * scale_xy - 0.5 * (scale_xy - 1) + grid) * stride
    anchors_arr = jnp.asarray(anchors, jnp.float32)[None, None, None, :, :]
    wh = jnp.exp(jnp.clip(raw[..., 2:4], -20.0, 8.0)) * anchors_arr
    obj = jax.nn.sigmoid(raw[..., 4:5])
    cls = jax.nn.sigmoid(raw[..., 5:])
    scores = obj * cls  # (B, H, W, 3, C)

    ltwh = jnp.concatenate([xy - wh / 2.0, wh], axis=-1)
    n = h * w * 3
    return ltwh.reshape(b, n, 4), scores.reshape(b, n, num_classes)


def postprocess(
    outputs,
    num_classes: int = 80,
    input_size: int = 608,
    score_threshold: float = 0.25,
    nms_iou: float = 0.2,
    max_detections: int = 64,
    pre_nms_top: int = 512,
):
    """Decode all heads and run class-aware NMS on device
    (nms-iou 0.2 per reference config/dnn/yolov4_b2.txt)."""
    from cova_tpu.ops.nms import batched_nms

    boxes_all, scores_all = [], []
    for raw, anc, stride, sxy in zip(outputs, ANCHORS, STRIDES, SCALE_XY):
        bx, sc = decode_head(raw, anc, stride, sxy, num_classes, input_size)
        boxes_all.append(bx)
        scores_all.append(sc)
    boxes = jnp.concatenate(boxes_all, axis=1)  # (B, N, 4)
    scores = jnp.concatenate(scores_all, axis=1)  # (B, N, C)

    best = jnp.max(scores, axis=-1)
    cls = jnp.argmax(scores, axis=-1).astype(jnp.int32)

    def per_image(bx, sc, cl):
        k = min(pre_nms_top, sc.shape[0])
        top = jax.lax.top_k(sc, k)[1]
        return batched_nms(
            bx[top], sc[top], cl[top], nms_iou, score_threshold, max_detections
        )

    return jax.vmap(per_image)(boxes, best, cls)


def preprocess_frames(y, u, v, input_size: int = 608):
    """I420 planes -> (1, S, S, 3) RGB in [0,1] on device (the reference
    uses nvvideoconvert + net-scale-factor 1/255)."""
    yf = y.astype(jnp.float32)
    h, w = yf.shape
    uf = jax.image.resize(u.astype(jnp.float32), (h, w), "nearest")
    vf = jax.image.resize(v.astype(jnp.float32), (h, w), "nearest")
    yy = yf - 16.0
    uu = uf - 128.0
    vv = vf - 128.0
    r = 1.164 * yy + 1.596 * vv
    g = 1.164 * yy - 0.392 * uu - 0.813 * vv
    b = 1.164 * yy + 2.017 * uu
    rgb = jnp.stack([r, g, b], axis=-1) / 255.0
    rgb = jnp.clip(rgb, 0.0, 1.0)
    rgb = jax.image.resize(rgb, (input_size, input_size, 3), "bilinear")
    return rgb[None]


def create_yolov4(rng, num_classes: int = 80, input_size: int = 608,
                  dtype=jnp.float32):
    model = YOLOv4(num_classes, dtype)
    dummy = jnp.zeros((1, input_size, input_size, 3), jnp.float32)
    variables = model.init(rng, dummy, train=False)
    return model, variables


def load_darknet_weights(variables, path, num_classes: int = 80):
    """Load darknet `.weights` (yolov4.weights) into the Flax variables.

    The darknet file is [bn_bias, bn_gamma, bn_mean, bn_var, conv_w] per
    conv-bn layer and [bias, conv_w] per linear head conv, in layer
    order. The YOLOv4.__call__ body is written in yolov4.cfg execution
    order and Flax's variable dict preserves module-creation order, so
    iterating the flattened params IS the darknet layer order (the
    mapping is pinned by tests/test_yolov4.py; accuracy against released
    weights is unverified here — no network egress).
    """
    import flax

    buf = np.fromfile(path, dtype=np.float32, offset=20)
    flat = flax.traverse_util.flatten_dict(variables["params"])
    stats = flax.traverse_util.flatten_dict(variables["batch_stats"])

    pos = 0

    def take(n, shape):
        nonlocal pos
        if pos + n > len(buf):
            raise ValueError(
                f"darknet weights file too short: need {pos + n} floats, "
                f"have {len(buf)}"
            )
        out = buf[pos : pos + n].reshape(shape)
        pos += n
        return out

    # Creation (= forward = darknet cfg) order — do NOT sort.
    conv_paths = [p[:-1] for p in flat if p[-1] == "kernel"]
    for cp in conv_paths:
        kernel = flat[cp + ("kernel",)]
        kh, kw, cin, cout = kernel.shape
        bias_path = cp + ("bias",)
        has_bias = bias_path in flat
        if has_bias:
            flat[bias_path] = take(cout, (cout,))
        else:
            parent = cp[:-1]
            bn_name = None
            for p in flat:
                if p[: len(parent)] == parent and "BatchNorm" in p[len(parent)]:
                    bn_name = p[len(parent)]
                    break
            assert bn_name is not None, f"no BN for {cp}"
            bnp = parent + (bn_name,)
            flat[bnp + ("bias",)] = take(cout, (cout,))
            flat[bnp + ("scale",)] = take(cout, (cout,))
            stats[bnp + ("mean",)] = take(cout, (cout,))
            stats[bnp + ("var",)] = take(cout, (cout,))
        w = take(kh * kw * cin * cout, (cout, cin, kh, kw))
        flat[cp + ("kernel",)] = np.transpose(w, (2, 3, 1, 0))

    if pos != len(buf):
        raise ValueError(
            f"darknet weights file has {len(buf) - pos} trailing floats "
            f"(expected exactly {pos})"
        )
    return {
        "params": flax.traverse_util.unflatten_dict(flat),
        "batch_stats": flax.traverse_util.unflatten_dict(stats),
    }


def make_yolo_detector(
    weights_path,
    num_classes: int = 80,
    input_size: int = 608,
    score_threshold: float = 0.25,
    nms_iou: float = 0.2,
    rng=None,
    cfg_path=None,
):
    """Build a CovaPipeline-compatible oracle callable from darknet
    `.weights`: frames [(ts_seconds, y, u, v), ...] -> list[BoxRec] in
    original-frame pixel units (the reference's nvinfer YOLOv4 engine +
    nvdsbbox extraction, config/dnn/yolov4_b2.txt).

    cfg_path builds the topology from the darknet cfg file the weights
    were trained for (models/darknet_cfg.py — also loads non-yolov4
    variants); None uses the built-in hand-written yolov4 topology,
    which is test-pinned numerically equal to cfg/yolov4.cfg."""
    import jax as _jax

    from cova_tpu.aggregator import BoxRec

    rng = rng if rng is not None else _jax.random.PRNGKey(0)
    if cfg_path:
        from cova_tpu.models.darknet_cfg import (
            create_darknet,
            load_darknet_weights_cfg,
            postprocess_darknet,
        )

        model, variables, heads = create_darknet(
            rng, cfg_path, input_size=input_size
        )
        variables = load_darknet_weights_cfg(variables, weights_path)
        num_classes = heads[0].classes

        @_jax.jit
        def infer(y, u, v):
            x = preprocess_frames(y, u, v, input_size)
            outs = model.apply(variables, x, train=False)
            return postprocess_darknet(
                outs, heads, input_size,
                score_threshold=score_threshold, nms_iou=nms_iou,
            )

    else:
        model, variables = create_yolov4(rng, num_classes, input_size)
        variables = load_darknet_weights(variables, weights_path, num_classes)

        @_jax.jit
        def infer(y, u, v):
            x = preprocess_frames(y, u, v, input_size)
            outs = model.apply(variables, x, train=False)
            return postprocess(
                outs, num_classes, input_size,
                score_threshold=score_threshold, nms_iou=nms_iou,
            )

    def detector(frames):
        recs = []
        for ts, y, u, v in frames:
            h, w = y.shape
            ltwh, scores, classes, valid = (
                np.asarray(a[0]) for a in infer(y, u, v)
            )
            sx, sy = w / input_size, h / input_size
            for k in range(len(valid)):
                if not valid[k]:
                    continue
                l, t, bw, bh = ltwh[k]
                recs.append(
                    BoxRec(
                        left=float(l) * sx,
                        top=float(t) * sy,
                        width=float(bw) * sx,
                        height=float(bh) * sy,
                        area=float(bw) * sx * float(bh) * sy,
                        track_id=None,
                        timestamp=float(ts),
                        class_id=int(classes[k]),
                        confidence=float(scores[k]),
                    )
                )
        return recs

    return detector
