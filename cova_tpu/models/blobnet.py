"""BlobNet — the compressed-domain foreground segmentation CNN, in plain JAX.

Architecture parity with the reference Keras model (reference:
utils/model/{blobnet,encoder,decoder,pointwise}.py and training config
utils/train-blobnet.py:57-69):

* encoder: 4 stages; each = Conv3D(kernel (1,3,3), channels
  [16, 32, 64, 128]) + BatchNorm + MaxPool(1,2,2) with asymmetric
  zero-padding when the pooled dim was odd (pad *before*, i.e. top/left)
  + a residual point-wise temporal block (two Conv1D(4, 1, relu, no
  bias) across the T axis, residual add, relu);
* decoder: operates on the first temporal slice of each encoder output
  (reversed), 4 ConvTranspose(kernel (4,4), stride 2, VALID) upsample
  blocks (channels [64, 32, 16, 16]) each preceded by relu+dropout and
  followed by center crop/pad to the skip shape, BatchNorm and skip
  concat (except the last), final 1x1 conv + sigmoid.

The reference's Conv3D kernels are (1,3,3) — temporally degenerate — so
the encoder folds T into the batch axis and runs NHWC Conv2D; the only
temporal mixing, the point-wise block, is an einsum over a (T,T) matrix.

Parameters are a plain pytree {"params": ..., "batch_stats": ...} whose
keys (Conv_0, BatchNorm_0, PointWiseTemporal_0/mix_0, ConvTranspose_0,
...) are those of the committed artifacts/*.npz weight files.

Input: (B, T=4, H=45, W=80, C) normalized macroblock metadata.
The SHIPPED contract (artifacts/blobnet_demo*.npz, since round 3) is
C=4: [mb_class, signed mv_x, signed mv_y, residual-nnz], signed MVs
offset-128 u8 on the wire and normalized clip(x-128,-6,6)/6 — the
reference's signed-MV contract (utils/data/parse.py:5-31) plus a
residual-density channel the reference's byte layout reserves but
never fills (measured ablation: ACCURACY.md "Input channels" table —
+0.02 BP / −0.02 GC over |mv| variants). Legacy C=3 unsigned-|mv|
weights (clip(x,0,6)/6) remain loadable; the artifact's stored
metadata (`use_nnz_channel`, `signed_mv`) selects the wire format, see
models.load_artifact and cova_tpu.ops.preprocess.
Output: (B, H, W) foreground probability mask.

Reference-trained Keras weights (unobtainable offline anyway) are NOT
drop-in — weights are trained against this framework's own decoder
output, as examples/train_blobnet.py does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

BN_MOMENTUM = 0.99
BN_EPSILON = 1e-5
_DN = ("NHWC", "HWIO", "NHWC")


@dataclasses.dataclass(frozen=True)
class BlobNetConfig:
    encoder_channels: Sequence[int] = (16, 32, 64, 128)
    decoder_channels: Sequence[int] = (64, 32, 16, 16)
    temporal_layers: int = 2  # Conv1D(4,1) count in the point-wise block
    timestep: int = 4
    dropout: float = 0.2
    # 3 = [mb_class, mv_x, mv_y] (legacy unsigned-|mv| weights); 4 adds
    # the residual nnz density channel — the shipped artifacts use 4
    # with signed MVs (CompressedStageConfig.{use_nnz_channel,signed_mv}).
    in_channels: int = 3


def _pool_pad(x):
    """MaxPool (2,2) over H,W then zero-pad top/left when the unpooled dim
    was odd (reference: encoder.py:63-71 pads (1,0) after pooling)."""
    b, t, h, w, c = x.shape
    y = lax.reduce_window(
        x.reshape(b * t, h, w, c), -jnp.inf, lax.max,
        (1, 2, 2, 1), (1, 2, 2, 1), "VALID",
    )
    ph = 1 if h % 2 else 0
    pw = 1 if w % 2 else 0
    if ph or pw:
        y = jnp.pad(y, ((0, 0), (ph, 0), (pw, 0), (0, 0)))
    hh, ww = y.shape[1], y.shape[2]
    return y.reshape(b, t, hh, ww, c)


def _crop_or_pad_center(x, th, tw):
    """Center crop/pad H,W to target, extra element goes first
    (reference: decoder.py:44-72 uses (d//2 + d%2, d//2))."""
    h, w = x.shape[-3], x.shape[-2]
    dh, dw = h - th, w - tw
    if dh > 0:
        x = x[..., dh // 2 + dh % 2 : h - dh // 2, :, :]
    elif dh < 0:
        d = -dh
        x = jnp.pad(
            x,
            [(0, 0)] * (x.ndim - 3) + [(d // 2 + d % 2, d // 2), (0, 0), (0, 0)],
        )
    if dw > 0:
        x = x[..., :, dw // 2 + dw % 2 : w - dw // 2, :]
    elif dw < 0:
        d = -dw
        x = jnp.pad(
            x,
            [(0, 0)] * (x.ndim - 2) + [(d // 2 + d % 2, d // 2), (0, 0)],
        )
    return x


class _Train:
    """Train-mode context of one forward pass: batch statistics, the
    running-average updates they produce, and the dropout key stream."""

    def __init__(self, key, rate):
        self.key = key
        self.rate = rate
        self.stats = {}

    def dropout(self, x):
        if self.rate <= 0.0:
            return x
        self.key, sub = jax.random.split(self.key)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(sub, keep, x.shape)
        return jnp.where(mask, x / keep, jnp.zeros_like(x))


def _batch_norm(x, name, params, batch_stats, train: Optional[_Train], dtype):
    p, s = params[name], batch_stats[name]
    xf = x.astype(jnp.float32)
    if train is None:
        mean, var = s["mean"], s["var"]
    else:
        axes = tuple(range(x.ndim - 1))
        mean = xf.mean(axes)
        var = jnp.maximum(0.0, (xf * xf).mean(axes) - mean * mean)
        train.stats[name] = {
            "mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean,
            "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var,
        }
    mul = lax.rsqrt(var + BN_EPSILON) * p["scale"]
    y = (xf - mean) * mul + p["bias"]
    return y.astype(dtype)


def _conv(x, p, dtype):
    y = lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), (1, 1), "SAME",
        dimension_numbers=_DN,
    )
    return y + p["bias"].astype(dtype)


def _conv_transpose(x, p, dtype):
    y = lax.conv_transpose(
        x.astype(dtype), p["kernel"].astype(dtype), (2, 2), "VALID",
        dimension_numbers=_DN,
    )
    return y + p["bias"].astype(dtype)


@dataclasses.dataclass(frozen=True)
class BlobNet:
    """init/apply over the parameter pytree (see module docstring).

    apply(variables, x) returns (B, H, W) probabilities. With
    train=True it normalizes with batch statistics, applies dropout
    from `dropout_key`, and returns (probs, new_batch_stats)."""

    config: BlobNetConfig = BlobNetConfig()
    dtype: jnp.dtype = jnp.float32

    def init(self, rng, x=None):
        cfg = self.config
        lecun = jax.nn.initializers.lecun_normal()
        keys = iter(jax.random.split(rng, 32))
        params, stats = {}, {}

        def conv(name, k, cin, cout):
            params[name] = {
                "kernel": lecun(next(keys), (k, k, cin, cout), jnp.float32),
                "bias": jnp.zeros((cout,), jnp.float32),
            }

        def bn(name, ch):
            params[name] = {
                "scale": jnp.ones((ch,), jnp.float32),
                "bias": jnp.zeros((ch,), jnp.float32),
            }
            stats[name] = {
                "mean": jnp.zeros((ch,), jnp.float32),
                "var": jnp.ones((ch,), jnp.float32),
            }

        cin = cfg.in_channels
        for i, ch in enumerate(cfg.encoder_channels):
            conv(f"Conv_{i}", 3, cin, ch)
            bn(f"BatchNorm_{i}", ch)
            params[f"PointWiseTemporal_{i}"] = {
                f"mix_{j}": lecun(
                    next(keys), (cfg.timestep, cfg.timestep), jnp.float32
                )
                for j in range(cfg.temporal_layers)
            }
            cin = ch
        enc = list(cfg.encoder_channels)
        skip_ch = enc[::-1][1:]
        n_enc, n_dec = len(enc), len(cfg.decoder_channels)
        for i, ch in enumerate(cfg.decoder_channels):
            params[f"ConvTranspose_{i}"] = {
                "kernel": lecun(next(keys), (4, 4, cin, ch), jnp.float32),
                "bias": jnp.zeros((ch,), jnp.float32),
            }
            cin = ch
            if i < n_dec - 1:
                bn(f"BatchNorm_{n_enc + i}", ch)
                cin = ch + skip_ch[i]
        conv(f"Conv_{n_enc}", 1, cin, 1)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables, x, *, train: bool = False, dropout_key=None):
        cfg, dtype = self.config, self.dtype
        params, batch_stats = variables["params"], variables["batch_stats"]
        tr = None
        if train:
            if dropout_key is None and cfg.dropout > 0.0:
                raise ValueError("train=True needs a dropout_key")
            tr = _Train(dropout_key, cfg.dropout)
        x = x.astype(dtype)
        b, t, h0, w0, _ = x.shape
        n_enc = len(cfg.encoder_channels)

        # ---- encoder ----
        skips = []
        for i, ch in enumerate(cfg.encoder_channels):
            bb, tt, hh, ww, cc = x.shape
            y = x.reshape(bb * tt, hh, ww, cc)
            # (1,3,3) Conv3D == per-timestep 3x3 Conv2D
            y = jax.nn.relu(_conv(y, params[f"Conv_{i}"], dtype))
            y = _batch_norm(y, f"BatchNorm_{i}", params, batch_stats, tr, dtype)
            x = _pool_pad(y.reshape(bb, tt, hh, ww, ch))
            # Point-wise temporal block (reference: utils/model/pointwise.py):
            # TxT dense mixes over the temporal axis, residual + relu.
            hcur = x
            mix = params[f"PointWiseTemporal_{i}"]
            for j in range(cfg.temporal_layers):
                w = mix[f"mix_{j}"].astype(dtype)
                hcur = jax.nn.relu(jnp.einsum("bthwc,ts->bshwc", hcur, w))
                if tr is not None:
                    hcur = tr.dropout(hcur)
            x = jax.nn.relu(hcur + x)
            skips.append(x)

        # ---- decoder: first temporal slice of reversed skips ----
        feats = [s[:, 0] for s in reversed(skips)]  # (B, H, W, C) each
        targets = [f.shape[1:3] for f in feats[1:]] + [(h0, w0)]

        x = feats[0]
        n_dec = len(cfg.decoder_channels)
        for i in range(n_dec):
            x = jax.nn.relu(x)
            if tr is not None:
                x = tr.dropout(x)
            x = _conv_transpose(x, params[f"ConvTranspose_{i}"], dtype)
            x = _crop_or_pad_center(x, *targets[i])
            if i < n_dec - 1:
                x = _batch_norm(
                    x, f"BatchNorm_{n_enc + i}", params, batch_stats, tr, dtype
                )
                x = jnp.concatenate([x, feats[i + 1]], axis=-1)

        x = _conv(x, params[f"Conv_{n_enc}"], dtype)
        probs = jax.nn.sigmoid(x.astype(jnp.float32))[..., 0]  # (B, H, W)
        if tr is None:
            return probs
        return probs, tr.stats


def create_blobnet(rng, config: BlobNetConfig = BlobNetConfig(), dtype=jnp.float32):
    """Init helper returning (model, variables)."""
    model = BlobNet(config, dtype)
    return model, model.init(rng)


def save_params_npz(path, variables, meta: dict | None = None) -> None:
    """Persist a variables pytree as one flat .npz file (committed model
    weights live in artifacts/*.npz). `meta` stores a JSON dict
    describing the input contract the weights were trained for
    (in_channels, signed_mv, ...) under the "__meta__" key; readers use
    `load_meta_npz`."""
    import json as _json

    import numpy as np

    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    arrays = {}
    for path_parts, leaf in flat:
        key = "/".join(
            p.key if hasattr(p, "key") else str(p.idx) for p in path_parts
        )
        arrays[key] = np.asarray(leaf)
    if meta:
        arrays["__meta__"] = np.frombuffer(
            _json.dumps(meta).encode(), dtype=np.uint8
        )
    import pathlib

    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_meta_npz(path) -> dict:
    """Input-contract metadata stored by save_params_npz ({} if none)."""
    import json as _json

    import numpy as np

    with np.load(path) as data:
        if "__meta__" not in data:
            return {}
        return _json.loads(bytes(data["__meta__"]).decode())


def load_artifact(path, rng=None, dtype=jnp.float32):
    """Build (model, variables, meta) from a self-describing npz weight
    artifact: the architecture comes from the stored input-contract
    metadata (in_channels; signed_mv tells the caller which metadata
    packing/normalization the weights expect)."""
    meta = load_meta_npz(path)
    cfg = BlobNetConfig(in_channels=int(meta.get("in_channels", 3)))
    model, template = create_blobnet(
        rng if rng is not None else jax.random.PRNGKey(0), cfg, dtype
    )
    return model, load_params_npz(path, template), meta


def load_params_npz(path, template):
    """Restore a variables pytree saved by save_params_npz; `template` is
    a same-structured pytree (e.g. from create_blobnet)."""
    import numpy as np

    data = np.load(path)
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path_parts, leaf in flat:
        key = "/".join(
            p.key if hasattr(p, "key") else str(p.idx) for p in path_parts
        )
        arr = data[key]
        if arr.shape != leaf.shape:
            raise ValueError(
                f"shape mismatch for {key}: {arr.shape} vs {leaf.shape}"
            )
        leaves.append(jnp.asarray(arr, leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)
