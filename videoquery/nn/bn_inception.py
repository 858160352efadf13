"""BN-Inception (TSN backbone) in pure functional JAX — NHWC for cuDNN.

Architecture transcribed from the reference deploy definitions
(src/features_GPU_compute/models/ucf101/tsn_bn_inception_{rgb,flow}_deploy
.prototxt: stem rgb:12-46, inception_3a..5b, global_pool :739-740,
dropout+fc-action :741-748). RGB input is 3-channel, flow input is 10
channels = 5 stacked (x, y) flow pairs (flow prototxt :4-8).

Design decisions (accelerator-first, not a Caffe translation):

- NHWC layout, conv via lax.conv_general_dilated; bfloat16 activations with
  float32 accumulation by default — the whole 69-conv network is one XLA
  program that fuses BN/ReLU into the convs.
- All BN layers in the reference are *frozen* (bn_param { frozen: true },
  e.g. rgb prototxt :17-19), so BN is folded into conv weights/biases at
  load time (`fold_bn`); at inference there is no BN op at all. For TSN
  fine-tuning the unfolded form keeps per-channel scale/shift with fixed
  statistics (partial-BN semantics of TSN training).
- Caffe pooling arithmetic is reproduced exactly: ceil-mode output sizing
  (extra bottom/right padding) and average pooling that counts padded zeros
  in a constant k*k denominator — this is what makes pool_3c 28->14 rather
  than 13 and keeps borders bit-consistent with Caffe.

Key blobs exposed: `global_pool` (the 1024-d embedding the whole framework
runs on — calcSig_wOF.py:173-176) and `fc-action` logits (score layer,
calcSig_wOF.py:184).
"""

from __future__ import annotations

import math
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np

# Inception block channel spec, transcribed from the prototxt (see module
# docstring). Fields: 1x1 branch, 3x3 reduce/out, double-3x3 reduce/mid/out,
# pool type, pool projection (0 = passthrough), block stride.
# A stride-2 block drops the 1x1 branch and the pool projection and
# max-pools its passthrough (inception_3c, inception_4e).
INCEPTION_BLOCKS: tuple[tuple[str, dict], ...] = (
    ("inception_3a", dict(c1=64, r3=64, c3=64, rd=64, d1=96, d2=96, pool="ave", pp=32, stride=1)),
    ("inception_3b", dict(c1=64, r3=64, c3=96, rd=64, d1=96, d2=96, pool="ave", pp=64, stride=1)),
    ("inception_3c", dict(c1=0, r3=128, c3=160, rd=64, d1=96, d2=96, pool="max", pp=0, stride=2)),
    ("inception_4a", dict(c1=224, r3=64, c3=96, rd=96, d1=128, d2=128, pool="ave", pp=128, stride=1)),
    ("inception_4b", dict(c1=192, r3=96, c3=128, rd=96, d1=128, d2=128, pool="ave", pp=128, stride=1)),
    ("inception_4c", dict(c1=160, r3=128, c3=160, rd=128, d1=160, d2=160, pool="ave", pp=128, stride=1)),
    ("inception_4d", dict(c1=96, r3=128, c3=192, rd=160, d1=192, d2=192, pool="ave", pp=128, stride=1)),
    ("inception_4e", dict(c1=0, r3=128, c3=192, rd=192, d1=256, d2=256, pool="max", pp=0, stride=2)),
    ("inception_5a", dict(c1=352, r3=192, c3=320, rd=160, d1=224, d2=224, pool="ave", pp=128, stride=1)),
    ("inception_5b", dict(c1=352, r3=192, c3=320, rd=192, d1=224, d2=224, pool="max", pp=128, stride=1)),
)

NUM_CLASSES = 101        # UCF101 fc-action (rgb prototxt :741-748)
EMBED_DIM = 1024         # global_pool width
RGB_CHANNELS = 3
FLOW_CHANNELS = 10       # 5 x/y flow pairs (flow prototxt :4-8)


# ---------------------------------------------------------------------------
# Caffe-exact pooling
# ---------------------------------------------------------------------------

def _ceil_pool_padding(size: int, k: int, s: int, pad: int) -> tuple[int, int]:
    """Caffe ceil-mode: out = ceil((size + 2*pad - k)/s) + 1; the last window
    may overhang, which we realize as extra bottom/right padding."""
    out = math.ceil((size + 2 * pad - k) / s) + 1
    # Caffe: if padded, clip the last window to start strictly inside.
    if pad > 0 and (out - 1) * s >= size + pad:
        out -= 1
    span = (out - 1) * s + k
    return pad, max(span - size - pad, 0)


def max_pool(x: jax.Array, k: int, s: int, pad: int = 0) -> jax.Array:
    """Caffe MAX pooling (ceil mode, -inf padding)."""
    ph = _ceil_pool_padding(x.shape[1], k, s, pad)
    pw = _ceil_pool_padding(x.shape[2], k, s, pad)
    # init must be a scalar literal so XLA dispatches to the differentiable
    # reduce_window_max primitive (array inits select the generic reducer,
    # which has no transpose rule under jit+grad)
    return jax.lax.reduce_window(
        x, -float("inf"), jax.lax.max, (1, k, k, 1), (1, s, s, 1),
        ((0, 0), ph, pw, (0, 0)),
    )


def avg_pool(x: jax.Array, k: int, s: int, pad: int = 0) -> jax.Array:
    """Caffe AVE pooling: zero padding, constant k*k denominator (padded
    zeros count — Caffe's pool_size is the window clipped to the *padded*
    bounds, which is k*k for every configuration this network uses)."""
    ph = _ceil_pool_padding(x.shape[1], k, s, pad)
    pw = _ceil_pool_padding(x.shape[2], k, s, pad)
    summed = jax.lax.reduce_window(
        x, 0.0, jax.lax.add,  # scalar literal: see max_pool note
        (1, k, k, 1), (1, s, s, 1), ((0, 0), ph, pw, (0, 0)),
    )
    return summed / jnp.array(k * k, x.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _conv_names(in_channels: int) -> list[tuple[str, int, int, int, int, int]]:
    """Every conv in topological order: (name, k, pad, stride, cin, cout)."""
    convs = [
        ("conv1/7x7_s2", 7, 3, 2, in_channels, 64),
        ("conv2/3x3_reduce", 1, 0, 1, 64, 64),
        ("conv2/3x3", 3, 1, 1, 64, 192),
    ]
    cin = 192
    for name, b in INCEPTION_BLOCKS:
        if b["c1"]:
            convs.append((f"{name}/1x1", 1, 0, 1, cin, b["c1"]))
        convs.append((f"{name}/3x3_reduce", 1, 0, 1, cin, b["r3"]))
        convs.append((f"{name}/3x3", 3, 1, b["stride"], b["r3"], b["c3"]))
        convs.append((f"{name}/double_3x3_reduce", 1, 0, 1, cin, b["rd"]))
        convs.append((f"{name}/double_3x3_1", 3, 1, 1, b["rd"], b["d1"]))
        convs.append((f"{name}/double_3x3_2", 3, 1, b["stride"], b["d1"], b["d2"]))
        if b["pp"]:
            convs.append((f"{name}/pool_proj", 1, 0, 1, cin, b["pp"]))
        cout = b["c1"] + b["c3"] + b["d2"] + (b["pp"] if b["pp"] else cin)
        cin = cout
    assert cin == EMBED_DIM, cin
    return convs


def init_params(
    key: jax.Array | int,
    in_channels: int = RGB_CHANNELS,
    num_classes: int = NUM_CLASSES,
    dtype=jnp.float32,
) -> dict[str, dict[str, jax.Array]]:
    """Xavier-initialized parameters in the BN-folded form:
    {caffe_layer_name: {'w': [kh,kw,cin,cout], 'b': [cout]}} + 'fc-action'.

    Host-side numpy generation (one device transfer at the end): generating
    70 tensors with per-op jax.random dispatch costs ~a minute on CPU."""
    if isinstance(key, (int, np.integer)):
        seed = int(key)
    else:
        seed = int(np.asarray(key).ravel()[-1])
    rng = np.random.default_rng(seed)
    np_dtype = np.dtype(jnp.dtype(dtype).name) if jnp.dtype(dtype) != jnp.bfloat16 else None
    def cast(a):
        # bfloat16 leaves stay float32 on host; the jit boundary casts once.
        return a.astype(np_dtype) if np_dtype is not None else a.astype(np.float32)
    params: dict[str, dict[str, np.ndarray]] = {}
    for name, k, _pad, _s, cin, cout in _conv_names(in_channels):
        fan_in, fan_out = k * k * cin, k * k * cout
        scale = np.sqrt(6.0 / (fan_in + fan_out))
        params[name] = {
            "w": cast(rng.uniform(-scale, scale, (k, k, cin, cout)).astype(np.float32)),
            "b": cast(np.zeros(cout, np.float32)),
        }
    params["fc-action"] = {
        "w": cast((rng.standard_normal((EMBED_DIM, num_classes))
                   / np.sqrt(EMBED_DIM)).astype(np.float32)),
        "b": cast(np.zeros(num_classes, np.float32)),
    }
    return params


def conv_shapes(in_channels: int = RGB_CHANNELS) -> dict[str, tuple]:
    return {name: (k, k, cin, cout) for name, k, _p, _s, cin, cout in _conv_names(in_channels)}


def fold_bn(
    conv_w: np.ndarray, conv_b: np.ndarray,
    scale: np.ndarray, shift: np.ndarray,
    mean: np.ndarray, var: np.ndarray, eps: float = 1e-5,
) -> tuple[np.ndarray, np.ndarray]:
    """Fold a frozen BN (y = scale*(x-mean)/sqrt(var+eps) + shift) into the
    preceding conv. All reference BNs are frozen, so this is exact."""
    inv = scale / np.sqrt(var + eps)
    return conv_w * inv.reshape(1, 1, 1, -1), (conv_b - mean) * inv + shift


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def _conv(params: Mapping, name: str, x: jax.Array, k: int, pad: int,
          stride: int, relu: bool = True) -> jax.Array:
    p = params[name]
    y = jax.lax.conv_general_dilated(
        x, p["w"].astype(x.dtype),
        window_strides=(stride, stride),
        padding=((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )
    y = y + p["b"].astype(jnp.float32)
    if relu:
        y = jax.nn.relu(y)
    return y.astype(x.dtype)


def _stem_s2d(params: Mapping, x: jax.Array) -> jax.Array:
    """conv1/7x7_s2 as a space-to-depth 4x4/s1 conv — the same math (up to
    summation order). A 3- or 10-channel 7x7 stride-2 conv feeds the
    matrix units a contraction depth of only 3 or 10 channels per tap;
    reshaping 2x2 pixel blocks into channels quarters the spatial positions
    and 4x's the contraction depth. On the H100 under cuDNN the whole
    6-member ensemble forward (200 images per stream, bf16) runs 92.3 ms
    with this stem against 95.9 ms with the plain conv (PERF.md).

    Derivation: out(oy,ox) = sum_{ky,kx} w[ky,kx] x[2oy-3+ky, 2ox-3+kx];
    with blocks X[i,j,(a,b,c)] = x[2i+a, 2j+b, c] the tap (ky,kx) lands in
    block (oy-2 + (ky+1)//2, ...) channel a=(ky+1)%2 — a 4x4 conv over X
    with padding (2,1) and the 7x7 kernel scattered (one zero tap row/col)."""
    p = params["conv1/7x7_s2"]
    w = p["w"].astype(x.dtype)                       # [7,7,C,64]
    c, cout = w.shape[2], w.shape[3]
    w8 = jnp.pad(w, ((1, 0), (1, 0), (0, 0), (0, 0)))  # ky' = ky+1 in [1,7]
    w2 = w8.reshape(4, 2, 4, 2, c, cout).transpose(0, 2, 1, 3, 4, 5)
    w2 = w2.reshape(4, 4, 4 * c, cout)
    n, h, wd, _ = x.shape
    xs = x.reshape(n, h // 2, 2, wd // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    xs = xs.reshape(n, h // 2, wd // 2, 4 * c)
    y = jax.lax.conv_general_dilated(
        xs, w2, window_strides=(1, 1), padding=((2, 1), (2, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )
    y = jax.nn.relu(y + p["b"].astype(jnp.float32))
    return y.astype(x.dtype)


def _inception(params: Mapping, name: str, b: Mapping, x: jax.Array) -> jax.Array:
    # straightforward per-branch convs: XLA and cuDNN schedule them
    branches = []
    if b["c1"]:
        branches.append(_conv(params, f"{name}/1x1", x, 1, 0, 1))
    r = _conv(params, f"{name}/3x3_reduce", x, 1, 0, 1)
    branches.append(_conv(params, f"{name}/3x3", r, 3, 1, b["stride"]))
    d = _conv(params, f"{name}/double_3x3_reduce", x, 1, 0, 1)
    d = _conv(params, f"{name}/double_3x3_1", d, 3, 1, 1)
    branches.append(_conv(params, f"{name}/double_3x3_2", d, 3, 1, b["stride"]))
    if b["stride"] == 1:
        pool = (avg_pool if b["pool"] == "ave" else max_pool)(x, 3, 1, 1)
        if b["pp"]:
            pool = _conv(params, f"{name}/pool_proj", pool, 1, 0, 1)
    else:
        pool = max_pool(x, 3, 2, 0)  # passthrough branch of reduction blocks
    branches.append(pool)
    return jnp.concatenate(branches, axis=-1)


def apply(
    params: Mapping[str, Mapping[str, jax.Array]],
    x: jax.Array,                      # NHWC, preprocessed (mean-subtracted)
    *,
    num_classes_head: bool = True,
    dropout_rng: jax.Array | None = None,
    dropout_rate: float = 0.8,         # rgb prototxt :742
) -> dict[str, jax.Array]:
    """Forward pass. Returns {'global_pool': [B, 1024], 'fc-action': [B, C]}.

    Dropout only applies when a dropout_rng is passed (training); the
    reference always runs caffe.TEST where dropout is identity
    (calcSig_wOF.py:44-46). Every conv runs on XLA's conv path (cuDNN on
    the GPU)."""
    if x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
        y = _stem_s2d(params, x)      # same math, deeper contraction
    else:                             # odd sizes: the plain strided conv
        y = _conv(params, "conv1/7x7_s2", x, 7, 3, 2)
    y = max_pool(y, 3, 2, 0)
    y = _conv(params, "conv2/3x3_reduce", y, 1, 0, 1)
    y = _conv(params, "conv2/3x3", y, 3, 1, 1)
    y = max_pool(y, 3, 2, 0)
    for name, b in INCEPTION_BLOCKS:
        y = _inception(params, name, b, y)
    # global_pool: 7x7 AVE (rgb prototxt :739-740)
    gp = jnp.mean(y.astype(jnp.float32), axis=(1, 2))  # [B, 1024]
    out = {"global_pool": gp}
    if num_classes_head:
        h = gp
        if dropout_rng is not None:
            keep = jax.random.bernoulli(dropout_rng, 1.0 - dropout_rate, h.shape)
            h = jnp.where(keep, h / (1.0 - dropout_rate), 0.0)
        p = params["fc-action"]
        out["fc-action"] = h @ p["w"].astype(jnp.float32) + p["b"].astype(jnp.float32)
    return out


def embed(params, x) -> jax.Array:
    """The 1024-d embedding (the `global_pool` blob)."""
    return apply(params, x, num_classes_head=False)["global_pool"]


# Jitted entry points — always call these (or wrap apply in your own jit):
# the unjitted forward dispatches ~300 eager ops and is ~30x slower even to
# *compile* than one fused program.
forward = jax.jit(apply, static_argnames=("num_classes_head", "dropout_rate"))
embed_jit = jax.jit(embed)
