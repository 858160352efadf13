"""Comparisons that need the GPU (they skip on the CPU harness; chip_smoke.py
runs the same comparisons at full size). Run on a card with
VIDEOQUERY_TESTS_ON_CARD=1 python -m pytest tests/ -m gpu."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_flow_on_card_matches_cpu(gpu, rng):
    """Quantized warped flow of a small warm-started pair plan: the card
    and the CPU agree within one u8 step on >= 99% of values."""
    from videoquery.kernels.tvl1 import TVL1Params
    from videoquery.pipeline.extract import _pair_flow
    from videoquery.pipeline.sampling import flow_warm_plan

    base = rng.random((80, 160)).astype(np.float32)
    gray = np.stack([np.roll(base, 2 * t, axis=1) for t in range(8)])[None]
    pairs = np.arange(7, dtype=np.int32)
    plan = flow_warm_plan(pairs, 3)
    p = TVL1Params(n_scales=3, n_warps=2, n_iters=10,
                   camera_model="homography", coarse_hw=(48, 64))
    fn = jax.jit(_pair_flow, static_argnames=(
        "bound", "warped", "tvl1", "value_scale", "warm_camera"))
    out = {}
    for dev in (gpu, jax.devices("cpu")[0]):
        args = jax.device_put((gray, pairs, plan), dev)
        out[dev.platform] = np.asarray(fn(
            args[0], args[1], bound=20.0, warped=True, tvl1=p,
            value_scale=(1.0, 1.0), warm_plan=args[2], warm_camera="init"))
    step = np.abs(out["gpu"].astype(int) - out["cpu"].astype(int))
    assert (step <= 1).mean() >= 0.99


def test_similarity_on_card_has_no_tf32(gpu, rng):
    """The similarity einsum runs at full f32 on the card (Precision.HIGHEST):
    it matches float64 to ~1e-6, where TF32 products would err ~1e-3."""
    from videoquery.search.scoring import ensemble_similarities

    feats = rng.normal(size=(2, 3, 4096, 1024)).astype(np.float32) / 32
    targets = rng.normal(size=(2, 3, 1024)).astype(np.float32) / 32
    avg, _ = ensemble_similarities(
        jax.device_put(targets, gpu), jnp.ones((2, 3), bool),
        jax.device_put(feats, gpu), jnp.ones((2, 3, 4096), bool))
    want = np.einsum("sknd,skd->skn", feats.astype(np.float64),
                     targets.astype(np.float64)).mean(axis=1)
    np.testing.assert_allclose(np.asarray(avg), want, atol=1e-6)
