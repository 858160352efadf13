"""Aux subsystems: profiling timers, checkpoint round-trip, config env."""

import os

import jax
import numpy as np
import pytest

from videoquery.core.config import BrokerConfig, HyperParams, compute_eps, random_seed
from videoquery.core.profiling import StageTimer


def test_stage_timer_accumulates():
    import time

    t = StageTimer()
    with t.stage("a") as h:
        h.value = jax.numpy.ones((4,))
        time.sleep(0.01)
    with t.stage("a"):
        time.sleep(0.01)
    assert t.counts["a"] == 2
    assert t.totals["a"] >= 0.02
    assert "a" in t.report()


def test_checkpoint_roundtrip(tmp_path):
    from videoquery.nn import bn_inception
    from videoquery.train.checkpoint import load_train_state, save_train_state
    from videoquery.train.trainer import TrainConfig, make_optimizer

    params = bn_inception.init_params(0, num_classes=5)
    opt_state = make_optimizer(TrainConfig(num_classes=5)).init(
        jax.tree.map(jax.numpy.asarray, params))
    path = str(tmp_path / "ckpt")
    save_train_state(path, params, opt_state, step=7)
    state = load_train_state(path, like={"params": params,
                                         "opt_state": opt_state,
                                         "step": np.asarray(7)})
    assert int(state["step"]) == 7
    np.testing.assert_allclose(
        np.asarray(state["params"]["conv1/7x7_s2"]["w"]),
        np.asarray(params["conv1/7x7_s2"]["w"]),
    )


def test_compute_eps_env(monkeypatch):
    monkeypatch.setenv("COMPUTE_EPS", "1e-4")
    assert compute_eps() == 1e-4
    monkeypatch.setenv("COMPUTE_EPS", "None")
    assert compute_eps() == 1e-6  # default when unset/None


def test_random_seed_env(monkeypatch):
    monkeypatch.setenv("RANDOM_SEED", "None")
    assert random_seed() is None
    monkeypatch.setenv("RANDOM_SEED", "42")
    assert random_seed() == 42
    monkeypatch.setenv("RANDOM_SEED", "hello")
    assert random_seed() == "hello"


def test_broker_config_env(monkeypatch):
    monkeypatch.setenv("BASE_URL", "http://x:1/")
    monkeypatch.setenv("BROKER_THREADING", "True")
    cfg = BrokerConfig.from_env()
    assert cfg.base_url == "http://x:1/"
    assert cfg.threading is True


def test_hyperparams_validation():
    with pytest.raises(ValueError):
        HyperParams(bootstrap_type="bogus")
    with pytest.raises(ValueError):
        HyperParams(f_bootstrap=0.0)
    with pytest.raises(ValueError):
        HyperParams(ballast=1.0)


def test_device_put_tree_roundtrip(rng):
    """Packed pytree transfer preserves values, shapes, dtypes, structure."""
    from videoquery.core.transfer import device_put_tree

    tree = {
        "a": {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)},
        "c": [np.arange(6, dtype=np.int32).reshape(2, 3),
              rng.normal(size=(4,)).astype(np.float64)],
        "d": np.asarray(True),
    }
    out = jax.tree.map(lambda x: x, device_put_tree(tree))
    assert jax.tree.structure(out) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(out), jax.tree.leaves(tree)):
        # dtypes follow jax.device_put semantics (f64 canonicalizes to f32
        # without x64 mode)
        expect = jax.device_put(want)
        assert np.asarray(got).dtype == np.asarray(expect).dtype
        np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                                   rtol=0, atol=0)


def test_device_put_tree_empty():
    from videoquery.core.transfer import device_put_tree

    assert device_put_tree({}) == {}


def test_device_put_tree_unpack_program_cached(rng):
    """The compiled unpack program is reused across calls with the same leaf
    shapes (jit caches by callable identity, so a per-call closure would
    re-trace on every call)."""
    from videoquery.core import transfer

    tree = (rng.normal(size=(2, 3)).astype(np.float32),
            rng.normal(size=(5,)).astype(np.float32))
    transfer.device_put_tree(tree)
    fn1 = transfer._unpack_program(np.float32, ((2, 3), (5,)))
    transfer.device_put_tree(tree)
    fn2 = transfer._unpack_program(np.float32, ((2, 3), (5,)))
    assert fn1 is fn2
    # distinct shapes get their own program
    fn3 = transfer._unpack_program(np.float32, ((3, 2), (5,)))
    assert fn3 is not fn1


def test_similarity_count_packing_roundtrip():
    """The [S+1, N] digit-packed similarity download reconstructs every
    per-stream ensemble count exactly, including the maximum (all splits
    present) and zero (clip missing from a stream)."""
    import jax.numpy as jnp

    from videoquery.search.engine import _COUNT_RADIX, _pack_f32, _unpack_counts

    s, n = 2, 17
    rng_ = np.random.default_rng(3)
    avg = rng_.normal(size=(s, n)).astype(np.float32)
    counts = rng_.integers(0, _COUNT_RADIX, size=(s, n)).astype(np.int32)
    counts[0, 0] = 0
    counts[1, 0] = _COUNT_RADIX - 1
    packed = np.asarray(_pack_f32(jnp.asarray(avg), jnp.asarray(counts)))
    assert packed.shape == (s + 1, n)
    np.testing.assert_array_equal(packed[:s], avg)
    np.testing.assert_array_equal(_unpack_counts(packed[s], s), counts)


def test_stream_ensemble_from_npz(tmp_path, rng):
    """Converter npz bundles wire into a StreamEnsemble (the extract
    --weights path)."""
    from videoquery.nn import bn_inception
    from videoquery.nn.convert_caffe import load_npz, save_npz
    from videoquery.nn.tsn import StreamEnsemble

    split_params = {}
    for split in (1, 2):
        p = bn_inception.init_params(split, in_channels=3, num_classes=5)
        path = str(tmp_path / f"rgb_split{split}.npz")
        save_npz(p, path)
        split_params[split] = jax.tree.map(jax.numpy.asarray, load_npz(path))
    ens = StreamEnsemble.from_split_params(split_params, in_channels=3)
    x = jax.numpy.ones((1, 64, 64, 3))
    emb = np.asarray(ens.embed(x))
    assert emb.shape == (2, 1, 1024)
    assert np.isfinite(emb).all()
    # split stacking preserved per-split weights (biases are zero-init, so
    # compare the conv weights specifically)
    w1 = np.asarray(ens.stacked_params["conv1/7x7_s2"]["w"])
    assert not np.allclose(w1[0], w1[1])
