"""Worker process for the 2-process multi-host test harness.

Each worker owns 4 virtual CPU devices and joins an 8-device global mesh
via jax.distributed (Gloo CPU collectives) — the DCN-style process
boundary the reference's MPI Caffe build implied but never exercised
(features_GPU_compute/Dockerfile:37-53; SURVEY.md §5.8). It runs the two
SPMD programs whose collectives cross the boundary:

  1. ShardedSearch top-k (index sharded over "data", shard-local top-k +
     all-gather reduction),
  2. one TSNTrainer step (batch sharded over "data", params replicated,
     XLA-inserted gradient all-reduce),

on a deterministic world (seed 0) and writes its results to --out as JSON
so the spawning test can assert both workers agree AND match a
single-process run bit-for-bit (tests/test_multihost.py).

Run (each in its own process):
  python -m videoquery.testing.multihost_worker \
      --coordinator 127.0.0.1:29500 --nprocs 2 --pid {0,1} --out r{0,1}.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--devices_per_proc", type=int, default=4)
    args = ap.parse_args()

    # virtual CPU devices + forced cpu platform BEFORE any backend touch
    # (conftest.py pattern)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
                    f"{args.devices_per_proc}").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:  # Gloo is the default CPU collectives impl on this stack; pin it
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass

    from videoquery.core.meshes import initialize_multihost

    initialize_multihost(args.coordinator, args.nprocs, args.pid)
    n_global = args.nprocs * args.devices_per_proc
    assert jax.device_count() == n_global, jax.devices()
    assert len(jax.local_devices()) == args.devices_per_proc

    result = run_world(jax)
    result["device_count"] = jax.device_count()
    result["local_devices"] = len(jax.local_devices())
    result["process_id"] = args.pid
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(f"[worker {args.pid}] ok", flush=True)
    jax.distributed.shutdown()


def run_world(jax) -> dict:
    """The deterministic SPMD world — identical in single- and 2-process
    runs (tests compare outputs across the two)."""
    import numpy as np

    from videoquery.core.meshes import make_mesh
    from videoquery.index.store import FeatureIndex, FeatureRecord
    from videoquery.nn import bn_inception
    from videoquery.search.distributed import ShardedSearch
    from videoquery.train.trainer import TrainConfig, TSNTrainer

    # 2-D mesh (data=4, model=2): with 4 devices per process the data axis
    # crosses the process boundary, so the search all-gather and the
    # gradient psum both ride the inter-process link
    mesh = make_mesh(model_parallel=2)
    rng = np.random.default_rng(0)
    streams = ("rgb", "warped_optical_flow")
    records = [
        FeatureRecord(cid, s, k, "global_pool", rng.normal(size=16))
        for cid in range(1, 41) for s in streams for k in (1, 2)
    ]
    index = FeatureIndex.build(records, streams, feature_dim=16,
                               pad_multiple=8)
    search = ShardedSearch(index, mesh)
    targets = [
        {s: {k: rng.normal(size=16).tolist() for k in (1, 2)}
         for s in streams}
        for _ in range(3)
    ]
    weights = [{"rgb": 1.0, "warped_optical_flow": 1.5}] * 3
    vals, ids = search.query_dicts(targets, weights, k=5)

    cfg = TrainConfig(num_segments=2, num_classes=7, dropout_rate=0.5)
    params = bn_inception.init_params(0, in_channels=3, num_classes=7)
    trainer = TSNTrainer(params, cfg, mesh=mesh)
    frames = rng.normal(size=(8, 2, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 7, size=(8,))
    metrics = trainer.step(frames, labels, jax.random.PRNGKey(0))
    m2 = trainer.step(frames, labels, jax.random.PRNGKey(1))

    return {
        "topk_vals": np.asarray(vals).tolist(),
        "topk_ids": np.asarray(ids).tolist(),
        "loss": float(metrics["loss"]),
        "accuracy": float(metrics["accuracy"]),
        "loss2": float(m2["loss"]),
    }


if __name__ == "__main__":
    sys.exit(main())
