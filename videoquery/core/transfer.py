"""Batched host->device transfers.

device_put_tree packs all leaves of a pytree into one flat buffer per
dtype, uploads each buffer once, and carves the leaves back out on device
inside a single jitted program: O(#dtypes) transfers instead of
O(#leaves), so a pytree of many small arrays pays the per-transfer cost
once.
"""

from __future__ import annotations

import jax
import numpy as np

# Compiled unpack programs keyed by (dtype, leaf shapes). jit caches by
# callable IDENTITY, so a closure defined per call would re-trace (and look
# up the compile cache) on every call.
_UNPACK_CACHE: dict[tuple, object] = {}


def _unpack_program(dtype: np.dtype, shapes: tuple[tuple[int, ...], ...]):
    key = (np.dtype(dtype).str, shapes)
    fn = _UNPACK_CACHE.get(key)
    if fn is None:
        import math

        sizes = tuple(math.prod(s) for s in shapes)
        offsets = tuple(np.cumsum((0,) + sizes[:-1]).tolist())

        def unpack(b):
            # static slicing inside one jit -> one compiled unpack program
            return [
                jax.lax.dynamic_slice_in_dim(b, o, s).reshape(shp)
                for o, s, shp in zip(offsets, sizes, shapes)
            ]

        fn = _UNPACK_CACHE[key] = jax.jit(unpack)
    return fn


def put_global(x, sharding):
    """device_put that also works under multi-process jax.distributed.

    With a sharding that spans non-addressable devices (a real multi-host
    mesh, or the 2-process virtual-CPU test harness), jax.device_put cannot
    place remote shards — every process instead supplies its local shards
    from the SAME host array via make_array_from_callback (the standard
    multihost ingest pattern; callers guarantee all processes pass equal
    data, which the deterministic index/target builders do)."""
    if getattr(sharding, "is_fully_addressable", True):
        return jax.device_put(x, sharding)
    arr = np.asarray(x)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def device_put_tree(tree, sharding=None):
    """Transfer an arbitrary (numpy/jax) pytree to device with O(#dtypes)
    transfers instead of O(#leaves)."""
    leaves, treedef = jax.tree.flatten(tree)
    if not leaves:
        return tree
    host = [np.asarray(l) for l in leaves]
    by_dtype: dict[np.dtype, list[int]] = {}
    for i, l in enumerate(host):
        by_dtype.setdefault(l.dtype, []).append(i)

    out: list = [None] * len(host)
    for dtype, idxs in by_dtype.items():
        flat = np.concatenate([host[i].ravel() for i in idxs])
        buf = put_global(flat, sharding) if sharding is not None \
            else jax.device_put(flat)
        pieces = _unpack_program(dtype, tuple(host[i].shape for i in idxs))(buf)
        for i, piece in zip(idxs, pieces):
            out[i] = piece
    return jax.tree.unflatten(treedef, out)
