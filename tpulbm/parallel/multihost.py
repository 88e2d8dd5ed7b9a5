"""Multi-host gather and rank-0 I/O semantics.

The equivalent of the reference's MPI_Gather/Gatherv reassembly on
rank 0 (LBMSolver.h:289-337, LBMIO.h:237-283) and its rank-0-only file
handling (LBMIO.h:35-46): on a multi-host run (`jax.process_count() > 1`)
the shards of a global array are not all addressable from one process, so
host fetches go through `multihost_utils.process_allgather`; files are
written by process 0 only. Single-process runs keep the zero-copy
`jax.device_get` path.
"""
from __future__ import annotations

import jax
import numpy as np


def is_primary() -> bool:
    """The rank-0 analog: the process that owns file writes and banners."""
    return jax.process_index() == 0


def fetch_global(x) -> np.ndarray:
    """Host NumPy copy of a global (possibly non-addressable) device array.

    Every process receives the full array (process_allgather semantics —
    the reference only materializes on rank 0, but the symmetric gather is
    what XLA collectives provide and callers gate file writes on
    is_primary())."""
    if jax.process_count() == 1:
        return np.asarray(jax.device_get(x))
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def fetch_tree(tree):
    """fetch_global over a pytree (e.g. the (rho, u) fields tuple)."""
    return jax.tree_util.tree_map(fetch_global, tree)
