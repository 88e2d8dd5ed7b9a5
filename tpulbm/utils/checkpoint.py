"""Checkpoint / resume — a capability the reference lacks entirely
(SURVEY §5: "a 120k-step run that dies restarts from scratch").

The whole simulation state is one population array plus the step counter.
Two formats:

  * single-device runs: one .npz with the params JSON embedded for a
    consistency check on restore (`save`/`load`);
  * multi-device runs: a `ckpt_<step>/` directory with ONE .npz per
    process holding only that process's addressable shards, plus a
    manifest.json written last by process 0 (its presence marks the
    checkpoint complete). Saving never materializes the global array on
    any host — at 256³ f32 that is ~1.3 GB per process — and
    restoring device_puts each shard straight to its device
    (`save_sharded`/`load_sharded`).

Written at chunk boundaries by the runner.
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil

import numpy as np

from ..config import SimulationParams

_PAT = re.compile(r"ckpt_(\d+)\.npz$")
_PAT_DIR = re.compile(r"ckpt_(\d+)$")

# Fields that do not change the physics of the trajectory: safe to differ
# between the checkpointing run and the resuming run. Everything else
# (grid, tau, velocities, BC/collision choices, body force, precision, …)
# must match — resuming with different physics silently mixes two
# simulations (the inlet velocity even shapes the frozen ghost ring).
_RUNTIME_FIELDS = frozenset({
    "num_timesteps", "output_frequency", "vtk_start_step",
    "mesh_shape", "checkpoint_every", "checkpoint_dir", "output_dir",
    "enable_vtk", "vtk_format",
    # observers, not physics: a resume may start/continue statistics
    # (saved accumulators are restored when present)
    "stats_from",
})


def save(ckpt_dir: str, step: int, f: np.ndarray,
         params: SimulationParams, keep: int = 3,
         stats: dict | None = None) -> str:
    """stats: optional host arrays (the runner's Reynolds-statistics
    accumulators — count/first/s_rho/s_u/s_uu) stored under stats_*
    keys so a resumed run continues accumulation instead of restarting
    the sample window."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:09d}.npz")
    tmp = path + ".tmp"
    extra = {f"stats_{k}": np.asarray(v) for k, v in (stats or {}).items()}
    with open(tmp, "wb") as fh:
        np.savez(fh, f=np.asarray(f), step=np.int64(step),
                 params_json=np.bytes_(params.to_json().encode()), **extra)
    os.replace(tmp, path)  # atomic publish
    for old in sorted(glob.glob(os.path.join(ckpt_dir, "ckpt_*.npz")))[:-keep]:
        os.remove(old)
    return path


def latest(ckpt_dir: str) -> str | None:
    """Newest complete checkpoint: either a ckpt_<step>.npz file or a
    ckpt_<step>/ shard directory whose manifest.json exists (shard files
    without a manifest are an interrupted save — ignored)."""
    cands = []
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*")):
        m = _PAT.search(p)
        if m:
            cands.append((int(m.group(1)), p))
            continue
        m = _PAT_DIR.search(p)
        if m and os.path.exists(os.path.join(p, "manifest.json")):
            cands.append((int(m.group(1)), p))
    return max(cands)[1] if cands else None


def _shard_key(index) -> str:
    """Stable key for one shard's global placement: offsets per axis."""
    return "shard_" + "_".join(str(sl.start or 0) for sl in index)


def save_sharded(ckpt_dir: str, step: int, f, params: SimulationParams,
                 keep: int = 3, stats: dict | None = None,
                 stats_scalars: dict | None = None) -> str:
    """Per-shard checkpoint of a sharded jax.Array: each process writes one
    .npz with ONLY its addressable shards (O(local) host RAM and I/O), then
    — after a barrier, so no manifest can precede a peer's shard file — its
    own copy of manifest.json, whose presence publishes the checkpoint.

    The manifest (the global key→file map) is derivable from the sharding
    alone, so every process writes IDENTICAL bytes: on a shared filesystem
    the per-process .tmp names make the duplicate publishes harmless; on
    per-host filesystems each host ends up with its own shards plus a full
    manifest, which is exactly what load_sharded needs there."""
    import jax

    path = os.path.join(ckpt_dir, f"ckpt_{step:09d}")
    os.makedirs(path, exist_ok=True)
    pid = jax.process_index()
    arrays = {_shard_key(s.index): np.asarray(s.data)
              for s in f.addressable_shards}
    # sharded statistics accumulators (name → sharded jax.Array): stored
    # in the same per-process file under "<name>|<shard_key>" keys
    stats_meta = {}
    for name, arr in (stats or {}).items():
        for s in arr.addressable_shards:
            arrays[f"{name}|{_shard_key(s.index)}"] = np.asarray(s.data)
        stats_meta[name] = {
            "global_shape": list(arr.shape), "dtype": str(arr.dtype),
            "files": {_shard_key(idx): f"proc_{d.process_index:05d}.npz"
                      for d, idx in
                      arr.sharding.devices_indices_map(arr.shape).items()}}
    fpath = os.path.join(path, f"proc_{pid:05d}.npz")
    tmp = fpath + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, fpath)

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(f"tpulbm_ckpt_{step}")
    files = {_shard_key(idx): f"proc_{d.process_index:05d}.npz"
             for d, idx in
             f.sharding.devices_indices_map(f.shape).items()}
    manifest = {"step": int(step), "params": params.to_dict(),
                "global_shape": list(f.shape), "dtype": str(f.dtype),
                "files": files}
    if stats_meta:
        manifest["stats"] = stats_meta
    if stats_scalars:
        # replicated scalars (sample count, first sampled step)
        manifest["stats_scalars"] = {k: float(v)
                                     for k, v in stats_scalars.items()}
    mtmp = os.path.join(path, f"manifest.json.tmp{pid}")
    with open(mtmp, "w") as fh:
        json.dump(manifest, fh, indent=1)
    os.replace(mtmp, os.path.join(path, "manifest.json"))
    # prune old checkpoints (files or shard dirs) beyond `keep`; on a
    # shared filesystem peers race to remove the same dirs — ignore losses
    cands = []
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*")):
        m = _PAT.search(p) or _PAT_DIR.search(p)
        if m:
            cands.append((int(m.group(1)), p))
    for _, old in sorted(cands)[:-keep]:
        try:
            shutil.rmtree(old) if os.path.isdir(old) else os.remove(old)
        except OSError:
            pass
    return path


def check_manifest(path: str, params: SimulationParams | None = None) -> int:
    """Validate a per-shard checkpoint directory's manifest (params
    compatibility) without touching the shard data; returns the saved
    step. Used by the runner's process-0 resume decision."""
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    if params is not None:
        _check_params(path, SimulationParams.from_dict(manifest["params"]),
                      params)
    return int(manifest["step"])


def _load_one_sharded(path: str, mesh, spec, shape, files: dict,
                      key_prefix: str = ""):
    """Assemble one sharded jax.Array from a shard-checkpoint directory:
    each process reads only the files holding its addressable shards and
    device_puts them directly (the global array is never materialized)."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    per_file: dict[str, list] = {}
    for d, idx in sharding.addressable_devices_indices_map(shape).items():
        key = _shard_key(idx)
        try:
            fname = files[key]
        except KeyError:
            raise ValueError(
                f"checkpoint {path} has no shard at offsets {key!r} — it "
                f"was saved with an incompatible mesh "
                f"(saved files: {sorted(set(files))[:4]}…)")
        per_file.setdefault(fname, []).append((d, key_prefix + key))
    shards = []
    for fname, wants in per_file.items():
        with np.load(os.path.join(path, fname)) as data:
            for d, key in wants:
                shards.append(jax.device_put(data[key], d))
    return jax.make_array_from_single_device_arrays(shape, sharding, shards)


def load_sharded(path: str, mesh, spec,
                 params: SimulationParams | None = None,
                 extras: bool = False):
    """Restore (step, f) from a per-shard checkpoint directory onto `mesh`
    with PartitionSpec `spec` (the restoring mesh need not match the
    saving one as long as the shard boundaries line up — a mismatch
    raises on the offset lookup). extras=True additionally returns the
    statistics-accumulator dict (sharded arrays restored with specs
    derived from their rank: trailing axes follow `spec`'s y/x, leading
    axes are replicated) or None."""
    from jax.sharding import PartitionSpec as P

    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    saved = SimulationParams.from_dict(manifest["params"])
    if params is not None:
        _check_params(path, saved, params)
    shape = tuple(manifest["global_shape"])
    f = _load_one_sharded(path, mesh, spec, shape, manifest["files"])
    if not extras:
        return int(manifest["step"]), f
    stats = None
    if "stats" in manifest:
        tail = [ax for ax in spec if ax is not None][-2:]  # ('y', 'x')
        stats = {}
        for name, meta in manifest["stats"].items():
            sshape = tuple(meta["global_shape"])
            sspec = P(*((None,) * (len(sshape) - 2) + tuple(tail)))
            stats[name] = _load_one_sharded(path, mesh, sspec, sshape,
                                            meta["files"],
                                            key_prefix=f"{name}|")
        for k, v in manifest.get("stats_scalars", {}).items():
            stats[k] = v
    return int(manifest["step"]), f, stats


def _check_params(path: str, saved: SimulationParams,
                  params: SimulationParams) -> None:
    saved_d, run_d = saved.to_dict(), params.to_dict()
    for field in sorted(set(saved_d) & set(run_d) - _RUNTIME_FIELDS):
        if saved_d[field] != run_d[field]:
            raise ValueError(
                f"checkpoint {path} was written with {field}="
                f"{saved_d[field]!r}, run has {run_d[field]!r}")


def load(path: str, params: SimulationParams | None = None,
         extras: bool = False):
    """Returns (step, f) — or (step, f, stats_dict_or_None) with
    extras=True. If params given, verifies grid compatibility."""
    with np.load(path) as data:
        f = data["f"]
        step = int(data["step"])
        saved = SimulationParams.from_json(bytes(data["params_json"]).decode())
        stats = {k[len("stats_"):]: data[k] for k in data.files
                 if k.startswith("stats_")} or None
    if params is not None:
        _check_params(path, saved, params)
    return (step, f, stats) if extras else (step, f)
