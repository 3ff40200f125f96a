"""Stage-boundary checkpoint / resume.

The SDK-level analog is full DPU context checkpointing
(`dpu_checkpoint.h:20-84`: area-selective WRAM/MRAM/IRAM/register
save/restore, byte serialization) which the reference app never exercises.
The engine's equivalent (SURVEY.md section 5 "Checkpoint / resume"):
persist the columnar state at pipeline stage boundaries plus a manifest
recording the pipeline cursor, and resume by re-entering the pipeline at
the last completed stage.

Format: one ``.npz`` per stage (data + counts arrays) plus ``manifest.json``
with the stage sequence, shapes, dtype and config fingerprint. Works for
both single-device `Table` and mesh-sharded `ShardedTable` (device arrays
are gathered to host; on restore they are re-placed with the pipeline's
current sharding, so a checkpoint taken at one mesh size can resume at
another -- elasticity the reference cannot express).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import jax
import numpy as np

from pim_sort_merge_join_tpu.columnar.table import Table

_MANIFEST = "manifest.json"


class StageCheckpointer:
    """Writes/reads per-stage table snapshots under a directory."""

    def __init__(self, directory: str, config_fingerprint: str = ""):
        self.directory = directory
        self.fingerprint = config_fingerprint
        os.makedirs(directory, exist_ok=True)

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, _MANIFEST)

    def _load_manifest(self) -> dict[str, Any]:
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
            if m.get("fingerprint") != self.fingerprint:
                return {"fingerprint": self.fingerprint, "stages": {}}
            return m
        except (FileNotFoundError, json.JSONDecodeError):
            return {"fingerprint": self.fingerprint, "stages": {}}

    def _store_manifest(self, manifest: dict[str, Any]) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, self._manifest_path())  # atomic commit

    # -- save / restore ----------------------------------------------------
    def save(self, stage: str, **tables) -> None:
        """Persist named tables (Table or ShardedTable) for a stage.

        Multi-process contract: EVERY process must call this with the same
        stage (gathering sharded state is a collective), but only process 0
        writes the files -- concurrent writers to a shared checkpoint
        directory would race. ``checkpoint_dir`` must be storage process 0
        can write and every process can read on resume.
        """
        manifest = self._load_manifest()
        entry: dict[str, Any] = {"ts": time.time(), "tables": {}}
        write = jax.process_index() == 0
        for name, t in tables.items():
            path = os.path.join(self.directory, f"{stage}.{name}.npz")
            payload = _table_to_host(t)  # collective for sharded tables
            if write:
                np.savez(path, **payload["arrays"])
            entry["tables"][name] = {
                "file": os.path.basename(path),
                "kind": payload["kind"],
                "names": payload["names"],
            }
        manifest["stages"][stage] = entry
        if write:
            self._store_manifest(manifest)

    def _stages_view(self) -> list[str]:
        """Process-0's view of completed stages, replicated to every process.

        With non-shared (or cache-inconsistent, e.g. NFS) storage, each
        process reading its own manifest.json could resolve resume
        decisions differently and diverge the SPMD program (skip vs re-run
        a collective exchange). Only process 0 writes the manifest, so its
        view is authoritative; broadcast it. In multi-process runs this is
        a COLLECTIVE -- every process must call has()/completed_stages()
        at the same program point (the resumable runner already does).
        """
        local = list(self._load_manifest()["stages"].keys())
        if jax.process_count() == 1:
            return local
        from jax.experimental import multihost_utils

        payload = np.frombuffer(
            json.dumps(local).encode("utf-8"), dtype=np.uint8
        )
        n = int(
            multihost_utils.broadcast_one_to_all(
                np.int32(payload.size)
            )
        )
        buf = np.zeros(n, dtype=np.uint8)
        if jax.process_index() == 0:
            buf[:] = payload
        buf = np.asarray(multihost_utils.broadcast_one_to_all(buf))
        return json.loads(buf.tobytes().decode("utf-8"))

    def has(self, stage: str) -> bool:
        return stage in self._stages_view()

    def completed_stages(self) -> list[str]:
        return self._stages_view()

    def load(self, stage: str) -> dict[str, Any]:
        """Load a stage's tables as host payloads: {name: (kind, arrays, names)}."""
        manifest = self._load_manifest()
        if stage not in manifest["stages"]:
            raise KeyError(f"no checkpoint for stage {stage!r}")
        out = {}
        for name, meta in manifest["stages"][stage]["tables"].items():
            with np.load(os.path.join(self.directory, meta["file"])) as z:
                arrays = {k: z[k] for k in z.files}
            out[name] = {
                "kind": meta["kind"],
                "arrays": arrays,
                "names": tuple(meta["names"]),
            }
        return out

    def load_table(self, stage: str, name: str) -> Table:
        """Restore a single-device Table from a checkpoint."""
        payload = self.load(stage)[name]
        arrays = payload["arrays"]
        import jax.numpy as jnp

        return Table(
            data=jnp.asarray(arrays["data"]),
            num_rows=jnp.asarray(arrays["num_rows"]),
            names=payload["names"],
        )

    def load_sharded(self, stage: str, name: str, mesh, axis: str):
        """Restore a ShardedTable onto ``mesh``.

        Post-exchange checkpoints are co-partitioned by key range; shard i's
        rows only join against shard i's rows, so restore requires the same
        partition count (a different mesh size needs a fresh exchange)."""
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec

        from pim_sort_merge_join_tpu.engine.distributed import ShardedTable

        payload = self.load(stage)[name]
        if payload["kind"] != "sharded":
            raise TypeError(f"checkpoint {stage}.{name} is not sharded")
        arrays = payload["arrays"]
        p = mesh.shape[axis]
        if arrays["counts"].shape[0] != p:
            raise ValueError(
                f"checkpoint has {arrays['counts'].shape[0]} shards; mesh "
                f"axis {axis!r} has {p} -- resume on the same partition "
                "count or re-run the exchange"
            )
        data = jnp.asarray(arrays["data"])
        counts = jnp.asarray(arrays["counts"])
        placed_data = jax.make_array_from_callback(
            data.shape,
            NamedSharding(mesh, PartitionSpec(axis, None)),
            lambda i: data[i],
        )
        placed_counts = jax.make_array_from_callback(
            counts.shape,
            NamedSharding(mesh, PartitionSpec(axis)),
            lambda i: counts[i],
        )
        return ShardedTable(
            data=placed_data, counts=placed_counts, names=payload["names"]
        )


def _table_to_host(t) -> dict[str, Any]:
    from pim_sort_merge_join_tpu.engine.distributed import ShardedTable

    if isinstance(t, Table):
        return {
            "kind": "table",
            "names": list(t.names),
            "arrays": {
                "data": np.asarray(jax.device_get(t.data)),
                "num_rows": np.asarray(jax.device_get(t.num_rows)),
            },
        }
    if isinstance(t, ShardedTable):
        # _host_arrays replicates across processes first when the global
        # array is not fully addressable (multi-process mesh) -- a bare
        # device_get would raise there. Collective in that case: every
        # process must checkpoint the same stage.
        data, counts = t._host_arrays()
        return {
            "kind": "sharded",
            "names": list(t.names),
            "arrays": {"data": data, "counts": counts},
        }
    raise TypeError(f"cannot checkpoint {type(t)!r}")


def config_fingerprint(config) -> str:
    """Stable fingerprint of the parts of the config that affect state."""
    d = dataclasses.asdict(config)
    return json.dumps(d, sort_keys=True, default=str)
