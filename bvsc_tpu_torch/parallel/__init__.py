"""Parallelism across devices (port of ``bvsc_tpu/parallel/``): meshes and
the process group (``mesh``), the exchanges built from ``all_reduce`` and
``broadcast`` (``collectives``), tensor-parallel BVRNN scans (``tp``), the
sequence-parallel vocoder (``sp``), the two-stage pipeline (``pp``) and the
multi-rank dry run (``dryrun``).  The serving engines take a ``mesh=``,
the trainers a mesh's process group for data parallelism."""

from bvsc_tpu_torch.parallel.mesh import (Mesh, batch_sharded, init_distributed, make_mesh,
                                          replicated, shard_batch)

__all__ = ["Mesh", "batch_sharded", "init_distributed", "make_mesh", "replicated",
           "shard_batch"]
