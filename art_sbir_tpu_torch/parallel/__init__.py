"""Device meshes for the row-sharded gallery (single process, one list of
devices), data-parallel training (one process a device,
:mod:`~art_sbir_tpu_torch.parallel.multihost`) and tensor-parallel
training over a ``(data, model)`` grid of such processes
(:mod:`~art_sbir_tpu_torch.parallel.tensor`); counterpart of
``art_sbir_tpu/parallel``."""

from art_sbir_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, MeshSpec,
                                              batch_rows, data_mesh,
                                              mesh_from_args,
                                              pad_to_multiple,
                                              shard_or_replicate, shard_rows,
                                              split_batch)

__all__ = ["DATA_AXIS", "Mesh", "MeshSpec", "batch_rows", "data_mesh",
           "mesh_from_args", "pad_to_multiple", "shard_or_replicate",
           "shard_rows", "split_batch"]
