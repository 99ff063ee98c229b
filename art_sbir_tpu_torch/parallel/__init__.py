"""Device meshes for the row-sharded gallery (single process, one list of
devices); counterpart of ``art_sbir_tpu/parallel``'s data axis."""

from art_sbir_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, MeshSpec,
                                              data_mesh, mesh_from_args,
                                              pad_to_multiple, shard_rows,
                                              split_batch)

__all__ = ["DATA_AXIS", "Mesh", "MeshSpec", "data_mesh", "mesh_from_args",
           "pad_to_multiple", "shard_rows", "split_batch"]
