"""The port's parallel layer: meshes of torch devices (mesh.py), the sorts
and the suffix-array construction sharded over a mesh
(sort_distributed.py), and the multi-process merge over torch.distributed
with the host functions of the sharded merge output (distributed.py)."""
