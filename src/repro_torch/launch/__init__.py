"""Process groups of the port: one rank per shard on ``torch.distributed``
(the counterpart of the reference's ``launch/mesh.py`` meshes)."""
