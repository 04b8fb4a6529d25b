"""Multi-process execution of the port on torch.distributed: the
collectives (collectives.py), the sequence-parallel process group
(mesh.py) and the sequence-parallel attention (sequence_parallel.py)."""
