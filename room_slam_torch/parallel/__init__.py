"""Parallel strategies over ``torch.distributed``: the mesh axes and the
autograd-aware collectives (``collectives.py``), the device mesh with
data, tensor / expert and sequence parallelism (``mesh.py``) and the GPipe
pipeline (``pipeline.py``)."""
