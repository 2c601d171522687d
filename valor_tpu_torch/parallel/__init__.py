"""Parallelism of the port: the (data, model, pipe) mesh across processes
(``mesh.py``: the process group, the grid and its groups, batch shards and
random draws at the global batch's shape; ``collectives.py``: object, ragged
and autograd-aware collectives over each axis, the Megatron pair of tensor
parallelism, the pipe axis's gathers, hand-back and stage sends;
``partition.py``: the JAX package's parameter placement, tensor parallelism
over ``model`` and ``fsdp`` over ``data``; ``fsdp.py``: blocks gathered where
they are read; ``activations.py``: the fusion sequence over ``model``;
``pipeline.py``: the fusion stack's stages over ``pipe``; ``launch.py``: ranks
on this host from Python)."""
