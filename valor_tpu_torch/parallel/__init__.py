"""Parallelism of the port: the (data, model) mesh across processes
(``mesh.py``: the process group, the grid and its groups, batch shards and
random draws at the global batch's shape; ``collectives.py``: object, ragged
and autograd-aware collectives over either axis, the Megatron pair of tensor
parallelism; ``partition.py``: the JAX package's parameter placement, tensor
parallelism over ``model`` and ``fsdp`` over ``data``; ``fsdp.py``: blocks
gathered where they are read; ``launch.py``: ranks on this host from Python).
The other axes of ``valor_tpu/parallel`` (sequence, pipeline, expert) are
later parts of ROADMAP item 13."""
