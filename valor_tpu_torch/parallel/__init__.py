"""Parallelism of the port: the data axis across processes (``mesh.py``:
the process group, batch shards and random draws at the global batch's shape;
``collectives.py``: object, ragged and autograd-aware collectives;
``launch.py``: ranks on this host from Python).  The other axes of
``valor_tpu/parallel`` (tensor, sequence, pipeline, ZeRO/FSDP, expert) are
later parts of ROADMAP item 13."""
