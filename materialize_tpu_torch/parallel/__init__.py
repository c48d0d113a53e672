"""The SPMD layer (the port of ``materialize_tpu/parallel/``).

The reference runs one controller process that drives a ``shard_map``
over a mesh of devices. The port runs one process per worker, joined by
``torch.distributed``: ``mesh.py`` holds a rank's view of the worker
group, ``multihost.py`` joins the group and launches ranks, and
``exchange.py`` routes update rows to the rank that owns their key.
"""
