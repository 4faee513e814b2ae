"""repro_torch.dist: the mesh context, sharding rules and multi-host ingest
on ``torch.distributed``.

``meshctx``   registers the active ``DeviceMesh`` for activation
              constraints (``models.transformer.constrain_act``) without
              threading it through every call signature.
``sharding``  maps parameter / cache paths to specs and DTensor placements
              (fsdp_tp / tp_only policies, divisibility fallbacks).
``multihost`` the cell's initialization, its process topology and process
              groups, per-host shard ingestion, and the compressed
              cross-host ``StreamState`` merge.
"""
from repro_torch.dist import meshctx, multihost, sharding  # noqa: F401
