"""repro_torch.dist: multi-host ingest on ``torch.distributed``.

``multihost``: the cell's initialization, its process topology and process
groups, per-host shard ingestion, and the compressed cross-host
``StreamState`` merge. (The JAX package's ``meshctx`` and ``sharding``
serve the LM stack, which is not ported yet.)
"""
from repro_torch.dist import multihost  # noqa: F401
