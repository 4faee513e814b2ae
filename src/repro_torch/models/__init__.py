"""The port of ``repro.models``: ``build(arch_or_cfg, device=...)`` gives a
``Model`` (configs in ``repro_torch.configs``)."""
from repro_torch.models.factory import Model, build  # noqa: F401
