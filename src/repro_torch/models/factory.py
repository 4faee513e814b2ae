"""Model factory: bundles an ArchConfig and a device with its init, loss,
prefill and decode entry points, the one entry point that serving uses.

The port of ``repro.models.factory``. ``params`` is the ``transformer.LM``
module that ``init_params`` returns; ``param_shapes`` and ``cache_shapes``
build the same structures on the ``meta`` device, which allocates nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device = torch.device("cuda")

    def init_params(self, key: torch.Tensor) -> transformer.LM:
        return transformer.init_params(key, self.cfg, device=self.device)

    def param_shapes(self) -> transformer.LM:
        """The parameter modules on the ``meta`` device (no allocation)."""
        return transformer.LM(self.cfg, device="meta")

    def loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return transformer.lm_loss(params, self.cfg, batch)

    def forward(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return transformer.lm_forward(params, self.cfg, batch)

    def prefill(self, params, batch: Dict[str, torch.Tensor], caches):
        return transformer.lm_prefill(params, self.cfg, batch, caches)

    def init_cache(self, batch_size: int, max_len: int):
        return transformer.init_cache(self.cfg, batch_size, max_len,
                                      device=self.device)

    def cache_shapes(self, batch_size: int, max_len: int):
        return transformer.init_cache(self.cfg, batch_size, max_len,
                                      device="meta")

    def decode_step(self, params, caches, token, pos):
        return transformer.lm_decode_step(params, self.cfg, caches, token, pos)

    def aux_input_shapes(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """Stub-frontend inputs (precomputed embeddings), as bf16 tensors on
        the ``meta`` device: their shape and dtype."""
        cfg = self.cfg
        out: Dict[str, torch.Tensor] = {}
        if cfg.is_encdec:
            out["enc_frames"] = torch.empty(
                (batch_size, cfg.enc_context, cfg.d_model),
                dtype=torch.bfloat16, device="meta")
        if cfg.n_img_tokens:
            out["img_embeds"] = torch.empty(
                (batch_size, cfg.n_img_tokens, cfg.d_model),
                dtype=torch.bfloat16, device="meta")
        return out


def build(name_or_cfg, device="cuda", **overrides) -> Model:
    """A ``Model`` of a registered arch name or an ``ArchConfig``, with
    config fields replaced by ``overrides``, on ``device``."""
    cfg = (get_config(name_or_cfg) if isinstance(name_or_cfg, str)
           else name_or_cfg)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return Model(cfg, _device.resolve(device))
