"""Reference ``.pt`` state dicts -> the port's modules.

Port of esm_tpu/io/convert.py's ``convert_esm2``, ``convert_esm1`` and
``convert_msa_transformer``. The port's modules carry the reference's
parameter names and layouts, so conversion is a strict ``load_state_dict``
after the key upgrade (pretrained.upgrade_state_v2 or upgrade_state_v1).
When the contact-regression weights are absent the head is zero, as the JAX
package's ``_default_contact_head`` makes it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.asarray(v))


def load_lm_state(model, state: Mapping) -> None:
    """Load a canonical (prefix-free) state dict into an ``ESM2``, ``ESM1`` or
    ``MSATransformer`` strictly, with a zero contact head when the state has
    none."""
    cfg = model.cfg
    sd: Dict[str, torch.Tensor] = {k: _tensor(v) for k, v in state.items()}
    if "contact_head.regression.weight" not in sd:
        sd["contact_head.regression.weight"] = torch.zeros(
            1, cfg.num_layers * cfg.attention_heads
        )
        sd["contact_head.regression.bias"] = torch.zeros(1)
    if "lm_head.weight" in sd:
        # the tied projection is the embedding (the JAX converters read only
        # embed_tokens.weight, and the v1 upgrade zeroes a row of it alone)
        sd["lm_head.weight"] = sd["embed_tokens.weight"]
    model.load_state_dict(sd, strict=True)
