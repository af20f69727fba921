"""What the JAX package's cell builder (``launch/cells.py``) decides for a
cell, as far as the port needs it yet: the optimizer rule of a family's
train cell (``opt_cfg``).  The builder itself and the dry-run wait for
ROADMAP queue 1, item 15.2.
"""
from __future__ import annotations

from repro_torch.configs import registry
from repro_torch.train import optimizer as opt

ADAFACTOR_AT = 40 * 5120     # d_model x n_layers from which an LM trains
#                              with Adafactor (~14B dense and up)


def published_layers(cfg) -> int:
    """``cfg``'s depth as published: a config cut in depth (``n_layers``
    replaced, name and width kept) counts its registry config's layers;
    any other config its own."""
    for configs in registry.LM_ARCHS.values():
        c = configs.CONFIG
        if c.name == cfg.name and c.d_model == cfg.d_model:
            return c.n_layers
    return cfg.n_layers


def opt_cfg(family: str, cfg) -> opt.OptConfig:
    """The reference's ``_opt_cfg``: Adam, or Adafactor for an LM whose
    ``d_model`` x (published) ``n_layers`` reaches ``ADAFACTOR_AT``; the
    tables' rule ``adagrad_rows`` on every path holding "table" or "embed"
    (an LM's ``unembed`` too)."""
    dense_rule = "adam"
    if family == "lm" and cfg.d_model * published_layers(cfg) \
            >= ADAFACTOR_AT:
        dense_rule = "adafactor"
    return opt.OptConfig(dense_rule=dense_rule)
