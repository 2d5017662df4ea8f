"""Carry LM weights and decode caches between the JAX package and the port,
as numpy.

The JAX package's parameter tree (``repro.models.model.init_model``) and
decode caches (dense from ``prefill``, clustered from
``Engine._cluster_caches`` or ``init_decode_caches``), handed over as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, tree)``),
become the port's trees and back. The two trees have the same keys and the
same leaf shapes: the port keeps the reference's weight layout, ``(d_in,
d_out)`` applied as ``x @ W``, and its stacked leading group axis, so every
leaf crosses by a copy and nothing is transposed: zamba2's shared block
(``stack["shared"]``, unstacked), whisper's ``encoder``, ``enc_pos`` and
``pos_embed``, the frontend's projection, and the recurrent caches' tuple
leaves (``{"mlstm": (C_hat, n_hat, m)}``, ``{"slstm": (c, n, m, h)}``)
included, in both directions. Neither package is imported here. bfloat16
leaves are reinterpreted bit for bit (``core.bridge``);
``caches_to_numpy`` widens them to float32, which is exact.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.bridge import _to_tensor


def _tree_from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_from_numpy(v, device) for v in tree)
    return _to_tensor(tree, device)


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(cfg: ArchConfig, tree: dict, device) -> dict:
    """The JAX package's parameter tree for ``cfg`` as the port's. Raises
    ``ValueError`` when a leaf's shape is not the one ``cfg`` gives it
    (checked on the stack's first sub-block and the embeddings)."""
    params = _tree_from_numpy(tree, device)
    want = cfg.vocab_padded(), cfg.d_model
    if tuple(params["embed"]["embedding"].shape) != want:
        raise ValueError(f"params_from_numpy: embedding "
                         f"{tuple(params['embed']['embedding'].shape)} is "
                         f"not {want} of {cfg.name}")
    return params


def caches_from_numpy(tree: dict, device) -> dict:
    """A dense or clustered decode-cache tree (leaves stacked over the
    groups, ``pos``/``rlen`` int32, ``ring`` bool, tuples kept) or
    whisper's cross-KV as the port's."""
    return _tree_from_numpy(tree, device)


def caches_to_numpy(caches: dict) -> dict:
    return _tree_to_numpy(caches)
