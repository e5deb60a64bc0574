"""Nested dicts of tensors (parameter trees) <-> flat dicts keyed by
'/'-joined paths."""

from __future__ import annotations


def flatten(tree: dict, prefix: str = "") -> dict:
    """{"a": {"b": x}} -> {"a/b": x}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten_like(tree: dict, flat: dict, prefix: str = "") -> dict:
    """The structure of ``tree`` with the leaves of ``flat``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out[k] = (unflatten_like(v, flat, key) if isinstance(v, dict)
                  else flat[key])
    return out
