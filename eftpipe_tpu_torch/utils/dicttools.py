"""Small config-dict utilities (counterpart of
``eftpipe_tpu/utils/dicttools.py``; upstream tools.py:87-145)."""

from __future__ import annotations

from typing import Any


def recursively_update_dict(base: dict, update: dict) -> None:
    """In-place deep merge of ``update`` into ``base``."""
    for key, value in update.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            recursively_update_dict(base[key], value)
        else:
            base[key] = value


def int_or_list(x: Any) -> list[int]:
    return [int(x)] if isinstance(x, (int, float)) else [int(v) for v in x]


def str_or_list(x: Any) -> list[str]:
    return [x] if isinstance(x, str) else list(x)


def bool_or_list(x: Any) -> list[bool]:
    return [x] if isinstance(x, bool) else list(x)
