"""A configuration tree (nested frozen dataclasses, tuples, dicts) as JSON
and back.  A dataclass becomes ``{"type": <class name>, <field>: ...}``
and a tuple ``{"tuple": [...]}``, so that the reference can rebuild the
same tree from its own classes of the same names."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict


def encode(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"type": type(obj).__name__}
        out.update((f.name, encode(getattr(obj, f.name))) for f in dataclasses.fields(obj) if f.init)
        return out
    if isinstance(obj, tuple):
        return {"tuple": [encode(v) for v in obj]}
    if isinstance(obj, list):
        return [encode(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): encode(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot write {type(obj).__name__} into a configuration file")


def decode(obj: Any, classes: Dict[str, Callable]) -> Any:
    """The tree of :func:`encode`'s ``obj``, each dataclass built by
    ``classes[<class name>]``."""
    if isinstance(obj, dict):
        if "tuple" in obj and len(obj) == 1:
            return tuple(decode(v, classes) for v in obj["tuple"])
        if "type" in obj:
            kw = {k: decode(v, classes) for k, v in obj.items() if k != "type"}
            return classes[obj["type"]](**kw)
        return {k: decode(v, classes) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode(v, classes) for v in obj]
    return obj
