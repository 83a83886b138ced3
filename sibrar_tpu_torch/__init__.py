"""sibrar_tpu_torch: the PyTorch / CUDA port of sibrar_tpu for NVIDIA Hopper.

The JAX package ``sibrar_tpu`` stays the reference; every module here names
its counterpart there. This package imports torch, numpy and scipy only.
"""
import dataclasses
import enum
import typing
from typing import Any

import torch


def _coerce(value: Any, tp: Any) -> Any:
    """``value`` as annotation ``tp`` says (the JAX package's
    ``schema._coerce``): ``None`` stays ``None`` under ``Optional``, a union
    takes its first member that accepts the value, lists and tuples coerce
    each element, enums take their value, nested dataclasses their dict,
    and ``int`` / ``float`` / ``str`` / ``bool`` their constructor;
    anything else is kept as it is."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        if value is None:
            return None
        err: Exception | None = None
        for arg in typing.get_args(tp):
            if arg is type(None):
                continue
            try:
                return _coerce(value, arg)
            except (TypeError, ValueError, KeyError) as e:
                err = e
        raise err or TypeError(f"cannot coerce {value!r} to {tp}")
    if origin in (list, tuple):
        (elem,) = typing.get_args(tp)[:1] or (Any,)
        seq = [_coerce(v, elem) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        return dict(value)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return value if isinstance(value, tp) else tp(value)
    if dataclasses.is_dataclass(tp):
        return config_from_dict(tp, value)
    if tp in (int, float, str, bool) and value is not None:
        return tp(value)
    return value


def config_from_dict(cls, data):
    """Dataclass ``cls`` from a config dict, as the JAX package's
    ``schema.from_dict`` loads it: ``None`` reads as empty, keys it has no
    field for are ignored, values are coerced to the field's annotation
    (nested dataclasses from their dicts), and ``validate()`` runs where the
    class has one."""
    data = dict(data or {})
    hints = typing.get_type_hints(cls)
    obj = cls(**{f.name: _coerce(data[f.name], hints.get(f.name, Any))
                 for f in dataclasses.fields(cls) if f.name in data})
    if hasattr(obj, "validate"):
        obj.validate()
    return obj


def full_f32() -> None:
    """Keep f32 matmuls and convolutions in full f32 (no TF32), as the JAX
    reference computes them; called by the serving and scoring entry points."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
