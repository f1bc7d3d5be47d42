"""Surgery policy registry: architecture -> (config, params) rewrite.

Counterpart of ``flash_attention_softmax_n_tpu/surgery/registry.py``.
Surgery is a rewrite of (config, params), never a patch of live modules,
so the registry maps architecture keys (a config class, or an HF
``model_type`` string such as 'bert') to rewrite functions. A function must
take exactly three parameters, the third named ``softmax_n_param`` and
annotated ``float``; a key registered twice and a key that is neither a
type nor a non-empty string are refused.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Tuple, Type, Union

__all__ = ["PolicyRegistry", "policy_registry", "SurgeryFn"]

# converter: (config, params, softmax_n_param) -> (config, params)
SurgeryFn = Callable[[object, dict, float], Tuple[object, dict]]

ArchKey = Union[str, Type]


class PolicyRegistry(Dict[ArchKey, SurgeryFn]):
    """Dict of architecture key -> rewrite function, with validation."""

    def register(self, *keys: ArchKey) -> Callable[[SurgeryFn], SurgeryFn]:
        """Decorator: register a converter for one or more architectures
        (config types such as ``BertConfig``, or HF ``model_type`` strings
        such as ``'bert'``)."""
        if not keys:
            raise ValueError("register requires at least one architecture key")

        def wrapper(fn: SurgeryFn) -> SurgeryFn:
            self._validate_signature(fn)
            for key in keys:
                self._validate_key(key)
                if key in self:
                    raise ValueError(
                        f"architecture {key!r} already has a registered converter")
                self[key] = fn
            return fn

        return wrapper

    @staticmethod
    def _validate_key(key: ArchKey) -> None:
        if isinstance(key, str):
            if not key:
                raise ValueError("architecture string key must be non-empty")
            return
        if isinstance(key, type):
            return
        raise TypeError(
            f"architecture key must be a config type or model_type string, "
            f"got {key!r}")

    @staticmethod
    def _validate_signature(fn: SurgeryFn) -> None:
        params = list(inspect.signature(fn).parameters.values())
        if len(params) != 3:
            raise TypeError(
                f"converter {fn.__name__} must take exactly (config, params, "
                f"softmax_n_param), got {len(params)} parameters")
        third = params[2]
        if third.name != "softmax_n_param":
            raise TypeError(
                f"converter {fn.__name__}'s third parameter must be named "
                f"'softmax_n_param', got {third.name!r}")
        # the annotation may be the type or its string form (PEP 563)
        if third.annotation not in (float, "float", inspect.Parameter.empty):
            raise TypeError(
                f"converter {fn.__name__}'s softmax_n_param must be annotated "
                f"float, got {third.annotation!r}")

    def lookup(self, config) -> Union[SurgeryFn, None]:
        """The converter for a config object: by its type, then by its
        ``model_type``."""
        fn = self.get(type(config))
        if fn is not None:
            return fn
        model_type = getattr(config, "model_type", None)
        if model_type is not None:
            return self.get(str(model_type))
        return None


policy_registry = PolicyRegistry()
