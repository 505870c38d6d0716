"""PyDataProvider2: the legacy data-provider protocol (reference
python/paddle/trainer/PyDataProvider2.py + its C++ consumer
gserver/dataproviders/PyDataProvider2.cpp).

A provider is `@provider(init_hook=...)` over a generator
`process(settings, file_list)` yielding per-instance tuples matching
`settings.slots`. The async double-buffering the C++ side did is served
by the same thread/queue machinery as paddle_tpu_torch.v2.reader.buffered."""

from __future__ import annotations

from ..v2.data_type import (  # noqa: F401 — the legacy names
    dense_vector,
    dense_vector_sequence,
    integer_value,
    integer_value_sequence,
    sparse_binary_vector,
    sparse_float_vector,
)

__all__ = [
    "provider", "CacheType", "ProviderSettings",
    "dense_vector", "dense_vector_sequence", "integer_value",
    "integer_value_sequence", "sparse_binary_vector", "sparse_float_vector",
]


class CacheType(object):
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class ProviderSettings(object):
    """Attribute bag the init_hook populates (height, width, slots, ...)."""

    def __init__(self):
        self.slots = None
        self.input_types = None

    @property
    def input_types_(self):
        return self.slots


def provider(input_types=None, init_hook=None, cache=CacheType.NO_CACHE,
             min_pool_size=-1, **provider_kwargs):
    """Decorator: fn(settings, file_list, ...) -> generator of instances."""

    def deco(fn):
        def create(file_list, **args):
            settings = ProviderSettings()
            if input_types is not None:
                settings.slots = list(input_types)
            if init_hook is not None:
                init_hook(settings, **args)
            if settings.slots is None and settings.input_types is not None:
                settings.slots = list(settings.input_types)

            def reader():
                yield from fn(settings, file_list)

            reader.settings = settings
            return reader

        create.is_provider = True
        create.origin = fn
        return create

    return deco
