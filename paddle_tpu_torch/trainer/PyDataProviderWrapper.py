"""PyDataProviderWrapper: the v1 (pre-PyDataProvider2) provider protocol
(reference python/paddle/trainer/PyDataProviderWrapper.py). v1 handlers
are `handler(obj, filename)` generators declared with slot-type objects;
this maps them onto the same reader factories the trainer consumes from
PyDataProvider2, so v1 provider modules keep working."""

from __future__ import annotations

__all__ = [
    "DenseSlot", "SlotType", "SparseNonValueSlot", "StringSlot",
    "SparseValueSlot", "IndexSlot", "PoolSize", "provider",
    "init_hook_wrapper",
]


class SlotType(object):
    """Base of the v1 slot declarations; carries the slot dimension."""

    def __init__(self, dim):
        self.dim = int(dim)

    def to_input_type(self):
        raise NotImplementedError


class DenseSlot(SlotType):
    def to_input_type(self):
        from ..v2.data_type import dense_vector

        return dense_vector(self.dim)


class SparseNonValueSlot(SlotType):
    def to_input_type(self):
        from ..v2.data_type import sparse_binary_vector

        return sparse_binary_vector(self.dim)


class SparseValueSlot(SlotType):
    def to_input_type(self):
        from ..v2.data_type import sparse_float_vector

        return sparse_float_vector(self.dim)


class IndexSlot(SlotType):
    def to_input_type(self):
        from ..v2.data_type import integer_value

        return integer_value(self.dim)


class StringSlot(SlotType):
    """Raw-string slot (the reference passed strings through untouched);
    no device lowering exists for it, so it stays a python object."""

    def to_input_type(self):
        return None


class PoolSize(object):
    """Max number of samples buffered by the provider."""

    def __init__(self, pool_size):
        self.size = pool_size


def default_init_hook(cls, *args, **kwargs):
    del cls, args, kwargs


def provider(slots=None, use_seq=False, should_shuffle=True, pool_size=1,
             can_over_batch_size=True, calc_batch_size=None, debug=False,
             init_hook=default_init_hook, profile_filename=None):
    """v1 decorator: `handler(obj, filename)` yields one sample per
    iteration, each a list/tuple with one entry per declared slot.
    Returns a factory `create(file_list, **kwargs)` producing a reader
    over all files — the same calling convention the trainer's provider
    loader uses for PyDataProvider2 modules."""

    def _wrapper(handler):
        def create(file_list, **kwargs):
            class _Obj(object):
                pass

            obj = _Obj()
            obj.logger = __import__("logging").getLogger("paddle")
            init_hook(obj, *([file_list] if file_list else []), **kwargs)
            slot_decl = slots
            if callable(slot_decl):
                slot_decl = slot_decl(
                    obj, *([file_list] if file_list else []), **kwargs
                )
            obj.slots = list(slot_decl or getattr(obj, "slots", []) or [])

            def reader():
                files = file_list if file_list else [None]
                for f in files:
                    yield from handler(obj, f)

            reader.settings = obj
            reader.input_types = [
                s.to_input_type() if isinstance(s, SlotType) else s
                for s in obj.slots
            ]
            return reader

        create.is_provider = True
        create.origin = handler
        return create

    return _wrapper


def init_hook_wrapper(func):
    """Mark `func` usable as an init_hook (kept for API parity)."""
    return func
