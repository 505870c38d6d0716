"""Input type descriptors (reference python/paddle/trainer/
PyDataProvider2.py InputType re-exported as paddle.v2.data_type)."""

__all__ = [
    "InputType",
    "DataType",
    "dense_vector",
    "dense_vector_sequence",
    "integer_value",
    "integer_value_sequence",
    "sparse_binary_vector",
    "sparse_float_vector",
]


class DataType(object):
    Dense = 0
    SparseNonValue = 1
    SparseValue = 2
    Index = 3


class SeqType(object):
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


class InputType(object):
    def __init__(self, dim, seq_type, tp):
        self.dim = dim
        self.seq_type = seq_type
        self.type = tp


def dense_vector(dim, seq_type=SeqType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.Dense)


def dense_vector_sequence(dim):
    return dense_vector(dim, SeqType.SEQUENCE)


def integer_value(value_range, seq_type=SeqType.NO_SEQUENCE):
    return InputType(value_range, seq_type, DataType.Index)


def integer_value_sequence(value_range):
    return integer_value(value_range, SeqType.SEQUENCE)


def sparse_binary_vector(dim, seq_type=SeqType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.SparseNonValue)


def sparse_float_vector(dim, seq_type=SeqType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.SparseValue)
