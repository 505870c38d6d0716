"""paddle.batch (reference python/paddle/v2/minibatch.py)."""

__all__ = ["batch"]


def batch(reader, batch_size):
    """Group a per-instance reader into lists of batch_size instances."""

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b:
            yield b

    return batch_reader
