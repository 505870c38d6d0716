"""Parameters: a name -> array pool shared across topologies (counterpart
of paddle_tpu/v2/parameters.py; reference python/paddle/v2/parameters.py
backed by SWIG GradientMachine args). Here it is backed by a fluid Scope
on the device `paddle.init` chose; the numpy interface and the tar
format are the JAX package's, byte for byte, so a tar written by either
package loads in the other."""

from __future__ import annotations

import io
import struct
import tarfile

import numpy as np

from .. import fluid
from .topology import Topology

__all__ = ["Parameters", "create"]


# --- reference-compatible wire helpers -------------------------------------
# The reference tar layout (python/paddle/v2/parameters.py:306,328-384) is,
# per parameter: a member `<name>` holding struct.pack('IIQ', 0, 4, size)
# followed by raw little-endian float32 bytes, plus a member
# `<name>.protobuf` holding a serialized paddle.ParameterConfig
# (proto/ParameterConfig.proto: name=1 string, size=2 uint64,
# dims=9 repeated uint64). We hand-encode/decode exactly those three
# fields so tars interoperate without a protobuf dependency.


def _varint(n: int) -> bytes:
    out = b""
    n = int(n)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _encode_parameter_config(name: str, shape) -> bytes:
    size = int(np.prod(shape)) if len(shape) else 1
    raw = name.encode("utf-8")
    msg = b"\x0a" + _varint(len(raw)) + raw  # field 1: name (len-delimited)
    msg += b"\x10" + _varint(size)  # field 2: size (varint)
    for d in shape:
        msg += b"\x48" + _varint(int(d))  # field 9: dims (varint, repeated)
    return msg


def _decode_parameter_config(data: bytes):
    """Minimal proto2 reader: returns (name, size, dims), skipping unknown
    fields (a reference-produced config carries many optional scalars)."""
    name, size, dims = None, None, []
    i, n = 0, len(data)

    def read_varint(i):
        shift, val = 0, 0
        while True:
            b = data[i]
            val |= (b & 0x7F) << shift
            i += 1
            if not b & 0x80:
                return val, i
            shift += 7

    while i < n:
        tag, i = read_varint(i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = read_varint(i)
            if field == 2:
                size = val
            elif field == 9:
                dims.append(val)
        elif wire == 2:
            ln, i = read_varint(i)
            payload = data[i : i + ln]
            i += ln
            if field == 1:
                name = payload.decode("utf-8")
        elif wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        else:  # groups (3/4) never appear in ParameterConfig
            break
    return name, size, dims


def write_tar_param(tar, name, arr):
    """One parameter into an open tar in the v2 wire layout (the single
    writer — Parameters.to_tar and utils/torch2paddle both call this)."""
    flat = np.ascontiguousarray(arr, dtype="<f4")
    data = struct.pack("IIQ", 0, 4, flat.size) + flat.tobytes()
    info = tarfile.TarInfo(name=name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))
    conf = _encode_parameter_config(name, np.asarray(arr).shape)
    info = tarfile.TarInfo(name="%s.protobuf" % name)
    info.size = len(conf)
    tar.addfile(info, io.BytesIO(conf))


class Parameters(object):
    def __init__(self, topology: Topology):
        self.topology = topology
        from . import place

        self.scope = fluid.executor.Scope()
        exe = fluid.Executor(place())
        with fluid.executor.scope_guard(self.scope):
            exe.run(topology.startup_program)
        # track ALL persistables, not just Parameters: batch_norm running
        # mean/variance must survive to_tar/init_from_tar and infer()
        self._param_names = sorted(
            v.name
            for v in topology.main_program.list_vars()
            if v.persistable and v.name in self.scope
        )

    # --- dict-ish surface (reference parameters.py) --------------------
    def keys(self):
        return list(self._param_names)

    def names(self):
        return self.keys()

    def has_key(self, key):
        return key in self._param_names

    def __contains__(self, key):
        return key in self._param_names

    def __iter__(self):
        return iter(self._param_names)

    def __getitem__(self, key):
        return fluid.executor.as_numpy(self.scope.full(key))

    def get(self, parameter_name):
        return self[parameter_name]

    def __setitem__(self, key, value):
        value = np.asarray(value, np.float32)
        self.scope.set(key, value)

    def set(self, parameter_name, value):
        self[parameter_name] = value

    def get_shape(self, key):
        return tuple(self.scope.get(key).shape)

    # --- tar round trip -------------------------------------------------
    def serialize(self, name, f):
        """Reference wire layout (parameters.py:306): 16-byte
        struct.pack('IIQ', version=0, value_size=4, num_elements) header
        followed by raw little-endian float32 bytes."""
        arr = np.ascontiguousarray(self[name], dtype="<f4")
        f.write(struct.pack("IIQ", 0, 4, arr.size))
        f.write(arr.tobytes())

    def deserialize(self, name, f):
        f.read(16)  # header
        arr = np.frombuffer(f.read(), dtype="<f4")
        self.set(name, arr.reshape(self.get_shape(name)))

    def to_tar(self, f):
        """Write the reference v2 model-file layout: per parameter a raw
        `<name>` member (see serialize) and a `<name>.protobuf`
        ParameterConfig member — interoperable with reference-produced
        tars for the name/size/dims fields this framework uses."""
        with tarfile.open(fileobj=f, mode="w") as tar:
            for name in self._param_names:
                write_tar_param(tar, name, self[name])

    @staticmethod
    def from_tar(f):
        """Build a Parameters-like object from a model tar (no topology
        needed — shapes come from each ParameterConfig's dims, falling
        back to flat when absent)."""
        params = Parameters.__new__(Parameters)
        params.topology = None
        params.scope = fluid.executor.Scope()
        params._param_names = []
        shapes = {}
        blobs = {}
        with tarfile.open(fileobj=f, mode="r") as tar:
            for m in tar.getmembers():
                data = tar.extractfile(m).read()
                if m.name.endswith(".protobuf"):
                    name, size, dims = _decode_parameter_config(data)
                    if name is not None and dims:
                        shapes[name] = tuple(int(d) for d in dims)
                elif data[:6] == b"\x93NUMPY":  # pre-r2 .npy tars
                    blobs[m.name] = np.load(io.BytesIO(data))
                else:
                    blobs[m.name] = np.frombuffer(data[16:], dtype="<f4")
        for name in sorted(blobs):
            arr = blobs[name]
            if name in shapes and arr.ndim == 1:
                arr = arr.reshape(shapes[name])
            params._param_names.append(name)
            params.scope.set(name, np.asarray(arr, np.float32))
        return params

    def init_from_tar(self, f, exclude_params=()):
        tar_params = Parameters.from_tar(f)
        for name in tar_params.names():
            if name in self._param_names and name not in exclude_params:
                arr = tar_params.get(name)
                self.set(name, np.asarray(arr).reshape(self.get_shape(name)))


def create(*layers):
    """paddle.parameters.create(cost): build the topology and initialize
    its parameters."""
    return Parameters(Topology(list(layers)))
