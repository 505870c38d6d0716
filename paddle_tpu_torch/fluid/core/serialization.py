"""Language-neutral Program serialization.

Replaces the reference's ProgramDesc protobuf wire format
(paddle/fluid/framework/framework.proto:34-152, written by
fluid/io.py:297 save_inference_model and read back by C++
inference::Load, paddle/fluid/inference/io.cc:108) with a stable JSON
schema: the Program IR here is a plain object graph and JSON keeps it
readable from any language — the native C++ inference runner
(native/inference.cc) parses the same file with no Python.

Schema (version 1):

    {
      "format": "paddle_tpu_program",
      "version": 1,
      "random_seed": 0,
      "amp": false,
      "shardings": {"w0": [["data"], null], ...},   # PartitionSpec per var
      "blocks": [
        {"idx": 0, "parent_idx": -1,
         "vars": [{"name", "shape", "dtype", "lod_level", "persistable",
                   "stop_gradient", "is_data", "is_parameter", "trainable"}],
         "ops":  [{"type", "inputs": {slot: [names]},
                   "outputs": {slot: [names]}, "attrs": {...}}]}
      ]
    }

Weights ride alongside as one standard .npy file per persistable
(fluid/io.py save_persistables) — also directly parseable from C.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from .program import Block, Operator, Parameter, Program, Variable

__all__ = [
    "program_to_dict",
    "program_from_dict",
    "dumps_program",
    "loads_program",
]

FORMAT_NAME = "paddle_tpu_program"
FORMAT_VERSION = 1


def _json_safe(v):
    """Normalise an attr value for JSON: tuples->lists, numpy scalars ->
    python scalars, numpy arrays -> nested lists."""
    if isinstance(v, (tuple, list)):
        return [_json_safe(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    raise TypeError(
        "op attr of type %s is not serializable: %r" % (type(v).__name__, v)
    )


def _spec_to_json(spec):
    """A sharding spec (a PartitionSpec-like sequence) -> list of entries
    (str axis, [str,...], or None)."""
    out = []
    for e in tuple(spec):
        if e is None or isinstance(e, str):
            out.append(e)
        else:  # tuple of axis names
            out.append(list(e))
    return out


def _spec_from_json(entries):
    """A spec read from a file, as the port's PartitionSpec
    (parallel/mesh.py)."""
    from ...parallel.mesh import PartitionSpec

    return PartitionSpec(*(tuple(e) if isinstance(e, list) else e
                           for e in entries))


def program_to_dict(program: Program) -> Dict[str, Any]:
    blocks = []
    for blk in program.blocks:
        vars_out = []
        for v in blk.vars.values():
            vars_out.append(
                {
                    "name": v.name,
                    "shape": list(v.shape) if v.shape is not None else None,
                    "dtype": v.dtype,
                    "lod_level": v.lod_level,
                    "persistable": bool(v.persistable),
                    "stop_gradient": bool(v.stop_gradient),
                    "is_data": bool(getattr(v, "is_data", False)),
                    "is_parameter": isinstance(v, Parameter),
                    "trainable": bool(getattr(v, "trainable", False)),
                }
            )
        ops_out = []
        for op in blk.ops:
            ops_out.append(
                {
                    "type": op.type,
                    "inputs": {k: list(v) for k, v in op.inputs.items()},
                    "outputs": {k: list(v) for k, v in op.outputs.items()},
                    "attrs": {k: _json_safe(v) for k, v in op.attrs.items()},
                }
            )
        blocks.append(
            {
                "idx": blk.idx,
                "parent_idx": blk.parent_idx,
                "vars": vars_out,
                "ops": ops_out,
            }
        )
    return {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "random_seed": program.random_seed,
        "amp": bool(program.amp),
        "remat": bool(program.remat),
        "shardings": {
            k: _spec_to_json(v) for k, v in program.shardings.items()
        },
        "blocks": blocks,
    }


def program_from_dict(d: Dict[str, Any]) -> Program:
    if d.get("format") != FORMAT_NAME:
        raise ValueError("not a %s file" % FORMAT_NAME)
    if d.get("version", 0) > FORMAT_VERSION:
        raise ValueError(
            "program schema version %s is newer than this loader (%d)"
            % (d.get("version"), FORMAT_VERSION)
        )
    program = Program()
    program.random_seed = int(d.get("random_seed", 0))
    program.amp = bool(d.get("amp", False))
    program.remat = bool(d.get("remat", False))
    if d.get("shardings"):
        program.shardings = {
            k: _spec_from_json(v) for k, v in d["shardings"].items()
        }
    # materialise blocks first (ops may reference later blocks via
    # sub_block attrs)
    for bd in d["blocks"][1:]:
        blk = Block(program, len(program.blocks), bd["parent_idx"])
        program.blocks.append(blk)
    for bd in d["blocks"]:
        blk = program.blocks[bd["idx"]]
        blk.parent_idx = bd["parent_idx"]
        for vd in bd["vars"]:
            cls = Parameter if vd.get("is_parameter") else Variable
            kwargs = dict(
                shape=vd["shape"],
                dtype=vd["dtype"],
                lod_level=vd.get("lod_level", 0),
                persistable=vd.get("persistable", False),
                stop_gradient=vd.get("stop_gradient", False),
            )
            if cls is Parameter:
                kwargs["trainable"] = vd.get("trainable", True)
            else:
                kwargs["is_data"] = vd.get("is_data", False)
            blk.vars[vd["name"]] = cls(blk, name=vd["name"], **kwargs)
        for od in bd["ops"]:
            op = Operator(
                blk,
                type=od["type"],
                inputs=None,
                outputs=None,
                attrs=od.get("attrs") or {},
            )
            op.inputs = {k: list(v) for k, v in od["inputs"].items()}
            op.outputs = {k: list(v) for k, v in od["outputs"].items()}
            blk.ops.append(op)
    program.current_block_idx = 0
    program._bump_version()
    return program


def dumps_program(program: Program, indent=None) -> str:
    return json.dumps(program_to_dict(program), indent=indent)


def loads_program(s: str) -> Program:
    return program_from_dict(json.loads(s))
