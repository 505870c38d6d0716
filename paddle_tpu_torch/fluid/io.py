"""Model save/load (reference python/paddle/v2/fluid/io.py:129-400 —
save/load_vars, save/load_params, save/load_persistables,
save/load_inference_model; C++ side inference/io.cc).

Persistables are saved one .npy per variable (name-escaped) plus the
program as a language-neutral JSON IR (core/serialization.py — the
counterpart of the reference's __model__ ProgramDesc protobuf,
inference/io.cc:108). The bundle is readable without this codebase: the
native C inference runner (native/inference.cc) loads and forwards it
directly, matching capi/gradient_machine.h:36,73. The on-disk format is
the JAX package's, so a directory either package saves loads in the
other. State lives in the Scope as tensors on the executor's device;
save pulls to the host, load puts numpy arrays in the scope and the
next executor run moves them to its device.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .core.program import Parameter, default_main_program
from .executor import as_numpy, global_scope

__all__ = [
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "save_inference_model",
    "load_inference_model",
    "get_inference_program",
]

_MODEL_FILE = "__model__"


def _escape(name: str) -> str:
    return name.replace("/", "%2F")


def is_persistable(var):
    return var.persistable


def is_parameter(var):
    return isinstance(var, Parameter)


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None):
    os.makedirs(dirname, exist_ok=True)
    if vars is None:
        if main_program is None:
            main_program = default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    scope = global_scope()
    for var in vars:
        name = var if isinstance(var, str) else var.name
        if name not in scope:
            continue
        # the on-disk format is always C-order so the native loader
        # (inference.cc load_npy) can mmap-read it directly
        np.save(
            os.path.join(dirname, _escape(name) + ".npy"),
            np.ascontiguousarray(as_numpy(scope.get(name))),
        )


def save_params(executor, dirname, main_program=None):
    save_vars(executor, dirname, main_program, predicate=is_parameter)


def save_persistables(executor, dirname, main_program=None):
    save_vars(executor, dirname, main_program, predicate=is_persistable)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None):
    if vars is None:
        if main_program is None:
            main_program = default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    scope = global_scope()
    for var in vars:
        name = var if isinstance(var, str) else var.name
        path = os.path.join(dirname, _escape(name) + ".npy")
        if not os.path.exists(path):
            raise IOError("no saved value for variable %r at %s" % (name, path))
        scope.set(name, np.load(path))


def load_params(executor, dirname, main_program=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter)


def load_persistables(executor, dirname, main_program=None):
    load_vars(executor, dirname, main_program, predicate=is_persistable)


def get_inference_program(target_vars, main_program=None):
    if main_program is None:
        main_program = default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    pruned = main_program.prune(target_vars)
    return pruned


def save_inference_model(
    dirname,
    feeded_var_names,
    target_vars,
    executor,
    main_program=None,
    model_filename=None,
    params_filename=None,
    export_for_deployment=True,
):
    """Prune to the inference subgraph, write the program's JSON IR, save params
    (reference io.py:297 + pruning via core.prune/pybind.cc:270)."""
    if main_program is None:
        main_program = default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    os.makedirs(dirname, exist_ok=True)

    inference_program = main_program.prune(target_vars).clone(for_test=True)
    fetch_names = [v.name for v in target_vars]

    from .core.serialization import program_to_dict

    bundle = program_to_dict(inference_program)
    bundle["meta"] = {
        "feed_names": list(feeded_var_names),
        "fetch_names": fetch_names,
    }
    with open(os.path.join(dirname, model_filename or _MODEL_FILE), "w") as f:
        json.dump(bundle, f)
    save_persistables(executor, dirname, inference_program)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None, params_filename=None):
    path = os.path.join(dirname, model_filename or _MODEL_FILE)
    from .core.serialization import program_from_dict

    # the JSON IR only: the JAX package's pre-JSON pickle bundles hold
    # its own classes and are not read here
    with open(path, "r") as f:
        bundle = json.load(f)
    program = program_from_dict(bundle)
    meta = bundle["meta"]
    load_persistables(executor, dirname, program)
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars
