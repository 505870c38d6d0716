"""Kernel classes of a Fluid training step by kernel name (the port's
chip script's classes, frozen here)."""


def fluid_class(name):
    if any(k in name for k in ("implicit_gemm", "fprop", "dgrad", "wgrad",
                               "conv", "cudnn", "nchwToNhwc", "nhwcToNchw",
                               "winograd")):
        return "conv"
    if any(k in name for k in ("nvjet", "gemm", "cutlass")):
        return "gemm"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if any(k in name for k in ("index", "gather", "scatter", "embedding")):
        return "index"
    return "bn_elementwise"
