"""Build and load the port's hand-written Hopper kernels (csrc/*.cu).

Each CUDA source is compiled by its own `nvcc` into a shared library with a
plain C interface, all compiles started together, into `csrc/build/` (listed
in .gitignore), at first use — so a fresh checkout needs nothing but the
CUDA toolkit. The libraries are loaded with ctypes; pointers and the stream
are passed as integers. Nothing here runs at import: this module is imported
on machines without a CUDA toolkit, where only the plain versions run.

A failed build raises. There is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("mont_mul", "ec_add_proj", "tape_eval", "ec_fold_shared", "ec_add_jac", "poseidon")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FIELD_IDS = {"fp": 0, "fq": 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _so_path(name)
    if not os.path.exists(so):
        return True
    deps = [os.path.join(CSRC, f) for f in (f"{name}.cu", "field.cuh", "ec_group.cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def build(force: bool = False) -> dict[str, str]:
    """Compile every stale source (all `nvcc`s at once); returns the
    compiler's output (with ptxas's register and spill report) by source
    name. Raises with that output if any compile fails."""
    todo = [n for n in SOURCES if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", _so_path(name), os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    outputs, failed = {}, []
    for name, proc in procs:
        outputs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (rc={proc.returncode})\n{outputs[name]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return outputs


_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_ARGTYPES = {
    "mont_mul": {"taiga_mont_mul": [_VP, _VP, _VP, _I64, ctypes.c_int, _VP]},
    "ec_add_proj": {
        "taiga_ec_add_proj": [_VP] * 9 + [_I64, ctypes.c_int, _VP],
        "taiga_ec_add_proj_sel": [_VP] * 10 + [_I64, ctypes.c_int, _VP],
        "taiga_ec_seg_round": [_VP] * 4 + [_I64, _I64] + [_VP] * 3 + [_I64, ctypes.c_int, _VP],
        "taiga_ec_seg_tile": [_VP] * 4 + [ctypes.c_int, ctypes.c_int] + [_VP] * 3
                             + [_I64, ctypes.c_int, _VP],
        "taiga_ec_horner": [_VP] * 6 + [ctypes.c_int, _I64, ctypes.c_int, ctypes.c_int, _VP],
    },
    "tape_eval": {
        "taiga_tape_eval": [_VP, _I32, _VP, _I32, _VP, _I64, _I32, _VP, _I64, ctypes.c_int,
                            _VP],
        "taiga_tape_max_code": [],
    },
    "ec_fold_shared": {"taiga_ec_fold_shared": [_VP] * 11 + [_I64, ctypes.c_int, _VP]},
    "ec_add_jac": {
        "taiga_ec_add_jac": [_VP] * 9 + [_I64, ctypes.c_int, _VP],
        "taiga_ec_add_jac_sel": [_VP] * 10 + [_I64, ctypes.c_int, _VP],
        "taiga_ec_double_jac": [_VP] * 6 + [_I64, ctypes.c_int, _VP],
        "taiga_ec_ladder": [_VP] * 4 + [_I64, ctypes.c_int] + [_VP] * 3
                           + [_I64, _I64, ctypes.c_int, _VP],
        "taiga_ec_add_tree": [_VP] * 6 + [_I64, _I64, ctypes.c_int, _VP],
    },
    "poseidon": {
        "taiga_poseidon_set_consts": [_VP] * 6,
        "taiga_poseidon_permute": [_VP, _VP, _I64, _VP],
        "taiga_poseidon_sponge": [_VP, _VP, _I64, ctypes.c_int, _VP],
    },
}


def _load(name: str) -> ctypes.CDLL:
    from . import limbs as L

    so = ctypes.CDLL(_so_path(name))
    so.taiga_set_field.argtypes = [ctypes.c_int, _VP, ctypes.c_uint32]
    so.taiga_set_field.restype = ctypes.c_int
    for fn, argtypes in _ARGTYPES[name].items():
        getattr(so, fn).argtypes = argtypes
        getattr(so, fn).restype = ctypes.c_int
    for field, fid in FIELD_IDS.items():
        p = L.FIELDS[field].modulus
        words = (ctypes.c_uint32 * 8)(*[(p >> (32 * j)) & 0xFFFFFFFF for j in range(8)])
        n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        check(so.taiga_set_field(fid, ctypes.cast(words, _VP), n0), f"{name}: set_field")
    return so


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    with _lock:
        so = _libs.get(name)
        if so is None:
            build()
            for n in SOURCES:
                if n not in _libs:
                    _libs[n] = _load(n)
            so = _libs[name]
        return so


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc} in {what}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
