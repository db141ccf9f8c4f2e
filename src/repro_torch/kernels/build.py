"""Build, load and bind the port's CUDA kernels.

The sources under ``src/repro_torch/csrc/`` have a plain C interface.
At first use they are compiled by ``nvcc`` — one process per source,
all started together — into object files, linked into one shared
library under ``build/`` at the repository root, and loaded with
``ctypes``.  The library's file name carries a hash of the sources and
flags, so an edited source never loads a stale build.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that no
multiply and add fuse: each kernel then rounds exactly like the
sequence of plain PyTorch ops it replaces.  No ``--use_fast_math``:
division and ``sqrtf`` stay IEEE (nvcc's default), which the wire codes
depend on.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("kd_loss.cu", "lowrank_apply.cu", "opt_update.cu",
           "proto_accum.cu", "proto_dist.cu", "quantize.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# C signatures (argument types) of the entry points; all return int
SIGNATURES = {
    # g, p, mu, nu, lr, scale, bc1, bc2, n, node_elems,
    # b1, 1-b1, b2, 1-b2, eps, wd, stream
    "adamw_update": (_P,) * 8 + (_I64, _I64) + (_F32,) * 6 + (_P,),
    # g, p, mu, lr, scale, n, node_elems, momentum, wd, stream
    "sgd_update": (_P,) * 5 + (_I64, _I64, _F32, _F32, _P),
    # upd, p, lr, n, wd, stream
    "adafactor_apply": (_P,) * 3 + (_I64, _F32, _P),
    # f1, labels, sums, counts, n_nodes, batch, p_dim, n_classes, stream
    "proto_accum": (_P,) * 4 + (_I32,) * 4 + (_P,),
    # x, out, rows, cols, stream
    "rowabs": (_P, _P, _I64, _I32, _P),
    # x, row_delta, codes, rows, cols, qmax, stream
    "quantize_rows": (_P, _P, _P, _I64, _I32, _F32, _P),
    # x, row_delta, out, rows, cols, qmax, stream
    "quantize_dequantize_rows": (_P, _P, _P, _I64, _I32, _F32, _P),
    # codes, row_delta, out, rows, cols, stream
    "dequantize_rows": (_P, _P, _P, _I64, _I32, _P),
    # codes, delta, out, n, stream
    "dequantize": (_P, _P, _P, _I64, _P),
    # x, out, delta, scratch, n, qmax, stream
    "fused_quantize": (_P,) * 4 + (_I64, _F32, _P),
    "fused_quantize_dequantize": (_P,) * 4 + (_I64, _F32, _P),
    # x, row_delta, row_qmax, codes, rows, cols, stream
    "quantize_rows_mixed": (_P, _P, _P, _P, _I64, _I32, _P),
    # x, res, out, rows, cols, decay, stream
    "rowabs_sum": (_P, _P, _P, _I64, _I32, _F32, _P),
    # x, res, row_delta, row_qmax, codes, new_res, rows, cols, decay, stream
    "quantize_rows_ef": (_P,) * 6 + (_I64, _I32, _F32, _P),
    # own, codes, row_delta, w_self, w_rows, out, m, s, rows, cols,
    # float_codes, stream
    "mix_packed": (_P,) * 6 + (_I32, _I32, _I64, _I32, _I32, _P),
    # w, out, coeffs, b, a, n_nodes, n_send, lead, d, k, r, a_recv_stride,
    # w_stride, out_stride, design, tile_d, tile_k, group, stages, smem,
    # stream
    "lowrank_apply": ((_P,) * 5 + (_I32,) * 6 + (_I64,) * 3 + (_I32,) * 5
                      + (_I64, _P)),
    # x, protos, out, n, c, p_dim, bf16, stream
    "proto_dist": (_P,) * 3 + (_I32,) * 4 + (_P,),
    # ys, yt, out, rows, v, inv_t, inv_t_sq, bf16, stream
    "kd_loss_rows": (_P,) * 3 + (_I64, _I64, _F32, _F32, _I32, _P),
}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME): the port's "
                       "CUDA kernels are built from src/repro_torch/csrc")


def compile_command(nvcc: str, src: Path, obj: Path) -> List[str]:
    """The nvcc command that compiles one source to an object file."""
    return [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
            "-o", str(obj)]


def link_command(nvcc: str, objs: Sequence[Path], lib: Path) -> List[str]:
    """The nvcc command that links the objects into the shared library."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            *map(str, objs), "-o", str(lib)]


def source_tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """Compile and link the kernels unless this exact build exists.
    Returns ``(library path, compiler output)``."""
    lib = build_dir / f"librepro_torch_{source_tag()}.so"
    if lib.exists():
        return lib, ""
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(compile_command(nvcc, CSRC / s, o),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        failed = []
        for s, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            log.append(f"--- nvcc {s}\n{out}")
            if p.returncode:
                failed.append(s)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib.name
        res = subprocess.run(link_command(nvcc, objs, tmp_lib),
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib)
    return lib, "\n".join(log)


_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every
    entry point's ``argtypes``/``restype`` declared."""
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require(t, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``) — what the kernels take."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


class LaunchCounter:
    """Launches of one kernel.  Its wrapper adds one where it launches
    the kernel and nowhere else, so a run can show that its path went
    through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        COUNTERS[name] = self


COUNTERS: Dict[str, LaunchCounter] = {}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}
