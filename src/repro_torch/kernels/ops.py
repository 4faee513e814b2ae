"""Public wrappers around the Hopper kernels: device dispatch, the build and
load of the CUDA libraries, and the launch counters.

The device of the inputs decides, and nothing falls back:

* tensors on the CPU take the kernel's plain PyTorch version (this takes
  the place of the JAX package's ``interpret`` mode);
* CUDA tensors launch the kernel, or raise: a missing ``nvcc``, a failed
  build or a refused launch is an error, never a silent detour to the plain
  version.

Each kernel is built at first use from ``kernels/csrc/<name>.cu`` with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ``ctypes``, under ``build/repro_torch/`` at the root of the
checkout. A library's file name carries a hash of its source and flags, so
an edited source is never served a stale build. ``build()`` compiles all
kernels at once, one ``nvcc`` process per source, side by side.

``LAUNCHES`` counts kernel launches per kernel; a wrapper adds one exactly
where it launches its kernel, and the plain version counts nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from repro_torch.kernels import sampled_dot as _sampled_dot
from repro_torch.kernels import sketch_fused as _sketch_fused

KERNELS = {"sketch_fused": _sketch_fused,
           "sampled_rescaled_dot": _sampled_dot}

LAUNCHES = {name: 0 for name in KERNELS}

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def reset_launch_counts() -> None:
    """Set every launch counter to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> pathlib.Path:
    """Where kernel ``name``'s library lives once built."""
    src = CSRC / KERNELS[name].SOURCE
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Build the named kernels (all by default) that are not built yet, one
    ``nvcc`` per source, all started together. Returns ``{name: path}``.
    The compiler's resource report (``-Xptxas -v``) is kept beside each
    library as ``<library>.log``."""
    names = list(KERNELS if names is None else names)
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / KERNELS[name].SOURCE)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        path = todo[name]
        path.with_name(path.name + ".log").write_text(log)
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        KERNELS[name].bind(lib)
        _LIBS[name] = lib
    return lib


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; anything else is an error."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {dev}")


def _kernel_dtype(*tensors, precision):
    """The dtype the kernel reads: bf16 when asked for or when every input
    already is bf16, float32 otherwise (mixed inputs read as float32, as the
    plain version reads them)."""
    if precision == "bf16":
        return torch.bfloat16
    if precision not in (None, "f32"):
        raise ValueError(f"unknown precision {precision!r} (None|'f32'|'bf16')")
    if precision is None and all(t.dtype == torch.bfloat16 for t in tensors):
        return torch.bfloat16
    return torch.float32


def sketch_fused(Pi: torch.Tensor, A: torch.Tensor, *,
                 precision: str | None = None):
    """Fused (Pi @ A, column norms of A) for Pi (k, d) and A (d, n).

    Both outputs are float32 and accumulate in float32. ``precision='bf16'``
    casts both inputs to bfloat16 first. Unlike the squared norms of the
    kernel, the second output is the norms themselves."""
    k, d = Pi.shape
    if A.ndim != 2 or A.shape[0] != d:
        raise ValueError(f"sketch_fused: Pi {tuple(Pi.shape)} and A "
                         f"{tuple(A.shape)} disagree on d")
    n = A.shape[1]
    dtype = _kernel_dtype(Pi, A, precision=precision)
    if precision == "bf16":
        Pi, A = Pi.to(torch.bfloat16), A.to(torch.bfloat16)
    if _on_cpu(Pi, A):
        out, norm2 = _sketch_fused.plain(Pi, A)
        return out, torch.sqrt(norm2)
    if max(k, n) >= 2 ** 31:
        raise ValueError("sketch_fused: k and n must be below 2**31")
    if k == 0 or d == 0 or n == 0:
        return (torch.zeros((k, n), dtype=torch.float32, device=A.device),
                torch.zeros((n,), dtype=torch.float32, device=A.device))
    Pi = Pi.to(dtype).contiguous()
    A = A.to(dtype).contiguous()
    lib = _library("sketch_fused")
    out, norm2 = _sketch_fused.launch(lib, Pi, A)
    LAUNCHES["sketch_fused"] += 1
    return out, norm2.sqrt_()


def sampled_rescaled_dot(As_rows: torch.Tensor, Bs_rows: torch.Tensor,
                         norm_A: torch.Tensor, norm_B: torch.Tensor,
                         rows: torch.Tensor, cols: torch.Tensor, *,
                         precision: str | None = None) -> torch.Tensor:
    """Rescaled-JL estimates (Eq. 2) at (rows, cols) from row-major sketches
    As_rows (n1, k) and Bs_rows (n2, k) and the exact norms. Returns (m,)
    float32; m = 0 gives an empty result, duplicates are allowed.
    ``precision='bf16'`` gathers bfloat16 rows; the sums stay float32."""
    n1, k = As_rows.shape
    n2 = Bs_rows.shape[0]
    if Bs_rows.shape[1] != k or norm_A.shape != (n1,) or norm_B.shape != (n2,):
        raise ValueError("sampled_rescaled_dot: sketch and norm shapes disagree")
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError("sampled_rescaled_dot: rows and cols must be (m,)")
    dtype = _kernel_dtype(As_rows, Bs_rows, precision=precision)
    if precision == "bf16":
        As_rows, Bs_rows = As_rows.to(torch.bfloat16), Bs_rows.to(torch.bfloat16)
    m = rows.shape[0]
    if _on_cpu(As_rows, Bs_rows, norm_A, norm_B, rows, cols):
        return _sampled_dot.plain(As_rows, Bs_rows, norm_A.float(),
                                  norm_B.float(), rows, cols)
    if m == 0:
        return torch.zeros((0,), dtype=torch.float32, device=rows.device)
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("sampled_rescaled_dot: the kernel takes int32 indices")
    bounds = torch.stack([rows.min(), rows.max(), cols.min(), cols.max()])
    lo_r, hi_r, lo_c, hi_c = bounds.tolist()
    if lo_r < 0 or lo_c < 0 or hi_r >= n1 or hi_c >= n2:
        raise IndexError(f"sampled_rescaled_dot: indices out of range: rows "
                         f"in [{lo_r}, {hi_r}] for n1={n1}, cols in "
                         f"[{lo_c}, {hi_c}] for n2={n2}")
    lib = _library("sampled_rescaled_dot")
    out = _sampled_dot.launch(
        lib, As_rows.to(dtype).contiguous(), Bs_rows.to(dtype).contiguous(),
        norm_A.float().contiguous(), norm_B.float().contiguous(),
        rows.contiguous(), cols.contiguous())
    LAUNCHES["sampled_rescaled_dot"] += 1
    return out
