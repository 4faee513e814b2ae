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

Every wrapper takes an optional ``config: tuning.KernelConfig`` and
resolves it as the JAX package's wrappers do, before anything runs:

    explicit kwarg (precision=...)                    wins over
    explicit ``config``                               wins over
    committed tuning-table hit for the shape bucket   wins over
    ``tuning.DEFAULTS`` (the tiles the kernels had before the tuner)

A config names a tile the kernel's source compiles, or ``ValueError``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from repro_torch import prng
from repro_torch.core.sketch import _next_pow2, _sqrt_f32
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import hadamard as _hadamard
from repro_torch.kernels import sampled_dot as _sampled_dot
from repro_torch.kernels import sketch_fused as _sketch_fused
from repro_torch.kernels import tuning as _tuning

KERNELS = {"sketch_fused": _sketch_fused,
           "sampled_rescaled_dot": _sampled_dot,
           "blocked_fwht": _hadamard,
           "flash_attention": _flash}

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


def _resolved(kernel: str, shape: tuple, ref: torch.Tensor,
              config: "_tuning.KernelConfig | None") -> _tuning.KernelConfig:
    """The effective config: the explicit one, else the table's hit or the
    default for ``ref``'s device; validated either way."""
    if config is None:
        config = _tuning.lookup(kernel, shape,
                                dtype_bytes=_tuning.dtype_bytes_of(ref),
                                backend=_tuning.backend_of(ref.device))
    _tuning.validate_config(config)
    if config.kernel != kernel:
        raise ValueError(f"config is for kernel {config.kernel!r}, "
                         f"wrapper is {kernel!r}")
    return config


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
                 precision: str | None = None,
                 config: "_tuning.KernelConfig | None" = None):
    """Fused (Pi @ A, column norms of A) for Pi (k, d) and A (d, n).

    Both outputs are float32 and accumulate in float32. ``precision='bf16'``
    casts both inputs to bfloat16 first. Unlike the squared norms of the
    kernel, the second output is the norms themselves."""
    k, d = Pi.shape
    if A.ndim != 2 or A.shape[0] != d:
        raise ValueError(f"sketch_fused: Pi {tuple(Pi.shape)} and A "
                         f"{tuple(A.shape)} disagree on d")
    n = A.shape[1]
    cfg = _resolved("sketch_fused", (k, d, n), A, config)
    precision = precision if precision is not None else cfg.precision
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
                         precision: str | None = None,
                         config: "_tuning.KernelConfig | None" = None
                         ) -> torch.Tensor:
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
    cfg = _resolved("sampled_dot", (n1, n2, k, rows.shape[0]), As_rows,
                    config)
    precision = precision if precision is not None else cfg.precision
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
    if m >= 2 ** 31 - 1:
        raise ValueError("sampled_rescaled_dot: m must be below 2**31 - 1")
    if n1 == 0 or n2 == 0:
        raise IndexError(f"sampled_rescaled_dot: {m} samples of an empty "
                         f"sketch (n1={n1}, n2={n2})")
    lib = _library("sampled_rescaled_dot")
    out, flag = _sampled_dot.launch(
        lib, As_rows.to(dtype).contiguous(), Bs_rows.to(dtype).contiguous(),
        norm_A.float().contiguous(), norm_B.float().contiguous(),
        rows.contiguous(), cols.contiguous())
    LAUNCHES["sampled_rescaled_dot"] += 1
    # the range check is folded into the kernel's first pass; reading its
    # flag is the one synchronisation
    if flag.item():
        raise IndexError(f"sampled_rescaled_dot: indices out of range: rows "
                         f"must lie in [0, {n1}), cols in [0, {n2})")
    return out


def blocked_fwht(X: torch.Tensor, signs: torch.Tensor, *,
                 d_pad: int | None = None,
                 config: "_tuning.KernelConfig | None" = None) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform ``H (signs * X)``, float32.

    X (d, n) float32 or bfloat16, signs (d,). Without ``d_pad``, d must be
    a power of two, as in the JAX wrapper. With it, X is read as if padded
    with zero rows to ``d_pad`` (a power of two >= d) and the result is
    (d_pad, n); on the card no padded copy is made, and X may be a column
    slice of a wider matrix (unit column stride, any row stride). A
    config's ``precision`` reads X as bfloat16 ('bf16') or float32 ('f32');
    the JAX wrapper ignores it."""
    if X.ndim != 2 or signs.shape != (X.shape[0],):
        raise ValueError(f"blocked_fwht: X {tuple(X.shape)} and signs "
                         f"{tuple(signs.shape)} disagree")
    d, n = X.shape
    if d_pad is None:
        if _next_pow2(d) != d:
            raise ValueError(
                f"blocked_fwht: d must be a power of two (got d={d}); "
                f"pad first or pass d_pad")
        d_pad = d
    elif _next_pow2(d_pad) != d_pad or d_pad < d:
        raise ValueError(f"blocked_fwht: d_pad={d_pad} must be a power of "
                         f"two >= d={d}")
    cfg = _resolved("blocked_fwht", (d_pad, n), X, config)
    if cfg.precision is not None:
        X = X.to(_kernel_dtype(X, precision=cfg.precision))
    if _on_cpu(X, signs):
        return _hadamard.plain(X, signs, d_pad)
    if d == 0 or n == 0:
        return torch.zeros((d_pad, n), dtype=torch.float32, device=X.device)
    if X.dtype not in (torch.float32, torch.bfloat16):
        X = X.float()
    if X.stride(1) != 1:
        X = X.contiguous()
    lib = _library("blocked_fwht")
    out = _hadamard.launch(lib, X, signs.float().contiguous(), d_pad)
    LAUNCHES["blocked_fwht"] += 1
    return out


def srht_block(X: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, *,
               d_pad: int, sketch: torch.Tensor | None = None,
               norms: torch.Tensor | None = None, col0: int = 0,
               config: "_tuning.KernelConfig | None" = None):
    """The SRHT pass on one column block: ``(H (signs * X))[rows] /
    sqrt(d_pad) * sqrt(d_pad / k)`` (k, n) and X's column norms (n,), both
    float32, written into ``sketch[:, col0:col0 + n]`` and ``norms[col0:col0
    + n]`` when given (else new tensors). Returns the two written views.

    X (d, n) float32 or bfloat16 as for ``blocked_fwht`` with ``d_pad``;
    rows (k,) integer, each in [0, d_pad). On the card one ``blocked_fwht``
    launch: the kernel's block mode, which writes only the k rows (equal
    bit for bit to the plain composition) and adds the norms into its first
    pass (in its own order, float64 beyond a thread's float32 sum, so they
    may differ from the plain float32 sums by float32 rounding)."""
    if X.ndim != 2 or signs.shape != (X.shape[0],) or rows.ndim != 1:
        raise ValueError(f"srht_block: X {tuple(X.shape)}, signs "
                         f"{tuple(signs.shape)} and rows "
                         f"{tuple(rows.shape)} disagree")
    d, n = X.shape
    k = rows.shape[0]
    if _next_pow2(d_pad) != d_pad or d_pad < d or not 0 < k <= d_pad:
        raise ValueError(f"srht_block: d_pad={d_pad} must be a power of two "
                         f">= d={d}, and k={k} in [1, d_pad]")
    if sketch is None:
        sketch = torch.empty((k, col0 + n), dtype=torch.float32,
                             device=X.device)
    if norms is None:
        norms = torch.empty((col0 + n,), dtype=torch.float32, device=X.device)
    if sketch.shape[0] != k or sketch.shape[1] < col0 + n or \
            norms.shape[0] < col0 + n or sketch.dtype != torch.float32 or \
            norms.dtype != torch.float32:
        raise ValueError(f"srht_block: sketch {tuple(sketch.shape)} and "
                         f"norms {tuple(norms.shape)} (float32) cannot take "
                         f"{n} columns at {col0}")
    out_s, out_n = sketch[:, col0:col0 + n], norms[col0:col0 + n]
    cfg = _resolved("blocked_fwht", (d_pad, n), X, config)
    if cfg.precision is not None:
        X = X.to(_kernel_dtype(X, precision=cfg.precision))
    if _on_cpu(X, signs, rows, sketch, norms):
        block, block_norms = _hadamard.plain_block(X, signs, rows, d_pad)
        out_s.copy_(block)
        out_n.copy_(block_norms)
        return out_s, out_n
    if n == 0:
        return out_s, out_n
    if d == 0:                  # nothing to read: the plain version's zeros
        out_s.zero_()
        out_n.zero_()
        return out_s, out_n
    if X.dtype not in (torch.float32, torch.bfloat16):
        X = X.float()
    if X.stride(1) != 1:
        X = X.contiguous()
    if sketch.stride(1) != 1 or not norms.is_contiguous():
        raise ValueError("srht_block: sketch needs unit column stride and "
                         "norms must be contiguous")
    lib = _library("blocked_fwht")
    _hadamard.launch_block(
        lib, X, signs.float().contiguous(), rows.to(torch.int32).contiguous(),
        d_pad, float(_sqrt_f32(d_pad)), float(_sqrt_f32(d_pad / k)), out_s,
        out_n)
    LAUNCHES["blocked_fwht"] += 1
    return out_s, out_n


def srht_sketch_kernel(key: torch.Tensor, X: torch.Tensor, k: int
                       ) -> torch.Tensor:
    """SRHT ``sqrt(1/k) R H D X`` through ``blocked_fwht``: X (d, n) ->
    (k, n) float32, with the keys of ``core.sketch.srht_sketch``."""
    d = X.shape[0]
    dp = _next_pow2(d)
    key_sign, key_rows = prng.split(key.to(X.device))
    signs = prng.rademacher(key_sign, (d,), dtype=X.dtype)
    HX = blocked_fwht(X, signs, d_pad=dp) / _sqrt_f32(dp).to(X.device)
    rows = prng.choice(key_rows, dp, (k,))
    return HX[rows.long()] * _sqrt_f32(dp / k).to(X.device)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the flash kernel reads it: unit stride along the last axis,
    the other strides multiples of 4 elements, 16-byte aligned; a
    contiguous copy otherwise."""
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        return t.contiguous()
    return t


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    config: "_tuning.KernelConfig | None" = None
                    ) -> torch.Tensor:
    """Softmax attention, forward: q (B, S, H, Dh), k and v GQA
    (B, S, Hkv, Dh) with H a multiple of Hkv; returns (B, S, H, Dh) in q's
    dtype. Query head h reads KV head ``h // (H // Hkv)``, as the JAX
    wrapper's ``jnp.repeat`` gives it; the kernel reads k and v in place.
    Blocks are ``min(block, S)`` of the resolved config and must divide S.
    The kernel reads float32 or bf16 (a config's ``precision``, else bf16
    when q, k and v all are); the arithmetic is float32."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} disagree")
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads is not a multiple "
                         f"of {Hkv} KV heads")
    cfg = _resolved("flash_attention", (B * H, S, Dh), q, config)
    bq, bk = (min(b, S) for b in cfg.block)
    if S == 0 or S % bq or S % bk:
        raise ValueError(f"flash_attention: S={S} not divisible by blocks "
                         f"(bq={bq}, bk={bk})")
    dtype = _kernel_dtype(q, k, v, precision=cfg.precision)
    qc, kc, vc = (t.to(dtype) for t in (q, k, v))
    if _on_cpu(q, k, v):
        return _flash.plain(qc, kc, vc, causal).to(q.dtype)
    _flash.check_tile(bq, bk, Dh)
    if q.numel() == 0:
        return torch.empty_like(q)
    lib = _library("flash_attention")
    out = _flash.launch(lib, _aligned(qc), _aligned(kc), _aligned(vc),
                        causal, bq, bk)
    LAUNCHES["flash_attention"] += 1
    return out.to(q.dtype)
