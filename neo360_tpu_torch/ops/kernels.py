"""Build and bind the hand-written CUDA kernels of `csrc/`.

The sources are compiled on first use with `nvcc`, one process per source
started together, and linked into one shared library with a plain C
interface, `build/neo360_kernels/libneo360_kernels-<hash>.so` at the root
of the checkout, bound with ctypes. The hash covers the
sources, the headers they share (`csrc/*.cuh`) and the flags, so an edited kernel is rebuilt and a stale library is
never loaded. Every C entry point takes raw pointers and the CUDA stream as
`void*`, launches on that stream without synchronising, and returns
`cudaGetLastError()`; `launch` raises on a non-zero code, and counts
each launch that returned 0 in `launches` (entry name -> launches so far),
the port's one launch counter.

Nothing is compiled or loaded when this module is imported: the CPU tests
import every module, and there is no `nvcc` there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "neo360_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of csrc/*.cu (all return int = cudaError_t)
SIGNATURES = {
    # table, table_dtype, uv, out, out_dtype, n_views, n_points, h, w, c,
    # zeros_mode, view_offset, total_views, run, stream
    "table_sample_fwd": (_P, _I, _P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _I,
                         _I, _P),
    # t_xz, t_xy, t_yz, table_dtype, cam, out, n_views, n_points, h, w, c,
    # view_offset, total_views, run, stream
    "triplane_sample_fwd": (_P, _P, _P, _I, _P, _P, _I, _L, _I, _I, _I, _I,
                            _I, _I, _P),
    # table, table_dtype, cam, focal, centre, sx, sy, out, n_views,
    # m_points, h, w, c, view_offset, total_views, run, stream
    "local_sample_fwd": (_P, _I, _P, _P, _P, _F, _F, _P, _I, _L, _I, _I, _I,
                         _I, _I, _I, _P),
    # fg rgb/sigma/t, s_fg, bg rgb/sigma/t, s_bg, dirs, far, n_rays,
    # white_bkgd, comp, fg_comp, bg_comp, fg_acc, bg_acc, fg_w, bg_w,
    # bg_lambda, depth, fg_depth, stream
    "composite_nerfpp_fwd": (_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # latent, logit_yz, logit_xz, logit_xy, out_yz, out_xz, out_xy, scratch,
    # dtype, nv, X, Y, Z, C, stream
    "pillar_collapse_fwd": (_P,) * 8 + (_I,) * 6 + (_P,),
    # grad, grad_dtype, uv, scratch, dtable, table_dtype, n_views, n_points,
    # h, w, c, zeros_mode, view_offset, total_views, table_elems, stream
    "table_sample_bwd": (_P, _I, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _I,
                         _I, _L, _P),
    # grad, grad_dtype, uv, acc, n_views, n_points, h, w, c, zeros_mode,
    # view_offset, total_views, stream
    "table_sample_bwd_acc": (_P, _I, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I,
                             _P),
    # the forward's inputs, then the cotangents of comp, fg_comp, bg_comp,
    # fg_acc, bg_acc, fg_w, bg_w, bg_lambda, depth, fg_depth (null = zero),
    # then d fg rgb, d fg sigma, d bg rgb, d bg sigma, stream
    "composite_nerfpp_bwd": (_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I)
    + (_P,) * 14 + (_P,),
    # latent, 3 logits, 3 floor cotangents, d latent, 3 d logits, scratch,
    # dtype, nv, X, Y, Z, C, stream
    "pillar_collapse_bwd": (_P,) * 12 + (_I,) * 6 + (_P,),
    # rgb, sigma, t, s, dirs, n_rays, white_bkgd, comp, acc, weights,
    # depth, stream
    "composite_vanilla_fwd": (_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P,
                              _P),
    # the forward's inputs, then the cotangents of comp, acc, weights,
    # depth (null = zero), then d rgb, d sigma, stream
    "composite_vanilla_bwd": (_P, _P, _P, _I, _P, _I, _I) + (_P,) * 7,
    # density, tdist, dirs, rgb, s, n_rays, bg, opaque, weights, comp, acc,
    # depth, stream
    "composite_mip_fwd": (_P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P, _P,
                          _P),
    # the forward's inputs, its acc, then the cotangents of weights, comp,
    # acc, depth (null = zero), then d density, d rgb, stream
    "composite_mip_bwd": (_P, _P, _P, _P, _I, _I, _F, _I) + (_P,) * 8,
    # image, image_dtype, uv, out, n_images, n_points, h, w, c, zeros_mode,
    # stream
    "grid_sample_fwd": (_P, _I, _P, _P, _I, _L, _I, _I, _I, _I, _P),
    # grad, uv, scratch, dimage, image_dtype, n_images, n_points, h, w, c,
    # zeros_mode, run, stream
    "grid_sample_bwd": (_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _P),
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# C entry name -> its launches in this process (`launch` counts them)
launches = dict.fromkeys(SIGNATURES, 0)

_lock = threading.Lock()
_lib = None
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of csrc/ need the "
                       "CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # the sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libneo360_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists (one nvcc
    per source, in parallel, then one link); returns its path. The
    compiler's register / spill report is kept in `build_log`."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cmd, _, proc in jobs:
            text, _ = proc.communicate()
            logs.append(text)
            if proc.returncode != 0:
                for _, _, other in jobs:
                    other.kill()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{text}")
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        build_log = "".join(logs)
        os.replace(lib, out)  # atomic: a concurrent build never sees half
    return out


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry `name` on `device` and its current stream (appended as
    the last argument); raise if the launch was refused, else add one to
    `launches[name]`."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1


def compare(out: torch.Tensor, ref: torch.Tensor, rtol: float = 1e-5,
            atol_frac: float = 1e-6) -> dict:
    """A kernel's output against its plain version's.

    Tolerance by output type: float32, `rtol` relative (default 1e-5);
    bfloat16, one bf16 ulp of the larger magnitude (both sides round the
    same float32 sum, and summation order may put them on either side of a
    rounding edge). Both add `atol_frac` * max|ref| (default 1e-6) for the
    summation-order error of results that cancel to near zero. Returns
    {max_abs, max_rel, ok}."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise ValueError(f"compare: {out.dtype} {tuple(out.shape)} vs "
                         f"{ref.dtype} {tuple(ref.shape)}")
    o, r = out.double(), ref.double()
    err = (o - r).abs()
    mag = torch.maximum(o.abs(), r.abs())
    if out.dtype == torch.bfloat16:
        _, exp = torch.frexp(mag.clamp(min=2.0 ** -126))
        allowed = torch.ldexp(torch.ones_like(mag), exp - 8)
    else:
        allowed = rtol * mag
    scale = float(r.abs().max()) if r.numel() else 0.0
    ok = bool(torch.all(err <= allowed + atol_frac * scale)) and \
        bool(torch.all(torch.isfinite(o) == torch.isfinite(r)))
    rel = err / mag.clamp(min=1e-30)
    return {"max_abs": float(err.nan_to_num(0.0).max()) if err.numel()
            else 0.0,
            "max_rel": float(rel.nan_to_num(0.0).max()) if rel.numel()
            else 0.0,
            "ok": ok}


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def checked(name: str, tensors, shapes) -> tuple:
    """`tensors` made contiguous, on one CUDA device (`require_cuda`) and
    each float32 of its shape in `shapes`; raises ValueError naming `name`
    otherwise. A None (a zero cotangent) stays None."""
    tensors = tuple(None if t is None else t.contiguous() for t in tensors)
    require_cuda(name, *(t for t in tensors if t is not None))
    for t, shape in zip(tensors, shapes, strict=True):
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32):
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return tensors


def plain_grads(plain, args, wrt, grads) -> tuple:
    """The gradients of `plain(*args)` (a sequence of outputs) with respect
    to `args[i]` for each i in `wrt`, for the output cotangents `grads`
    (None = zero), by autograd; zeros where no output reaches an input. A
    wrapper's backward on CPU tensors."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(i in wrt)
                  for i, a in enumerate(args)]
        outs = plain(*leaves)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        inputs = [leaves[i] for i in wrt]
        d = torch.autograd.grad([o for o, _ in pairs], inputs,
                                [g for _, g in pairs], allow_unused=True) \
            if pairs else [None] * len(inputs)
        return tuple(torch.zeros_like(a) if g is None else g
                     for a, g in zip(inputs, d))


def dense(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous and 16-byte aligned, for kernels that load 16-byte
    vectors (copied only if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
