"""Build the port's CUDA sources with nvcc and bind them with ctypes.

The sources under ``vitxtgqa_tpu_torch/csrc`` have a plain C interface, so
they compile in seconds: one ``nvcc -gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 -c`` per ``.cu`` file, all started together, then one
``nvcc -shared`` link into ``build/kernels/<source hash>/libvitxtgqa_kernels.so``
beside the package.  The build runs at first use and is keyed on a hash
of the sources and flags, so a changed source rebuilds and an unchanged one
loads the existing library.  There is no fallback: without nvcc, or on a
failed build, this module raises.  ``--use_fast_math`` stays out of the
flags: the decode step's int8 quantization needs IEEE division to match
``quantize_kv`` bit for bit.

Every pointer crosses the ctypes boundary as ``c_void_p`` (or, for the
kernels with many operands, as one array of them, see ``pointers``), the
stream as a ``c_void_p`` holding ``torch.cuda.current_stream().cuda_stream``,
and each C entry returns ``cudaGetLastError()`` (or the cooperative
launch's own error) after its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libvitxtgqa_kernels.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_SIGNATURES = {
    # q, k, v, key_mask, out, lse, seed, k8, ks, v8, vs; batch, seq_len,
    # heads, head_dim, dec_len; threshold; keep_scale; stream
    "vt_flash_attention_merged": [_P] * 11 + [_I] * 5 + [_U, _F, _P],
    # q, k, v, key_mask, out, dout, lse, scratch, dq, dk, dv, seed; batch,
    # seq_len, heads, head_dim, dec_len; threshold; keep_scale; stream
    "vt_flash_attention_merged_bwd": [_P] * 12 + [_I] * 5 + [_U, _F, _P],
    # q, k, v, key_mask, out, lse, seed, strides (12 int64: q, k, v, out);
    # batch, heads, len_q, len_k, head_dim, dec_len, row_offset; threshold;
    # keep_scale; stream
    "vt_flash_attention": [_P] * 8 + [_I] * 7 + [_U, _F, _P],
    # q, k, v, key_mask, out, dout, lse, scratch, dq, dk, dv, seed, strides (24
    # int64: q, k, v, out, dout, dq, dk, dv); batch, heads, len_q, len_k,
    # head_dim, dec_len, row_offset; threshold; keep_scale; stream
    "vt_flash_attention_bwd": [_P] * 13 + [_I] * 7 + [_U, _F, _P],
    # 12 block operands, seed, mask_a_out, mask_f_out, y, x1h, pre1, h,
    # x2h, xb; rows, d, m; threshold; keep_scale, eps; stream
    "vt_block_train_fwd": [_P] * 21 + [_I] * 3 + [_U, _F, _F, _P],
    # g, ctx, x1h, pre1, h, x2h, wo, w1, w2, s1, g1, s2, seed, 12
    # gradients, 5 scratch buffers; rows, d, m; threshold; keep_scale, eps;
    # stream
    "vt_block_train_bwd": [_P] * 30 + [_I] * 3 + [_U, _F, _F, _P],
    # x_q, ctx, wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, res, x32, xb, h, out;
    # rows, d, m; eps; stream
    "vt_fused_block": [_P] * 17 + [_I] * 3 + [_F, _P],
    # pointer array (order in csrc/fused_block_w8a8.cu); rows, d, m; eps;
    # stream
    "vt_fused_block_w8a8": [_P] + [_I] * 3 + [_F, _P],
    # q, k8, ks, mask, out; batch, n, d; scale; stream
    "vt_ptr_scores_int8": [_P] * 5 + [_I] * 3 + [_F, _P],
    # q, k8, ks, v8, vs, key_mask, out; batch, cache_len, heads, head_dim,
    # step, write_offset; stream
    "vt_decode_attention_int8": [_P] * 7 + [_I] * 6 + [_P],
    # q, k, v, key_mask, out; batch, cache_len, heads, head_dim, step,
    # write_offset; stream
    "vt_decode_attention": [_P] * 5 + [_I] * 6 + [_P],
    # pointer array (order in csrc/fused_decode_step.cu); n_layers, batch,
    # cache_len, d, m, heads, step, write_offset; eps; stream
    "vt_fused_decode_step": [_P] + [_I] * 8 + [_F, _P],
    # pointer array (order in csrc/fused_epilogue.cu); batch, d, vp, n, qk,
    # s2, step, dec_len; qk_scale; stream
    "vt_fused_epilogue": [_P] + [_I] * 8 + [_F, _P],
    # x, w1, b1, w2, b2, h, out; rows, d, m, d2; stream
    "vt_fused_ffn": [_P] * 7 + [_I] * 4 + [_P],
    # q, k, v, bias, out, strides (14 int64: csrc/fused_attention.cu);
    # batch, heads, len_q, len_k, head_dim; stream
    "vt_fused_attention": [_P] * 6 + [_I] * 5 + [_P],
}

# launch counts per kernel wrapper: each wrapper adds one where it launches
# its kernel and nowhere else (chip_smoke.py reads them around a forward)
LAUNCHES: Dict[str, int] = {
    "flash_attention_merged": 0,
    "fused_block": 0,
    "fused_block_tanh": 0,
    "decode_attention_int8": 0,
    "decode_attention": 0,
    "fused_decode_step": 0,
    "fused_epilogue": 0,
    "flash_attention_merged_bwd": 0,
    "block_train_fwd": 0,
    "block_train_bwd": 0,
    "fused_block_w8a8": 0,
    "flash_attention_merged_q8": 0,
    "ptr_scores_int8": 0,
    "fused_ffn": 0,
    "fused_attention": 0,
    "flash_attention": 0,
    "flash_attention_bwd": 0,
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), DEFAULT_NVCC]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are compiled from "
        f"{CSRC} with the CUDA toolkit's nvcc; there is no fallback"
    )


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the commands in parallel; return [(cmd, returncode, output,
    seconds since the start)]."""
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    out = []
    for cmd, proc in procs:
        text, _ = proc.communicate()
        out.append((cmd, proc.returncode, text, time.perf_counter() - t0))
    return out


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library path.  Raises RuntimeError if nvcc is missing or fails."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = []
    compiles = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    log = []
    steps = (compiles, [[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                         "-o", str(tmp), *map(str, objs)]])
    for cmds in steps:
        results = _run(cmds)
        log += [" ".join(cmd) + f"\n# {sec:.1f} s\n" + text
                for cmd, _, text, sec in results]
        failed = [(cmd, rc, text) for cmd, rc, text, _ in results if rc != 0]
        if failed:
            (out_dir / "nvcc.log").write_text("\n".join(log))
            cmd, rc, text = failed[0]
            raise RuntimeError(
                f"nvcc failed with exit code {rc} on {cmd[-1]}:\n" + text[-6000:]
            )
    (out_dir / "nvcc.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    return lib


def ptxas_kernels(log, source: str):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    kernel compiled from ``source`` (a file name under csrc/), from the lines
    of a build's nvcc.log (the -Xptxas -v report)."""
    out, mine, name, spills = [], False, None, ("?", "?")
    for ln in log:
        if ln.endswith(".cu") and " -c " in ln:  # the command of one source
            mine, name = ln.endswith("/" + source), None
        elif not mine:
            continue
        elif "Compiling entry function" in ln:
            name, spills = ln.split("'")[1], ("?", "?")
        elif "spill stores" in ln and name:
            parts = ln.replace(",", "").split()
            spills = (parts[parts.index("spill") - 2], parts[parts.index("loads") - 3])
        elif "Used" in ln and "registers" in ln and name:
            out.append((name, int(ln.split("Used ")[1].split()[0]), *spills))
            name = None
    return out


def lib() -> ctypes.CDLL:
    """The bound kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.vt_error_string.argtypes = [ctypes.c_int]
            handle.vt_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        text = lib().vt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")


def pointers(*tensors: torch.Tensor) -> ctypes.Array:
    """The tensors' device pointers as one C array of ``void*``."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    the given dtype (and shape / device, where given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
