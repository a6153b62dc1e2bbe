"""Build and load the package's CUDA kernels, and its host KD-tree.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into an
object file, all sources at once in parallel, and the objects are linked
into one shared library with a plain C interface that ``ctypes`` loads. The
library lands in ``build/torch_kernels/`` at the repository root under a
name carrying a hash of the sources and flags, so an edit to any source rebuilds it on first use and an unchanged
tree reuses it. Nothing is compiled when the package is imported.

The host KD-tree of ``knn="kdtree"`` (``csrc/kdtree.cpp``) is built the same
way by ``g++`` (:func:`build_kdtree`), for the machine that runs it
(``-march=native``): its library's name carries a hash of the source, the
flags and what ``-march=native`` means to the compiler there, so a library
built for another machine or from another source is never loaded.

``LAUNCHES`` counts kernel launches by name. Each wrapper adds one at the
place where it calls into the library, and nowhere else, so a caller can
reset the counts, run a path, and see which kernels the path launched.
"""

import collections
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
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

#: kernel name -> number of launches since the last ``reset_launches()``
LAUNCHES = collections.Counter()

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


KDTREE_SRC = CSRC / "kdtree.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp", "-Wall"]


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_log(lib_path: Path) -> Path:
    return lib_path.with_suffix(".ptxas.log")


def build(csrc: Path = CSRC, out_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels of ``csrc`` into ``out_dir`` if the library for
    this source hash is missing; return its path. The compiler's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
    kept beside the library."""
    lib_path = out_dir / f"libr3d_kernels_{_source_hash(csrc)}.so"
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        objs = []
        for src in sorted(csrc.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed, logs = [], []
        for cmd, proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        _ptxas_log(lib_path).write_text("".join(logs))
        tmp_lib = Path(tmp) / lib_path.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def _gxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the KD-tree cannot be built")
    return cxx


def build_kdtree(src: Path = KDTREE_SRC, out_dir: Path = BUILD_DIR) -> Path:
    """Compile the host KD-tree with ``g++`` into ``out_dir`` if the
    library for this source, these flags and the building machine is missing;
    return its path. A failed build raises."""
    cxx = _gxx()
    # what -march=native selects here: the instruction set the library uses
    target = subprocess.run([cxx, *CXX_FLAGS, "-Q", "--help=target"], check=True,
                            capture_output=True, text=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    h.update(target.encode())
    lib_path = out_dir / f"libr3d_kdtree_{h.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / lib_path.name
        cmd = [cxx, *CXX_FLAGS, "-shared", str(src), "-o", str(tmp_lib)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def ptxas_report(names) -> list:
    """One line per compiled kernel whose (mangled) name contains one of
    ``names``: its registers, shared memory and spills, from the
    ``-Xptxas -v`` report of the last build of this source hash."""
    log = _ptxas_log(build()).read_text().splitlines()
    lines, kernel = [], None
    for line in log:
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and any(n in kernel for n in names) and (
            "spill" in line or "Used" in line
        ):
            lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return lines


def sass_counts(names, opcode: str) -> dict:
    """Per compiled kernel whose (mangled) name contains one of ``names``:
    the number of ``opcode`` instructions (e.g. ``HMMA``, the tensor cores'
    matrix multiply-accumulate) in the library's SASS, read with the
    ``cuobjdump`` of the toolkit that built it."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(cuobjdump), "-sass", str(build())], check=True,
                         capture_output=True, text=True)
    counts, kernel = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            kernel = name if any(n in name for n in names) else None
            if kernel:
                counts[kernel] = 0
        elif kernel and f" {opcode}" in line:
            counts[kernel] += 1
    return counts


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (query, support, scratch, idx_out, d2_out, B, M, N, k, stream)
    "r3d_knn_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (query, support, scratch, idx_out, d2_out, B, M, N, stream)
    "r3d_argmin": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # (query, support, starts, idx_out, d2_out, B, M, N, w, qb, k, stream)
    "r3d_knn_window": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (table, nbr, d2, center, consts, pooled_out, rpe2_out, rows, K, h, n, s, stream)
    "r3d_lfa_round1": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (rpe2, table, nbr, f_in, consts, out, rows, K, h, F, n, s, stream)
    "r3d_lfa_pool2_res": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (rpe2, table, nbr, consts, out, rows, K, h, n, s, stream)
    "r3d_lfa_pool2": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the bfloat16 forms of the three LFA kernels: the same arguments, the
    # rows (table, pooled, rpe2, f_in, out) bfloat16
    "r3d_lfa_round1_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "r3d_lfa_pool2_res_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "r3d_lfa_pool2_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (x, out, rows, ts, stages, stream)
    "r3d_roll_stages": [_P, _P, _I, _I, _I, _P],
    # (priority, scratch, order_out, B, N, n_out, cluster, staged, keys_shared, stream)
    "r3d_select_smallest": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library, its C functions typed."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # (B, N) -> bytes of scratch r3d_argmin / r3d_knn_topk need
    for name in ("r3d_argmin_scratch_bytes", "r3d_knn_topk_scratch_bytes"):
        fn = getattr(lib, name)
        fn.argtypes = [_I, _I]
        fn.restype = ctypes.c_longlong
    # window points -> whether r3d_knn_window scans them with the streaming kernel
    lib.r3d_knn_window_streams.argtypes = [_I]
    lib.r3d_knn_window_streams.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: tuple, device: torch.device, align: int = 1) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (a ``None`` in ``shape`` matches any size) whose data starts
    at a multiple of ``align`` bytes (kernels that copy rows 16 bytes at a
    time ask for 16), and, while grad mode is on, does not require grad:
    the kernels have no backward, so they would cut the autograd graph."""
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{name}: requires grad; the kernels have no backward (run them "
            "under torch.no_grad() or torch.inference_mode())"
        )
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != ts for s, ts in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data not {align}-byte aligned")


def check_status(name: str, status: int) -> None:
    """Raise if a launcher returned a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
