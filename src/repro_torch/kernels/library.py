"""Build, load and count the CUDA kernels.

All kernel sources (`src/repro_torch/csrc/*.cu`) are compiled into one
shared library with a plain C interface, loaded with `ctypes`: one nvcc
process per source, all started together, then one nvcc run that links
the objects. The library is built at first use into
`src/repro_torch/_build/` (listed in `.gitignore`) under a name that
hashes the sources and flags, so an edited source never loads a stale
build. Nothing is built or loaded when this module is imported: the CPU
tests import every module on hosts without `nvcc`.

Build flags: `sm_90a` (Hopper; `wgmma` and `setmaxnreg` exist only
there), `-O3`, and `-fmad=false` so that no multiply is contracted into
an add as an FMA; the sources also spell every multiply, add and divide
as `__fmul_rn`/`__fadd_rn`/`__fdiv_rn`, and the kernels that want an FMA
(the FFMA GEMM in `qgemm.cu`, flash attention's SIMT dots and its
softmax exponent) spell out `__fmaf_rn`/`fmaf`. `-fmad=false` does not
touch `wgmma`: the tensor-core products and sums are the instruction's
own. No `--use_fast_math`: it would flush subnormals and approximate
the division. The library links without `-lcuda`: `hopper.cuh` fetches
`cuTensorMapEncodeTiled` through the runtime. A build from nothing
takes as long as its slowest source (flash attention's thirteen
template instances: ten SIMT, three wgmma); chip_smoke prints the
time and each source's.

Each wrapper adds one to its entry in `LAUNCHES`, and to its route's
entry in `ROUTE_LAUNCHES`, where it launches its kernel, and nowhere
else; flash attention's also to its mask kind's in
`FLASH_KIND_LAUNCHES`. The solver kernels count a launch on the float64
carrier under their name with `_f64` (`kernel_name`): "chop_f64", "qmv_f64",
"qgemm_f64", "trisolve_f64". `reset_launches` sets every count to 0, so
a caller can show which kernels, and which of their routes, a run went
through.

The cold steps of a process, counted (what AOT warmup, `core.aot`,
prepares ahead of traffic): the build (`CACHE["misses"]`: an nvcc run;
`CACHE["hits"]`: a build found at `library_path` and loaded without
one) in a build directory that `set_build_dir` moves before the first
load, and each kernel instance's first launch on a device
(`COLD_LAUNCHES`): CUDA loads a module at its first launch and the
launchers make their one-time `cudaFuncSetAttribute` and SM-count
lookups then. An instance is what a wrapper can tell apart: the count's
name (kernel and carrier), its route (chop's with the form), one format
or per-row ids, the device, and the template the launcher picks (qmv's
padded K on "shfl", trisolve's direction and block, the GEMM's operand
type). A warm launch pays one set lookup for it; `reset_launches` keeps
the record. A wrapper calls
its C launcher through `call` (or `call_packed`), with the tensors'
device made current: the launchers prepare kernels
(`cudaFuncSetAttribute`, the SM count) on the current device.

The launch path is the host's cost of every call, and a solve makes
tens of thousands of short ones, so it does only what a launch needs:
the C entry looked up once, the format's four arguments ready-made per
id and carrier (`fmt_args`), the current stream's handle without a
`torch.cuda.Stream` object (`raw_stream`), and a device switch only
when the tensors' device is not the current one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.precision.chop import fmt_params
from repro_torch.precision.formats import FORMAT_LIST

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

KERNELS = ("chop", "qmv", "qgemm", "qmatmul", "trisolve", "flash_attention",
           "chop_f64", "qmv_f64", "qgemm_f64", "trisolve_f64", "chop_sr")
# The carriers the solver kernels take, and the suffix of their launch
# counts' names; in the order of csrc/chop.cu's carrier codes (0, 1).
CARRIERS = {torch.float32: "", torch.float64: "_f64"}
LAUNCHES = {name: 0 for name in KERNELS}
ROUTE_LAUNCHES = {name: {} for name in KERNELS}
# Flash attention's launches by mask kind (its wrapper's `KINDS`).
FLASH_KIND_LAUNCHES = {"attn": 0, "local": 0, "chunked": 0}

_LOCK = threading.Lock()
_LIB = None
_ENTRIES = {}            # C entry name -> function of the loaded library
BUILD_SECONDS = None     # wall time of the nvcc run this process made
SOURCE_SECONDS = {}      # per source: seconds from the start to its object
CACHE = {"hits": 0, "misses": 0}   # builds found / nvcc runs made
# Kernel instances launched in this process, and the first launch of
# each, in order: (name, route, variant, per_row, device).
_LAUNCHED = set()
COLD_LAUNCHES = []
_COLD_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_Q = ctypes.c_ulonglong
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # one packed `ExprArgs` (csrc/chop.cu, kernels/chop/ops.py `_ARGS`)
    "repro_chop_expr": (_P,),
    # x, random words, out, n, t, emin, xmax_bits, saturate, stream
    "repro_chop_sr": (_P, _P, _P, ctypes.c_longlong, _I, _I, _U, _I, _P),
    # a, v, out, B, M, K, lda, a_b, v_b, t, emin, xmax_bits, saturate,
    # ids, table, chop_out, route, stream
    "repro_qmv_f32": (_P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _U, _I,
                      _P, _P, _I, _I, _P),
    "repro_qmv_f64": (_P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _Q, _I,
                      _P, _P, _I, _I, _P),
    # a, b, c, pa, pb, B, M, N, K, Kp, bk, t, emin, xmax_bits, saturate,
    # ids, table, fmask, chop_out, route, stream
    "repro_qgemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _U,
                    _I, _P, _P, _U, _I, _I, _P),
    # a, b, pa, pb, M, N, K, Kp, t, emin, xmax_bits, saturate, route,
    # stream
    "repro_qgemm_pack": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _I, _I,
                         _P),
    # a, b, c, B, M, N, K, t, emin, xmax_bits, saturate, ids, table,
    # chop_out, stream
    "repro_qgemm_f64": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _Q, _I, _P, _P,
                        _I, _P),
    # lu, b, y, B, n, block, lower, t, emin, xmax_bits, saturate, ids,
    # table, route, stream
    "repro_trisolve_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _I, _P,
                           _P, _I, _P),
    "repro_trisolve_f64": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _Q, _I, _P,
                           _P, _I, _P),
    # q, k, v, o, bh, sq, sk, d, groups, kind, window, chunk, scale,
    # softcap, bf16, route, stream
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _F, _F, _I, _I, _P),
}


def reset_launches() -> None:
    with _LOCK:
        for name in KERNELS:
            LAUNCHES[name] = 0
            ROUTE_LAUNCHES[name].clear()
        for kind in FLASH_KIND_LAUNCHES:
            FLASH_KIND_LAUNCHES[kind] = 0


def kernel_name(name: str, dtype: torch.dtype) -> str:
    """The name a solver kernel's launch on the carrier `dtype` counts
    under: `name` on float32, `name` + "_f64" on float64."""
    return name + CARRIERS[dtype]


def count_launch(name: str, route: str, dev: int = 0,
                 per_row: bool = False, variant=None,
                 kind: str = None) -> None:
    """Count one launch of `name` on `route` (and flash attention's of
    its mask `kind`), and record the instance's first launch on device
    `dev` (module docstring). The counts are exact under threads (a mesh
    executor's shards launch from several)."""
    with _LOCK:
        LAUNCHES[name] += 1
        ROUTE_LAUNCHES[name][route] = ROUTE_LAUNCHES[name].get(route, 0) + 1
        if kind is not None:
            FLASH_KIND_LAUNCHES[kind] += 1
    key = (name, route, variant, per_row, dev)
    if key not in _LAUNCHED:
        with _COLD_LOCK:
            if key not in _LAUNCHED:
                _LAUNCHED.add(key)
                COLD_LAUNCHES.append(key)


def cold_launch_count() -> int:
    """First launches of a kernel instance in this process so far."""
    return len(COLD_LAUNCHES)


def set_build_dir(path=None) -> Path:
    """Build and load the library in `path` (None: `DEFAULT_BUILD_DIR`),
    a directory kept across processes. It takes effect before the
    library's first load; after it the call changes nothing. Returns the
    directory in force."""
    global BUILD_DIR
    with _LOCK:
        if _LIB is None:
            BUILD_DIR = Path(path).resolve() if path is not None \
                else DEFAULT_BUILD_DIR
        return BUILD_DIR


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def library_path(flags=NVCC_FLAGS, cu=None) -> Path:
    """Where the build of `cu` (default: every `csrc/*.cu`) with `flags`
    lives; the name hashes the sources, the headers and the flags."""
    cu = sorted(CSRC.glob("*.cu")) if cu is None else list(cu)
    h = hashlib.sha256()
    for p in cu + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build(flags=NVCC_FLAGS, cu=None) -> Path:
    """Compile every `csrc/*.cu` (or the sources `cu`) with `flags`, one
    nvcc process per source, all at once, and link them into one library
    (no-op when that build exists). Returns its path."""
    global BUILD_SECONDS
    cu = sorted(CSRC.glob("*.cu")) if cu is None else list(cu)
    out = library_path(flags, cu)
    if out.exists():
        CACHE["hits"] += 1
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [out.with_name(f"{out.stem}.{p.stem}.{tag}.o") for p in cu]
    tmp = out.with_suffix(f".{tag}.tmp")
    compile_flags = [f for f in flags if f != "-shared"]
    t0 = time.perf_counter()

    def compile_one(job):
        src, obj = job
        cmd = [_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return src.stem, cmd, proc, time.perf_counter() - t0

    with ThreadPoolExecutor(max(len(cu), 1)) as pool:
        done = list(pool.map(compile_one, zip(cu, objs)))
    failed = None
    for stem, cmd, proc, seconds in done:
        SOURCE_SECONDS[stem] = seconds
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, proc.stderr)
    if failed is None:
        link = [_nvcc(), *flags, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            failed = (link, proc.returncode, proc.stderr)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed is not None:
        cmd, rc, err = failed
        raise RuntimeError("nvcc failed (rc %d):\n%s\n%s"
                           % (rc, " ".join(cmd), err[-8000:]))
    BUILD_SECONDS = time.perf_counter() - t0
    CACHE["misses"] += 1
    os.replace(tmp, out)
    return out


def open_library(path: Path):
    """Load a build and declare the C signatures of the entry points it
    exports."""
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    return lib


def load():
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = open_library(build())
        return _LIB


def use(path: Path) -> None:
    """Make the wrappers launch the kernels of another build from now on
    (a tool that compares builds of the same sources)."""
    global _LIB
    lib = open_library(path)
    with _LOCK:
        _LIB = lib
        _ENTRIES.clear()


# (t, emin, xmax_bits, saturate) of each format id, per carrier, as the C
# launchers take them: xmax_bits is the format's xmax as a pattern of the
# carrier (32 bits on float32, 64 on float64).
_FMT_ARGS = {dtype: tuple((t, emin, xmax_bits, int(sat))
                          for t, emin, xmax_bits, sat
                          in (fmt_params(i, dtype)
                              for i in range(len(FORMAT_LIST))))
             for dtype in CARRIERS}


def fmt_args(fmt_id, dtype=torch.float32):
    """The launchers' four format arguments of a format id on the carrier
    `dtype`."""
    return _FMT_ARGS[dtype][fmt_id]


# The format table of each carrier as the kernels take it for per-row
# formats (`RowFmts` in csrc/chop_core.cuh): NFMT rows of (t, emin,
# xmax_bits as 64 bits, saturate, 0), in host memory that lives as long
# as the process; a launcher copies it into its kernel's arguments.
NFMT = 8
_ROW = struct.Struct("<iiQii")
_TABLES = {}
for _dt, _rows in _FMT_ARGS.items():
    _buf = ctypes.create_string_buffer(_ROW.size * NFMT)
    for _k, (_t, _emin, _xmax, _sat) in enumerate(_rows):
        _ROW.pack_into(_buf, _k * _ROW.size, _t, _emin, _xmax, _sat, 0)
    _TABLES[_dt] = (_buf, ctypes.addressof(_buf))


def format_table(dtype=torch.float32) -> int:
    """The host address of the carrier `dtype`'s format table."""
    return _TABLES[dtype][1]


def row_args(fmt_id, rows, dtype, device):
    """The launchers' arguments for the format `fmt_id`, one id, or the
    per-row formats `rows` (`precision.rows.RowFormats`, None for one id):
    the format arguments of the launch's one format, the ids' device
    pointer (None without) and the table's address (None without). Rows
    that all share one id launch as that format, with no ids."""
    if rows is None or rows.uniform is not None:
        fid = int(fmt_id) if rows is None else rows.uniform
        return fmt_args(fid, dtype), None, None
    ids = rows.ids_on(device)
    return fmt_args(int(rows.host[0]), dtype), ids.data_ptr(), \
        format_table(dtype)


def check_cuda(name: str, *tensors: torch.Tensor,
               dtypes=(torch.float32,), contiguous: bool = True) -> None:
    """The checks every wrapper makes before it hands pointers to a
    kernel: CUDA, one device, one dtype the kernel takes, contiguous
    (unless the kernel takes strides, `contiguous=False`)."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dtype not in dtypes or t.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes one of {dtypes}, "
                            f"got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _entry(name: str):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = getattr(load(), name)
    return fn


def _on_device(dev: int, fn, *args) -> int:
    """fn(*args) with device `dev` current, switched only when it is
    not."""
    if dev == _current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def call(name: str, kernel: str, t: torch.Tensor, *args) -> int:
    """Call the C launcher `name` with `args` and the current stream of
    `t`'s device, with that device current, and raise if it reports an
    error. Returns the device's index."""
    dev = t.get_device()
    check(_on_device(dev, _entry(name), *args, raw_stream(dev)), kernel)
    return dev


def call_packed(name: str, kernel: str, dev: int, args: int) -> None:
    """Call the C launcher `name`, which takes one pointer to its packed
    arguments (`args`, an address; the stream among them), with device
    `dev` current, and raise if it reports an error."""
    check(_on_device(dev, _entry(name), args), kernel)


def check(rc: int, kernel: str) -> None:
    """Raise when a C launcher reported a CUDA error (its
    `cudaGetLastError()` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


# torch's own queries of the handle of a device's current stream
# (`raw_stream(dev)`) and of the current device
# (`torch.cuda.current_stream(d).cuda_stream` builds a Stream object a
# call); the public calls where a build lacks them.
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda dev: torch.cuda.current_stream(dev).cuda_stream)
_current_device = getattr(torch._C, "_cuda_getDevice", None) or \
    torch.cuda.current_device
