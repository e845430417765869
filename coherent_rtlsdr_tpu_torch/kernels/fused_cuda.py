"""Build and bind the hand-written CUDA kernels of ``kernels/fused.py``,
``kernels/fourstep.py`` and ``kernels/copy.py``.

The sources in ``csrc/`` have a plain C interface. At first use each is
compiled by its own ``nvcc`` process (all started together) for ``sm_90a``
into a shared library under ``build/torch_kernels/`` at the checkout root,
named by a hash of the sources and flags so that a changed source rebuilds,
and loaded with ``ctypes``. Each C entry point launches one kernel, on
PyTorch's current stream; its wrapper here allocates the outputs with
``torch.empty``, checks what the kernel takes, raises on a CUDA error code,
and otherwise adds one to the instance's launch count of that kernel.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from coherent_rtlsdr_tpu_torch.kernels.fused import CLUSTER_M, SLICE_K

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("fused_measure.cu", "fused_apply.cu", "fourstep.cu", "probe_copy.cu")
HEADERS = ("fused_cluster.cuh", "fused_common.cuh", "tc_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The m each C entry point takes. At m = 256 (W = 65536, L = 32768) every
# entry runs a window (or a transform) on a cluster of four CTAs
# (csrc/fused_cluster.cuh).
ADMITTED_M = {
    "fused_measure_ref": (64, 128, 256),
    "fused_measure_i8_spec": (64, 128, 256),
    "fused_measure_i8": (64, 128, 256),
    "fused_apply_spec_i8": (64, 128, 256),
    "fused_apply_i8": (64, 128, 256),
    "fourstep_fft": (64, 128, 256),
    "fused_measure_planes": (64, 128, 256),
    "fused_apply_planes": (64, 128, 256),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return build_dir / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def log_path(source: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """The compiler's output (the ptxas report) kept beside the library."""
    return library_path(source, csrc, build_dir).with_suffix(".log")


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> dict:
    """Compile every source of ``csrc`` whose library or report is missing
    from ``build_dir``, one ``nvcc`` each, in parallel. Returns ``{source:
    ptxas report}`` for every source (the compiler's output, kept beside its
    library) and ``{"seconds": wall time}``; raises with the compiler's
    output if any compile fails."""
    t0 = time.perf_counter()
    lib = lambda src: library_path(src, csrc, build_dir)
    log = lambda src: log_path(src, csrc, build_dir)
    todo = [src for src in SOURCES if not (lib(src).exists() and log(src).exists())]
    nvcc = _nvcc() if todo else None
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in todo:
        out = lib(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode == 0:
            log(src).write_text(text)
            os.replace(tmp, out)
        else:
            failed.append(f"{src} (exit {proc.returncode}):\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    report = {src: log(src).read_text() for src in SOURCES}
    report["seconds"] = time.perf_counter() - t0
    return report


# The measure kernels, all on the tensor cores, by their ptxas_usage names:
# {reference, i8 channels with and without the D store, float channels} x
# m in {64, 128}, and the four as m = 256 cluster kernels.
TC_MEASURE_KERNELS = tuple(
    [f"fused::measure_ref_kernel<{m}>" for m in (64, 128)]
    + [f"fused::measure_kernel<{m}, {d}>" for m in (64, 128) for d in (1, 0)]
    + [f"fused::measure_planes_kernel<{m}>" for m in (64, 128)]
    + ["fused::measure_ref_cluster_kernel", "fused::measure_cluster_kernel<1>",
       "fused::measure_cluster_kernel<0>", "fused::measure_planes_cluster_kernel"])

# The apply kernels, all on the tensor cores, by their ptxas_usage names:
# {the spectrum handoff's persistent kernel, the i8 recompute kernel, the
# float kernel} x m in {64, 128}, and the three as m = 256 cluster kernels.
TC_APPLY_KERNELS = tuple(
    [f"fused::apply_spec_kernel<{m}>" for m in (64, 128)]
    + [f"fused::apply_i8_kernel<{m}>" for m in (64, 128)]
    + [f"fused::apply_planes_kernel<{m}>" for m in (64, 128)]
    + ["fused::apply_spec_cluster_kernel", "fused::apply_i8_cluster_kernel",
       "fused::apply_planes_cluster_kernel"])

# The four-step kernels, forward (0) and inverse (1): the persistent kernel
# at m in {64, 128} and the m = 256 cluster kernel.
TC_FOURSTEP_KERNELS = tuple(
    [f"fourstep::fourstep_kernel<{m}, {inv}>" for m in (64, 128) for inv in (0, 1)]
    + [f"fourstep::fourstep_cluster_kernel<{inv}>" for inv in (0, 1)])

# Each source's tensor-core instantiations, which must use no stack frame
# and spill nothing.
TC_KERNELS = {"fused_measure.cu": TC_MEASURE_KERNELS, "fused_apply.cu": TC_APPLY_KERNELS,
              "fourstep.cu": TC_FOURSTEP_KERNELS}


def _kernel_name(mangled: str) -> str:
    """``ns::name<1, 2>`` for the Itanium-mangled name of a function
    template in a namespace with integer or bool arguments (every kernel
    here); any other name as it is."""
    if not mangled.startswith("_ZN"):
        return mangled
    parts, i = [], 3
    while i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group()
        i += len(n)
        parts.append(mangled[i:i + int(n)])
        i += int(n)
    args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[i:])
    if args is None:
        return "::".join(parts)
    return "::".join(parts) + "<" + ", ".join(re.findall(r"L[a-z](\d+)E", args.group(1))) + ">"


def ptxas_usage(report: str) -> dict:
    """Each kernel of a ptxas report (``nvcc -Xptxas -v``), by
    ``_kernel_name``: ``{"registers", "stack", "spill_stores",
    "spill_loads"}`` (bytes but for the registers)."""
    entries, props, cur = set(), {}, None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entries.add(m.group(1))
        elif m := re.search(r"Function properties for (\S+)", line):
            cur = props.setdefault(m.group(1), {})
        elif cur is not None and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
    return {_kernel_name(name): v for name, v in props.items() if name in entries}


_P = ctypes.c_void_p
_I = ctypes.c_int


# C entry points: (source, name, pointer arguments, int arguments), each
# followed by the stream.
ENTRY_POINTS = (
    ("fused_measure.cu", "fused_measure_ref", 5, 2),
    ("fused_measure.cu", "fused_measure_i8_spec", 12, 3),
    ("fused_measure.cu", "fused_measure_i8", 10, 3),
    ("fused_measure.cu", "fused_measure_planes", 10, 3),
    ("fused_apply.cu", "fused_apply_spec_i8", 8, 3),
    ("fused_apply.cu", "fused_apply_i8", 8, 3),
    ("fused_apply.cu", "fused_apply_planes", 8, 3),
    ("fourstep.cu", "fourstep_fft", 4, 3),
    ("probe_copy.cu", "probe_copy_blocks", 2, 4),
)


@functools.lru_cache(maxsize=None)
def _functions(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> dict:
    """The C entry points by name, one kernel each, of the sources in
    ``csrc`` built into ``build_dir``."""
    build(csrc, build_dir)
    libs = {src: ctypes.CDLL(str(library_path(src, csrc, build_dir))) for src in SOURCES}
    fns = {}
    for src, name, n_ptr, n_int in ENTRY_POINTS:
        fn = getattr(libs[src], name)
        fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
        fn.restype = _I
        fns[name] = fn
    return fns


def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _expect(x: torch.Tensor, name, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"{name}: need {dtype} {tuple(shape)} on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _aligned(*xs):
    """The tensors contiguous and 16-byte aligned (the kernels read up to
    16-byte vectors from each base): a view that is neither is copied."""
    out = [x.contiguous() for x in xs]
    return [x.clone() if x.data_ptr() % 16 else x for x in out]


def _dense(name, x: torch.Tensor):
    """Raise unless ``x`` is contiguous and 16-byte aligned (the four-step
    and copy kernels take no view)."""
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: need a contiguous tensor on a 16-byte boundary, got "
                         f"strides {x.stride()} at address {x.data_ptr():#x}")


@functools.lru_cache(maxsize=None)
def _tables(fft):
    """Interleaved (re, im) float32 [m, m, 2] tables of a bf16
    ``FFT4Step`` on its device, built once an instance: F and conj(F)/m as
    their bf16-rounded values, and the twiddle."""
    pair = lambda re, im: torch.stack([re, im], dim=-1).contiguous()
    return pair(fft.fre, fft.fim), pair(fft.fire, fft.fiim), pair(fft.tre, fft.tim)


def _fused_tables(k):
    """F, Fi and the twiddle as the measure and apply kernels take them: the
    float32 pairs of ``_tables``, but F and Fi as the instance's packed
    k-slices at m = 256 (``fused.cluster_slices``)."""
    F, Fi, Tw = _tables(k.fft)
    if k.m == CLUSTER_M:
        F, Fi = k.f_slices, k.fi_slices
    return F, Fi, Tw


# The packed k-slices of F or Fi at m = 256 (``fused.cluster_slices``).
SLICES_SHAPE = (CLUSTER_M // SLICE_K, 2, CLUSTER_M // 8, 2, 8, 8)


def admit(entry: str, m: int):
    """Raise ``ValueError`` unless the C entry point ``entry`` takes m."""
    if m not in ADMITTED_M[entry]:
        raise ValueError(f"{entry} takes m in {ADMITTED_M[entry]}, got m = {m}")


def _setup(k, x: torch.Tensor, entry: str):
    admit(entry, k.m)
    if x.device != k.device:
        raise ValueError(f"inputs on {x.device}, kernels built for {k.device}")
    return _functions(), torch.cuda.current_stream(x.device).cuda_stream


def measure_ref(k, ref_raw: torch.Tensor):
    """Launch ``fused_measure_ref`` (see ``FusedPipelineKernels.measure_ref``)."""
    fns, stream = _setup(k, ref_raw, "fused_measure_ref")
    F, _, Tw = _fused_tables(k)
    m = k.m
    T = ref_raw.shape[0]
    if T < 2:
        raise ValueError(f"measure_ref needs at least 2 blocks, got {T}")
    dev = ref_raw.device
    _expect(ref_raw, "ref_raw", torch.int8, (T, m // 2, 2 * m), dev)
    (ref_raw,) = _aligned(ref_raw)
    R = torch.empty((T - 1, m, m, 2), dtype=torch.float32, device=dev)
    eref = torch.empty((T - 1,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = fns["fused_measure_ref"](ref_raw.data_ptr(), F.data_ptr(), Tw.data_ptr(),
                                      R.data_ptr(), eref.data_ptr(), T - 1, m, stream)
    _check("fused_measure_ref", rc)
    k.measure_ref_launches += 1
    return R, eref


def _expect_raw(raw, name, m):
    """``raw`` int8 ``[T, N, m/2, 2m]`` with T >= 2; returns (T - 1, N)."""
    T, N = raw.shape[:2]
    if T < 2:
        raise ValueError(f"{name} needs at least 2 blocks, got {T}")
    _expect(raw, "raw", torch.int8, (T, N, m // 2, 2 * m), raw.device)
    return T - 1, N


def _measure_channels(k, raw, R, eref, store_d: bool):
    """Launch ``fused_measure_i8_spec`` (``store_d``) or ``fused_measure_i8``
    on int8 blocks against the reference spectra of ``measure_ref``."""
    name = "fused_measure_i8_spec" if store_d else "fused_measure_i8"
    fns, stream = _setup(k, raw, name)
    F, _, Tw = _fused_tables(k)
    m, dev = k.m, raw.device
    T1, N = _expect_raw(raw, name, m)
    _expect(R, "R", torch.float32, (T1, m, m, 2), dev)
    _expect(eref, "eref", torch.float32, (T1,), dev)
    raw, R, eref = _aligned(raw, R, eref)
    scal = [torch.empty((T1, N), dtype=torch.float32, device=dev) for _ in range(5)]
    d = ([torch.empty((T1, N, m, m), dtype=torch.bfloat16, device=dev) for _ in range(2)]
         if store_d else [])
    with torch.cuda.device(dev):
        rc = fns[name](raw.data_ptr(), F.data_ptr(), Tw.data_ptr(), R.data_ptr(),
                       eref.data_ptr(), *(x.data_ptr() for x in scal + d), T1, N, m, stream)
    _check(name, rc)
    return (*scal, *d)


def measure_spec(k, raw: torch.Tensor, R: torch.Tensor, eref: torch.Tensor):
    """Launch ``fused_measure_i8_spec`` (see ``FusedPipelineKernels.measure_spec``)."""
    out = _measure_channels(k, raw, R, eref, store_d=True)
    k.measure_spec_launches += 1
    return out


def measure_i8(k, raw: torch.Tensor, R: torch.Tensor, eref: torch.Tensor):
    """Launch ``fused_measure_i8`` (see ``FusedPipelineKernels.measure_i8``):
    the five scalars of ``measure_spec``, no spectrum stored."""
    out = _measure_channels(k, raw, R, eref, store_d=False)
    k.measure_i8_launches += 1
    return out


def apply_spec_i8(k, dre, dim, advance, phase_re, phase_im):
    """Launch ``fused_apply_spec_i8`` (see ``FusedPipelineKernels.apply_spec_i8``)."""
    fns, stream = _setup(k, dre, "fused_apply_spec_i8")
    _, Fi, Tw = _fused_tables(k)
    m = k.m
    T1, N = dre.shape[:2]
    dev = dre.device
    for name, x in (("dre", dre), ("dim", dim)):
        _expect(x, name, torch.bfloat16, (T1, N, m, m), dev)
    for name, x in (("advance", advance), ("phase_re", phase_re), ("phase_im", phase_im)):
        _expect(x, name, torch.float32, (T1, N), dev)
    args = _aligned(dre, dim, advance, phase_re, phase_im)
    out = torch.empty((T1, N, m // 2, 2 * m), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        rc = fns["fused_apply_spec_i8"](*(x.data_ptr() for x in args), Fi.data_ptr(),
                                        Tw.data_ptr(), out.data_ptr(), T1, N, m, stream)
    _check("fused_apply_spec_i8", rc)
    k.apply_spec_i8_launches += 1
    return out


def apply_i8(k, raw, advance, phase_re, phase_im):
    """Launch ``fused_apply_i8`` (see ``FusedPipelineKernels.apply_i8``)."""
    fns, stream = _setup(k, raw, "fused_apply_i8")
    F, Fi, Tw = _fused_tables(k)
    m, dev = k.m, raw.device
    T1, N = _expect_raw(raw, "fused_apply_i8", m)
    for name, x in (("advance", advance), ("phase_re", phase_re), ("phase_im", phase_im)):
        _expect(x, name, torch.float32, (T1, N), dev)
    args = _aligned(raw, advance, phase_re, phase_im)
    out = torch.empty((T1, N, m // 2, 2 * m), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        rc = fns["fused_apply_i8"](*(x.data_ptr() for x in args), F.data_ptr(), Fi.data_ptr(),
                                   Tw.data_ptr(), out.data_ptr(), T1, N, m, stream)
    _check("fused_apply_i8", rc)
    k.apply_i8_launches += 1
    return out


def _expect_planes(pre, pim, dev, m):
    T, N = pre.shape[:2]
    if T < 2:
        raise ValueError(f"the float kernels need at least 2 blocks, got {T}")
    for name, x in (("pre", pre), ("pim", pim)):
        _expect(x, name, torch.bfloat16, (T, N, m // 2, m), dev)
    return T - 1, N


def measure_planes(k, pre, pim, rre, rim):
    """Launch ``fused_measure_planes`` (see ``FusedPipelineKernels.measure``)."""
    fns, stream = _setup(k, pre, "fused_measure_planes")
    F, _, Tw = _fused_tables(k)
    m, dev = k.m, pre.device
    T1, N = _expect_planes(pre, pim, dev, m)
    for name, x in (("rre", rre), ("rim", rim)):
        _expect(x, name, torch.bfloat16, (T1, m, m), dev)
    args = _aligned(pre, pim, rre, rim)
    out = [torch.empty((T1, N), dtype=torch.float32, device=dev) for _ in range(4)]
    with torch.cuda.device(dev):
        rc = fns["fused_measure_planes"](*(x.data_ptr() for x in args), F.data_ptr(),
                                         Tw.data_ptr(), *(o.data_ptr() for o in out),
                                         T1, N, m, stream)
    _check("fused_measure_planes", rc)
    k.measure_launches += 1
    return tuple(out)


def apply_planes(k, pre, pim, advance):
    """Launch ``fused_apply_planes`` (see ``FusedPipelineKernels.apply``)."""
    fns, stream = _setup(k, pre, "fused_apply_planes")
    F, Fi, Tw = _fused_tables(k)
    m, dev = k.m, pre.device
    T1, N = _expect_planes(pre, pim, dev, m)
    _expect(advance, "advance", torch.float32, (T1, N), dev)
    args = _aligned(pre, pim, advance)
    yre = torch.empty((T1, N, m * m // 2), dtype=torch.float32, device=dev)
    yim = torch.empty_like(yre)
    with torch.cuda.device(dev):
        rc = fns["fused_apply_planes"](*(x.data_ptr() for x in args), F.data_ptr(),
                                       Fi.data_ptr(), Tw.data_ptr(), yre.data_ptr(),
                                       yim.data_ptr(), T1, N, m, stream)
    _check("fused_apply_planes", rc)
    k.apply_launches += 1
    return yre, yim


def fourstep(k, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Launch ``fourstep_fft`` on ``x`` complex64 ``[B, m, m]`` (see
    ``FFT4StepKernel``), with the instance's packed bf16 table of F or Fi
    (its planes at m in {64, 128}, its k-slices at m = 256) and the float32
    twiddle of its plain version; returns complex64 ``[B, m, m]``."""
    fns, stream = _setup(k, x, "fourstep_fft")
    Tw = _tables(k.plain)[2]
    m, dev = k.m, x.device
    B = x.shape[0]
    if B < 1:
        raise ValueError("fourstep_fft: need at least one transform")
    _expect(x, "x", torch.complex64, (B, m, m), dev)
    tab = k.fi_packed if inverse else k.f_packed
    _expect(tab, "table", torch.bfloat16,
            SLICES_SHAPE if m == CLUSTER_M else (2, m, m), dev)
    for name, v in (("x", x), ("table", tab), ("twiddle", Tw)):
        _dense(name, v)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = fns["fourstep_fft"](x.data_ptr(), tab.data_ptr(), Tw.data_ptr(), y.data_ptr(), B, m,
                                 int(inverse), stream)
    _check("fourstep_fft", rc)
    if inverse:
        k.ifft_launches += 1
    else:
        k.fft_launches += 1
    return y


def copy_blocks(c, x: torch.Tensor, nc: int) -> torch.Tensor:
    """Launch ``probe_copy_blocks`` on ``x`` int8 ``[T, N, m/2, 2m]``
    (contiguous, 16-byte aligned) with ``nc`` channels a CTA (see
    ``BlockCopy.copy``); returns the copy."""
    if x.dtype != torch.int8 or x.dim() != 4 or x.shape[3] != 4 * x.shape[2]:
        raise ValueError(f"copy_blocks: need int8 [T, N, m/2, 2m], got {x.dtype} "
                         f"{tuple(x.shape)}")
    T, N = x.shape[:2]
    W = x.shape[2] * x.shape[3]
    if T < 1 or nc < 1 or N % nc or W % 16:
        raise ValueError(f"copy_blocks: need T >= 1, N a multiple of nc and m*m a multiple "
                         f"of 16, got T = {T}, N = {N}, nc = {nc}, m*m = {W}")
    fns = _functions()
    _dense("copy_blocks", x)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = fns["probe_copy_blocks"](x.data_ptr(), y.data_ptr(), T, N, W, nc,
                                      torch.cuda.current_stream(x.device).cuda_stream)
    _check("probe_copy_blocks", rc)
    c.copy_launches += 1
    return y
