"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

``csrc/*.cu`` compile with nvcc, one process per source, all started
together (``source_seconds`` keeps each one's wall time), and link into one shared library with a plain C interface
under ``build/spmv_topk_tpu_torch/`` beside the package, at the first
launch of any kernel. The file name carries a hash of the sources
(headers included) and flags, so an edited source builds anew. Nothing
here runs at import: a host without nvcc or a card imports every module
of the package, and only a launch on a CUDA tensor needs the library.
``ptxas_report`` reads each kernel's registers and spills from the build.

Every C entry point takes its pointers and the CUDA stream as
``c_void_p`` (``bucket_topk``, ``bucket_topk_batch``, ``octet_topk``,
``octet_topk_batch``, ``slice_topk``, ``slice_topk_batch``,
``slice_scores``: one pointer to its arguments packed as int64) and returns ``cudaGetLastError()``;
``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "spmv_topk_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# flags of some sources besides NVCC_FLAGS: the measurement labs' kernels
# flush float denormals to zero, as the TPU does, and round each multiply
# and add apart, as their plain versions do (csrc/lab_common.cuh)
SOURCE_FLAGS = {f"lab_{name}.cu": ["-ftz=true", "-fmad=false"]
                for name in ("kernel", "fused", "h16", "fold", "dma")}

# sources whose object the build keeps beside the library, for
# ``sass_report`` (a dump of one unit takes a second, of the library a
# minute)
SASS_SOURCES = ("lab_batch.cu", "lab_i16.cu", "lab_mxu.cu", "lab_pack16.cu",
                "octet_topk_batch_h16.cu")

_LIB = None
build_seconds = None   # wall seconds of the nvcc build in this process
                       # (0.0 when a built library was reused)
source_seconds = {}    # source -> wall seconds of its nvcc process (a
                       # build in this process)

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_int64
_f32 = ctypes.c_float
# name -> argtypes of each C entry point (all return int: cudaError_t)
_SIGNATURES = {
    "octet_topk": [_vp],    # int64 arguments packed (csrc/octet_topk.cu)
    "octet_topk_occupancy": [_i32] * 5,
    "octet_topk_batch": [_vp],   # int64 arguments packed (octet_topk_batch.cu)
    "octet_topk_batch_h16": [_vp] * 4 + [_i32] * 11 + [_vp, _i64] * 2
    + [_vp] * 3,
    "octet_scores": [_vp] * 4 + [_i32] * 8 + [_vp] * 2 + [_f32, _vp],
    "slice_topk": [_vp],    # int64 arguments packed (csrc/slice_topk.cu)
    "slice_topk_occupancy": [_i32] * 4,
    "slice_topk_batch": [_vp],   # int64 arguments packed (slice_topk_batch.cu)
    "slice_scores": [_vp],  # int64 arguments packed (csrc/slice_scores.cu)
    "slice_scores_occupancy": [_i32] * 3,
    "stream_words": [_vp, _i64] + [_vp] * 3 + [_i32, _vp],
    "bucket_scores": [_vp] * 2 + [_i32] * 5 + [_vp] * 2,
    "bucket_scores_occupancy": [_i32] * 2,
    "bucket_topk": [_vp],   # int64 arguments packed (csrc/bucket_topk.cu)
    "bucket_topk_occupancy": [_i32] * 3,
    "bucket_topk_batch": [_vp],  # packed int64 (bucket_topk_batch.cu)
    "lab_kernel": [_vp] * 2 + [_i32] * 7 + [_vp] * 3,
    "lab_fused": [_vp] * 3 + [_i32] * 6 + [_vp] * 3,
    "lab_h16": [_vp] * 2 + [_i32] * 5 + [_vp] * 3,
    "lab_fold": [_vp] * 2 + [_i32] * 6 + [_vp] * 3,
    "lab_batch": [_vp] * 2 + [_i32] * 6 + [_vp] * 3,
    "lab_dma": [_vp] * 2 + [_i32] * 4 + [_vp] * 2,
    "lab_dma_reduce": [_vp, _i32, _vp, _vp],
    "lab_i16": [_vp] * 2 + [_i32] * 4 + [_vp] * 2,
    "lab_mxu": [_vp] * 2 + [_i32] * 3 + [_vp] * 3,
    "lab_pack16": [_vp] + [_i32] * 4 + [_vp] * 3,
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode()
                       + repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libspmv_topk_kernels-{h.hexdigest()[:16]}.so")


def nvcc_version() -> str:
    """The 'release' line of `nvcc --version`."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.strip().splitlines()[-1]


def lib():
    """The loaded kernel library, built first if needed."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    path = library_path()
    t0 = time.perf_counter()
    if not os.path.exists(path):
        _build(path)
    build_seconds = time.perf_counter() - t0
    so = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = so
    return so


def _compile(cmd):
    """Run one nvcc command: (CompletedProcess, wall seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    return res, time.perf_counter() - t0


def _build(path: str) -> None:
    """nvcc each source to an object, all at once, then link ``path``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    # one thread per nvcc process: each waits on its own, so every source
    # gets its own wall time
    with ThreadPoolExecutor(max_workers=len(srcs)) as ex:
        results = list(ex.map(_compile, [
            [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(os.path.basename(src), []),
             "-c", "-o", obj, src]
            for src, obj in zip(srcs, objs)]))
    logs, failed = [], []
    for src, (res, secs) in zip(srcs, results):
        name = os.path.basename(src)
        source_seconds[name] = secs
        logs.append(f"== {name}\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(logs[-1])
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        for src, obj in zip(srcs, objs):
            if os.path.basename(src) in SASS_SOURCES:
                os.replace(obj, object_path(path, os.path.basename(src)))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(path + ".ptxas.txt", "w") as fh:
        fh.write("\n".join(logs))
    os.replace(tmp, path)   # atomic: concurrent builds agree


def _kernel_name(demangled: str) -> str:
    """``kernel<args>`` of a demangled kernel signature: no return type,
    namespaces, literal casts, parameters or spaces."""
    s = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\w+::", "", demangled)
    s = re.sub(r"\((?:unsigned )?(?:int|bool|long|char)\)", "", s)
    s = re.sub(r"^void ", "", s)
    return s.split("(", 1)[0].replace(" ", "")


def ptxas_report() -> dict:
    """{kernel<template args>: (registers, spill store bytes)} of the
    loaded library's build, from nvcc's ``-Xptxas=-v`` output, the names
    demangled by the toolkit's ``cu++filt``."""
    with open(library_path() + ".ptxas.txt") as fh:
        text = fh.read()
    entries, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            entries.append((name, int(m.group(1)), spill))
            name = None
    if not entries:
        return {}
    cufilt = os.path.join(os.path.dirname(_nvcc()), "cu++filt")
    names = subprocess.run([cufilt, *(e[0] for e in entries)],
                           capture_output=True, text=True, check=True,
                           timeout=60).stdout.splitlines()
    return {_kernel_name(d): (regs, spill)
            for d, (_, regs, spill) in zip(names, entries, strict=True)}


def object_path(library: str, source: str) -> str:
    """Where a build keeps the object of ``source`` (SASS_SOURCES)."""
    return f"{library}.{source}.o"


def _sass_dump(source: str, match: str, obj=None) -> dict:
    """{kernel<template args>: ([(address, opcode, operands, guard)],
    {label: address})} of the kernels of ``source`` (one of SASS_SOURCES,
    or the object or library ``obj``) whose name contains ``match``, from
    the toolkit's ``cuobjdump -sass``: an opcode with its modifiers, the
    guard predicate such as ``"!P0"`` (``""`` for none); a label
    (``.L_x_N:``) at the address of the instruction after it."""
    if obj is None:
        lib()
        obj = object_path(library_path(), source)
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", obj], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    mangled, bodies, cur, pending = [], [], None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = None
            if match in m.group(1):
                mangled.append(m.group(1))
                bodies.append(([], {}))
                cur = bodies[-1]
            pending = []
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@(!?U?P[T0-9]+)\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*)", line)
        if m:
            addr = int(m.group(1), 16)
            cur[0].append((addr, m.group(3), m.group(4).strip(),
                           m.group(2) or ""))
            for label in pending:
                cur[1][label] = addr
            pending = []
    if not mangled:
        return {}
    cufilt = os.path.join(os.path.dirname(_nvcc()), "cu++filt")
    names = subprocess.run([cufilt, *mangled], capture_output=True,
                           text=True, check=True, timeout=60).stdout
    return {_kernel_name(d): b
            for d, b in zip(names.splitlines(), bodies, strict=True)}


def _counts(instructions) -> dict:
    out = {"total": 0}
    for _, op, _, _ in instructions:
        out[op] = out.get(op, 0) + 1
        out["total"] += 1
    return out


def sass_report(source: str, match: str = "") -> dict:
    """{kernel<template args>: {opcode: count}} of the kernels of
    ``source`` (one of SASS_SOURCES, whose object the build keeps) whose
    name contains ``match``, from the toolkit's ``cuobjdump -sass``: an
    opcode with its modifiers, predicates dropped; the key "total" counts
    every instruction."""
    return {k: _counts(ins) for k, (ins, _) in
            _sass_dump(source, match).items()}


def sass_loops(source: str, match: str = "", obj=None) -> dict:
    """{kernel<template args>: [loop, ...]} of the kernels of ``source``
    (or of the object or library ``obj``) whose name contains ``match``:
    each backward branch (a ``BRA`` to a label or address at or before
    it) as dict(start, end, opcodes, trips), the body's instructions from
    the branch's target to the branch, counted as ``sass_report`` counts
    them, and the trips the loop runs as ``loop_trips`` reads them from
    its counter (None where it cannot); innermost (shortest) first."""
    out = {}
    for kern, (ins, labels) in _sass_dump(source, match, obj).items():
        loops = []
        for addr, op, args, _ in ins:
            if op.split(".")[0] != "BRA":
                continue
            m = re.search(r"\(?(\.L_x_\d+)\)?|(0x[0-9a-f]+)", args)
            if m is None:
                continue
            target = labels.get(m.group(1)) if m.group(1) else \
                int(m.group(2), 16)
            if target is None or target > addr:
                continue
            loops.append(dict(start=target, end=addr, opcodes=_counts(
                [i for i in ins if target <= i[0] <= addr]),
                trips=loop_trips(ins, target, addr)))
        out[kern] = sorted(loops, key=lambda lp: lp["end"] - lp["start"])
    return out


# a loop counter's value at entry: SASS that writes a constant
_ZERO_FORMS = {("MOV", ("RZ",)), ("CS2R", ("SRZ",)),
               ("HFMA2.MMA", ("-RZ", "RZ", "0", "0")),
               ("IMAD.MOV.U32", ("RZ", "RZ", "RZ"))}
_CMP = {"GE": lambda a, b: a >= b, "GT": lambda a, b: a > b,
        "LE": lambda a, b: a <= b, "LT": lambda a, b: a < b,
        "EQ": lambda a, b: a == b, "NE": lambda a, b: a != b}
MAX_TRIPS = 1 << 20


def _imm(text: str):
    try:
        return int(text, 0)
    except ValueError:
        return None


def _constant(op: str, operands: list):
    """The constant that instruction (op, dest + operands) writes, or
    None."""
    if (op, tuple(operands[1:])) in _ZERO_FORMS:
        return 0
    if op == "MOV" and len(operands) == 2:
        return _imm(operands[1])
    if op == "IMAD.MOV.U32" and operands[1:3] == ["RZ", "RZ"]:
        return _imm(operands[3]) if len(operands) == 4 else None
    return None


def loop_trips(ins: list, start: int, end: int):
    """The trips of the loop from ``start`` to its backward branch at
    ``end`` (``ins``: ``_sass_dump``'s instructions of one kernel), read
    from its counter: the branch's predicate set by one ISETP in the body
    comparing a register with a constant (or RZ); that register written
    in the body only by one unguarded ``IADD3 R, R, step, RZ``; its value
    at entry the constant that the last instruction before the loop
    writing it sets. The trips are counted by running the counter as the
    SASS does (32-bit, signed unless the compare is .U32); None for a
    loop of any other form or of more than MAX_TRIPS trips."""
    parsed = [(a, op, [x.strip() for x in args.split(",")], g)
              for a, op, args, g in ins]
    body = [i for i in parsed if start <= i[0] <= end]
    if not body or body[-1][1].split(".")[0] != "BRA" or not body[-1][3]:
        return None
    guard = body[-1][3]
    sets = [i for i in body[:-1] if i[1].startswith("ISETP") and not i[3]
            and i[2][0] == guard.lstrip("!")]
    if len(sets) != 1 or len(sets[0][2]) != 5:
        return None
    set_at, cmp_op, (_, pt0, reg, bound, pt1), _ = sets[0]
    mods = cmp_op.split(".")[1:]
    cond = next((c for c in mods if c in _CMP), None)
    bound = 0 if bound == "RZ" else _imm(bound)
    if (pt0, pt1) != ("PT", "PT") or "EX" in mods or mods[-1:] != ["AND"] \
            or cond is None or bound is None or \
            not re.fullmatch(r"R\d+", reg):
        return None
    writes = [i for i in body if i[2][0] == reg]
    if len(writes) != 1:
        return None
    step_at, op, args, g = writes[0]
    step = _imm(args[2]) if len(args) == 4 else None
    if op != "IADD3" or g or args[1] != reg or args[3] != "RZ" or \
            step is None:
        return None
    before = [i for i in parsed if i[0] < start and i[2][0] == reg]
    if not before or before[-1][3]:
        return None
    value = _constant(before[-1][1], before[-1][2])
    if value is None:
        return None
    unsigned = "U32" in mods

    def word(v):
        v &= 0xFFFFFFFF
        return v if unsigned or v < 1 << 31 else v - (1 << 32)

    bound = word(bound)
    for trips in range(1, MAX_TRIPS + 1):
        stepped = word(value + step)
        seen = stepped if step_at < set_at else word(value)
        value = stepped
        if _CMP[cond](seen, bound) == guard.startswith("!"):
            return trips
    return None


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
