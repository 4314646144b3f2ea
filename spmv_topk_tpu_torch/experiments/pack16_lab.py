"""16-bit packed arithmetic lab (L9) on the H100: does a 16-bit type run
its multiply-add chains at twice the element rate of a 32-bit one
(experiments/pack16_lab.py)?

Each case is one (sub, 128) tile x of one type (pack16_lab.py:59-66):

  f32_8, f32_16     float32, 8 and 16 rows
  bf16_16, bf16_32  bfloat16, 16 and 32 rows (the same bytes as f32's)
  int16_16          int16, 16 rows
  int32_8           int32, 8 rows

and the lab's function is acc = acc * x + x, REPS = 512 times from acc =
x, each multiply and add rounded in the tile's type (integers wrap). The
TPU lab runs it on each of GRID = 512 grid steps, every step writing the
same tile; the kernel (``csrc/lab_pack16.cu``) runs GRID CUDA blocks, each
computing the whole tile, so the element-op count is the lab's: 2 * REPS
* GRID * sub * 128. Data as the lab draws it from default_rng(0), case by
case: floats standard_normal((sub, 128)) * 1e-3, integers integers(1, 3,
(sub, 128)) (pack16_lab.py:58-73; bf16 rounded through float32, as
jnp.asarray rounds it).

``pack16_plain`` runs the rounds with torch ops in the tile's type (each
op rounds its result, as the kernel does), ``pack16_device`` launches the
kernel on a CUDA tensor and runs ``pack16_plain`` on a CPU one; the two
are equal bit for bit. ``main()`` times each case as the lab does
(pack16_lab.py:78-91): the slope between 12 and 2 chained calls on inputs
x + i, median of 5, here between CUDA events, and prints the lab's ms,
cycles per tile-op at the card's SM clock (nvidia-smi's ``clocks.max.sm``,
named in the line), element-ops per second, and the bound at the rate
at which the card issues the chain's instructions for the type
(``RATES``).

    python -m spmv_topk_tpu_torch.experiments.pack16_lab [case ...]
        [--device cpu]
"""

from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

from ._common import parse_args

LANES = 128
REPS = 512          # mul+add pairs per grid step (pack16_lab.py:29)
GRID = 512          # grid steps, here CUDA blocks (pack16_lab.py:30)
# the kernel's dtype argument (csrc/lab_pack16.cu, enum Dtype)
DTYPES = (torch.float32, torch.bfloat16, torch.int16, torch.int32)
# (name, dtype, sub) in the lab's order (pack16_lab.py:59-66)
CASES = (("f32_8", torch.float32, 8), ("f32_16", torch.float32, 16),
         ("bf16_16", torch.bfloat16, 16), ("bf16_32", torch.bfloat16, 32),
         ("int16_16", torch.int16, 16), ("int32_8", torch.int32, 8))
NAMES = tuple(c[0] for c in CASES)
LAB_NAMES = dict(zip(NAMES, ("f32 (8,128)", "f32 (16,128)", "bf16 (16,128)",
                             "bf16 (32,128)", "int16 (16,128)",
                             "int32 (8,128)")))
# NVIDIA H100 SXM, element-ops per second outside the tensor cores as the
# chains issue them: a multiply and an add each rounded, so the float
# chains issue FMUL and FADD apart (bf16 as HMUL2 and HADD2 on pairs), at
# half the FMA-counted peak (f32 67 TFLOPS, the H100 data sheet; bf16
# 133.8, the Hopper architecture white paper's table of peak rates, SXM5);
# an integer multiply-add is one IMAD at the int32 units' rate, which the
# white paper's INT32 33.5 TOPS counts as two ops; int16 runs on the int32
# units (no packed 16-bit integer arithmetic, PERF.md's L6 finding)
RATES = {torch.float32: 33.5e12, torch.bfloat16: 66.9e12,
         torch.int16: 33.5e12, torch.int32: 33.5e12}
RATE_SOURCES = {
    torch.float32: "H100 SXM data sheet: FP32 67 TFLOPS counting an FMA "
                   "as two; FMUL and FADD issue apart: 33.5e12",
    torch.bfloat16: "Hopper white paper, H100 SXM5: BF16 (non-Tensor) "
                    "133.8 TFLOPS counting an HFMA2 as four; HMUL2 and "
                    "HADD2 issue apart: 66.9e12",
    torch.int16: "Hopper white paper, H100 SXM5: INT32 33.5 TOPS, one "
                 "IMAD a multiply-add (int16 on the int32 units)",
    torch.int32: "Hopper white paper, H100 SXM5: INT32 33.5 TOPS, one "
                 "IMAD a multiply-add"}


def case(name: str):
    """(dtype, sub) of a case."""
    for n, dt, sub in CASES:
        if n == name:
            return dt, sub
    raise ValueError(f"unknown case {name!r}: choose from {', '.join(NAMES)}")


def pack16_data(seed: int = 0) -> dict:
    """name -> the case's tile x as a CPU tensor, drawn from
    default_rng(seed) case after case as pack16_lab.py:58-73 draws them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, dt, sub in CASES:
        if dt in (torch.int16, torch.int32):
            x = torch.from_numpy(rng.integers(1, 3, (sub, LANES))).to(dt)
        else:
            x = torch.from_numpy((rng.standard_normal((sub, LANES)) * 1e-3)
                                 .astype(np.float32)).to(dt)
        out[name] = x.contiguous()
    return out


def _check(x):
    if x.ndim != 2 or x.shape[1] != LANES or x.dtype not in DTYPES or \
            not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (sub, {LANES}) tile of "
                         f"{', '.join(map(str, DTYPES))}, got {x.dtype} "
                         f"{tuple(x.shape)}")


def pack16_plain(x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """Plain PyTorch version: ``reps`` rounds of acc = acc * x + x from acc
    = x, in x's type: float ops rounded one at a time (torch's float32 and
    bfloat16 tensors round each op's result), integers wrapping (computed
    in int64, reduced each round)."""
    _check(x)
    if x.dtype.is_floating_point:
        acc = x
        for _ in range(reps):
            acc = acc * x + x
        return acc
    bits = torch.iinfo(x.dtype).bits
    mask = (1 << bits) - 1
    xl = x.long() & mask
    acc = xl
    for _ in range(reps):
        acc = (acc * xl + xl) & mask
    return torch.where(acc >= 1 << (bits - 1), acc - (1 << bits),
                       acc).to(x.dtype)


def pack16_device(x: torch.Tensor, *, grid: int = GRID) -> torch.Tensor:
    """The lab kernel (csrc/lab_pack16.cu) on a CUDA tensor: ``grid`` CUDA
    blocks each compute REPS rounds of the whole tile and write it (the
    same bits); returns the (sub, 128) tile. A CPU tensor runs
    ``pack16_plain``."""
    _check(x)
    if x.device.type == "cpu":
        return pack16_plain(x)
    from ..ops.kernel import _launch

    out = torch.empty_like(x)
    _launch(x.device, "lab_pack16", x.data_ptr(), DTYPES.index(x.dtype),
            x.shape[0], grid, out.data_ptr())
    pack16_device.launches += 1
    return out


pack16_device.launches = 0


def element_ops(sub: int, reps: int = REPS, grid: int = GRID) -> int:
    """Element-ops of one call: a multiply and an add per round, element
    and grid step."""
    return 2 * reps * grid * sub * LANES


def bound_ms(dtype, sub: int) -> float:
    """The least time, ms, of one call at the card's rate for the type."""
    return element_ops(sub) / RATES[dtype] * 1e3


def sm_clock_hz(dev) -> float:
    """The card's maximum SM clock (nvidia-smi ``clocks.max.sm``, MHz)."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def _chain_ms(xs) -> float:
    """ms of ``pack16_device`` over each tile of ``xs`` in turn, between
    two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for xx in xs:
        pack16_device(xx)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def slope_ms(x: torch.Tensor, runs: int = 5) -> float:
    """ms of one call as the lab times it: (12 chained calls - 2) / 10 on
    inputs x + i, the median of ``runs``."""
    xs = {n: [x + i for i in range(n)] for n in (2, 12)}
    for n in (2, 12):           # build and warm
        _chain_ms(xs[n])
    torch.cuda.synchronize()
    return statistics.median((_chain_ms(xs[12]) - _chain_ms(xs[2])) / 10.0
                             for _ in range(runs))


def report(name: str, ms, clock_hz) -> dict:
    """The lab's line (pack16_lab.py:92-95) for a case: ms, cycles per
    tile-op (2 * REPS * GRID ops) at ``clock_hz``, element-ops per second;
    beside them the bound and its rate's source."""
    dt, sub = case(name)
    ops = 2 * REPS * GRID
    elems = element_ops(sub)
    line = dict(lab="pack16_lab", case=name, lab_name=LAB_NAMES[name],
                dtype=str(dt).replace("torch.", ""), sub=sub, reps=REPS,
                grid=GRID, element_ops=elems, ms=ms, cyc_per_op=None,
                telem_op_per_s=None, sm_clock_hz=clock_hz,
                clock_source="nvidia-smi clocks.max.sm",
                bound_ms=bound_ms(dt, sub), bound_by="operations",
                rate_per_s=RATES[dt], rate_source=RATE_SOURCES[dt])
    if ms:
        line.update(cyc_per_op=ms * 1e-3 * clock_hz / ops,
                    telem_op_per_s=elems / (ms * 1e-3) / 1e12)
    return line


def main(argv=None):
    names, dev = parse_args(argv, NAMES, NAMES, __doc__)
    data = pack16_data()
    cuda = dev.type == "cuda"
    if cuda:
        from ._common import smi_line

        print(smi_line(), flush=True)
    clock = sm_clock_hz(dev) if cuda else None
    print(f"{REPS} mul+add pairs x {GRID} grid steps", flush=True)
    lines = []
    for name in names:
        x = data[name].to(dev)
        out = pack16_device(x)
        line = report(name, slope_ms(x) if cuda else None, clock)
        line["device"] = torch.cuda.get_device_name(dev) if cuda else "cpu"
        line["finite_share"] = float(torch.isfinite(out.float()).float()
                                     .mean())
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
