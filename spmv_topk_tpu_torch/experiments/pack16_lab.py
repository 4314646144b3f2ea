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
same tile; the kernel (``csrc/lab_pack16.cu``) runs GRID copies of the
tile's chains, each writing a tile of its own, so the element-op count
is the lab's: 2 * REPS * GRID * sub * 128. Its launch is one wave, WARPS
warps a block and one block an SM (``pack16_blocks``); an item is
CHAINS[dtype] chains (rows, or bf16 row pairs) of one lane-warp of one
copy, and the warps take equal shares of the items (``warp_items``,
``item_chains``); the rounds run in a rolled loop of UNROLL rounds a
trip. Data as the lab draws it from default_rng(0), case by case:
floats standard_normal((sub, 128)) * 1e-3, integers integers(1, 3, (sub,
128)) (pack16_lab.py:58-73; bf16 rounded through float32, as jnp.asarray
rounds it).

``pack16_plain`` runs the rounds with torch ops in the tile's type (each
op rounds its result, as the kernel does), ``pack16_device`` launches the
kernel on a CUDA tensor and runs ``pack16_plain`` on a CPU one; the two
are equal bit for bit. ``main()`` times each case as the lab does
(pack16_lab.py:78-91): the slope between 12 and 2 chained calls on inputs
x + i, median of 5, here between CUDA events with the stream held while
the host enqueues each chain (the card's time, not the host's: the
kernel takes about as long as a call's host work), and prints the lab's ms,
cycles per tile-op at the card's SM clock (nvidia-smi's ``clocks.max.sm``,
named in the line) and at the clock the card held while the case ran
(``held_clock``: a diagnostic launch's clock64 cycles over %globaltimer
nanoseconds), element-ops per second, and the bound at the rate at which
the card issues the chain's instructions for the type (``RATES``).

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
GRID = 512          # grid steps, here copies of the chains (pack16_lab.py:30)
# the kernel's shape (csrc/lab_pack16.cu: kUnroll, kWarps, each type's
# kChains)
UNROLL = 16         # rounds a trip of the rolled round loop
WARPS = 16          # warps a block, one block an SM
# the kernel's dtype argument (csrc/lab_pack16.cu, enum Dtype)
DTYPES = (torch.float32, torch.bfloat16, torch.int16, torch.int32)
# chains a thread runs together (an item): rows, or bf16 row pairs
CHAINS = {torch.float32: 8, torch.bfloat16: 4, torch.int16: 8,
          torch.int32: 8}
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


def pack16_device(x: torch.Tensor, *, grid: int = GRID,
                  clocks=None) -> torch.Tensor:
    """The lab kernel (csrc/lab_pack16.cu) on a CUDA tensor: ``grid``
    copies of the tile's chains (the lab's grid steps), REPS rounds each,
    each copy writing a tile of its own ((grid, sub, 128), the same bits;
    the first returned). ``clocks``: None, or a CUDA int64
    (``pack16_blocks``, 4) tensor the launch fills per block (SM id,
    clock64 cycles, %globaltimer ns at its first and last instruction). A
    CPU tensor runs ``pack16_plain``."""
    _check(x)
    if x.device.type == "cpu":
        return pack16_plain(x)
    from ..ops.kernel import _launch

    blocks = pack16_blocks(x.device)
    if clocks is not None and (clocks.device != x.device or
                               clocks.dtype != torch.int64 or
                               tuple(clocks.shape) != (blocks, 4)):
        raise ValueError(f"clocks: need int64 ({blocks}, 4) on {x.device}")
    out = torch.empty((grid, *x.shape), dtype=x.dtype, device=x.device)
    _launch(x.device, "lab_pack16", x.data_ptr(), DTYPES.index(x.dtype),
            x.shape[0], grid, blocks, out.data_ptr(),
            0 if clocks is None else clocks.data_ptr())
    pack16_device.launches += 1
    return out[0]


pack16_device.launches = 0


def pack16_blocks(dev) -> int:
    """The kernel's CUDA grid on ``dev``: one block of WARPS warps an SM
    (the SM count, read once per device)."""
    from ..ops.kernel import _device_info

    return _device_info(dev)[0]


def pack16_items(dtype, sub: int, grid: int = GRID) -> int:
    """The kernel's items for a case: ``grid`` copies x the tile's chain
    groups (CHAINS[dtype] chains of a lane, rows or bf16 row pairs) x 4
    lane-warps."""
    pack = 2 if dtype == torch.bfloat16 else 1
    if sub % (pack * CHAINS[dtype]):
        raise ValueError(f"sub={sub}: the kernel runs groups of "
                         f"{CHAINS[dtype]} chains")
    return grid * (sub // (pack * CHAINS[dtype])) * 4


def warp_items(warp: int, warps: int, items: int) -> range:
    """The items of one warp of ``warps``: [warp n / V, (warp + 1) n / V),
    as the kernel deals them."""
    return range(items * warp // warps, items * (warp + 1) // warps)


def item_chains(item: int, dtype, sub: int):
    """(copy, chain rows, lanes) of an item: copy and group from item // 4
    (groups = the tile's chain groups), lanes 32 (item % 4) .. + 32, the
    group's CHAINS[dtype] chain rows (bf16: row pairs 2p, 2p + 1)."""
    pack = 2 if dtype == torch.bfloat16 else 1
    ch = CHAINS[dtype]
    copy, g = divmod(item // 4, sub // (pack * ch))
    w = item % 4
    return copy, range(g * ch, (g + 1) * ch), range(32 * w, 32 * w + 32)


def held_clock(x: torch.Tensor, grid: int = GRID) -> dict:
    """The SM clock the card held while the case ran: a diagnostic launch
    (``pack16_device(..., clocks=)``) after one warm launch, each block's
    clock64 cycles over its %globaltimer nanoseconds, summed over the
    blocks; with the blocks an SM (one block on every SM expected), the
    blocks' median time, and the spread of their starts and of their ends
    (ns after the first start)."""
    blocks = pack16_blocks(x.device)
    clocks = torch.zeros((blocks, 4), dtype=torch.int64, device=x.device)
    pack16_device(x, grid=grid)
    pack16_device(x, grid=grid, clocks=clocks)
    c = clocks.cpu()
    ns = c[:, 3] - c[:, 2]
    first = int(c[:, 2].min())
    return dict(held_clock_hz=float(c[:, 1].sum()) / float(ns.sum()) * 1e9,
                held_clock_blocks=blocks,
                held_clock_max_blocks_an_sm=int(torch.bincount(c[:, 0])
                                                .max()),
                held_clock_block_ns_median=float(ns.median()),
                held_clock_last_start_ns=int(c[:, 2].max()) - first,
                held_clock_first_end_ns=int(c[:, 3].min()) - first,
                held_clock_last_end_ns=int(c[:, 3].max()) - first)


# the kernel of each type in _build.sass_loops' names
# (csrc/lab_pack16.cu: lab_pack16_chains<C>)
_SASS_CASE = {torch.float32: "F32", torch.bfloat16: "BF16",
              torch.int16: "Int<short>", torch.int32: "Int<int>"}
# what ptxas makes of the bf16 round's fma.rn pair (nvcc 12.8, sm_90a):
# the multiply as HMUL2 or as HFMA2.MMA with a -0 addend, the add as HADD2
# or as HFMA2.MMA with a 1.0 multiplier, half of the pairs each way
BF16_CHAIN_OPCODES = frozenset({"HMUL2.BF16_V2", "HADD2.BF16_V2",
                                "HFMA2.MMA.BF16_V2"})


def sass_kernel(loops: dict, dtype) -> str:
    """The name of the type's kernel among ``_build.sass_loops``' keys."""
    case = _SASS_CASE[dtype]
    names = [k for k in loops if k.endswith(f"<{case}>")]
    if len(names) != 1:
        raise ValueError(f"{len(names)} kernels of {case} in {list(loops)}")
    return names[0]


def chain_opcodes(opcodes: dict, dtype) -> dict:
    """The chain's arithmetic among ``opcodes`` (opcode -> count): FMUL and
    FADD for f32; HMUL2, HADD2 and HFMA2 (any modifiers) for bf16; for the
    integers an IMAD that multiplies and adds (no MOV, SHL, IADD, WIDE or
    HI form)."""
    out = {}
    for op, n in opcodes.items():
        base, *mods = op.split(".")
        if dtype == torch.float32:
            keep = base in ("FMUL", "FADD")
        elif dtype == torch.bfloat16:
            keep = base in ("HMUL2", "HADD2", "HFMA2")
        else:
            keep = base == "IMAD" and not set(mods) & {
                "MOV", "SHL", "IADD", "WIDE", "HI"}
        if keep:
            out[op] = n
    return out


def round_loop(kernel_loops: list, dtype) -> dict:
    """The round loop among a kernel's loops (``_build.sass_loops``,
    innermost first): the innermost holding chain arithmetic."""
    for loop in kernel_loops:
        if chain_opcodes(loop["opcodes"], dtype):
            return loop
    raise ValueError("no loop of the kernel holds the chain's arithmetic")


def round_ops(dtype) -> int:
    """Chain instructions a round and chain: a multiply and an add (one
    bf16x2 pair a chain), or one integer multiply-add."""
    return 2 if dtype.is_floating_point else 1


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


def _chain_ms(xs, launch=None) -> float:
    """ms of ``launch`` (default ``pack16_device``) over each tile of
    ``xs`` in turn, between two CUDA events; the card sleeps (HOLD_CYCLES)
    before the first event while the host enqueues the calls, so the
    chain is the card's time, as the lab's scanned calls are on the TPU,
    and not the host's time to enqueue them."""
    from ..utils.profiling import HOLD_CYCLES

    launch = launch or pack16_device
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for xx in xs:
        launch(xx)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def slope_ms(x: torch.Tensor, runs: int = 5, launch=None) -> float:
    """ms of one call as the lab times it: (12 chained calls - 2) / 10 on
    inputs x + i, the median of ``runs``; ``launch`` another launcher
    taking the tile (default ``pack16_device``)."""
    xs = {n: [x + i for i in range(n)] for n in (2, 12)}
    for n in (2, 12):           # build and warm
        _chain_ms(xs[n], launch)
    torch.cuda.synchronize()
    return statistics.median((_chain_ms(xs[12], launch) -
                              _chain_ms(xs[2], launch)) / 10.0
                             for _ in range(runs))


def report(name: str, ms, clock_hz, held_hz=None) -> dict:
    """The lab's line (pack16_lab.py:92-95) for a case: ms, cycles per
    tile-op (2 * REPS * GRID ops) at ``clock_hz`` and at ``held_hz`` (the
    clock the card held, ``held_clock``), element-ops per second; beside
    them the bound and its rate's source."""
    dt, sub = case(name)
    ops = 2 * REPS * GRID
    elems = element_ops(sub)
    line = dict(lab="pack16_lab", case=name, lab_name=LAB_NAMES[name],
                dtype=str(dt).replace("torch.", ""), sub=sub, reps=REPS,
                grid=GRID, element_ops=elems, ms=ms, cyc_per_op=None,
                telem_op_per_s=None, sm_clock_hz=clock_hz,
                clock_source="nvidia-smi clocks.max.sm",
                cyc_per_op_held=None, held_clock_hz=held_hz,
                held_clock_source="clock64 / %globaltimer of a diagnostic "
                                  "launch",
                bound_ms=bound_ms(dt, sub), bound_by="operations",
                rate_per_s=RATES[dt], rate_source=RATE_SOURCES[dt])
    if ms:
        line.update(cyc_per_op=ms * 1e-3 * clock_hz / ops,
                    telem_op_per_s=elems / (ms * 1e-3) / 1e12)
        if held_hz:
            line["cyc_per_op_held"] = ms * 1e-3 * held_hz / ops
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
        held = held_clock(x) if cuda else {}
        line = report(name, slope_ms(x) if cuda else None, clock,
                      held.get("held_clock_hz"))
        line.update(held)
        line["device"] = torch.cuda.get_device_name(dev) if cuda else "cpu"
        line["finite_share"] = float(torch.isfinite(out.float()).float()
                                     .mean())
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
