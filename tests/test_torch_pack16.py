"""The port's lab L9 (pack16_lab) against the JAX lab of experiments/ on
the CPU.

The port runs its plain version here. The JAX lab's kernel runs in
interpret mode with nothing in experiments/ edited: the module fixture
swaps jax.experimental.pallas.pallas_call for its interpret form, sets the
lab's REPS and GRID small and runs every case once. A NumPy oracle of the
lab's arithmetic in bf16 (every multiply and add rounded to bf16, nearest
even) takes the full 512 rounds.

Tolerances: the integer cases bit for bit (wrapping arithmetic); f32 to
rtol 1e-6 against interpret mode (XLA's CPU backend may fuse a multiply
and an add into one FMA, one rounding where the port rounds twice);
bf16 to rtol 2**-6 against interpret mode (XLA may keep bf16
intermediates in f32, rounding once at the end), and bit for bit against
the NumPy oracle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas

import experiments.pack16_lab as jpack

from spmv_topk_tpu_torch.experiments import pack16_lab

SMALL = dict(REPS=6, GRID=3)
JDTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.int16: jnp.int16, torch.int32: jnp.int32}


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp(t):
    """The tile as the JAX lab's array (same bits)."""
    dt = JDTYPES[t.dtype]
    if t.dtype == torch.bfloat16:
        return jnp.asarray(_np(t)).view(jnp.bfloat16)
    return jnp.asarray(_np(t), dt)


@pytest.fixture(scope="module")
def jax_runs():
    """case -> the JAX lab's output at SMALL's REPS and GRID (numpy)."""
    orig = pallas.pallas_call

    def interpret(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    data = pack16_lab.pack16_data()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call", interpret)
        for name, value in SMALL.items():
            mp.setattr(jpack, name, value)
        jax.clear_caches()
        for name, dt, sub in pack16_lab.CASES:
            out[name] = np.asarray(jpack.run(_jnp(data[name]),
                                             dtype=JDTYPES[dt], sub=sub))
    jax.clear_caches()
    return out


def test_data_is_the_labs():
    """pack16_data draws what pack16_lab.py:58-73 draws, case by case."""
    rng = np.random.default_rng(0)
    data = pack16_lab.pack16_data()
    for name, dt, sub in pack16_lab.CASES:
        if dt in (torch.int16, torch.int32):
            ref = jnp.asarray(rng.integers(1, 3, (sub, 128)), JDTYPES[dt])
        else:
            ref = jnp.asarray(rng.standard_normal((sub, 128)) * 1e-3,
                              JDTYPES[dt])
        got = data[name]
        assert tuple(got.shape) == (sub, 128) and got.dtype == dt
        if dt == torch.bfloat16:
            np.testing.assert_array_equal(
                _np(got), np.asarray(ref.view(jnp.uint16)))
        else:
            np.testing.assert_array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("name", pack16_lab.NAMES)
def test_plain_matches_interpret(jax_runs, name):
    x = pack16_lab.pack16_data()[name]
    got = pack16_lab.pack16_plain(x, reps=SMALL["REPS"])
    ref = jax_runs[name]
    if x.dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2.0**-6, atol=0)
    elif x.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def _bf16_round(f32):
    """float32 -> bf16 bits (uint16), round to nearest even."""
    b = f32.view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def _bf16_value(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _bf16_oracle(xbits, reps):
    """The lab's chain with each multiply and add rounded to bf16 (the
    exact product and sum of two bf16 values fit float32 before the
    rounding's decision, so float32 then one rounding is the bf16 op)."""
    x = _bf16_value(xbits)
    acc = x
    for _ in range(reps):
        acc = _bf16_value(_bf16_round(acc * x))
        acc = _bf16_value(_bf16_round(acc + x))
    return _bf16_round(acc)


@pytest.mark.parametrize("name", ("bf16_16", "bf16_32"))
def test_bf16_plain_matches_per_op_oracle(name):
    x = pack16_lab.pack16_data()[name]
    got = pack16_lab.pack16_plain(x)
    np.testing.assert_array_equal(_np(got), _bf16_oracle(_np(x),
                                                         pack16_lab.REPS))
    # and on the timing inputs x + i, whose chains overflow to inf / NaN
    xi = x + 3
    np.testing.assert_array_equal(
        _np(pack16_lab.pack16_plain(xi, reps=40)), _bf16_oracle(_np(xi), 40))


@pytest.mark.parametrize("name", ("int16_16", "int32_8"))
def test_int_plain_wraps(name):
    """Integer chains wrap in the tile's type at the full 512 rounds, on
    the lab's data and on x + 11 (the last timing input)."""
    x = pack16_lab.pack16_data()[name]
    for xi in (x, x + 11):
        got = pack16_lab.pack16_plain(xi)
        bits = torch.iinfo(xi.dtype).bits
        acc = xi.numpy().astype(np.uint64)
        xv = acc.copy()
        for _ in range(pack16_lab.REPS):
            acc = (acc * xv + xv) & np.uint64((1 << bits) - 1)
        ref = acc.astype(np.uint32 if bits == 32 else np.uint16).view(
            xi.numpy().dtype)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_device_wrapper_runs_plain_on_cpu():
    x = pack16_lab.pack16_data()["f32_8"]
    before = pack16_lab.pack16_device.launches
    np.testing.assert_array_equal(pack16_lab.pack16_device(x).numpy(),
                                  pack16_lab.pack16_plain(x).numpy())
    assert pack16_lab.pack16_device.launches == before


def test_rejects_other_tiles():
    with pytest.raises(ValueError):
        pack16_lab.pack16_plain(torch.zeros(8, 64))
    with pytest.raises(ValueError):
        pack16_lab.pack16_plain(torch.zeros(8, 128, dtype=torch.float64))
    with pytest.raises(ValueError):
        pack16_lab.case("f64_8")


def test_report_and_bound():
    line = pack16_lab.report("bf16_32", 0.05, 1.98e9)
    assert line["element_ops"] == 2 * 512 * 512 * 32 * 128
    assert line["bound_ms"] == pytest.approx(
        line["element_ops"] / 66.9e12 * 1e3)
    assert line["cyc_per_op"] == pytest.approx(0.05e-3 * 1.98e9
                                               / (2 * 512 * 512))
    assert line["telem_op_per_s"] == pytest.approx(
        line["element_ops"] / 0.05e-3 / 1e12)
    assert pack16_lab.report("f32_8", None, None)["cyc_per_op"] is None


def test_main_on_cpu(capsys):
    lines = pack16_lab.main(["--device", "cpu", "int32_8", "f32_8"])
    assert [ln["case"] for ln in lines] == ["int32_8", "f32_8"]
    assert all(ln["ms"] is None and ln["device"] == "cpu" for ln in lines)
    assert "512 mul+add pairs x 512 grid steps" in capsys.readouterr().out


# ------------------------------------------------------ the kernel's shape

import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

from spmv_topk_tpu_torch.ops import _build  # noqa: E402

SOURCE = os.path.join(_build.CSRC_DIR, "lab_pack16.cu")


def test_kernel_constants_match_the_source():
    """pack16_lab's mirror of csrc/lab_pack16.cu: REPS, UNROLL, WARPS, each
    type's CHAINS and the order of the dtype enum."""
    text = open(SOURCE).read()

    def const(name, within=text):
        return int(re.search(rf"constexpr int {name} = (\d+);", within)[1])
    assert const("kReps") == pack16_lab.REPS
    assert const("kUnroll") == pack16_lab.UNROLL
    assert const("kWarps") == pack16_lab.WARPS
    for struct, dt in (("struct F32 {", torch.float32),
                       ("struct BF16 {", torch.bfloat16),
                       ("struct Int {", torch.int16)):
        body = text[text.index(struct):]
        assert const("kChains", body[:body.index("};")]) == \
            pack16_lab.CHAINS[dt]
    assert pack16_lab.CHAINS[torch.int32] == pack16_lab.CHAINS[torch.int16]
    assert pack16_lab.REPS % pack16_lab.UNROLL == 0
    assert "enum Dtype { kF32, kBF16, kI16, kI32, kNumDtypes };" in text
    assert pack16_lab.DTYPES == (torch.float32, torch.bfloat16, torch.int16,
                                 torch.int32)


@pytest.mark.parametrize("copies", [512, 7, 133])
@pytest.mark.parametrize("name", pack16_lab.NAMES)
def test_items_cover_every_chain_once(name, copies):
    """The warps' shares of the items (``warp_items``) cover each item
    once and differ by one item at most; the items (``item_chains``)
    cover each (copy, chain row, lane) of the case once, on one wave of
    the H100 (132 blocks of WARPS warps) and on a small grid."""
    dt, sub = pack16_lab.case(name)
    n = pack16_lab.pack16_items(dt, sub, copies)
    pack = 2 if dt == torch.bfloat16 else 1
    ch = pack16_lab.CHAINS[dt]
    assert n == copies * sub // (pack * ch) * 4
    for warps in (132 * pack16_lab.WARPS, 7 * pack16_lab.WARPS):
        shares = [pack16_lab.warp_items(w, warps, n) for w in range(warps)]
        assert [i for s in shares for i in s] == list(range(n))
        sizes = [len(s) for s in shares]
        assert max(sizes) - min(sizes) <= 1
    seen = np.zeros((copies, sub // pack, 128), np.int64)
    for item in range(n):
        c, rows, lanes = pack16_lab.item_chains(item, dt, sub)
        assert len(rows) == ch and len(lanes) == 32
        seen[c, rows.start:rows.stop, lanes.start:lanes.stop] += 1
    assert (seen == 1).all()


def test_pack16_items_refuse_partial_groups():
    with pytest.raises(ValueError, match="groups"):
        pack16_lab.pack16_items(torch.float32, 12)
    with pytest.raises(ValueError, match="groups"):
        pack16_lab.pack16_items(torch.bfloat16, 4)


def test_grid_is_one_block_an_sm(monkeypatch):
    """One block of WARPS warps an SM: the grid is the SM count, read once
    per device (ops/kernel.py::_device_info)."""
    from spmv_topk_tpu_torch.ops import kernel as pk

    monkeypatch.setattr(pk, "_device_info", lambda dev: (132, 232448))
    assert pack16_lab.pack16_blocks(torch.device("cpu")) == 132


def test_lab_ablation_forms_and_variants_patch_their_sources(tmp_path):
    """Every bf16 form and variant of experiments/lab_ablation.py finds
    each line it replaces in its copy of the kernel's source (the copy
    raises otherwise), and changes it."""
    from spmv_topk_tpu_torch.experiments import _common
    from spmv_topk_tpu_torch.experiments import lab_ablation as A

    units = {**{f: ("lab_pack16.cu", p) for f, p in A.FORMS.items()},
             **{v: (src, p) for v, (src, p, _) in A.VARIANTS.items()}}
    assert set(A.FORMS) == {"mul_add", "fma_add", "mul_fma"}
    for name, (source, parts) in units.items():
        d = _common.variant_dir(str(tmp_path / name), (source,), parts)
        text = open(os.path.join(d, source)).read()
        assert text != open(os.path.join(_build.CSRC_DIR, source)).read()
        assert all(new in text for _, new in parts)
    assert [v for v, (_, _, exact) in A.VARIANTS.items() if not exact] == [
        "no_merge", "no_decode"]


def test_report_at_the_held_clock():
    line = pack16_lab.report("int16_16", 0.04, 1.98e9, 1.755e9)
    ops = 2 * 512 * 512
    assert line["cyc_per_op"] == pytest.approx(0.04e-3 * 1.98e9 / ops)
    assert line["cyc_per_op_held"] == pytest.approx(0.04e-3 * 1.755e9 / ops)
    assert line["held_clock_hz"] == 1.755e9
    assert pack16_lab.report("int16_16", 0.04, 1.98e9)[
        "cyc_per_op_held"] is None


def test_chain_opcodes_and_round_loop():
    """The chain's arithmetic by type, and the round loop: the innermost
    loop holding it."""
    f = {"FMUL": 128, "FADD": 128, "IADD3": 1, "BRA": 1, "total": 258}
    assert pack16_lab.chain_opcodes(dict(f, FFMA=1), torch.float32) == {
        "FMUL": 128, "FADD": 128}
    assert pack16_lab.chain_opcodes(f, torch.float32) == {"FMUL": 128,
                                                          "FADD": 128}
    b = {"HFMA2.MMA.BF16_V2": 64, "HMUL2.BF16_V2": 32,
         "HADD2.BF16_V2": 32, "total": 130}
    assert sum(pack16_lab.chain_opcodes(b, torch.bfloat16).values()) == 128
    i = {"IMAD": 128, "IMAD.MOV.U32": 3, "IMAD.WIDE": 1, "PRMT": 0}
    assert pack16_lab.chain_opcodes(i, torch.int16) == {"IMAD": 128}
    loops = [dict(start=0x100, end=0x180, opcodes={"LDG.E": 2, "total": 3}),
             dict(start=0x200, end=0x1200, opcodes=f),
             dict(start=0x80, end=0x1400, opcodes=dict(f, total=300))]
    assert pack16_lab.round_loop(loops, torch.float32) is loops[1]
    with pytest.raises(ValueError):
        pack16_lab.round_loop(loops[:1], torch.float32)
    assert pack16_lab.round_ops(torch.bfloat16) == 2
    assert pack16_lab.round_ops(torch.int32) == 1


def test_sass_kernel_names():
    keys = {"lab_pack16_chains<F32>": [], "lab_pack16_chains<BF16>": [],
            "lab_pack16_chains<Int<short>>": [],
            "lab_pack16_chains<Int<int>>": []}
    assert pack16_lab.sass_kernel(keys, torch.int16).endswith("<Int<short>>")
    assert pack16_lab.sass_kernel(keys, torch.bfloat16) == \
        "lab_pack16_chains<BF16>"
    with pytest.raises(ValueError):
        pack16_lab.sass_kernel({}, torch.float32)


def test_sass_loops_reads_backward_branches(tmp_path, monkeypatch):
    """``_build.sass_loops``: each backward BRA (to a ``.L_x_N`` label or
    an address) and its body's opcodes, innermost first; a forward branch
    gives none (stand-ins print lines as the 12.9 toolkit does)."""
    import json

    names = {"_Z17lab_pack16_chainsI3F32EvPf":
             "void lab_pack16_chains<F32>(float *)",
             "_Z17lab_pack16_chainsI3IntIiEEvPf":
             "void lab_pack16_chains<Int<int>>(float *)"}
    m = list(names)
    ins = ["LDG.E R2, desc[UR4][R2.64] ;", "MOV R5, R2 ;",
           "FMUL R5, R5, R2 ;", "FADD R5, R5, R2 ;", "IADD3 R0, R0, 0x10, RZ ;",
           "ISETP.GE.AND P0, PT, R0, 0x200, PT ;", "@!P0 BRA `(.L_x_1) ;",
           "@P1 BRA `(.L_x_0) ;", "STG.E desc[UR4][R6.64], R5 ;", "EXIT ;",
           "BRA `(.L_x_2) ;"]
    lines = []
    for k, text in enumerate(ins):
        if k == 1:
            lines.append(".L_x_0:")
        if k == 2:
            lines.append(".L_x_1:")
        if k == 10:
            lines.append(".L_x_2:")
        lines.append(f"        /*{k * 16:04x}*/                   {text}")
        lines.append("                        /* 0x000fc80000400000 */")
    dump = (f"\n\t\tFunction : {m[0]}\n" + "\n".join(lines) +
            f"\n\t\tFunction : {m[1]}\n"
            "        /*0000*/                   IMAD R1, R1, R2, R2 ;\n"
            "        /*0010*/               @P0 BRA 0x40 ;\n"
            "        /*0020*/                   BRA 0x0 ;\n")
    obj = str(tmp_path / "lib.so.lab_pack16.cu.o")
    (tmp_path / "cuobjdump").write_text(
        f"#!{sys.executable}\nprint({dump!r})\n")
    (tmp_path / "cu++filt").write_text(
        f"#!{sys.executable}\nimport json, sys\n"
        f"names = json.loads({json.dumps(json.dumps(names))})\n"
        "print('\\n'.join(names[a] for a in sys.argv[1:]))\n")
    for tool in ("cuobjdump", "cu++filt"):
        (tmp_path / tool).chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "lib", lambda: None)
    monkeypatch.setattr(_build, "library_path",
                        lambda: str(tmp_path / "lib.so"))
    assert os.path.basename(obj) == os.path.basename(
        _build.object_path(_build.library_path(), "lab_pack16.cu"))
    loops = _build.sass_loops("lab_pack16.cu", "lab_pack16_chains")
    f32 = loops["lab_pack16_chains<F32>"]
    # innermost first: the self-branch after EXIT, the round loop, the
    # loop around it
    assert [(lp["start"], lp["end"]) for lp in f32] == [
        (0xa0, 0xa0), (0x20, 0x60), (0x10, 0x70)]
    assert f32[1]["opcodes"] == {"total": 5, "FMUL": 1, "FADD": 1,
                                 "IADD3": 1, "ISETP.GE.AND": 1, "BRA": 1}
    assert f32[2]["opcodes"]["total"] == 7
    assert pack16_lab.round_loop(f32, torch.float32) is f32[1]
    # its counter R0 has no constant start in the stand-in: no trip count
    assert f32[1]["trips"] is None
    assert [(lp["start"], lp["end"]) for lp in
            loops["lab_pack16_chains<Int<int>>"]] == [(0x0, 0x20)]
    assert _build.sass_report("lab_pack16.cu", "chains")[
        "lab_pack16_chains<F32>"]["total"] == 11


def test_lab_ablation_units_and_turns(monkeypatch):
    """experiments/lab_ablation.py: the kernels before (the parent's L9
    with its 512 unrolled rounds and one block a copy, L8 with its
    per-block sums) under their own entry names, an empty kernel; times
    taken in turns (each round the names in order, then reversed); its
    command line refuses unknown modes and needs a card."""
    from spmv_topk_tpu_torch.experiments import lab_ablation as A

    assert set(A.UNITS) == {"pack16_old", "mxu_old", "empty"}
    assert "int lab_pack16_old(const void* x" in A.OLD_PACK16
    assert "for (int i = 0; i < kReps; ++i)" in A.OLD_PACK16
    assert "int lab_mxu_old(const int32_t* words" in A.OLD_MXU
    assert "int32_t* partials" in A.OLD_MXU
    assert "lab_empty_kernel() {}" in A.EMPTY
    order = []

    def timer(fn):
        order.append(fn())
        return float(len(order))

    got = A.in_turns({"old": lambda: "old", "new": lambda: "new"}, timer,
                     rounds=2)
    assert order == ["old", "new", "new", "old"] * 2
    assert got == {"old": [1.0, 4.0, 5.0, 8.0], "new": [2.0, 3.0, 6.0, 7.0]}
    with pytest.raises(SystemExit, match="unknown"):
        A.main(["fast"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        A.main(["routes"])


def _ins(*lines, base=0x100):
    """_sass_dump's instructions of SASS ``lines`` ("@!P0 BRA 0x0" style),
    one each 16 bytes from ``base``."""
    out = []
    for k, text in enumerate(lines):
        guard = ""
        if text.startswith("@"):
            guard, text = text[1:].split(" ", 1)
        op, _, args = text.partition(" ")
        out.append((base + 16 * k, op, args.strip(), guard))
    return out


# (init, step, compare, guard, increment after the compare) -> trips
_LOOPS = [
    (("MOV R4, RZ", "0x10", "ISETP.GE.U32.AND P1, PT, R4, 0x200, PT",
      "@!P1", False), 32),
    (("HFMA2.MMA R4, -RZ, RZ, 0, 0", "0x10",
      "ISETP.GE.U32.AND P1, PT, R4, 0x200, PT", "@!P1", False), 32),
    (("MOV R4, RZ", "0x20", "ISETP.GE.U32.AND P1, PT, R4, 0x200, PT",
      "@!P1", False), 16),
    (("MOV R4, 0x20", "-0x1", "ISETP.NE.AND P0, PT, R4, RZ, PT", "@P0",
      False), 32),
    (("MOV R4, 0x20", "-0x1", "ISETP.NE.AND P0, PT, R4, 0x0, PT", "@P0",
      False), 32),
    (("MOV R4, RZ", "0x10", "ISETP.GE.U32.AND.EX P1, PT, R4, 0x200, PT, P2",
      "@!P1", False), None),
    (("IMAD.MOV.U32 R4, RZ, RZ, 0x8", "-0x1",
      "ISETP.GT.AND P0, PT, R4, 0x0, PT", "@P0", False), 8),
    (("MOV R4, RZ", "0x10", "ISETP.GE.U32.AND P1, PT, R4, 0x200, PT",
      "@!P1", True), 33),
    (("MOV R4, R9", "0x10", "ISETP.GE.U32.AND P1, PT, R4, 0x200, PT",
      "@!P1", False), None),
    (("MOV R4, RZ", "0x10", "ISETP.GE.U32.AND P1, PT, R4, R5, PT",
      "@!P1", False), None),
    (("MOV R4, RZ", "0x10", "ISETP.GE.U32.AND P1, PT, R4, 0x200, PT",
      "", False), None),
]


@pytest.mark.parametrize("form,trips", _LOOPS)
def test_loop_trips_reads_the_counter(form, trips):
    """``_build.loop_trips``: the trips of a rolled loop from its counter
    (its value at entry, its IADD3 step, the ISETP that sets the backward
    branch's predicate), run as the SASS runs it; None where the counter
    is not a constant stepped by a constant (a register start or bound, a
    64-bit compare, an unconditional branch). The first form is ptxas's
    round loop of csrc/lab_pack16.cu (nvcc 12.8, sm_90a)."""
    init, step, cmp, guard, late = form
    body = [f"IADD3 R4, R4, {step}, RZ", "FMUL R5, R5, R2", cmp,
            "FADD R5, R5, R2"]
    if late:
        body = body[1:3] + body[:1] + body[3:]
    ins = _ins("LDG.E R2, desc[UR4][R2.64]", init, *body,
               f"{guard} BRA 0x120".strip(), "EXIT")
    start, end = ins[2][0], ins[-2][0]
    assert _build.loop_trips(ins, start, end) == trips


def test_loop_trips_refuses_a_second_counter_write():
    """A counter written twice in the loop (or stepped under a predicate)
    gives no trip count."""
    head = ["MOV R4, RZ"]
    for body in (["IADD3 R4, R4, 0x10, RZ", "IADD3 R4, R4, 0x10, RZ"],
                 ["@P2 IADD3 R4, R4, 0x10, RZ"],
                 ["IADD3 R4, R4, 0x10, RZ", "SHF.L.U32 R4, R4, 0x1, RZ"]):
        ins = _ins(*head, *body, "ISETP.GE.U32.AND P1, PT, R4, 0x200, PT",
                   "@!P1 BRA 0x110")
        assert _build.loop_trips(ins, ins[1][0], ins[-1][0]) is None


def test_lab_ablation_reuses_a_built_unit(tmp_path, monkeypatch):
    """``lab_ablation._unit``: nvcc once for a unit's sources and flags
    (a stand-in nvcc writes the library), the library reused by a later
    build of the same sources, a new one when a source changes."""
    from spmv_topk_tpu_torch.experiments import lab_ablation as A
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    f"open({str(log)!r}, 'a').write(' '.join(sys.argv) + "
                    "'\\n')\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write("
                    "'so')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(A, "OUT_DIR", str(tmp_path / "out"))
    first = A._unit("empty")
    assert os.path.exists(first) and first.endswith(".so")
    assert A._unit("empty") == first
    assert len(log.read_text().splitlines()) == 1
    monkeypatch.setitem(A.UNITS, "empty", A.EMPTY + "// changed\n")
    second = A._unit("empty")
    assert second != first and os.path.exists(second)
    variant = A._unit("warps8")
    assert A._unit("warps8") == variant
    assert len(log.read_text().splitlines()) == 3
    assert not [p for p in os.listdir(os.path.dirname(first))
                if p.endswith(".tmp")]
