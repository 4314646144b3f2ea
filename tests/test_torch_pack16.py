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
