"""The port's tax meter and acceleration analytics
(``repro_torch.core.{taxmeter,acceleration}``) against the JAX package.

``acceleration`` is a copy: every constant and function equals the
reference's over a grid of AI fractions and speed-ups that includes 0, 1
and infinity (where the reference raises, the port raises the same).
``TaxedStep`` runs on the CPU here (``device="cpu"``), beside the
reference's on its CPU backend, on the same seeded numpy payload: the
same stage names, categories and transfer bytes, and outputs within
1e-6. On the card, ``chip_smoke.py`` wraps the fused identify in it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acceleration as jax_acc
from repro.core import events as jax_events
from repro.core import taxmeter as jax_taxmeter

from repro_torch.core import acceleration as acc
from repro_torch.core import events
from repro_torch.core import taxmeter

FRACTIONS = [0.0, 0.42, 0.552, 0.88, 1.0]
SPEEDUPS = [0.5, 1.0, 2.0, 10.0, 1e6, math.inf]


def _outcome(fn, *args, **kw):
    """fn's value, or the type of what it raised."""
    try:
        return fn(*args, **kw)
    except Exception as err:              # noqa: BLE001  (compared below)
        return type(err)


# ---- acceleration ----------------------------------------------------------

def test_acceleration_constants_equal_the_reference():
    for name in ("INGESTION", "DETECTION", "IDENTIFICATION"):
        port, ref = getattr(acc, name), getattr(jax_acc, name)
        assert (port.name, port.ai_fraction) == (ref.name, ref.ai_fraction)
    assert acc.E2E_AI_FRACTION == jax_acc.E2E_AI_FRACTION
    assert acc.E2E_TAX == jax_acc.E2E_TAX


@pytest.mark.parametrize("f", FRACTIONS)
def test_amdahl_and_residual_tax_equal_the_reference(f):
    port, ref = acc.StageProfile("s", f), jax_acc.StageProfile("s", f)
    assert port.asymptote == ref.asymptote
    assert (port.asymptote == math.inf) == (f == 1.0)
    for s in SPEEDUPS:
        assert _outcome(port.amdahl_speedup, s) == \
            _outcome(ref.amdahl_speedup, s)
        assert _outcome(acc.residual_tax_fraction, port, s) == \
            _outcome(jax_acc.residual_tax_fraction, ref, s)
    finite = [s for s in SPEEDUPS if s != math.inf]
    assert acc.amdahl_curve(port, finite) == jax_acc.amdahl_curve(ref, finite)
    assert acc.roofline_sweep(port, finite) == \
        jax_acc.roofline_sweep(ref, finite)
    if f < 1.0:                      # the residual tax tends to 1
        assert acc.residual_tax_fraction(port, math.inf) == 1.0


@pytest.mark.parametrize("terms", [(3.0, 1.0, 0.0), (0.0, 2.0, 1.0),
                                   (1.5, 0.0, 0.5), (0.0, 0.0, 0.0)])
def test_profile_from_roofline_equals_the_reference(terms):
    port = acc.profile_from_roofline("r", *terms)
    ref = jax_acc.profile_from_roofline("r", *terms)
    assert (port.name, port.ai_fraction) == (ref.name, ref.ai_fraction)


@pytest.mark.parametrize("ai_only", [False, True])
@pytest.mark.parametrize("s", [1.0, 4.0, 1e6])
def test_emulated_times_equal_the_reference(ai_only, s):
    measured = {"ingestion": 0.31, "detection": 1.7, "identification": 0.9,
                "broker": 0.2}
    profiles = {p.name: p for p in (acc.INGESTION, acc.DETECTION,
                                    acc.IDENTIFICATION)}
    ref_profiles = {p.name: p for p in (jax_acc.INGESTION, jax_acc.DETECTION,
                                        jax_acc.IDENTIFICATION)}
    got = acc.emulated_times(measured, s, ai_only=ai_only, profiles=profiles)
    want = jax_acc.emulated_times(measured, s, ai_only=ai_only,
                                  profiles=ref_profiles)
    assert got == want
    if ai_only and s > 1:       # ingestion has no AI part: it keeps its time
        assert got["ingestion"] == measured["ingestion"]
        assert got["broker"] == measured["broker"] / s


# ---- taxed_stage_category ---------------------------------------------------

SUFFIX_BATTERY = [("s/pre", "pre"), ("s/compute", "ai"), ("s/h2d", "transfer"),
                  ("s/d2h", "transfer"), ("s/post", "post"), ("wait", "queue"),
                  ("step/pre", "pre"), ("identify_fused/h2d", "transfer"),
                  ("identify_fused/compute", "ai"), ("x/wait", "queue"),
                  ("reject", "queue"), ("prefill", "ai"), ("decode", "ai")]


def test_taxed_stage_category_equals_the_reference():
    assert events.STAGE_CATEGORIES == jax_events.STAGE_CATEGORIES
    for stage in sorted(jax_events.STAGE_CATEGORIES):
        assert taxmeter.taxed_stage_category(stage) == \
            jax_taxmeter.taxed_stage_category(stage)
    for stage, cat in SUFFIX_BATTERY:
        assert taxmeter.taxed_stage_category(stage) == cat == \
            jax_taxmeter.taxed_stage_category(stage)


# ---- TaxedStep ----------------------------------------------------------------

def _payload(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.integers(0, 100, 5).astype(np.int32)}


def _pre(x):
    return {"a": x["a"] * 0.5 + 1.0, "b": x["b"] * 2}


def _run_pair(seed: int = 0):
    """The same step through the reference's TaxedStep (JAX on the CPU)
    and the port's (device="cpu")."""
    ref = jax_taxmeter.TaxedStep(jax_events.EventLog(), name="s")
    port = taxmeter.TaxedStep(events.EventLog(), name="s", device="cpu")
    want = ref.run(
        0, pre=_pre, payload=_payload(seed),
        compute=lambda x: (jnp.tanh(x["a"].T @ x["a"]), jnp.sum(x["b"])),
        post=lambda y: (np.asarray(y[0]) * 2.0, int(y[1])))
    got = port.run(
        0, pre=_pre, payload=_payload(seed),
        compute=lambda x: (torch.tanh(x["a"].T @ x["a"]),
                           x["b"].sum(dtype=torch.int32)),
        post=lambda y: (y[0].numpy() * 2.0, int(y[1])))
    return ref, port, want, got


def test_taxed_step_equals_the_reference_on_the_cpu():
    ref, port, want, got = _run_pair()
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    assert got[1] == want[1]
    stages = [ev.stage for ev in port.log.events]
    assert stages == [ev.stage for ev in ref.log.events] == \
        ["s/pre", "s/h2d", "s/compute", "s/d2h", "s/post"]
    assert [taxmeter.taxed_stage_category(s) for s in stages] == \
        ["pre", "transfer", "ai", "transfer", "post"]
    # h2d: the pre'd payload (16 x 8 float32 + 5 int32); d2h: the 8 x 8
    # float32 product and the int32 sum, booked as on the reference's CPU
    assert port.log.transfer_bytes() == ref.log.transfer_bytes() == \
        {"h2d": 16 * 8 * 4 + 5 * 4, "d2h": 8 * 8 * 4 + 4,
         "total": 16 * 8 * 4 + 5 * 4 + 8 * 8 * 4 + 4}
    got_bd, want_bd = port.breakdown(), ref.breakdown()
    assert set(got_bd) == set(want_bd)
    assert set(got_bd["per_stage"]) == set(want_bd["per_stage"])
    assert got_bd["transfer_bytes"] == want_bd["transfer_bytes"]
    assert sum(got_bd["fractions"].values()) == pytest.approx(1.0)
    assert got_bd["ai_fraction"] + got_bd["tax_fraction"] == pytest.approx(1)


def test_taxed_step_without_pre_or_post_fetches_cpu_tensors():
    step = taxmeter.TaxedStep(events.EventLog(), device="cpu")
    x = torch.arange(6, dtype=torch.float32)
    y = step.run(3, compute=lambda t: [t * 2, t[:2]], payload=x)
    assert isinstance(y, list) and all(t.device.type == "cpu" for t in y)
    assert torch.equal(y[0], x * 2)
    assert [ev.stage for ev in step.log.events] == \
        ["step/h2d", "step/compute", "step/d2h"]
    assert step.log.transfer_bytes() == {"h2d": 24, "d2h": 32, "total": 56}


def test_taxed_step_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this container check needs a machine without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        taxmeter.TaxedStep(events.EventLog())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        taxmeter.TaxedStep(events.EventLog(), device="cuda")


def test_taxed_step_around_the_fused_identify_books_its_bytes():
    """The split chip_smoke.py measures on the card, on the CPU: the crop
    stack up, ``FusedIdentifier.score`` as the compute, the (index, score)
    rows down, names as ``identify_crops`` gives them."""
    from repro_torch.core import facerec
    fused = facerec.build_identify_stack(seed=0, placement="device",
                                         device="cpu").fused
    rng = np.random.default_rng(5)
    crops = rng.integers(0, 256, (5, facerec.CROP_SIZE, facerec.CROP_SIZE, 3),
                         dtype=np.uint8)
    step = taxmeter.TaxedStep(events.EventLog(), "identify_fused",
                              device="cpu")
    got = step.run(
        0, payload=crops,
        pre=lambda c: np.ascontiguousarray(facerec._pad_rows_pow2(c)),
        compute=fused.score,
        post=lambda y: fused.named(y[0].numpy()[:5], y[1].numpy()[:5]))
    assert got == fused.identify_crops(crops)
    # 5 crops pad to 8 rows of 48 x 48 x 3 bytes; int64 index + f32 score
    assert step.log.transfer_bytes() == {
        "h2d": 8 * facerec.CROP_SIZE ** 2 * 3, "d2h": 8 * (8 + 4),
        "total": 8 * facerec.CROP_SIZE ** 2 * 3 + 8 * 12}
    assert set(step.breakdown()["per_stage"]) == {
        f"identify_fused/{s}" for s in ("pre", "h2d", "compute", "d2h",
                                        "post")}
