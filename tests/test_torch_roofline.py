"""The port's cost model (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``): the shapes, the pure-arithmetic estimates
(exact), the roofline terms with the reference's hardware constants set to
the H100's, op_cost's dot FLOPs against ``hlo_cost``'s on the same
fixtures, its trip, slice and view rules, the calibration battery against
``FlopCounterMode``, and ``count_step`` on the llama3-8b smoke config."""
import dataclasses
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from hypothesis_fallback import given, settings, st

from repro import configs as ref_configs
from repro.roofline import analysis as ref_analysis
from repro.roofline import calibrate as ref_calibrate
from repro.roofline import hlo_cost
from repro.roofline import hw as ref_hw
from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.kernels import linear_scan as ls
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import Model
from repro_torch.roofline import analysis, calibrate, hw, op_cost


@pytest.fixture(scope="module")
def rows():
    return {r.name: r for r in calibrate.calibrate()}


def test_shapes_and_supports_shape_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    for arch in configs.ARCHS:
        cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
        for shape in configs.SHAPES:
            assert configs.supports_shape(cfg, shape) == \
                ref_configs.supports_shape(ref, shape), (arch, shape)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_estimates_equal_the_reference(arch):
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        ref_shape = ref_configs.SHAPES[name]
        assert analysis.model_flops_estimate(cfg, shape) == \
            ref_analysis.model_flops_estimate(ref, ref_shape)
        assert analysis.ideal_bytes_estimate(cfg, shape, 3.5e9, 7.25e8) == \
            ref_analysis.ideal_bytes_estimate(ref, ref_shape, 3.5e9, 7.25e8)
        for chips in (1, 4, 256):
            assert analysis.kernel_ideal_bytes(cfg, shape, chips) == \
                ref_analysis.kernel_ideal_bytes(ref, ref_shape, chips)


def _fields():
    return dict(arch="llama3-8b", shape="decode_32k", mesh="1x1", chips=2,
                hlo_flops=3.1e12, hlo_bytes=4.7e10, coll_bytes=2.3e9,
                coll_breakdown={"all-reduce": 2.3e9, "total": 2.3e9},
                model_flops=5.5e12, ideal_bytes=6.1e10,
                bytes_per_device=3.3e10, peak_memory_ok=True,
                xla_cost={"flops": 3.0e12},
                calibration={"flops_delta": 0.01},
                flash_bytes=1.9e10, kernel_bytes=2.0e9)


def test_roofline_to_dict_equals_the_reference_on_the_h100(monkeypatch):
    monkeypatch.setattr(ref_hw, "PEAK_FLOPS_BF16", hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(ref_hw, "HBM_BW", hw.HBM_BW)
    monkeypatch.setattr(ref_hw, "ICI_BW", hw.NVLINK_BW)
    ours = analysis.Roofline(**_fields())
    ref = ref_analysis.Roofline(**_fields())
    assert ours.to_dict() == ref.to_dict()
    assert ours.stage_profile().ai_fraction == ref.stage_profile().ai_fraction
    # with the reference's TPU constants the keys still agree
    monkeypatch.undo()
    assert ours.to_dict().keys() == ref_analysis.Roofline(
        **_fields()).to_dict().keys()


def test_hw_constants_are_the_h100_data_sheet_and_chip_smoke_uses_them():
    import chip_smoke
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_TF32, hw.PEAK_FLOPS_FP32,
            hw.HBM_BW, hw.HBM_BYTES, hw.SM_COUNT) == \
        (989e12, 495e12, 67e12, 3.35e12, 80e9, 132)
    assert (chip_smoke.PEAK_BYTES_S, chip_smoke.PEAK_FP32_FLOP_S,
            chip_smoke.PEAK_BF16_FLOP_S, chip_smoke.PEAK_TF32_FLOP_S,
            chip_smoke.PEAK_SFU_S) == (3.35e12, 67e12, 989e12, 495e12,
                                       16 * 132 * 1.98e9)


@pytest.mark.parametrize("name,ref_build", [
    ("matmul", ref_calibrate._matmul), ("attention", ref_calibrate._attention),
    ("scan", ref_calibrate._scan), ("nested_scan", ref_calibrate._nested_scan)])
def test_dot_flops_equal_hlo_cost_on_the_same_fixtures(rows, name, ref_build):
    tripped, _ = hlo_cost.analyze_pair(ref_build().as_text())
    assert rows[name].ours["dot_flops"] == tripped.dot_flops


def test_scan_trips_multiply(rows):
    scan, nested = rows["scan"], rows["nested_scan"]
    assert scan.ours["dot_flops"] == 7 * scan.ours_flat["dot_flops"]
    assert scan.ours["flops"] == 7 * scan.ours_flat["flops"]
    assert nested.ours["dot_flops"] == 15 * nested.ours_flat["dot_flops"]
    # the same run under FlopCounterMode saw one trip of each loop
    assert scan.lib["flops_flat"] == scan.ours_flat["dot_flops"]
    assert nested.lib["flops_flat"] == nested.ours_flat["dot_flops"]


def test_slice_write_charges_the_slice_only(rows):
    # 16 trips, each reading one 1024-float row and writing it into the
    # (16, 1024) carry: the slice read and written, never the whole buffer
    assert rows["dus_carry"].ours["bytes"] == 16 * 2 * 1024 * 4
    assert rows["dus_carry"].ours["flops"] == 0


def test_views_cost_nothing_and_copies_cost_bytes():
    with op_cost.counting() as c:
        x = torch.empty(8, 16, 32)
        x.view(128, 32).transpose(0, 1)[:, :4][None].expand(3, 32, 4)
        x.reshape(8, 512).unsqueeze(0).permute(1, 0, 2).squeeze(1)
    assert c.cost.to_dict() == op_cost.Cost().to_dict()
    with op_cost.counting() as c:
        x = torch.empty(8, 16, 32)
        x.transpose(0, 1).reshape(16, 256)       # not contiguous: a copy
        x.to(torch.bfloat16)
    n = 8 * 16 * 32
    assert c.cost.hbm_bytes == 2 * 4 * n + (4 + 2) * n
    assert c.cost.flops == 0


def test_elementwise_and_in_place_rules():
    with op_cost.counting() as c:
        a, b = torch.empty(64, 32), torch.empty(32)
        a.add_(b)                       # reads a and b, writes a
        torch.tanh(a).sum(dim=0)        # 2048 + 2048 elements
    assert c.cost.ew_flops == 3 * 2048
    assert c.cost.hbm_bytes == (2 * 2048 + 32) * 4 + 2 * 2048 * 4 \
        + (2048 + 32) * 4


def test_calibration_battery_within_5pct(rows):
    gated = [r for r in rows.values() if r.gate]
    assert len(gated) >= 3
    for r in gated:
        assert r.ok(0.05), (r.name, r.deltas)
    lines = calibrate.report(list(rows.values()))
    assert len(lines) > len(rows) and "matmul" in "\n".join(lines)
    assert calibrate.main([]) == 0


@settings(max_examples=10, deadline=None)
@given(st.integers(8, 48), st.integers(8, 48), st.integers(8, 48))
def test_matmul_dot_flops_match_flop_counter(m, k, n):
    lib = FlopCounterMode(display=False)
    with op_cost.counting(lib) as c:
        torch.empty(m, k) @ torch.empty(k, n)
    assert c.cost.dot_flops == 2 * m * k * n
    assert c.cost.dot_flops == pytest.approx(lib.get_total_flops(), rel=0.05)


def test_a_long_scan_counts_one_trip_times_its_length():
    S, B, H, K = 32768, 1, 2, 4
    with op_cost.counting() as long:
        t0 = time.perf_counter()
        ls.rwkv_scan_plain(*(torch.empty(B, S, H, K) for _ in range(4)),
                           torch.empty(H, K))
        secs = time.perf_counter() - t0
    with op_cost.counting() as one:
        ls.rwkv_scan_plain(*(torch.empty(B, 1, H, K) for _ in range(4)),
                           torch.empty(H, K))
    assert secs < 10
    assert long.flat.dot_flops == one.flat.dot_flops
    assert long.cost.dot_flops == S * one.cost.dot_flops > 0


def test_region_tags_forward_and_backward_bytes():
    with op_cost.counting() as c:
        a = torch.empty(16, 32, requires_grad=True)
        with op_cost.region():
            y = torch.tanh(a @ a.T)
        inside = c.cost.flash_bytes
        (y.sum() * 2).backward()
    assert inside > 0
    assert c.cost.flash_bytes > inside          # tanh's and mm's backward
    assert c.cost.flash_bytes < c.cost.hbm_bytes    # sum's and mul's not


@pytest.fixture(scope="module")
def llama_smoke():
    return Model(configs.get_config("llama3-8b", smoke=True), device="cpu")


@pytest.mark.parametrize("kind,batch,seq", [("decode", 8, 64),
                                            ("prefill", 2, 32),
                                            ("train", 2, 32)])
def test_count_step_on_the_llama_smoke_config(llama_smoke, kind, batch, seq):
    shape = ShapeConfig(f"{kind}_smoke", kind, seq, batch)
    counted = analysis.count_step(llama_smoke, None, shape, kind)
    rl = analysis.from_counted("llama3-8b", shape.name, "1", 1,
                               counted.counter, counted.lib_flops,
                               llama_smoke.cfg, shape,
                               param_bytes=counted.param_bytes,
                               cache_bytes=counted.cache_bytes)
    # a prefill computes the logits of the last position only, while
    # model_flops_estimate counts 2 FLOPs a parameter a token, the
    # unembedding's included: there the ratio passes 1
    assert 0 < rl.useful_flops_ratio <= (1 if kind != "prefill" else 2)
    assert 0 < rl.flash_bytes <= rl.hlo_bytes
    assert rl.calibration["flops_delta"] == 0.0
    assert rl.peak_memory_ok and rl.bytes_per_device >= counted.param_bytes
    assert 0 < rl.ai_fraction < 1 and rl.t_bound > 0
    assert counted.param_bytes == (
        4 * llama_smoke.n_params() if kind == "train"
        else llama_smoke.weight_bytes())
    if kind == "decode":
        assert counted.cache_bytes == llama_smoke.cache_bytes(batch, seq)


def test_count_step_takes_the_shapes_of_a_given_tree(llama_smoke):
    """A real parameter tree counts as the metadata's fake leaves do, and
    is neither read nor written."""
    shape = ShapeConfig("decode_smoke", "decode", 64, 4)
    params = llama_smoke.init(seed=0)
    before = [t.clone() for t in tree_leaves(params)]
    given = analysis.count_step(llama_smoke, params, shape, "decode")
    meta = analysis.count_step(llama_smoke, None, shape, "decode")
    assert given.counter.cost.to_dict() == meta.counter.cost.to_dict()
    assert given.param_bytes == meta.param_bytes
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
