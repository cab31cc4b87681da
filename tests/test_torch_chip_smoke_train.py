"""``chip_smoke.py``'s training phase (phase 11) helpers on the CPU, from
the configs' shapes alone: its model-FLOP count, the cuts its fit tries
(depth, or for a MoE arch whose one layer does not fit, its routed
experts), and the launches by route it requires of each arch's run."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

# the free memory of an H100 80GB HBM3 at the start of phase 11 (the fit's
# own print, PERF.md section 5)
FREE = int(82.66e9)


def _old_flops(model) -> float:
    """The count before attention went by head widths: 6 S d_model a layer
    a token for attention, the token embedding left out as a gather."""
    cfg = model.cfg
    n_mat = model.n_params() - cfg.vocab_size * cfg.d_model
    specs = list(cfg.block_pattern) * cfg.n_repeats
    if cfg.moe is not None:
        n_mat -= sum(s.moe for s in specs) * (
            cfg.moe.n_experts - cfg.moe.top_k) * 3 * cfg.d_model \
            * cfg.moe.d_expert
    n_attn = sum(s.kind == "attn" for s in specs)
    return cs.TRAIN_B * cs.TRAIN_S * (6 * n_mat
                                      + 6 * n_attn * cs.TRAIN_S * cfg.d_model)


@pytest.mark.parametrize("arch", ["llama3-8b", "jamba-v0.1-52b"])
def test_train_flops_equal_the_old_count_where_h_d_is_d_model(arch):
    model = Model(get_config(arch), device="cpu")
    cfg = model.cfg
    assert cfg.n_heads * cfg.head_dim == cfg.d_model
    assert cs.train_flops(model) == _old_flops(model)


@pytest.mark.parametrize("arch,ratio", [("deepseek-v2-236b", 4.0),
                                        ("gemma3-12b", 16 * 512 / 2 / 3840)])
def test_train_flops_count_attention_by_head_widths(arch, ratio):
    """MLA's 128 heads of (192 | 128) do 4x the attention work of 6 S
    d_model, gemma3's 16 of 256 | 256 6.7% more; gemma3's tied embedding is
    also its head's product (6 vocab d_model a token)."""
    cfg = cs.train_cfg(get_config(arch), 1 if arch.startswith("deep") else 6)
    model = Model(cfg, device="cpu")
    tokens = cs.TRAIN_B * cs.TRAIN_S
    n_attn = sum(s.kind == "attn" for s in cfg.block_pattern) * cfg.n_repeats
    head = 6 * cfg.vocab_size * cfg.d_model if cfg.tie_embeddings else 0
    old_attn = 6 * n_attn * cs.TRAIN_S * cfg.d_model * tokens
    new_attn = cs.train_flops(model) - _old_flops(model) - head * tokens
    assert new_attn + old_attn == pytest.approx(ratio * old_attn, rel=1e-12)
    assert cs.train_flops(model) > _old_flops(model)


def test_train_cuts_fit_deepseeks_experts_at_one_layer():
    """One deepseek-v2-236b layer with its 160 routed experts needs 80.3
    GB at 16 bytes a parameter: the fit tries one layer with the most
    experts that fit by shape, then TRAIN_EXPERT_STEP fewer at a time down
    to top_k, every other width as the config has it."""
    cfg = get_config("deepseek-v2-236b")
    one = cs.train_cfg(cfg, 1)
    assert not cs.train_fits(one, FREE)
    cuts = cs.train_cuts(cfg, FREE)
    experts = [c.moe.n_experts for c in cuts]
    assert all(c.n_layers == 1 for c in cuts)
    assert cs.train_fits(cuts[0], FREE)
    assert not cs.train_fits(cs.with_experts(one, experts[0] + 1), FREE)
    assert experts == list(range(experts[0], cfg.moe.top_k - 1,
                                 -cs.TRAIN_EXPERT_STEP))
    assert experts[-1] >= cfg.moe.top_k
    for c in cuts:
        assert c.replace(moe=cfg.moe) == one
        assert (c.moe.top_k, c.moe.d_expert, c.moe.n_shared) == (
            cfg.moe.top_k, cfg.moe.d_expert, cfg.moe.n_shared)


@pytest.mark.parametrize("arch,first", [("gemma3-12b", 12), ("llama3-8b", 15),
                                        ("jamba-v0.1-52b", 3)])
def test_train_cuts_walk_depths_where_one_layer_fits(arch, first):
    """gemma3-12b's first try is two repeats of its 6-layer pattern (59.1 GB
    at 16 bytes a parameter; 18 layers would be 80.7), then whole repeats
    or a prefix of one; the experts of a MoE arch whose layer fits stay."""
    cfg = get_config(arch)
    cuts = cs.train_cuts(cfg, FREE)
    assert [c.n_layers for c in cuts] == [
        d for d in cs.train_depths(cfg) if d <= first]
    assert all(c.moe == cfg.moe for c in cuts)


@pytest.mark.parametrize("arch,route", [("llama3-8b", "wgmma"),
                                        ("gemma3-12b", "wgmma_split"),
                                        ("deepseek-v2-236b", "wgmma_kv128")])
def test_train_want_puts_each_backward_on_its_route(arch, route):
    """Each attention layer's forward twice a step on wgmma (the
    rematerialised one included) and its backward once on the route of its
    head widths, 0 on every other route."""
    from repro_torch.kernels import flash_attention as fa
    cfg = cs.train_cfg(get_config(arch), 1 if arch.startswith("deep") else 6)
    want = cs.train_want(cfg)
    n = cfg.n_layers * cs.TRAIN_STEPS
    assert fa._bwd_route(torch.bfloat16, *cs.attn_widths(cfg)) == route
    assert want["flash_attention"] == {"wgmma": 2 * n, "simt": 0}
    assert want["flash_attention_bwd"] == {
        r: n if r == route else 0
        for r in fa.flash_attention_bwd.launches_by_route}


@pytest.mark.parametrize("arch,kind", [("rwkv6-3b", "rwkv"),
                                       ("jamba-v0.1-52b", "mamba")])
def test_train_want_puts_each_scan_backward_on_its_chunked_route(arch, kind):
    """Each scan layer's backward once a step on the chunked route that
    training's widths take (``linear_scan._rwkv_bwd_route`` /
    ``_mamba_bwd_route`` in bf16), none on the serial
    kernel; the routes are the wrapper's own."""
    from repro_torch.kernels import linear_scan as ls
    cfg = cs.train_cfg(get_config(arch), 2 if kind == "rwkv" else 3)
    want = cs.train_want(cfg)
    n = sum(s.kind == kind for s in cfg.block_pattern) * cfg.n_repeats \
        * cs.TRAIN_STEPS
    if kind == "rwkv":
        taken = ls._rwkv_bwd_route(torch.bfloat16, cfg.head_dim,
                                   cfg.head_dim)
    else:
        taken = ls._mamba_bwd_route(torch.bfloat16, cs.MAMBA_N)
    wrapper = getattr(ls, f"{kind}_scan_bwd")
    assert taken == "chunk"
    assert want[f"{kind}_scan_bwd"] == {
        r: n if r == taken else 0 for r in wrapper.launches_by_route}
