"""``chip_smoke.py``'s training phase (phase 11) helpers on the CPU, from
the configs' shapes alone: its model-FLOP count, the cuts its fit tries
(depth, or for a MoE arch whose one layer does not fit, its routed
experts), the launches by route it requires of each arch's run, its
learning rate by arch and its step-1 depth caps; and its gradient-leaf
rule, on toy trees and on a qwen2.5-14b smoke step's gradients (a key
bias is exempt from "not all zero" only without RoPE)."""
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
                                        ("jamba-v0.1-52b", 3),
                                        ("qwen2.5-14b", 10),
                                        ("chameleon-34b", 4),
                                        ("qwen1.5-110b", 1)])
def test_train_cuts_walk_depths_where_one_layer_fits(arch, first):
    """gemma3-12b's first try is two repeats of its 6-layer pattern (59.1 GB
    at 16 bytes a parameter; 18 layers would be 80.7), then whole repeats
    or a prefix of one; the experts of a MoE arch whose layer fits stay.
    qwen2.5-14b's first try is 10 of 48 layers (68.96 GB), chameleon-34b's
    4 of 48 (61.47 GB), qwen1.5-110b's 1 of 80 (61.61 GB: its embedding
    and untied head are 2.49 B of its 3.85 B parameters), so its fit has
    no cut below the first try."""
    cfg = get_config(arch)
    cuts = cs.train_cuts(cfg, FREE)
    assert [c.n_layers for c in cuts] == [
        d for d in cs.train_depths(cfg) if d <= first]
    assert all(c.moe == cfg.moe for c in cuts)


@pytest.mark.parametrize("arch,route", [("llama3-8b", "wgmma"),
                                        ("qwen2.5-14b", "wgmma"),
                                        ("chameleon-34b", "wgmma"),
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


WHISPER = "whisper-large-v3"
GRANITE = "granite-moe-3b-a800m"


def test_train_want_counts_whispers_encoder_decoder_and_cross_launches():
    """whisper-large-v3 launches 32 encoder (non-causal self), 32 decoder
    (causal self) and 32 cross attention calls a step, each forward twice
    (every layer rematerialised) and each backward once, all of them at
    D = 64 on the wgmma routes; 0 on every other route, no scan."""
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config(WHISPER)
    assert (cfg.n_enc_layers, cfg.n_layers) == (32, 32)
    want = cs.train_want(cfg)
    calls = (32 + 32 + 32) * cs.TRAIN_STEPS
    assert set(want) == {"flash_attention", "flash_attention_bwd"}
    assert want["flash_attention"] == {"wgmma": 2 * calls, "simt": 0}
    assert fa._bwd_route(torch.bfloat16, *cs.attn_widths(cfg)) == "wgmma"
    assert want["flash_attention_bwd"] == {
        r: calls if r == "wgmma" else 0
        for r in fa.flash_attention_bwd.launches_by_route}
    # a cut keeps three calls a decoder layer and one an encoder layer
    cut = cs.train_want(cs.train_cfg(cfg, 2))
    assert cut["flash_attention"]["wgmma"] == 2 * 6 * cs.TRAIN_STEPS


def test_train_want_for_granite():
    """granite-moe-3b-a800m's 32 attention layers (GQA 24 | 8, D = 64):
    forward twice a step on wgmma, backward once on wgmma, no scan."""
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config(GRANITE)
    want = cs.train_want(cfg)
    n = 32 * cs.TRAIN_STEPS
    assert set(want) == {"flash_attention", "flash_attention_bwd"}
    assert want["flash_attention"] == {"wgmma": 2 * n, "simt": 0}
    assert want["flash_attention_bwd"] == {
        r: n if r == "wgmma" else 0
        for r in fa.flash_attention_bwd.launches_by_route}


def test_train_flops_for_whisper_at_its_own_token_counts():
    """The count written out from whisper-large-v3's widths: the encoder's
    products on 4 x 1,500 frames, the decoder's on 4 x 187 tokens, but each
    decoder layer's cross K and V projections on the 1,500 encoder states;
    the token embedding a gather (the head is its own matrix); attention
    6 H (D + Dv) a visible pair, the encoder's and the cross attention's
    every pair, the decoder's causal self attention half of S_dec^2."""
    cfg = get_config(WHISPER)
    d, f, V, H, D = (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_heads,
                     cfg.head_dim)
    HD = H * D
    B, Se, Sd = 4, 1500, 187
    assert cs.train_lengths(cfg) == (Se, Sd) and cs.TRAIN_B == B
    ln = 2 * d                                       # LayerNorm: w, b
    attn = 4 * d * HD + 3 * HD                       # wq wk wv wo, bq bk bv
    mlp = 2 * d * f + f + d                          # wi, bi, wo, bo
    enc = d * d + 32 * (2 * ln + attn + mlp) + ln    # enc_in, layers, ln_enc
    cross_kv = 32 * 2 * d * HD
    dec = 32 * (3 * ln + attn + 2 * d * HD + mlp) + ln + d * V  # + ln_f, head
    model = Model(cfg, device="cpu")
    assert model.n_params() == enc + dec + cross_kv + V * d
    products = 6 * B * ((enc + cross_kv) * Se + dec * Sd)
    attention = 6 * H * 2 * D * B * (32 * Se * Se + 32 * Sd * Se
                                     + 32 * Sd * Sd / 2)
    assert cs.train_flops(model) == pytest.approx(products + attention,
                                                  rel=1e-12)


def test_train_flops_for_granite():
    """granite-moe-3b-a800m: 32 layers of GQA attention and 40 experts of
    which 8 are active, the tied embedding counted as the head's product,
    attention 3 S H (D + Dv) a layer a token."""
    cfg = get_config(GRANITE)
    d, V, H, KV, D = (cfg.d_model, cfg.vocab_size, cfg.n_heads,
                      cfg.n_kv_heads, cfg.head_dim)
    E, K, f = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert
    # the two norms, attention's wq, wo, wk, wv and the router
    layer = 2 * d + d * H * D * 2 + 2 * d * KV * D + d * E
    model = Model(cfg, device="cpu")
    assert model.n_params() == V * d + 32 * (layer + E * 3 * d * f) + d
    tokens = cs.TRAIN_B * cs.TRAIN_S
    active = V * d + 32 * (layer + K * 3 * d * f) + d
    want = tokens * (6 * active + 3 * 32 * cs.TRAIN_S * H * 2 * D)
    assert cs.train_flops(model) == pytest.approx(want, rel=1e-12)


def test_frames_batch_has_the_references_train_geometry():
    """whisper-large-v3's train batch: (4, 1,500, 1,280) stub frames in the
    compute dtype and (4, 187) tokens and labels (the reference's
    input_specs for a train shape of 1,500 frames), equal for equal seeds;
    a decoder-only arch's loader has no frames."""
    from repro_torch.configs.base import ShapeConfig
    cfg = get_config(WHISPER)
    loader = cs.train_loader(cfg, "cpu")
    assert isinstance(loader, cs.FramesLoader)
    batch = loader.next_batch()
    assert tuple(batch["frames"].shape) == (4, 1500, 1280)
    assert batch["frames"].dtype == torch.bfloat16
    assert tuple(batch["tokens"].shape) == tuple(batch["labels"].shape) \
        == (4, 187)
    specs = Model(cfg, device="cpu").input_specs(
        ShapeConfig("t", "train", 1500, 4))
    assert {k: tuple(t.shape) for k, t in specs.items()} == {
        k: tuple(t.shape) for k, t in batch.items()}
    again = cs.FramesLoader(cfg, "cpu").next_batch()
    for name in batch:
        assert torch.equal(batch[name], again[name]), name
    other = cs.FramesLoader(cfg, "cpu", seed=1).next_batch()
    assert not torch.equal(batch["frames"], other["frames"])
    second = loader.next_batch()
    assert torch.equal(second["frames"], batch["frames"])
    assert not torch.equal(second["tokens"], batch["tokens"])
    assert "frames" not in cs.train_loader(get_config(GRANITE),
                                           "cpu").next_batch()


def test_whisper_loss_without_frames_raises():
    """An encoder-decoder's loss on a batch without frames raises; it never
    runs the decoder alone."""
    from repro_torch.configs import whisper_large_v3
    from repro_torch.data.tokens import TokenLoader
    cfg = whisper_large_v3.smoke_config()
    model = Model(cfg, device="cpu")
    params = model.init(seed=0, masters=True)
    batch = TokenLoader(cfg.vocab_size, batch=2, seq_len=8,
                        device="cpu").next_batch()
    with pytest.raises(KeyError, match="frames"):
        model.loss(params, batch)


@pytest.mark.parametrize("arch", [WHISPER, GRANITE])
def test_train_cuts_for_whisper_and_granite(arch):
    """Both fit whole on an 80 GB card by their shapes (whisper 25.7 GB,
    granite 52.8 GB at 16 bytes a parameter): the first try is every layer;
    whisper's cuts take encoder and decoder layers together, granite's keep
    its 40 experts."""
    cfg = get_config(arch)
    cuts = cs.train_cuts(cfg, FREE)
    assert [c.n_layers for c in cuts] == list(range(32, 0, -1))
    assert cs.train_fits(cuts[0], FREE)
    if cfg.encdec:
        assert all(c.n_enc_layers == c.n_layers for c in cuts)
    else:
        assert all(c.moe == cfg.moe for c in cuts)


def test_check_grad_leaves_exempts_only_key_biases_from_not_all_zero():
    """Under a sincos config (whisper's) a ``*/bk`` leaf of zeros passes
    (its gradient is zero in exact arithmetic), held instead to 2e-2 of the
    largest gradient; any other zero leaf fails, and so does a non-finite
    key bias. Under a RoPE config (qwen's) the key bias is a leaf as any
    other: all zero, it fails."""
    g = torch.Generator().manual_seed(0)
    sincos = get_config(WHISPER, smoke=True)
    rope = get_config("qwen2.5-14b", smoke=True)
    assert (sincos.pos, rope.pos) == ("sincos", "rope")

    def tree(**over):
        t = {"embed": {"tok": torch.randn((8, 4), generator=g)},
             "enc": [{"attn": {"wq": torch.randn((4, 4), generator=g),
                               "bq": torch.randn((4,), generator=g),
                               "bk": torch.zeros(4)}}]}
        for path, value in over.items():
            *head, last = path.split("__")
            node = t
            for key in head:
                node = node[int(key)] if key.isdigit() else node[key]
            node[last] = value
        return t

    cs.check_grad_leaves(sincos, tree())
    cs.check_grad_leaves(sincos, tree(enc__0__attn__bk=torch.full(
        (4,), 1e-3)))
    cs.check_grad_leaves(rope, tree(enc__0__attn__bk=torch.full((4,), 100.0)))
    for cfg, bad in ((sincos, {"enc__0__attn__wq": torch.zeros((4, 4))}),
                     (sincos, {"enc__0__attn__bq": torch.zeros(4)}),
                     (sincos, {"embed__tok": torch.zeros((8, 4))}),
                     (sincos, {"enc__0__attn__bk": torch.full(
                         (4,), float("nan"))}),
                     (sincos, {"enc__0__attn__bk": torch.full((4,), 100.0)}),
                     (rope, {}),
                     (rope, {"enc__0__attn__bk": torch.full(
                         (4,), float("nan"))})):
        with pytest.raises(cs.SmokeFailure):
            cs.check_grad_leaves(cfg, tree(**bad))


def _leaf_kinds(cfg) -> set:
    """The names of ``cfg``'s parameter leaves with the layer indices taken
    out: the kinds of leaf a step at ``cfg``'s depth has gradients of."""
    import re
    meta = Model(cfg, device="cpu").param_meta()
    return {re.sub(r"/\d+", "", n) for n, _ in cs._named_leaves(meta)}


def test_step1_depth_caps_are_depths_the_fit_can_take():
    """TRAIN_STEP1_LAYERS cuts only the step-1 check: each cap is a depth
    ``train_cfg`` can cut its arch to, shallower than the arch, and no
    shallower than its grad-norm depth (TRAIN_GNORM_LAYERS), so that the
    grad-norm check still runs at or below it; and the cut keeps every
    kind of leaf the whole arch has, so that no leaf goes unchecked."""
    for arch, n in cs.TRAIN_STEP1_LAYERS.items():
        cfg = get_config(arch)
        assert arch in cs.TRAIN_ARCHS
        assert n in cs.train_depths(cfg) and n < cfg.n_layers
        assert cs.TRAIN_GNORM_LAYERS.get(arch, n) <= n
        assert cs.train_cfg(cfg, n).n_layers == n
        assert _leaf_kinds(cs.train_cfg(cfg, n)) == _leaf_kinds(cfg)


def test_train_lr_scales_the_default_by_width_for_the_8192_wide_archs():
    """Phase 11 trains at launch/train.py's default learning rate but for
    chameleon-34b and qwen1.5-110b, 8,192 wide, at the default scaled by
    llama3-8b's 4,096 over their width; the warmup and the schedule are
    the same for every arch."""
    assert cs.TRAIN_LR_DEFAULT == 3e-3
    llama = get_config("llama3-8b")
    for arch in cs.TRAIN_ARCHS:
        cfg = get_config(arch)
        hp = cs.train_hp(cfg)
        want = (cs.TRAIN_LR_DEFAULT * llama.d_model / cfg.d_model
                if arch in ("chameleon-34b", "qwen1.5-110b")
                else cs.TRAIN_LR_DEFAULT)
        assert hp.lr == pytest.approx(want, rel=1e-12)
        assert (hp.warmup_steps, hp.total_steps) == (2, cs.TRAIN_STEPS)
    assert set(cs.TRAIN_LR) <= set(cs.TRAIN_ARCHS)


def test_device_times_sum_each_names_device_events():
    """``device_times`` groups a profile's raw events as key_averages()
    groups its CUDA entries: the device events' durations summed by name
    and counted, host events and asynchronous ones left out."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType

    def event(name, device, ns, is_async=False):
        return SimpleNamespace(name=lambda: name, device_type=lambda: device,
                               duration_ns=lambda: ns,
                               is_async=lambda: is_async)
    events = [event("gemm", DeviceType.CUDA, 3000),
              event("add", DeviceType.CUDA, 500),
              event("gemm", DeviceType.CUDA, 1500),
              event("cudaLaunchKernel", DeviceType.CPU, 9000),
              event("gemm", DeviceType.CUDA, 7000, is_async=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    got = sorted(cs.device_times(prof))
    assert got == [("add", 0.5, 1), ("gemm", 4.5, 2)]
    assert got[1].self_device_time_total == 4.5 and got[1].count == 2


def _smoke_grads(arch):
    """One float32 smoke step's gradients of ``arch`` on the CPU, from
    ``Model.init(seed=0)``: (cfg, gradient tree)."""
    from repro_torch.data.tokens import TokenLoader
    from repro_torch.train.train_step import make_train_step
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    model = Model(cfg, device="cpu")
    params = model.init(seed=0, masters=True)
    batch = TokenLoader(cfg.vocab_size, batch=2, seq_len=16,
                        device="cpu").next_batch()
    _, grads = make_train_step(model, cs.train_hp(cfg)).grads(params, batch)
    return cfg, grads


def test_check_grad_leaves_holds_a_rope_key_bias_as_any_leaf():
    """Under RoPE a key bias is rotated by its key's position before it
    reaches the scores, so it moves them and its gradient is a real one:
    qwen2.5-14b's smoke step gives its ``bk`` leaves gradients of 0.07 and
    0.13 of the largest, above the 2e-2 to which a sincos arch's key bias
    (zero in exact arithmetic) is held. The check passes them as it passes
    any leaf, and they are not all zero."""
    cfg, grads = _smoke_grads("qwen2.5-14b")
    assert cfg.pos == "rope" and cfg.qkv_bias
    named = cs._named_leaves(grads)
    top = max(float(g.abs().max()) for _, g in named)
    biases = [float(g.abs().max()) for n, g in named if n.endswith("/bk")]
    assert len(biases) == cfg.n_layers
    assert min(biases) > cs.BWD_RTOL["bfloat16"] * top
    cs.check_grad_leaves(cfg, grads)
