"""The plain reference against the port's CPU path, both in float32, at
the port's smoke sizes: prefill then ragged decode through the cache (the
serving engine's calls), and a training step's loss, gradients and AdamW
update."""
import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "portbench")]

from benchkit import configs, traffic, weights  # noqa: E402
from reference.lm import serve_logits  # noqa: E402
from reference.train import train_reference  # noqa: E402

SMALL = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
         "vocab_size": 256}
SMOKE = {
    "chameleon-34b": dict(SMALL, num_hidden_layers=2),
    "chameleon-34b.pp12": dict(SMALL, num_hidden_layers=2),
    "jamba-v0.1-52b": dict(SMALL, num_hidden_layers=8, num_experts=4,
                           expert_intermediate_size=128, mamba_d_state=4,
                           mamba_dt_rank=4),
}


def smoke_config(name: str) -> dict:
    cfg = copy.deepcopy(configs.load_config(name))
    cfg.update(SMOKE[name])
    return cfg


def port_model(cfg):
    from repro_torch.models.model import Model
    pc = configs.port_config(cfg, smoke=True).replace(dtype="float32")
    return Model(pc, "cpu")


def served_through_the_port(cfg, seed, prompt, toks, cache_len=96):
    """Logits (T, V): the prefill's last row, then one ragged decode step
    a token on slot 1 of a 2-slot cache (slot 0 idle), as the engine calls
    the model."""
    model = port_model(cfg)
    params = weights.port_tree(cfg, seed, torch.float32, "cpu",
                               final_norm_dtype=torch.float32)
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": prompt[None]},
                                  cache_len=cache_len)
        blocks = model.init_cache(2, cache_len)["blocks"]
        model.insert_prefill(blocks, cache["blocks"], 1)
        rows, kv = [lg[0]], len(prompt)
        for t in toks[:-1]:
            tok = torch.tensor([[0], [int(t)]], dtype=torch.int32)
            lens = torch.tensor([0, kv], dtype=torch.int32)
            lg, blocks = model.decode_step_ragged(params, blocks, tok, lens)
            rows.append(lg[1])
            kv += 1
    return torch.stack(rows).float()


@pytest.mark.parametrize("name", ["chameleon-34b", "jamba-v0.1-52b"])
def test_serve_reference_matches_the_port(name):
    cfg = smoke_config(name)
    seed = 2_147_483_659
    g = torch.Generator().manual_seed(5)
    seqs, lens, want = [], [], []
    for S, T in ((40, 9), (13, 5)):
        prompt = torch.randint(0, cfg["vocab_size"], (S,), generator=g)
        toks = torch.randint(0, cfg["vocab_size"], (T,), generator=g)
        want.append(served_through_the_port(cfg, seed, prompt, toks))
        seqs.append(torch.cat([prompt, toks[:-1]]))
        lens.append(S)
    got = serve_logits(cfg, seed, seqs, lens, torch.float32, "cpu")
    for w, r in zip(want, got):
        assert r.shape == w.shape
        torch.testing.assert_close(r, w, rtol=1e-4, atol=1e-4)


def test_moe_reference_drops_past_capacity():
    cfg = smoke_config("jamba-v0.1-52b")
    assert configs.moe_capacity(cfg, 40) == 28
    assert configs.moe_capacity(cfg, 1) == 4


def test_train_reference_matches_the_port():
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    drv = __import__("benchkit.harness", fromlist=["driver"]).driver(
        "train_steps")
    cfg = smoke_config("chameleon-34b.pp12")
    tr = dict(configs.load_traffic("train-4k"), seq_len=48, batches=3,
              warmup_steps=2)
    seed = 3_000_000_007
    model = port_model(cfg)
    params = weights.port_tree(cfg, seed, torch.float32, "cpu")
    opt = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(
        lr=tr["lr"], b1=tr["b1"], b2=tr["b2"], eps=tr["eps"],
        weight_decay=tr["weight_decay"], clip_norm=tr["clip_norm"],
        warmup_steps=tr["warmup_steps"], total_steps=tr["total_steps"],
        min_lr_ratio=tr["min_lr_ratio"]))
    data = traffic.train_tokens(tr, cfg["vocab_size"], seed, "cpu")
    losses = []
    for i in range(3):
        batch = {"tokens": data[i][:, :-1], "labels": data[i][:, 1:]}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = {k: float((t / (1 - tr["b1"])).norm())
                    for k, t in drv.flat_leaves(opt.m).items()}
    ref = train_reference(cfg, tr, seed, data, "cpu")
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for k in grad:
        assert grad[k] == pytest.approx(ref["grad"][k], rel=1e-3,
                                        abs=1e-7), k
    from reference.train import change_norms
    change = change_norms(cfg, seed, drv.flat_leaves(params), "cpu")
    for k in change:
        assert change[k] == pytest.approx(ref["change"][k], rel=1e-3,
                                          abs=1e-7), k
