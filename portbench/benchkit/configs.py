"""Configuration files, and the port's ``ModelConfig`` built from one.

A configuration file (``portbench/configs/<name>.json``) holds the sizes as
they are run, under the published config's key names, with the port's
registry name (``port_config``) it is run through. :func:`port_config`
takes that registry entry, cuts its depth to the file's, and raises where
any size the file states differs from what the port would run: the file
is the configuration as run, never a description beside it.
"""
from __future__ import annotations

import json
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_config(name: str) -> dict:
    return load_json(PORTBENCH / "configs" / f"{name}.json")


def load_traffic(name: str) -> dict:
    return load_json(PORTBENCH / "traffic" / f"{name}.json")


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in bench['workloads']]}")


def moe_capacity(cfg: dict, n_tokens: int) -> int:
    """Slots an expert takes in one dispatch of ``n_tokens`` tokens:
    int(n k / E cf) rounded up to a multiple of 4, at least 4."""
    c = int(n_tokens * cfg["num_experts_per_tok"] / cfg["num_experts"]
            * cfg["expert_capacity_factor"])
    return max(4, -(-c // 4) * 4)


def port_config(cfg: dict, smoke: bool = False):
    """The port's ``ModelConfig`` for the file ``cfg``: its registry entry
    at the file's depth. ``smoke`` (tests only, with a file whose sizes are
    the smoke config's) starts from the port's smoke config of the arch.
    Raises ``ValueError``
    where a size differs from the file's."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_specs
    from benchkit.work import layer_kinds
    pc = get_config(cfg["port_config"], smoke=smoke)
    pc = pc.replace(n_layers=cfg["num_hidden_layers"])
    want = {"d_model": cfg["hidden_size"],
            "n_heads": cfg["num_attention_heads"],
            "n_kv_heads": cfg["num_key_value_heads"],
            "head_dim": cfg["head_dim"], "d_ff": cfg["intermediate_size"],
            "vocab_size": cfg["vocab_size"], "act": cfg["hidden_act"],
            "rope_theta": cfg["rope_theta"], "norm": "rmsnorm",
            "mlp_kind": "glu", "pos": "rope", "qkv_bias": False,
            "qk_norm": cfg.get("qk_norm") == "rmsnorm",
            "tie_embeddings": cfg["tie_word_embeddings"],
            "embed_scale": False, "dtype": cfg["dtype"], "mla": None}
    have = {k: getattr(pc, k) for k in want}
    if "num_experts" in cfg:
        m = pc.moe
        want.update(n_experts=cfg["num_experts"],
                    top_k=cfg["num_experts_per_tok"],
                    d_expert=cfg["expert_intermediate_size"],
                    capacity_factor=cfg["expert_capacity_factor"],
                    n_shared=0)
        have.update(n_experts=m.n_experts, top_k=m.top_k,
                    d_expert=m.d_expert, capacity_factor=m.capacity_factor,
                    n_shared=m.n_shared)
    if "mamba_d_state" in cfg:
        want.update(ssm_state=cfg["mamba_d_state"],
                    ssm_conv=cfg["mamba_d_conv"],
                    ssm_expand=cfg["mamba_expand"],
                    dt_rank=cfg["mamba_dt_rank"])
        have.update(ssm_state=pc.ssm_state, ssm_conv=pc.ssm_conv,
                    ssm_expand=pc.ssm_expand,
                    dt_rank=pc.ssm_dt_rank or max(pc.d_model // 16, 1))
    kinds = [(s.kind, bool(s.moe)) for s in layer_specs(pc)]
    want["layers"], have["layers"] = layer_kinds(cfg), kinds
    if any(s.window for s in layer_specs(pc)):
        have["window"] = True
        want["window"] = False
    bad = {k: (want[k], have[k]) for k in want if want[k] != have[k]}
    if bad:
        raise ValueError(f"{cfg['name']}: the port's {cfg['port_config']} "
                         f"differs from the file (file, port): {bad}")
    return pc
