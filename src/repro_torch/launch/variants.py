"""Named lowering variants for the perf hillclimb (a copy of
``repro.launch.variants`` with the imports renamed).

A variant bundles the sharding rules + model/step knobs that one §Perf
iteration changes. ``baseline`` is the paper-faithful starting point; the
hillclimb registers additional variants and the dry-run lowers any of them
with ``--variant``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.distributed import sharding as shd


@dataclass(frozen=True)
class Variant:
    name: str
    train_rules: shd.Rules = field(default_factory=lambda: dict(shd.TRAIN_RULES))
    serve_rules: shd.Rules = field(default_factory=lambda: dict(shd.SERVE_RULES))
    # model-config overrides applied via cfg.replace(**model_overrides)
    model_overrides: dict = field(default_factory=dict)
    notes: str = ""


def _rules(base: shd.Rules, **kw) -> shd.Rules:
    r = dict(base)
    r.update(kw)
    return r


VARIANTS: dict[str, Variant] = {}


def register(v: Variant) -> Variant:
    VARIANTS[v.name] = v
    return v


register(Variant(
    name="baseline",
    train_rules=_rules(shd.TRAIN_RULES, attn_q=None),
    serve_rules=_rules(shd.SERVE_RULES, attn_q=None),
    notes="starting point: 2-D FSDPxTP train sharding, sequence-parallel "
          "boundaries, sequence-sharded serve caches; heads-only "
          "attention sharding (no q-row fallback)"))

# ---- hillclimb variants (see EXPERIMENTS.md §Perf for the log) -----------

register(Variant(
    name="attn_q",
    notes="§Perf iter: q-row sharding fallback for head counts that don't "
          "divide the model axis (qwen2.5 40H, whisper 20H, granite 24H)",
))

register(Variant(
    name="seq_data_cache",
    serve_rules=_rules(shd.SERVE_RULES, kv_seq=("model", "data"),
                       batch=("pod",)),
    notes="decode: shard cache sequence over BOTH data+model axes "
          "(batch stays on pod only) — for small-batch long-context decode",
))

register(Variant(
    name="serve_repl_w",
    serve_rules=_rules(shd.SERVE_RULES, embed=None),
    notes="§Perf iter (decode): drop the FSDP dimension at serve time — "
          "weights sharded only over the model axis, so decode stops "
          "all-gathering weight shards every step (latency path); "
          "memory check: weights/16 must fit beside the cache shard",
))

register(Variant(
    name="moe_cf1",
    model_overrides={"moe_capacity_factor": 1.0},
    notes="§Perf iter (MoE train): capacity_factor 1.25 -> 1.0 trims the "
          "dispatch buffer slack: less all-to-all + expert-compute waste "
          "at the cost of more dropped tokens under imbalance",
))


def get_variant(name: str) -> Variant:
    if name not in VARIANTS:
        raise KeyError(f"unknown variant {name!r}: {sorted(VARIANTS)}")
    return VARIANTS[name]
