"""Roofline terms of one step on one H100 (counterpart of
``repro.roofline.analysis``, whose terms come from a compiled dry-run
artifact; the port's come from :mod:`repro_torch.roofline.op_cost`'s count
of the aten ops the step dispatches on fake tensors).

  compute term    = FLOPs / (chips x peak bf16 FLOP/s)
  memory term     = bytes / (chips x HBM bytes/s)
  collective term = collective bytes / (chips x NVLink bytes/s)

against :mod:`repro_torch.roofline.hw`'s H100 constants. The count is of
one card's program, so the terms are per card directly.

:class:`Roofline` keeps the reference's field names, so that both
packages' ``to_dict()`` have the same keys: ``hlo_flops``, ``hlo_bytes``
and ``coll_bytes`` hold op_cost's counts (trips multiplied), and
``xla_cost`` and ``calibration`` hold ``torch.utils.flop_counter``'s count
of the same run, which takes XLA's ``cost_analysis()``'s place.

``roofline_fraction`` compares the workload's *intrinsic* best time
(max of useful-FLOP time and unavoidable-bytes time — weights once per
step, plus KV cache for decode) against the dominant counted term.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import NamedTuple

import torch

from repro_torch.roofline import hw, op_cost

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per chip
    hlo_bytes: float            # per chip (eager HBM model)
    coll_bytes: float           # per chip
    coll_breakdown: dict = field(default_factory=dict)
    model_flops: float = 0.0    # global useful FLOPs (6ND / 2ND)
    ideal_bytes: float = 0.0    # global unavoidable bytes (weights/cache)
    bytes_per_device: float = 0.0
    peak_memory_ok: bool = True
    xla_cost: dict = field(default_factory=dict)
    # cross-calibration against FlopCounterMode on the same run, which
    # sees each loop body once: op_cost's count with trips not multiplied
    calibration: dict = field(default_factory=dict)
    # kernel-traffic substitution: flash_bytes = HBM traffic of the plain
    # versions inside kernel regions (op_cost.region); kernel_bytes = what
    # the hand-written kernels move for the same math
    flash_bytes: float = 0.0
    kernel_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / hw.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_ideal(self) -> float:
        t_f = (self.model_flops / self.chips) / hw.PEAK_FLOPS_BF16
        t_b = (self.ideal_bytes / self.chips) / hw.HBM_BW
        return max(t_f, t_b)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs per chip (remat/redundancy waste)."""
        per_chip = self.model_flops / self.chips
        return per_chip / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        return self.t_ideal / self.t_bound if self.t_bound else 0.0

    @property
    def ai_fraction(self) -> float:
        """Accelerable share of the serialized term sum: the compute term
        is what an s×-faster accelerator shrinks; memory + collective
        terms are the infrastructure tax that stays. Feeds
        :func:`repro_torch.core.acceleration.profile_from_roofline`."""
        tot = self.t_compute + self.t_memory + self.t_collective
        return self.t_compute / tot if tot else 0.0

    def stage_profile(self):
        """This cell as an Amdahl stage profile (measured, not paper)."""
        from repro_torch.core import acceleration
        return acceleration.StageProfile(
            f"{self.arch}:{self.shape}", self.ai_fraction)

    # ---- hand-written-kernel variant (same count, substituted traffic
    # for the tagged regions) ----
    @property
    def t_memory_pallas(self) -> float:
        return max(self.hlo_bytes - self.flash_bytes + self.kernel_bytes,
                   0.0) / hw.HBM_BW

    @property
    def t_bound_pallas(self) -> float:
        return max(self.t_compute, self.t_memory_pallas, self.t_collective)

    @property
    def bottleneck_pallas(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory_pallas,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def roofline_fraction_pallas(self) -> float:
        return self.t_ideal / self.t_bound_pallas if self.t_bound_pallas else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 t_bound=self.t_bound, t_ideal=self.t_ideal,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction,
                 ai_fraction=self.ai_fraction,
                 t_memory_pallas=self.t_memory_pallas,
                 t_bound_pallas=self.t_bound_pallas,
                 bottleneck_pallas=self.bottleneck_pallas,
                 roofline_fraction_pallas=self.roofline_fraction_pallas)
        return d


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N_active·D (inference), global."""
    counts = cfg.param_counts()
    n = counts["active"]
    tokens = shape.global_batch * shape.seq_len
    if cfg.encdec:
        tokens = shape.global_batch * (shape.seq_len
                                       + shape.seq_len // cfg.dec_ratio)
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch     # decode: one token per sequence


def ideal_bytes_estimate(cfg, shape, param_bytes: float,
                         cache_bytes: float = 0.0) -> float:
    """Unavoidable global HBM traffic per step."""
    if shape.kind == "train":
        # fwd read + bwd read + grad write + opt read(m,v)+write(m,v,p)
        # with f32 master+moments: ~7 passes over f32 params
        return 7.0 * param_bytes
    if shape.kind == "prefill":
        return param_bytes
    return param_bytes + cache_bytes        # decode reads weights + cache


def kernel_ideal_bytes(cfg, shape, chips: int) -> float:
    """Per-chip HBM traffic of the kernels for this cell's tagged regions:
    q/k/v/o tiles for attention, input/output streams for the SSM/RWKV
    scans, cache reads for decode. Scores and per-step states stay on
    chip. Training multiplies by 4 (fwd + remat recompute + a ~2x
    backward); prefill is 1x."""
    B, S = shape.global_batch, shape.seq_len
    elt = 2.0                                     # bf16
    mult = 4.0 if shape.kind == "train" else 1.0
    D = cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if cfg.mla is not None:
        H = KV = cfg.n_heads
        D = cfg.mla.qk_nope + cfg.mla.qk_rope
    total = 0.0
    n_rep = cfg.n_repeats
    for spec in cfg.block_pattern:
        if spec.kind == "attn":
            if shape.kind == "decode":
                L = min(spec.window, S) if spec.window else S
                total += n_rep * B * L * 2 * KV * D * elt     # cache read
            else:
                tok = B * S
                total += n_rep * mult * tok * D * (2 * H + 2 * KV) * elt
        elif spec.kind == "mamba":
            di = cfg.ssm_expand * cfg.d_model
            tok = B * (1 if shape.kind == "decode" else S)
            total += n_rep * mult * tok * (3 * di + 2 * cfg.ssm_state) * elt
        else:  # rwkv
            tok = B * (1 if shape.kind == "decode" else S)
            total += n_rep * mult * tok * 5 * cfg.d_model * elt
    if cfg.encdec and shape.kind != "decode":
        total += cfg.n_enc_layers * mult * B * S * 4 * H * D * elt
    return total / chips


def from_counted(arch: str, shape_name: str, mesh_name: str, chips: int,
                 cost: op_cost.OpCounter, cost_lib: float | None, cfg, shape,
                 *, param_bytes: float = 0.0,
                 cache_bytes: float = 0.0) -> Roofline:
    """The roofline of one step from ``cost``, the :class:`~repro_torch.
    roofline.op_cost.OpCounter` of its run (:func:`count_step`), and
    ``cost_lib``, ``FlopCounterMode``'s total on the same run (None where
    none ran). ``flops_delta`` compares the dot FLOPs with trips not
    multiplied against it, the only FLOPs that counter counts, and is None
    when it reports none: "no comparison ran", not "perfect agreement"."""
    tripped, flat = cost.cost, cost.flat
    lib = float(cost_lib or 0.0)
    calibration = {
        "flops_untripped": flat.flops,
        "lib_flops": lib,
        "flops_delta": (flat.dot_flops - lib) / lib if lib else None,
        "trip_multiplier": (tripped.flops / flat.flops
                            if flat.flops else 1.0),
    }
    bpd = float(cost.peak_bytes)
    coll = {k: tripped.coll[k] for k in _COLLECTIVES}
    coll["total"] = tripped.coll_bytes
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=tripped.flops, hlo_bytes=tripped.hbm_bytes,
        coll_bytes=tripped.coll_bytes, coll_breakdown=coll,
        model_flops=model_flops_estimate(cfg, shape),
        ideal_bytes=ideal_bytes_estimate(
            cfg, shape, param_bytes, cache_bytes),
        bytes_per_device=bpd, peak_memory_ok=bpd <= hw.HBM_BYTES,
        xla_cost={"flops": lib} if cost_lib is not None else {},
        calibration=calibration,
        flash_bytes=tripped.flash_bytes,
        kernel_bytes=kernel_ideal_bytes(cfg, shape, chips))


# --------------------------------------------------------------------------
# Counting one step of the port's Model
# --------------------------------------------------------------------------

class StepCount(NamedTuple):
    counter: op_cost.OpCounter   # the step's count
    lib_flops: float             # FlopCounterMode's on the same run
    param_bytes: float           # the parameters as the step holds them
    cache_bytes: float           # the decode cache (0 for the others)


def _fake_params(model, params, masters: bool):
    """Fake CPU leaves shaped as ``params``' (any device, real or not), or,
    for None, as :meth:`Model.init` makes them (float32 masters for
    training, else each leaf cast as ``cast_leaf`` casts it)."""
    from repro_torch.models import model as mm
    from repro_torch.models.layers import cast_leaf, map_tree
    if params is not None:
        return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype), params)
    dtype = torch.float32 if masters else model.dtype
    return mm._by_part(lambda meta, stacked: map_tree(
        lambda p: cast_leaf(torch.empty(p.shape), dtype, stacked), meta),
        model.param_meta())


def count_step(model, params, shape_like, kind: str, *, mesh=None,
               rules=None) -> StepCount:
    """Count one step of ``model`` (a ``repro_torch.models.model.Model``)
    on fake tensors: ``kind`` ``"prefill"`` (``shape_like.global_batch``
    prompts of ``shape_like.seq_len`` tokens), ``"decode"`` (one
    ``decode_step_ragged`` tick of as many rows against a cache of
    ``seq_len``; an encoder-decoder's lock-step ``decode_step``) or
    ``"train"`` (forward, loss, backward and AdamW on float32 masters, as
    ``train.train_step`` runs them); making the parameters, the optimizer
    state and the cache is set-up, left out of the count (not of its
    peak bytes). An encoder-decoder's batches carry
    ``seq_len`` frames and ``seq_len // dec_ratio`` tokens. ``params``
    gives the leaves' shapes and dtypes (None: the model's metadata), and
    is never read or written; the step runs on the CPU whatever the
    model's device, so every kernel wrapper takes its plain version.

    With ``mesh`` (a DeviceMesh of more than one rank, e.g. the dry run's
    fake production mesh) and ``rules`` (the train or serve rules by
    default) the step runs as one rank of that mesh
    (:func:`_count_on_mesh`): the count is that rank's, and so are the
    peak bytes; ``params`` is not used."""
    from repro_torch.distributed import sharding as shd
    if mesh is not None and shd.is_distributed(mesh):
        return _count_on_mesh(model, shape_like, kind, mesh, rules)
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    if kind not in ("prefill", "decode", "train"):
        raise ValueError(f"kind must be prefill, decode or train, got {kind!r}")
    cfg = model.cfg
    B, S = shape_like.global_batch, shape_like.seq_len
    lib = FlopCounterMode(display=False)
    cache_bytes = 0.0
    model = type(model)(cfg, device="cpu")     # fake CPU tensors throughout
    with op_cost.counting(lib) as counter:
        p = _fake_params(model, params, masters=kind == "train")
        param_bytes = float(sum(t.nbytes for t in tree_leaves(p)))
        tokens = torch.zeros((B, max(1, S // cfg.dec_ratio) if cfg.encdec
                              else S), dtype=torch.long)
        batch = {"tokens": tokens}
        if cfg.encdec:
            batch["frames"] = torch.empty((B, S, p["enc_in"].shape[0]),
                                          dtype=torch.float32)
        if kind == "train":
            batch["labels"] = tokens
            step = make_train_step(model, AdamWConfig())
            opt = init_opt_state(p)
            counter.reset()
            step(p, opt, batch)
        elif kind == "prefill":
            counter.reset()
            with torch.no_grad():
                model.prefill(p, batch, cache_len=tokens.shape[1])
        else:
            cache_bytes = float(model.cache_bytes(B, S))
            cache = model.init_cache(B, S)
            one = torch.zeros((B, 1), dtype=torch.long)
            counter.reset()
            with torch.no_grad():
                if cfg.encdec:
                    model.decode_step(p, {**cache, "cur_len": S - 1}, one)
                else:
                    model.decode_step_ragged(
                        p, cache["blocks"], one,
                        torch.full((B,), S - 1, dtype=torch.long))
    return StepCount(counter, float(lib.get_total_flops()), param_bytes,
                     cache_bytes)


def _count_on_mesh(model, shape_like, kind: str, mesh, rules) -> StepCount:
    """:func:`count_step` as one rank of ``mesh``: the parameters (float32
    masters for training, else as :meth:`Model.init` holds them), the
    optimizer state, the batch (the reference's ``input_specs``) and the
    decode cache are DTensors of fake shards laid out by the train or
    serve shardings, made shard by shard (nothing global is allocated);
    the step runs under ``use_sharding(mesh, rules)``, through
    ``train_step.make_train_step(sh=...)``, ``serve_step.make_prefill``
    or ``serve_step.placed_decode_step`` (lock step at position
    ``seq_len - 1``, as the reference's dry run decodes). Every op that
    runs is a local op on a shard or a collective, so the counter books
    one rank's FLOPs and bytes and the collectives' bytes by kind.
    ``param_bytes`` and ``cache_bytes`` are global, as the reference's."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    if kind not in ("prefill", "decode", "train"):
        raise ValueError(f"kind must be prefill, decode or train, got {kind!r}")
    cfg = model.cfg
    B, S = shape_like.global_batch, shape_like.seq_len
    model = type(model)(cfg, device="cpu")
    specs = model.input_specs(ShapeConfig("count", kind, S, B))

    def laid_out(meta_tree, shardings):
        return shd.map_trees(
            lambda m, s: shd.empty_laid_out(tuple(m.shape), m.dtype, s),
            meta_tree, shardings,
            is_leaf=lambda t: isinstance(t, torch.Tensor))

    def nbytes(tree):
        return float(sum(t.nbytes for t in tree_leaves(tree)
                         if isinstance(t, torch.Tensor)))

    from repro_torch.models.layers import tree_leaves
    # shardings and shapes first, outside the fake mode and the counter:
    # their meta tensors are neither the step's work nor its memory
    if kind == "train":
        sh = ts.make_train_shardings(model, mesh, rules, batch_specs=specs)
        aparams, psh, bsh = model.abstract_params(), sh.params, sh.batch
    else:
        cache_len = specs["tokens"].shape[1] if kind == "prefill" else S
        ssh = serve_step.make_serve_shardings(model, mesh, B, cache_len,
                                              rules)
        aparams, psh = model.abstract_params(model.dtype), ssh.params
        bsh = ts.batch_shardings(model, specs, mesh, ssh.rules)
        part = model._cache_part()
        acache = model.abstract_cache(B, S)
    lib = FlopCounterMode(display=False)
    cache_bytes = 0.0
    with op_cost.counting(lib) as counter:
        p = laid_out(aparams, psh)
        batch = laid_out(specs, bsh)
        if kind == "train":
            opt = init_opt_state(p)
            step = ts.make_train_step(model, AdamWConfig(), sh)
            counter.reset()
            step(p, opt, batch)
        elif kind == "prefill":
            fn = serve_step.make_prefill(model, ssh, cache_len)
            counter.reset()
            with torch.no_grad():
                fn(p, batch)
        else:
            cache_bytes = nbytes(acache)
            cache = {part: laid_out(acache[part], ssh.cache[part]),
                     "cur_len": S - 1}
            fn = serve_step.placed_decode_step(model, ssh, B)
            counter.reset()
            with torch.no_grad():
                fn(p, cache, batch["tokens"])
    return StepCount(counter, float(lib.get_total_flops()), nbytes(aparams),
                     cache_bytes)
