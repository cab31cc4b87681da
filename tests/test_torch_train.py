"""The port's training (repro_torch.train, data.tokens, Model.loss) against
the JAX package, on the CPU.

Copies of ``tests/test_train.py`` and of ``tests/test_checkpoint.py``'s
non-elastic cases for the port's modules, then parity runs with the
reference's weights carried across (``params_from_jax(masters=True)``):
a 10-step llama3 smoke training run through the port's ``Trainer`` against
the reference's ``Trainer`` with ``jax.value_and_grad(model.loss)`` +
``adamw_update`` on the same ``TokenLoader`` batches (per-step loss within
1e-5 relative, grad norm within 1e-4, final parameters within 1e-5 in
each leaf's L2 norm, AdamW's eps above the packages' float32 gradient
difference), and one step's loss and gradients for the
whisper (frames from a numpy seed), granite-moe (the MoE aux loss),
rwkv6, jamba, gemma3, deepseek-v2, qwen2.5-14b, chameleon-34b and
qwen1.5-110b smoke configs (each gradient leaf within 1e-4 of its largest
value; the last three with their biases and norm scales moved off their
init). float32 throughout; the reference runs its XLA path.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenLoader as JaxLoader
from repro.models.model import build_model as jax_build_model
from repro.train import optimizer as jax_opt
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig

from test_torch_models import _moved_constants

from repro_torch import configs
from repro_torch.data.tokens import TokenLoader
from repro_torch.models.layers import map_tree, tree_leaves
from repro_torch.models.model import Model, params_from_jax
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optimizer import (
    AdamWConfig, adamw_update, global_norm, init_opt_state, schedule,
)
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig, Watchdog


def _tiny(arch="llama3-8b", **kw):
    cfg = configs.get_config(arch, smoke=True).replace(dtype="float32", **kw)
    return cfg, Model(cfg, device="cpu")


# ---- copies of tests/test_train.py -----------------------------------------

def test_adamw_minimizes_quadratic():
    hp = AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0,
                     total_steps=200)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = init_opt_state(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"].clone()}
        params, opt, _ = adamw_update(grads, opt, params, hp)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


@pytest.mark.parametrize("n", [4096, 70_001, 3 * 2048 + 5])
def test_sliced_update_equals_the_whole_leaf_bit_for_bit(monkeypatch, n):
    """A leaf of more than UPDATE_CHUNK elements is updated a slice at a
    time: two steps (the second from the first's moments, weight decay on
    the matrix, none on the vector, the gradients clipped) give parameters,
    moments, scaled gradients and grad norms equal bit for bit to the
    update of each leaf whole."""
    from repro_torch.train import optimizer
    g = torch.Generator().manual_seed(n)

    def tree(scale):
        return {"embed": {"tok": scale * torch.randn((n, 3), generator=g)},
                "ln_f": scale * torch.randn((n,), generator=g),
                "small": scale * torch.randn((7, 5), generator=g)}
    params = tree(0.02)
    grads = [tree(5.0), tree(5.0)]
    hp = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    runs = {}
    for chunk in (1 << 30, 2048):
        monkeypatch.setattr(optimizer, "UPDATE_CHUNK", chunk)
        p = map_tree(torch.clone, params)
        opt, gs, norms = init_opt_state(p), [], []
        for gr in grads:
            gr = map_tree(torch.clone, gr)
            p, opt, gn = adamw_update(gr, opt, p, hp)
            gs.append(gr)
            norms.append(gn)
        runs[chunk] = tree_leaves(p) + tree_leaves(opt.m) + tree_leaves(
            opt.v) + tree_leaves(gs) + norms
    assert len(optimizer.pieces(*[params["ln_f"]] * 4)) == -(-n // 2048)
    for a, b in zip(runs[1 << 30], runs[2048]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_pieces_slice_only_plain_contiguous_leaves_above_the_chunk(
        monkeypatch):
    """Views of a leaf's elements in order, each UPDATE_CHUNK long but the
    last, written through to the leaf; a leaf no larger than the chunk, or
    one that is not contiguous, stays whole."""
    from repro_torch.train import optimizer
    monkeypatch.setattr(optimizer, "UPDATE_CHUNK", 8)
    t = torch.arange(20.0).reshape(4, 5)
    parts = optimizer.pieces(t, t.clone())
    assert [tuple(x.numel() for x in part) for part in parts] == [
        (8, 8), (8, 8), (4, 4)]
    parts[1][0].fill_(-1.0)
    assert torch.equal(t.view(-1)[8:16], torch.full((8,), -1.0))
    small = torch.zeros(8)
    assert optimizer.pieces(small, small)[0][0] is small
    strided = torch.zeros(5, 4).t()
    assert optimizer.pieces(strided, strided)[0][0] is strided


@pytest.mark.parametrize("scale", [0.1, 1.0, 10.0])
def test_grad_clipping_property(scale):
    """Post-clip effective grad norm never exceeds clip_norm."""
    g = {"a": torch.ones((4, 4)) * scale}
    gn = float(global_norm(g))
    clip_scale = min(1.0, 1.0 / (gn + 1e-9))
    assert gn * clip_scale <= 1.0 + 1e-6


def test_schedule_warmup_and_decay():
    hp = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert schedule(hp, 5) < hp.lr
    assert schedule(hp, 10) == pytest.approx(hp.lr, rel=1e-3)
    assert schedule(hp, 100) == pytest.approx(hp.lr * hp.min_lr_ratio,
                                              rel=1e-3)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 57, 100, 140])
def test_schedule_equals_the_reference(step):
    hp = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    want = jax_opt.schedule(jax_opt.AdamWConfig(**hp.__dict__),
                            jnp.asarray(step))
    assert schedule(hp, step) == float(want)


def test_loss_decreases_on_tiny_lm(tmp_path):
    cfg, model = _tiny(n_layers=2, d_model=64, vocab_size=64)
    loader = TokenLoader(cfg.vocab_size, batch=8, seq_len=32, device="cpu")
    hp = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    tc = TrainerConfig(steps=40, ckpt_every=100, log_every=100,
                       ckpt_dir=str(tmp_path / "ck"))
    _, _, hist = Trainer(model, make_train_step(model, hp), loader, tc).run()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.1, (first, last)


def test_trainer_restart_resumes_from_checkpoint(tmp_path):
    cfg, model = _tiny(n_layers=1, d_model=32, vocab_size=32)
    hp = AdamWConfig(lr=1e-3)

    def make(steps):
        return Trainer(model, make_train_step(model, hp),
                       TokenLoader(cfg.vocab_size, batch=4, seq_len=16,
                                   device="cpu"),
                       TrainerConfig(steps=steps, ckpt_every=5,
                                     log_every=1000,
                                     ckpt_dir=str(tmp_path / "ck")))

    make(10).run()                              # writes step_10
    params, opt, hist = make(14).run()          # "restarted" job
    assert hist[0]["step"] == 11                # resumed, not restarted
    assert opt.count == 14


def test_trainer_without_a_checkpoint_dir_neither_resumes_nor_writes(
        tmp_path, monkeypatch):
    cfg, model = _tiny(n_layers=1, d_model=32, vocab_size=32)
    monkeypatch.chdir(tmp_path)
    trainer = Trainer(model, make_train_step(model, AdamWConfig(lr=1e-3)),
                      TokenLoader(cfg.vocab_size, batch=2, seq_len=8,
                                  device="cpu"),
                      TrainerConfig(steps=3, ckpt_every=1, log_every=1000,
                                    ckpt_dir=None))
    _, opt, hist = trainer.run()
    assert [h["step"] for h in hist] == [1, 2, 3] and opt.count == 3
    assert trainer.ckpt is None and not any(tmp_path.iterdir())


def test_grad_accum_averages_the_microbatches():
    """``grad_accum = 2`` gives the mean of the two halves' losses and
    gradients, which for equal halves is the whole batch's."""
    cfg, model = _tiny(n_layers=1, d_model=32, vocab_size=32)
    params = model.init(seed=0, masters=True)
    batch = TokenLoader(cfg.vocab_size, batch=4, seq_len=8,
                        device="cpu").next_batch()
    loss1, g1 = make_train_step(model, AdamWConfig()).grads(params, batch)
    loss2, g2 = make_train_step(model, AdamWConfig(),
                                grad_accum=2).grads(params, batch)
    assert abs(float(loss1) - float(loss2)) <= 1e-6 * abs(float(loss1))
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_watchdog_detects_hang():
    dog = Watchdog(timeout=0.2).start()
    time.sleep(0.7)
    dog.stop()
    assert len(dog.hangs) >= 1


def test_loader_is_seekable_and_deterministic():
    l1 = TokenLoader(64, batch=4, seq_len=8, device="cpu")
    batches = [l1.next_batch() for _ in range(3)]
    l2 = TokenLoader(64, batch=4, seq_len=8, device="cpu")
    l2.seek(2)
    assert torch.equal(batches[2]["tokens"], l2.next_batch()["tokens"])


def test_loader_host_sharding_partitions_batch():
    full = TokenLoader(64, batch=8, seq_len=8, device="cpu").next_batch()
    h0 = TokenLoader(64, batch=8, seq_len=8, host_index=0, host_count=2,
                     device="cpu").next_batch()
    h1 = TokenLoader(64, batch=8, seq_len=8, host_index=1, host_count=2,
                     device="cpu").next_batch()
    assert torch.equal(torch.cat([h0["tokens"], h1["tokens"]]),
                       full["tokens"])


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2)])
def test_loader_batches_equal_the_reference(host_index, host_count):
    mine = TokenLoader(256, batch=4, seq_len=12, seed=3, device="cpu",
                       host_index=host_index, host_count=host_count)
    ref = JaxLoader(256, batch=4, seq_len=12, seed=3, host_index=host_index,
                    host_count=host_count)
    mine.seek(5)
    ref.seek(5)
    for _ in range(2):
        a, b = mine.next_batch(), ref.next_batch()
        for name in ("tokens", "labels"):
            assert a[name].dtype == torch.int32
            np.testing.assert_array_equal(a[name].numpy(), np.asarray(b[name]))


# ---- copies of tests/test_checkpoint.py (the elastic re-shard is not
# ported: the port has no mesh yet) ------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "b": {"c": torch.arange(12, dtype=torch.int32),
                  "d": torch.tensor(3.5)},
            "n": [torch.randn((4,), generator=g), 7]}


def _leaves_equal(t, u):
    a, b = tree_leaves(t), tree_leaves(u)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(7, t, blocking=True)
    target = _tree(seed=1)
    target["n"][1] = 0
    restored, step = ck.restore(target)
    assert step == 7
    _leaves_equal(restored, t)


def test_async_save_overlaps_and_waits(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1))       # non-blocking
    ck.save(2, _tree(2))       # waits for the previous write internally
    ck.wait()
    assert ck.all_steps() == [1, 2]


def test_save_snapshots_before_returning(tmp_path):
    """The trainer updates its tensors in place right after a save: what
    is written is the state at the call."""
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    want = _tree()
    ck.save(1, t)
    t["a"].add_(1.0)
    ck.wait()
    restored, _ = ck.restore(_tree(seed=2))
    _leaves_equal(restored, want)


def test_retention_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s), blocking=True)
    assert ck.all_steps() == [3, 4]


def test_restore_missing_leaf_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones((2,))}, blocking=True)
    with pytest.raises(KeyError):
        ck.restore({"a": torch.ones((2,)), "zz": torch.ones((2,))})


def test_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones((2,))}, blocking=True)
    with pytest.raises(ValueError):
        ck.restore({"a": torch.ones((3,))})


# ---- parity with the reference ------------------------------------------------

def _jax_pair(arch, moved: bool = False, **kw):
    jcfg = jax_get_config(arch, smoke=True).replace(dtype="float32", **kw)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if moved:            # every bias and norm scale off its init
        jp = jax.tree.map(jnp.asarray, _moved_constants(jp, seed=2))
    pcfg, pm = _tiny(arch, **kw)
    pp = params_from_jax(pcfg, jax.tree.map(np.asarray, jp), device="cpu",
                         masters=True)
    return jm, jp, pcfg, pm, pp


def _leaf_close(got, want, rtol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


def test_ten_step_llama_run_matches_the_reference(tmp_path):
    """Both packages' Trainers, 10 steps of AdamW on the same batches from
    the same weights: the same history (loss, grad norm, skips) and final
    parameters.

    AdamW's eps is 1e-6 here, above the ~1e-9 by which the two packages'
    float32 gradients differ: at the default 1e-8 an element whose
    gradient is near eps gets an update g / (|g| + eps) that a rounding
    difference moves by a good part of lr (up to 5e-5 of a parameter in
    eight runs of different initial weights, 7e-6 of a leaf's L2 norm)."""
    jm, jp, cfg, pm, pp = _jax_pair("llama3-8b")
    hp = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10, eps=1e-6)
    jhp = jax_opt.AdamWConfig(**hp.__dict__)

    def jstep(params, opt, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        params, opt, gn = jax_opt.adamw_update(grads, opt, params, jhp)
        return params, opt, {"loss": loss, "grad_norm": gn,
                             "step": opt.count}

    jtc = JaxTrainerConfig(steps=10, ckpt_every=100, log_every=100,
                           ckpt_dir=str(tmp_path / "jax"))
    jparams, _, jhist = JaxTrainer(
        jm, jax.jit(jstep), JaxLoader(cfg.vocab_size, batch=4, seq_len=32),
        jtc, init_params_fn=lambda: jp).run()
    tc = TrainerConfig(steps=10, ckpt_every=100, log_every=100,
                       ckpt_dir=str(tmp_path / "port"))
    params, opt, hist = Trainer(
        pm, make_train_step(pm, hp),
        TokenLoader(cfg.vocab_size, batch=4, seq_len=32, device="cpu"), tc,
        init_params_fn=lambda: pp).run()
    assert opt.count == 10
    for a, b in zip(hist, jhist):
        assert a["step"] == b["step"] and a["skipped"] == b["skipped"]
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * b["grad_norm"]
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                           device="cpu", masters=True)
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        # in the L2 norm of each leaf (within 1e-6 in eight runs)
        err = torch.linalg.vector_norm(a.detach() - b)
        assert float(err) <= 1e-5 * float(torch.linalg.vector_norm(b))


def _named(tree, path=""):
    """(path, leaf) pairs of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _named(v, f"{path}/{i}")]
    return [(path, tree)]


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 10)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 10))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    batch["labels"][1, -3:] = -1
    if cfg.encdec:
        batch["frames"] = rng.standard_normal(
            (2, cfg.cross_seq, cfg.d_model)).astype(np.float32)
    return batch


# the archs whose one-step case moves every constant leaf off its init
# first (qwen's q/k/v biases, chameleon's q/k norm scales)
MOVED = ("qwen2.5-14b", "chameleon-34b", "qwen1.5-110b")


@pytest.mark.parametrize("arch", ["whisper-large-v3", "granite-moe-3b-a800m",
                                  "rwkv6-3b", "jamba-v0.1-52b", "gemma3-12b",
                                  "deepseek-v2-236b", *MOVED])
def test_one_step_loss_and_grads_match_the_reference(arch):
    jm, jp, cfg, pm, pp = _jax_pair(arch, moved=arch in MOVED)
    batch = _batch(cfg, seed=11)
    loss, grads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(pm, AdamWConfig())
    ploss, pgrads = step.grads(pp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, grads),
                           device="cpu", masters=True)
    top = max(float(t.abs().max()) for t in tree_leaves(want))
    for (name, a), (_, b) in zip(_named(pgrads), _named(want)):
        if name.endswith("/bk") and cfg.pos != "rope":
            # without RoPE (whisper's sincos) the key bias's gradient is 0
            # in exact arithmetic (q . bk, one constant added to a row's
            # scores, leaves its softmax as it is): both sides give
            # rounding noise. Under RoPE the bias is rotated by each key's
            # position and moves the scores: compared as any leaf
            assert float(a.abs().max()) <= 1e-6 * top
            assert float(b.abs().max()) <= 1e-6 * top
        else:
            _leaf_close(a, b.numpy(), 1e-4)
    assert abs(float(global_norm(pgrads)) - float(jax_opt.global_norm(grads))) \
        <= 1e-4 * float(jax_opt.global_norm(grads))
