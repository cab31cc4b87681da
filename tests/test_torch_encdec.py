"""The port's encoder-decoder (whisper-large-v3, repro_torch.models.encdec)
against the JAX package, on the whisper smoke config in float32 on the
CPU: the encoder, the training forward's hidden states and the loss, the
prefill's logits and its lock-step cache (``k``, ``v``, ``xk``, ``xv``),
and four decode steps, under the reference's XLA attention and under its
Pallas kernels in interpret mode (``repro.kernels.ops.default_impl``).

The reference's ``Model.init`` tree is carried across with
``params_from_jax``; every zeros- or ones-initialised leaf (biases, norm
scales) is first moved by N(0, 0.2) from a numpy seed, so that the
biases and the LayerNorms are exercised. The frames and tokens are numpy
draws. Tolerance: 1e-4 relative to the largest value compared.

Both serving engines force the slot scheduler for an encoder-decoder and
then fail in prefill for want of ``frames``, which no request carries
(the reference's limitation, which the port shares).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.models import encdec as jax_ed
from repro.models.model import build_model as jax_build_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxEngine

from repro_torch import configs
from repro_torch.models import encdec as ed
from repro_torch.models.model import Model, params_from_jax
from repro_torch.serve.engine import Request, ServingEngine

RTOL = 1e-4
ARCH = "whisper-large-v3"
B, S_DEC, CACHE_LEN, STEPS = 2, 6, 16, 4
IMPLS = ["xla", "pallas_interpret"]


def _moved_constants(tree, seed: int, scale: float = 0.2):
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a, np.float32)
        return (a + scale * rng.standard_normal(a.shape) if np.ptp(a) == 0
                else a).astype(np.float32)

    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def whisper():
    """(jax model, jax params, port model, port params, frames, tokens,
    labels) for the smoke config in float32."""
    cfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
    jm = jax_build_model(cfg)
    jp = _moved_constants(jm.init(jax.random.PRNGKey(0)), seed=3)
    pcfg = configs.get_config(ARCH, smoke=True).replace(dtype="float32")
    pm = Model(pcfg, device="cpu")
    pp = params_from_jax(pcfg, jp, device="cpu")
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((B, cfg.cross_seq, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    labels[0, -2:] = -1                       # ignored positions
    return (jm, jax.tree.map(jnp.asarray, jp), pm, pp, frames, tokens,
            labels)


def _rel_close(got: torch.Tensor, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_forward_and_loss_match_the_reference(whisper, impl):
    jm, jp, pm, pp, frames, tokens, labels = whisper
    cfg = pm.cfg
    with jax_ops.default_impl(impl):
        enc = jax_ed.encode(jm.cfg, jp, jnp.asarray(frames))
        hid, aux = jm.forward(jp, {"frames": jnp.asarray(frames),
                                   "tokens": jnp.asarray(tokens)})
        loss = jm.loss(jp, {"frames": jnp.asarray(frames),
                            "tokens": jnp.asarray(tokens),
                            "labels": jnp.asarray(labels)})
    _rel_close(ed.encode(cfg, pp, _t(frames)), enc)
    phid, paux = pm.forward(pp, {"frames": _t(frames), "tokens": _t(tokens)})
    _rel_close(phid, hid)
    assert float(paux) == float(aux) == 0.0
    ploss = pm.loss(pp, {"frames": _t(frames), "tokens": _t(tokens),
                         "labels": _t(labels)})
    assert abs(float(ploss) - float(loss)) <= RTOL * abs(float(loss))


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_and_cache_match_the_reference(whisper, impl):
    jm, jp, pm, pp, frames, tokens, _ = whisper
    with jax_ops.default_impl(impl):
        logits, cache = jm.prefill(jp, {"frames": jnp.asarray(frames),
                                        "tokens": jnp.asarray(tokens)},
                                   cache_len=CACHE_LEN)
    plogits, pcache = pm.prefill(pp, {"frames": _t(frames),
                                      "tokens": _t(tokens)},
                                 cache_len=CACHE_LEN)
    _rel_close(plogits, logits)
    assert pcache["cur_len"] == int(cache["cur_len"]) == S_DEC
    assert set(pcache["dec"]) == set(cache["dec"]) == {"k", "v", "xk", "xv"}
    for name, leaf in pcache["dec"].items():
        _rel_close(leaf, cache["dec"][name])


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_steps_match_the_reference(whisper, impl):
    """Four greedy lock-step decode steps after the prefill: each step's
    logits, then the self-attention cache after the last."""
    jm, jp, pm, pp, frames, tokens, _ = whisper
    with jax_ops.default_impl(impl):
        logits, cache = jm.prefill(jp, {"frames": jnp.asarray(frames),
                                        "tokens": jnp.asarray(tokens)},
                                   cache_len=CACHE_LEN)
        plogits, pcache = pm.prefill(pp, {"frames": _t(frames),
                                          "tokens": _t(tokens)},
                                     cache_len=CACHE_LEN)
        for _ in range(STEPS):
            tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
            logits, cache = jm.decode_step(jp, cache, jnp.asarray(tok))
            plogits, pcache = pm.decode_step(pp, pcache, _t(tok))
            _rel_close(plogits, logits)
    assert pcache["cur_len"] == int(cache["cur_len"]) == S_DEC + STEPS
    for name in ("k", "v"):
        _rel_close(pcache["dec"][name], cache["dec"][name])


def test_lock_step_cache_has_the_reference_layout(whisper):
    jm, _, pm, _, _, _, _ = whisper
    want = jm.abstract_cache(3, CACHE_LEN)
    got = pm.init_cache(3, CACHE_LEN)
    assert got["cur_len"] == 0
    for name, leaf in got["dec"].items():
        assert tuple(leaf.shape) == tuple(want["dec"][name].shape)
        assert not leaf.any()
    assert pm.cache_bytes(3, CACHE_LEN) == sum(
        t.nbytes for t in got["dec"].values())
    with pytest.raises(NotImplementedError):
        pm.decode_step_ragged(None, got["dec"], None, None)


def test_both_engines_force_the_slot_scheduler_and_need_frames(whisper):
    jm, jp, pm, pp, _, _, _ = whisper
    prompt = np.arange(5, dtype=np.int32)
    jeng = JaxEngine(jm, jp, batch_slots=2, cache_len=CACHE_LEN)
    peng = ServingEngine(pm, pp, batch_slots=2, cache_len=CACHE_LEN)
    assert jeng.scheduler == peng.scheduler == "slot"
    jeng.submit(JaxRequest(0, prompt, max_tokens=4))
    peng.submit(Request(0, prompt, max_tokens=4))
    with pytest.raises(KeyError, match="frames"):
        jeng.run()
    with pytest.raises(KeyError, match="frames"):
        peng.run()


def test_full_config_counts_and_cache_bytes():
    """whisper-large-v3 at full width, from the metadata alone: the
    reference's parameter count, and the lock-step cache of 8 rows at
    whisper's 448-token decoder context against 1,500 frames."""
    cfg = configs.get_config(ARCH)
    pm = Model(cfg, device="cpu")
    jm = jax_build_model(jax_get_config(ARCH))
    assert pm.n_params() == jm.n_params()
    H, D, n = cfg.n_heads, cfg.head_dim, cfg.n_layers
    assert pm.cache_bytes(8, 448) == 2 * n * 8 * (448 + 1500) * H * D * 2
