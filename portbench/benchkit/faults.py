"""Faults planted in the timed path, for the tests and the tool that
show a cell's ``correct`` coming out false under each: never used by a
run. Each takes a ``pytest.MonkeyPatch`` and patches the program."""


def token_altered(monkeypatch):
    """Every token a decode step produces is replaced by the next id."""
    from repro_torch.serve import engine
    orig = engine._step_batched_fused

    def altered(model, params, blocks, packed):
        out, blocks = orig(model, params, blocks, packed)
        return (out + 1) % model.cfg.vocab_size, blocks
    monkeypatch.setattr(engine, "_step_batched_fused", altered)


def cache_unchanged(monkeypatch):
    """Every decode step leaves the cache as it found it: no key or value
    written, no Mamba state carried."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention, ssm
    monkeypatch.setattr(attention, "_insert", lambda *a, **k: None)
    orig = ops.mamba_decode_step
    monkeypatch.setattr(ssm.ops, "mamba_decode_step",
                        lambda d, A, B, C, x, h: orig(d, A, B, C, x,
                                                      h.clone()))


def state_unchanged(monkeypatch):
    """The step returns the parameters and the moments as it got them."""
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import OptState

    def update(self, params, opt, grads, gnorm=None):
        return params, OptState(opt.m, opt.v, opt.count + 1), gnorm
    monkeypatch.setattr(train_step.TrainStep, "update", update)


def half_batch(monkeypatch):
    """The loss over half of every row's positions, the mean over them."""
    from repro_torch.models.model import Model
    orig = Model.loss

    def loss(self, params, batch):
        labels = batch["labels"].clone()
        labels[:, labels.shape[1] // 2:] = -1
        return orig(self, params, dict(batch, labels=labels))
    monkeypatch.setattr(Model, "loss", loss)


SERVE = (token_altered, cache_unchanged)
TRAIN = (state_unchanged, half_batch)
