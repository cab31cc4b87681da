"""Multi-process checks of the port's sharding on a 4-rank gloo (2, 2)
mesh (or, with ``--world 8``, an 8-rank (2, 4) one), run by the
``tests/test_torch_*.py`` files in a subprocess (a process group is
process-global state, which pytest workers must not hold):

    python tests/torch_mesh_worker.py [--world N] OUT_DIR CHECK [CHECK ...]

N (4 by default) ranks are spawned (``torch.multiprocessing``, a
``file://`` rendezvous in OUT_DIR) on a (2, N / 2) ("data", "model") mesh;
each runs the named checks at smoke size in float32, and rank 0 writes
``OUT_DIR/result.json``, one entry a check. Inputs that come from
the JAX package (the reference's parameters, its one-step result) are read
from ``OUT_DIR/inputs.npz``, written by the test beforehand: this file
imports nothing of JAX.
"""
from __future__ import annotations

import copy
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _unflatten(npz, prefix: str) -> dict:
    """Nested dicts of arrays from ``npz`` keys ``prefix/a/b/...``."""
    out: dict = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]
    return out


def _smoke():
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config("llama3-8b", smoke=True).replace(dtype="float32")
    return cfg, Model(cfg, device="cpu")


def _max_err(a_tree, b_tree) -> float:
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.layers import tree_leaves
    return max(float((shd.full(a) - shd.full(b)).abs().max())
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def _close(a_tree, b_tree, tol: float) -> bool:
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.layers import tree_leaves
    return all(torch.allclose(shd.full(a), shd.full(b), atol=tol, rtol=tol)
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def check_train(mesh, npz) -> dict:
    """One AdamW step: sharded (placed_train_step) against the unsharded
    port step and the reference's single-device step."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import params_from_jax
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (
        make_train_shardings, make_train_step, placed_train_step,
    )
    cfg, model = _smoke()
    p0 = params_from_jax(cfg, _unflatten(npz, "params"), "cpu", masters=True)
    want = params_from_jax(cfg, _unflatten(npz, "stepped"), "cpu",
                           masters=True)
    batch = {k: torch.from_numpy(npz[k]).long() for k in ("tokens", "labels")}
    hp = AdamWConfig()
    pu = copy.deepcopy(p0)
    pu, _, mu = make_train_step(model, hp)(pu, init_opt_state(pu), batch)
    sh = make_train_shardings(model, mesh, batch_specs=batch)
    ps = shd.lay_out_tree(copy.deepcopy(p0), sh.params)
    ps, os_, ms = placed_train_step(model, hp, sh)(ps, init_opt_state(ps),
                                                   batch)
    wq = ps["blocks"][0]["mix"]["wq"]
    return {"loss_sharded": float(ms["loss"]), "loss_unsharded": float(
                mu["loss"]), "loss_reference": float(npz["loss"]),
            "sharded_vs_unsharded": _max_err(ps, pu),
            "sharded_vs_reference": _max_err(ps, want),
            "close_unsharded": _close(ps, pu, 2e-5),
            "close_reference": _close(ps, want, 2e-5),
            "wq_placements": [repr(p) for p in wq.placements],
            "wq_local": list(wq.to_local().shape),
            "moments_laid_out": [repr(p) for p in os_.m["blocks"][0]["mix"]
                                 ["wq"].placements]}


def check_serve(mesh, npz) -> dict:
    """Prefill + 4 greedy decode steps through serve_step on the mesh
    against Model.prefill / decode_step unsharded."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.serve.serve_step import (
        make_prefill, make_serve_shardings, placed_decode_step,
    )
    cfg, model = _smoke()
    params = model.init(0)
    tokens = torch.from_numpy(npz["tokens"]).long()
    B, cache_len = tokens.shape[0], tokens.shape[1] + 8
    sh = make_serve_shardings(model, mesh, B, cache_len)
    sp = shd.lay_out_tree(params, sh.params)
    prefill = make_prefill(model, sh, cache_len)
    decode = placed_decode_step(model, sh, B)
    errs, same = [], True
    with torch.no_grad():
        rl, rc = model.prefill(params, {"tokens": tokens}, cache_len=cache_len)
        sl, sc = prefill(sp, {"tokens": tokens})
        layout = {n: [repr(p) for p in t.placements]
                  for n, t in sc["blocks"].items()}
        for _ in range(5):
            errs.append(float((shd.full(sl) - rl).abs().max()))
            rt = rl.argmax(-1, keepdim=True)
            st = shd.full(sl).argmax(-1, keepdim=True)
            same &= bool((rt == st).all())
            if len(errs) == 5:
                break
            rl, rc = model.decode_step(params, rc, rt)
            sl, sc = decode(sp, sc, st)
        cache_err = _max_err(sc["blocks"], rc["blocks"])
    return {"logit_errs": errs, "same_tokens": same, "cache_err": cache_err,
            "cache_layout": layout, "cur_len": sc["cur_len"],
            "logits_layout": [repr(p) for p in sl.placements]}


def check_restore(mesh, npz, out_dir) -> dict:
    """Elastic restore of a checkpoint written unsharded onto the mesh, and
    the restored (sharded) state written again and read back unsharded."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_shardings
    cfg, model = _smoke()
    want = model.init(3, masters=True)
    sh = make_train_shardings(model, mesh)
    like = {"params": model.init(0, masters=True)}
    like["opt"] = init_opt_state(like["params"])
    tree, step = Checkpointer(os.path.join(out_dir, "ckpt")).restore(
        like, shardings={"params": sh.params, "opt": sh.opt})
    wq = tree["params"]["blocks"][0]["mix"]["wq"]
    again = Checkpointer(os.path.join(out_dir, "ckpt_sharded"))
    again.save(8, tree, blocking=True)
    dist.barrier()
    plain = {"params": model.init(1, masters=True)}
    plain["opt"] = init_opt_state(plain["params"])
    back, _ = again.restore(plain)
    return {"step": step, "equal": _max_err(tree["params"], want) == 0.0,
            "resaved_equal": _max_err(back["params"], want) == 0.0,
            "moments_zero": _max_err(tree["opt"].m, init_opt_state(want).m)
            == 0.0, "count": tree["opt"].count,
            "wq_placements": [repr(p) for p in wq.placements],
            "wq_local": list(wq.to_local().shape)}


def check_order(mesh, npz) -> dict:
    """A dim split over ("pod", "data") on a (2, 2) ("pod", "data") mesh:
    which block each rank holds (JAX: pod major)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    pd = make_host_mesh((2, 2), ("pod", "data"), device="cpu")
    spec = shd.spec_for(("batch",), (8,), pd, shd.TRAIN_RULES)
    x = shd.lay_out(torch.arange(8.0), shd.NamedSharding(pd, spec))
    got = [torch.zeros(2) for _ in range(WORLD)]
    dist.all_gather(got, x.to_local().contiguous())
    coords = [None] * WORLD
    dist.all_gather_object(coords, pd.get_coordinate())
    return {"spec": [list(e) if isinstance(e, tuple) else e for e in spec],
            "blocks": [g.tolist() for g in got], "coords": coords}


def check_psum(mesh, npz) -> dict:
    """compressed_psum over the whole group of each rank's gradients."""
    from repro_torch.distributed.collectives import compressed_psum
    rank = dist.get_rank()
    grads = {"w": torch.from_numpy(npz[f"grad{rank}"]),
             "b": [torch.from_numpy(npz[f"bias{rank}"])]}
    mean, err = compressed_psum(grads, None)
    return {"w": mean["w"].tolist(), "b": mean["b"][0].tolist(),
            "err_w": err["w"].tolist()}


def check_attention(mesh, npz) -> dict:
    """The plain attention under the mesh (each rank's shard of the batch
    and the heads, in query chunks) against the one-block plain version on
    one device, for each case ``NAME/{q,k,v,kw}`` of the inputs: the
    largest absolute difference of o, on rank 0."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for name in sorted({k.split("/")[0] for k in npz.files}):
        q, k, v = (torch.from_numpy(npz[f"{name}/{t}"]) for t in "qkv")
        kw = json.loads(str(npz[f"{name}/kw"]))
        with shd.use_sharding(mesh, shd.TRAIN_RULES):
            got = shd.full(fa.flash_attention_plain(q, k, v, **kw))
        if dist.get_rank() == 0:
            chunk, fa.Q_CHUNK = fa.Q_CHUNK, 1 << 30
            want = fa.flash_attention_plain(q, k, v, **kw)
            fa.Q_CHUNK = chunk
            out[name] = float((got - want).abs().max())
    return out


def check_mamba_scan(mesh, npz) -> dict:
    """The plain Mamba scan under the mesh (each rank's shard of the batch
    and the inner dim, the inputs laid out as the model lays them out)
    against the whole scan on one device, with autograd through both: the
    largest differences of y, the final state and each input's gradient,
    relative to the largest value of each, on rank 0."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import linear_scan as ls
    names = ("delta", "A", "Bt", "Ct", "x", "h0")
    specs = (("data", None, "model"), ("model",), ("data", "model"),
             ("data", "model"), ("data", None, "model"), ("data", "model"))
    arrs = [torch.from_numpy(npz[f"mamba/{n}"]) for n in names]
    dy, dh = (torch.from_numpy(npz[f"mamba/{n}"]) for n in ("dy", "dh"))
    with shd.use_sharding(mesh, shd.TRAIN_RULES):
        leaves = [shd.lay_out(t, shd.NamedSharding(mesh, s)).detach()
                  .requires_grad_() for t, s in zip(arrs, specs)]
        y, h = ls.mamba_scan_plain(*leaves)
        placements = [str(p) for p in y.placements]
        loss = shd.full((y * dy).sum() + (h * dh).sum())
        got = [shd.full(t) for t in
               (y, h, *torch.autograd.grad(loss, leaves))]
    out = {}
    if dist.get_rank() == 0:
        whole = [t.clone().requires_grad_() for t in arrs]
        y, h = ls.mamba_scan_plain(*whole)
        want = [y, h, *torch.autograd.grad(
            (y * dy).sum() + (h * dh).sum(), whole)]
        for name, a, b in zip(("y", "h") + names, got, want):
            out[name] = float((a.detach() - b.detach()).abs().max()
                              / b.detach().abs().max())
        out["y_placements"] = placements
    return out


CHECKS = {"train": check_train, "serve": check_serve, "order": check_order,
          "psum": check_psum, "attention": check_attention,
          "mamba_scan": check_mamba_scan}


def run(rank: int, world: int, out_dir: str, checks: list[str]) -> None:
    global WORLD
    WORLD = world
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.abspath(
            os.path.join(out_dir, "rendezvous")),
        rank=rank, world_size=WORLD)
    torch.manual_seed(0)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((2, WORLD // 2), device="cpu")
    path = os.path.join(out_dir, "inputs.npz")
    npz = np.load(path) if os.path.exists(path) else None
    result = {}
    for name in checks:
        if name == "restore":
            result[name] = check_restore(mesh, npz, out_dir)
        else:
            result[name] = CHECKS[name](mesh, npz)
    dist.barrier()
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    args, world = sys.argv[1:], WORLD
    if args[0] == "--world":
        world, args = int(args[1]), args[2:]
    mp.spawn(run, args=(world, args[0], args[1:]), nprocs=world)
