"""One rank of a 4-rank gloo group for tests/test_torch_parallel.py.

Runs every case of the port's data and tensor parallelism on sub-meshes of
the group ((4, 1), (2, 1) on ranks 0-1, (2, 2), (1, 4)) and writes what it
got to ``out_dir/rank{r}.pt``. Every rank enters every case in the same
order (``make_mesh`` creates process groups collectively); a rank outside a
case's mesh records None for it. Started with the ``spawn`` method, so it
imports no JAX.
"""

import datetime
import os


def _prepare(draws, batch):
    """The JAX tests' prepare: the mixture is the sum of the sources."""
    return batch.sum(dim=1, keepdim=True), batch


def _train(case, mesh, name, steps, cfg, batch, local_rows=False):
    """``steps`` train steps of a fresh model holding the case's params over
    ``mesh``: loss and grad norm of the last step, the whole params after
    every step (gathered under storage TP) and this rank's own tensors."""
    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig

    if not mesh.member:
        return None
    hp = dict(case["hp"], **case.get(f"{name}_hp", {}))
    tp = hp.pop("tp", False)
    model = models.get_model("relu", **hp, tp_mesh=mesh if tp else None)
    model.load_state_dict(case[f"{name}_sd"] if f"{name}_sd" in case else case["sd"])
    trainer = Trainer(model, TrainerConfig(**cfg), prepare_batch=_prepare, mesh=mesh)
    state = trainer.init_state()
    per_step, grads = [], None
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch, None, local_rows=local_rows)
        per_step.append(trainer.whole_state_dict())
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                params=per_step[-1], per_step=per_step, own=model.state_dict(), grads=grads,
                sharded=sorted(trainer.shards.shapes) if trainer.shards else [],
                state=state, trainer=trainer)


def fed_steps(case, mesh, how):
    """Two steps of a fresh model holding the case's params, fed as a chain
    (``Trainer.train_steps`` over two stacked global batches), as the same
    two single steps, or as a resident epoch (an example bank of the case's
    rows, drawn from a seeded generator): the losses and the whole params.
    ``mesh`` None is the one process."""
    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig
    from sudo_rm_rf_tpu_torch.train.resident import ResidentData, make_examples_sampler

    if mesh is not None and not mesh.member:
        return None
    model = models.get_model("relu", **case["hp"])
    model.load_state_dict(case["sd"])
    trainer = Trainer(model, TrainerConfig(), prepare_batch=_prepare, mesh=mesh)
    state = trainer.init_state()
    if how == "chain":
        state, metrics = trainer.train_steps(state, case["chain_src"], [None, None])
        losses = metrics["loss"]
    elif how == "steps":
        losses = torch.stack([trainer.train_step(state, batch, None)[1]["loss"]
                              for batch in case["chain_src"]])
    else:
        pool = case["pool_src"]
        data = ResidentData(trainer, make_examples_sampler(pool.shape[0], 4), pool, 2,
                            lambda generator, batch: None)
        state, losses = data.run_epoch(state, torch.Generator().manual_seed(3))
    return dict(losses=losses.tolist(), params=trainer.whole_state_dict())


def run(rank: int, world: int, store_path: str, case_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.cli import evaluate as evaluate_cli
    from sudo_rm_rf_tpu_torch.cli import separate as separate_cli
    from sudo_rm_rf_tpu_torch.cli import train as train_cli
    from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
    from sudo_rm_rf_tpu_torch.parallel import make_mesh, shard_batch
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig
    from sudo_rm_rf_tpu_torch.utils import CheckpointManager

    torch.set_num_threads(1)
    case = torch.load(case_path, weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    strip = lambda r: r and {k: v for k, v in r.items() if k not in ("state", "trainer")}
    got = {}
    try:
        # data parallelism: 4 ranks, and 2 ranks feeding their local rows
        dp4 = make_mesh(4, 1)
        got["dp4"] = strip(_train(case, dp4, "dp", 3, {}, case["dp_src"]))
        dp2 = make_mesh(2, 1, ranks=[0, 1])
        local = shard_batch(dp2, case["dist_src"]) if dp2.member else None
        got["dp2_local"] = strip(_train(case, dp2, "dist", 1, {}, local, local_rows=True))
        # a 2-step chain and a 2-step resident epoch over DP 2
        for how in ("chain", "steps", "resident"):
            got[f"dp2_{how}"] = fed_steps(case, dp2, how)
        # the clamp on the global mean, and gradient accumulation
        for name in ("clamp_inside", "clamp_saturated"):
            got[name] = strip(_train(case, dp2, "clamp", 1, dict(loss_clamp=case[name]),
                                     case["clamp_src"]))
        got["accum2"] = strip(_train(case, dp4, "dp", 2, dict(grad_accum_steps=2),
                                     case["dp_src"]))
        # storage TP on (2, 2); its checkpoint; state_from_params
        grid = make_mesh(2, 2)
        run_ = _train(case, grid, "dp", 2, dict(shard_params=True), case["tp_src"])
        got["tp_storage"] = strip(run_)
        ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"), "relu", writer=rank == 0)
        ckpt.save(run_["state"], "relu_epoch_2")
        # state_from_params places the whole params as init_state does
        fresh = Trainer(models.get_model("relu", **case["hp"]),
                        TrainerConfig(shard_params=True), prepare_batch=_prepare, mesh=grid)
        resumed = fresh.state_from_params(case["sd"]).model.state_dict()
        at_init = _own_at_init(case, grid)
        got["state_from_params"] = dict(
            same=resumed.keys() == at_init.keys()
            and all(torch.equal(resumed[k], v) for k, v in at_init.items()),
            shapes={k: tuple(v.shape) for k, v in resumed.items()})
        _, m = fresh.train_step(fresh.init_state(), case["tp_src"], None)
        got["state_from_params"]["loss"] = float(m["loss"])
        # compute TP (with storage TP) on (1, 4)
        row = make_mesh(1, 4)
        got["tp_compute"] = strip(_train(case, row, "ctp", 2, dict(shard_params=True),
                                         case["ctp_src"]))
        # the serving forward under compute TP, on (2, 2) and (1, 4)
        fast = models.get_model("relu", **case["fast_hp"])
        fast.load_state_dict(case["fast_sd"])
        got["fast_tp"] = {str(m_.grid.shape): improved_forward_fast(
            fast, case["fast_x"], impl="fma", tp_mesh=m_) for m_ in (grid, row)}
        # DP overlap-add on (4, 1)
        ola_model = models.get_model("relu", **case["ola_hp"])
        ola_model.load_state_dict(case["ola_sd"])
        sep = OverlapAddSeparator(ola_model, chunk_samples=800, num_sources=2,
                                  batch_chunks=5, mesh=dp4)
        got["ola"] = dict(batch_chunks=sep.batch_chunks, est=sep.separate(case["ola_mix"]))
        # the CLIs over the whole group: separate --mode seq_parallel,
        # evaluate --full_length_mode seq_parallel and train --n_model 2 (a
        # (2, 2) grid at batch 2)
        assert separate_cli.main(case["separate_argv"]) == 0
        assert evaluate_cli.main(case["evaluate_argv"]) == 0
        assert train_cli.main(case["train_argv"]) == 0
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _own_at_init(case, mesh):
    """This rank's tensors of a sharded trainer built from the case's params."""
    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig

    model = models.get_model("relu", **case["hp"])
    model.load_state_dict(case["sd"])
    Trainer(model, TrainerConfig(shard_params=True), prepare_batch=_prepare, mesh=mesh)
    return model.state_dict()
