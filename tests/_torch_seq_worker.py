"""One rank of a gloo group for tests/test_torch_sequence_parallel.py: runs
the communicator's primitives, ``improved_forward_seq`` and
``groupcomm_forward_seq`` through ``DistributedShards`` and writes what it got
to ``out_dir/rank{r}.pt``. Started with the ``spawn`` method, so it imports
no JAX."""

import datetime
import os


def run(rank: int, world: int, store_path: str, case_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.inference.sequence_parallel import (
        DistributedShards,
        groupcomm_forward_seq,
        improved_forward_seq,
    )

    torch.set_num_threads(1)
    case = torch.load(case_path, weights_only=True)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        comm = DistributedShards()
        prim = case["prim"]
        got = {
            "rank": comm.rank(),
            "all_reduce_sum": comm.all_reduce_sum(prim[rank]),
            "halo_exchange": comm.halo_exchange(prim[rank, :, 0], 3),
            "all_gather": comm.all_gather(prim[rank]),
        }
        for name, forward in (("relu", improved_forward_seq),
                              ("groupcomm_v2", groupcomm_forward_seq)):
            model = models.get_model(name, **case[f"{name}_hp"])
            model.load_state_dict(case[f"{name}_sd"])
            got[name] = forward(model.eval(), case["x"], comm)
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
