"""`sudo-torch-separate`: separate wav files with a torch checkpoint.

Counterpart of ``sudo_rm_rf_tpu/cli/separate.py``: ``--mode overlap_add``
(the default) chunks each recording; ``--mode seq_parallel`` separates it in
one exact pass (``inference.SequenceParallelSeparator``, model types
``relu`` and ``groupcomm_v2`` as the JAX CLI). One rank runs that pass
through the U-ConvBlock kernel (K1) on a card. Under a torchrun launch
(``torchrun --nproc_per_node N -m sudo_rm_rf_tpu_torch.cli.separate ...``;
NCCL on the cards, gloo with ``--device cpu``) every rank reads every file:
``seq_parallel`` runs the n-shard body with one time shard a rank, and
``overlap_add`` splits each chunk batch over the ranks (each runs its chunks
through the serving forward, K1 on a card); rank 0 alone writes the files.
Takes a ``.pt`` holding a state_dict (the published format, or one written
by ``sudo-torch-export``) or a whole pickled module, or a msgpack checkpoint
of either package (bare params or a whole ``TrainState``; the file's first
bytes tell the formats apart, so a name needs no suffix), and serves it on
``--device`` through ``improved_forward_fast`` (model types
``relu``/``improved``), ``groupcomm_forward_fast`` (``groupcomm_v2``) or the
module's own forward (``softmax``, ``causal``, ``attention``,
``attention_v2``, ``attention_v3``, as the JAX CLI serves every type):

    sudo-torch-separate --checkpoint Improved_Sudormrf_U16_Bases512_WSJ02mix.pt \
        --out_channels 256 --input mix1.wav mix2.wav --out_dir ./separated
    sudo-torch-separate --checkpoint groupcomm_u16_512.pt \
        --model_type groupcomm_v2 --out_channels 256 --group_size 16 \
        --mixture_consistency uniform --input mix1.wav --out_dir ./separated
"""

from __future__ import annotations

import argparse
import functools
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="Separate audio files")
    p.add_argument("--checkpoint", required=True,
                   help="torch .pt, or a msgpack checkpoint (bare params or TrainState)")
    p.add_argument("--model_type", default="relu")
    p.add_argument("--input", nargs="+", required=True)
    p.add_argument("--out_dir", default="./separated")
    p.add_argument("-fs", type=int, default=8000)
    p.add_argument("--chunk_seconds", type=float, default=4.0)
    p.add_argument("--batch_chunks", type=int, default=8)
    p.add_argument("--num_sources", type=int, default=2)
    p.add_argument("--mixture_consistency", default=None,
                   choices=[None, "uniform", "magsq"])
    p.add_argument("--mode", default="overlap_add",
                   choices=["overlap_add", "seq_parallel"],
                   help="overlap_add: COLA chunking (any model); seq_parallel: one "
                        "exact pass over the whole recording (relu, groupcomm_v2): on one "
                        "rank through K1 on a card, under a torchrun launch one time shard "
                        "a rank (rank 0 writes the files)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on; never falls back to the CPU")
    p.add_argument("--reference_root", default=None,
                   help="path that makes a whole-pickled torch module loadable")
    # model hyperparams (needed for bare state_dicts)
    p.add_argument("--out_channels", type=int, default=128)
    p.add_argument("--in_channels", type=int, default=512)
    p.add_argument("--num_blocks", type=int, default=16)
    p.add_argument("--upsampling_depth", type=int, default=5)
    p.add_argument("--enc_kernel_size", type=int, default=21)
    p.add_argument("--enc_num_basis", type=int, default=512)
    p.add_argument("--group_size", type=int, default=16)
    args = p.parse_args(argv)
    if args.mode == "seq_parallel" and args.model_type not in ("relu", "groupcomm_v2"):
        p.error("--mode seq_parallel supports model_type 'relu' or 'groupcomm_v2'")

    import torch
    import torch.distributed as dist

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.inference import make_seq_comm
    from sudo_rm_rf_tpu_torch.parallel import launch_group, make_mesh, rank_device

    models.check_cli_model_type(args.model_type)
    with launch_group(args.device) as joined:
        if joined:
            return _separate(args, rank_device(args.device), dist.get_rank() == 0,
                             make_seq_comm(), make_mesh())
        return _separate(args, torch.device(args.device), True, None, None)


def _separate(args, device, write: bool, comm, mesh) -> int:
    """Separate every input on ``device``; ``comm`` / ``mesh``: a launch's
    communicator and mesh (None in one process); ``write``: this rank
    writes the files."""
    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.inference import SequenceParallelSeparator, separate_file
    from sudo_rm_rf_tpu_torch.utils.benchmark import serving_forward

    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")

    hp = dict(
        out_channels=args.out_channels, in_channels=args.in_channels,
        num_blocks=args.num_blocks, upsampling_depth=args.upsampling_depth,
        enc_kernel_size=args.enc_kernel_size, enc_num_basis=args.enc_num_basis,
        num_sources=args.num_sources,
    )
    if args.model_type == "groupcomm_v2":
        hp["group_size"] = args.group_size
    model = models.load_checkpoint_model(args.model_type, hp, args.checkpoint, device,
                                         reference_root=args.reference_root)

    if args.mode == "seq_parallel":
        kwargs = dict(separator=SequenceParallelSeparator(
            model, comm=comm, mixture_consistency=args.mixture_consistency))
    else:
        kwargs = dict(chunk_seconds=args.chunk_seconds, batch_chunks=args.batch_chunks,
                      mixture_consistency=args.mixture_consistency,
                      forward_fn=functools.partial(serving_forward(model), model), mesh=mesh)
    for path in args.input:
        outs = separate_file(model, path, args.out_dir, fs=args.fs,
                             num_sources=args.num_sources, write=write, **kwargs)
        if write:
            print(f"{path} -> {outs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
