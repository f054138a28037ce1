"""`sudo-torch-train`: the training CLI of the port (counterpart of
``sudo_rm_rf_tpu/cli/train.py``).

Train Improved SuDoRM-RF U16/512 on WHAM sep_clean on the GPU:

    sudo-torch-train --train WHAM --val WHAM --separation_task sep_clean \\
        --model_type relu --out_channels 256 --in_channels 512 \\
        --num_blocks 16 --upsampling_depth 5 --enc_num_basis 512 \\
        -lr 0.001 --divide_lr_by 3 --patience 49 --zero_pad_audio \\
        --wham_root /mnt/data/wham

``--device`` defaults to ``cuda`` and raises where there is no CUDA device;
``--device cpu`` trains on the CPU.

Over several ranks, one process a rank, launch it with torchrun: NCCL on the
cards (rank ``r`` of a host on ``cuda:LOCAL_RANK``), gloo with ``--device
cpu``. ``--n_model`` ranks share each model (tensor parallelism), the rest
split the batch:

    torchrun --nproc_per_node 8 -m sudo_rm_rf_tpu_torch.cli.train \
        --n_model 2 -bs 8 ... --wham_root /mnt/data/wham
"""

from __future__ import annotations

import os
import sys


def main(argv=None):
    from sudo_rm_rf_tpu_torch.cli.args import args_to_config, build_parser

    args = build_parser().parse_args(argv)
    config = args_to_config(args)
    # dataset root overrides reach data.setup through the environment
    for name in ("wham", "whamr", "fuss", "libri2mix", "musdb"):
        root = getattr(args, f"{name}_root")
        if root:
            os.environ[f"SUDO_TPU_{name.upper()}_ROOT"] = root
            if name == "musdb":  # one flag covers both rate variants
                os.environ["SUDO_TPU_MUSDB8K_ROOT"] = root

    import torch.distributed as dist

    from sudo_rm_rf_tpu_torch.parallel import launch_group, rank_device
    from sudo_rm_rf_tpu_torch.train.experiment import run_experiment
    from sudo_rm_rf_tpu_torch.utils import ExperimentLogger

    # under torchrun: join the launch's process group first, as the JAX CLI
    # calls jax.distributed.initialize
    with launch_group(args.device) as joined:
        logger = None
        if not joined or dist.get_rank() == 0:
            logger = ExperimentLogger(
                args.experiment_logs_path, config.experiment_name,
                tags=list(config.tags), use_comet=args.use_comet,
                comet_project=args.project_name,
            )
        try:
            run_experiment(config, logger=logger, resume=args.resume,
                           log_audio_every=args.log_audio_every,
                           device=rank_device(args.device))
        finally:
            if logger is not None:
                logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
