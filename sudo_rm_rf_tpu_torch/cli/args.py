"""Argparse front end of ``sudo-torch-train`` (counterpart of
``sudo_rm_rf_tpu/cli/args.py``).

The JAX package's flags and defaults, plus ``--device``, mapped onto the
port's dataclass config tree (``sudo_rm_rf_tpu_torch.config``), so a
published run's ``hparams.json`` trains as written: ``--block_impl auto``
times the block forms at build, ``--chain_steps`` stacks that many host
batches into one copy, ``--max_inflight`` bounds the dispatches queued
ahead of the card and ``--device_data`` keeps the training set on the
device. Combinations the port cannot train raise in
``train.experiment.check_supported``.
"""

from __future__ import annotations

import argparse

from sudo_rm_rf_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="SuDoRM-RF training on a CUDA device (PyTorch port)"
    )
    # datasets
    p.add_argument("--train", nargs="+", default=["WHAM"])
    p.add_argument("--val", nargs="+", default=None)
    p.add_argument("--test", nargs="+", default=None)
    p.add_argument("--train_val", nargs="+", default=None)
    p.add_argument("--n_train", type=int, default=0)
    p.add_argument("--n_val", type=int, default=0)
    p.add_argument("--n_test", type=int, default=0)
    p.add_argument("--n_train_val", type=int, default=0)
    p.add_argument("--audio_timelength", type=float, default=4.0)
    p.add_argument("--min_or_max", type=str, default="min", choices=["min", "max"])
    p.add_argument("--zero_pad_audio", action="store_true")
    p.add_argument("--normalize_audio", action="store_true")
    p.add_argument("--n_channels", type=int, default=1)
    p.add_argument("--min_num_sources", type=int, default=1)
    p.add_argument("--max_num_sources", type=int, default=4)
    p.add_argument("--separation_task", type=str, default="sep_clean")
    # legacy AUGMENTED_* hierarchical datasets (cmd_args_parser.py -i/-val)
    p.add_argument("--train_dataset_paths", nargs="+", default=[])
    p.add_argument("--val_dataset_paths", nargs="+", default=[])
    p.add_argument("--test_dataset_paths", nargs="+", default=[])
    p.add_argument("--max_abs_snr", type=float, default=2.5)
    # training
    p.add_argument("-bs", "--batch_size", type=int, default=4)
    p.add_argument("--n_epochs", type=int, default=200)
    p.add_argument("-lr", "--learning_rate", type=float, default=1e-3)
    p.add_argument("--divide_lr_by", type=float, default=3.0)
    p.add_argument("--patience", type=int, default=0)
    p.add_argument("--optimizer", type=str, default="adam",
                   choices=["adam", "radam_cosine"])
    p.add_argument("--clip_grad_norm", type=float, default=5.0)
    p.add_argument("--loss_clamp", type=float, default=30.0)
    p.add_argument("--mixture_consistency", type=str, default=None,
                   choices=[None, "uniform", "magsq"])
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="mixed-precision fwd/bwd compute dtype (fp32 "
                        "master params); bfloat16 is the fastest measured "
                        "training mode")
    p.add_argument("--n_model", type=int, default=1,
                   help="model-group size of the (data, model) grid of ranks of a "
                        "torchrun launch (>1: storage TP; + compute TP for relu with "
                        "block_impl fma); the other ranks split the batch")
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="microbatches per optimizer step (large effective "
                        "batches beyond device memory)")
    p.add_argument("--chain_steps", type=int, default=25,
                   help="host batches stacked into one copy to the device and "
                        "queued together (bit for bit the single steps; a "
                        "ragged tail runs step by step); 1 disables")
    p.add_argument("--upload_dtype", type=str, default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="host->device dtype of the train batches: cast on "
                        "the host, back to fp32 on the device (bfloat16 "
                        "halves the bytes copied)")
    p.add_argument("--max_inflight", type=int, default=2,
                   help="max train dispatches queued ahead of the card before "
                        "the host waits on the oldest (bounds the queued work "
                        "and the pinned host batches); 0 = unbounded")
    p.add_argument("--early_stop_patience", type=int, default=0,
                   help="stop after N epochs without a new best primary "
                        "val metric (0 = run all epochs)")
    p.add_argument("--device_data", action="store_true",
                   help="decode the training set once into a pool on the "
                        "device and draw every batch there: no host-to-device "
                        "copy a step")
    p.add_argument("-fs", type=int, default=8000)
    p.add_argument("--seed", type=int, default=0)
    # bookkeeping
    p.add_argument("-tags", "--cometml_tags", nargs="+", default=[])
    p.add_argument("--experiment_name", type=str, default="sudo_tpu_experiment")
    p.add_argument("--project_name", type=str, default="sudo_rm_rf_tpu")
    p.add_argument("--use_comet", action="store_true")
    p.add_argument("--n_jobs", type=int, default=4)
    p.add_argument("-elp", "--experiment_logs_path", type=str, default="./logs")
    p.add_argument("-alp", "--audio_logs_path", type=str, default=None)
    p.add_argument("-clp", "--checkpoints_path", type=str, default="./checkpoints")
    p.add_argument("--save_checkpoint_every", type=int, default=10)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint (incl. optimizer)")
    p.add_argument("--log_audio_every", type=int, default=1,
                   help="epochs between audio logging")
    # model
    p.add_argument("--out_channels", type=int, default=128)
    p.add_argument("--in_channels", type=int, default=512)
    p.add_argument("--num_blocks", type=int, default=16)
    p.add_argument("--upsampling_depth", type=int, default=5)
    p.add_argument("--group_size", type=int, default=16)
    p.add_argument("--enc_kernel_size", type=int, default=21)
    p.add_argument("--enc_num_basis", type=int, default=512)
    p.add_argument("--att_dims", type=int, default=256)
    p.add_argument("--att_n_heads", type=int, default=4)
    p.add_argument("--att_dropout", type=float, default=0.1)
    p.add_argument("--block_impl", type=str, default="fma",
                   choices=["xla", "fma", "kernel", "auto"],
                   help="U-ConvBlock form; 'kernel' is forward-only, 'auto' "
                        "times xla and fma through the train step at build and "
                        "trains with the faster")
    p.add_argument("--remat_blocks", action="store_true",
                   help="recompute block activations in the backward (model "
                        "types relu and groupcomm_v2): less memory for about "
                        "one more forward")
    p.add_argument(
        "--model_type", type=str, default="relu",
        choices=["relu", "softmax", "groupcomm_v2", "causal", "attention",
                 "attention_v2", "attention_v3", "convtasnet", "dprnn",
                 "demucs", "tdcn", "residual_tdcn", "sepformer"],
    )
    # dataset root overrides
    for name in ("wham", "whamr", "fuss", "libri2mix", "musdb"):
        p.add_argument(f"--{name}_root", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on; never falls back to the CPU")
    return p


def args_to_config(args) -> ExperimentConfig:
    n_sources = 2
    if args.separation_task in ("enh_single", "enhance_single",
                                "enhance_single_white_noise", "enh_both",
                                "enhance_both"):
        n_sources = 1
    if args.train and args.train[0] == "FUSS":
        n_sources = args.max_num_sources
    if args.train and args.train[0] == "MUSDB":
        n_sources = 4  # drums/bass/other/vocals stem slots

    model = ModelConfig(
        model_type=args.model_type,
        out_channels=args.out_channels,
        in_channels=args.in_channels,
        num_blocks=args.num_blocks,
        upsampling_depth=args.upsampling_depth,
        enc_kernel_size=args.enc_kernel_size,
        enc_num_basis=args.enc_num_basis,
        num_sources=max(n_sources, 2) if n_sources == 1 else n_sources,
        group_size=args.group_size,
        in_audio_channels=args.n_channels,
        n_heads=args.att_n_heads,
        att_dims=args.att_dims,
        att_dropout=args.att_dropout,
        block_impl=args.block_impl,
        remat_blocks=args.remat_blocks,
    )
    data = DataConfig(
        train=tuple(args.train or ()),
        val=tuple(args.val or ()),
        test=tuple(args.test or ()),
        train_val=tuple(args.train_val or ()),
        separation_task=args.separation_task,
        fs=args.fs,
        audio_timelength=args.audio_timelength,
        min_or_max=args.min_or_max,
        zero_pad_audio=args.zero_pad_audio,
        normalize_audio=args.normalize_audio,
        n_channels=args.n_channels,
        min_num_sources=args.min_num_sources,
        max_num_sources=args.max_num_sources,
        n_train=args.n_train,
        n_val=args.n_val,
        n_test=args.n_test,
        n_train_val=args.n_train_val,
        batch_size=args.batch_size,
        n_jobs=args.n_jobs,
        train_dataset_paths=tuple(args.train_dataset_paths),
        val_dataset_paths=tuple(args.val_dataset_paths),
        test_dataset_paths=tuple(args.test_dataset_paths),
        max_abs_snr=args.max_abs_snr,
    )
    train = TrainConfig(
        n_epochs=args.n_epochs,
        learning_rate=args.learning_rate,
        divide_lr_by=args.divide_lr_by,
        patience_epochs=args.patience,
        clip_grad_norm=args.clip_grad_norm,
        loss_clamp=args.loss_clamp,
        mixture_consistency=args.mixture_consistency,
        optimizer=args.optimizer,
        grad_accum_steps=args.grad_accum_steps,
        chain_steps=args.chain_steps,
        compute_dtype=args.compute_dtype,
        upload_dtype=args.upload_dtype,
        max_inflight=args.max_inflight,
        device_data=args.device_data,
        early_stop_patience=args.early_stop_patience,
        n_model=args.n_model,
        save_checkpoint_every=args.save_checkpoint_every,
        checkpoints_path=args.checkpoints_path,
        seed=args.seed,
    )
    return ExperimentConfig(
        model=model, data=data, train=train,
        experiment_name=args.experiment_name, tags=tuple(args.cometml_tags),
    )
