"""`sudo-torch-separate`: separate wav files with a torch checkpoint.

Counterpart of ``sudo_rm_rf_tpu/cli/separate.py`` in its overlap-add mode.
Takes a ``.pt`` holding a state_dict (the published format, or one written
from JAX params with ``convert.load_jax_params``) or a whole pickled module,
and serves it through ``improved_forward_fast`` on ``--device``:

    sudo-torch-separate --checkpoint Improved_Sudormrf_U16_Bases512_WSJ02mix.pt \
        --out_channels 256 --input mix1.wav mix2.wav --out_dir ./separated
"""

from __future__ import annotations

import argparse
import functools
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="Separate audio files")
    p.add_argument("--checkpoint", required=True, help="torch .pt checkpoint")
    p.add_argument("--model_type", default="relu")
    p.add_argument("--input", nargs="+", required=True)
    p.add_argument("--out_dir", default="./separated")
    p.add_argument("-fs", type=int, default=8000)
    p.add_argument("--chunk_seconds", type=float, default=4.0)
    p.add_argument("--batch_chunks", type=int, default=8)
    p.add_argument("--num_sources", type=int, default=2)
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
    args = p.parse_args(argv)
    if not args.checkpoint.endswith(".pt"):
        p.error("--checkpoint must be a torch .pt file")

    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import load_pt_file
    from sudo_rm_rf_tpu_torch.inference import separate_file
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")

    hp = dict(
        out_channels=args.out_channels, in_channels=args.in_channels,
        num_blocks=args.num_blocks, upsampling_depth=args.upsampling_depth,
        enc_kernel_size=args.enc_kernel_size, enc_num_basis=args.enc_num_basis,
        num_sources=args.num_sources,
    )
    sd, attrs = load_pt_file(args.checkpoint, reference_root=args.reference_root)
    hp.update(attrs)
    model = models.get_model(args.model_type, **hp, device=device)
    model.load_state_dict(sd, strict=True)
    model.eval()
    forward = functools.partial(improved_forward_fast, model)

    for path in args.input:
        outs = separate_file(
            model, path, args.out_dir, fs=args.fs,
            chunk_seconds=args.chunk_seconds, num_sources=args.num_sources,
            batch_chunks=args.batch_chunks, forward_fn=forward,
        )
        print(f"{path} -> {outs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
