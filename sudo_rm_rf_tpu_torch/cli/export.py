"""`sudo-torch-export`: export a msgpack checkpoint to a torch state_dict .pt.

Counterpart of ``sudo_rm_rf_tpu/cli/export.py``, with its flags. Reads a
msgpack checkpoint of either package (bare params or a whole
``TrainState``), loads its params strictly into the port's own module, whose
names are the torch reference's, and writes that module's ``state_dict``
with ``torch.save``: the format of the published checkpoints, which
``sudo-torch-separate`` and ``sudo-torch-evaluate`` read. With
``--reference_root`` the state_dict is also strict-loaded into the
reference's own torch module, as a check:

    sudo-torch-export --checkpoint ckpt/best_val_SISDRi_... \\
        --model_type relu --out_channels 256 --out model.pt

It only moves tensors, so it runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a checkpoint to torch .pt")
    p.add_argument("--checkpoint", required=True,
                   help="msgpack checkpoint (bare params or TrainState)")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--model_type", default="relu")
    p.add_argument("--reference_root", default=None,
                   help="reference repo path: strict load verification against "
                        "the reference's torch model")
    p.add_argument("--out_channels", type=int, default=128)
    p.add_argument("--in_channels", type=int, default=512)
    p.add_argument("--num_blocks", type=int, default=16)
    p.add_argument("--upsampling_depth", type=int, default=5)
    p.add_argument("--enc_kernel_size", type=int, default=21)
    p.add_argument("--enc_num_basis", type=int, default=512)
    p.add_argument("--num_sources", type=int, default=2)
    p.add_argument("--group_size", type=int, default=16)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.convert import load_model_from_checkpoint

    models.check_cli_model_type(args.model_type)
    hp = dict(
        out_channels=args.out_channels, in_channels=args.in_channels,
        num_blocks=args.num_blocks, upsampling_depth=args.upsampling_depth,
        enc_kernel_size=args.enc_kernel_size, enc_num_basis=args.enc_num_basis,
        num_sources=args.num_sources,
    )
    if args.model_type == "groupcomm_v2":
        hp["group_size"] = args.group_size
    model = models.get_model(args.model_type, **hp, device="cpu")
    sd = load_model_from_checkpoint(args.checkpoint, model).state_dict()
    if args.reference_root:
        import glob as _glob

        sys.modules.setdefault("glob2", _glob)
        if args.reference_root not in sys.path:
            sys.path.insert(0, args.reference_root)
        ref = _build_reference_model(args.model_type, hp)
        ref.load_state_dict(sd, strict=True)
        print(f"strict load into torch {type(ref).__name__}: ok")
    torch.save(sd, args.out)
    print(f"{args.checkpoint} -> {args.out} ({len(sd)} tensors)")
    return 0


def _build_reference_model(model_type: str, hp: dict):
    """The torch reference's model of ``model_type``."""
    if model_type == "groupcomm_v2":
        from sudo_rm_rf.dnn.models import groupcomm_sudormrf_v2 as ref

        return ref.GroupCommSudoRmRf(in_audio_channels=1, **hp)
    from sudo_rm_rf.dnn.models import improved_sudormrf as ref

    return ref.SuDORMRF(**hp)


if __name__ == "__main__":
    sys.exit(main())
