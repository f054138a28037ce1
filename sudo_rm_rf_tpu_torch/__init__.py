"""PyTorch and CUDA port of the SuDoRM-RF framework, for NVIDIA Hopper.

The counterpart of ``sudo_rm_rf_tpu`` (JAX), which stays the reference the
port is tested against. Same module paths and function names; PyTorch idiom
inside: ``nn.Module``s with the torch reference's attribute names, explicit
devices and ``torch.Generator``s, (B, C, T) layout at every public function.
Imports no JAX.

Subpackages
-----------
ops        conv1d, conv_transpose1d, GlobLN, padding, and the U-ConvBlock with
           its hand-written Hopper kernel (csrc/uconv.cu).
models     The Improved SuDoRM-RF ("relu") and GroupComm v2, and their
           serving forwards.
inference  Overlap-add chunked and exact (time-sharded) long-recording
           separation, streaming.
parallel   Data and tensor parallelism over torch.distributed ranks: the
           (data, model) mesh, its collectives and sharding rules.
convert    Torch checkpoints, and the JAX package's param trees and train
           states into the port.
losses     PIT SI-SDR, the stabilized SI-SDR, zero-reference SNR, BSS-eval,
           mixture consistency.
data       WHAM, WHAMR!, FUSS and Libri2Mix loaders, synthetic corpora.
train      Augmentations with explicit draws, the trainer, the recipes.
utils      Checkpoints and logs.
cli        ``sudo-torch-separate``, ``sudo-torch-train``,
           ``sudo-torch-evaluate``.
"""

__version__ = "0.1.0"
