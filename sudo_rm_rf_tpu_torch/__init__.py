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
models     The Improved SuDoRM-RF ("relu") and its serving forward.
inference  Overlap-add chunked long-recording separation.
convert    Loading the JAX package's param trees into the port.
cli        ``sudo-torch-separate``.
"""

__version__ = "0.1.0"
