"""The baselines of the reference's model zoo, counterparts of
``sudo_rm_rf_tpu/models/baselines``: ConvTasNet, DPRNN, Demucs, TDCN and
ResidualTN, and SepFormer with every dual-path block family of the JAX file.
Plain PyTorch and library calls (cuDNN's LSTM, cuBLAS): no baseline holds a
U-ConvBlock, so none reaches the CUDA kernel."""
