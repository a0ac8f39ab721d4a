"""PyTorch ops of the port: plain tensor code plus the hand-written CUDA
kernels that replace idiaptts_tpu's Pallas kernels."""
