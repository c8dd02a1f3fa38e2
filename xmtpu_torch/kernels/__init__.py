"""Hand-written CUDA kernels (sources in ``xmtpu_torch/csrc``) with
their plain torch twins; a wrapper launches the kernel on a CUDA tensor
and runs the twin on a CPU tensor."""
