"""repro_torch: the AutoTSMM serving runtime ported to PyTorch and CUDA
(NVIDIA H100), beside the JAX reference package ``repro``."""
