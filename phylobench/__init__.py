"""The benchmark of the PyTorch and CUDA port (beast_mcmc_tpu_torch): see README.md."""
