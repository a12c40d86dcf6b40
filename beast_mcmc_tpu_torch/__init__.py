"""PyTorch/CUDA port of the Bayesian phylodynamics engine.

Mirrors the module layout of `beast_mcmc_tpu` (the JAX reference, which this
package never imports). The chain runs in float64 on an NVIDIA H100; the
Felsenstein peel runs in hand-written CUDA kernels (`csrc/`), with a plain
PyTorch version of each beside its wrapper for CPU tensors.

Entry points take an explicit `device=` (default "cuda") and `dtype=`
(default float64).
"""
